"""The port's paged serving path vs the JAX package's, on the same numpy
weights, in fp32 on the CPU.

Greedy generations must be token-identical: across queueing (more
requests than slots), chunked prefill, int8 KV, KV-pool pressure
(preemption), and with the JAX side running both Pallas kernels in
interpret mode (``DSTPU_PAGED_KERNEL=1``).  The programs' logits are
compared directly with a tolerance of 1e-4 (fp32, 2 layers; CPU matmul
summation order is the only difference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import RaggedRequest as JaxRequest
from deepspeed_tpu.inference.v2 import model_runner as jmr
from deepspeed_tpu.inference.v2.ragged import BlockAllocator as JaxAllocator
from deepspeed_tpu.inference.v2.ragged import KVBlockConfig as JaxBlock
from deepspeed_tpu.inference.v2.ragged import PagedKVCache as JaxKVCache
from deepspeed_tpu.models.llama import llama_model as jax_llama
from deepspeed_tpu_torch.inference.v2 import (BlockAllocator, InferenceEngineV2,
                                              KVBlockConfig, PagedKVCache,
                                              RaggedInferenceConfig, RaggedRequest,
                                              RejectedError)
from deepspeed_tpu_torch.inference.v2 import model_runner as tmr
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.models.llama import llama_model

torch.set_num_threads(2)

BASE = dict(dtype="fp32", page_size=8, num_pages=64, max_seqs=4, max_pages_per_seq=8)
LENGTHS = (5, 17, 30, 9, 40, 3)

CASES = {
    "queueing": dict(),
    "chunked": dict(prefill_chunk=16),
    "kv_quant": dict(kv_quant=True),
    "kv_quant_chunked": dict(kv_quant=True, prefill_chunk=16),
    # 9 pages for 4 slots of up to 6 pages: decode growth preempts
    "preemption": dict(num_pages=9, max_seqs=4),
}


@pytest.fixture(scope="module")
def weights():
    jmodel = jax_llama("tiny", max_seq_len=256)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    return jmodel, params, jax.tree_util.tree_map(np.asarray, params)


def _prompts(seed=2, lengths=LENGTHS):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, 256, n))) for n in lengths]


def _jax_streams(weights, cfg, prompts, max_new=8):
    jmodel, params, _ = weights
    eng = JaxEngine(jmodel, JaxConfig(**cfg), params=params)
    return eng.generate_all([JaxRequest(prompt_ids=p, max_new_tokens=max_new)
                             for p in prompts])


def _port_engine(weights, cfg):
    return InferenceEngineV2(llama_model("tiny", max_seq_len=256),
                             RaggedInferenceConfig(**cfg), params=weights[2],
                             device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_streams_token_identical(weights, case):
    cfg = dict(BASE, **CASES[case])
    prompts = _prompts()
    max_new = 16 if case == "preemption" else 8
    want = _jax_streams(weights, cfg, prompts, max_new)
    eng = _port_engine(weights, cfg)
    got = eng.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=max_new)
                            for p in prompts])
    assert got == want
    assert all(len(v) == max_new for v in got.values())
    assert eng.allocator.free_pages == cfg["num_pages"]
    eng.allocator.assert_no_leaks()
    st = eng.stats()
    if case == "preemption":
        assert st["preemptions"] > 0
    if cfg.get("prefill_chunk"):
        assert st["prefill_chunk_calls"] > len(prompts) and st["prefill_calls"] == 0
    else:
        assert st["prefill_calls"] >= len(prompts) and st["prefill_chunk_calls"] == 0


@pytest.mark.parametrize("case", ["queueing", "chunked"])
def test_greedy_streams_match_jax_pallas_kernels(weights, case, monkeypatch):
    """The JAX side with both Pallas kernels (flash prefill, paged
    decode) forced on in interpret mode, as its own engine tests do."""
    monkeypatch.setenv("DSTPU_PAGED_KERNEL", "1")
    cfg = dict(BASE, **CASES[case])
    prompts = _prompts(seed=3, lengths=(11, 26, 4, 19, 33))
    want = _jax_streams(weights, cfg, prompts)
    got = _port_engine(weights, cfg).generate_all(
        [RaggedRequest(prompt_ids=p, max_new_tokens=8) for p in prompts])
    assert got == want


@pytest.mark.parametrize("quant", [False, True])
def test_program_logits_and_pools_match_jax(weights, quant):
    """paged_prefill, paged_prefill_chunk and paged_decode directly: the
    same ids, page rows and tables through both; logits within 1e-4 and
    the written KV pages equal within 1e-5 (int8 codes exactly, bar
    rounding ties)."""
    jmodel, params, np_params = weights
    jcfg = jmodel.config
    tcfg = llama_model("tiny", max_seq_len=256).config
    tparams = params_from_numpy(np_params, tcfg, "cpu")
    block = dict(page_size=8, num_pages=16, max_seqs=2, max_pages_per_seq=8)
    jpools = JaxKVCache.init(jcfg.n_layers, jcfg.kv_heads, jcfg.head_dim,
                             JaxBlock(**block), jnp.float32, kv_quant=quant)
    tpools = PagedKVCache.init(tcfg.n_layers, tcfg.kv_heads, tcfg.head_dim,
                               KVBlockConfig(**block), torch.float32, kv_quant=quant,
                               device="cpu")
    trash = 16
    ids = np.zeros((32,), np.int32)
    ids[:21] = _prompts(seed=5, lengths=(21,))[0]
    rows = np.array([3, 7, 1, trash], np.int32)
    jl, jpools = jmr.paged_prefill(jcfg, params, jpools, jnp.asarray(ids),
                                   jnp.asarray(rows), jnp.int32(21))
    tl, _ = tmr.paged_prefill(tcfg, tparams, tpools, torch.from_numpy(ids).long(),
                              torch.from_numpy(rows), 21)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)

    # second sequence through two 16-token chunks over pages [5, 9, 2]
    table2 = np.array([5, 9, 2, trash], np.int32)
    ids2 = _prompts(seed=6, lengths=(20,))[0] + [0] * 12
    for start, n in ((0, 16), (16, 4)):
        chunk = np.array(ids2[start:start + 16], np.int32)
        crow = table2[start // 8:start // 8 + 2]
        prev = table2[:4 if start else 2]
        jl, jpools = jmr.paged_prefill_chunk(
            jcfg, params, jpools, jnp.asarray(chunk), jnp.asarray(crow),
            jnp.asarray(prev), jnp.int32(start), jnp.int32(n))
        tl, _ = tmr.paged_prefill_chunk(
            tcfg, tparams, tpools, torch.from_numpy(chunk).long(),
            torch.from_numpy(crow), torch.from_numpy(prev), start, n)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)

    table = np.full((2, 8), trash, np.int32)
    table[0, :3] = [3, 7, 1]
    table[1, :3] = [5, 9, 2]
    last = np.array([17, 42], np.int32)
    pos = np.array([21, 20], np.int32)
    act = np.array([True, True])
    jl, jpools = jmr.paged_decode(jcfg, params, jpools, jnp.asarray(last),
                                  jnp.asarray(pos), jnp.asarray(table), jnp.asarray(act))
    tl, _ = tmr.paged_decode(tcfg, tparams, tpools, torch.from_numpy(last).long(),
                             torch.from_numpy(pos), torch.from_numpy(table),
                             torch.from_numpy(act))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    live = [3, 7, 1, 5, 9, 2]
    for name in jpools:
        np.testing.assert_allclose(tpools[name][:, live].float().numpy(),
                                   np.asarray(jpools[name][:, live], np.float32),
                                   atol=1e-5 if name.endswith("scale") or not quant else 1,
                                   rtol=1e-5)


def test_quantized_chunked_prefill_takes_the_plain_path(weights):
    """Chunked prefill with an int8 pool attends through the plain
    concat formulation by design (as the JAX engine does), counted."""
    cfg = dict(BASE, kv_quant=True, prefill_chunk=16)
    before = tmr.paged_prefill_chunk.plain_quant_calls
    eng = _port_engine(weights, cfg)
    eng.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=2)
                      for p in _prompts(lengths=(20, 9))])
    assert (tmr.paged_prefill_chunk.plain_quant_calls - before
            == eng.stats()["prefill_chunk_calls"] == 3)


def _run_steps(eng, requests):
    for r in requests:
        eng.put(r)
    recs = {}
    while eng.has_work():
        for uid, rec in eng.step().items():
            agg = recs.setdefault(uid, {"tokens": [], "finish_reason": None})
            agg["tokens"] += rec["tokens"]
            if rec["done"]:
                agg["finish_reason"] = rec["finish_reason"]
    return recs


def test_finish_reasons_eos_and_length(weights):
    prompts = _prompts(seed=4, lengths=(6, 12))
    want = _jax_streams(weights, BASE, prompts)
    eos = want[0][2]  # the third generated token of request 0 acts as EOS
    stop = want[0].index(eos) + 1
    recs = _run_steps(_port_engine(weights, BASE), [
        RaggedRequest(prompt_ids=prompts[0], max_new_tokens=8, eos_id=eos, uid=0),
        RaggedRequest(prompt_ids=prompts[1], max_new_tokens=5, uid=1)])
    assert recs[0] == {"tokens": want[0][:stop], "finish_reason": "eos"}
    assert recs[1] == {"tokens": want[1][:5], "finish_reason": "length"}


def test_deadline_expires_queued_request(weights):
    recs = _run_steps(_port_engine(weights, BASE), [
        RaggedRequest(prompt_ids=[1, 2, 3], max_new_tokens=4, deadline_s=0.0)])
    assert recs[0] == {"tokens": [], "finish_reason": "deadline"}


def test_bounded_queue_rejects(weights):
    eng = _port_engine(weights, dict(BASE, max_queue_depth=2))
    eng.put(RaggedRequest(prompt_ids=[1, 2]))
    eng.put(RaggedRequest(prompt_ids=[3, 4]))
    with pytest.raises(RejectedError) as e:
        eng.put(RaggedRequest(prompt_ids=[5, 6]))
    assert e.value.reason == "engine_queue_full" and e.value.retry_after_s >= 0.1
    assert eng.queue_depth == 2 and eng.active_count == 0
    assert sorted(eng.abort_all()) == [0, 1] and not eng.has_work()


@pytest.mark.parametrize("knob", [
    {"enable_prefix_cache": True}, {"kv_tier": {"enabled": True}},
    {"speculative": {"mode": "ngram"}}, {"decode_horizon": 4}, {"quant_bits": 8},
    {"timeline_every_n_steps": 5}, {"slo_ttft_s": 0.5}])
def test_not_ported_knobs_raise(knob):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RaggedInferenceConfig.from_dict(dict(BASE, **knob))
    cfg = RaggedInferenceConfig(**BASE)
    for k, v in knob.items():
        setattr(cfg, k, v)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngineV2(llama_model("tiny"), cfg, device="cpu")


def test_sampled_stream_independent_of_slot(weights):
    """A sampled request keeps its stream whether it lands in slot 0 or
    behind a greedy request in slot 1: the decode noise is keyed by
    (seed, uid, position), never by the slot."""
    p = _prompts(seed=8, lengths=(10,))[0]
    req = dict(prompt_ids=p, max_new_tokens=12, temperature=1.0, uid=7)
    alone = _port_engine(weights, BASE).generate_all([RaggedRequest(**req)])
    shifted = _port_engine(weights, BASE).generate_all(
        [RaggedRequest(prompt_ids=[5, 6, 7], max_new_tokens=12, uid=3),
         RaggedRequest(**req)])
    assert alone[7] == shifted[7]
    other_seed = InferenceEngineV2(llama_model("tiny", max_seq_len=256),
                                   RaggedInferenceConfig(**BASE), params=weights[2],
                                   seed=1, device="cpu")
    assert other_seed.generate_all([RaggedRequest(**req)])[7] != alone[7]


def test_block_allocator_matches_jax_line_for_line():
    """The same random alloc/free/share/register sequence on both
    allocators leaves the same pages, refcounts and registry."""
    rng = np.random.RandomState(0)
    ja, ta = JaxAllocator(12, cache_pages=3), BlockAllocator(12, cache_pages=3)
    held = []
    for i in range(200):
        op = rng.randint(4)
        if op == 0:
            n = int(rng.randint(1, 4))
            if n <= ja.free_pages:
                a, b = ja.alloc(n), ta.alloc(n)
                assert a == b
                held += a
            else:
                with pytest.raises(MemoryError):
                    ta.alloc(n)
        elif op == 1 and held:
            p = held.pop(int(rng.randint(len(held))))
            ja.free([p])
            ta.free([p])
        elif op == 2 and held:
            p = held[int(rng.randint(len(held)))]
            assert ja.register(p, ("k", i)) == ta.register(p, ("k", i))
        elif op == 3:
            key = ("k", int(rng.randint(max(i, 1))))
            assert ja.lookup(key) == ta.lookup(key)
            if ja.lookup(key) is not None and ja.refcount(ja.lookup(key)) == 0:
                ja.share(ja.lookup(key))
                held.append(ta.share(ta.lookup(key)))
        assert (ja.free_pages, ja.used_pages, ja.lru_pages, ja.evictions) == \
            (ta.free_pages, ta.used_pages, ta.lru_pages, ta.evictions)
        assert [ja.refcount(p) for p in range(12)] == [ta.refcount(p) for p in range(12)]
    ta.check_invariants([held])
