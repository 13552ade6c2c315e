"""The port's paged serving path vs the JAX package's, on the same numpy
weights, in fp32 on the CPU.

Greedy generations must be token-identical: across queueing (more
requests than slots), chunked prefill, int8 KV, KV-pool pressure
(preemption), weight-only int8 and int4 weights (``quant_bits``), and with
the JAX side running both Pallas kernels in interpret mode
(``DSTPU_PAGED_KERNEL=1``), and for the mixtral MoE under both
``moe_drop_tokens`` settings.  The programs' logits are compared directly
with a tolerance of 1e-4 (fp32, 2 layers; CPU matmul summation order is
the only difference).  The weight-only quantized trees are held to JAX's
bit for bit: the same leaves, the same codes and scales."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.quantization import \
    quantize_inference_params as jax_quantize_params
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import RaggedRequest as JaxRequest
from deepspeed_tpu.inference.v2 import model_runner as jmr
from deepspeed_tpu.inference.v2.ragged import BlockAllocator as JaxAllocator
from deepspeed_tpu.inference.v2.ragged import KVBlockConfig as JaxBlock
from deepspeed_tpu.inference.v2.ragged import PagedKVCache as JaxKVCache
from deepspeed_tpu.models.llama import llama_model as jax_llama
from deepspeed_tpu.models.mixtral import mixtral_model as jax_mixtral
from deepspeed_tpu_torch.inference.v2 import (BlockAllocator, InferenceEngineV2,
                                              KVBlockConfig, PagedKVCache,
                                              RaggedInferenceConfig, RaggedRequest,
                                              RejectedError)
from deepspeed_tpu_torch.inference.quantization import quantize_inference_params
from deepspeed_tpu_torch.inference.v2 import model_runner as tmr
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.models.llama import llama_model
from deepspeed_tpu_torch.models.mixtral import mixtral_model

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
    {"slo_tpot_s": 1e-9}, {"timeline_every_n_steps": 5}, {"slo_ttft_s": 1e-9}])
def test_once_refused_telemetry_knobs_serve(weights, knob):
    """The three telemetry knobs that raised before serving telemetry was
    ported: an engine built with each serves, on the CPU, the greedy
    streams of the plain engine and produces what the knob asks for — a
    host-only timeline record of a step on the cadence, or one SLO
    violation per request (every request misses a 1 ns limit)."""
    from deepspeed_tpu_torch.telemetry import MetricsRegistry, get_registry, set_registry

    prompts = _prompts(seed=9, lengths=(7, 21, 12, 30, 5))
    reqs = [RaggedRequest(prompt_ids=p, max_new_tokens=10) for p in prompts]
    want = _port_engine(weights, BASE).generate_all(reqs)
    saved = get_registry()
    set_registry(MetricsRegistry())
    try:
        eng = InferenceEngineV2(llama_model("tiny", max_seq_len=256),
                                RaggedInferenceConfig.from_dict(dict(BASE, **knob)),
                                params=weights[2], device="cpu")
        got = eng.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=10)
                                for p in prompts])
        reg = get_registry()
    finally:
        set_registry(saved)
    assert got == want
    ttft = reg.get("deepspeed_tpu_serving_slo_ttft_violations_total").value()
    tpot = reg.get("deepspeed_tpu_serving_slo_tpot_violations_total").value()
    if "timeline_every_n_steps" in knob:
        rec = eng.timeline_record()
        assert rec is not None and rec["measured"] is False and rec["step"] % 5 == 0
        assert sum(rec["categories"].values()) == pytest.approx(rec["wall_seconds"], abs=1e-9)
        assert reg.get("deepspeed_tpu_timeline_captures_total").value(measured="false") > 0
        assert ttft == tpot == 0
    else:
        assert eng.timeline_record() is None
        assert (ttft, tpot) == ((len(prompts), 0) if "slo_ttft_s" in knob
                                else (0, len(prompts)))
    eng.assert_no_leaks()


@pytest.mark.parametrize("knob", [{"speculative": {"mode": "ngram"}}, {"decode_horizon": 4}],
                         ids=["speculative_ngram", "decode_horizon_4"])
def test_once_refused_knobs_serve_the_plain_greedy_streams(weights, knob):
    """The two knobs that raised before speculative and multi-step decode
    were ported: an engine built with each serves, on the CPU, the greedy
    streams of the plain engine, through the program the knob selects."""
    prompts = _prompts(seed=9, lengths=(7, 21, 12, 30, 5))
    prompts.append([3, 4, 5, 6] * 4)  # repeats: the n-gram proposer drafts
    reqs = [RaggedRequest(prompt_ids=p, max_new_tokens=10) for p in prompts]
    want = _port_engine(weights, BASE).generate_all(reqs)
    eng = InferenceEngineV2(llama_model("tiny", max_seq_len=256),
                            RaggedInferenceConfig.from_dict(dict(BASE, **knob)),
                            params=weights[2], device="cpu")
    got = eng.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=10) for p in prompts])
    assert got == want
    st = eng.decode_stats()
    if "speculative" in knob:
        assert st["spec_verify_calls"] > 0 and st["spec_accepted_tokens"] > 0
    else:
        assert st["decode_tokens_per_host_sync"] > 1.0
    eng.assert_no_leaks()


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


# -- weight-only quantized weights (quant_bits) --------------------------------
#: the JAX package's own quantized-engine test sizes
#: (tests/unit/test_inference_v2.py:229-234): tiny matrices, group 64
QUANT = dict(quant_group=64, quant_min_size=1024)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_inference_params_matches_jax(weights, bits):
    """The same leaves quantized, per-layer codes and scales equal to the
    stacked JAX ones, the same byte counts, fp32 scales."""
    _, params, np_params = weights
    want, jb, ja = jax_quantize_params(params, bits, 64, min_size=1024)
    tparams = params_from_numpy(np_params, llama_model("tiny").config, "cpu")
    got, tb, ta = quantize_inference_params(tparams, bits, 64, min_size=1024)
    assert (tb, ta) == (jb, ja)
    w, g = _flat(jax.tree_util.tree_map(np.asarray, want)), _flat(params_to_numpy(got))
    assert sorted(w) == sorted(g)
    quantized = sorted(k for k in w if k.endswith("/wq"))
    assert quantized == ["layers/attn/wk/wq", "layers/attn/wo/wq", "layers/attn/wq/wq",
                         "layers/attn/wv/wq", "layers/mlp/w_down/wq", "layers/mlp/w_gate/wq",
                         "layers/mlp/w_up/wq", "lm_head/w/wq"]
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    leaf = got.layers[1].attn.wq
    assert leaf.wq.dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert leaf.scale.dtype == torch.float32


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", ["queueing", "chunked"])
def test_quantized_greedy_streams_token_identical(weights, bits, case):
    cfg = dict(BASE, **CASES[case], quant_bits=bits, **QUANT)
    prompts = _prompts(seed=9)
    jmodel, params, _ = weights
    jeng = JaxEngine(jmodel, JaxConfig(**cfg), params=params)
    want = jeng.generate_all([JaxRequest(prompt_ids=p, max_new_tokens=8) for p in prompts])
    eng = _port_engine(weights, cfg)
    got = eng.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=8) for p in prompts])
    assert got == want
    assert eng.param_bytes == jeng.param_bytes
    assert eng.cfg.wq_bits == bits and eng.cfg.wq_group == 64
    assert "wq" in eng.params.lm_head.w and "wq" in eng.params.layers[0].mlp.w_down
    assert eng.params.layers[0].mlp.w_down.scale.dtype == torch.float32


def test_quantized_engine_keeps_flags_and_weights_of_its_caller(weights):
    """The flags land on the engine's own config copy, and the tree it was
    given keeps its float weights (the engine quantizes into a new tree)."""
    model = llama_model("tiny", max_seq_len=256)
    tparams = params_from_numpy(weights[2], model.config, "cpu")
    fp = InferenceEngineV2(model, RaggedInferenceConfig(**BASE), params=tparams, device="cpu")
    q8 = InferenceEngineV2(model, RaggedInferenceConfig(**BASE, quant_bits=8, **QUANT),
                           params=tparams, device="cpu")
    assert model.config.wq_bits == 0 and fp.cfg.wq_bits == 0 and q8.cfg.wq_bits == 8
    assert isinstance(tparams.layers[0].attn.wq, torch.Tensor)
    assert q8.param_bytes < fp.param_bytes * 0.72
    with pytest.raises(ValueError, match="quant_bits"):
        RaggedInferenceConfig.from_dict(dict(BASE, quant_bits=6))


def test_quantized_tree_crosses_the_bridge_with_fp32_scales(weights):
    """params_to_numpy keeps the codes' integer type; params_from_numpy in
    bf16 casts the float leaves but not the scales."""
    tparams = params_from_numpy(weights[2], llama_model("tiny").config, "cpu")
    q, _, _ = quantize_inference_params(tparams, 4, 64, min_size=1024)
    tree = params_to_numpy(q)
    assert tree["layers"]["attn"]["wq"]["wq"].dtype == np.uint8
    back = params_from_numpy(tree, llama_model("tiny").config, "cpu", torch.bfloat16)
    assert back.layers[1].attn.wq.scale.dtype == torch.float32
    assert back.layers[1].attn.wq.wq.dtype == torch.uint8
    assert back.layers[1].norm1.scale.dtype == torch.bfloat16
    assert torch.equal(back.layers[1].attn.wq.scale, q.layers[1].attn.wq.scale)


# -- mixtral (MoE): dropless grouped matmul and the capacity path ------------
MOE_CASES = {"queueing": {}, "chunked": dict(prefill_chunk=16),
             "kv_quant": dict(kv_quant=True), "quant_bits_8": dict(quant_bits=8, **QUANT)}


@pytest.fixture(scope="module")
def moe_weights():
    params = jax_mixtral("tiny", max_seq_len=256).init_params(jax.random.PRNGKey(1))
    return params, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("drop", [False, True])
def test_mixtral_greedy_streams_token_identical(moe_weights, drop, case):
    """Every prefill, chunk and decode call routes its bucket-padded prompt
    rows and inactive slots through the MoE, as the JAX runner does; the
    capacity path (drop_tokens) prices capacity with the eval factor."""
    params, np_params = moe_weights
    cfg = dict(BASE, **MOE_CASES[case])
    prompts = _prompts(seed=10)
    jeng = JaxEngine(jax_mixtral("tiny", max_seq_len=256, moe_drop_tokens=drop),
                     JaxConfig(**cfg), params=params)
    want = jeng.generate_all([JaxRequest(prompt_ids=p, max_new_tokens=8) for p in prompts])
    eng = InferenceEngineV2(mixtral_model("tiny", max_seq_len=256, moe_drop_tokens=drop),
                            RaggedInferenceConfig(**cfg), params=np_params, device="cpu")
    got = eng.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=8) for p in prompts])
    assert got == want
    assert eng.param_bytes == jeng.param_bytes


def test_mixtral_quantized_tree_keeps_experts_full_precision(moe_weights):
    """quant_bits: the attention projections and the head are quantized as
    JAX quantizes them; the [E, H, F] expert leaves and the router stay
    full precision, leaf for leaf."""
    params, np_params = moe_weights
    want, jb, ja = jax_quantize_params(params, 8, 64, min_size=1024)
    tparams = params_from_numpy(np_params, mixtral_model("tiny").config, "cpu")
    got, tb, ta = quantize_inference_params(tparams, 8, 64, min_size=1024)
    assert (tb, ta) == (jb, ja)
    w, g = _flat(jax.tree_util.tree_map(np.asarray, want)), _flat(params_to_numpy(got))
    assert sorted(w) == sorted(g)
    assert sorted(k for k in w if k.endswith("/wq")) == [
        "layers/attn/wk/wq", "layers/attn/wo/wq", "layers/attn/wq/wq", "layers/attn/wv/wq",
        "lm_head/w/wq"]
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert got.layers[0].mlp.get(name).dtype == torch.float32
