"""The port's speculative decoding against the JAX package's, on the same
numpy weights, in fp32 on the CPU.

``NgramProposer.propose`` and ``longest_accepted`` give exactly the JAX
results over a seeded grid; ``paged_verify`` gives the JAX logits on the
same pools (rtol and atol 1e-5); the engine's greedy streams and its spec
counters (proposed, accepted, verify calls, rollback pages, fallbacks)
equal the JAX engine's with the n-gram proposer and with a draft model
sharing the JAX draft's weights.  Port-internal: the verify program's
windows reproduce the plain decode step's logits, the sampling guard,
empty drafts, pool pressure and preemption keep streams exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import RaggedRequest as JaxRequest
from deepspeed_tpu.inference.v2 import model_runner as jmr
from deepspeed_tpu.inference.v2 import speculative as jspec
from deepspeed_tpu.inference.v2.ragged import KVBlockConfig as JaxBlock
from deepspeed_tpu.inference.v2.ragged import PagedKVCache as JaxKVCache
from deepspeed_tpu.models.llama import llama_model as jax_llama
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, KVBlockConfig, PagedKVCache,
                                              RaggedInferenceConfig, RaggedRequest)
from deepspeed_tpu_torch.inference.v2 import model_runner as tmr
from deepspeed_tpu_torch.inference.v2 import speculative as tspec
from deepspeed_tpu_torch.inference.v2.engine_v2 import SpeculativeConfig as EngineSpecConfig
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.models.llama import llama_model

torch.set_num_threads(2)

BASE = dict(dtype="fp32", page_size=8, num_pages=64, max_seqs=2, max_pages_per_seq=16)
SPEC_KEYS = ("spec_proposed_tokens", "spec_accepted_tokens", "spec_verify_calls",
             "spec_rollback_pages", "spec_fallback_requests", "decode_model_invocations",
             "decode_host_syncs", "decode_tokens")


@pytest.fixture(scope="module")
def weights():
    jmodel = jax_llama("tiny", max_seq_len=256)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    return jmodel, params, jax.tree_util.tree_map(np.asarray, params)


def _prompts(seed, lengths, vocab=256):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, n))) for n in lengths]


def _port(weights, spec=None, proposer=None, **kw):
    cfg = dict(BASE, **kw)
    if spec is not None:
        cfg["speculative"] = spec
    return InferenceEngineV2(llama_model("tiny", max_seq_len=256),
                             RaggedInferenceConfig.from_dict(cfg), params=weights[2],
                             device="cpu", proposer=proposer)


def _jax(weights, spec=None, proposer=None, **kw):
    cfg = dict(BASE, **kw)
    if spec is not None:
        cfg["speculative"] = spec
    return JaxEngine(weights[0], JaxConfig.from_dict(cfg), params=weights[1],
                     proposer=proposer)


def _reqs(cls, prompts, n=24, temperature=0.0):
    return [cls(prompt_ids=list(p), max_new_tokens=n, temperature=temperature)
            for p in prompts]


# -- proposers and the accept rule ---------------------------------------------------
def test_ngram_proposer_matches_jax_over_a_grid():
    rng = np.random.RandomState(0)
    for _ in range(400):
        lo = int(rng.randint(1, 4))
        hi = lo + int(rng.randint(0, 3))
        tokens = list(map(int, rng.randint(0, int(rng.choice([3, 5, 50])),
                                           int(rng.randint(0, 40)))))
        k = int(rng.randint(0, 7))
        assert (tspec.NgramProposer(lo, hi).propose(tokens, k)
                == jspec.NgramProposer(lo, hi).propose(tokens, k)), (lo, hi, tokens, k)


def test_ngram_proposer_cases():
    p = tspec.NgramProposer(ngram_min=1, ngram_max=3)
    assert p.propose([1, 2, 3, 9, 8, 7, 1, 2, 3], 3) == [9, 8, 7]
    assert p.propose([1, 2, 3, 9, 8, 7, 1, 2, 3], 2) == [9, 8]
    assert p.propose([1, 2, 3, 4, 5], 4) == [] and p.propose([], 4) == []
    assert p.propose([7], 4) == [] and p.propose([1, 2, 3, 1], 0) == []
    p2 = tspec.NgramProposer(ngram_min=1, ngram_max=2)
    assert p2.propose([1, 2, 3, 5, 3, 6, 2, 3], 1) == [5]
    assert p2.propose([4, 5, 6, 7, 4, 5, 4], 3) == [5, 6, 7]
    assert p2.propose([4, 5, 4], 3) == [5, 4]


def test_longest_accepted_matches_jax_over_a_grid():
    rng = np.random.RandomState(1)
    for _ in range(500):
        n = int(rng.randint(0, 6))
        verified = list(map(int, rng.randint(0, 3, n + 1)))
        draft = list(map(int, rng.randint(0, 3, n)))
        assert (tspec.longest_accepted(draft, verified)
                == jspec.longest_accepted(draft, verified))
    assert tspec.longest_accepted([5, 9, 7], [5, 6, 7, 8]) == ([5], 6)
    assert tspec.longest_accepted([], [5]) == ([], 5)


def test_speculative_config_validation_and_import_path():
    assert EngineSpecConfig is tspec.SpeculativeConfig
    tspec.SpeculativeConfig(mode="ngram", k=4).validate()
    for bad in (dict(mode="bogus"), dict(mode="ngram", k=0),
                dict(mode="ngram", ngram_min=3, ngram_max=2), dict(mode="draft")):
        with pytest.raises(ValueError):
            tspec.SpeculativeConfig(**bad).validate()
    r = RaggedInferenceConfig.from_dict({"speculative": {"mode": "ngram", "k": 2}})
    assert r.speculative.k == 2 and r.speculative.enabled
    with pytest.raises(ValueError):
        RaggedInferenceConfig.from_dict({"speculative": {"mode": "bogus"}})


# -- paged_verify against the JAX function --------------------------------------------
@pytest.mark.parametrize("quant", [False, True])
def test_paged_verify_logits_match_jax(weights, quant):
    """Two sequences prefilled into the same pages of both packages' pools,
    then one verify window each (W = 5, row 1 with 3 valid tokens, a third
    row inactive): logits within rtol 1e-5, atol 1e-5."""
    jmodel, params, np_params = weights
    jcfg = jmodel.config
    tcfg = llama_model("tiny", max_seq_len=256).config
    tparams = params_from_numpy(np_params, tcfg, "cpu")
    block = dict(page_size=8, num_pages=24, max_seqs=3, max_pages_per_seq=6)
    jpools = JaxKVCache.init(jcfg.n_layers, jcfg.kv_heads, jcfg.head_dim, JaxBlock(**block),
                             jnp.float32, kv_quant=quant)
    tpools = PagedKVCache.init(tcfg.n_layers, tcfg.kv_heads, tcfg.head_dim,
                               KVBlockConfig(**block), torch.float32, kv_quant=quant,
                               device="cpu")
    trash = 24
    table = np.full((3, 6), trash, np.int32)
    for b, (n, pages) in enumerate(((20, [1, 2, 3]), (13, [5, 6]))):
        ids = np.zeros((32,), np.int32)
        ids[:n] = _prompts(40 + b, (n,))[0]
        rows = np.full((4,), trash, np.int32)
        rows[:len(pages)] = pages
        table[b, :len(pages)] = pages
        _, jpools = jmr.paged_prefill(jcfg, params, jpools, jnp.asarray(ids),
                                      jnp.asarray(rows), jnp.int32(n))
        tmr.paged_prefill(tcfg, tparams, tpools, torch.from_numpy(ids).long(),
                          torch.from_numpy(rows), n)
    table[0, 3] = 7  # the window of row 0 crosses into a fourth page
    ids = np.array([[17, 4, 9, 200, 31], [42, 8, 8, 0, 0], [0, 0, 0, 0, 0]], np.int32)
    pos = np.array([19, 12, 0], np.int32)
    act = np.array([True, True, False])
    nv = np.array([5, 3, 1], np.int32)
    jl, jpools = jmr.paged_verify(jcfg, params, jpools, jnp.asarray(ids), jnp.asarray(pos),
                                  jnp.asarray(table), jnp.asarray(act), jnp.asarray(nv))
    t = torch.from_numpy
    tl, _ = tmr.paged_verify(tcfg, tparams, tpools, t(ids), t(pos), t(table), t(act), t(nv))
    assert tl.shape == (3, 5, tcfg.vocab_size)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl[0].numpy(), jl[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl[1, :3].numpy(), jl[1, :3], rtol=1e-5, atol=1e-5)
    live = [1, 2, 3, 5, 6, 7]
    for name in jpools:
        np.testing.assert_allclose(tpools[name][:, live].float().numpy(),
                                   np.asarray(jpools[name][:, live], np.float32),
                                   rtol=1e-5, atol=1e-5 if name.endswith("scale") or not quant
                                   else 1)


def test_paged_verify_windows_are_plain_decode_steps(weights):
    """Port-internal: position w of a verify window gives the logits a
    plain decode step gives after consuming the window's first w + 1
    tokens (the decode step through its own gather path)."""
    np_params = weights[2]
    tcfg = llama_model("tiny", max_seq_len=256).config
    tparams = params_from_numpy(np_params, tcfg, "cpu")
    pools = PagedKVCache.init(tcfg.n_layers, tcfg.kv_heads, tcfg.head_dim,
                              KVBlockConfig(page_size=8, num_pages=8, max_seqs=1,
                                            max_pages_per_seq=4), torch.float32,
                              device="cpu")
    ids = torch.zeros(16, dtype=torch.long)
    ids[:10] = torch.tensor(_prompts(3, (10,))[0])
    tmr.paged_prefill(tcfg, tparams, pools, ids, torch.tensor([0, 1], dtype=torch.int32), 10)
    table = torch.tensor([[0, 1, 2, 8]], dtype=torch.int32)
    window = [7, 100, 3, 55]
    ref = {k: v.clone() for k, v in pools.items()}
    vl, _ = tmr.paged_verify(tcfg, tparams, pools, torch.tensor([window], dtype=torch.int32),
                             torch.tensor([10], dtype=torch.int32), table,
                             torch.tensor([True]), torch.tensor([4], dtype=torch.int32))
    for w, tok in enumerate(window):
        dl, _ = tmr.paged_decode(tcfg, tparams, ref, torch.tensor([tok]),
                                 torch.tensor([10 + w], dtype=torch.int32), table,
                                 torch.tensor([True]))
        torch.testing.assert_close(vl[0, w], dl[0], rtol=1e-5, atol=1e-5)


# -- the engine against the JAX engine --------------------------------------------------
@pytest.mark.parametrize("extra", [{}, {"prefill_chunk": 16}], ids=["whole", "chunked"])
def test_ngram_greedy_streams_and_counters_match_jax(weights, extra):
    rng = np.random.RandomState(2)
    shared = list(map(int, rng.randint(0, 256, 16)))
    prompts = [shared + list(map(int, rng.randint(0, 256, m))) for m in (5, 11)]
    prompts.append([3, 9, 27, 81] * 5)
    spec = {"mode": "ngram", "k": 4}
    base = _port(weights, **extra)
    want = base.generate_all(_reqs(RaggedRequest, prompts))
    jeng = _jax(weights, spec=spec, **extra)
    assert jeng.generate_all(_reqs(JaxRequest, prompts)) == want
    eng = _port(weights, spec=spec, **extra)
    assert eng.generate_all(_reqs(RaggedRequest, prompts)) == want
    js, ts = jeng.decode_stats(), eng.decode_stats()
    assert {k: ts[k] for k in SPEC_KEYS} == {k: js[k] for k in SPEC_KEYS}
    assert ts["spec_verify_calls"] > 0 and ts["spec_accepted_tokens"] > 0
    assert ts["decode_model_invocations"] < base.decode_stats()["decode_model_invocations"]
    assert ts["decode_tokens"] == base.decode_stats()["decode_tokens"]
    eng.assert_no_leaks()


def test_draft_model_greedy_streams_and_counters_match_jax(weights):
    """Draft mode with the same draft weights in both packages: a 1-layer
    tiny llama initialized by JAX, its numpy tree handed to the port."""
    jdraft = jax_llama("tiny", max_seq_len=256, n_layers=1)
    dparams = jdraft.init_params(jax.random.PRNGKey(3))
    np_dparams = jax.tree_util.tree_map(np.asarray, dparams)
    prompts = _prompts(5, (9, 20))
    spec = {"mode": "draft", "k": 3, "draft_model": "tiny"}
    jeng = _jax(weights, spec=spec, proposer=jspec.DraftModelProposer(jdraft, dparams))
    tprop = tspec.DraftModelProposer(llama_model("tiny", max_seq_len=256, n_layers=1),
                                     np_dparams, device="cpu")
    eng = _port(weights, spec=spec, proposer=tprop)
    want = jeng.generate_all(_reqs(JaxRequest, prompts, n=12))
    assert eng.generate_all(_reqs(RaggedRequest, prompts, n=12)) == want
    assert _port(weights).generate_all(_reqs(RaggedRequest, prompts, n=12)) == want
    js, ts = jeng.decode_stats(), eng.decode_stats()
    assert {k: ts[k] for k in SPEC_KEYS} == {k: js[k] for k in SPEC_KEYS}
    assert ts["spec_verify_calls"] > 0
    # the draft's proposals themselves equal the JAX draft's
    hist = prompts[1]
    assert tprop.propose(hist, 4) == jspec.DraftModelProposer(jdraft, dparams).propose(hist, 4)
    eng.assert_no_leaks()


def test_draft_mode_from_the_config_is_lossless(weights):
    """``mode="draft"`` with a size and no weights: a seeded draft the
    engine builds itself; its drafts may all miss, the streams stay the
    plain engine's."""
    prompts = _prompts(6, (7, 15))
    eng = _port(weights, spec={"mode": "draft", "k": 2, "draft_model": "tiny"})
    assert isinstance(eng._proposer, tspec.DraftModelProposer)
    got = eng.generate_all(_reqs(RaggedRequest, prompts, n=8))
    assert got == _port(weights).generate_all(_reqs(RaggedRequest, prompts, n=8))
    assert eng.decode_stats()["spec_verify_calls"] > 0
    eng.assert_no_leaks()


def test_empty_drafts_take_the_plain_decode_program(weights):
    class Blank:
        def propose(self, tokens, k):
            return []

    prompts = _prompts(3, (7, 12))
    base = _port(weights)
    want = base.generate_all(_reqs(RaggedRequest, prompts, n=10))
    eng = _port(weights, spec={"mode": "ngram"}, proposer=Blank())
    assert eng.generate_all(_reqs(RaggedRequest, prompts, n=10)) == want
    st = eng.decode_stats()
    assert st["spec_verify_calls"] == 0
    assert st["decode_model_invocations"] == base.decode_stats()["decode_model_invocations"]
    eng.assert_no_leaks()


def test_spec_under_pool_pressure_and_preemption_matches_jax(weights):
    rng = np.random.RandomState(4)
    prompts = [list(map(int, rng.randint(0, 256, 28))) for _ in range(2)]
    prompts[1][-8:] = prompts[1][-16:-8]  # a repeat, so drafts land
    kw = dict(num_pages=8, max_pages_per_seq=8)
    spec = {"mode": "ngram", "k": 4}
    want = _port(weights, **kw).generate_all(_reqs(RaggedRequest, prompts, n=10))
    jeng = _jax(weights, spec=spec, **kw)
    assert jeng.generate_all(_reqs(JaxRequest, prompts, n=10)) == want
    eng = _port(weights, spec=spec, **kw)
    assert eng.generate_all(_reqs(RaggedRequest, prompts, n=10)) == want
    assert eng.allocator.free_pages == 8
    js, ts = jeng.decode_stats(), eng.decode_stats()
    assert {k: ts[k] for k in SPEC_KEYS} == {k: js[k] for k in SPEC_KEYS}
    assert eng.stats()["preemptions"] > 0
    eng.assert_no_leaks()


def test_spec_preempt_midstream_recovers_exact(weights):
    prompt = _prompts(5, (12,))[0]
    want = _port(weights).generate_all(_reqs(RaggedRequest, [prompt], n=16))
    eng = _port(weights, spec={"mode": "ngram", "k": 4})
    uid = eng.put(_reqs(RaggedRequest, [prompt], n=16)[0])
    got = []
    for _ in range(3):
        got.extend(eng.step().get(uid, {"tokens": []})["tokens"])
    eng._preempt(next(s for s in eng._slots if s is not None))
    eng.assert_no_leaks()
    while eng.has_work():
        got.extend(eng.step().get(uid, {"tokens": []})["tokens"])
    assert got == list(want.values())[0]
    eng.assert_no_leaks()


def test_sampled_requests_fall_back_to_plain_decode(weights, caplog):
    import logging

    from deepspeed_tpu_torch.utils.logging import logger

    prompts = _prompts(6, (9, 9))
    want = _port(weights).generate_all(_reqs(RaggedRequest, prompts, n=8, temperature=0.7))
    eng = _port(weights, spec={"mode": "ngram", "k": 4})
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING):
            got = eng.generate_all(_reqs(RaggedRequest, prompts, n=8, temperature=0.7))
    finally:
        logger.removeHandler(caplog.handler)
    assert got == want
    st = eng.decode_stats()
    assert st["spec_fallback_requests"] == 2
    assert st["spec_verify_calls"] == 0 and st["spec_proposed_tokens"] == 0
    assert caplog.text.count("fall back") == 1


def test_draft_clamps_tokens_past_its_vocabulary_like_jax():
    """A draft whose vocabulary is smaller than the target's (the "tiny"
    draft of a 32000-token model) embeds a token past it as its last row,
    as the JAX draft's clamped gather does."""
    jdraft = jax_llama("tiny", max_seq_len=256, n_layers=1)
    dparams = jdraft.init_params(jax.random.PRNGKey(4))
    tprop = tspec.DraftModelProposer(llama_model("tiny", max_seq_len=256, n_layers=1),
                                     jax.tree_util.tree_map(np.asarray, dparams),
                                     device="cpu")
    hist = [5, 300, 31999, 17, 256, 9]
    assert tprop.propose(hist, 3) == jspec.DraftModelProposer(jdraft, dparams).propose(hist, 3)
    assert tprop.forwards == 3
