"""The port's multi-step decode against the JAX package's, on the same
numpy weights, in fp32 on the CPU.

The pure horizon arithmetic (headroom pages, the halving chain, the
deadline clamp) gives exactly the JAX results over a seeded grid;
``paged_multi_decode`` gives the JAX tokens and produced counts on the
same pools (greedy rows, with EOS and mixed budgets); the engine's greedy
streams and its horizon counters at ``decode_horizon`` 4 equal the JAX
engine's, with chunked prefill, int8 KV and preemption.  Port-internal: a
K-step program is bit-identical to K single steps, sampled rows too, and
sampled streams are identical across horizons 1, 2 and 4 (the JAX PRNG's
bits cannot be matched, so sampled rows are held to the port's own
single-step stream)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import RaggedRequest as JaxRequest
from deepspeed_tpu.inference.v2 import engine_v2 as jeng
from deepspeed_tpu.inference.v2 import model_runner as jmr
from deepspeed_tpu.inference.v2.ragged import KVBlockConfig as JaxBlock
from deepspeed_tpu.inference.v2.ragged import PagedKVCache as JaxKVCache
from deepspeed_tpu.models.llama import llama_model as jax_llama
from deepspeed_tpu_torch.inference.v2 import (BlockAllocator, InferenceEngineV2, KVBlockConfig,
                                              PagedKVCache, RaggedInferenceConfig,
                                              RaggedRequest)
from deepspeed_tpu_torch.inference.v2 import engine_v2 as teng
from deepspeed_tpu_torch.inference.v2 import model_runner as tmr
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.models.llama import llama_model

torch.set_num_threads(2)

BASE = dict(dtype="fp32", page_size=8, num_pages=96, max_seqs=4, max_pages_per_seq=16)


@pytest.fixture(scope="module")
def weights():
    jmodel = jax_llama("tiny", max_seq_len=256)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    return jmodel, params, jax.tree_util.tree_map(np.asarray, params)


def _prompts(seed, lengths, vocab=256):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, vocab, n))) for n in lengths]


def _drive(eng, reqs, max_steps=500):
    """put + step to completion: (streams, finish reasons) in request order."""
    uids = [eng.put(r) for r in reqs]
    toks = {u: [] for u in uids}
    fin = {}
    for _ in range(max_steps):
        if not eng.has_work():
            break
        for u, rec in eng.step().items():
            toks[u].extend(rec["tokens"])
            if rec.get("done"):
                fin[u] = rec.get("finish_reason")
    return [toks[u] for u in uids], [fin.get(u) for u in uids]


def _port(weights, seed=0, **cfg):
    return InferenceEngineV2(llama_model("tiny", max_seq_len=256),
                             RaggedInferenceConfig(**cfg), params=weights[2], seed=seed,
                             device="cpu")


def _jax(weights, **cfg):
    return JaxEngine(weights[0], JaxConfig(**cfg), params=weights[1])


def _reqs(cls, prompts, n, **kw):
    return [cls(prompt_ids=list(p), max_new_tokens=n, **kw) for p in prompts]


# -- the pure horizon arithmetic ------------------------------------------------
def test_horizon_pages_needed_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(500):
        length, budget = int(rng.randint(2, 400)), int(rng.randint(1, 33))
        ps = int(rng.choice([1, 2, 4, 8, 16, 128]))
        assert (teng._horizon_pages_needed(length, budget, ps)
                == jeng._horizon_pages_needed(length, budget, ps))
    assert teng._horizon_pages_needed(17, 1, 8) == 3
    assert teng._horizon_pages_needed(16, 2, 8) == 3
    assert teng._horizon_pages_needed(10, 8, 4) == 5


def test_shrink_horizon_matches_jax():
    for k in range(1, 33):
        for cap in range(0, 40):
            assert teng._shrink_horizon(k, cap) == jeng._shrink_horizon(k, cap), (k, cap)
    assert teng._shrink_horizon(8, 3) == 4 and teng._shrink_horizon(6, 2) == 2
    assert teng._shrink_horizon(8, 0) == 1


def test_horizon_chain_is_every_shrink_value():
    for k in range(1, 33):
        chain = teng._horizon_chain(k)
        assert chain[0] == k and chain[-1] == 1
        assert sorted({teng._shrink_horizon(k, cap) for cap in range(0, k + 2)},
                      reverse=True) == chain


def test_deadline_clamp_matches_jax():
    rng = np.random.RandomState(1)
    for _ in range(500):
        budget = int(rng.randint(1, 33))
        left = float(rng.uniform(-1.0, 1.0))
        tpot = rng.choice([None, 0.0, float(rng.uniform(1e-4, 0.1))])
        assert (teng._deadline_clamp(budget, left, tpot)
                == jeng._deadline_clamp(budget, left, tpot))
    assert teng._deadline_clamp(8, 0.05, 0.01) == 5
    assert teng._deadline_clamp(8, -5.0, 0.01) == 1


def test_allocator_headroom_reservation_never_evicts_cached_pages():
    a = BlockAllocator(4)
    assert a.try_alloc(5) is None and a.free_pages == 4
    pages = a.alloc(2)
    a.register(pages[0], b"key0")
    a.free(pages)  # page 0 parks in the LRU
    assert a.try_alloc(4, uncached_only=True) is None and a.lru_pages == 1
    got = a.try_alloc(3, uncached_only=True)
    assert got is not None and a.lru_pages == 1
    a.free(got)
    got = a.try_alloc(4)  # the plain budget may claim the LRU page
    assert got is not None and a.lru_pages == 0
    a.free(got)
    a.assert_no_leaks()


def test_decode_horizon_validation():
    with pytest.raises(ValueError, match="decode_horizon"):
        RaggedInferenceConfig.from_dict(dict(BASE, decode_horizon=0))


# -- the sampler -----------------------------------------------------------------
def test_gumbel_noise_is_keyed_like_row_seed():
    """The device hash's row key is ``_row_seed`` bit for bit, its noise is
    finite and keyed by (seed, uid, position) only."""
    sids = torch.tensor([0, 5, 2 ** 31 - 1, 77], dtype=torch.int32)
    pos = torch.tensor([0, 9, 300, 4096], dtype=torch.int32)
    for seed in (0, 1, 2 ** 40 + 3):
        key = tmr._row_key(seed, sids, pos)
        assert key.tolist() == [tmr._row_seed(seed, int(s), int(p))
                                for s, p in zip(sids.tolist(), pos.tolist())]
    g = tmr.gumbel_noise(3, sids, pos, 1000)
    assert g.dtype == torch.float64 and bool(torch.isfinite(g).all())
    # the mean of Gumbel(0, 1) is the Euler-Mascheroni constant
    assert abs(g.mean().item() - 0.5772) < 0.05
    # a row's noise does not depend on its neighbours or its slot
    again = tmr.gumbel_noise(3, sids.flip(0), pos.flip(0), 1000).flip(0)
    assert torch.equal(g, again)
    assert not torch.equal(g, tmr.gumbel_noise(4, sids, pos, 1000))


def test_sample_tokens_greedy_and_distribution():
    torch.manual_seed(0)
    logits = torch.randn((4, 50))
    temps = torch.tensor([0.0, -1.0, 0.7, 1.0])
    sids = torch.arange(4, dtype=torch.int32)
    pos = torch.full((4,), 10, dtype=torch.int32)
    out = tmr.sample_tokens(logits, temps, 0, sids, pos)
    assert out.dtype == torch.int32
    assert out[:2].tolist() == torch.argmax(logits[:2], -1).tolist()
    # Gumbel-max draws follow softmax(logits / t): 4000 draws of one row
    n = 4000
    row = torch.tensor([2.0, 1.0, 0.0, -1.0])
    draws = tmr.sample_tokens(row.expand(n, 4), torch.full((n,), 1.0), 7,
                              torch.zeros(n, dtype=torch.int32),
                              torch.arange(n, dtype=torch.int32))
    freq = torch.bincount(draws.long(), minlength=4).float() / n
    assert torch.allclose(freq, torch.softmax(row, 0), atol=0.03)


# -- paged_multi_decode against the JAX function ------------------------------------
def _filled_pools(weights, quant=False):
    """Both packages' pools after the same two prefills (pages [1, 2, 3]
    and [5, 6] of a 24-page pool), and their page tables."""
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
    lengths = (20, 13)
    for b, (n, pages) in enumerate(zip(lengths, ([1, 2, 3], [5, 6]))):
        ids = np.zeros((32,), np.int32)
        ids[:n] = _prompts(40 + b, (n,))[0]
        rows = np.full((4,), trash, np.int32)
        rows[:len(pages)] = pages
        table[b, :len(pages)] = pages
        _, jpools = jmr.paged_prefill(jcfg, params, jpools, jnp.asarray(ids),
                                      jnp.asarray(rows), jnp.int32(n))
        tmr.paged_prefill(tcfg, tparams, tpools, torch.from_numpy(ids).long(),
                          torch.from_numpy(rows), n)
    # headroom pages for the multi-step rows
    table[0, 3] = 7
    table[1, 2] = 9
    return (jcfg, params, jpools), (tcfg, tparams, tpools), table


@pytest.mark.parametrize("quant", [False, True])
def test_paged_multi_decode_matches_jax(weights, quant):
    (jcfg, params, jpools), (tcfg, tparams, tpools), table = _filled_pools(weights, quant)
    last = np.array([17, 42, 0], np.int32)
    pos = np.array([20, 13, 0], np.int32)
    act = np.array([True, True, False])
    budgets = np.array([5, 3, 0], np.int32)
    temps = np.zeros((3,), np.float32)
    sids = np.array([3, 4, 5], np.int32)
    # an EOS the first row produces mid-horizon: taken from an EOS-free run
    j_toks, j_prod, _ = jmr.paged_multi_decode(
        jcfg, params, jax.tree_util.tree_map(jnp.array, jpools), jnp.asarray(last),
        jnp.asarray(pos), jnp.asarray(table), jnp.asarray(act), jnp.asarray(temps),
        jnp.full((3,), -1, jnp.int32), jnp.asarray(budgets), jnp.asarray(sids),
        jax.random.PRNGKey(0), 6)
    eos = np.array([int(np.asarray(j_toks)[0, 2]), -1, -1], np.int32)
    j_toks, j_prod, _ = jmr.paged_multi_decode(
        jcfg, params, jpools, jnp.asarray(last), jnp.asarray(pos), jnp.asarray(table),
        jnp.asarray(act), jnp.asarray(temps), jnp.asarray(eos), jnp.asarray(budgets),
        jnp.asarray(sids), jax.random.PRNGKey(0), 6)
    t = torch.from_numpy
    t_toks, t_prod, _ = tmr.paged_multi_decode(
        tcfg, tparams, tpools, t(last), t(pos), t(table), t(act), t(temps), t(eos),
        t(budgets), 0, t(sids), 6)
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    np.testing.assert_array_equal(t_prod.numpy(), np.asarray(j_prod))
    assert t_prod.tolist()[2] == 0 and (t_toks[2] == -1).all()
    assert 0 < t_prod.tolist()[0] <= 3  # stopped at its EOS
    assert t_prod.tolist()[1] == 3      # stopped at its budget


def test_multi_decode_is_k_single_steps_sampled_rows_included(weights):
    """Port-internal: the K-step program emits what K calls of the decode
    step and the sampler emit, greedy and sampled rows alike, and leaves
    the same pools."""
    _, (tcfg, tparams, tpools), table = _filled_pools(weights)
    ref_pools = {k: v.clone() for k, v in tpools.items()}
    last = torch.tensor([17, 42, 0], dtype=torch.int32)
    pos = torch.tensor([20, 13, 0], dtype=torch.int32)
    act = torch.tensor([True, True, False])
    temps = torch.tensor([0.0, 0.9, 0.0])
    sids = torch.tensor([3, 4, 5], dtype=torch.int32)
    budgets = torch.tensor([4, 4, 0], dtype=torch.int32)
    eos = torch.full((3,), -1, dtype=torch.int32)
    tab = torch.from_numpy(table)
    toks, produced, _ = tmr.paged_multi_decode(tcfg, tparams, tpools, last, pos, tab, act,
                                               temps, eos, budgets, 11, sids, 4)
    want = []
    cur, p = last.long(), pos.clone()
    for _ in range(4):
        logits, _ = tmr.paged_decode(tcfg, tparams, ref_pools, cur, p, tab, act)
        tok = tmr.sample_tokens(logits, temps, 11, sids, p + 1)
        want.append(tok)
        cur, p = tok.long(), p + 1
    want = torch.stack(want, 1)
    assert produced.tolist() == [4, 4, 0]
    assert torch.equal(toks[:2], want[:2])
    for name in tpools:
        assert torch.equal(tpools[name][:, :24], ref_pools[name][:, :24]), name


# -- the engine against the JAX engine ------------------------------------------------
ENGINE_CASES = {
    "plain": {},
    "chunked_prefill": {"prefill_chunk": 16},
    "kv_quant": {"kv_quant": True},
}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_horizon_greedy_streams_match_jax(weights, name):
    cfg = dict(BASE, decode_horizon=4, **ENGINE_CASES[name])
    prompts = _prompts(11, (13, 29, 7, 40))
    want, wfin = _drive(_jax(weights, **cfg), _reqs(JaxRequest, prompts, 17))
    eng = _port(weights, **cfg)
    got, fin = _drive(eng, _reqs(RaggedRequest, prompts, 17))
    assert got == want and fin == wfin == ["length"] * 4
    st = eng.decode_stats()
    assert st["decode_tokens_per_host_sync"] > 1.0
    eng.assert_no_leaks()
    # the plain engine gives the same streams one step at a time
    assert _drive(_port(weights, **dict(cfg, decode_horizon=1)),
                  _reqs(RaggedRequest, prompts, 17))[0] == got


def test_mid_horizon_eos_matches_jax(weights):
    cfg = dict(BASE, max_seqs=2, num_pages=64, decode_horizon=4)
    prompts = _prompts(17, (12, 21))
    ref, _ = _drive(_port(weights, **dict(cfg, decode_horizon=1)),
                    _reqs(RaggedRequest, prompts, 20))
    eos = ref[0][2]
    want, wfin = _drive(_jax(weights, **cfg), _reqs(JaxRequest, prompts, 20, eos_id=eos))
    got, fin = _drive(_port(weights, **cfg), _reqs(RaggedRequest, prompts, 20, eos_id=eos))
    assert got == want and fin == wfin
    assert fin[0] == "eos" and got[0][-1] == eos and len(got[0]) < len(ref[0])


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_horizon_with_preemption(weights, temperature):
    """KV-pool pressure preempts under the horizon: greedy streams and the
    preemption and shrink counts equal the JAX engine's; sampled streams
    equal the port's own single-step run."""
    cfg = dict(BASE, page_size=8, num_pages=10, max_seqs=2, max_pages_per_seq=10,
               decode_horizon=4)
    prompts = _prompts(23, (25, 25, 25))
    eng = _port(weights, **cfg)
    got, fin = _drive(eng, _reqs(RaggedRequest, prompts, 24, temperature=temperature))
    assert eng.stats()["preemptions"] > 0
    eng.assert_no_leaks()
    single = _port(weights, **dict(cfg, decode_horizon=1))
    assert (got, fin) == _drive(single, _reqs(RaggedRequest, prompts, 24,
                                              temperature=temperature))
    if temperature == 0.0:
        jeng_ = _jax(weights, **cfg)
        want, wfin = _drive(jeng_, _reqs(JaxRequest, prompts, 24))
        assert (got, fin) == (want, wfin)
        js, ts = jeng_.decode_stats(), eng.decode_stats()
        for key in ("decode_horizon_shrinks", "decode_host_syncs", "decode_tokens",
                    "decode_model_invocations"):
            assert ts[key] == js[key], key


def test_horizon_shrinks_under_pool_pressure_like_jax(weights):
    cfg = dict(dtype="fp32", page_size=4, num_pages=9, max_seqs=2, max_pages_per_seq=8,
               decode_horizon=8)
    prompts = _prompts(29, (10, 10))
    jeng_ = _jax(weights, **cfg)
    want, _ = _drive(jeng_, _reqs(JaxRequest, prompts, 12))
    eng = _port(weights, **cfg)
    got, _ = _drive(eng, _reqs(RaggedRequest, prompts, 12))
    assert got == want
    js, ts = jeng_.decode_stats(), eng.decode_stats()
    assert ts["decode_horizon_shrinks"] == js["decode_horizon_shrinks"] > 0
    assert ts["decode_host_syncs"] == js["decode_host_syncs"]
    single = _port(weights, **dict(cfg, decode_horizon=1))
    assert _drive(single, _reqs(RaggedRequest, prompts, 12))[0] == got
    assert ts["decode_host_syncs"] < single.decode_stats()["decode_host_syncs"]
    eng.assert_no_leaks()


def test_sampled_streams_identical_across_horizons(weights):
    prompts = _prompts(31, (9, 14, 11))

    def run(h):
        eng = _port(weights, seed=5, **dict(BASE, decode_horizon=h))
        return _drive(eng, _reqs(RaggedRequest, prompts, 13, temperature=0.8))[0]

    a = run(1)
    assert run(2) == a and run(4) == a
    assert all(0 <= t < 256 for s in a for t in s)


def test_mid_horizon_deadline_expires_without_overshoot(weights):
    cfg = dict(BASE, max_seqs=2, num_pages=64, decode_horizon=8)
    prompt = _prompts(19, (12,))[0]
    ref, _ = _drive(_port(weights, **cfg), _reqs(RaggedRequest, [prompt], 120))
    eng = _port(weights, **cfg)
    # warm every horizon and the time-per-step estimate on a short request
    _drive(eng, _reqs(RaggedRequest, [prompt[:8]], 12))
    eng._tpot_ema = 0.01  # 10 ms a step: a 30 ms deadline lands mid-horizon
    got, fin = _drive(eng, [RaggedRequest(prompt_ids=prompt, max_new_tokens=120,
                                          deadline_s=0.03)])
    eng.assert_no_leaks()
    assert fin == ["deadline"]
    assert 0 < len(got[0]) < 120 and got[0] == ref[0][:len(got[0])]


def test_speculative_engine_stands_the_horizon_down(weights, caplog):
    import logging

    from deepspeed_tpu_torch.utils.logging import logger

    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING):
            eng = _port(weights, **dict(BASE, decode_horizon=8,
                                        speculative={"mode": "ngram", "k": 4}))
    finally:
        logger.removeHandler(caplog.handler)
    assert eng._horizon == 1 and "stands down" in caplog.text
    assert not any(isinstance(k, tuple) for k in eng._programs.keys)
    got = eng.generate_all([RaggedRequest(prompt_ids=[1, 2, 3, 4, 1, 2, 3, 4],
                                          max_new_tokens=6)])
    assert len(list(got.values())[0]) == 6
    eng.assert_no_leaks()


def test_sampled_stream_independent_of_slot_under_a_horizon(weights):
    """A sampled request keeps its stream at horizon 4 whether it lands in
    slot 0 or behind a greedy request, and equals its single-step stream:
    the noise is keyed by (seed, uid, position), never the slot."""
    p = _prompts(8, (10,))[0]
    req = dict(prompt_ids=p, max_new_tokens=12, temperature=1.0, uid=7)
    cfg = dict(BASE, decode_horizon=4)
    alone = _port(weights, **cfg).generate_all([RaggedRequest(**req)])
    shifted = _port(weights, **cfg).generate_all(
        [RaggedRequest(prompt_ids=[5, 6, 7], max_new_tokens=12, uid=3), RaggedRequest(**req)])
    assert alone[7] == shifted[7]
    single = _port(weights, **dict(cfg, decode_horizon=1)).generate_all([RaggedRequest(**req)])
    assert single[7] == alone[7]
