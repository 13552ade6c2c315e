"""Automatic prefix caching: the port's ``PrefixCache``, allocator and
engine against the JAX package's, in fp32 on the CPU.

Host logic (refcounts, the LRU, the cap, the sha256 chain) is mirrored
case for case and the chain keys are compared byte for byte.  The engine
oracles run the same shared-prefix and repeated-prompt traffic through
the JAX engine and the port with ``enable_prefix_cache`` (whole-prompt
and chunked prefill, and with multi-step decode and n-gram speculation):
the greedy streams must equal each other and cache-off's exactly, and
``cache_stats()`` must equal the JAX engine's key by key (counters are
integers: compared exactly).  Tiny llama, 2 layers, through
``params_from_numpy``."""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import PrefixCache as JaxPrefixCache
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import RaggedRequest as JaxRequest
from deepspeed_tpu.inference.v2.ragged import BlockAllocator as JaxAllocator
from deepspeed_tpu.models.llama import llama_model as jax_llama
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, RaggedInferenceConfig,
                                              RaggedRequest)
from deepspeed_tpu_torch.inference.v2.ragged import BlockAllocator, PrefixCache
from deepspeed_tpu_torch.models.llama import llama_model

torch.set_num_threads(2)

CFG = dict(dtype="fp32", page_size=8, num_pages=64, max_seqs=2, max_pages_per_seq=10)


@pytest.fixture(scope="module")
def weights():
    jmodel = jax_llama("tiny", max_seq_len=256)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    return jmodel, params, jax.tree_util.tree_map(np.asarray, params)


def _port(weights, **kw):
    return InferenceEngineV2(llama_model("tiny", max_seq_len=256),
                             RaggedInferenceConfig.from_dict(dict(CFG, **kw)),
                             params=weights[2], device="cpu")


def _jax(weights, **kw):
    return JaxEngine(weights[0], JaxConfig(**dict(CFG, **kw)), params=weights[1])


def _tokens(rng, n):
    return list(map(int, rng.randint(0, 256, n)))


# ----------------------------- host logic -------------------------------------
def test_refcount_no_free_while_referenced():
    a = BlockAllocator(4)
    (p,) = a.alloc(1)
    a.share(p)
    assert a.refcount(p) == 2
    a.free([p])
    assert a.refcount(p) == 1 and a.free_pages == 3
    with pytest.raises(MemoryError):
        a.alloc(4)
    a.free([p])
    assert a.free_pages == 4
    with pytest.raises(ValueError):
        a.free([p])  # double free
    with pytest.raises(ValueError):
        a.share(p)  # unreferenced and unregistered


def test_lru_evicts_only_unreferenced_and_in_order():
    a = BlockAllocator(4)
    pc = PrefixCache(2, a)
    pages = a.alloc(3)
    keys = [pc.chain_key(None, [i, i]) for i in range(3)]
    for p, k in zip(pages, keys):
        a.register(p, k)
    a.free([pages[1]])  # parked first: the LRU's oldest
    a.free([pages[0]])
    assert a.free_pages == 3
    got = a.alloc(3)  # the free page, then pages[1], then pages[0]
    assert a.evictions == 2
    assert pages[1] in got and pages[0] in got and pages[2] not in got
    assert a.lookup(keys[1]) is None and a.lookup(keys[0]) is None
    assert a.lookup(keys[2]) == pages[2]


def test_share_revives_cached_page_from_lru():
    a = BlockAllocator(2)
    pc = PrefixCache(2, a)
    (p,) = a.alloc(1)
    a.register(p, pc.chain_key(None, [7, 7]))
    a.free([p])
    assert a.free_pages == 2
    a.share(p)
    assert a.refcount(p) == 1 and a.free_pages == 1
    a.alloc(1)
    assert a.evictions == 0


def test_cache_cap_trims_unreferenced_cached_pages():
    a = BlockAllocator(8, cache_pages=2)
    pc = PrefixCache(2, a)
    pages = a.alloc(4)
    for i, p in enumerate(pages):
        a.register(p, pc.chain_key(None, [i, i]))
    a.free(pages)
    assert a.evictions == 2 and a.cached_pages == 2 and a.free_pages == 8
    a.check_invariants()


def test_prefix_match_chain_and_counters():
    a = BlockAllocator(8)
    pc = PrefixCache(4, a)
    tokens = list(range(12))  # 3 full pages
    keys = pc.page_keys(tokens, 3)
    pages = a.alloc(3)
    for p, k in zip(pages, keys):
        a.register(p, k)
    got, gkeys = pc.match(tokens)
    assert got == pages and gkeys == keys
    got2, _ = pc.match(tokens[:4] + [99] * 8)
    assert got2 == pages[:1]
    got3, _ = pc.match([99] + tokens[1:])
    assert got3 == []
    got4, _ = pc.match(tokens + [1, 2])
    assert got4 == pages
    # resumed from an earlier match's end: the same result
    assert pc.match(tokens, resume=(pages[:1], keys[:1])) == (pages, keys)
    assert (pc.hits, pc.misses) == (0, 0)  # match() is pure
    pc.count(len(got), len(tokens) // 4)
    pc.count(len(got2), 3)
    assert (pc.hits, pc.misses) == (4, 1)
    a.free(pages)
    a.alloc(8)
    assert a.evictions == 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_keys_are_the_jax_packages(seed):
    """The same sha256 chain, byte for byte: keys travel in bundles and
    address the NVMe tier's files, so both packages must agree."""
    rng = np.random.RandomState(seed)
    tokens = _tokens(rng, 50)
    tk = PrefixCache(8, BlockAllocator(8)).page_keys(tokens, 6)
    jk = JaxPrefixCache(8, JaxAllocator(8)).page_keys(tokens, 6)
    assert tk == jk and all(isinstance(k, bytes) and len(k) == 32 for k in tk)
    # extending a computed prefix of keys gives the same chain
    assert PrefixCache(8, BlockAllocator(8)).page_keys(tokens, 6, tk[:2]) == tk


def test_cache_stats_keys_are_the_jax_engines(weights):
    got = _port(weights, enable_prefix_cache=True).cache_stats()
    want = _jax(weights, enable_prefix_cache=True).cache_stats()
    assert got == want and set(got) == {
        "prefill_admitted_tokens", "prefill_computed_tokens", "prefix_hit_tokens",
        "cache_hits", "cache_misses", "cache_evictions", "cached_pages", "prefix_hit_rate"}


# ----------------------------- engines against JAX ----------------------------
def _traffic(seed=2):
    """Two families of a shared 24-token prefix with distinct turns, then
    a second wave repeating two prompts exactly (one page-aligned: a full
    hit)."""
    rng = np.random.RandomState(seed)
    fam_a, fam_b = _tokens(rng, 24), _tokens(rng, 16)
    first = [fam_a + _tokens(rng, n) for n in (13, 5, 28)] + [fam_b + _tokens(rng, n)
                                                            for n in (8, 19)]
    return [first, [list(first[3]), list(first[1]), fam_a[:16]]]


def _waves(eng, waves, request, max_new=6):
    out = []
    for wave in waves:
        got = eng.generate_all([request(prompt_ids=p, max_new_tokens=max_new) for p in wave])
        out.append([got[u] for u in sorted(got)])
    return out


@pytest.mark.parametrize("extra", [{}, {"prefill_chunk": 16}], ids=["whole", "chunked"])
def test_shared_prefix_streams_and_stats_match_jax(weights, extra):
    waves = _traffic()
    want_off = _waves(_port(weights, **extra), waves, RaggedRequest)
    jeng = _jax(weights, enable_prefix_cache=True, **extra)
    want = _waves(jeng, waves, JaxRequest)
    eng = _port(weights, enable_prefix_cache=True, **extra)
    got = _waves(eng, waves, RaggedRequest)
    assert got == want == want_off
    st, jst = eng.cache_stats(), jeng.cache_stats()
    assert st == jst
    assert st["cache_hits"] > 0 and st["prefix_hit_tokens"] >= 24
    assert st["prefill_computed_tokens"] < st["prefill_admitted_tokens"]
    eng.assert_no_leaks()
    assert eng.allocator.free_pages == CFG["num_pages"]


@pytest.mark.parametrize("extra", [{"decode_horizon": 4},
                                   {"speculative": {"mode": "ngram", "k": 4}}],
                         ids=["horizon_4", "spec_ngram"])
def test_cache_under_multi_step_and_speculation_matches_jax(weights, extra):
    """Pages registered by the multi-step and verify programs (only full,
    final ones: never a rolled-back draft's) give the same hits as JAX."""
    waves = _traffic(seed=5)
    waves[0].append([3, 4, 5, 6] * 6)  # repeats: the n-gram proposer drafts
    waves[1].append([3, 4, 5, 6] * 6)
    want_off = _waves(_port(weights), waves, RaggedRequest, max_new=12)
    jeng = _jax(weights, enable_prefix_cache=True, **extra)
    want = _waves(jeng, waves, JaxRequest, max_new=12)
    eng = _port(weights, enable_prefix_cache=True, **extra)
    got = _waves(eng, waves, RaggedRequest, max_new=12)
    assert got == want == want_off
    assert eng.cache_stats() == jeng.cache_stats()
    if "speculative" in extra:
        assert eng.decode_stats()["spec_verify_calls"] > 0
    else:
        assert eng.decode_stats()["decode_tokens_per_host_sync"] > 1.0
    eng.assert_no_leaks()


@pytest.mark.parametrize("extra", [{}, {"prefill_chunk": 8}], ids=["whole", "chunked"])
def test_full_prompt_cached_copy_on_write(weights, extra):
    """A page-aligned prompt cached whole enters the decode program with
    its last page copied on write: the cached page keeps its bytes, the
    sharer writes a private copy, and the stream equals cache-off's and
    JAX's."""
    prompt = _tokens(np.random.RandomState(7), 16)  # 2 pages
    want = list(_port(weights, **extra).generate_all(
        [RaggedRequest(prompt_ids=prompt, max_new_tokens=5)]).values())[0]
    jeng = _jax(weights, enable_prefix_cache=True, **extra)
    jeng.generate_all([JaxRequest(prompt_ids=prompt, max_new_tokens=5)])
    jwant = list(jeng.generate_all([JaxRequest(prompt_ids=prompt, max_new_tokens=5)])
                 .values())[0]
    eng = _port(weights, enable_prefix_cache=True, **extra)
    first = eng.generate_all([RaggedRequest(prompt_ids=prompt, max_new_tokens=5)])
    assert list(first.values())[0] == want
    keys = eng.prefix_cache.page_keys(prompt, 2)
    src = eng.allocator.lookup(keys[1])
    before = {n: t[:, src].clone() for n, t in eng._pools.items()}
    eng.put(RaggedRequest(prompt_ids=prompt, max_new_tokens=5))
    out = eng.step()  # admission and the first decode step
    seq = next(s for s in eng._slots if s is not None)
    assert seq.decode_entry
    assert seq.pages[0] == eng.allocator.lookup(keys[0])
    assert seq.pages[1] != src and eng.allocator.lookup(keys[1]) == src
    toks = list(out.values())[0]["tokens"]
    while eng.has_work():
        for _u, rec in eng.step().items():
            toks.extend(rec["tokens"])
    assert toks == want == jwant
    for n, t in eng._pools.items():
        assert torch.equal(t[:, src], before[n]), n  # the shared page untouched
    assert eng.cache_stats() == jeng.cache_stats()
    assert eng.cache_stats()["prefix_hit_tokens"] >= 15
    eng.assert_no_leaks()


def test_preempt_readmit_hits_cache(weights):
    """A preempted sequence's re-prefill maps the pages it registered
    before the eviction; the counters after it equal JAX's."""
    prompt = _tokens(np.random.RandomState(3), 28)

    def run(eng, request):
        uid = eng.put(request(prompt_ids=prompt, max_new_tokens=10))
        got = []
        for _ in range(3):
            for u, rec in eng.step().items():
                got.extend(rec["tokens"])
        eng._preempt(next(s for s in eng._slots if s is not None))
        eng.reset_cache_stats()
        while eng.has_work():
            for _u, rec in eng.step().items():
                got.extend(rec["tokens"])
        assert uid == 0
        return got, eng.cache_stats()

    got, st = run(_port(weights, enable_prefix_cache=True), RaggedRequest)
    jgot, jst = run(_jax(weights, enable_prefix_cache=True), JaxRequest)
    assert st["cache_hits"] >= 3 and st["prefix_hit_tokens"] >= 24
    assert (got, st) == (jgot, jst)
    want = _port(weights).generate_all([RaggedRequest(prompt_ids=prompt, max_new_tokens=10)])
    assert got == list(want.values())[0]


def test_cache_under_pool_pressure_stays_exact(weights):
    """A tight pool with caching: LRU eviction of unreferenced pages keeps
    admission and growth going, the streams exact and nothing leaked."""
    rng = np.random.RandomState(4)
    prompts = [_tokens(rng, 28) for _ in range(2)]
    tight = dict(num_pages=8, max_pages_per_seq=8)
    reqs = [RaggedRequest(prompt_ids=p, max_new_tokens=10) for p in prompts]
    want = _port(weights, **tight).generate_all(reqs)
    eng = _port(weights, enable_prefix_cache=True, **tight)
    got = eng.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=10) for p in prompts])
    jgot = _jax(weights, enable_prefix_cache=True, **tight).generate_all(
        [JaxRequest(prompt_ids=p, max_new_tokens=10) for p in prompts])
    assert got == want == jgot
    assert eng.allocator.free_pages == 8
    eng.assert_no_leaks()


def test_blocked_head_releases_its_claims(weights):
    """An admission that cannot fit gives its claimed matches back (they
    park, registered) and admits once pages free up, exactly."""
    rng = np.random.RandomState(8)
    fam = _tokens(rng, 16)
    prompt = fam + _tokens(rng, 12)
    want = list(_port(weights).generate_all(
        [RaggedRequest(prompt_ids=prompt, max_new_tokens=4)]).values())[0]
    eng = _port(weights, enable_prefix_cache=True, num_pages=12)
    eng.generate_all([RaggedRequest(prompt_ids=fam, max_new_tokens=2)])
    held = eng.allocator.alloc(eng.allocator.free_pages - 2)  # room for 2 only
    uid = eng.put(RaggedRequest(prompt_ids=prompt, max_new_tokens=4))
    assert eng.step() == {} and eng.queue_depth == 1
    eng.allocator.assert_no_leaks([held])  # the claims went back
    assert eng.allocator.lookup(eng.prefix_cache.page_keys(fam, 2)[1]) is not None
    eng.allocator.free(held)
    got = []
    while eng.has_work():
        for u, rec in eng.step().items():
            got.extend(rec["tokens"])
    assert got == want and uid == 1
    assert eng.cache_stats()["prefix_hit_tokens"] == 16
    eng.assert_no_leaks()
