"""The tiered KV cache: the port's ``serving/kv_tier.py`` and the engine's
spill, drain, restore and prefetch, on the CPU.

Host logic (the host LRU's byte budget, order and CRC refusal, the
allocator's spill pins, the NVMe tier's files) is mirrored case for case
from the JAX package's tests.  The engine oracles hold a prefix cache
capped below the working set, with the host tier, to an uncapped engine
(the port's and the JAX package's): the greedy streams must be equal
exactly, plain, chunked, n-gram speculative, at decode horizon 4 and with
int8 KV, the tier engaged (pages spilled and restored, none corrupt) and
no page leaked.  The pools must keep their storage (``data_ptr``) through
a copy on write, an import, a drain and a restore: the captured programs
read them.  Tiny llama in fp32, 2 layers, through ``params_from_numpy``."""

import dataclasses
import os
import time

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import RaggedRequest as JaxRequest
from deepspeed_tpu.models.llama import llama_model as jax_llama
from deepspeed_tpu.serving.config import KVTierConfig as JaxTierConfig
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, RaggedInferenceConfig,
                                              RaggedRequest)
from deepspeed_tpu_torch.inference.v2.ragged import BlockAllocator, KVPageBundle, PrefixCache
from deepspeed_tpu_torch.models.llama import llama_model
from deepspeed_tpu_torch.serving import (HostKVTier, KVTierConfig, NVMeKVTier, batch_page_crcs,
                                         bundle_to_bytes)
from deepspeed_tpu_torch.serving.kv_transfer import _MAGIC, rebase_deadline_left

torch.set_num_threads(2)

PS = 8  # page size of the engine oracles


def _page(v, nbytes=256):
    """A gathered page: one leaf, ``[L=1, 1, n]`` float32."""
    return {"k": torch.full((1, 1, nbytes // 4), float(v))}


def _put(tier, key, v, nbytes=256):
    arrays = _page(v, nbytes)
    return tier.insert(key, arrays, batch_page_crcs(arrays)[0])


def _flip(t, at):
    t.view(-1).view(torch.uint8)[at] ^= 0x40


# ----------------------------- host LRU ---------------------------------------
def test_host_lru_byte_budget_and_eviction_order():
    tier = HostKVTier(KVTierConfig(enabled=True, host_bytes=3 * 256))
    for i in range(3):
        assert _put(tier, f"k{i}".encode(), i)
    assert tier.host_pages == 3 and tier.host_bytes == 3 * 256
    _put(tier, b"k3", 3)
    assert tier.host_pages == 3 and not tier.has(b"k0") and tier.has(b"k3")
    assert tier.host_evictions == 1
    assert tier.get(b"k1") is not None  # a hit refreshes recency
    _put(tier, b"k4", 4)
    assert tier.has(b"k1") and not tier.has(b"k2")


def test_host_lru_restore_is_bit_identical_and_reput_replaces():
    tier = HostKVTier(KVTierConfig(enabled=True, host_bytes=1 << 20))
    arrays = _page(7)
    tier.insert(b"a", arrays, batch_page_crcs(arrays)[0])
    assert torch.equal(tier.get(b"a")["k"], arrays["k"])
    arrays2 = _page(9)
    tier.insert(b"a", arrays2, batch_page_crcs(arrays2)[0])
    assert tier.host_pages == 1 and tier.host_bytes == 256
    assert torch.equal(tier.get(b"a")["k"], arrays2["k"])


def test_crc_refusal_drops_entry_loudly():
    tier = HostKVTier(KVTierConfig(enabled=True, host_bytes=1 << 20))
    _put(tier, b"good", 1)
    _put(tier, b"bad", 2)
    _flip(tier._lru[b"bad"][0]["k"], 3)  # a host-RAM bit flip
    assert tier.get(b"bad") is None and not tier.has(b"bad")
    assert tier.corrupt_pages == 1
    assert tier.get(b"good") is not None


def test_oversized_page_refused():
    tier = HostKVTier(KVTierConfig(enabled=True, host_bytes=100))
    assert not _put(tier, b"big", 1, nbytes=256)
    assert tier.host_pages == 0 and tier.dropped_spills == 1


def test_stats_keys_are_the_jax_tiers(tmp_path):
    from deepspeed_tpu.serving.kv_tier import HostKVTier as JaxHostKVTier

    for nvme in (False, True):
        kw = dict(enabled=True, nvme_enabled=nvme, nvme_dir=str(tmp_path / str(nvme)))
        got = HostKVTier(KVTierConfig(**kw)).stats()
        want = JaxHostKVTier(JaxTierConfig(**kw)).stats()
        assert got == want


@pytest.mark.parametrize("bad", [{"host_bytes": -1}, {"spill_inflight": 0},
                                 {"prefetch_requests": -1}, {"nvme_bytes": -1}])
def test_config_validation(bad):
    with pytest.raises(ValueError):
        KVTierConfig(enabled=True, **bad).validate()
    with pytest.raises(ValueError):
        KVTierConfig.from_dict(dict(enabled=True, **bad))
    with pytest.raises(ValueError):
        RaggedInferenceConfig.from_dict({"enable_prefix_cache": True,
                                         "kv_tier": dict(enabled=True, **bad)})


def test_tier_needs_the_prefix_cache_in_both_packages():
    """``kv_tier.enabled`` without ``enable_prefix_cache`` raises, as in
    JAX: the tier captures the prefix cache's LRU evictions."""
    cfg = dict(dtype="fp32", page_size=8, num_pages=16, max_seqs=2, max_pages_per_seq=8)
    with pytest.raises(ValueError, match="requires enable_prefix_cache"):
        JaxEngine(jax_llama("tiny"), JaxConfig(kv_tier={"enabled": True}, **cfg))
    port_cfg = RaggedInferenceConfig.from_dict(dict(cfg, kv_tier={"enabled": True}))
    assert isinstance(port_cfg.kv_tier, KVTierConfig) and port_cfg.kv_tier.enabled
    with pytest.raises(ValueError, match="requires enable_prefix_cache"):
        InferenceEngineV2(llama_model("tiny"), port_cfg, device="cpu")
    # disabled, the block is accepted and no tier is built
    off = InferenceEngineV2(llama_model("tiny"), RaggedInferenceConfig.from_dict(
        dict(cfg, kv_tier={"enabled": False})), device="cpu")
    assert off.kv_tier is None and off.tier_stats() == {}


# ----------------------------- allocator spill pins ---------------------------
def test_spill_hook_pins_until_release():
    a = BlockAllocator(4)
    pc = PrefixCache(2, a)
    captured = []
    a.spill_hook = lambda page, key: captured.append((page, key)) or True
    pages = a.alloc(2)
    keys = [pc.chain_key(None, [i, i]) for i in range(2)]
    for p, k in zip(pages, keys):
        a.register(p, k)
    a.free(pages)
    assert a.free_pages == 4
    got = a.alloc(3)  # slack 1: one capture, then the next evictee is handed out
    assert len(captured) == 1 and captured[0][1] == keys[0]
    pinned = captured[0][0]
    assert a.spill_pinned_pages == 1 and pinned not in got
    assert a.free_pages == 0
    with pytest.raises(MemoryError):
        a.alloc(1)
    a.check_invariants()
    a.assert_no_leaks([got])
    a.release_spill_pin(pinned)
    assert a.free_pages == 1 and a.spill_pinned_pages == 0
    assert a.alloc(1) == [pinned]
    with pytest.raises(ValueError):
        a.release_spill_pin(pinned)


def test_alloc_slack_never_starves_allocation():
    a = BlockAllocator(2)
    pc = PrefixCache(2, a)
    a.spill_hook = lambda page, key: True
    pages = a.alloc(2)
    for i, p in enumerate(pages):
        a.register(p, pc.chain_key(None, [i]))
    a.free(pages)
    got = a.alloc(2)
    assert sorted(got) == sorted(pages) and a.spill_pinned_pages == 0


def test_trim_capture_does_not_over_evict():
    a = BlockAllocator(8, cache_pages=2)
    pc = PrefixCache(2, a)
    pages = a.alloc(3)
    for i, p in enumerate(pages):
        a.register(p, pc.chain_key(None, [i]))
    a.spill_hook = lambda page, key: True
    a.free(pages)
    assert a.lru_pages == 2 and a.spill_pinned_pages == 1 and a.cached_pages == 2
    a.check_invariants()


def test_invariants_flag_spill_pin_corruption():
    a = BlockAllocator(4, cache_pages=1)
    pc = PrefixCache(2, a)
    a.spill_hook = lambda page, key: True
    pages = a.alloc(2)
    for i, p in enumerate(pages):
        a.register(p, pc.chain_key(None, [i]))
    a.free(pages)
    assert a.spill_pinned_pages == 1
    a.assert_no_leaks([])
    (pin,) = a._spill_pinned
    a._ref[pin] = 0
    with pytest.raises(AssertionError):
        a.check_invariants()


def test_prefix_match_consults_host_tier():
    a = BlockAllocator(8)
    pc = PrefixCache(2, a)
    tokens = [1, 2, 3, 4, 5, 6, 7, 8]
    keys = pc.page_keys(tokens, 4)
    (p0,) = a.alloc(1)
    a.register(p0, keys[0])

    class FakeTier:
        def has(self, k):
            return k in (keys[1], keys[3])

    pages, got_keys, host_keys = pc.match(tokens, host_tier=FakeTier())
    assert pages == [p0] and got_keys == [keys[0]]
    assert host_keys == [keys[1]]  # consecutive only: page 3 lies past a gap
    assert pc.match(tokens) == ([p0], [keys[0]])


# ----------------------------- NVMe tier --------------------------------------
def _nvme_cfg(tmp_path, nvme_bytes=16 << 30, host_bytes=1 << 30):
    return KVTierConfig(enabled=True, host_bytes=host_bytes, nvme_enabled=True,
                        nvme_dir=str(tmp_path), nvme_bytes=nvme_bytes)


def test_nvme_lru_budget_eviction_and_bit_identical_promote(tmp_path):
    tier = NVMeKVTier(_nvme_cfg(tmp_path))
    assert tier.put(b"k0", _page(0))
    rec = tier.nvme_bytes
    tier.pop(b"k0")
    tier = NVMeKVTier(_nvme_cfg(tmp_path, nvme_bytes=3 * rec + 64))
    for i in range(3):
        assert tier.put(f"k{i}".encode(), _page(i))
    assert tier.put(b"k3", _page(3))
    assert tier.nvme_pages == 3 and not tier.has(b"k0") and tier.evicted_pages == 1
    assert len([f for f in os.listdir(tier.dir) if f.endswith(".kvpage")]) == 3
    got = tier.get(b"k1")
    assert got is not None and torch.equal(got["k"], _page(1)["k"])
    assert got["k"].dtype == torch.float32
    tier.put(b"k4", _page(4))  # k2 goes, not the refreshed k1
    assert tier.has(b"k1") and not tier.has(b"k2")
    assert tier.get(b"nope") is None and tier.misses == 1
    tier.pop(b"k1")
    assert not tier.has(b"k1")


def test_nvme_files_are_the_jax_tiers_records(tmp_path):
    """A page file written by the port reads back in the JAX tier and the
    other way: the same DSTPUKV2 record."""
    from deepspeed_tpu.serving.kv_tier import NVMeKVTier as JaxNVMe

    cfg = dict(enabled=True, nvme_enabled=True, nvme_dir=str(tmp_path))
    mine, theirs = NVMeKVTier(KVTierConfig(**cfg)), JaxNVMe(JaxTierConfig(**cfg))
    arrays = {"k": torch.arange(64, dtype=torch.float32).reshape(1, 1, 8, 2, 4),
              "k_scale": torch.rand(1, 1, 8, 2)}
    mine.put(b"\x01" * 32, arrays)
    path, _nb = mine._lru[b"\x01" * 32]
    theirs._lru[b"\x01" * 32] = (path, os.path.getsize(path))
    got = theirs.get(b"\x01" * 32)
    for n in arrays:
        assert got[n].tobytes() == arrays[n].numpy().tobytes()
    theirs.put(b"\x02" * 32, {n: a.numpy() for n, a in arrays.items()})
    path2, _ = theirs._lru[b"\x02" * 32]
    assert open(path2, "rb").read() == open(path, "rb").read().replace(
        (b"\x01" * 32).hex().encode(), (b"\x02" * 32).hex().encode())


def test_nvme_corrupt_file_refused_loudly_and_unlinked(tmp_path):
    tier = NVMeKVTier(_nvme_cfg(tmp_path))
    assert tier.put(b"\x05" * 8, _page(5))
    path, _nb = tier._lru[b"\x05" * 8]
    blob = bytearray(open(path, "rb").read())
    blob[-3] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))
    assert tier.get(b"\x05" * 8) is None
    assert tier.corrupt_pages == 1 and not os.path.exists(path) and not tier.has(b"\x05" * 8)
    assert tier.put(b"\x06" * 8, _page(6))
    path, _nb = tier._lru[b"\x06" * 8]
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])  # a torn write
    assert tier.get(b"\x06" * 8) is None and tier.corrupt_pages == 2


def test_host_tier_demotes_to_nvme_and_promotes_back(tmp_path):
    tier = HostKVTier(_nvme_cfg(tmp_path, host_bytes=3 * 256))
    for i in range(3):
        assert _put(tier, f"k{i}".encode(), i)
    _put(tier, b"k3", 3)  # over budget: k0 goes down to NVMe
    assert tier.host_evictions == 1 and tier.nvme.nvme_pages == 1 and tier.nvme.has(b"k0")
    assert tier.has(b"k0")
    got = tier.get(b"k0")  # host miss -> file read -> promote
    assert got is not None and torch.equal(got["k"], _page(0)["k"])
    assert tier.nvme.restored_pages == 1 and not tier.nvme.has(b"k0")
    assert b"k0" in tier._lru and tier.nvme.has(b"k1")
    st = tier.stats()
    assert st["nvme_spilled_pages"] == 2 and st["nvme_restored_pages"] == 1
    assert st["nvme_hit_rate"] == 1.0


def test_nvme_bundle_spill_restore_rebases_deadline(tmp_path):
    import json

    tier = NVMeKVTier(_nvme_cfg(tmp_path))
    arrays = {"k": torch.arange(32, dtype=torch.float32).reshape(1, 1, 8, 2, 2)}
    b = KVPageBundle(uid=9, tokens=list(range(10)), prompt_len=9, max_new_tokens=4,
                     temperature=0.0, eos_id=None, prefilled=9, decode_entry=False,
                     page_size=8, page_keys=[b"\x09" * 32],
                     src_pages=[{"page": 1, "refcount": 1, "key": None}], arrays=arrays,
                     model_sig=(1, 2, 2), kv_quant=False, dtype="fp32",
                     deadline=time.perf_counter() + 10.0)
    path = tier.spill_bundle(b)
    raw = open(path, "rb").read()
    hlen = int.from_bytes(raw[len(_MAGIC):len(_MAGIC) + 8], "little")
    hdr = json.loads(raw[len(_MAGIC) + 8:len(_MAGIC) + 8 + hlen].decode())
    assert 9.5 < hdr["deadline_left_s"] <= 10.0

    def rewrite(sent):
        hdr["sent_unix"] = sent
        enc = json.dumps(hdr).encode()
        with open(path, "wb") as f:
            f.write(_MAGIC + len(enc).to_bytes(8, "little") + enc
                    + raw[len(_MAGIC) + 8 + hlen:])

    rewrite(time.time() - 4.0)  # 4 s on disk
    rt = tier.restore_bundle(path)
    assert 5.0 < rt.deadline - time.perf_counter() < 6.5
    assert torch.equal(rt.arrays["k"], arrays["k"])
    rewrite(time.time() + 3600.0)  # a clock behind the spill's grants nothing
    assert tier.restore_bundle(path).deadline - time.perf_counter() <= 10.01
    assert rebase_deadline_left(1.0, time.time() - 50.0) == 0.0


# ----------------------------- engine oracles ---------------------------------
@pytest.fixture(scope="module")
def weights():
    jmodel = jax_llama("tiny", max_seq_len=128)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    return jmodel, params, jax.tree_util.tree_map(np.asarray, params)


def _engine(weights, cap=3, tier=True, num_pages=48, max_seqs=4, **kw):
    cfg = RaggedInferenceConfig.from_dict(dict(
        dtype="fp32", page_size=PS, num_pages=num_pages, max_seqs=max_seqs,
        max_pages_per_seq=12, enable_prefix_cache=True, prefix_cache_pages=cap,
        kv_tier=tier if isinstance(tier, dict) else ({"enabled": True} if tier else None),
        **kw))
    return InferenceEngineV2(llama_model("tiny", max_seq_len=128), cfg, params=weights[2],
                             device="cpu")


def _family_waves(n_fams=3, per_fam=2, rounds=2, gen=6, seed=11, request=RaggedRequest):
    """Families cycle, so a capped cache must spill each family before it
    comes back (and restore it then)."""
    rng = np.random.RandomState(seed)
    fams = [list(map(int, rng.randint(0, 256, 2 * PS))) for _ in range(n_fams)]
    waves = []
    for _ in range(rounds):
        for f in fams:
            waves.append([request(prompt_ids=f + list(map(int, rng.randint(0, 256, 3 + i))),
                                  max_new_tokens=gen) for i in range(per_fam)])
    return waves


def _play(eng, waves):
    out = []
    for wave in waves:
        got = eng.generate_all([dataclasses.replace(r) for r in wave])
        out.append([got[u] for u in sorted(got)])
    return out


VARIANTS = {"plain": {}, "chunked": {"prefill_chunk": PS},
            "speculative": {"speculative": {"mode": "ngram", "k": 4}},
            "horizon_4": {"decode_horizon": 4}, "kv_quant": {"kv_quant": True}}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tier_streams_equal_uncapped(weights, variant):
    """A capped cache with the host tier streams what an uncapped engine
    streams, the port's and the JAX package's; under ``kv_quant`` int8
    codes and fp32 scales spill and come back bit for bit."""
    kw = VARIANTS[variant]
    waves = _family_waves()
    want = _play(_engine(weights, cap=0, tier=False, num_pages=64, **kw), waves)
    jax_kw = {k: v for k, v in kw.items()}
    jeng = JaxEngine(weights[0], JaxConfig(
        dtype="fp32", page_size=PS, num_pages=64, max_seqs=4, max_pages_per_seq=12,
        enable_prefix_cache=True, **jax_kw), params=weights[1])
    jwant = _play(jeng, _family_waves(request=JaxRequest))
    eng = _engine(weights, cap=3, tier=True, **kw)
    got = _play(eng, waves)
    ts = eng.tier_stats()
    assert got == want == jwant, variant
    assert ts["spilled_pages"] > 0 and ts["restored_pages"] > 0, ts
    assert ts["corrupt_pages"] == 0
    assert eng.kv_tier.spill_seconds > 0 and eng.kv_tier.restore_seconds > 0
    eng.assert_no_leaks()
    eng.close()
    eng.allocator.assert_no_leaks([])


def test_tier_streams_equal_uncapped_under_preemption(weights):
    waves = _family_waves(n_fams=2, per_fam=3, gen=20)
    want = _play(_engine(weights, cap=0, tier=False, num_pages=64), waves)
    # 12 pages for 3 sequences growing to 6 pages each: decode preempts
    eng = _engine(weights, cap=2, tier=True, num_pages=12, max_seqs=3)
    assert _play(eng, waves) == want
    assert eng.stats()["preemptions"] > 0
    eng.assert_no_leaks()
    eng.close()


def _junk_wave(eng, salt=77, gen=4):
    """Push the earlier families out of a capped LRU: the junk wave's
    pages park on retire and the cap trims the oldest, which the spill
    hook captures (pinned until the next drain)."""
    junk = list(map(int, np.random.RandomState(salt).randint(0, 256, 2 * PS)))
    eng.generate_all([RaggedRequest(prompt_ids=junk, max_new_tokens=gen)])


def test_pin_until_commit_under_slow_drain(weights):
    fam = list(map(int, np.random.RandomState(3).randint(0, 256, 2 * PS)))
    eng = _engine(weights, cap=2, tier=True, num_pages=32, max_seqs=2)
    eng.generate_all([RaggedRequest(prompt_ids=fam, max_new_tokens=4)])
    _junk_wave(eng)
    assert eng.allocator.spill_pinned_pages == 2
    pinned = set(eng.allocator._spill_pinned)
    assert eng.kv_tier.host_pages == 0  # not copied out yet
    free0 = eng.allocator.free_pages
    grabbed = eng.allocator.alloc(free0)
    assert not (pinned & set(grabbed))
    eng.allocator.free(grabbed)
    eng.assert_no_leaks()
    eng.flush_spills()
    assert eng.kv_tier.host_pages == len(pinned) and eng.allocator.spill_pinned_pages == 0
    assert eng.allocator.free_pages == free0 + len(pinned)
    eng.assert_no_leaks()
    eng.close()


def test_restore_prefetch_for_queued_request(weights):
    rng = np.random.RandomState(5)
    fam = list(map(int, rng.randint(0, 256, 2 * PS)))
    queued_req = RaggedRequest(prompt_ids=fam + list(map(int, rng.randint(0, 256, 3))),
                               max_new_tokens=4)
    long_req = RaggedRequest(prompt_ids=list(map(int, rng.randint(0, 256, 12))),
                             max_new_tokens=24)
    want = _engine(weights, cap=0, tier=False, num_pages=64).generate_all(
        [dataclasses.replace(queued_req)])[0]
    eng = _engine(weights, cap=2, tier=True, num_pages=32, max_seqs=1)
    eng.generate_all([RaggedRequest(prompt_ids=fam, max_new_tokens=4)])
    _junk_wave(eng)
    eng.flush_spills()
    assert eng.kv_tier.host_pages >= 2
    keys = eng.prefix_cache.page_keys(fam, 2)
    assert all(eng.allocator.lookup(k) is None for k in keys)  # device-cold
    eng.allocator.cache_cap = 8  # room in the LRU for the prefetch
    eng.put(long_req)
    u_q = eng.put(queued_req)
    prefetched_while_queued = False
    got = {}
    for _ in range(300):
        for uid, rec in eng.step().items():
            got.setdefault(uid, []).extend(rec["tokens"])
        if (any(s.uid == u_q for s in eng._queue)
                and all(eng.allocator.lookup(k) is not None for k in keys)):
            prefetched_while_queued = True
        if not eng.has_work():
            break
    assert prefetched_while_queued
    assert eng.kv_tier.restored_pages >= 2 and got[u_q] == want
    eng.assert_no_leaks()
    eng.close()


def test_corrupt_host_page_refused_costs_only_recompute(weights):
    rng = np.random.RandomState(9)
    fam = list(map(int, rng.randint(0, 256, 2 * PS)))
    req = RaggedRequest(prompt_ids=fam + [1, 2, 3], max_new_tokens=6)
    want = _engine(weights, cap=0, tier=False, num_pages=64).generate_all(
        [dataclasses.replace(req)])[0]
    eng = _engine(weights, cap=2, tier=True, num_pages=32, max_seqs=2)
    eng.generate_all([RaggedRequest(prompt_ids=fam, max_new_tokens=4)])
    _junk_wave(eng)
    eng.flush_spills()
    keys = eng.prefix_cache.page_keys(fam, 2)
    assert eng.kv_tier.has(keys[0])
    _flip(next(iter(eng.kv_tier._lru[keys[0]][0].values())), 5)
    out = eng.generate_all([dataclasses.replace(req)])
    assert out[max(out)] == want
    assert eng.kv_tier.corrupt_pages >= 1 and not eng.kv_tier.has(keys[0])
    eng.assert_no_leaks()
    eng.close()


def test_restore_alloc_never_evicts_matched_pages(weights):
    """With the free list empty and the request's device-matched pages
    parked in the LRU, the restore's own alloc must not evict them: the
    admission claims its matches first, blocks while nothing is left, and
    admits exactly once pages free up."""
    rng = np.random.RandomState(21)
    fam = list(map(int, rng.randint(0, 256, 3 * PS)))
    req = RaggedRequest(prompt_ids=fam + [5, 6, 7], max_new_tokens=4)
    want = _engine(weights, cap=0, tier=False, num_pages=64).generate_all(
        [dataclasses.replace(req)])[0]
    eng = _engine(weights, cap=2, tier=True, num_pages=24, max_seqs=1)
    eng.generate_all([RaggedRequest(prompt_ids=fam, max_new_tokens=2)])
    _junk_wave(eng)
    eng.flush_spills()
    eng.generate_all([RaggedRequest(prompt_ids=fam[:2 * PS] + [9, 9], max_new_tokens=2)])
    eng.flush_spills()
    keys = eng.prefix_cache.page_keys(fam, 3)
    dev = [eng.allocator.lookup(k) for k in keys]
    assert dev[0] is not None and dev[1] is not None
    assert dev[2] is None and eng.kv_tier.has(keys[2])
    held = eng.allocator.alloc(len(eng.allocator._free))
    assert not eng.allocator._free
    uid = eng.put(dataclasses.replace(req))
    out = dict(eng.step())
    for s in eng._slots:
        if s is not None:
            assert len(set(s.pages)) == len(s.pages), s.pages
    eng.allocator.free(held)
    got = {uid: []}
    for u, rec in out.items():
        got.setdefault(u, []).extend(rec.get("tokens", []))
    while eng.has_work():
        for u, rec in eng.step().items():
            got.setdefault(u, []).extend(rec["tokens"])
        for s in eng._slots:
            if s is not None:
                assert len(set(s.pages)) == len(s.pages), s.pages
    assert got[uid] == want
    eng.assert_no_leaks()
    eng.close()


def test_close_releases_pending_spill_pins(weights):
    rng = np.random.RandomState(13)
    fam = list(map(int, rng.randint(0, 256, 2 * PS)))
    eng = _engine(weights, cap=2, tier=True, num_pages=32, max_seqs=2)
    eng.generate_all([RaggedRequest(prompt_ids=fam, max_new_tokens=4)])
    _junk_wave(eng)
    assert eng.allocator.spill_pinned_pages > 0
    eng.put(RaggedRequest(prompt_ids=list(map(int, rng.randint(0, 256, 2 * PS))),
                          max_new_tokens=16))
    for _ in range(3):
        eng.step()
    eng.close()  # releases the pins without copying (the tier goes too)
    assert eng.allocator.spill_pinned_pages == 0
    eng.allocator.assert_no_leaks([])


def test_nvme_tier_under_a_small_host_budget(weights, tmp_path):
    """The NVMe tier under a host budget of 2 pages: pages demote to
    files and come back through it, the streams equal the uncapped
    engine's; a corrupt file is refused loudly and costs only recompute;
    close releases the pending pins."""
    page_bytes = 2 * 2 * PS * 2 * 16 * 4  # k and v: [L=2, 1, PS, KVH=2, D=16] fp32
    tier = {"enabled": True, "host_bytes": 2 * page_bytes, "nvme_enabled": True,
            "nvme_dir": str(tmp_path)}
    waves = _family_waves()
    want = _play(_engine(weights, cap=0, tier=False, num_pages=64), waves)
    eng = _engine(weights, cap=3, tier=tier)
    assert _play(eng, waves) == want
    st = eng.tier_stats()
    assert st["nvme_spilled_pages"] > 0 and st["nvme_restored_pages"] > 0, st
    assert st["corrupt_pages"] == st["nvme_corrupt_pages"] == 0
    eng.assert_no_leaks()
    # a corrupt page file: refused, unlinked, recomputed, the stream exact
    files = sorted(os.listdir(tmp_path))
    assert files and all(f.endswith(".kvpage") for f in files)
    for f in files:
        blob = bytearray(open(tmp_path / f, "rb").read())
        blob[-7] ^= 0x20
        open(tmp_path / f, "wb").write(bytes(blob))
    replay = _family_waves(seed=11)[:3]
    again = _play(eng, replay)
    assert again == want[:3]
    assert eng.tier_stats()["nvme_corrupt_pages"] > 0
    _junk_wave(eng)
    eng.close()
    assert eng.allocator.spill_pinned_pages == 0
    eng.allocator.assert_no_leaks([])


def test_pools_keep_their_storage(weights):
    """The captured programs hold the pool tensors: every page copy (copy
    on write, import, spill drain, restore) writes them in place."""
    from deepspeed_tpu_torch.serving import bundle_from_bytes

    eng = _engine(weights, cap=2, tier=True, num_pages=32, max_seqs=2)
    ptrs = {n: t.data_ptr() for n, t in eng._pools.items()}
    fam = list(map(int, np.random.RandomState(31).randint(0, 256, 2 * PS)))
    eng.generate_all([RaggedRequest(prompt_ids=fam, max_new_tokens=3)])
    eng.put(RaggedRequest(prompt_ids=fam, max_new_tokens=3))
    eng._admit()  # a full hit: copy on write
    assert next(s for s in eng._slots if s is not None).decode_entry
    while eng.has_work():
        eng.step()
    _junk_wave(eng)
    eng.flush_spills()  # a drain
    assert eng.kv_tier.spilled_pages > 0
    eng.generate_all([RaggedRequest(prompt_ids=fam + [4, 5], max_new_tokens=3)])
    assert eng.kv_tier.restored_pages > 0  # a restore
    src = _engine(weights, cap=0, tier=False)
    uid = src.put(RaggedRequest(prompt_ids=fam + [1], max_new_tokens=6))
    for _ in range(3):
        src.step()
    assert eng.import_sequence(bundle_from_bytes(bundle_to_bytes(src.export_sequence(uid))))
    while eng.has_work():
        eng.step()
    assert {n: t.data_ptr() for n, t in eng._pools.items()} == ptrs
    eng.assert_no_leaks()
    eng.close()
