"""KV-page transfer: the port's ``serving/kv_transfer.py`` and the engines'
``export_sequence`` / ``import_sequence`` against the JAX package's, on
the CPU.

The wire format is compared byte for byte: for the same page arrays
(fp32, int8 codes with fp32 scales, bf16) both packages give the same
per-page CRC32s and the same DSTPUKV2 record (the wall-clock stamps
pinned), and each reads the other's.  A bundle exported mid-decode by
either engine continues, after the other has imported it from bytes, to
the exporter's uninterrupted greedy stream (fp32 tiny llama, 2 layers;
streams compared exactly).  A flipped, truncated or mislabelled record
raises ``CorruptBundleError``."""

import dataclasses
import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import KVPageBundle as JaxBundle
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import RaggedRequest as JaxRequest
from deepspeed_tpu.models.llama import llama_model as jax_llama
from deepspeed_tpu.serving import kv_transfer as jkt
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, RaggedInferenceConfig,
                                              RaggedRequest)
from deepspeed_tpu_torch.inference.v2.model_runner import paged_gather_pages
from deepspeed_tpu_torch.inference.v2.ragged import BlockAllocator, KVPageBundle, PrefixCache
from deepspeed_tpu_torch.models.llama import llama_model
from deepspeed_tpu_torch.serving import kv_transfer as tkt

torch.set_num_threads(2)

CFG = dict(dtype="fp32", page_size=8, num_pages=64, max_seqs=4, max_pages_per_seq=12)


@pytest.fixture(scope="module")
def weights():
    jmodel = jax_llama("tiny", max_seq_len=128)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    return jmodel, params, jax.tree_util.tree_map(np.asarray, params)


def _prompt(n, seed=0, vocab=256):
    return list(map(int, np.random.RandomState(seed).randint(0, vocab, n)))


def _leaves(kind, n_pages=3, seed=0):
    """The same page arrays for both packages: (numpy for JAX, torch for
    the port), ``[L=2, n_pages, ps=8, KVH=2(, D=4)]``."""
    rng = np.random.RandomState(seed)
    shape = (2, n_pages, 8, 2, 4)
    if kind == "fp32":
        a = {"k": rng.randn(*shape).astype(np.float32),
             "v": rng.randn(*shape).astype(np.float32)}
        return a, {n: torch.from_numpy(x.copy()) for n, x in a.items()}
    if kind == "int8":
        a = {"k": rng.randint(-127, 128, shape).astype(np.int8),
             "v": rng.randint(-127, 128, shape).astype(np.int8),
             "k_scale": rng.rand(*shape[:-1]).astype(np.float32),
             "v_scale": rng.rand(*shape[:-1]).astype(np.float32)}
        return a, {n: torch.from_numpy(x.copy()) for n, x in a.items()}
    t = {"k": torch.randn(shape, generator=torch.Generator().manual_seed(seed)).bfloat16(),
         "v": torch.randn(shape, generator=torch.Generator().manual_seed(seed + 1)).bfloat16()}
    return ({n: x.view(torch.int16).numpy().view(ml_dtypes.bfloat16) for n, x in t.items()},
            t)


def _bundles(kind, trace=None):
    a_np, a_t = _leaves(kind)
    meta = dict(uid=7, tokens=list(range(20)), prompt_len=18, max_new_tokens=8,
                temperature=0.0, eos_id=None, prefilled=19, decode_entry=False, page_size=8,
                page_keys=[b"\x01" * 32, b"\x02" * 32],
                src_pages=[{"page": 3, "refcount": 1, "key": b"\x01" * 32},
                           {"page": 5, "refcount": 2, "key": None},
                           {"page": 9, "refcount": 1, "key": None}],
                model_sig=(2, 2, 4), kv_quant=kind == "int8",
                dtype={"bf16": "bf16"}.get(kind, "fp32"), trace=trace)
    return JaxBundle(arrays=a_np, **meta), KVPageBundle(arrays=a_t, **meta)


@pytest.fixture
def fixed_clock(monkeypatch):
    """Pin the wall-clock stamps (``sent_unix``, hop stamps): the only
    bytes of a record that depend on when it was written."""
    import time

    monkeypatch.setattr(time, "time", lambda: 1700000000.25)


# ----------------------------- the wire format, across packages -------------
@pytest.mark.parametrize("kind", ["fp32", "int8", "bf16"])
def test_page_crcs_identical_across_packages(kind):
    a_np, a_t = _leaves(kind, n_pages=5, seed=3)
    leaves = sorted(a_np)
    assert tkt.page_crcs(a_t, leaves) == jkt.page_crcs(a_np, leaves)
    # a page-major view (paged_gather_pages' storage) checksums the same
    view = {n: x.transpose(0, 1).contiguous().transpose(0, 1) for n, x in a_t.items()}
    assert tkt.page_crcs(view, leaves) == jkt.page_crcs(a_np, leaves)


@pytest.mark.parametrize("trace", [None, {"trace_id": "r1-7", "hops": []}],
                         ids=["no_trace", "trace"])
@pytest.mark.parametrize("kind", ["fp32", "int8", "bf16"])
def test_bundle_bytes_identical_across_packages(kind, trace, fixed_clock):
    jb, tb = _bundles(kind, trace)
    wire = tkt.bundle_to_bytes(tb)
    assert wire == jkt.bundle_to_bytes(jb)
    # each package reads the other's record back bit for bit
    back_t = tkt.bundle_from_bytes(jkt.bundle_to_bytes(jb))
    back_j = jkt.bundle_from_bytes(wire)
    for n in tb.arrays:
        assert back_t.arrays[n].dtype == tb.arrays[n].dtype
        assert torch.equal(back_t.arrays[n], tb.arrays[n])
        assert back_j.arrays[n].dtype == jb.arrays[n].dtype
        assert back_j.arrays[n].tobytes() == jb.arrays[n].tobytes()
    assert back_t.page_keys == tb.page_keys and back_t.src_pages == tb.src_pages
    assert tkt.pages_to_bytes(tb.arrays, {"tier": "nvme"}) == jkt.pages_to_bytes(
        jb.arrays, {"tier": "nvme"})


def test_bundle_bytes_roundtrip_without_engine():
    _, b = _bundles("fp32")
    rt = tkt.bundle_from_bytes(tkt.bundle_to_bytes(b))
    assert rt.uid == 7 and rt.tokens == b.tokens and rt.prefilled == 19
    assert rt.page_keys == b.page_keys and rt.model_sig == (2, 2, 4)
    assert rt.src_pages[0]["key"] == b"\x01" * 32 and rt.src_pages[1]["key"] is None
    for leaf in b.arrays:
        assert rt.arrays[leaf].dtype == b.arrays[leaf].dtype
        assert torch.equal(rt.arrays[leaf], b.arrays[leaf])
    assert rt.trace is None and rt.deadline == 0.0


def test_bundle_wire_preserves_trace_context():
    snap = {"trace_id": "r1-7", "elapsed_s": 0.25, "phases": [["prefill", "prefill0", 0.25]]}
    _, b = _bundles("fp32", trace=snap)
    rt = tkt.bundle_from_bytes(tkt.bundle_to_bytes(b))
    assert rt.trace["trace_id"] == "r1-7"
    assert rt.trace["phases"] == [["prefill", "prefill0", 0.25]]
    hops = rt.trace["hops"]
    assert len(hops) == 1 and "sent_unix" in hops[0] and "recv_unix" in hops[0]
    assert rt.trace["transit_s"] >= 0.0
    rt2 = tkt.bundle_from_bytes(tkt.bundle_to_bytes(dataclasses.replace(b, trace=rt.trace)))
    assert len(rt2.trace["hops"]) == 2  # a second hop appends


def test_bundle_wire_legacy_no_trace_has_no_trace_block():
    _, b = _bundles("fp32")
    wire = tkt.bundle_to_bytes(b)
    assert b'"trace_crc"' not in wire
    assert tkt.bundle_from_bytes(wire).trace is None


def _header(wire):
    off = len(tkt._MAGIC)
    hlen = int.from_bytes(wire[off:off + 8], "little")
    return off, hlen, json.loads(wire[off + 8:off + 8 + hlen].decode())


def _rewrite_header(wire, header):
    off, hlen, _ = _header(wire)
    enc = json.dumps(header).encode()
    return tkt._MAGIC + len(enc).to_bytes(8, "little") + enc + wire[off + 8 + hlen:]


def test_bundle_wire_torn_trace_block_refused_by_name():
    _, b = _bundles("fp32", trace={"trace_id": "r1-9", "hops": []})
    wire = tkt.bundle_to_bytes(b)
    _, _, hdr = _header(wire)
    hdr["trace"]["trace_id"] = "r1-X"
    with pytest.raises(tkt.CorruptBundleError, match="trace block"):
        tkt.bundle_from_bytes(_rewrite_header(wire, hdr))


@pytest.mark.parametrize("kind", ["fp32", "int8", "bf16"])
def test_flipped_byte_raises_in_both_packages(kind):
    jb, tb = _bundles(kind)
    wire = bytearray(tkt.bundle_to_bytes(tb))
    wire[-5] ^= 0x10  # a byte of the last leaf's last page
    with pytest.raises(tkt.CorruptBundleError, match=r"CRC32 mismatch on page\(s\) \[2\]"):
        tkt.bundle_from_bytes(bytes(wire))
    with pytest.raises(jkt.CorruptBundleError):
        jkt.bundle_from_bytes(bytes(wire))


def test_truncated_bad_magic_and_retired_version_raise():
    _, b = _bundles("fp32")
    wire = tkt.bundle_to_bytes(b)
    with pytest.raises(tkt.CorruptBundleError, match="truncated"):
        tkt.bundle_from_bytes(wire[:len(wire) - 10])
    with pytest.raises(tkt.CorruptBundleError, match="truncated"):
        tkt.bundle_from_bytes(wire[:12])
    with pytest.raises(tkt.CorruptBundleError, match="bad magic"):
        tkt.bundle_from_bytes(b"XXXXXXXX" + wire[8:])
    with pytest.raises(tkt.CorruptBundleError, match="retired"):
        tkt.bundle_from_bytes(b"DSTPUKV1" + wire[8:])
    off, hlen, hdr = _header(wire)
    hdr["page_crcs"] = hdr["page_crcs"][:-1]
    with pytest.raises(tkt.CorruptBundleError, match="page CRCs"):
        tkt.bundle_from_bytes(_rewrite_header(wire, hdr))


def test_deadline_travels_as_seconds_left():
    import time

    _, b = _bundles("fp32")
    b.deadline = time.perf_counter() + 10.0
    rt = tkt.bundle_from_bytes(tkt.bundle_to_bytes(b))
    assert 9.0 < rt.deadline - time.perf_counter() <= 10.0
    assert tkt.rebase_deadline_left(1.0, time.time() - 50.0) == 0.0
    assert tkt.rebase_deadline_left(5.0, time.time() + 50.0) == 5.0
    assert tkt.rebase_deadline_left(None, time.time()) is None


# ----------------------------- ref-count adoption -----------------------------
def test_allocator_adopt_shares_registered_and_allocs_fresh():
    a = BlockAllocator(8)
    pc = PrefixCache(2, a)
    keys = pc.page_keys(list(range(8)), 4)
    owned = a.alloc(2)
    for p, k in zip(owned, keys[:2]):
        a.register(p, k)
    pages, reused = a.adopt([keys[0], keys[1], keys[2], None])
    assert reused == [True, True, False, False]
    assert pages[:2] == owned
    assert a.refcount(owned[0]) == 2 and a.refcount(owned[1]) == 2
    assert a.refcount(pages[2]) == 1 and a.refcount(pages[3]) == 1


def test_allocator_adopt_revives_lru_and_is_all_or_nothing():
    a = BlockAllocator(4)
    pc = PrefixCache(2, a)
    keys = pc.page_keys(list(range(8)), 4)
    owned = a.alloc(3)
    for p, k in zip(owned, keys[:3]):
        a.register(p, k)
    a.free(owned)
    pages, reused = a.adopt([keys[0], None])
    assert reused == [True, False] and pages[0] == owned[0]
    assert a.evictions <= 1 and a.lookup(keys[0]) == owned[0]
    before = [a.refcount(p) for p in range(4)]
    with pytest.raises(MemoryError):
        a.adopt([keys[1], None, None, None])
    assert [a.refcount(p) for p in range(4)] == before


# ----------------------------- engines ----------------------------------------
def _jax_engine(weights, cache=True, **kw):
    return JaxEngine(weights[0], JaxConfig(**dict(CFG, enable_prefix_cache=cache, **kw)),
                     params=weights[1])


def _port_engine(weights, cache=True, **kw):
    return InferenceEngineV2(llama_model("tiny", max_seq_len=128),
                             RaggedInferenceConfig(**dict(CFG, enable_prefix_cache=cache, **kw)),
                             params=weights[2], device="cpu")


def _uninterrupted(make, prompt, max_new):
    eng = make()
    got = eng.generate_all([RaggedRequest(prompt_ids=prompt, max_new_tokens=max_new)])
    return list(got.values())[0]


def _continue(eng, uid, out=None):
    toks = list(out or [])
    for _ in range(64):
        for u, rec in eng.step().items():
            if u == uid:
                toks.extend(rec["tokens"])
        if not eng.has_work():
            break
    return toks


def _drive_to_mid_decode(eng, request, steps):
    uid = eng.put(request)
    toks = []
    for _ in range(steps):
        for u, rec in eng.step().items():
            if u == uid:
                toks.extend(rec["tokens"])
    return uid, toks


@pytest.mark.parametrize("cache", [False, True])
def test_jax_bundle_continues_in_the_port(weights, cache):
    """The JAX engine exports mid-decode; the bytes import into the
    port's engine, which continues to JAX's own uninterrupted stream."""
    prompt = _prompt(20, seed=1)
    want = list(_jax_engine(weights, cache).generate_all(
        [JaxRequest(prompt_ids=prompt, max_new_tokens=10)]).values())[0]
    src = _jax_engine(weights, cache)
    uid, head = _drive_to_mid_decode(src, JaxRequest(prompt_ids=prompt, max_new_tokens=10), 4)
    wire = jkt.bundle_to_bytes(src.export_sequence(uid))
    dst = _port_engine(weights, cache)
    bundle = tkt.bundle_from_bytes(wire)
    assert dst.import_sequence(bundle)
    got = paged_gather_pages(dst._pools, dst._find_slotted(uid).pages)
    for leaf, arr in bundle.arrays.items():
        assert torch.equal(got[leaf], arr), leaf
    assert _continue(dst, uid, head) == want
    dst.assert_no_leaks()


@pytest.mark.parametrize("cache", [False, True])
def test_port_bundle_continues_in_jax(weights, cache):
    """The other way: the port exports mid-decode, JAX imports the bytes
    and continues to the port's uninterrupted stream."""
    prompt = _prompt(23, seed=2)
    want = _uninterrupted(lambda: _port_engine(weights, cache), prompt, 10)
    src = _port_engine(weights, cache)
    uid, head = _drive_to_mid_decode(src, RaggedRequest(prompt_ids=prompt, max_new_tokens=10), 4)
    wire = tkt.bundle_to_bytes(src.export_sequence(uid))
    dst = _jax_engine(weights, cache)
    assert dst.import_sequence(jkt.bundle_from_bytes(wire))
    assert _continue(dst, uid, head) == want


@pytest.mark.parametrize("cache", [False, True])
def test_export_import_between_port_engines(weights, cache):
    """Export mid-decode, import into a fresh port engine from bytes:
    pages bit-identical, and both the source (still running) and the
    importer continue the same stream."""
    src = _port_engine(weights, cache)
    uid, head = _drive_to_mid_decode(
        src, RaggedRequest(prompt_ids=_prompt(20, seed=1), max_new_tokens=8), 3)
    bundle = src.export_sequence(uid)
    assert bundle.n_pages == len(src._find_slotted(uid).pages)
    dst = _port_engine(weights, cache)
    assert dst.import_sequence(tkt.bundle_from_bytes(tkt.bundle_to_bytes(bundle)))
    got = paged_gather_pages(dst._pools, dst._find_slotted(uid).pages)
    for leaf, arr in bundle.arrays.items():
        assert got[leaf].dtype == arr.dtype and torch.equal(got[leaf], arr), leaf
    src_rest, dst_rest = _continue(src, uid), _continue(dst, uid)
    assert src_rest == dst_rest and len(dst_rest) > 0
    src.assert_no_leaks()
    dst.assert_no_leaks()


def test_migrate_sequence_releases_the_source(weights):
    prompt = _prompt(18, seed=4)
    want = _uninterrupted(lambda: _port_engine(weights), prompt, 9)
    src, dst = _port_engine(weights), _port_engine(weights)
    uid, head = _drive_to_mid_decode(src, RaggedRequest(prompt_ids=prompt, max_new_tokens=9), 3)
    n = tkt.migrate_sequence(src, dst, uid)
    assert n == len(dst._find_slotted(uid).pages) and not src.has_work()
    src.assert_no_leaks()
    assert _continue(dst, uid, head) == want


def test_export_import_covers_copy_on_write_page(weights):
    """A fully cached prompt admits through a private copy of its last
    page (decode_entry); its bundle carries that page by value and the
    migrated stream equals the first run's."""
    src = _port_engine(weights)
    prompt = _prompt(16, seed=2)  # page-aligned: a full hit on re-admission
    first = src.generate_all([RaggedRequest(prompt_ids=list(prompt), max_new_tokens=6)])
    uid = src.put(RaggedRequest(prompt_ids=list(prompt), max_new_tokens=6))
    src._admit()
    seq = src._find_slotted(uid)
    assert seq.decode_entry and seq.generated == 0
    bundle = src.export_sequence(uid)
    assert len(bundle.page_keys) < bundle.n_pages  # the copy travels by value
    dst = _port_engine(weights)
    assert dst.import_sequence(bundle)
    got = paged_gather_pages(dst._pools, dst._find_slotted(uid).pages)
    for leaf, arr in bundle.arrays.items():
        assert torch.equal(got[leaf], arr), leaf
    src.release_sequence(uid)
    src.assert_no_leaks()
    assert _continue(dst, uid) == list(first.values())[0]


def test_import_refuses_mismatches_and_full_engines(weights):
    src = _port_engine(weights)
    uid, _ = _drive_to_mid_decode(
        src, RaggedRequest(prompt_ids=_prompt(20, seed=5), max_new_tokens=8), 3)
    bundle = src.export_sequence(uid)
    dst = _port_engine(weights)
    with pytest.raises(ValueError, match="dtype"):
        dst.import_sequence(dataclasses.replace(bundle, dtype="bf16"))
    with pytest.raises(ValueError, match="kv_quant"):
        dst.import_sequence(dataclasses.replace(bundle, kv_quant=True))
    with pytest.raises(ValueError, match="model_sig"):
        dst.import_sequence(dataclasses.replace(bundle, model_sig=(3, 2, 4)))
    with pytest.raises(ValueError, match="decode-ready"):
        dst.import_sequence(dataclasses.replace(bundle, prefilled=2))
    dst.assert_no_leaks()
    small = _port_engine(weights, max_seqs=1)
    small.put(RaggedRequest(prompt_ids=_prompt(9, seed=6), max_new_tokens=30))
    small.step()
    assert small.import_sequence(bundle) is False  # no free slot: untouched
    small.assert_no_leaks()
