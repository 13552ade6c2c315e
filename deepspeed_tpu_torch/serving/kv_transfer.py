"""KV-page transfer between engines (the port's counterpart of
``deepspeed_tpu/serving/kv_transfer.py``).

:func:`migrate_sequence` exports a decode-ready sequence's KV pages and
block-table metadata from one engine (``export_sequence``), imports them
into another with ref-count adoption (``import_sequence``), and releases
the source only after the import succeeded: a failed handoff loses
nothing.

Between processes, :func:`bundle_to_bytes` / :func:`bundle_from_bytes`
give the self-describing DSTPUKV2 record: magic, a json header, then each
leaf's raw little-endian bytes in sorted-leaf order, with one CRC32 per
page across its slice of every leaf.  The byte stream is the JAX
package's, byte for byte, so either package reads the other's.  Page
arrays are CPU tensors in the pool's exact dtype; bf16 is torch's own
``bfloat16``, written as its 16-bit words under the dtype name
``"bfloat16"`` (no ``ml_dtypes``).  A torn, truncated or bit-flipped
record raises :class:`CorruptBundleError`.
"""

from __future__ import annotations

import io
import json
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..inference.v2.ragged import KVPageBundle
from ..utils.logging import logger

#: wire-format magic and version (v2: per-page CRC32s, priority and
#: seconds of deadline left)
_MAGIC = b"DSTPUKV2"
_OLD_MAGICS = (b"DSTPUKV1",)


class CorruptBundleError(ValueError):
    """A serialized bundle failed its integrity checks (bad magic, retired
    version, truncation, a page CRC mismatch).  The exporter still owns
    the sequence: retry or re-export, never import."""


def _trace_crc(trace: Dict[str, Any]) -> int:
    """CRC32 of the trace block's canonical json, its own checksum."""
    blob = json.dumps(trace, sort_keys=True, separators=(",", ":"))
    return zlib.crc32(blob.encode()) & 0xFFFFFFFF


def migrate_sequence(src_engine: Any, dst_engine: Any, uid: int) -> int:
    """Move one decode-ready sequence from ``src_engine`` to
    ``dst_engine``.  Returns the pages moved, or 0 when the destination
    has no room (the sequence keeps running on the source).  Engines of
    different geometry raise ``ValueError``."""
    bundle = src_engine.export_sequence(uid)
    if not dst_engine.import_sequence(bundle):
        return 0
    src_engine.release_sequence(uid, reason="migrated")
    return bundle.n_pages


def rebase_deadline_left(left: Any, sent_unix: Any) -> Optional[float]:
    """Seconds of deadline left after the wall time since ``sent_unix``;
    a receiver clock behind the sender's consumes nothing and never grants
    budget back."""
    if left is None:
        return None
    if sent_unix is not None:
        # dstpu-lint: allow[wall-clock] transit vs the sender's wall-clock stamp; clamped
        # non-negative so skew never grants budget back
        transit = max(0.0, time.time() - float(sent_unix))
        left = max(0.0, float(left) - transit)
    return float(left)


def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name of the dtype (``bfloat16`` for torch's bf16)."""
    return str(t.dtype).split(".")[-1]


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise CorruptBundleError(f"corrupt bundle: unknown leaf dtype {name!r}")
    return dt


def _bytes_of(t: torch.Tensor) -> np.ndarray:
    """A tensor's C-order bytes as a flat uint8 array."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def page_crcs(arrays: Dict[str, torch.Tensor], leaves: List[str]) -> List[int]:
    """CRC32 per page: each page's slice of every leaf (axis 1 is the
    page axis, ``[L, n_pages, ...]``), chained in sorted-leaf order: the
    checksum the wire format, the host tier and the NVMe tier share."""
    if not leaves:
        return []
    n_pages = arrays[leaves[0]].shape[1]
    crcs = [0] * n_pages
    for n in leaves:
        # one contiguous page-major copy per leaf (none when the storage
        # is page-major already, as paged_gather_pages leaves it)
        rows = _bytes_of(arrays[n].movedim(1, 0)).reshape(n_pages, -1)
        for j in range(n_pages):
            crcs[j] = zlib.crc32(rows[j], crcs[j])
    return [c & 0xFFFFFFFF for c in crcs]


def pages_to_bytes(arrays: Dict[str, torch.Tensor],
                   meta: Optional[Dict[str, Any]] = None) -> bytes:
    """The DSTPUKV2 page record: magic, a json header (``meta``, then each
    leaf's name, shape and dtype, then the per-page CRC32s), then each
    leaf's raw C-order bytes in sorted-leaf order."""
    leaves = sorted(arrays)
    header = dict(meta or {})
    header["leaves"] = [{"name": n, "shape": list(arrays[n].shape),
                         "dtype": _dtype_name(arrays[n])} for n in leaves]
    header["page_crcs"] = page_crcs(arrays, leaves)
    buf = io.BytesIO()
    hdr = json.dumps(header).encode()
    buf.write(_MAGIC)
    buf.write(len(hdr).to_bytes(8, "little"))
    buf.write(hdr)
    for n in leaves:
        buf.write(_bytes_of(arrays[n]))
    return buf.getvalue()


def pages_from_bytes(data: bytes) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Inverse of :func:`pages_to_bytes` (bit-identical CPU tensors).
    Bad magic, a retired version, truncation or a page CRC mismatch raise
    :class:`CorruptBundleError` naming what failed."""
    if data[:len(_MAGIC)] in _OLD_MAGICS:
        raise CorruptBundleError(
            f"serialized KVPageBundle uses retired wire version {data[:len(_MAGIC)]!r} "
            f"(no per-page checksums); current is {_MAGIC!r}: re-export from the "
            "source engine")
    if data[:len(_MAGIC)] != _MAGIC:
        raise CorruptBundleError("not a serialized KVPageBundle (bad magic)")
    off = len(_MAGIC)
    if len(data) < off + 8:
        raise CorruptBundleError("truncated bundle: header length missing")
    hlen = int.from_bytes(data[off:off + 8], "little")
    off += 8
    if len(data) < off + hlen:
        raise CorruptBundleError(f"truncated bundle: header needs {hlen} bytes, "
                                 f"{len(data) - off} present")
    try:
        header = json.loads(data[off:off + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CorruptBundleError(f"corrupt bundle header: {e}") from e
    off += hlen
    arrays = {}
    for leaf in header["leaves"]:
        dt = _torch_dtype(leaf["dtype"])
        n = int(np.prod(leaf["shape"])) * dt.itemsize
        if len(data) < off + n:
            raise CorruptBundleError(
                f"truncated bundle: leaf {leaf['name']!r} needs {n} bytes, "
                f"{len(data) - off} present")
        raw = np.frombuffer(data, dtype=np.uint8, count=n, offset=off).copy()
        arrays[leaf["name"]] = torch.from_numpy(raw).view(dt).reshape(leaf["shape"])
        off += n
    if off != len(data):
        logger.warning(f"pages_from_bytes: {len(data) - off} trailing bytes ignored")
    want = list(header.get("page_crcs", []))
    got = page_crcs(arrays, sorted(arrays))
    if len(want) != len(got):
        raise CorruptBundleError(f"corrupt bundle: header carries {len(want)} page CRCs "
                                 f"for {len(got)} pages")
    bad = [j for j, (w, g) in enumerate(zip(want, got)) if w != g]
    if bad:
        raise CorruptBundleError(
            f"corrupt bundle: CRC32 mismatch on page(s) {bad} of {len(got)} (bit flip or "
            "torn write in transport) — refused; source still holds the sequence")
    return arrays, header


def bundle_to_bytes(bundle: KVPageBundle) -> bytes:
    """Serialize a bundle: its metadata (page keys hex-encoded, the
    absolute ``deadline`` re-based to ``deadline_left_s`` with a
    ``sent_unix`` wall stamp: clocks do not cross processes) over
    :func:`pages_to_bytes`.  A trace block, when present, rides as an
    optional header block with its own CRC and one hop stamp added."""
    header = {
        "uid": bundle.uid, "tokens": list(map(int, bundle.tokens)),
        "prompt_len": bundle.prompt_len,
        "max_new_tokens": bundle.max_new_tokens,
        "temperature": bundle.temperature, "eos_id": bundle.eos_id,
        "prefilled": bundle.prefilled, "decode_entry": bundle.decode_entry,
        "page_size": bundle.page_size,
        "priority": bundle.priority,
        "deadline_left_s": (max(0.0, bundle.deadline - time.perf_counter())
                            if bundle.deadline else None),
        # dstpu-lint: allow[wall-clock] cross-host wire timestamp; monotonic clocks do not
        # compare across machines
        "sent_unix": time.time(),
        "page_keys": [k.hex() if isinstance(k, bytes) else k for k in bundle.page_keys],
        "src_pages": [{"page": m["page"], "refcount": m["refcount"],
                       "key": (m["key"].hex() if isinstance(m.get("key"), bytes) else None)}
                      for m in bundle.src_pages],
        "model_sig": list(bundle.model_sig), "kv_quant": bundle.kv_quant,
        "dtype": bundle.dtype,
    }
    if bundle.trace is not None:
        trace = dict(bundle.trace)
        # dstpu-lint: allow[wall-clock] per-hop wire timestamp; transit is sender wall vs
        # receiver wall, as sent_unix
        trace["hops"] = list(trace.get("hops") or []) + [{"sent_unix": time.time()}]
        header["trace"] = trace
        header["trace_crc"] = _trace_crc(trace)
    return pages_to_bytes(bundle.arrays, header)


def bundle_from_bytes(data: bytes) -> KVPageBundle:
    """Inverse of :func:`bundle_to_bytes` (bit-identical arrays), every
    integrity check passed before anything is returned."""
    arrays, header = pages_from_bytes(data)
    trace = None
    if "trace" in header:
        trace = header["trace"]
        want_crc = header.get("trace_crc")
        if (not isinstance(trace, dict) or want_crc is None
                or _trace_crc(trace) != int(want_crc)):
            raise CorruptBundleError(
                "corrupt bundle: trace block failed its CRC32 (torn or bit-flipped "
                "trace context) — refused; a legacy bundle would OMIT the block, not "
                "carry a broken one")
        hops = trace.get("hops") or []
        if hops and hops[-1].get("sent_unix") is not None:
            # dstpu-lint: allow[wall-clock] receive stamp paired with the sender's
            # wall-clock hop stamp (cross-host transit)
            now_unix = time.time()
            hops[-1]["recv_unix"] = now_unix
            trace["transit_s"] = max(0.0, now_unix - float(hops[-1]["sent_unix"]))
    left = rebase_deadline_left(header.get("deadline_left_s"), header.get("sent_unix"))
    return KVPageBundle(
        uid=header["uid"], tokens=list(header["tokens"]),
        prompt_len=header["prompt_len"], max_new_tokens=header["max_new_tokens"],
        temperature=header["temperature"], eos_id=header["eos_id"],
        prefilled=header["prefilled"], decode_entry=header["decode_entry"],
        page_size=header["page_size"],
        page_keys=[bytes.fromhex(k) if isinstance(k, str) else k
                   for k in header["page_keys"]],
        src_pages=[{"page": m["page"], "refcount": m["refcount"],
                    "key": bytes.fromhex(m["key"]) if m.get("key") else None}
                   for m in header["src_pages"]],
        arrays=arrays, model_sig=tuple(header["model_sig"]),
        kv_quant=header["kv_quant"], dtype=header["dtype"],
        priority=int(header.get("priority", 1)),
        deadline=time.perf_counter() + float(left) if left is not None else 0.0,
        trace=trace)


__all__ = ["migrate_sequence", "bundle_to_bytes", "bundle_from_bytes",
           "pages_to_bytes", "pages_from_bytes", "page_crcs",
           "rebase_deadline_left", "CorruptBundleError"]
