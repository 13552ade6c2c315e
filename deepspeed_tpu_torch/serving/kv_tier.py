"""Tiered KV cache: host-RAM (and NVMe) spill and restore of cold prefix
pages (the port's counterpart of ``deepspeed_tpu/serving/kv_tier.py``).

The device prefix cache turns shared prompt prefixes into page-table
lookups until the distinct-prefix working set outgrows the pool and the
LRU evicts pages that are needed again.  :class:`HostKVTier` captures
pages on prefix-cache LRU eviction into a byte-budgeted host LRU keyed by
the prefix cache's chain keys, and the engine restores them, CRC-verified
and bit-identical, when a later prefix walks past the device hit.
:class:`NVMeKVTier` is a file-backed LRU under it: pages the host LRU
evicts are written as DSTPUKV2 page records instead of dropped.

One page's path::

    device (LRU-parked) --evict+capture--> spilling (ref-pinned)
        --copy to host at the step boundary--> host (byte-budgeted LRU)
        --prefix walk hits--> restoring (one scatter) --> device (LRU-parked)

* Capture uses ``model_runner.paged_gather_pages``' exact-dtype layout
  (CPU tensors; int8 codes and fp32 scales under ``kv_quant``) and stamps
  ``kv_transfer.page_crcs``; restore recomputes the CRC and refuses a
  mismatch loudly (entry dropped, counted, the chain treated as a miss):
  the engine then prefills the suffix and loses nothing.
* Eviction only queues a capture (bounded by ``kv_tier.spill_inflight``;
  the page stays pinned until its copy is done); the copies drain in one
  batched gather at the next step boundary.

The engine side (capture hook, drain, restore, prefetch) lives in
``inference/v2/engine_v2.py``.  The counters are plain attributes, read
through ``stats()`` under the JAX tier's keys, and mirrored onto the
``deepspeed_tpu_serving_kv_tier_*`` and ``deepspeed_tpu_serving_kv_nvme_*``
metric families of the process registry under the reference's names,
help strings and labels; the tier's trace events (``kv_tier_spill``,
``kv_tier_restore``, ``kv_nvme_demote``, ``kv_nvme_promote``) have their
one owner here.  ``spill_seconds`` and ``restore_seconds`` (wall time of
the drains and restores) are kept beside them.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..telemetry import get_registry
from ..telemetry.spans import record_event
from ..utils.logging import logger
from .config import KVTierConfig
from .kv_transfer import (CorruptBundleError, bundle_from_bytes, bundle_to_bytes, page_crcs,
                          pages_from_bytes, pages_to_bytes)

Page = Dict[str, torch.Tensor]


def _nbytes(arrays: Page) -> int:
    return sum(t.numel() * t.element_size() for t in arrays.values())


class NVMeKVTier:
    """File-backed tier under the host LRU: one DSTPUKV2 page record per
    file (``kv_transfer.pages_to_bytes``: the wire format's layout, dtype
    and CRC rule), a byte-budgeted LRU over the file sizes, atomic writes
    (tmp + rename).  A read is CRC-verified: bit-identical or refused
    loudly.  Whole bundles can sit spilled too (:meth:`spill_bundle`,
    :meth:`restore_bundle`), their deadline re-based on restore exactly as
    across the wire."""

    def __init__(self, config: Optional[KVTierConfig] = None):
        self.config = config or KVTierConfig(enabled=True, nvme_enabled=True)
        self.dir = self.config.nvme_dir or tempfile.mkdtemp(prefix="dstpu_kv_nvme_")
        os.makedirs(self.dir, exist_ok=True)
        self._lru: "OrderedDict[Any, Tuple[str, int]]" = OrderedDict()
        self._bytes = 0
        self.spilled_pages = 0
        self.restored_pages = 0
        self.evicted_pages = 0
        self.corrupt_pages = 0
        self.misses = 0
        self._init_metrics()

    def _init_metrics(self) -> None:
        reg = get_registry()
        self._m_spilled = reg.counter(
            "deepspeed_tpu_serving_kv_nvme_spilled_pages_total",
            "pages demoted from the host LRU to NVMe page files "
            "(DSTPUKV2 records, atomic tmp+rename writes)")
        self._m_restored = reg.counter(
            "deepspeed_tpu_serving_kv_nvme_restored_pages_total",
            "NVMe page files promoted back to the host tier "
            "(CRC-verified on read, bit-identical)")
        self._m_bytes = reg.gauge(
            "deepspeed_tpu_serving_kv_nvme_bytes",
            "bytes of KV page files on disk (byte-budgeted LRU)")
        self._m_evicted = reg.counter(
            "deepspeed_tpu_serving_kv_nvme_evicted_pages_total",
            "page files unlinked from the NVMe LRU to hold the byte "
            "budget (the tier's floor: past it, pages are recomputed)")
        self._m_corrupt = reg.counter(
            "deepspeed_tpu_serving_kv_nvme_corrupt_pages_total",
            "page files refusing restore on CRC mismatch or torn read "
            "(file unlinked; the walk treats the page as a miss)")
        self._m_miss = reg.counter(
            "deepspeed_tpu_serving_kv_nvme_misses_total",
            "restore walks that consulted the NVMe tier for a page it "
            "does not hold")
        self._m_hit_rate = reg.gauge(
            "deepspeed_tpu_serving_kv_nvme_hit_rate",
            "cumulative NVMe promotes / (promotes + NVMe misses)")

    def _publish(self) -> None:
        self._m_bytes.set(self._bytes)
        looked = self.restored_pages + self.misses
        if looked:
            self._m_hit_rate.set(self.restored_pages / looked)

    @staticmethod
    def _key_name(key: Any) -> str:
        if isinstance(key, bytes):
            return key.hex()
        return hashlib.sha256(repr(key).encode()).hexdigest()

    def _path(self, key: Any) -> str:
        return os.path.join(self.dir, self._key_name(key) + ".kvpage")

    @staticmethod
    def _write_atomic(path: str, blob: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    @property
    def nvme_bytes(self) -> int:
        return self._bytes

    @property
    def nvme_pages(self) -> int:
        return len(self._lru)

    @property
    def hit_rate(self) -> float:
        looked = self.restored_pages + self.misses
        return self.restored_pages / looked if looked else 0.0

    def has(self, key: Any) -> bool:
        return key in self._lru

    def put(self, key: Any, arrays: Page) -> bool:
        """Write one page (atomically), then unlink the oldest files past
        the byte budget.  False, nothing written, when the one record
        exceeds the whole budget."""
        blob = pages_to_bytes(arrays, {"tier": "nvme", "key": self._key_name(key)})
        if len(blob) > self.config.nvme_bytes:
            logger.warning(f"kv_nvme: one page record ({len(blob)} B) exceeds the NVMe "
                           f"byte budget ({self.config.nvme_bytes} B); dropped")
            return False
        path = self._path(key)
        old = self._lru.pop(key, None)
        if old is not None:
            self._bytes -= old[1]
        self._write_atomic(path, blob)
        self._lru[key] = (path, len(blob))
        self._bytes += len(blob)
        self.spilled_pages += 1
        self._m_spilled.inc()
        while self._bytes > self.config.nvme_bytes:
            _, (p, nb) = self._lru.popitem(last=False)
            self._unlink(p)
            self._bytes -= nb
            self.evicted_pages += 1
            self._m_evicted.inc()
        self._publish()
        record_event("kv_nvme_demote", cat="serve",
                     nvme_pages=self.nvme_pages, nvme_bytes=self._bytes)
        return True

    def get(self, key: Any) -> Optional[Page]:
        """The page's tensors, CRC-verified, or None: on a miss (counted),
        or loudly on a corrupt or torn file, which is unlinked so the walk
        treats the page as a miss."""
        entry = self._lru.get(key)
        if entry is None:
            self.misses += 1
            self._m_miss.inc()
            self._publish()
            return None
        path, nb = entry
        try:
            with open(path, "rb") as f:
                blob = f.read()
            arrays, _header = pages_from_bytes(blob)
        except (OSError, CorruptBundleError) as e:
            self._lru.pop(key, None)
            self._bytes -= nb
            self.corrupt_pages += 1
            self._m_corrupt.inc()
            self._unlink(path)
            self._publish()
            logger.error(f"kv_nvme: REFUSING promote of page {self._key_name(key)[:16]}…: "
                         f"{e}; file dropped: the device recomputes the suffix, nothing is "
                         "lost")
            return None
        self._lru.move_to_end(key)
        self.restored_pages += 1
        self._m_restored.inc()
        self._publish()
        record_event("kv_nvme_promote", cat="serve", nvme_pages=self.nvme_pages)
        return arrays

    def pop(self, key: Any) -> None:
        """Drop one entry and its file (promotion moved it up a tier)."""
        entry = self._lru.pop(key, None)
        if entry is not None:
            self._bytes -= entry[1]
            self._unlink(entry[0])
            self._publish()

    def spill_bundle(self, bundle: Any) -> str:
        """Park a whole exported sequence on disk (``bundle_to_bytes``)."""
        path = os.path.join(self.dir, f"seq_{bundle.uid}.kvbundle")
        self._write_atomic(path, bundle_to_bytes(bundle))
        return path

    def restore_bundle(self, path: str) -> Any:
        """Read a spilled sequence back: the wire import's integrity pass,
        and its deadline re-based by the time it sat on disk."""
        with open(path, "rb") as f:
            return bundle_from_bytes(f.read())

    def stats(self) -> Dict[str, float]:
        return {"nvme_spilled_pages": self.spilled_pages,
                "nvme_restored_pages": self.restored_pages,
                "nvme_pages": self.nvme_pages,
                "nvme_bytes": self._bytes,
                "nvme_evictions": self.evicted_pages,
                "nvme_corrupt_pages": self.corrupt_pages,
                "nvme_misses": self.misses,
                "nvme_hit_rate": self.hit_rate}


class HostKVTier:
    """Byte-budgeted host LRU of spilled KV pages, keyed by the prefix
    cache's chain keys: one entry per page, ``{leaf: [L, 1, page_size,
    KVH(, D)]}`` CPU tensors in the pool's exact dtype, with the CRC32
    taken at capture.  Pure host state; the engine does the device
    copies."""

    def __init__(self, config: Optional[KVTierConfig] = None):
        self.config = config or KVTierConfig(enabled=True)
        #: key -> (arrays, crc, nbytes), oldest first
        self._lru: "OrderedDict[Any, Tuple[Page, int, int]]" = OrderedDict()
        self._bytes = 0
        self.spilled_pages = 0
        self.restored_pages = 0
        self.host_evictions = 0
        self.corrupt_pages = 0
        self.dropped_spills = 0
        self.hits = 0    # pages served from the tier (on restore)
        self.misses = 0  # restore walks that ended on a page not held
        #: wall seconds of the drained spill batches and of the restores
        self.spill_seconds = 0.0
        self.restore_seconds = 0.0
        self.nvme: Optional[NVMeKVTier] = (
            NVMeKVTier(self.config) if self.config.nvme_enabled else None)
        self._init_metrics()

    def _init_metrics(self) -> None:
        reg = get_registry()
        self._m_spilled = reg.counter(
            "deepspeed_tpu_serving_kv_tier_spilled_pages_total",
            "prefix-cache pages captured into the host tier on LRU "
            "eviction (D2H commit counted, not queueing)")
        self._m_restored = reg.counter(
            "deepspeed_tpu_serving_kv_tier_restored_pages_total",
            "host-tier pages restored into the device pool (H2D, "
            "CRC-verified bit-identical)")
        self._m_host_bytes = reg.gauge(
            "deepspeed_tpu_serving_kv_tier_host_bytes",
            "host RAM held by spilled KV pages (byte-budgeted LRU)")
        self._m_hit_rate = reg.gauge(
            "deepspeed_tpu_serving_kv_tier_hit_rate",
            "cumulative restored pages / (restored + restore walks that "
            "missed)")
        self._m_restore_h = reg.histogram(
            "deepspeed_tpu_serving_kv_tier_restore_seconds",
            "one batched host->device restore (H2D scatter + CRC "
            "verification) wall time")
        self._m_host_evict = reg.counter(
            "deepspeed_tpu_serving_kv_tier_host_evicted_pages_total",
            "spilled pages dropped from the host LRU to hold the byte "
            "budget")
        self._m_corrupt = reg.counter(
            "deepspeed_tpu_serving_kv_tier_corrupt_pages_total",
            "host-tier pages refusing restore on CRC mismatch (entry "
            "dropped; the device treats the page as a miss)")
        self._m_dropped = reg.counter(
            "deepspeed_tpu_serving_kv_tier_dropped_spills_total",
            "evictions whose spill was refused: the bounded in-flight "
            "queue was full, or a single page exceeded the whole host "
            "byte budget (the device never blocks on the tier either "
            "way)")

    def _publish(self) -> None:
        self._m_host_bytes.set(self._bytes)
        looked = self.restored_pages + self.misses
        if looked:
            self._m_hit_rate.set(self.restored_pages / looked)

    @property
    def host_bytes(self) -> int:
        return self._bytes

    @property
    def host_pages(self) -> int:
        return len(self._lru)

    @property
    def hit_rate(self) -> float:
        looked = self.restored_pages + self.misses
        return self.restored_pages / looked if looked else 0.0

    def has(self, key: Any) -> bool:
        """Membership in the host LRU or the NVMe tier, without touching
        recency (the prefix walk's consult)."""
        if key in self._lru:
            return True
        return self.nvme is not None and self.nvme.has(key)

    def _evict_over_budget(self, keep: Any = None) -> None:
        """Evict the oldest entries past the byte budget, each demoted to
        the NVMe tier when there is one (never ``keep``)."""
        while self._bytes > self.config.host_bytes:
            k, (arrs, _, nb) = self._lru.popitem(last=False)
            self._bytes -= nb
            self.host_evictions += 1
            self._m_host_evict.inc()
            if self.nvme is not None and k != keep:
                self.nvme.put(k, arrs)

    def insert(self, key: Any, arrays: Page, crc: int) -> bool:
        """Commit one captured page (already copied to the host) at the
        MRU end, then evict past the byte budget.  False, nothing stored,
        when the one page exceeds the whole budget."""
        nbytes = _nbytes(arrays)
        if nbytes > self.config.host_bytes:
            self.dropped_spills += 1
            self._m_dropped.inc()
            logger.warning(f"kv_tier: one page ({nbytes} B) exceeds the host byte budget "
                           f"({self.config.host_bytes} B); not spilled")
            return False
        old = self._lru.pop(key, None)
        if old is not None:
            self._bytes -= old[2]
        self._lru[key] = (arrays, int(crc) & 0xFFFFFFFF, nbytes)
        self._bytes += nbytes
        self.spilled_pages += 1
        self._m_spilled.inc()
        self._evict_over_budget()
        self._publish()
        return True

    def get(self, key: Any) -> Optional[Page]:
        """The page's tensors for a restore, CRC-verified (recency
        refreshed), or None: on a miss, or loudly on a CRC mismatch, where
        the entry is dropped.  A host miss reads the NVMe tier and moves a
        hit back up into the host LRU."""
        entry = self._lru.get(key)
        if entry is None:
            if self.nvme is None:
                return None
            arrays = self.nvme.get(key)
            if arrays is None:
                return None
            crc = page_crcs(arrays, sorted(arrays))[0]
            self.nvme.pop(key)
            nbytes = _nbytes(arrays)
            if nbytes <= self.config.host_bytes:
                self._lru[key] = (arrays, crc, nbytes)
                self._bytes += nbytes
                self._evict_over_budget(keep=key)
                self._publish()
            return arrays
        arrays, crc, _nbytes_ = entry
        got = page_crcs(arrays, sorted(arrays))[0]
        if got != crc:
            self._drop_corrupt(key, crc, got)
            return None
        self._lru.move_to_end(key)
        return arrays

    def _drop_corrupt(self, key: Any, want: int, got: int) -> None:
        _arrays, _crc, nb = self._lru.pop(key)
        self._bytes -= nb
        self.corrupt_pages += 1
        self._m_corrupt.inc()
        self._publish()
        kh = key.hex()[:16] if isinstance(key, bytes) else str(key)
        logger.error(f"kv_tier: REFUSING restore of page {kh}…: CRC32 {got:#010x} != "
                     f"captured {want:#010x} (host-RAM bit flip or torn copy); entry "
                     "dropped: the device recomputes the suffix, nothing is lost")

    # -- accounting (the engine calls these) ---------------------------------
    def note_capture_dropped(self, n: int = 1) -> None:
        """The in-flight spill queue was full: ``n`` evictions not captured."""
        self.dropped_spills += n
        self._m_dropped.inc(n)

    def note_spill(self, pages: int, wall_s: float) -> None:
        """One drained spill batch committed ``pages`` copies."""
        self.spill_seconds += wall_s
        record_event("kv_tier_spill", cat="serve", pages=pages,
                     host_pages=self.host_pages, host_bytes=self._bytes,
                     wall_s=round(wall_s, 6))

    def note_restore(self, pages: int, wall_s: float) -> None:
        """One restore batch moved ``pages`` pages to the device."""
        self.restored_pages += pages
        self.hits += pages
        self.restore_seconds += wall_s
        self._m_restored.inc(pages)
        self._m_restore_h.observe(wall_s)
        self._publish()
        record_event("kv_tier_restore", cat="serve", pages=pages,
                     host_pages=self.host_pages, wall_s=round(wall_s, 6))

    def note_miss(self) -> None:
        """A restore walk needed a page the tier does not hold."""
        self.misses += 1
        self._publish()

    def stats(self) -> Dict[str, float]:
        """Cumulative tier counters, under the JAX tier's keys."""
        out = {"spilled_pages": self.spilled_pages,
               "restored_pages": self.restored_pages,
               "host_pages": self.host_pages,
               "host_bytes": self._bytes,
               "host_evictions": self.host_evictions,
               "corrupt_pages": self.corrupt_pages,
               "dropped_spills": self.dropped_spills,
               "hit_rate": self.hit_rate}
        if self.nvme is not None:
            out.update(self.nvme.stats())
        return out


def page_slices(arrays: Page, j: int) -> Page:
    """Page ``j``'s own copy out of a gathered batch, ``[L, 1, ...]`` per
    leaf: an entry owns its memory, not a view of the whole batch."""
    return {name: a[:, j:j + 1].clone(memory_format=torch.contiguous_format)
            for name, a in arrays.items()}


def batch_page_crcs(arrays: Page) -> List[int]:
    """Per-page CRC32s of a gathered batch: ``kv_transfer.page_crcs``."""
    return page_crcs(arrays, sorted(arrays))


__all__ = ["HostKVTier", "NVMeKVTier", "KVTierConfig", "page_slices", "batch_page_crcs"]
