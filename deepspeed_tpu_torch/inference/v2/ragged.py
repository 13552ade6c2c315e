"""Paged KV-cache state (the port's copy of ``deepspeed_tpu/inference/v2/
ragged.py``): the ref-counted page allocator with its prefix-cache
registry and spill pins, the content-hash :class:`PrefixCache`, the page
pool, the :class:`KVPageBundle` that carries a sequence's pages between
engines, and the host-side :class:`SequenceState`.

Layout: ``k``/``v`` are ``[L, num_pages + 1, page_size, KVH, D]``.  The
last page (index ``num_pages``) is the *trash page*: writes from inactive
slots and pad positions are routed there, keeping every scatter
unconditional.  Nothing ever reads the trash page for a live token.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ...accelerator import DeviceLike, resolve_device

#: request priority classes (smaller = more urgent): order admission and
#: choose preemption victims under KV-pool pressure
PRIORITY_INTERACTIVE = 0
PRIORITY_NORMAL = 1
PRIORITY_BATCH = 2


class RejectedError(RuntimeError):
    """A request refused by admission control (load shedding): the
    submitter still holds the request and should back off
    ``retry_after_s`` seconds before resubmitting."""

    def __init__(self, reason: str, retry_after_s: float = 1.0,
                 priority: Optional[int] = None):
        super().__init__(
            f"request rejected ({reason}); retry after {retry_after_s:.2f}s")
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        self.priority = priority


@dataclasses.dataclass
class KVBlockConfig:
    page_size: int = 16
    num_pages: int = 256
    max_seqs: int = 8  # concurrent decode slots
    max_pages_per_seq: int = 16

    @property
    def max_seq_len(self) -> int:
        return self.page_size * self.max_pages_per_seq

    @property
    def trash_page(self) -> int:
        return self.num_pages


class BlockAllocator:
    """Ref-counted page allocator, host-side, O(1) alloc/share/free.

    Every live page carries a refcount: ``alloc`` hands out pages at
    refcount 1, ``share`` maps an already-written page into another
    sequence (+1), ``free`` drops a reference.  A page is never recycled
    while referenced.  Pages may additionally be registered under a
    content key: when a registered page's refcount drops to 0 it is
    parked in an LRU of cached-but-unreferenced pages instead of the free
    list, and ``alloc`` evicts from the LRU tail only after the free list
    is empty.  ``spill_hook(page, key) -> bool`` is offered every page
    evicted from the LRU: True captures it for a host-tier spill, and the
    allocator pins it (refcount 1, ``_spill_pinned``) until the owner
    calls :meth:`release_spill_pin` once the copy to the host is done."""

    def __init__(self, num_pages: int, cache_pages: int = 0):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref: List[int] = [0] * num_pages
        #: cap on cached-but-unreferenced pages retained (0 = pool-bounded)
        self.cache_cap = cache_pages
        self._by_key: Dict[Any, int] = {}   # content key -> page
        self._key_of: Dict[int, Any] = {}   # page -> content key
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # oldest first
        self.evictions = 0
        self.spill_hook = None
        self._spill_pinned: set = set()
        self._pin_slack = num_pages
        #: bumped on every registry change (register/evict)
        self.generation = 0
        #: bumped only on unregister
        self.evict_generation = 0

    @property
    def free_pages(self) -> int:
        """Allocatable pages: truly free + cached-but-unreferenced."""
        return len(self._free) + len(self._lru)

    @property
    def used_pages(self) -> int:
        """Pages referenced by live sequences (refcount > 0)."""
        return self.num_pages - len(self._free) - len(self._lru)

    @property
    def uncached_free_pages(self) -> int:
        return len(self._free)

    @property
    def lru_pages(self) -> int:
        return len(self._lru)

    @property
    def cached_pages(self) -> int:
        return len(self._by_key)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def alloc(self, n: int) -> List[int]:
        if n > self.free_pages:
            raise MemoryError(f"KV pool exhausted: need {n} pages, "
                              f"{self.free_pages} free")
        self._pin_slack = self.free_pages - n
        try:
            out = []
            for _ in range(n):
                if self._free:
                    p = self._free.pop()
                else:
                    p = self._evict_lru()
                self._ref[p] = 1
                out.append(p)
        finally:
            self._pin_slack = self.num_pages
        return out

    def try_alloc(self, n: int,
                  uncached_only: bool = False) -> Optional[List[int]]:
        """Non-raising twin of :meth:`alloc`: ``None`` (allocator
        untouched) when the pool cannot cover ``n`` pages."""
        budget = self.uncached_free_pages if uncached_only \
            else self.free_pages
        if n > budget:
            return None
        return self.alloc(n)

    def share(self, page: int) -> int:
        """Map an already-written page into another sequence (+1 ref)."""
        if not (0 <= page < self.num_pages):
            raise ValueError(f"sharing invalid page {page}")
        if self._ref[page] == 0:
            if page not in self._lru:
                raise ValueError(f"sharing unreferenced uncached page {page}")
            del self._lru[page]
        self._ref[page] += 1
        return page

    def free(self, pages: List[int]) -> None:
        # validate the WHOLE list before mutating (duplicate-aware)
        counts: Dict[int, int] = {}
        for p in pages:
            if not (0 <= p < self.num_pages):
                raise ValueError(f"freeing invalid page {p}")
            counts[p] = counts.get(p, 0) + 1
        for p, c in counts.items():
            if self._ref[p] < c:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                if p in self._key_of:
                    self._lru[p] = None
                    self._trim_cache()
                else:
                    self._free.append(p)

    def check_invariants(
            self, live_pages: Optional[Sequence[Sequence[int]]] = None
    ) -> None:
        """Audit the allocator's invariants; raise ``AssertionError``
        naming the first violation.  ``live_pages`` (one page list per
        live owner) additionally audits every refcount exactly."""
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            raise AssertionError(
                f"free list has duplicates: {sorted(self._free)}")
        if free_set & set(self._lru):
            raise AssertionError(
                f"pages in free list AND LRU: {sorted(free_set & set(self._lru))}")
        for p in self._free:
            if self._ref[p] != 0:
                raise AssertionError(
                    f"page {p} in free list with refcount {self._ref[p]}")
        for p in self._lru:
            if self._ref[p] != 0:
                raise AssertionError(
                    f"LRU page {p} has refcount {self._ref[p]}")
            if p not in self._key_of:
                raise AssertionError(f"LRU page {p} is not registered")
        referenced = {p for p in range(self.num_pages) if self._ref[p] > 0}
        if referenced & free_set:
            raise AssertionError(
                f"referenced pages in free list: {sorted(referenced & free_set)}")
        covered = len(free_set) + len(self._lru) + len(referenced)
        if covered != self.num_pages:
            raise AssertionError(
                f"page partition broken: {len(free_set)} free + "
                f"{len(self._lru)} LRU + {len(referenced)} referenced "
                f"!= {self.num_pages} pages")
        if len(self._by_key) != len(self._key_of):
            raise AssertionError("registry maps disagree in size")
        for key, p in self._by_key.items():
            if self._key_of.get(p) != key:
                raise AssertionError(f"registry not a bijection at page {p}")
        if self.cache_cap > 0 and len(self._lru) > self.cache_cap:
            raise AssertionError(
                f"LRU {len(self._lru)} exceeds cache_cap {self.cache_cap}")
        for p in self._spill_pinned:
            if self._ref[p] < 1:
                raise AssertionError(
                    f"spill-pinned page {p} has refcount {self._ref[p]}")
            if p in self._key_of:
                raise AssertionError(
                    f"spill-pinned page {p} is still registered")
        if live_pages is not None:
            want: Dict[int, int] = {}
            for p in self._spill_pinned:
                want[p] = 1
            for owner in live_pages:
                for p in owner:
                    want[p] = want.get(p, 0) + 1
            for p in range(self.num_pages):
                w = want.get(p, 0)
                if self._ref[p] != w:
                    raise AssertionError(
                        f"page {p}: refcount {self._ref[p]} != {w} live "
                        f"reference(s) — "
                        f"{'leak' if self._ref[p] > w else 'use-after-free'}")

    def assert_no_leaks(
            self, live_pages: Sequence[Sequence[int]] = ()) -> None:
        self.check_invariants(list(live_pages))

    def adopt(self, keys: Sequence[Optional[Any]]
              ) -> Tuple[List[int], List[bool]]:
        """Import-side placement with ref-count adoption: registered keys
        share the local page, the rest get fresh pages.  All-or-nothing."""
        matched = [self._by_key.get(k) if k is not None else None
                   for k in keys]
        lru_matched = sum(1 for p in matched
                          if p is not None and self._ref[p] == 0)
        need = sum(1 for p in matched if p is None)
        if need > self.free_pages - lru_matched:
            raise MemoryError(
                f"KV import needs {need} fresh pages "
                f"(+{lru_matched} adopted from the LRU), only "
                f"{self.free_pages - lru_matched} allocatable")
        for p in matched:
            if p is not None:
                self.share(p)
        fresh = iter(self.alloc(need))
        pages = [p if p is not None else next(fresh) for p in matched]
        return pages, [p is not None for p in matched]

    def export_meta(self, pages: Sequence[int]) -> List[Dict[str, Any]]:
        return [{"page": int(p), "refcount": self._ref[p],
                 "key": self._key_of.get(p)} for p in pages]

    # -- prefix-cache registry ----------------------------------------------
    def register(self, page: int, key: Any) -> bool:
        """Publish ``page`` as the cached page for ``key`` (first writer
        wins)."""
        if key in self._by_key or page in self._key_of:
            return False
        self._by_key[key] = page
        self._key_of[page] = key
        self.generation += 1
        return True

    def lookup(self, key: Any) -> Optional[int]:
        return self._by_key.get(key)

    def _unregister(self, page: int) -> None:
        key = self._key_of.pop(page, None)
        if key is not None and self._by_key.get(key) == page:
            del self._by_key[key]
            self.generation += 1
            self.evict_generation += 1

    def _evict_one(self) -> Optional[int]:
        page, _ = self._lru.popitem(last=False)
        key = self._key_of.get(page)
        self._unregister(page)
        self.evictions += 1
        if (self.spill_hook is not None and self._pin_slack > 0
                and self.spill_hook(page, key)):
            self._ref[page] = 1
            self._spill_pinned.add(page)
            self._pin_slack -= 1
            return None
        return page

    def _evict_lru(self) -> int:
        while True:
            p = self._evict_one()
            if p is not None:
                return p

    def _trim_cache(self) -> None:
        if self.cache_cap > 0:
            while len(self._lru) > self.cache_cap:
                p = self._evict_one()
                if p is not None:
                    self._free.append(p)

    @property
    def spill_pinned_pages(self) -> int:
        return len(self._spill_pinned)

    def release_spill_pin(self, page: int) -> None:
        if page not in self._spill_pinned:
            raise ValueError(f"page {page} is not spill-pinned")
        self._spill_pinned.discard(page)
        self.free([page])


class PrefixCache:
    """Automatic prefix caching: a content-hash chain over FULL pages.

    Page ``j``'s key is ``sha256(key[j-1], tokens[j*ps:(j+1)*ps])``, so a
    page's identity depends on its whole token prefix and a walk from the
    root finds the longest cached page-aligned prefix.  Partial tail pages
    are never hashed: they stay private to their sequence (the engine
    copies on write the one shared full page a sequence must write).
    ``hits``/``misses`` count consumed matches; evictions are the
    allocator's."""

    def __init__(self, page_size: int, allocator: BlockAllocator):
        self.page_size = page_size
        self.allocator = allocator
        self.hits = 0    # page lookups that matched (counted on admission)
        self.misses = 0  # admission walks that ended on a missing page

    @staticmethod
    def chain_key(parent_key: Any, page_tokens: Sequence[int]) -> bytes:
        """sha256 digest chain (not ``hash()``: a colliding key would map a
        request onto another's KV), the reference's bytes exactly."""
        h = hashlib.sha256()
        if parent_key is not None:
            h.update(parent_key)
        h.update(",".join(str(int(t)) for t in page_tokens).encode())
        return h.digest()

    def page_keys(self, tokens: Sequence[int], n_pages: int,
                  prefix_keys: Sequence[Any] = ()) -> List[Any]:
        """Chain keys for full pages ``[len(prefix_keys), n_pages)``,
        extending an already computed prefix of keys."""
        keys = list(prefix_keys)
        ps = self.page_size
        for j in range(len(keys), n_pages):
            parent = keys[j - 1] if j else None
            keys.append(self.chain_key(parent, tokens[j * ps:(j + 1) * ps]))
        return keys

    def match(self, tokens: Sequence[int],
              resume: Optional[Tuple[List[int], List[Any]]] = None,
              host_tier: Any = None):
        """Longest cached page-aligned prefix of ``tokens``: ``(pages,
        keys)``.  Pure: the caller counts hits and misses when an admission
        consumes the match.  ``resume``: an earlier match of the same
        tokens still valid (no eviction since), continued from its end.
        ``host_tier`` (anything with ``has(key)``): the walk goes on past
        the device hit and a third element lists the chain keys of the
        consecutive pages the tier holds."""
        ps = self.page_size
        pages: List[int] = list(resume[0]) if resume else []
        keys: List[Any] = list(resume[1]) if resume else []
        parent = keys[-1] if keys else None
        for j in range(len(pages), len(tokens) // ps):
            key = self.chain_key(parent, tokens[j * ps:(j + 1) * ps])
            page = self.allocator.lookup(key)
            if page is None:
                break
            pages.append(page)
            keys.append(key)
            parent = key
        if host_tier is not None:
            return pages, keys, self.host_extend(tokens, keys, host_tier)
        return pages, keys

    def host_extend(self, tokens: Sequence[int], keys: Sequence[Any],
                    host_tier: Any) -> List[Any]:
        """Chain keys of the consecutive full pages past ``keys`` that
        ``host_tier`` holds (pure: no counters, no restore)."""
        ps = self.page_size
        out: List[Any] = []
        parent = keys[-1] if keys else None
        for j in range(len(keys), len(tokens) // ps):
            key = self.chain_key(parent, tokens[j * ps:(j + 1) * ps])
            if not host_tier.has(key):
                break
            out.append(key)
            parent = key
        return out

    def count(self, matched_pages: int, n_full_pages: int) -> None:
        """Record a consumed match in the hit/miss counters."""
        self.hits += matched_pages
        if matched_pages < n_full_pages:
            self.misses += 1


class PagedKVCache:
    """Device tensors of the page pool.

    ``kv_quant``: int8 codes + one fp32 scale per (page, slot, kv-head).
    The pools are updated IN PLACE by the model runner's programs — the
    counterpart of the JAX engine donating the pool buffers to each
    jitted step.  ``device`` None means ``cuda``, as everywhere in the
    port."""

    @staticmethod
    def init(n_layers: int, kv_heads: int, head_dim: int,
             block: KVBlockConfig, dtype: torch.dtype = torch.bfloat16,
             kv_quant: bool = False, device: DeviceLike = None
             ) -> Dict[str, torch.Tensor]:
        device = resolve_device(device)
        shape = (n_layers, block.num_pages + 1, block.page_size, kv_heads, head_dim)
        if kv_quant:
            sshape = shape[:-1]
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
                    "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device)}
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}


@dataclasses.dataclass
class KVPageBundle:
    """One in-flight sequence's KV pages and scheduling state: the unit
    of KV-page migration between engines.

    ``arrays`` holds one CPU tensor per pool leaf (``k``/``v`` and, under
    kv_quant, their scales), ``[L, n_pages, page_size, KVH(, D)]`` in the
    pool's exact dtype: an import is bit-identical.  ``page_keys`` covers
    only the leading full pages that are never written again (index <
    ``prefilled // page_size``), which an importing engine may adopt by
    content key; later pages always travel by value.  ``src_pages`` is
    the exporting allocator's ``export_meta`` (page ids mean nothing in
    another pool).  ``deadline`` is absolute on ``time.perf_counter``'s
    clock (0 = none); the wire format re-bases it as seconds left.
    ``trace`` is plain data (the fleet trace context), None here."""

    uid: int
    tokens: List[int]
    prompt_len: int
    max_new_tokens: int
    temperature: float
    eos_id: Optional[int]
    #: tokens of the prefix whose KV is already written in ``arrays``
    prefilled: int
    #: fully cached prompt mid-handoff: enters through the decode program
    decode_entry: bool
    page_size: int
    page_keys: List[Any]
    src_pages: List[Dict[str, Any]]
    arrays: Dict[str, Any]
    #: (n_layers, kv_heads, head_dim): pools must agree to import
    model_sig: Tuple[int, int, int]
    kv_quant: bool
    dtype: str
    priority: int = PRIORITY_NORMAL
    deadline: float = 0.0
    trace: Optional[Dict[str, Any]] = None

    @property
    def n_pages(self) -> int:
        return next(iter(self.arrays.values())).shape[1]

    @property
    def generated(self) -> int:
        return len(self.tokens) - self.prompt_len


@dataclasses.dataclass
class SequenceState:
    """Host-side descriptor of one in-flight sequence."""

    uid: int
    tokens: List[int]  # prompt + generated so far
    prompt_len: int
    max_new_tokens: int
    temperature: float
    eos_id: Optional[int]
    slot: int = -1  # decode slot index, -1 = not scheduled
    pages: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    admit_order: int = -1  # monotonic admission stamp (preemption policy)
    #: tokens of the prefix already prefilled (chunked prefill, or cached
    #: prefix pages mapped at admission); a sequence decodes only once
    #: prefilled == length at chunk end
    prefilled: int = 0
    #: prefix cache: chain keys of the full pages computed so far, and how
    #: many leading pages have been offered to the registry
    page_keys: List[Any] = dataclasses.field(default_factory=list)
    registered_upto: int = 0
    #: fully cached prompt: every prompt page mapped from the cache (the
    #: last one copied on write); the decode program recomputes only the
    #: final prompt token
    decode_entry: bool = False
    #: memoized match of a QUEUED sequence, valid while the allocator's
    #: registry generation is unchanged; resumed from its end while only
    #: registrations happened (evict generation unchanged)
    cached_match: Any = None
    match_gen: int = -1
    match_evict_gen: int = -1
    priority: int = PRIORITY_NORMAL
    #: absolute expiry on the ``time.perf_counter`` clock (0 = none)
    deadline: float = 0.0
    #: monotonic enqueue stamp: FCFS order within a priority class
    enqueue_order: int = -1
    queued_at: float = 0.0
    #: "length", "eos", "max_seq_len", "deadline"; "" while running
    finish_reason: str = ""
    trace_id: Optional[str] = None

    @property
    def length(self) -> int:
        return len(self.tokens)

    @property
    def generated(self) -> int:
        return self.length - self.prompt_len
