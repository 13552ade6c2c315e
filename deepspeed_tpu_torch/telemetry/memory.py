"""Device memory ledger and OOM forensics (the port's counterpart of
``deepspeed_tpu/telemetry/memory.py``).

* **MemoryLedger** — attributes device/host bytes to named *components*
  structurally: each component is a provider callback returning a tree
  (tensors, ``ParamTree``s and other ``nn.Module``s, dicts, lists and
  tuples; numpy arrays count as host bytes) or an explicit
  ``{"device": n, "host": n}`` byte dict.  The residual against the
  accelerator's live ``memory_stats()`` (on CUDA the caching allocator's
  ``memory_allocated``) is published as *unattributed*: the CUDA-graph
  pool, workspaces, transients, anything the structural view cannot see.

* **Per-phase peak watermarks** — hooked off the span enters/exits
  (``spans.set_phase_listener``): when a watched phase opens or closes,
  the ledger reads the allocator's two cheap counters (bytes allocated
  now and at peak; ``accelerator.memory_counters``, never the full
  ``memory_stats`` or ``mem_get_info``) and keeps the highest in-phase
  occupancy per phase.

* **OOM forensics** — ``record_oom_incident`` turns a
  ``torch.cuda.OutOfMemoryError`` (the engines route step exceptions here
  via ``flight.dump_on_exception``) into a memory incident report through
  the flight recorder: ledger breakdown, raw ``memory_stats()``, the top
  live device tensors aggregated by dtype/shape, and actionable hints.

A tensor counts as device bytes on the ledger's device type (CUDA when a
card is present, else the CPU, as the JAX package counts its CPU arrays)
and as host bytes elsewhere (pinned staging, host-tier pages).

Gauges (published by ``publish()``):

* ``deepspeed_tpu_memory_component_bytes{component,space}``
* ``deepspeed_tpu_memory_bytes_in_use`` / ``_peak_bytes_in_use`` /
  ``_bytes_limit``
* ``deepspeed_tpu_memory_unattributed_bytes``
* ``deepspeed_tpu_memory_phase_peak_bytes{phase}``
* ``deepspeed_tpu_memory_oom_incidents_total{where}``
"""

from __future__ import annotations

import gc
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import accelerator
from ..utils.logging import logger
from .registry import MetricsRegistry, get_registry

#: span/phase names whose enters/exits feed the per-phase watermarks
DEFAULT_WATCH_PHASES = ("train_batch", "forward", "backward",
                        "optimizer_step", "prefill", "decode",
                        "multi_decode")

#: substrings that mark an exception as a memory exhaustion when its type
#: does not say so (the KV allocator raises MemoryError)
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED")


def is_resource_exhausted(exc: BaseException) -> bool:
    """True when ``exc`` is a device/host memory exhaustion
    (``torch.cuda.OutOfMemoryError``, ``MemoryError``, "out of memory"
    text)."""
    if exc is None:
        return False
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    msg = f"{type(exc).__name__}: {exc}"
    return any(m in msg for m in _OOM_MARKERS) or "out of memory" in msg.lower()


# --------------------------------------------------------------------------
# structural byte accounting
# --------------------------------------------------------------------------
def _device_type() -> str:
    return accelerator.default_device().type


def leaf_bytes(x: Any, device_type: Optional[str] = None) -> Tuple[int, int]:
    """``(device_bytes, host_bytes)`` of one leaf: a tensor on
    ``device_type`` (default: the ledger's device type) is device bytes,
    any other tensor and a numpy array host bytes; Python scalars are
    free."""
    if isinstance(x, torch.Tensor):
        n = x.numel() * x.element_size()
        return (n, 0) if x.device.type == (device_type or _device_type()) else (0, n)
    if isinstance(x, np.ndarray):
        return (0, int(x.nbytes))
    return (0, 0)


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def tree_bytes(tree: Any) -> Tuple[int, int]:
    """``(device_bytes, host_bytes)`` summed over a tree (each tensor
    once), or an explicit ``{"device": n, "host": n}`` byte dict."""
    if isinstance(tree, dict) and tree and set(tree) <= {"device", "host"} \
            and all(isinstance(v, (int, float)) for v in tree.values()):
        return (int(tree.get("device", 0)), int(tree.get("host", 0)))
    dtype = _device_type()
    dev = host = 0
    seen = set()
    for leaf in _leaves(tree):
        if id(leaf) in seen:
            continue
        seen.add(id(leaf))
        d, h = leaf_bytes(leaf, dtype)
        dev += d
        host += h
    return (dev, host)


def top_live_buffers(n: int = 10) -> List[Dict[str, Any]]:
    """The biggest live device tensors the garbage collector tracks,
    aggregated by (dtype, shape): ``[{"dtype", "shape", "count",
    "total_bytes"}, ...]`` sorted by total bytes descending — the "who is
    holding memory" list of an OOM incident report."""
    dtype = _device_type()
    agg: Dict[Tuple[str, Tuple[int, ...]], Dict[str, Any]] = {}
    seen = set()
    for obj in gc.get_objects():
        if not isinstance(obj, torch.Tensor) or id(obj) in seen:
            continue
        seen.add(id(obj))
        nb, _ = leaf_bytes(obj, dtype)
        if nb == 0:
            continue
        key = (str(obj.dtype), tuple(int(s) for s in obj.shape))
        row = agg.setdefault(key, {"dtype": key[0], "shape": list(key[1]),
                                   "count": 0, "total_bytes": 0})
        row["count"] += 1
        row["total_bytes"] += nb
    rows = sorted(agg.values(), key=lambda r: -r["total_bytes"])
    return rows[:max(1, int(n))]


class _Component:
    __slots__ = ("name", "provider", "informational")

    def __init__(self, name: str, provider: Callable[[], Any],
                 informational: bool):
        self.name = name
        self.provider = provider
        self.informational = informational


class MemoryLedger:
    """Structural device-memory attribution + per-phase watermarks.

    One ledger per process (``get_memory_ledger()``); the serving engine
    attaches its weights and KV page pool.  A component attached under an
    existing name replaces it (engines are rebuilt; the latest owner
    wins).  ``informational`` components (prefix-cache-pinned pages, a
    sub-slice of the KV pool) are published but excluded from the
    attribution sum so the unattributed residual stays honest.

    ``accelerator``: an object with ``memory_stats()`` (and optionally
    ``memory_counters()``) returning the reference's keys; None reads the
    port's accelerator on its default device."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 accelerator: Any = None,
                 watch_phases=DEFAULT_WATCH_PHASES):
        self.registry = registry or get_registry()
        self._acc = accelerator
        #: the device the port's accelerator is read on, fixed at first use
        self._device = None
        self._lock = threading.Lock()
        self._components: Dict[str, _Component] = {}
        #: hint context the engines register (KV geometry); feeds ``oom_hints``
        self.context: Dict[str, Any] = {}
        self.watch_phases = set(watch_phases)
        #: top-N live-buffer rows embedded in an OOM incident
        self.top_buffers = 10
        self._phase_enter: Dict[str, Tuple[int, int]] = {}
        self._watermarks: Dict[str, int] = {}
        #: (phase, process_peak_at_exit) of recent phase exits — the
        #: process peak is a running max, so this sequence is monotone
        self._exit_log: deque = deque(maxlen=128)
        self._watching = False
        reg = self.registry
        self._g_component = reg.gauge(
            "deepspeed_tpu_memory_component_bytes",
            "structural bytes attributed to a named component",
            labelnames=("component", "space"))
        self._g_in_use = reg.gauge(
            "deepspeed_tpu_memory_bytes_in_use",
            "live accelerator bytes in use (summed over local devices)")
        self._g_peak = reg.gauge(
            "deepspeed_tpu_memory_peak_bytes_in_use",
            "accelerator peak bytes in use since process start")
        self._g_limit = reg.gauge(
            "deepspeed_tpu_memory_bytes_limit",
            "accelerator memory capacity (0 when unreported)")
        self._g_unattributed = reg.gauge(
            "deepspeed_tpu_memory_unattributed_bytes",
            "bytes_in_use minus the attributed device components "
            "(transients, fragmentation, untracked buffers)")
        self._g_phase_peak = reg.gauge(
            "deepspeed_tpu_memory_phase_peak_bytes",
            "highest device occupancy observed while the phase was open",
            labelnames=("phase",))
        self._c_oom = reg.counter(
            "deepspeed_tpu_memory_oom_incidents_total",
            "RESOURCE_EXHAUSTED incidents captured by OOM forensics",
            labelnames=("where",))

    # ------------------------------------------------------------ components
    def attach(self, name: str, provider: Callable[[], Any],
               informational: bool = False) -> None:
        """Register/replace a component: ``provider()`` returns a tree
        (structurally measured) or a ``{"device": n, "host": n}`` dict."""
        with self._lock:
            self._components[name] = _Component(name, provider,
                                                bool(informational))

    def detach(self, name: str, provider: Optional[Callable] = None) -> None:
        """Remove a component.  With ``provider``, remove only if it is
        still the registered one — a closed engine must not detach the
        component a newer engine has since claimed under the same name."""
        with self._lock:
            comp = self._components.get(name)
            if comp is None:
                return
            if provider is not None and comp.provider is not provider:
                return  # replaced by a newer owner; not ours to remove
            del self._components[name]
        # zero the gauge rows so a stale component cannot masquerade as live
        for space in ("device", "host"):
            self._g_component.set(0, component=name, space=space)

    def update_context(self, **fields) -> None:
        """Merge hint context (KV geometry, offload flags)."""
        self.context.update(fields)

    # ------------------------------------------------------------ sampling
    def memory_stats(self) -> Dict[str, int]:
        """Live accelerator stats (empty dict when the platform reports
        nothing)."""
        try:
            s = (self._acc.memory_stats() if self._acc is not None
                 else accelerator.memory_stats(self._dev()))
        except Exception:
            s = {}
        return {k: int(v) for k, v in (s or {}).items()
                if isinstance(v, (int, float))}

    def memory_counters(self) -> Dict[str, int]:
        """The two cheap occupancy counters (``bytes_in_use``,
        ``peak_bytes_in_use``) the phase watch reads at every edge."""
        if self._acc is None:
            return accelerator.memory_counters(self._dev())
        fn = getattr(self._acc, "memory_counters", None)
        return fn() if fn is not None else self._acc.memory_stats()

    def _dev(self):
        if self._device is None:
            self._device = accelerator.default_device()
        return self._device

    def publish_stats(self, stats: Optional[Dict[str, int]] = None
                      ) -> Dict[str, int]:
        """Publish the live-occupancy gauges only; returns the stats used."""
        s = self.memory_stats() if stats is None else stats
        if s:
            self._g_in_use.set(s.get("bytes_in_use", 0))
            self._g_peak.set(s.get("peak_bytes_in_use",
                                   s.get("bytes_in_use", 0)))
            self._g_limit.set(s.get("bytes_limit", 0))
        return s

    def collect(self) -> Dict[str, Any]:
        """One full ledger reading: per-component bytes, live stats, the
        unattributed residual, and the phase watermarks (JSON-safe)."""
        with self._lock:
            comps = list(self._components.values())
        out: Dict[str, Any] = {"ts": time.time(), "components": {}}
        dev_sum = host_sum = 0
        for c in comps:
            try:
                tree = c.provider()
            except Exception:
                tree = None
            d, h = tree_bytes(tree)
            out["components"][c.name] = {
                "device": d, "host": h,
                "informational": c.informational}
            if not c.informational:
                dev_sum += d
                host_sum += h
        stats = self.memory_stats()
        in_use = int(stats.get("bytes_in_use", 0))
        out["attributed_device_bytes"] = dev_sum
        out["attributed_host_bytes"] = host_sum
        out["stats"] = stats
        out["bytes_in_use"] = in_use
        out["unattributed_bytes"] = in_use - dev_sum
        out["watermarks"] = dict(self._watermarks)
        return out

    snapshot = collect  # the flight recorder's name for the same reading

    def publish(self) -> Dict[str, Any]:
        """Collect and push everything to the gauges; returns the reading."""
        report = self.collect()
        for name, row in report["components"].items():
            self._g_component.set(row["device"], component=name,
                                  space="device")
            self._g_component.set(row["host"], component=name, space="host")
        self.publish_stats(report["stats"])
        self._g_unattributed.set(report["unattributed_bytes"])
        for phase, peak in report["watermarks"].items():
            self._g_phase_peak.set(peak, phase=phase)
        return report

    # ------------------------------------------------------------ watermarks
    def install_phase_watch(self) -> None:
        """Hook the span enters/exits (``spans.set_phase_listener``) so
        watched phases sample the accelerator at their boundaries."""
        from .spans import set_phase_listener

        set_phase_listener(self._on_phase)
        self._watching = True

    def uninstall_phase_watch(self) -> None:
        from .spans import get_phase_listener, set_phase_listener

        # == not `is`: each `self._on_phase` access builds a fresh bound
        # method; equality compares (instance, function)
        if get_phase_listener() == self._on_phase:
            set_phase_listener(None)
        self._watching = False

    def _on_phase(self, name: str, edge: str) -> None:
        """Span-listener callback: ``edge`` is enter/exit/point."""
        if name not in self.watch_phases:
            return
        try:
            stats = self.memory_counters()
        except Exception:
            return
        in_use = int(stats.get("bytes_in_use", 0))
        peak = int(stats.get("peak_bytes_in_use", in_use))
        hi = in_use
        if edge == "enter":
            self._phase_enter[name] = (in_use, peak)
            return
        if edge == "exit":
            ent = self._phase_enter.pop(name, None)
            if ent is not None:
                e_use, e_peak = ent
                hi = max(hi, e_use)
                if peak > e_peak:
                    # the process peak moved while this phase was open:
                    # the new high-water mark happened inside it
                    hi = max(hi, peak)
            self._exit_log.append((name, peak))
        if hi > self._watermarks.get(name, 0):
            self._watermarks[name] = hi

    def watermarks(self) -> Dict[str, int]:
        return dict(self._watermarks)

    def phase_exit_log(self) -> List[Tuple[str, int]]:
        """Recent ``(phase, process_peak_at_exit)`` samples, oldest
        first — monotone in the second field."""
        return list(self._exit_log)

    def reset_watermarks(self) -> None:
        self._watermarks.clear()
        self._phase_enter.clear()
        self._exit_log.clear()


# --------------------------------------------------------------------------
# process default
# --------------------------------------------------------------------------
_default_ledger: Optional[MemoryLedger] = None
_default_lock = threading.Lock()


def get_memory_ledger(registry: Optional[MetricsRegistry] = None
                      ) -> MemoryLedger:
    """The process-local default ledger (created on first use, like the
    default registry) — engines attach to it, flight dumps read it.
    ``registry`` binds the gauges at CREATION time only."""
    global _default_ledger
    if _default_ledger is None:
        with _default_lock:
            if _default_ledger is None:
                _default_ledger = MemoryLedger(registry=registry)
    return _default_ledger


def set_memory_ledger(ledger: Optional[MemoryLedger]) -> None:
    """Swap the process default (tests install a fresh one)."""
    global _default_ledger
    with _default_lock:
        _default_ledger = ledger


# --------------------------------------------------------------------------
# OOM forensics
# --------------------------------------------------------------------------
def oom_hints(context: Dict[str, Any], report: Dict[str, Any]) -> List[str]:
    """Actionable next steps for a memory incident, derived from the
    engine-registered context and the ledger reading (the JAX package's
    rules)."""
    hints: List[str] = []
    comps = report.get("components", {})

    def _bytes(name):
        row = comps.get(name, {})
        return row.get("device", 0) + row.get("host", 0)

    stage = context.get("zero_stage")
    if stage is not None and stage < 3:
        hints.append(
            f"raise zero_optimization.stage (currently {stage}): stage 2 "
            "shards gradients, stage 3 shards parameters across data ranks")
    if context.get("offload_optimizer") is False:
        hints.append(
            "enable zero_optimization.offload_optimizer.device='cpu' to move "
            "the fp32 master and Adam moments to host RAM "
            f"(~{_bytes('optimizer_state') + _bytes('master_params')} bytes "
            "would leave HBM)")
    if context.get("compute_dtype") == "float32":
        hints.append("train in bf16 (bf16.enabled) to halve parameter, "
                     "gradient, and activation bytes")
    if context.get("gas") is not None:  # presence marks a training context
        hints.append(
            "shrink train_micro_batch_size_per_gpu and raise "
            "gradient_accumulation_steps: activations and transient "
            "program buffers scale with the micro batch")
    if _bytes("kv_pool") > 0:
        hint = ("shrink the KV page pool (num_pages / page_size / "
                "max_seqs)")
        if not context.get("kv_quant", False):
            hint += " or enable kv_quant (int8 pages halve the pool HBM)"
        hints.append(hint)
    pinned = comps.get("kv_prefix_pinned", {}).get("device", 0)
    if pinned > 0:
        hints.append(
            f"cap prefix_cache_pages: {pinned} bytes of KV pages are "
            "pinned by the prefix cache for reuse")
    in_use = report.get("bytes_in_use", 0)
    unattr = report.get("unattributed_bytes", 0)
    if in_use > 0 and unattr > 0.25 * in_use:
        hints.append(
            f"{unattr} bytes ({100.0 * unattr / in_use:.0f}% of occupancy) "
            "are unattributed transients: reduce the micro batch or enable "
            "activation checkpointing (activation_checkpointing.policy)")
    if not hints:
        hints.append("reduce batch size / model size, or add devices: no "
                     "config headroom detected from the registered context")
    return hints


def record_oom_incident(where: str, exc: BaseException,
                        flight: Any = None) -> Optional[str]:
    """Dump a memory incident report through the flight recorder.

    Called from ``flight.dump_on_exception`` when the exception rates as
    a memory exhaustion.  Uses the installed recorder, or a fresh one
    (default dump directory) when none is installed.  Never raises (the
    original exception must propagate); returns the dump path or None."""
    try:
        ledger = get_memory_ledger()
        report = ledger.collect()
        hints = oom_hints(ledger.context, report)
        incident: Dict[str, Any] = {
            "kind": "oom_incident",
            "ts": time.time(),
            "where": where,
            "error": f"{type(exc).__name__}: {exc}"[:2000],
            "hints": hints,
            "memory_stats": report["stats"],
            "ledger": {k: report[k] for k in
                       ("components", "attributed_device_bytes",
                        "attributed_host_bytes", "unattributed_bytes",
                        "watermarks")},
            "context": dict(ledger.context),
            "top_buffers": top_live_buffers(ledger.top_buffers),
        }
        from .flight import FlightRecorder, get_flight_recorder

        fr = flight or get_flight_recorder()
        if fr is None:
            fr = FlightRecorder(registry=ledger.registry)
        fr.note("oom", where=where,
                bytes_in_use=report["bytes_in_use"],
                unattributed_bytes=report["unattributed_bytes"])
        path = fr.dump(reason=f"oom:{where}", extra_records=[incident])
        # AFTER the dump: the counter claims a CAPTURED incident
        ledger._c_oom.inc(where=where)
        logger.error(
            f"OOM forensics [{where}]: {report['bytes_in_use']} bytes in "
            f"use, {report['attributed_device_bytes']} attributed -> {path}"
            f"\n  hints: " + "; ".join(hints))
        return path
    except Exception as e:  # pragma: no cover - forensics must not mask OOM
        logger.error(f"OOM forensics failed for {where}: {e}")
        return None
