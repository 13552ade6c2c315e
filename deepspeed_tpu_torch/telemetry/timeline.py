"""Measured step-time attribution (the port's counterpart of
``deepspeed_tpu/telemetry/timeline.py``).

Periodically (the serving engine's ``timeline_every_n_steps``; only the
captured step pays) captures a ``torch.profiler`` trace of ONE step,
parses the device events (``cat`` ``kernel``, ``gpu_memcpy``,
``gpu_memset``; kernels replayed by a CUDA graph included) into
categories, and publishes a **measured** per-step decomposition:

* ``deepspeed_tpu_timeline_category_seconds{category}`` — where the
  step's wall went: ``gemm`` / ``attention`` compute, each collective
  kind, ``copy`` (copies, memsets), ``other_compute``, ``host_gap``
  (wall − device busy), and ``pipe_bubble``. Every instant is attributed
  to exactly ONE category (:func:`decompose_events`, unchanged from the
  JAX package), so the categories sum to the step wall.
* the record's ``kernels``: launches and device seconds per kernel name,
  with the category each was filed under.
* a per-capture Chrome-trace artifact merging the host span ring and
  the device events into ONE Perfetto file.

The step's wall window is a ``record_function`` range
(:data:`TIMELINE_RANGE`) read from the same trace, on the same clock as
the kernels, not a host timer.  On the CPU the profiler has no device
events: the capture falls back to the span-derived host timeline and
stamps ``measured: false``.  On CUDA a capture that yields no kernel
event raises :class:`DeviceTraceMissing` instead of falling back.  While
another ``torch.profiler`` session runs, a due step goes uncaptured.  Any
other failure of the capture's own machinery (parse, artifact write,
metric publish) is isolated from the step, and a flight dump taken
mid-capture sees the last *completed* record.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..accelerator import default_device

#: compute categories shadow collectives in the sweep: a collective
#: running under compute is *overlapped* (hidden) and the instant
#: belongs to the compute hiding it
COMPUTE_CATEGORIES = ("attention", "gemm", "copy", "other_compute")
COLLECTIVE_CATEGORIES = ("all_reduce", "all_gather", "reduce_scatter",
                         "all_to_all", "collective_permute")
CATEGORY_PRIORITY = COMPUTE_CATEGORIES + COLLECTIVE_CATEGORIES
#: every category a record (measured or fallback) may carry
ALL_CATEGORIES = CATEGORY_PRIORITY + ("host_compute", "host_gap",
                                      "pipe_bubble")

#: the JAX package's patterns (XLA op names), then the card's: the port's
#: own kernels (``csrc/*.cu``), cuBLAS / CUTLASS GEMMs, NCCL, memsets
_ATTENTION_PAT = ("attention", "flash", "splash", "paged_attn", "mha",
                  "softmax",
                  "paged_decode", "paged_merge", "sparse_attn", "evo_", "fmha",
                  "reduce_chunks", "reduce_kranges", "reduce_ranges")
_GEMM_PAT = ("dot", "gemm", "matmul", "einsum", "conv",
             "gmm_", "wq_", "nvjet", "xmma", "cutlass", "cublas", "gemv")
_COPY_PAT = ("copy", "transpose", "bitcast", "memcpy", "d2d", "h2d", "d2h",
             "memset")
_COLLECTIVE_PAT = (("all-reduce", "all_reduce"), ("all_reduce", "all_reduce"),
                   ("allreduce", "all_reduce"),
                   ("all-gather", "all_gather"), ("all_gather", "all_gather"),
                   ("allgather", "all_gather"),
                   ("reduce-scatter", "reduce_scatter"),
                   ("reduce_scatter", "reduce_scatter"),
                   ("reducescatter", "reduce_scatter"),
                   ("all-to-all", "all_to_all"), ("all_to_all", "all_to_all"),
                   ("alltoall", "all_to_all"),
                   ("collective-permute", "collective_permute"),
                   ("collective_permute", "collective_permute"),
                   ("ppermute", "collective_permute"),
                   ("sendrecv", "collective_permute"))

#: the ``record_function`` range that marks a captured step's window
TIMELINE_RANGE = "dstpu_timeline_step"
#: the Chrome-trace categories of device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTraceMissing(RuntimeError):
    """A capture on CUDA recorded no device event (or no step window)."""


def categorize_op(name: str) -> str:
    """Map one device event name (an XLA op, or a CUDA kernel's) to a
    category.

    Unknown ops land in ``other_compute`` — never dropped: an op the
    taxonomy doesn't know still spent real device time.
    """
    n = str(name).lower()
    # collectives first: a fusion name can embed "dot" AND "all-reduce",
    # and the collective is the scarcer signal
    for pat, cat in _COLLECTIVE_PAT:
        if pat in n:
            return cat
    if any(p in n for p in _ATTENTION_PAT):
        return "attention"
    if any(p in n for p in _GEMM_PAT):
        return "gemm"
    if any(p in n for p in _COPY_PAT):
        return "copy"
    return "other_compute"


def decompose_events(events: Sequence[Dict[str, Any]], wall_s: float,
                     pipe_bubble_fraction: float = 0.0) -> Dict[str, Any]:
    """Attribute a step's wall clock over device trace events.

    ``events``: ``{"name", "ts", "dur"}`` dicts in SECONDS (any common
    epoch). Interval sweep, each instant attributed to exactly one
    category (:data:`CATEGORY_PRIORITY` order — compute shadows
    collectives), so ``sum(categories) == wall_s`` by construction
    (``host_gap`` is the uncovered remainder; if device busy exceeds the
    host wall — clock skew — everything is scaled down by ``scale``).
    """
    wall_s = max(0.0, float(wall_s))
    points: List[Tuple[float, int, str]] = []
    raw_busy: Dict[str, float] = {}
    for ev in events:
        dur = float(ev.get("dur", 0.0) or 0.0)
        if dur <= 0:
            continue
        ts = float(ev.get("ts", 0.0) or 0.0)
        cat = categorize_op(ev.get("name", ""))
        raw_busy[cat] = raw_busy.get(cat, 0.0) + dur
        points.append((ts, +1, cat))
        points.append((ts + dur, -1, cat))
    categories = {c: 0.0 for c in CATEGORY_PRIORITY}
    busy_union = coll_union = exposed_coll = 0.0
    if points:
        points.sort(key=lambda p: (p[0], -p[1]))
        active = {c: 0 for c in CATEGORY_PRIORITY}
        n_compute = n_coll = 0
        prev = points[0][0]
        for t, delta, cat in points:
            seg = t - prev
            if seg > 0 and (n_compute or n_coll):
                busy_union += seg
                for c in CATEGORY_PRIORITY:
                    if active[c]:
                        categories[c] += seg
                        break
                if n_coll:
                    coll_union += seg
                    if not n_compute:
                        exposed_coll += seg
            prev = t
            active[cat] += delta
            if cat in COMPUTE_CATEGORIES:
                n_compute += delta
            else:
                n_coll += delta
    scale = 1.0
    if busy_union > wall_s > 0:
        scale = wall_s / busy_union
        categories = {c: v * scale for c, v in categories.items()}
        busy_union, coll_union, exposed_coll = (
            busy_union * scale, coll_union * scale, exposed_coll * scale)
    host_gap = max(0.0, wall_s - busy_union)
    bubble = 0.0
    if pipe_bubble_fraction > 0:
        # the measured gap, split by the structural (P-1)/(M+P-1) claim:
        # a pipe bubble IS device idleness, so it can only come out of
        # the measured gap — never exceed it
        bubble = min(host_gap, pipe_bubble_fraction * wall_s)
        host_gap -= bubble
    categories["pipe_bubble"] = bubble
    categories["host_gap"] = host_gap
    return {
        "categories": categories,
        "collective_busy_seconds": {k: v * scale for k, v in raw_busy.items()
                                    if k in COLLECTIVE_CATEGORIES},
        "exposed_collective_seconds": exposed_coll,
        "overlapped_collective_seconds": max(0.0, coll_union - exposed_coll),
        "device_busy_seconds": busy_union,
        "scale": scale,
    }


# ------------------------------------------------------- torch.profiler parse
def _device_trace_events(log_dir: str) -> Tuple[List[Dict[str, Any]],
                                                List[Dict[str, Any]],
                                                Optional[Tuple[float, float]]]:
    """Parse the newest Chrome trace ``torch.profiler`` wrote under
    ``log_dir``: the device events (name, ts, dur in seconds on the
    profiler's clock), the raw device events and their process/thread
    names for the merged artifact, and the :data:`TIMELINE_RANGE` window
    ``(start, duration)`` in seconds (None when absent)."""
    paths = sorted(glob.glob(os.path.join(log_dir, "**", "*.json"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        return [], [], None
    with open(paths[-1]) as f:
        chrome = json.load(f).get("traceEvents", []) or []
    events, artifact, window, pids = [], [], None, set()
    for ev in chrome:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        if cat in _DEVICE_CATS and ev.get("dur"):
            artifact.append(ev)
            pids.add(ev.get("pid"))
            events.append({"name": ev.get("name", ""),
                           "ts": float(ev["ts"]) / 1e6,
                           "dur": float(ev["dur"]) / 1e6})
        elif cat == "user_annotation" and ev.get("name") == TIMELINE_RANGE:
            window = (float(ev["ts"]) / 1e6, float(ev.get("dur", 0.0)) / 1e6)
    artifact.extend(ev for ev in chrome
                    if ev.get("ph") == "M" and ev.get("pid") in pids)
    return events, artifact, window


def _clip(events: List[Dict[str, Any]], t0: float, t1: float) -> List[Dict[str, Any]]:
    """The parts of ``events`` inside ``[t0, t1]``."""
    out = []
    for ev in events:
        a, b = max(ev["ts"], t0), min(ev["ts"] + ev["dur"], t1)
        if b > a:
            out.append({"name": ev["name"], "ts": a, "dur": b - a})
    return out


def kernel_table(events: Sequence[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Launches and device seconds per event name, with its category."""
    table: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        row = table.setdefault(ev["name"], {"category": categorize_op(ev["name"]),
                                            "launches": 0, "seconds": 0.0})
        row["launches"] += 1
        row["seconds"] += float(ev["dur"])
    return table


# ----------------------------------------------------- last-record slot
_last_lock = threading.Lock()
_last_record: Optional[Dict[str, Any]] = None


def last_timeline_record() -> Optional[Dict[str, Any]]:
    """The last COMPLETED capture record, process-wide (flight-dump
    hook; an in-progress capture is never visible here)."""
    with _last_lock:
        return dict(_last_record) if _last_record is not None else None


def _set_last_record(rec: Dict[str, Any]) -> None:
    global _last_record
    with _last_lock:
        _last_record = rec


class StepTimeline:
    """Cadence-gated profiler capture of single steps.

    The serving engine builds one directly.  All
    ``deepspeed_tpu_timeline_*`` metrics are single-owner HERE.
    ``device``: the device whose steps are captured (None: CUDA when a
    card is present, else the CPU).
    """

    def __init__(self, every_n_steps: int = 0, artifact_dir: str = "",
                 registry=None, device: Any = None):
        if registry is None:
            from .registry import get_registry

            registry = get_registry()
        self.every_n_steps = max(0, int(every_n_steps))
        self.artifact_dir = artifact_dir
        self.device = torch.device(device) if device is not None else default_device()
        self._force = False
        self._active = False
        self._my_last: Optional[Dict[str, Any]] = None
        self._m_cat = registry.gauge(
            "deepspeed_tpu_timeline_category_seconds",
            "measured step-time decomposition from the last profiler "
            "capture: seconds of the step wall attributed to each "
            "category (categories sum to the step wall)",
            labelnames=("category",))
        self._m_exposed = registry.gauge(
            "deepspeed_tpu_timeline_exposed_collective_seconds",
            "MEASURED collective seconds not overlapped by compute in "
            "the last captured step (counterpart to the structural "
            "deepspeed_tpu_train_overlapped_fraction model)")
        self._m_overlapped = registry.gauge(
            "deepspeed_tpu_timeline_overlapped_collective_seconds",
            "MEASURED collective seconds hidden under compute in the "
            "last captured step")
        self._m_measured = registry.gauge(
            "deepspeed_tpu_timeline_measured",
            "1 when the last capture parsed a device trace, 0 when it "
            "fell back to the span-derived host timeline (CPU/interpreter)")
        self._m_captures = registry.counter(
            "deepspeed_tpu_timeline_captures_total",
            "timeline captures taken, by whether a device trace was "
            "parsed (measured=true) or the host fallback ran",
            labelnames=("measured",))
        self._m_overhead = registry.counter(
            "deepspeed_tpu_timeline_capture_overhead_seconds_total",
            "cumulative seconds spent starting/stopping/parsing profiler "
            "captures (the bounded-overhead contract, made observable)")

    # ------------------------------------------------------------ cadence
    def should_capture(self, step: int) -> bool:
        if self._active:
            return False
        if self._force:
            return True
        return self.every_n_steps > 0 and step % self.every_n_steps == 0

    def force_next(self) -> None:
        """Arm a one-shot capture regardless of cadence."""
        self._force = True

    def last_record(self) -> Optional[Dict[str, Any]]:
        """This timeline's own last completed record (None before the
        first capture; see :func:`last_timeline_record` for the
        process-wide slot the flight recorder reads)."""
        return dict(self._my_last) if self._my_last is not None else None

    # ------------------------------------------------------------ capture
    @contextlib.contextmanager
    def capture(self, step: int, pipe_struct: Optional[Dict[str, Any]] = None,
                sync: Optional[Callable[[], None]] = None):
        """Wrap ONE step. The profiler is always stopped, an exception
        inside the step propagates unchanged (no half-step record is
        published), and no lock is held while user code runs.  ``sync``
        (default on CUDA: ``torch.cuda.synchronize``) runs inside the
        step's window, so the window holds its device work."""
        if self._active:
            yield
            return
        from .spans import _now_us
        from .tracing import annotate, start_trace, stop_trace

        overhead_t0 = time.perf_counter()
        tmpdir = tempfile.mkdtemp(prefix="dstpu_timeline_")
        if not start_trace(tmpdir, device=self.device):
            # another profiler owns the process: this step goes uncaptured
            # (a forced capture stays armed for the next step)
            shutil.rmtree(tmpdir, ignore_errors=True)
            yield
            return
        self._active = True
        self._force = False
        if sync is None and self.device.type == "cuda":
            def sync():
                torch.cuda.synchronize(self.device)
        try:
            t0 = time.perf_counter()
            t0_us = _now_us()
            ok = False
            ann = annotate(TIMELINE_RANGE)
            ann.__enter__()
            try:
                yield
                ok = True
            finally:
                try:
                    if sync is not None:
                        sync()
                finally:
                    ann.__exit__(None, None, None)
                    wall = time.perf_counter() - t0
                    t1_us = _now_us()
                    stop_trace()
            if ok:
                try:
                    self._finish(step, wall, t0_us, t1_us, tmpdir, pipe_struct,
                                 overhead_t0)
                except DeviceTraceMissing:
                    raise
                # dstpu-lint: allow[swallow] attribution must never fail
                # the step it measures; a failed parse leaves the prior record
                except Exception:
                    pass
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
            self._active = False

    def _finish(self, step: int, wall: float, t0_us: float, t1_us: float,
                trace_dir: Optional[str], pipe_struct,
                overhead_t0: float) -> None:
        bubble = 0.0
        if pipe_struct:
            bubble = float(pipe_struct.get("bubble_fraction", 0.0) or 0.0)
        events: List[Dict[str, Any]] = []
        artifact_events: List[Dict[str, Any]] = []
        window = None
        if trace_dir is not None:
            events, artifact_events, window = _device_trace_events(trace_dir)
        if window is not None and events:
            # the step's wall on the kernels' clock; device work outside
            # it (none after the in-window sync) is not this step's
            events = _clip(events, window[0], window[0] + window[1])
        measured = bool(events) and window is not None
        if self.device.type == "cuda" and not measured:
            raise DeviceTraceMissing(
                f"timeline capture of step {step} on {self.device}: the profiler "
                f"recorded {len(events)} device events and "
                f"{'a' if window else 'no'} {TIMELINE_RANGE} window")
        if measured:
            wall = window[1]
            dec = decompose_events(events, wall, pipe_bubble_fraction=bubble)
            record = {"step": step, "measured": True, "wall_seconds": wall,
                      **dec, "kernels": kernel_table(events)}
        else:
            record = {"step": step, "measured": False, "wall_seconds": wall,
                      "categories": self._host_fallback(wall, t0_us, t1_us),
                      "exposed_collective_seconds": None,
                      "overlapped_collective_seconds": None}
        record["ts"] = time.time()
        record["artifact"] = self._write_artifact(
            step, t0_us, t1_us, artifact_events,
            window[0] * 1e6 if window is not None else None)
        # publish: zero every known category first so a fallback capture
        # doesn't leave stale measured numbers standing next to it
        for c in ALL_CATEGORIES:
            self._m_cat.set(0.0, category=c)
        for c, v in record["categories"].items():
            self._m_cat.set(v, category=c)
        self._m_measured.set(1.0 if measured else 0.0)
        if measured:
            self._m_exposed.set(record["exposed_collective_seconds"])
            self._m_overlapped.set(record["overlapped_collective_seconds"])
        self._m_captures.inc(measured="true" if measured else "false")
        overhead = max(0.0, (time.perf_counter() - overhead_t0) - wall)
        record["capture_overhead_seconds"] = overhead
        self._m_overhead.inc(overhead)
        self._my_last = record
        _set_last_record(record)

    def _host_fallback(self, wall: float, t0_us: float,
                       t1_us: float) -> Dict[str, float]:
        """Span-derived host timeline: union of span coverage inside the
        captured window vs the uncovered gap. Sums to wall exactly."""
        from .spans import get_span_recorder

        ivals = []
        for sp in get_span_recorder().spans():
            a = max(float(sp.ts_us), t0_us)
            b = min(float(sp.ts_us) + float(sp.dur_us), t1_us)
            if b > a:
                ivals.append((a, b))
        ivals.sort()
        covered = 0.0
        cur_a = cur_b = None
        for a, b in ivals:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    covered += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            covered += cur_b - cur_a
        covered = min(wall, covered / 1e6)
        return {"host_compute": covered, "host_gap": max(0.0, wall - covered)}

    def _write_artifact(self, step: int, t0_us: float, t1_us: float,
                        device_events: List[Dict[str, Any]],
                        window_us: Optional[float]) -> Optional[str]:
        """ONE Perfetto file per capture: the span ring's host events
        (window-filtered) merged with the device events, re-based so the
        step window starts at the span clock's ``t0_us``."""
        if not self.artifact_dir:
            return None
        try:
            from .spans import get_span_recorder

            margin = 2e5  # 200 ms of pre/post context around the step
            host = [ev for ev in get_span_recorder().trace_events()
                    if t0_us - margin <= float(ev.get("ts", 0)) <= t1_us + margin]
            merged = list(host)
            offset = (t0_us - window_us) if window_us is not None else 0.0
            for ev in device_events:
                ev = dict(ev)
                ev["pid"] = 1000000 + int(ev.get("pid", 0) or 0)
                if "ts" in ev:
                    ev["ts"] = float(ev["ts"]) + offset
                merged.append(ev)
            os.makedirs(self.artifact_dir, exist_ok=True)
            path = os.path.join(self.artifact_dir,
                                f"timeline_step{int(step):08d}.json")
            with open(path, "w") as f:
                json.dump({"displayTimeUnit": "ms", "traceEvents": merged}, f)
            return path
        except (OSError, TypeError, ValueError):
            return None


def capture_thunk(fn: Callable[[], Any], step: int = 0,
                  timeline: Optional[StepTimeline] = None,
                  pipe_struct: Optional[Dict[str, Any]] = None,
                  sync: Optional[Callable[[], None]] = None,
                  artifact_dir: str = "") -> Tuple[Any, Optional[Dict[str, Any]]]:
    """One-shot attribution of an arbitrary callable. Returns
    ``(fn(), record)``; the record is None only if the capture machinery
    itself failed."""
    tl = timeline if timeline is not None else StepTimeline(
        every_n_steps=0, artifact_dir=artifact_dir)
    tl.force_next()
    with tl.capture(step, pipe_struct=pipe_struct, sync=sync):
        out = fn()
    return out, tl.last_record()
