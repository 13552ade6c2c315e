"""Process-local span tracing (the port's copy of
``deepspeed_tpu/telemetry/spans.py``; only the profiler annotation is
PyTorch's).

Where the registry (``registry.py``) answers *how much* and
``torch.profiler`` (``tracing.py``) answers *where on the device*, spans answer
*when on the host*: every request, step, phase, and compile event
records a begin/end pair into a bounded ring, reconstructable after the
fact as a Chrome-trace-format JSON (``trace_dump()``) loadable in
Perfetto or ``chrome://tracing``.

Three entry points:

* ``span(name, **attrs)`` — context manager for a host-side phase.  It
  also enters a ``torch.profiler.record_function`` range (via
  ``tracing.py``), so the same name shows in a profiler capture.
* ``begin_span`` / ``end_span`` — explicit handles for ranges that
  cross steps (a serving request lives across many ``engine.step()``
  calls; no context manager can span them).
* ``record_event(name, **attrs)`` — a zero-duration point event
  (collective traced, request admitted, recompile detected).

Everything lands in one process-default :class:`SpanRecorder` (swap it
with ``set_span_recorder`` in tests).  Recording is a lock + deque
append of host timestamps — no device syncs, no allocation beyond the
ring — so it is safe on hot paths and ON by default; the ``telemetry``
config block's ``spans`` sub-block can turn it off or resize the ring.

Span names are ``snake_case`` WITHOUT the ``deepspeed_tpu_`` metric
namespace (the JAX package's ``tools/check_metric_names.py`` lints both
rules statically).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

SPAN_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

#: optional phase listener: ``fn(name, edge)`` with edge one of
#: "enter"/"exit" (spans, PhaseTimer) or "point" (events).  Installed by
#: the memory ledger to sample per-phase occupancy watermarks at span
#: boundaries; None (the default) costs one attribute check per span.
_phase_listener = None


def set_phase_listener(fn) -> None:
    global _phase_listener
    _phase_listener = fn


def get_phase_listener():
    return _phase_listener


def _notify_phase(name: str, edge: str) -> None:
    fn = _phase_listener
    if fn is None:
        return
    try:
        fn(name, edge)
    # dstpu-lint: allow[swallow] a broken phase listener must never break
    # the traced code
    except Exception:
        pass

#: one monotonic origin per process: every span timestamp is
#: microseconds since import, so events from all threads share a
#: timeline and the Chrome trace starts near 0
_TRACE_ORIGIN = time.perf_counter()


def _now_us() -> float:
    return (time.perf_counter() - _TRACE_ORIGIN) * 1e6


def perf_to_us(t: float) -> float:
    """Map a ``perf_counter`` stamp onto the span timeline (µs since the
    process trace origin) — the reqtrace fleet merge uses this so ledger
    phase slices and ring events share one clock."""
    return (t - _TRACE_ORIGIN) * 1e6


_thread_ids = threading.local()


def _tid() -> int:
    """This thread's native id, read once per thread: ``get_native_id`` is
    a system call, which some sandboxes make cost ~0.2 ms."""
    tid = getattr(_thread_ids, "tid", None)
    if tid is None:
        tid = _thread_ids.tid = threading.get_native_id()
    return tid


class Span:
    """One completed (or instant) range on the host timeline."""

    __slots__ = ("name", "ts_us", "dur_us", "tid", "cat", "attrs")

    def __init__(self, name: str, ts_us: float, dur_us: float, tid: int,
                 cat: str = "", attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.ts_us = ts_us
        self.dur_us = dur_us
        self.tid = tid
        self.cat = cat
        self.attrs = attrs or {}

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "ts": self.ts_us, "dur": self.dur_us,
                "tid": self.tid, "cat": self.cat, "args": dict(self.attrs)}


class _Handle:
    """Open span returned by ``begin()``; finish with ``end()``."""

    __slots__ = ("name", "cat", "attrs", "t0_us", "tid", "_ann")

    def __init__(self, name: str, cat: str, attrs: Dict[str, Any]):
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.t0_us = _now_us()
        self.tid = _tid()
        self._ann = None


class SpanRecorder:
    """Bounded ring of recent spans (process-local, thread-safe)."""

    def __init__(self, ring_size: int = 4096, enabled: bool = True,
                 profiler_annotations: bool = True):
        self.enabled = enabled
        self.profiler_annotations = profiler_annotations
        self._ring: deque = deque(maxlen=max(16, int(ring_size)))
        self._lock = threading.Lock()
        self.dropped = 0  # spans that pushed another out of the ring

    def configure(self, enabled: Optional[bool] = None,
                  ring_size: Optional[int] = None,
                  profiler_annotations: Optional[bool] = None) -> None:
        if enabled is not None:
            self.enabled = bool(enabled)
        if profiler_annotations is not None:
            self.profiler_annotations = bool(profiler_annotations)
        if ring_size is not None and ring_size != self._ring.maxlen:
            with self._lock:
                self._ring = deque(self._ring, maxlen=max(16, int(ring_size)))

    # ------------------------------------------------------------ recording
    def record(self, name: str, ts_us: float, dur_us: float,
               cat: str = "", tid: Optional[int] = None, **attrs) -> None:
        """Append one completed span (timestamps in ring microseconds)."""
        if not self.enabled:
            return
        sp = Span(name, ts_us, dur_us, tid if tid is not None else _tid(),
                  cat, attrs)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(sp)

    def event(self, name: str, cat: str = "", **attrs) -> None:
        """Zero-duration point event (rendered as a sliver in Perfetto)."""
        _notify_phase(name, "point")
        self.record(name, _now_us(), 0.0, cat=cat, **attrs)

    def begin(self, name: str, cat: str = "", **attrs) -> Optional[_Handle]:
        """Open a cross-step span; pair with ``end()``.  The profiler
        annotation is NOT entered here — an open handle may be closed on
        a different step (or thread), which a profiler range forbids."""
        if not self.enabled:
            return None
        return _Handle(name, cat, dict(attrs))

    def end(self, handle: Optional[_Handle], **attrs) -> None:
        if handle is None:
            return
        handle.attrs.update(attrs)
        self.record(handle.name, handle.t0_us, _now_us() - handle.t0_us,
                    cat=handle.cat, tid=handle.tid, **handle.attrs)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", **attrs):
        """Record the enclosed block; nests a profiler annotation so the
        same range is attributable in a ``torch.profiler`` capture."""
        if not self.enabled:
            # the phase watch (memory watermarks) is orthogonal to span
            # RECORDING: notify it even with the ring off, as event() and
            # PhaseTimer already do
            _notify_phase(name, "enter")
            try:
                yield
            finally:
                _notify_phase(name, "exit")
            return
        ann = None
        if self.profiler_annotations:
            from .tracing import annotate

            ann = annotate(name)
            ann.__enter__()
        _notify_phase(name, "enter")
        t0 = _now_us()
        try:
            yield
        finally:
            dur = _now_us() - t0
            if ann is not None:
                ann.__exit__(None, None, None)
            _notify_phase(name, "exit")
            self.record(name, t0, dur, cat=cat, **attrs)

    # ------------------------------------------------------------ export
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def trace_events(self) -> List[Dict[str, Any]]:
        """Chrome-trace ``traceEvents``: complete ("X") events carrying
        the Perfetto-required keys ``ph/ts/dur/pid/tid/name``."""
        pid = os.getpid()
        out = []
        for sp in self.spans():
            out.append({"name": sp.name, "cat": sp.cat or "span", "ph": "X",
                        "ts": sp.ts_us, "dur": sp.dur_us, "pid": pid,
                        "tid": sp.tid, "args": dict(sp.attrs)})
        return out


# --------------------------------------------------------------------------
# process default
# --------------------------------------------------------------------------
_default_recorder: Optional[SpanRecorder] = None
_default_lock = threading.Lock()


def get_span_recorder() -> SpanRecorder:
    """The process-local default recorder (created enabled on first use)."""
    global _default_recorder
    if _default_recorder is None:
        with _default_lock:
            if _default_recorder is None:
                _default_recorder = SpanRecorder()
    return _default_recorder


def set_span_recorder(recorder: Optional[SpanRecorder]) -> None:
    """Swap the process default (tests install a fresh one)."""
    global _default_recorder
    with _default_lock:
        _default_recorder = recorder


def configure_spans(enabled: Optional[bool] = None,
                    ring_size: Optional[int] = None,
                    profiler_annotations: Optional[bool] = None) -> SpanRecorder:
    """Apply the ``telemetry.spans`` config block to the default recorder."""
    rec = get_span_recorder()
    rec.configure(enabled=enabled, ring_size=ring_size,
                  profiler_annotations=profiler_annotations)
    return rec


def span(name: str, cat: str = "", **attrs):
    """``with span("forward"): ...`` on the default recorder."""
    return get_span_recorder().span(name, cat=cat, **attrs)


def begin_span(name: str, cat: str = "", **attrs) -> Optional[_Handle]:
    return get_span_recorder().begin(name, cat=cat, **attrs)


def end_span(handle: Optional[_Handle], **attrs) -> None:
    get_span_recorder().end(handle, **attrs)


def record_event(name: str, cat: str = "", **attrs) -> None:
    get_span_recorder().event(name, cat=cat, **attrs)


def trace_dump(path: Optional[str] = None,
               recorder: Optional[SpanRecorder] = None):
    """Render the ring as a Chrome-trace JSON document.

    With ``path``: write the file (creating directories) and return the
    path.  Without: return the document dict.  Loadable in Perfetto
    (ui.perfetto.dev) and ``chrome://tracing``; attr values that are not
    JSON-native are stringified rather than dropped."""
    rec = recorder or get_span_recorder()
    doc = {"displayTimeUnit": "ms", "traceEvents": rec.trace_events()}
    if path is None:
        return doc
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
    return path
