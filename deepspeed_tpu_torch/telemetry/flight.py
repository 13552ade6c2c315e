"""Flight recorder: a black box for crashed or hung runs (the port's
copy of ``deepspeed_tpu/telemetry/flight.py``).

Keeps the last few hundred spans (shared with ``spans.py``'s ring), a
bounded ring of log events (``note()``), and — at dump time — a full
registry snapshot, and writes them all to one timestamped JSONL file.
Dumps fire:

* on demand (``dump()``),
* when an engine step raises (``dump_on_exception`` from the engines'
  ``step()``/``train_batch()`` exception paths), and
* when the stall watchdog trips (``Telemetry`` wires the watchdog's
  ``on_stall`` callback here),

so a wedged collective or a mid-step crash leaves a reconstructable
timeline instead of an empty log.  The recorder itself only ever
appends to host-side rings — no I/O, no device syncs — until a dump is
actually requested.

File schema (one JSON object per line, same spirit as
``exporter.JSONLWriter``):

* ``{"kind": "flight_header", "ts", "reason", "pid", "spans", "events"}``
* ``{"kind": "span", "name", "ts", "dur", "tid", "cat", "args"}`` — one
  per ring span, oldest first; ``ts``/``dur`` in trace microseconds
  (the same clock ``trace_dump()`` uses, so the two artifacts align)
* ``{"kind": "log", "ts", "name", ...}`` — one per ``note()`` event
* ``{"kind": "memory", "ts", "components", "stats", "watermarks", ...}``
  — the memory ledger's reading at dump time (telemetry/memory.py), so
  every incident file answers memory questions too
* ``{"kind": "timeline", ...}`` — the last completed step-time record
* ``{"kind": "goodput", ...}`` — the goodput ledger's summary
* ``{"kind": "reqtrace", ...}`` — the request-trace ledger's summary
* ``{"kind": "numerics", ...}`` — the numerics observatory's last
  boundary report + sentinel window (``numerics.last_numerics_summary``)
* ``{"kind": "snapshot", "ts", "metrics": {...}}`` — the registry at
  dump time (the final record of a plain dump)
* ``{"kind": "oom_incident", ...}`` — appended by OOM forensics
  (``memory.record_oom_incident``): ledger breakdown, top live buffers,
  actionable hints
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from ..utils.logging import logger
from .exporter import snapshot_metrics
from .registry import MetricsRegistry, get_registry
from .spans import SpanRecorder, get_span_recorder

_REASON_SAFE_RE = re.compile(r"[^a-zA-Z0-9_.-]+")


class FlightRecorder:
    """Bounded in-memory black box; ``dump()`` writes the JSONL."""

    def __init__(self, path: str = "", max_events: int = 256,
                 registry: Optional[MetricsRegistry] = None,
                 spans: Optional[SpanRecorder] = None):
        #: directory dumps land in (created lazily at first dump)
        self.dir = path or "./flight_recorder"
        self.registry = registry
        self._spans = spans
        self._events: deque = deque(maxlen=max(16, int(max_events)))
        self._lock = threading.Lock()
        self._dumps = 0
        self._m_dumps = (registry or get_registry()).counter(
            "deepspeed_tpu_flight_dumps_total",
            "flight-recorder dumps written", labelnames=("trigger",))

    def note(self, name: str, **fields) -> None:
        """Append one log event to the ring (cheap; no I/O)."""
        rec = {"ts": time.time(), "name": name}
        rec.update(fields)
        with self._lock:
            self._events.append(rec)

    def dump(self, reason: str = "manual", path: Optional[str] = None,
             extra_records: Optional[list] = None) -> str:
        """Write the black box to ``path`` (default: a timestamped file
        under ``self.dir``) and return the file path.  The trigger kind
        (text before the first ``:`` of ``reason``) labels the dump
        counter.  Every dump also attaches a ``memory`` section (the
        process memory ledger's reading: components, live stats,
        watermarks) so incident files answer memory questions too;
        ``extra_records`` appends caller records (the OOM incident
        report) verbatim."""
        spans = (self._spans or get_span_recorder()).spans()
        with self._lock:
            events = list(self._events)
        if path is None:
            safe = _REASON_SAFE_RE.sub("_", reason)[:48] or "dump"
            stamp = time.strftime("%Y%m%d_%H%M%S")
            path = os.path.join(self.dir,
                                f"flight_{stamp}_{self._dumps}_{safe}.jsonl")
        self._dumps += 1
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            def line(rec: Dict[str, Any]) -> None:
                f.write(json.dumps(rec, default=str) + "\n")

            line({"kind": "flight_header", "ts": time.time(),
                  "reason": reason, "pid": os.getpid(),
                  "spans": len(spans), "events": len(events)})
            for sp in spans:
                line(dict({"kind": "span"}, **sp.to_dict()))
            for ev in events:
                line(dict({"kind": "log"}, **ev))
            try:
                # lazy: memory.py imports this module at top level.
                # Before the snapshot: a plain dump keeps the registry
                # snapshot as its final record (tools rely on that).
                from .memory import get_memory_ledger

                line(dict({"kind": "memory"},
                          **get_memory_ledger().snapshot()))
            # dstpu-lint: allow[swallow] the black box must be written even
            # half-blind: a broken ledger drops one record, not the dump
            except Exception:
                pass
            try:
                # last COMPLETED step-time attribution (never a torn
                # in-progress capture: timeline.py publishes the record
                # only after its capture context has fully closed, so a
                # dump taken mid-capture sees the previous one)
                from .timeline import last_timeline_record

                tl = last_timeline_record()
                if tl is not None:
                    line(dict({"kind": "timeline"}, **tl))
            # dstpu-lint: allow[swallow] same contract as the memory record
            except Exception:
                pass
            try:
                from .goodput import last_goodput_summary

                gp = last_goodput_summary()
                if gp is not None:
                    line(dict({"kind": "goodput"}, **gp))
            # dstpu-lint: allow[swallow] same contract as the memory record
            except Exception:
                pass
            try:
                from .reqtrace import last_reqtrace_summary

                rt = last_reqtrace_summary()
                if rt is not None:
                    line(dict({"kind": "reqtrace"}, **rt))
            # dstpu-lint: allow[swallow] same contract as the memory record
            except Exception:
                pass
            try:
                # numerics observatory: the last boundary's per-layer
                # health report + sentinel window, so any dump (stall,
                # exception, OOM — not just numerics-triggered ones)
                # answers "was training numerically healthy?"
                from .numerics import last_numerics_summary

                nm = last_numerics_summary()
                if nm is not None:
                    line(dict({"kind": "numerics"}, **nm))
            # dstpu-lint: allow[swallow] same contract as the memory record
            except Exception:
                pass
            line({"kind": "snapshot", "ts": time.time(),
                  "metrics": snapshot_metrics(self.registry)})
            for rec in (extra_records or []):
                line(dict(rec))
        self._m_dumps.inc(trigger=reason.split(":", 1)[0])
        logger.warning(f"flight recorder: {len(spans)} spans + "
                       f"{len(events)} events + registry snapshot -> "
                       f"{path} (reason: {reason})")
        return path


# --------------------------------------------------------------------------
# process default — engines and exception hooks reach the recorder here
# --------------------------------------------------------------------------
_flight: Optional[FlightRecorder] = None
_flight_lock = threading.Lock()


def get_flight_recorder() -> Optional[FlightRecorder]:
    """The installed recorder, or None (flight recording off)."""
    return _flight


def install_flight_recorder(recorder: Optional[FlightRecorder]) -> None:
    global _flight
    with _flight_lock:
        _flight = recorder


def dump_on_exception(where: str,
                      exc: Optional[BaseException] = None) -> Optional[str]:
    """Best-effort dump from an exception path: never raises, returns
    the dump path or None when no recorder is installed (engines call
    this unconditionally before re-raising).

    When ``exc`` rates as a device-memory exhaustion
    (``memory.is_resource_exhausted``: ``torch.cuda.OutOfMemoryError``
    among others), the dump is upgraded to a full
    OOM incident report — ledger breakdown, top live buffers, hints —
    and is written even WITHOUT an installed recorder (an ephemeral one
    is created): an OOM is too precious to lose to missing config."""
    fr = _flight
    if exc is not None:
        try:
            from .memory import is_resource_exhausted, record_oom_incident

            if is_resource_exhausted(exc):
                path = record_oom_incident(where, exc, flight=fr)
                if path is not None:
                    return path
                # forensics failed: fall through to the plain dump so an
                # OOM still leaves SOME black box, as every exception did
                # before forensics existed
        except Exception as e:  # forensics must never mask the OOM
            logger.error(f"flight recorder: OOM forensics from {where} "
                         f"failed: {e}")
    if fr is None:
        return None
    try:
        return fr.dump(reason=f"exception:{where}")
    except Exception as e:  # the original exception must still propagate
        logger.error(f"flight recorder: dump from {where} failed: {e}")
        return None
