"""Fleet-wide request tracing (the port's copy of
``deepspeed_tpu/telemetry/reqtrace.py``, pure Python, unchanged: a wire
snapshot is the JAX package's byte for byte).

Three pieces, all keyed on the **router-minted** ``trace_id`` (request
uids are per-engine and collide across replicas; the trace id is the
fleet-unique correlation key):

* :class:`RequestTrace` — one request's lifecycle **phase ledger**: a
  state machine with exactly one open phase at a time (``queue_wait`` /
  ``prefill`` / ``recompute`` / ``kv_transfer`` / ``decode``), each
  interval stamped with the replica that owned it.  Because every
  ``transition()`` closes the current interval at the instant the next
  one opens, the intervals partition ``[submit, finish]`` and their
  durations **sum to end-to-end latency by construction** — the
  request-level analogue of the goodput ledger's buckets-sum-to-lifetime
  identity.  The ledger survives re-dispatch and KV migration (same
  ``trace_id``, new owner), so its ``first_token_s`` is TTFT from FIRST
  submission — the per-(re)enqueue histograms keep their local
  semantics; the ledger owns end-to-end truth.
* :class:`ReqTraceLedger` — the process-wide collection: open traces, a
  bounded ring of finished ones, the ``deepspeed_tpu_serving_reqtrace_*``
  metric family (single-owner: this module is the only registration
  site), and the **SLO exemplar store** — every
  ``deepspeed_tpu_serving_slo_*`` counter increment attaches the
  offending ``trace_id`` via :func:`slo_exemplar` (enforced statically
  by the ``slo-exemplar`` hazard-lint rule).
* :func:`merged_trace_events` / :func:`write_merged_trace` — the fleet
  collector: merges every trace's phase intervals (plus the span ring's
  trace-tagged events) into ONE Perfetto/Chrome-trace artifact — one
  *thread* track per ``trace_id``, one *process* row per owning replica,
  KV transit visible as its own ``kv_transfer`` slice between them.

All ledger arithmetic runs on ``perf_counter`` (the wall clock steps
backwards under NTP; per-hop wall stamps live only in the
``kv_transfer`` wire block where cross-host transit needs them).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

#: the phase taxonomy.  ``queue_wait`` covers router queueing, engine
#: queueing, preemption wait and re-dispatch gaps; ``recompute`` is a
#: prefill re-run after preemption or replica loss (work a failure
#: bought, not first-attempt prefill); ``kv_transfer`` spans export ->
#: import including wire transit.
PHASES = ("queue_wait", "prefill", "recompute", "kv_transfer", "decode")

#: finished traces kept for artifact merge / exemplar resolution
_DONE_RING = 512

#: exemplars kept per SLO metric
_EXEMPLARS_PER_METRIC = 32


class RequestTrace:
    """Single-owner phase ledger for one request's fleet lifetime."""

    __slots__ = ("trace_id", "uid", "priority", "attempts", "preempted",
                 "intervals", "_open", "submit_t", "end_t", "first_token_s",
                 "finish_reason", "transit_s", "owners")

    def __init__(self, trace_id: str, uid: Optional[int] = None,
                 priority: int = 0, now: Optional[float] = None):
        now = time.perf_counter() if now is None else now
        self.trace_id = trace_id
        self.uid = uid
        self.priority = int(priority)
        self.attempts = 0          # completed re-dispatches
        self.preempted = False     # next prefill is recompute
        #: closed intervals: (phase, owner, start, end) on perf_counter
        self.intervals: List[Tuple[str, str, float, float]] = []
        self._open: Optional[Tuple[str, str, float]] = None
        self.submit_t = now
        self.end_t: Optional[float] = None
        self.first_token_s: Optional[float] = None  # from submit_t
        self.finish_reason = ""
        #: wire transit seconds folded into kv_transfer (cross-process)
        self.transit_s = 0.0
        self.owners: List[str] = []
        self._open = ("queue_wait", "router", now)

    # ------------------------------------------------------ state machine
    @property
    def done(self) -> bool:
        return self.end_t is not None

    @property
    def phase(self) -> Optional[str]:
        return self._open[0] if self._open is not None else None

    def _close_open(self, now: float) -> None:
        if self._open is None:
            return
        phase, owner, start = self._open
        self.intervals.append((phase, owner, start, max(start, now)))
        if not self.owners or self.owners[-1] != owner:
            self.owners.append(owner)
        self._open = None

    def transition(self, phase: str, owner: str,
                   now: Optional[float] = None) -> None:
        """Close the open interval and open ``phase`` at the same
        instant — the partition invariant lives here."""
        if phase not in PHASES:
            raise ValueError(f"unknown reqtrace phase {phase!r}")
        if self.done:
            return
        now = time.perf_counter() if now is None else now
        if phase == "prefill" and (self.attempts > 0 or self.preempted):
            phase = "recompute"
        self._close_open(now)
        self._open = (phase, owner, now)

    def note_first_token(self, now: Optional[float] = None) -> None:
        """Set-once end-to-end TTFT (measured from FIRST submission —
        re-dispatch never restarts this clock)."""
        if self.first_token_s is None:
            now = time.perf_counter() if now is None else now
            self.first_token_s = max(0.0, now - self.submit_t)

    def note_preempt(self, owner: str, now: Optional[float] = None) -> None:
        """Preemption: back to queue_wait; the re-run prefill chunks
        will classify as recompute."""
        self.preempted = True
        self.transition("queue_wait", owner, now)

    def note_redispatch(self, now: Optional[float] = None) -> None:
        """Replica loss re-dispatch: the prior attempt's ledger rides
        along (satellite: no clock restart); the replacement prefill
        classifies as recompute."""
        self.attempts += 1
        self.transition("queue_wait", "router", now)

    def finish(self, reason: str, now: Optional[float] = None) -> None:
        if self.done:
            return
        now = time.perf_counter() if now is None else now
        self._close_open(now)
        self.end_t = now
        self.finish_reason = reason

    # ---------------------------------------------------------- read-out
    def elapsed_s(self, now: Optional[float] = None) -> float:
        end = self.end_t
        if end is None:
            end = time.perf_counter() if now is None else now
        return max(0.0, end - self.submit_t)

    def phase_seconds(self) -> Dict[str, float]:
        """Per-phase durations.  For a finished trace these sum to
        :meth:`elapsed_s` exactly (up to float reassociation)."""
        out = {p: 0.0 for p in PHASES}
        for phase, _owner, start, end in self.intervals:
            out[phase] += end - start
        if self._open is not None:
            phase, _owner, start = self._open
            out[phase] += max(0.0, time.perf_counter() - start)
        return out

    def summary(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "uid": self.uid,
            "priority": self.priority,
            "attempts": self.attempts,
            "preempted": self.preempted,
            "done": self.done,
            "finish_reason": self.finish_reason,
            "e2e_s": self.elapsed_s(),
            "ttft_s": self.first_token_s,
            "phases": self.phase_seconds(),
            "owners": list(self.owners) + (
                [self._open[1]] if self._open is not None
                and (not self.owners or self.owners[-1] != self._open[1])
                else []),
        }

    # ------------------------------------------------------------- wire
    def wire_snapshot(self) -> Dict[str, Any]:
        """Clock-free snapshot for the ``kv_transfer`` wire: closed
        intervals as durations (a remote host's ``perf_counter`` origin
        is unrelated; durations are the portable part)."""
        return {
            "trace_id": self.trace_id,
            "uid": self.uid,
            "priority": self.priority,
            "attempts": self.attempts,
            "preempted": self.preempted,
            "phases": [[p, o, round(e - s, 9)]
                       for (p, o, s, e) in self.intervals],
            "open_phase": self.phase,
            "first_token_s": self.first_token_s,
            "elapsed_s": round(self.elapsed_s(), 9),
        }

    @classmethod
    def from_wire_snapshot(cls, snap: Dict[str, Any], transit_s: float = 0.0,
                           now: Optional[float] = None) -> "RequestTrace":
        """Reconstruct a trace on the importing host: re-anchor the
        remote durations onto the local clock so the partition invariant
        (intervals tile ``[submit, now]``) holds here too.  Wire transit
        is folded in as ``kv_transfer`` time — it IS part of the
        request's end-to-end latency."""
        now = time.perf_counter() if now is None else now
        transit_s = max(0.0, float(transit_s))
        elapsed = max(0.0, float(snap.get("elapsed_s", 0.0))) + transit_s
        tr = cls(str(snap["trace_id"]), uid=snap.get("uid"),
                 priority=int(snap.get("priority", 0)), now=now - elapsed)
        tr.attempts = int(snap.get("attempts", 0))
        tr.preempted = bool(snap.get("preempted", False))
        tr.transit_s = transit_s
        t = tr.submit_t
        tr.intervals = []
        for p, o, dur in snap.get("phases", ()):
            d = max(0.0, float(dur))
            tr.intervals.append((str(p), str(o), t, t + d))
            t += d
            if not tr.owners or tr.owners[-1] != o:
                tr.owners.append(str(o))
        # the sender's open phase ran until the bundle left; transit
        # rides as its own kv_transfer stretch up to `now`
        open_phase = snap.get("open_phase")
        if open_phase and t < now - transit_s:
            tr.intervals.append((str(open_phase), "wire", t, now - transit_s))
            t = now - transit_s
        if now > t:
            tr.intervals.append(("kv_transfer", "wire", t, now))
        tr._open = None
        ft = snap.get("first_token_s")
        tr.first_token_s = None if ft is None else float(ft)
        return tr


class ReqTraceLedger:
    """Process-wide request-trace collection + SLO exemplar store."""

    def __init__(self, registry=None):
        if registry is None:
            from .registry import get_registry

            registry = get_registry()
        self._lock = threading.Lock()
        self._open: Dict[str, RequestTrace] = {}
        self._done: deque = deque(maxlen=_DONE_RING)
        self._exemplars: Dict[str, deque] = {}
        self._m_requests = registry.counter(
            "deepspeed_tpu_serving_reqtrace_requests_total",
            "request traces finished, by terminal reason "
            "(complete / shed / deadline / failed / abandoned)",
            labelnames=("reason",))
        self._m_phase = registry.counter(
            "deepspeed_tpu_serving_reqtrace_phase_seconds_total",
            "finished-request lifecycle seconds by ledger phase; a "
            "request's phases sum to its end-to-end latency",
            labelnames=("phase",))
        self._m_open = registry.gauge(
            "deepspeed_tpu_serving_reqtrace_open_requests",
            "request traces currently open (submitted, not finished)")
        self._m_exemplars = registry.counter(
            "deepspeed_tpu_serving_reqtrace_exemplars_total",
            "SLO violation exemplars recorded (trace_id attached to a "
            "deepspeed_tpu_serving_slo_* increment)",
            labelnames=("metric",))

    # ------------------------------------------------------------ traces
    def begin(self, trace_id: str, uid: Optional[int] = None,
              priority: int = 0) -> RequestTrace:
        with self._lock:
            tr = RequestTrace(trace_id, uid=uid, priority=priority)
            self._open[trace_id] = tr
            self._m_open.set(len(self._open))
            return tr

    def get(self, trace_id: Optional[str]) -> Optional[RequestTrace]:
        if trace_id is None:
            return None
        with self._lock:
            return self._open.get(trace_id)

    def lookup(self, trace_id: Optional[str]) -> Optional[RequestTrace]:
        """Like :meth:`get` but also searches the finished ring."""
        if trace_id is None:
            return None
        with self._lock:
            tr = self._open.get(trace_id)
            if tr is not None:
                return tr
            for t in self._done:
                if t.trace_id == trace_id:
                    return t
        return None

    def adopt(self, snap: Dict[str, Any],
              transit_s: float = 0.0) -> RequestTrace:
        """Install a wire snapshot as an open trace (cross-process
        import path).  In-process migration finds the trace already
        open and never lands here."""
        tr = RequestTrace.from_wire_snapshot(snap, transit_s=transit_s)
        with self._lock:
            self._open[tr.trace_id] = tr
            self._m_open.set(len(self._open))
        return tr

    def finish(self, trace_id: Optional[str], reason: str) -> None:
        if trace_id is None:
            return
        with self._lock:
            tr = self._open.pop(trace_id, None)
            if tr is None:
                return
            tr.finish(reason)
            self._done.append(tr)
            self._m_open.set(len(self._open))
            self._m_requests.inc(reason=reason or "complete")
            for phase, sec in tr.phase_seconds().items():
                if sec > 0:
                    self._m_phase.inc(sec, phase=phase)

    def discard(self, trace_id: Optional[str]) -> None:
        """Drop an open trace without terminal accounting (submit-path
        unwind: the request never entered the fleet)."""
        if trace_id is None:
            return
        with self._lock:
            self._open.pop(trace_id, None)
            self._m_open.set(len(self._open))

    def traces(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._done) + list(self._open.values())

    # --------------------------------------------------------- exemplars
    def record_exemplar(self, metric: str, trace_id: Optional[str],
                        **attrs) -> None:
        if not trace_id:
            return
        with self._lock:
            ring = self._exemplars.setdefault(
                metric, deque(maxlen=_EXEMPLARS_PER_METRIC))
            ring.append(dict({"metric": metric, "trace_id": trace_id},
                             **attrs))
            self._m_exemplars.inc(metric=metric)

    def exemplars(self) -> Dict[str, List[Dict[str, Any]]]:
        with self._lock:
            return {m: list(ring) for m, ring in self._exemplars.items()}

    # ----------------------------------------------------------- read-out
    def summary(self) -> Dict[str, Any]:
        with self._lock:
            done = list(self._done)
            n_open = len(self._open)
            n_ex = sum(len(r) for r in self._exemplars.values())
        phases = {p: 0.0 for p in PHASES}
        for tr in done:
            for p, sec in tr.phase_seconds().items():
                phases[p] += sec
        reasons: Dict[str, int] = {}
        for tr in done:
            reasons[tr.finish_reason] = reasons.get(tr.finish_reason, 0) + 1
        return {"open": n_open, "finished": len(done), "reasons": reasons,
                "phase_seconds": {p: round(s, 6) for p, s in phases.items()},
                "exemplars": n_ex}


# ------------------------------------------------------- process default
_default: Optional[ReqTraceLedger] = None
_default_lock = threading.Lock()


def get_reqtrace_ledger(create: bool = False) -> Optional[ReqTraceLedger]:
    """The process-default ledger.  ``create=True`` (the router) makes
    one on first use so co-located replicas share it; engine-side hooks
    pass ``create=False`` and no-op when no fleet ever traced."""
    global _default
    if _default is None and create:
        with _default_lock:
            if _default is None:
                _default = ReqTraceLedger()
    return _default


def set_reqtrace_ledger(ledger: Optional[ReqTraceLedger]) -> None:
    global _default
    with _default_lock:
        _default = ledger


def slo_exemplar(metric: str, trace_id: Optional[str], **attrs) -> None:
    """Attach ``trace_id`` as an exemplar to an SLO counter increment.

    Every ``deepspeed_tpu_serving_slo_*`` ``.inc()`` site calls this in
    the same function (the ``slo-exemplar`` lint rule fails by name
    otherwise); with no ledger installed or no trace context (engine
    used standalone) it is a no-op.
    """
    led = get_reqtrace_ledger()
    if led is None:
        return
    led.record_exemplar(metric, trace_id, **attrs)


def last_reqtrace_summary() -> Optional[Dict[str, Any]]:
    """Flight-dump hook: the process-default ledger's summary, or None."""
    led = _default
    if led is None:
        return None
    try:
        return led.summary()
    except Exception:
        return None


# ---------------------------------------------------------- fleet merge
def merged_trace_events(ledger: Optional[ReqTraceLedger] = None,
                        recorder=None) -> List[Dict[str, Any]]:
    """Merge every request's phase intervals (plus the span ring's
    trace-tagged events) into one Chrome-trace/Perfetto event list.

    Layout: one *process* row per owning replica (``pid`` +
    ``process_name`` metadata), one *thread* track per ``trace_id``
    (``tid`` + ``thread_name`` metadata) — so a request reads as a
    single horizontal track whose slices hop across replica rows, with
    ``kv_transfer`` as its own slice between prefill and decode.
    """
    from .spans import perf_to_us

    ledger = ledger if ledger is not None else get_reqtrace_ledger()
    if ledger is None:
        return []
    traces = ledger.traces()
    owners: List[str] = []
    for tr in traces:
        for _p, o, _s, _e in tr.intervals:
            if o not in owners:
                owners.append(o)
    pid_of = {o: i + 1 for i, o in enumerate(sorted(owners))}
    tid_of = {tr.trace_id: i + 1
              for i, tr in enumerate(
                  sorted(traces, key=lambda t: t.trace_id))}
    events: List[Dict[str, Any]] = []
    for owner, pid in sorted(pid_of.items(), key=lambda kv: kv[1]):
        events.append({"ph": "M", "ts": 0.0, "dur": 0.0, "pid": pid,
                       "tid": 0, "name": "process_name",
                       "args": {"name": owner}})
    for tr in traces:
        tid = tid_of[tr.trace_id]
        for pid in set(pid_of[o] for _p, o, _s, _e in tr.intervals):
            events.append({"ph": "M", "ts": 0.0, "dur": 0.0, "pid": pid,
                           "tid": tid, "name": "thread_name",
                           "args": {"name": tr.trace_id}})
        for phase, owner, start, end in tr.intervals:
            events.append({
                "ph": "X", "ts": round(perf_to_us(start), 3),
                "dur": round(max(0.0, end - start) * 1e6, 3),
                "pid": pid_of[owner], "tid": tid, "name": phase,
                "cat": "reqtrace",
                "args": {"trace_id": tr.trace_id, "uid": tr.uid,
                         "owner": owner, "attempt": tr.attempts,
                         "finish_reason": tr.finish_reason}})
    # span-ring events that carry trace context ride along as instant
    # events on the trace's track (shed/breaker/migrate markers)
    if recorder is None:
        from .spans import get_span_recorder

        recorder = get_span_recorder()
    if recorder is not None:
        for ev in recorder.trace_events():
            tid = tid_of.get((ev.get("args") or {}).get("trace_id"))
            if tid is None:
                continue
            events.append({
                "ph": "X", "ts": ev.get("ts", 0.0),
                "dur": max(0.0, ev.get("dur", 0.0)),
                "pid": pid_of.get((ev.get("args") or {}).get("replica"), 0),
                "tid": tid, "name": ev.get("name", "event"),
                "cat": "reqtrace_event", "args": ev.get("args") or {}})
    events.sort(key=lambda e: (e["ph"] != "M", e["ts"], e["pid"], e["tid"]))
    return events


def write_merged_trace(path: str, ledger: Optional[ReqTraceLedger] = None,
                       recorder=None) -> int:
    """Write the merged fleet artifact; returns the event count."""
    events = merged_trace_events(ledger, recorder)
    doc = {"displayTimeUnit": "ms", "traceEvents": events}
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
    return len(events)


__all__ = ["PHASES", "RequestTrace", "ReqTraceLedger",
           "get_reqtrace_ledger", "set_reqtrace_ledger", "slo_exemplar",
           "last_reqtrace_summary", "merged_trace_events",
           "write_merged_trace"]
