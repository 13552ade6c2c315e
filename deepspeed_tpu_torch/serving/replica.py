"""One engine replica as the router sees it (the port's counterpart of
``deepspeed_tpu/serving/replica.py``).

Wraps an :class:`InferenceEngineV2` (or a
:class:`~.transport.RemoteEngineProxy` to one in another process) with the
fleet-level state the router schedules on: a **role** (``prefill`` /
``decode`` / ``mixed`` — a placement *preference*, not a capability gate:
any engine can do both, which is what makes lossless fallback possible
when a pool empties), a **health** state (alive / retired), a
:class:`PreemptionWatcher` so a maintenance notice against one replica
turns into graceful drain-and-migrate instead of dropped streams, and a
**circuit breaker** against *gray failure* — the replica that is slow or
flaky rather than dead, which ``kill()``-style liveness never catches.

The breaker is a rolling window of per-``step()`` wall times and
exceptions plus a three-state machine:

``closed`` ──median > k x fleet median, or N consec. errors──▶ ``open``
``open``   ──cooldown pumps elapse──▶ ``half_open`` (probing)
``half_open`` ──probe steps healthy──▶ ``closed``  (or back to ``open``)

The latency rule compares this replica's rolling *median* step time
(sustained degradation) against the fleet median; p95 is kept on the
health surface for tail observability, but a lone CUDA-graph capture or
GC spike never trips the breaker.

The replica only *records and evaluates*; fleet-relative judgment (the
median of the OTHER replicas) and the consequences of a trip (drain of
new placement, re-dispatch of in-flight streams) belong to the router
(``FleetRouter._check_breakers``).  Thresholds come from the ``serving``
config block.

``load()`` is the router's least-loaded signal: queue depth + occupied
decode slots — the quantities the engine publishes as the
``deepspeed_tpu_serving_queue_depth`` / ``_batch_occupancy`` gauges, read
directly so N co-located replicas (which share one process-wide gauge)
stay individually observable.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from ..resilience.preemption import PreemptionWatcher

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_MIXED = "mixed"
ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_MIXED)

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


class EngineReplica:
    """A named engine + fleet-level lifecycle state."""

    def __init__(self, name: str, engine: Any, role: str = ROLE_MIXED,
                 breaker_window: int = 32):
        if role not in ROLES:
            raise ValueError(f"replica role {role!r} not in {ROLES}")
        self.name = name
        self.engine = engine
        self.role = role
        # the engine stamps this name as the owner of its reqtrace
        # ledger intervals and span attrs: N co-located replicas share
        # one process, so per-replica attribution must ride the engine
        engine.trace_owner = name
        #: signal/maintenance-notice injection point: the router
        #: polls ``preempted`` each pump and retires the replica
        #: gracefully.  No process-level signal handlers here — N
        #: replicas share one process in the CPU drill, and a real
        #: deployment installs per-process watchers in the replica's
        #: launcher instead.
        self.watcher = PreemptionWatcher(install_signals=False)
        #: False after a hard death (chaos ``kill()``): engine state —
        #: including every in-flight KV page — is gone
        self.alive = True
        #: True once drained/evacuated: keeps its slot in the fleet
        #: table for observability but takes no work
        self.retired = False
        # -- circuit-breaker state (see module docstring) --
        self.breaker = BREAKER_CLOSED
        self.step_errors = 0       # lifetime step exceptions
        self.consec_errors = 0     # reset by any healthy step
        self._lat: deque = deque(maxlen=max(2, int(breaker_window)))
        #: rolling per-step error flags (same window): an INTERMITTENT
        #: flaky replica never runs up consec_errors, but a majority-
        #: erroring window still trips
        self._err: deque = deque(maxlen=max(2, int(breaker_window)))
        self._cooldown = 0         # open -> half_open countdown (pumps)
        self._probe_ok = 0         # healthy steps while half_open
        self._probe_err = False    # any error while half_open: re-trip
        #: gray-failure injection point (resilience/chaos.py
        #: ``SlowReplica`` / ``FlakyStep``): called with this replica at
        #: the top of every ``step()``; may sleep (slow replica) or
        #: raise (flaky step)
        self._chaos_hook: Optional[Callable[["EngineReplica"], None]] = None

    # -- scheduling signals --------------------------------------------------
    @property
    def preempted(self) -> bool:
        return self.watcher.requested is not None

    def accepts_new(self) -> bool:
        """Can this replica take NEW admissions right now?  An open
        breaker means degraded: drained of placement until the
        half-open probe readmits it."""
        return (self.alive and not self.retired and not self.preempted
                and self.breaker != BREAKER_OPEN)

    def load(self) -> int:
        """Queue depth + occupied decode slots (see module docstring)."""
        return self.engine.queue_depth + self.engine.active_count

    def kv_free_fraction(self) -> float:
        """Allocatable fraction of the KV page pool — the pool-occupancy
        signal (same quantity as the ``_kv_pages_free`` gauge)."""
        a = self.engine.allocator
        return a.free_pages / max(1, a.num_pages)

    # -- chaos injection -----------------------------------------------------
    def inject_chaos(self, hook: Optional[Callable[["EngineReplica"], None]]
                     ) -> None:
        """Install (or clear, with None) the per-step gray-failure hook."""
        self._chaos_hook = hook

    def clear_chaos(self) -> None:
        self._chaos_hook = None

    # -- breaker window ------------------------------------------------------
    @property
    def lat_samples(self) -> int:
        return len(self._lat)

    def step_p95(self) -> float:
        """p95 of the rolling step-latency window (0.0 while empty) —
        the tail-latency health surface."""
        if not self._lat:
            return 0.0
        xs = sorted(self._lat)
        return xs[min(len(xs) - 1, max(0, -(-95 * len(xs) // 100) - 1))]

    def step_p50(self) -> float:
        """Rolling MEDIAN step latency (0.0 while empty) — what the
        breaker's latency rule compares: a gray-failed replica is slow
        on EVERY step, so its median rises; an occasional CUDA-graph
        capture or GC spike moves only the tail (p95) and must not trip."""
        if not self._lat:
            return 0.0
        xs = sorted(self._lat)
        return xs[(len(xs) - 1) // 2]

    def _record_step(self, dt: float, error: bool) -> None:
        self._err.append(bool(error))
        if error:
            # error steps stay OUT of the latency window: a failure
            # raising in microseconds would drag p50 DOWN and let a
            # flaky replica evade the latency rule
            self.step_errors += 1
            self.consec_errors += 1
            if self.breaker == BREAKER_HALF_OPEN:
                self._probe_err = True
        else:
            self._lat.append(dt)
            self.consec_errors = 0
            if self.breaker == BREAKER_HALF_OPEN:
                self._probe_ok += 1

    def breaker_eval(self, fleet_median: float, cfg: Any
                     ) -> Optional[str]:
        """Advance the breaker one router pump against the fleet signal.

        Returns the transition taken — ``"trip"`` (-> open),
        ``"probe"`` (open -> half_open after cooldown), ``"recover"``
        (half_open -> closed after healthy probe steps) — or None.
        ``fleet_median`` is the fleet latency signal: the median of
        the OTHER replicas' rolling medians (0.0 = no fleet signal:
        only the error rule can trip).  This replica's own SUSTAINED
        latency (``step_p50``) is what's compared — a one-off compile
        or GC spike lifts only the tail and must not trip."""
        if self.breaker == BREAKER_OPEN:
            self._cooldown -= 1
            if self._cooldown <= 0:
                self.breaker = BREAKER_HALF_OPEN
                self._lat.clear()
                self._err.clear()
                self.consec_errors = 0
                self._probe_ok = 0
                self._probe_err = False
                return "probe"
            return None
        # error rules: a consecutive run, ANY error during a half-open
        # probe (docs/SERVING.md: probe errors re-trip), or a majority-
        # erroring window — the intermittent-fault profile that never
        # accumulates a consecutive run
        trip = self.consec_errors >= cfg.breaker_consec_errors
        if not trip and self.breaker == BREAKER_HALF_OPEN:
            trip = self._probe_err
        if (not trip and len(self._err) >= cfg.breaker_min_samples
                and 2 * sum(self._err) >= len(self._err)):
            trip = True
        if not trip and fleet_median > 0.0 and self._lat:
            # latency rule gate: breaker_min_samples when closed; at the
            # half-open DECISION point (probe complete) the probe steps
            # are the evidence — a still-slow replica must re-trip here,
            # not recover and flap (probe_steps < min_samples in every
            # shipped config, so waiting for min_samples would always
            # let recovery win)
            decide = (self.lat_samples >= cfg.breaker_min_samples
                      or (self.breaker == BREAKER_HALF_OPEN
                          and self._probe_ok >= cfg.breaker_probe_steps))
            if decide:
                floor = max(fleet_median, cfg.breaker_min_latency_s)
                trip = self.step_p50() > cfg.breaker_latency_factor * floor
        if trip:
            self.breaker = BREAKER_OPEN
            self._cooldown = int(cfg.breaker_cooldown_pumps)
            self._probe_ok = 0
            self._probe_err = False
            return "trip"
        if (self.breaker == BREAKER_HALF_OPEN
                and self._probe_ok >= cfg.breaker_probe_steps):
            self.breaker = BREAKER_CLOSED
            return "recover"
        return None

    # -- lifecycle -----------------------------------------------------------
    def step(self) -> Dict[int, Dict[str, Any]]:
        """One engine step, timed into the breaker window.  Exceptions
        (chaos hook or engine) are recorded as error steps and
        re-raised — TOLERATING them is the router's decision (it
        swallows per-replica step failures when breakers are enabled,
        letting consecutive errors trip the breaker instead of one
        replica's fault taking the fleet down)."""
        if not self.engine.has_work():
            return {}
        t0 = time.perf_counter()
        try:
            if self._chaos_hook is not None:
                self._chaos_hook(self)
            out = self.engine.step()
        except Exception:
            self._record_step(time.perf_counter() - t0, error=True)
            raise
        self._record_step(time.perf_counter() - t0, error=False)
        return out

    def kill(self) -> None:
        """Chaos hook: simulate an unannounced replica death (process
        gone, KV pages unrecoverable).  The router re-dispatches its
        in-flight requests on the next pump."""
        self.alive = False

    def health(self) -> Dict[str, Any]:
        h = {"role": self.role, "alive": self.alive, "retired": self.retired,
             "preempted": self.watcher.requested or "",
             "breaker": self.breaker,
             "step_p50_s": round(self.step_p50(), 6),
             "step_p95_s": round(self.step_p95(), 6),
             "step_errors": self.step_errors,
             "load": self.load() if self.alive else -1}
        if self.alive:
            h.update(queue_depth=self.engine.queue_depth,
                     active=self.engine.active_count,
                     kv_free_fraction=round(self.kv_free_fraction(), 4))
            tier = getattr(self.engine, "kv_tier", None)
            if tier is not None:
                # host-tier occupancy: the second-tier capacity signal
                # next to the device pool's kv_free_fraction
                h.update(kv_tier_host_pages=tier.host_pages,
                         kv_tier_host_bytes=tier.host_bytes,
                         kv_tier_hit_rate=round(tier.hit_rate, 4))
        return h


__all__ = ["EngineReplica", "ROLE_PREFILL", "ROLE_DECODE", "ROLE_MIXED",
           "ROLES", "BREAKER_CLOSED", "BREAKER_OPEN", "BREAKER_HALF_OPEN"]
