"""Elastic fleet sizing: grow/shrink replicas from load signals (the
port's counterpart of ``deepspeed_tpu/serving/autoscale.py``).

Without it a fleet has a FIXED topology: whatever ``build_fleet``
constructed is what traffic gets, however the queue looks.  This module
closes the loop: a :class:`FleetAutoscaler` watches two signals
each router pump — **queue depth per accepting replica** (the router's
own load measure) and **new TTFT SLO violations** (the
``deepspeed_tpu_serving_slo_ttft_violations_total`` counter the engine
already publishes) — and moves the replica count between
``autoscale.min_replicas`` and ``max_replicas``:

* **Grow** when the queue-per-replica signal has exceeded
  ``grow_queue_per_replica`` for ``grow_streak`` consecutive
  evaluations, or when new TTFT violations appeared since the last
  evaluation (latency debt is the leading indicator; queue depth the
  confirming one).  New replicas come from the injected
  ``spawn_replica`` factory — an in-process engine, or a cross-process
  :class:`~.transport.RemoteEngineProxy` replica; the autoscaler
  neither knows nor cares.
* **Shrink** when the fleet has idled under
  ``shrink_queue_per_replica`` for ``shrink_streak`` evaluations.
  Scale-down is LIFO (the most recently grown replica goes first —
  its caches are the coldest) and ALWAYS via
  ``router.retire_replica(name, migrate=True)``: decode-ready streams
  evacuate with their KV pages, everything else re-dispatches — a
  scale-down never drops a stream, the contract preemption evacuation
  keeps.

Failure policy mirrors the ``resilience/`` elastic-agent: a failed
spawn backs off exponentially (capped, seeded jitter) in PUMP units —
a broken replica factory costs a bounded, decaying trickle of
attempts, never a hot spawn loop.  ``cooldown_pumps`` of hysteresis
follow every action so a fresh replica gets to absorb load before the
signals are trusted again.

Owns the ``deepspeed_tpu_serving_autoscale_*`` metric family
(docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import random
from typing import Any, Callable, List, Optional

from ..telemetry import get_registry
from ..telemetry.spans import record_event
from ..utils.logging import logger
from .config import AutoscaleConfig
from .replica import ROLE_DECODE, ROLE_MIXED, ROLE_PREFILL, EngineReplica

_TTFT_COUNTER = "deepspeed_tpu_serving_slo_ttft_violations_total"


class FleetAutoscaler:
    """Pump-driven elastic sizing policy over a ``FleetRouter``.

    Call :meth:`evaluate` once per router pump (after ``router.step``);
    it returns the action taken — ``"grow"`` / ``"shrink"`` — or None.
    ``spawn_replica`` is called with a monotonically increasing index
    and must return a fresh :class:`~.replica.EngineReplica` (weights
    and page geometry matching the fleet)."""

    def __init__(self, router: Any,
                 config: Optional[AutoscaleConfig] = None,
                 spawn_replica: Optional[
                     Callable[[int], EngineReplica]] = None,
                 seed: int = 0):
        self.router = router
        self.config = config or AutoscaleConfig(enabled=True)
        self.spawn_replica = spawn_replica
        self._rand = random.Random(seed)
        self._grow_streak = 0
        self._shrink_streak = 0
        self._cooldown = 0
        self._spawn_failures = 0
        self._spawn_backoff = 0      # pumps left to skip after a failure
        self._spawn_index = 0
        self._ttft_seen = self._ttft_total()
        #: replicas THIS autoscaler grew, oldest first (LIFO shrink)
        self.grown: List[str] = []
        self._init_metrics()

    # -- telemetry -----------------------------------------------------------
    def _init_metrics(self) -> None:
        reg = get_registry()
        self._m_grow = reg.counter(
            "deepspeed_tpu_serving_autoscale_grow_total",
            "replicas added by the elastic sizing policy")
        self._m_shrink = reg.counter(
            "deepspeed_tpu_serving_autoscale_shrink_total",
            "replicas retired by the elastic sizing policy (always via "
            "evacuation — a scale-down never drops a stream)")
        self._m_replicas = reg.gauge(
            "deepspeed_tpu_serving_autoscale_replicas",
            "replicas currently accepting work, as the autoscaler "
            "counts them")
        self._m_qpr = reg.gauge(
            "deepspeed_tpu_serving_autoscale_queue_per_replica",
            "fleet queue depth per accepting replica — the grow/shrink "
            "occupancy signal")
        self._m_spawn_failures = reg.counter(
            "deepspeed_tpu_serving_autoscale_spawn_failures_total",
            "spawn_replica factory failures (each enters the bounded "
            "elastic-agent backoff schedule)")

    @staticmethod
    def _ttft_total() -> float:
        m = get_registry().get(_TTFT_COUNTER)
        return m.total() if m is not None else 0.0

    # -- signals -------------------------------------------------------------
    def _accepting(self) -> List[EngineReplica]:
        return [r for r in self.router.replicas.values()
                if r.accepts_new()]

    def _queue_per_replica(self) -> float:
        acc = self._accepting()
        if not acc:
            return float("inf")  # zero capacity and any queue = grow
        return sum(r.engine.queue_depth for r in acc) / len(acc)

    # -- the policy ----------------------------------------------------------
    def evaluate(self) -> Optional[str]:
        cfg = self.config
        acc = self._accepting()
        qpr = self._queue_per_replica()
        self._m_replicas.set(len(acc))
        self._m_qpr.set(0.0 if qpr == float("inf") else qpr)
        ttft_now = self._ttft_total()
        new_ttft = ttft_now - self._ttft_seen
        self._ttft_seen = ttft_now
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        if self._spawn_backoff > 0:
            self._spawn_backoff -= 1
            return None
        # streaks: consecutive evaluations, reset on any quiet reading
        self._grow_streak = (self._grow_streak + 1
                             if qpr > cfg.grow_queue_per_replica else 0)
        self._shrink_streak = (self._shrink_streak + 1
                               if qpr < cfg.shrink_queue_per_replica else 0)
        want_grow = (self._grow_streak >= cfg.grow_streak
                     or (cfg.grow_on_ttft_violations and new_ttft > 0
                         and qpr > 0))
        if want_grow and len(acc) < cfg.max_replicas:
            return self._grow(qpr, new_ttft)
        if (self._shrink_streak >= cfg.shrink_streak
                and len(acc) > cfg.min_replicas):
            return self._shrink(qpr)
        return None

    def _grow(self, qpr: float, new_ttft: float) -> Optional[str]:
        if self.spawn_replica is None:
            return None
        idx = self._spawn_index
        self._spawn_index += 1
        try:
            replica = self.spawn_replica(idx)
            self.router.add_replica(replica)
        except Exception as e:  # noqa: BLE001 — a broken factory must
            # back off, not kill the serving loop
            self._spawn_failures += 1
            self._m_spawn_failures.inc()
            self._spawn_backoff = self._backoff_pumps(self._spawn_failures)
            logger.warning(
                f"autoscale: spawn_replica failed ({e!r}); backing off "
                f"{self._spawn_backoff} pumps "
                f"(failure #{self._spawn_failures})")
            return None
        self._spawn_failures = 0
        self.grown.append(replica.name)
        self._grow_streak = 0
        self._cooldown = self.config.cooldown_pumps
        self._m_grow.inc()
        record_event("autoscale_grow", cat="serve", replica=replica.name,
                     queue_per_replica=round(qpr, 3),
                     new_ttft_violations=new_ttft,
                     fleet=len(self.router.replicas))
        logger.info(f"autoscale: grew fleet with {replica.name} "
                    f"(queue/replica={qpr:.2f}, "
                    f"new TTFT violations={new_ttft:.0f})")
        return "grow"

    def _shrink(self, qpr: float) -> Optional[str]:
        name = self._shrink_candidate()
        if name is None:
            return None
        self.router.retire_replica(name, migrate=True)
        if name in self.grown:
            self.grown.remove(name)
        self._shrink_streak = 0
        self._cooldown = self.config.cooldown_pumps
        self._m_shrink.inc()
        record_event("autoscale_shrink", cat="serve", replica=name,
                     queue_per_replica=round(qpr, 3),
                     fleet=len(self.router.replicas))
        logger.info(f"autoscale: retired {name} "
                    f"(queue/replica={qpr:.2f}); streams evacuated")
        return "shrink"

    def _shrink_candidate(self) -> Optional[str]:
        """LIFO: newest autoscaler-grown replica first (coldest
        caches); otherwise the least-loaded accepting replica whose
        removal keeps a disaggregated fleet functional (>= 1 prefill-
        capable AND >= 1 decode-capable replica remain)."""
        acc = self._accepting()
        for name in reversed(self.grown):
            r = self.router.replicas.get(name)
            if r is not None and r in acc and self._removable(r, acc):
                return name
        for r in sorted(acc, key=lambda x: (x.load(), x.name)):
            if self._removable(r, acc):
                return r.name
        return None

    def _removable(self, r: EngineReplica,
                   acc: List[EngineReplica]) -> bool:
        rest = [o for o in acc if o is not r]
        if not rest:
            return False
        if getattr(self.router.config, "disaggregated", False):
            has_prefill = any(o.role in (ROLE_PREFILL, ROLE_MIXED)
                              for o in rest)
            has_decode = any(o.role in (ROLE_DECODE, ROLE_MIXED)
                             for o in rest)
            return has_prefill and has_decode
        return True

    def _backoff_pumps(self, failures: int) -> int:
        """Elastic-agent schedule in pump units: exponential, capped,
        seeded jitter — bounded pressure on a broken factory."""
        base = min(2 ** max(0, failures - 1), 32)
        return max(1, int(round(
            base * (1.0 + 0.25 * self._rand.random()))))


__all__ = ["FleetAutoscaler", "AutoscaleConfig"]
