"""Admission control & load shedding for the serving fleet (the port's
copy of ``deepspeed_tpu/serving/admission.py``, pure Python, unchanged).
The fleet (ROADMAP Queue 1 #15) will drive :class:`AdmissionController`;
the engine's bounded queue counts its sheds through :func:`record_shed`.

The dominant production failure mode is not a crash but **overload**: a
burst of requests grows queues without bound, queued work holds its
submitters hostage, and the KV pool thrashes through admission →
preemption → re-prefill storms.  The cure is to *refuse* work loudly at
the front door while the fleet can still say no cheaply:

* **Bounded queue** — ``serving.max_queue_depth`` caps the fleet-wide
  number of requests waiting for admission (queue depth summed over
  accepting replicas).
* **Token-budget estimator** — a request's KV-page cost is known at
  submit time (``ceil((prompt + max_new_tokens) / page_size)``); when
  the best candidate replica's projected pool occupancy crosses
  ``serving.shed_occupancy`` the fleet is saturated and queuing more
  work only manufactures preemptions.
* **Priority floor** — shedding only ever drops work whose priority
  class is ABOVE ``serving.protect_priority`` (numerically greater =
  less urgent).  Interactive traffic is never shed by these rules; it
  fails only when no live replica exists at all.

A shed is a :class:`RejectedError` carrying a ``retry_after_s`` hint —
the submitter still holds the request and backs off, instead of the
fleet OOMing on its behalf.  Every shed counts
``deepspeed_tpu_serving_slo_shed_total`` (labeled by priority class) and
emits a ``shed`` trace event, so "where did my request go" is always
answerable from the metrics alone.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from ..inference.v2.ragged import RejectedError
from ..telemetry import get_registry
from ..telemetry.reqtrace import slo_exemplar
from ..telemetry.spans import record_event
from ..utils.logging import logger


def shed_counter():
    """The (single-owner) shed counter, labeled by priority class."""
    return get_registry().counter(
        "deepspeed_tpu_serving_slo_shed_total",
        "requests refused by admission control (load shedding), by "
        "priority class and the engine-level bounded-queue rejections",
        labelnames=("priority",))


def retry_after_hint(queued: int, est_pages: int = 0) -> float:
    """Back-off hint for a shed request: proportional to the backlog it
    would have joined (a documented heuristic, not a promise — ~50ms of
    drain per queued request plus ~20ms per KV page it needs), clamped
    to [0.1s, 30s]."""
    return round(min(30.0, max(0.1, 0.05 * queued + 0.02 * est_pages)), 3)


def record_shed(priority: int, reason: str, retry_after_s: float,
                uid: Optional[int] = None,
                trace_id: Optional[str] = None) -> None:
    """Account one shed decision (counter + trace event + trace
    exemplar) — shared by the fleet controller below and the
    engine-level bounded queue."""
    shed_counter().inc(priority=str(int(priority)))
    slo_exemplar("deepspeed_tpu_serving_slo_shed_total", trace_id,
                 reason=reason, priority=int(priority))
    record_event("shed", cat="serve", priority=int(priority),
                 reason=reason, retry_after_s=retry_after_s,
                 **({} if uid is None else {"uid": uid}),
                 **({} if trace_id is None else {"trace_id": trace_id}))


def estimate_pages(prompt_tokens: int, max_new_tokens: int,
                   page_size: int) -> int:
    """KV pages a request will occupy if it runs to its token budget."""
    return -(-(prompt_tokens + max_new_tokens) // page_size)


class AdmissionController:
    """Fleet-front shed policy over a set of candidate replicas.

    Pure host logic: ``check()`` either returns (admit — with the
    estimated page cost, for event logging) or raises
    :class:`RejectedError`.  Candidates are any objects exposing the
    :class:`~.replica.EngineReplica` load surface (``engine.queue_depth``,
    ``engine.allocator.free_pages`` / ``num_pages``), so the policy is
    unit-testable with fakes."""

    def __init__(self, config: Any):
        self.config = config
        shed_counter()  # register the family even before the first shed

    # -- signals -------------------------------------------------------------
    @staticmethod
    def fleet_queue_depth(candidates: Sequence[Any]) -> int:
        return sum(r.engine.queue_depth for r in candidates)

    @staticmethod
    def best_free_pages(candidates: Sequence[Any]) -> int:
        return max((r.engine.allocator.free_pages for r in candidates),
                   default=0)

    @staticmethod
    def best_occupancy(candidates: Sequence[Any], extra_pages: int = 0
                       ) -> float:
        """Projected pool occupancy of the COOLEST candidate after
        placing ``extra_pages`` there — the fleet is only saturated when
        even its best replica is.  Can exceed 1.0 (the request's
        estimated pages overflow even the emptiest pool), so a
        ``shed_occupancy`` of 1.0 still arms the rule."""
        best = float("inf")
        for r in candidates:
            a = r.engine.allocator
            occ = (a.num_pages - a.free_pages + extra_pages) \
                / max(1, a.num_pages)
            best = min(best, occ)
        return best if best != float("inf") else 1.0

    # -- the decision --------------------------------------------------------
    def check(self, request: Any, candidates: Sequence[Any]) -> int:
        """Admit-or-shed for one request against the accepting replicas.

        Returns the estimated page cost on admit; raises
        :class:`RejectedError` on shed.  Requests at or below
        ``protect_priority`` are NEVER shed here."""
        cfg = self.config
        page_size = (candidates[0].engine.block.page_size
                     if candidates else 16)
        est = estimate_pages(len(request.prompt_ids),
                             request.max_new_tokens, page_size)
        prio = int(getattr(request, "priority", 1))
        if prio <= cfg.protect_priority or not candidates:
            return est
        queued = self.fleet_queue_depth(candidates)
        if cfg.max_queue_depth and queued >= cfg.max_queue_depth:
            self._shed(prio, "queue_full", queued, est,
                       uid=getattr(request, "uid", None),
                       trace_id=getattr(request, "trace_id", None))
        if cfg.shed_occupancy and \
                self.best_occupancy(candidates, est) > cfg.shed_occupancy:
            self._shed(prio, "pool_pressure", queued, est,
                       uid=getattr(request, "uid", None),
                       trace_id=getattr(request, "trace_id", None))
        return est

    def _shed(self, priority: int, reason: str, queued: int, est: int,
              uid: Optional[int] = None,
              trace_id: Optional[str] = None) -> None:
        hint = retry_after_hint(queued, est)
        record_shed(priority, reason, hint, uid=uid, trace_id=trace_id)
        logger.warning(
            f"admission: shed priority-{priority} request ({reason}: "
            f"{queued} queued fleet-wide, ~{est} KV pages needed); "
            f"retry after {hint}s")
        raise RejectedError(reason, retry_after_s=hint, priority=priority)


__all__ = ["AdmissionController", "RejectedError", "record_shed",
           "retry_after_hint", "estimate_pages", "shed_counter"]
