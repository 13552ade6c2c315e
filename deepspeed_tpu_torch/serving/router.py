"""Fleet router (the port's counterpart of
``deepspeed_tpu/serving/router.py``): prefix-cache-affinity request
scheduling across N engine replicas, prefill/decode disaggregation, and
failure handling.

One :class:`~..inference.v2.InferenceEngineV2` is one process-worth of
serving; a front tier above many of them is this router, host-side (the
engines own the card):

* **Placement** — requests are routed by *prefix-cache affinity*:
  the affinity key is the prefix cache's content-hash chain over the prompt's
  leading full pages (``PrefixCache.chain_key``), so requests sharing a
  system prompt / few-shot template land on the replica whose prefix
  cache already holds those pages.  Rendezvous (highest-random-weight)
  hashing keeps the mapping deterministic and stable as replicas come
  and go; a **least-loaded fallback** (driven by the same queue-depth /
  occupancy quantities the serving gauges publish) overrides affinity
  when the favorite is more than ``load_gap`` requests hotter than the
  coolest candidate.
* **Disaggregation** — prefill-role replicas run (chunked) prefill;
  the moment a sequence is decode-ready its KV pages stream to a
  decode-role replica (``kv_transfer.migrate_sequence``, ref-count
  adoption on import).  If no decode replica has capacity the sequence
  simply keeps decoding where it is — roles are preferences, so the
  fleet degrades to mixed serving instead of losing work.
* **Lifecycle** — a replica death (chaos ``kill()``) re-dispatches its
  in-flight requests (prompt + tokens emitted so far, greedy streams
  stay bit-identical); a preemption notice triggers graceful
  evacuation: decode-ready sequences migrate with their KV, the rest
  re-dispatch, and the replica retires without dropping a stream.

Everything observable flows through the ``deepspeed_tpu_serving_fleet_*``
metric family and ``fleet_*`` trace events (docs/SERVING.md catalog).
"""

from __future__ import annotations

import hashlib
import itertools
import statistics
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..inference.v2.engine_v2 import RaggedRequest
from ..inference.v2.ragged import PrefixCache, RejectedError
from ..telemetry import get_registry
from ..telemetry.reqtrace import get_reqtrace_ledger, slo_exemplar
from ..telemetry.spans import record_event
from ..utils.logging import logger
from .admission import AdmissionController, record_shed, retry_after_hint
from .config import ServingConfig
from .kv_transfer import migrate_sequence
from .replica import (BREAKER_OPEN, ROLE_DECODE, ROLE_MIXED, ROLE_PREFILL,
                      EngineReplica)

#: breaker_state gauge encoding (docs/OBSERVABILITY.md)
_BREAKER_STATE_CODE = {"closed": 0, "half_open": 1, "open": 2}

#: per-process router instance counter: the trace-id namespace.  Request
#: uids are PER-ENGINE (two replicas both have a uid 0), so cross-replica
#: correlation keys on the router-minted ``trace_id`` instead — and two
#: routers in one process (drills build several fleets) must not collide
#: either.  Counter-based, never uuid/time: drills replay bit-identically
#: under ``--seed``.
_ROUTER_SEQ = itertools.count()


# -- pure routing policy (unit-testable without engines) ---------------------
def affinity_key(prompt_ids: Sequence[int], page_size: int,
                 affinity_pages: int = 4) -> bytes:
    """Affinity key of a prompt: the prefix cache's content-hash chain
    (``PrefixCache.chain_key``) over its leading full pages, capped at
    ``affinity_pages``.  Prompts shorter than one page hash whole —
    still deterministic, still groups identical prompts."""
    n_full = min(len(prompt_ids) // page_size, max(1, affinity_pages))
    if n_full == 0:
        return PrefixCache.chain_key(None, prompt_ids)
    key: Optional[bytes] = None
    for j in range(n_full):
        key = PrefixCache.chain_key(
            key, prompt_ids[j * page_size:(j + 1) * page_size])
    return key  # type: ignore[return-value]


def hrw_score(key: bytes, name: str) -> int:
    """Rendezvous weight of (request key, replica name): deterministic,
    uniform, and stable — removing one replica only re-homes the keys
    that mapped to it."""
    return int.from_bytes(
        hashlib.sha256(key + b"\x00" + name.encode()).digest()[:8], "big")


def pick_replica(key: bytes, candidates: Sequence[Any], load_gap: int
                 ) -> Tuple[Any, str]:
    """Choose among ``candidates`` (objects with ``.name`` and
    ``.load()``): the HRW-affinity favorite unless it is more than
    ``load_gap`` requests hotter than the least-loaded candidate, in
    which case the least-loaded one (ties broken by name, so the choice
    is deterministic).  Returns ``(replica, "affinity"|"least_loaded")``."""
    if not candidates:
        raise ValueError("no candidate replicas")
    favorite = max(candidates, key=lambda r: (hrw_score(key, r.name), r.name))
    loads = {r.name: r.load() for r in candidates}
    coolest = min(loads.values())
    if loads[favorite.name] - coolest <= load_gap:
        return favorite, "affinity"
    least = min(candidates, key=lambda r: (loads[r.name], r.name))
    return least, "least_loaded"


class _RequestRecord:
    """Router-side view of one request across replica hops."""

    __slots__ = ("request", "replica", "emitted", "done", "failed",
                 "redispatches", "finish_reason", "deadline_abs",
                 "trace_id", "submitted_at")

    def __init__(self, request: RaggedRequest,
                 trace_id: Optional[str] = None):
        self.request = request
        self.replica: Optional[str] = None  # current owner
        self.emitted: List[int] = []        # tokens streamed so far
        self.done = False
        self.failed = False
        self.redispatches = 0
        self.finish_reason = ""             # set when done
        #: the fleet-unique correlation key (router-minted)
        self.trace_id = trace_id
        #: FIRST-submission stamp: re-dispatch hops re-enqueue with a
        #: fresh engine clock, but end-to-end accounting (the reqtrace
        #: ledger) measures from here
        self.submitted_at = time.perf_counter()
        #: absolute expiry on this process's perf_counter clock; hops
        #: (re-dispatch) carry the REMAINING budget, not a fresh one
        self.deadline_abs = (self.submitted_at + request.deadline_s
                             if request.deadline_s is not None else None)

    def deadline_left(self) -> Optional[float]:
        if self.deadline_abs is None:
            return None
        return max(0.0, self.deadline_abs - time.perf_counter())


class FleetRouter:
    """Front tier over a list of :class:`EngineReplica`.

    Drive it like an engine: ``submit()`` requests, ``step()`` (one
    pump of the whole fleet) until done — or ``run_all()`` for batch
    use.  All replicas must share weights and page geometry (greedy
    streams are then bit-identical to a single engine, kill or no
    kill)."""

    def __init__(self, replicas: Sequence[EngineReplica],
                 config: Optional[ServingConfig] = None):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        ps = {r.engine.block.page_size for r in replicas}
        if len(ps) != 1:
            raise ValueError(f"replicas disagree on page_size: {ps} — "
                             "KV migration needs one geometry")
        self.config = config or ServingConfig()
        self.replicas: Dict[str, EngineReplica] = {r.name: r for r in replicas}
        self._page_size = ps.pop()
        self._requests: Dict[int, _RequestRecord] = {}
        self._uid = itertools.count()
        #: fleet request tracing: this router's trace-id namespace plus
        #: the (shared, process-default) lifecycle ledger — co-located
        #: replicas write into the same ledger, so one request is ONE
        #: trace across its prefill/decode/re-dispatch hops
        self._trace_prefix = f"r{next(_ROUTER_SEQ)}"
        self._trace_seq = itertools.count()
        self.reqtrace = get_reqtrace_ledger(create=True)
        self.admission = AdmissionController(self.config)
        self._init_metrics()
        self._publish()

    # -- telemetry -----------------------------------------------------------
    def _init_metrics(self) -> None:
        reg = get_registry()
        self._m_live = reg.gauge(
            "deepspeed_tpu_serving_fleet_replicas_live",
            "replicas accepting work (alive, not retired/preempted)")
        self._m_inflight = reg.gauge(
            "deepspeed_tpu_serving_fleet_inflight_requests",
            "submitted requests not yet finished")
        self._m_requests = reg.counter(
            "deepspeed_tpu_serving_fleet_requests_total",
            "requests submitted to the router")
        self._m_affinity = reg.counter(
            "deepspeed_tpu_serving_fleet_affinity_routed_total",
            "placements that followed prefix-cache affinity")
        self._m_least = reg.counter(
            "deepspeed_tpu_serving_fleet_least_loaded_routed_total",
            "placements that fell back to the least-loaded replica")
        self._m_migrations = reg.counter(
            "deepspeed_tpu_serving_fleet_migrations_total",
            "sequences streamed prefill -> decode (KV-page migration)")
        self._m_migrated_pages = reg.counter(
            "deepspeed_tpu_serving_fleet_migrated_pages_total",
            "KV pages moved by migration")
        self._m_migration_failures = reg.counter(
            "deepspeed_tpu_serving_fleet_migration_failures_total",
            "migrations refused for capacity (sequence stayed put)")
        self._m_redispatch = reg.counter(
            "deepspeed_tpu_serving_fleet_redispatches_total",
            "in-flight requests re-run after a replica loss")
        self._m_deaths = reg.counter(
            "deepspeed_tpu_serving_fleet_replica_deaths_total",
            "replicas lost without warning")
        self._m_preempt = reg.counter(
            "deepspeed_tpu_serving_fleet_replica_preemptions_total",
            "replicas evacuated after a preemption notice")
        self._m_drains = reg.counter(
            "deepspeed_tpu_serving_fleet_drains_total",
            "replica retirements via engine drain")
        self._m_failed = reg.counter(
            "deepspeed_tpu_serving_fleet_failed_requests_total",
            "requests abandoned after max_redispatch replica losses")
        # circuit-breaker half of the slo_* family (the deadline /
        # queue-wait / shed half lives on engine_v2 + admission.py)
        self._m_breaker_state = reg.gauge(
            "deepspeed_tpu_serving_slo_breaker_state",
            "per-replica breaker state: 0=closed, 1=half_open, 2=open",
            labelnames=("replica",))
        self._m_breaker_trips = reg.counter(
            "deepspeed_tpu_serving_slo_breaker_trips_total",
            "breakers tripped open (gray failure detected: slow or "
            "flaky replica drained of placement)")
        self._m_breaker_recover = reg.counter(
            "deepspeed_tpu_serving_slo_breaker_recoveries_total",
            "breakers closed again after a healthy half-open probe")
        self._m_rebalanced = reg.counter(
            "deepspeed_tpu_serving_fleet_rebalanced_total",
            "running decode streams migrated off hot replicas by live "
            "rebalancing (placement fixed AFTER admission, "
            "bit-identically)")
        self._m_rebalance_skipped = reg.counter(
            "deepspeed_tpu_serving_fleet_rebalance_skipped_deadline_total",
            "rebalance candidates left in place because their remaining "
            "deadline budget was below rebalance_min_deadline_s (the "
            "move itself costs time the stream does not have)")
        self._m_replicas_added = reg.counter(
            "deepspeed_tpu_serving_fleet_replicas_added_total",
            "replicas added to a running fleet (elastic scale-up)")

    def _publish(self) -> None:
        self._m_live.set(sum(1 for r in self.replicas.values()
                             if r.accepts_new()))
        self._m_inflight.set(sum(1 for rec in self._requests.values()
                                 if not rec.done))

    # -- placement -----------------------------------------------------------
    def _place_engine(self, req: RaggedRequest, target: EngineReplica,
                      cands: List[EngineReplica]
                      ) -> Optional[EngineReplica]:
        """Hand ``req`` to ``target``, falling back to the remaining
        candidates coolest-first when an engine-level bounded queue
        refuses — the ONE placement-retry policy, shared by new
        submissions and re-dispatch.  ``record_shed=False``: shed
        accounting (or not — in-flight streams are never shed) is the
        caller's.  Returns the accepting replica, or None when every
        candidate refused."""
        order = [target] + sorted((c for c in cands if c is not target),
                                  key=lambda r: (r.load(), r.name))
        for t in order:
            try:
                t.engine.put(req, record_shed=False)
            except RejectedError:
                continue
            return t
        return None

    def _candidates(self, phase: str) -> List[EngineReplica]:
        """Replicas that can take ``phase`` work, role-preferred with a
        lossless fallback to ANY accepting replica when the preferred
        pool is empty (e.g. every prefill replica died)."""
        roles = (phase, ROLE_MIXED)
        pref = [r for r in self.replicas.values()
                if r.accepts_new() and r.role in roles]
        if pref:
            return pref
        return [r for r in self.replicas.values() if r.accepts_new()]

    def _route(self, prompt_ids: Sequence[int],
               cands: Optional[List[EngineReplica]] = None
               ) -> Tuple[EngineReplica, str]:
        if cands is None:
            cands = self._candidates(ROLE_PREFILL)
        if not cands:
            raise RuntimeError("no live replica accepts work")
        key = affinity_key(prompt_ids, self._page_size,
                           self.config.affinity_pages)
        chosen, via = pick_replica(key, cands, self.config.load_gap)
        (self._m_affinity if via == "affinity" else self._m_least).inc()
        return chosen, via

    # -- request API ---------------------------------------------------------
    def submit(self, request: RaggedRequest) -> int:
        """Route + enqueue one request; returns the router-level uid its
        stream is keyed by (stable across migrations/re-dispatch).

        Under overload this raises :class:`RejectedError` (load
        shedding — bounded queue / KV-pool shed threshold, see
        ``serving/admission.py``) instead of queuing: the caller still
        holds the request and backs off ``retry_after_s``.  Requests at
        or below ``serving.protect_priority`` are never shed by the
        fleet rules; with engine-level hard bounds
        (``inference.v2 max_queue_depth``) they are refused only when
        EVERY accepting engine's queue is full — backpressure of last
        resort, counted as one shed."""
        # the trace id is minted BEFORE admission so a shed carries the
        # exemplar of the request it refused; the ledger entry of a shed
        # request finishes immediately (reason="shed") — its whole
        # lifetime was one queue_wait interval at the front door
        trace_id = f"{self._trace_prefix}-{next(self._trace_seq)}"
        request.trace_id = trace_id
        self.reqtrace.begin(trace_id, priority=request.priority)
        # admission BEFORE allocating a uid: a shed request was never in
        # the fleet (no record, no partial state to clean up)
        cands = self._candidates(ROLE_PREFILL)
        try:
            self.admission.check(request, cands)
        except RejectedError:
            self.reqtrace.finish(trace_id, "shed")
            raise
        except BaseException:
            self.reqtrace.discard(trace_id)
            raise
        target, via = self._route(request.prompt_ids, cands)
        uid = next(self._uid)
        rec = _RequestRecord(request, trace_id=trace_id)
        self._requests[uid] = rec
        tr = self.reqtrace.get(trace_id)
        if tr is not None:
            tr.uid = uid
        # an engine-level bounded queue may refuse the favorite: try the
        # remaining candidates coolest-first (record_shed=False in
        # _place_engine — at most ONE shed per request, counted here,
        # not per engine)
        try:
            req = RaggedRequest(
                prompt_ids=list(request.prompt_ids),
                max_new_tokens=request.max_new_tokens,
                temperature=request.temperature, eos_id=request.eos_id,
                uid=uid, priority=request.priority,
                deadline_s=request.deadline_s, trace_id=trace_id)
            placed = self._place_engine(req, target, cands)
            if placed is None:
                # roles are preferences, not gates: before shedding, try
                # the accepting replicas OUTSIDE the prefill-capable
                # pool (e.g. idle decode replicas — mixed-serving
                # degradation, the same lossless fallback _candidates
                # applies when the preferred pool is empty)
                rest = sorted(
                    (r for r in self.replicas.values()
                     if r.accepts_new() and r not in cands),
                    key=lambda r: (r.load(), r.name))
                if rest:
                    placed = self._place_engine(req, rest[0], rest)
            if placed is None:
                # every accepting engine's hard queue bound refused:
                # shed loudly (once)
                hint = retry_after_hint(
                    self.admission.fleet_queue_depth(cands))
                record_shed(request.priority, "engine_queue_full", hint,
                            uid=uid, trace_id=trace_id)
                self.reqtrace.finish(trace_id, "shed")
                logger.warning(
                    f"fleet: shed priority-{request.priority} request — "
                    "every accepting engine's bounded queue is full; "
                    f"retry after {hint}s")
                raise RejectedError("engine_queue_full",
                                    retry_after_s=hint,
                                    priority=request.priority)
            if placed is not target:
                target, via = placed, "engine_full_fallback"
        except BaseException:
            # the request was never admitted anywhere: a ghost record
            # with done=False would wedge has_work() True forever
            # (the shed path above already finished the ledger entry —
            # discard is a no-op for it)
            self._requests.pop(uid, None)
            self.reqtrace.discard(trace_id)
            raise
        rec.replica = target.name
        self._m_requests.inc()
        record_event("fleet_route", cat="serve", uid=uid,
                     replica=target.name, via=via,
                     priority=request.priority, trace_id=trace_id,
                     prompt_tokens=len(request.prompt_ids))
        self._publish()
        return uid

    def has_work(self) -> bool:
        return any(not rec.done for rec in self._requests.values())

    # -- failure handling ----------------------------------------------------
    def _redispatch(self, uid: int, charge: bool = True) -> None:
        """Re-run an unfinished request elsewhere.  ``charge=False`` is
        for planned retirements (drain handbacks): the request was not
        lost to a replica failure, so it neither consumes the
        ``max_redispatch`` replica-loss budget nor counts in the
        re-dispatch metric."""
        rec = self._requests[uid]
        if rec.done:
            return
        remaining = rec.request.max_new_tokens - len(rec.emitted)
        if remaining <= 0:
            rec.done = True
            self.reqtrace.finish(rec.trace_id, "complete")
            return
        if charge:
            rec.redispatches += 1
            if rec.redispatches > self.config.max_redispatch:
                rec.done = rec.failed = True
                rec.replica = None
                self._m_failed.inc()
                self.reqtrace.finish(rec.trace_id, "failed")
                logger.error(f"fleet: request {uid} abandoned after "
                             f"{rec.redispatches - 1} re-dispatches")
                return
        # continuation prompt = original prompt + tokens already
        # streamed: greedy decoding is deterministic, so the re-run
        # continues the stream bit-identically (the same recompute
        # contract engine preemption relies on)
        prompt = list(rec.request.prompt_ids) + list(rec.emitted)
        cands = self._candidates(ROLE_PREFILL)
        if not cands:
            rec.done = rec.failed = True
            self._m_failed.inc()
            self.reqtrace.finish(rec.trace_id, "failed")
            logger.error(f"fleet: request {uid} lost — no live replicas")
            return
        key = affinity_key(prompt, self._page_size,
                           self.config.affinity_pages)
        target, _via = pick_replica(key, cands, self.config.load_gap)
        tr = self.reqtrace.get(rec.trace_id)
        if tr is not None:
            # the prior-attempt ledger rides the re-dispatch (satellite:
            # no clock restart): attempts++ and back to queue_wait; the
            # replacement prefill classifies as recompute
            tr.note_redispatch()
        # the hop inherits the request's REMAINING deadline budget (a
        # re-dispatch never resets the SLO clock) and its priority.
        # An engine-level bounded queue may refuse the favorite — an
        # in-flight stream is NOT shed for that: try the remaining
        # candidates coolest-first before giving up.
        # an in-flight stream is never "shed": a refusal here is a
        # placement miss (the loss, if total, counts in
        # fleet_failed_requests_total), so no shed accounting
        placed = self._place_engine(RaggedRequest(
            prompt_ids=prompt, max_new_tokens=remaining,
            temperature=rec.request.temperature,
            eos_id=rec.request.eos_id, uid=uid,
            priority=rec.request.priority,
            deadline_s=rec.deadline_left(),
            trace_id=rec.trace_id), target, cands)
        if placed is None:
            rec.done = rec.failed = True
            self._m_failed.inc()
            self.reqtrace.finish(rec.trace_id, "failed")
            logger.error(f"fleet: request {uid} lost — every live replica "
                         "refused the re-dispatch (bounded queues full)")
            return
        target = placed
        rec.replica = target.name
        if charge:
            self._m_redispatch.inc()
        record_event("fleet_redispatch", cat="serve", uid=uid,
                     replica=target.name, emitted=len(rec.emitted),
                     attempt=rec.redispatches, planned=not charge,
                     **({} if rec.trace_id is None
                        else {"trace_id": rec.trace_id}))

    def _owned_uids(self, name: str) -> List[int]:
        return [uid for uid, rec in self._requests.items()
                if rec.replica == name and not rec.done]

    def _clear_breaker_gauge(self, r: EngineReplica) -> None:
        """A dead/retired replica must not export an open breaker
        forever: zero its ``breaker_state`` label on the way out."""
        self._m_breaker_state.set(0, replica=r.name)

    def _reap_dead(self) -> None:
        for r in self.replicas.values():
            if r.alive or r.retired:
                continue
            r.retired = True
            self._clear_breaker_gauge(r)
            lost = self._owned_uids(r.name)
            self._m_deaths.inc()
            record_event("fleet_replica_death", cat="serve",
                         replica=r.name, inflight=len(lost))
            logger.warning(f"fleet: replica {r.name} died with "
                           f"{len(lost)} in-flight request(s); "
                           "re-dispatching")
            for uid in lost:
                self._redispatch(uid)

    def _reap_preempted(self) -> None:
        for r in self.replicas.values():
            if not (r.alive and not r.retired and r.preempted):
                continue
            self._m_preempt.inc()
            record_event("fleet_replica_preempted", cat="serve",
                         replica=r.name, reason=r.watcher.requested)
            logger.warning(f"fleet: replica {r.name} preempted "
                           f"({r.watcher.requested}); evacuating")
            self._evacuate(r)

    def _evacuate(self, r: EngineReplica) -> None:
        """Graceful retirement: decode-ready sequences migrate with
        their KV pages; everything else (queued, mid-prefill) is
        re-dispatched; the replica ends retired with an empty engine."""
        for uid in list(r.engine.ready_uids()):
            # keep trying the rest on failure: a long sequence that fits
            # nowhere must not force shorter ones into full recompute
            self._try_migrate(uid, r)
        leftovers = r.engine.abort_all(reason="evacuate")
        r.retired = True
        self._clear_breaker_gauge(r)
        record_event("fleet_retire", cat="serve", replica=r.name,
                     redispatched=len(leftovers))
        for uid in leftovers:
            self._redispatch(uid)

    # -- disaggregation ------------------------------------------------------
    def _decode_targets(self, src: EngineReplica) -> List[EngineReplica]:
        return [r for r in self.replicas.values()
                if r is not src and r.accepts_new()
                and r.role in (ROLE_DECODE, ROLE_MIXED)]

    def _try_migrate(self, uid: int, src: EngineReplica) -> bool:
        rec = self._requests.get(uid)
        targets = sorted(self._decode_targets(src),
                         key=lambda r: (r.load(), r.name))
        for dst in targets:
            moved = migrate_sequence(src.engine, dst.engine, uid)
            if moved:
                if rec is not None:
                    rec.replica = dst.name
                self._m_migrations.inc()
                self._m_migrated_pages.inc(moved)
                record_event("fleet_migrate", cat="serve", uid=uid,
                             src=src.name, dst=dst.name, pages=moved,
                             **({} if rec is None or rec.trace_id is None
                                else {"trace_id": rec.trace_id}))
                return True
        self._m_migration_failures.inc()
        return False

    def _pump_migrations(self) -> None:
        """Stream decode-ready sequences off prefill-role replicas.
        Runs BEFORE the engines step, so a sequence whose prefill
        finished last pump never decodes on the prefill pool."""
        for r in self.replicas.values():
            if r.role != ROLE_PREFILL or not r.alive or r.retired:
                continue
            if not self._decode_targets(r):
                # decode pool gone: keep decoding here (mixed fallback)
                # without burning a migration-failure count per pump
                continue
            for uid in list(r.engine.ready_uids()):
                self._try_migrate(uid, r)

    # -- live decode rebalancing ---------------------------------------------
    def _hot_decode_replica(self, cands: List[EngineReplica]
                            ) -> Optional[EngineReplica]:
        """The replica rebalancing should relieve this pump, or None.
        Two signals, either suffices: **occupancy** — its load exceeds
        the coolest accepting peer's by more than
        ``rebalance_load_gap`` — or **latency** — its rolling p50
        exceeds ``rebalance_p50_factor`` x the median of its peers
        (the breaker's gray-failure signal at a LOWER threshold:
        rebalancing relieves a warm replica before the breaker
        declares it failed and recomputes everything)."""
        cfg = self.config
        by_load = sorted(cands, key=lambda r: (r.load(), r.name))
        hot = by_load[-1]
        if hot.load() - by_load[0].load() > cfg.rebalance_load_gap:
            return hot
        for r in sorted(cands, key=lambda x: -x.step_p50()):
            if r.lat_samples < cfg.breaker_min_samples:
                continue
            others = [o.step_p50() for o in cands if o is not r
                      and o.breaker != BREAKER_OPEN
                      and o.lat_samples >= cfg.breaker_min_samples]
            if not others:
                continue
            floor = max(statistics.median(others),
                        cfg.breaker_min_latency_s)
            if r.step_p50() > cfg.rebalance_p50_factor * floor:
                return r
        return None

    def _rebalance_decode(self) -> None:
        """Migrate RUNNING decode streams off a hot replica (the router
        historically only placed NEW work; this fixes placement after
        admission).  Bounded per pump, deadline-budget-aware (a stream
        with almost no budget left is never moved — the move costs
        time it doesn't have), and bit-identical by the migration
        contract: a moved stream is indistinguishable from one that
        stayed."""
        cfg = self.config
        cands = [r for r in self.replicas.values()
                 if r.alive and not r.retired
                 and r.role in (ROLE_DECODE, ROLE_MIXED)]
        if len(cands) < 2 or not any(r.accepts_new() for r in cands):
            return
        hot = self._hot_decode_replica(cands)
        if hot is None or not self._decode_targets(hot):
            return
        moved = 0
        for uid in list(hot.engine.ready_uids()):
            if moved >= cfg.rebalance_max_per_pump:
                break
            rec = self._requests.get(uid)
            left = rec.deadline_left() if rec is not None else None
            if left is not None and left < cfg.rebalance_min_deadline_s:
                self._m_rebalance_skipped.inc()
                continue
            if self._try_migrate(uid, hot):
                moved += 1
        if moved:
            self._m_rebalanced.inc(moved)
            record_event("fleet_rebalance", cat="serve", src=hot.name,
                         moved=moved, src_load=hot.load(),
                         src_p50_s=round(hot.step_p50(), 6))
            logger.info(f"fleet: rebalanced {moved} decode stream(s) "
                        f"off {hot.name}")

    # -- circuit breakers ----------------------------------------------------
    def _check_breakers(self) -> None:
        """Advance every live replica's breaker one pump.  The fleet
        signal for the latency rule is the median of the OTHER
        *same-role* replicas' rolling medians (open breakers and short
        windows excluded): prefill chunks and decode steps have
        different cost profiles, so cross-role comparison would trip
        healthy prefill replicas on a fleet of fast decoders.  A
        replica is only *relatively* slow — on a uniformly slow fleet
        (or a role with a single replica) the latency rule stays quiet
        and only consecutive step errors trip.  A trip drains the
        replica of new placement (its ``accepts_new`` goes False) and
        re-dispatches its in-flight streams through the bit-identical
        recompute path."""
        if not self.config.breaker_enabled:
            return
        live = [r for r in self.replicas.values()
                if r.alive and not r.retired]
        for r in live:
            others = [o.step_p50() for o in live
                      if o is not r and o.role == r.role
                      and o.breaker != BREAKER_OPEN
                      and o.lat_samples >= self.config.breaker_min_samples]
            med = statistics.median(others) if others else 0.0
            action = r.breaker_eval(med, self.config)
            if action == "trip":
                self._on_breaker_trip(r, med)
            elif action == "probe":
                record_event("breaker_probe", cat="serve", replica=r.name)
                logger.info(f"fleet: breaker half-open on {r.name} — "
                            "probing with live traffic")
            elif action == "recover":
                # dstpu-lint: allow[slo-exemplar] a recovery clears a
                # fault condition — there is no single offending request
                # whose trace_id could serve as the exemplar
                self._m_breaker_recover.inc()
                record_event("breaker_recover", cat="serve", replica=r.name)
                logger.info(f"fleet: breaker closed on {r.name} — "
                            "recovered after a healthy probe")
            self._m_breaker_state.set(_BREAKER_STATE_CODE[r.breaker],
                                      replica=r.name)

    def _on_breaker_trip(self, r: EngineReplica, fleet_median: float) -> None:
        self._m_breaker_trips.inc()
        lost = self._owned_uids(r.name)
        # the trip's exemplars are the streams it disrupted: every
        # in-flight request on the tripped replica links its trace
        for uid in lost:
            slo_exemplar("deepspeed_tpu_serving_slo_breaker_trips_total",
                         self._requests[uid].trace_id, replica=r.name,
                         uid=uid)
        record_event("breaker_trip", cat="serve", replica=r.name,
                     p50_s=round(r.step_p50(), 6),
                     p95_s=round(r.step_p95(), 6),
                     fleet_median_s=round(fleet_median, 6),
                     consec_errors=r.consec_errors, inflight=len(lost))
        logger.warning(
            f"fleet: breaker OPEN on {r.name} (median step "
            f"{r.step_p50() * 1e3:.1f}ms / p95 {r.step_p95() * 1e3:.1f}ms "
            f"vs fleet median {fleet_median * 1e3:.1f}ms, "
            f"{r.consec_errors} consecutive errors); draining placement, "
            f"re-dispatching {len(lost)} in-flight stream(s)")
        # free the degraded replica's queued + admitted work, then
        # re-run it elsewhere: greedy streams continue bit-identically
        # (prompt + emitted recompute, the replica-death contract)
        r.engine.abort_all(reason="breaker")
        for uid in lost:
            self._redispatch(uid)

    # -- the fleet pump ------------------------------------------------------
    def step(self) -> Dict[int, Dict[str, Any]]:
        """One pump: reap failures, evaluate breakers, migrate ready
        sequences, step every replica.  Returns ``{uid: {"tokens":
        [...], "done": bool}}`` keyed by router uids — the same shape as
        ``engine.step()`` (finished records carry ``finish_reason``)."""
        self._reap_dead()
        self._reap_preempted()
        self._check_breakers()
        if self.config.disaggregated:
            self._pump_migrations()
        if self.config.rebalance_enabled:
            self._rebalance_decode()
        out: Dict[int, Dict[str, Any]] = {}
        for r in self.replicas.values():
            if not (r.alive and not r.retired):
                continue
            try:
                stepped = r.step()
            except Exception as e:
                if not self.config.breaker_enabled:
                    raise
                # gray-failure tolerance: one replica's step fault must
                # not take the fleet down.  The error is recorded in the
                # replica's breaker window — consecutive faults trip the
                # breaker, which re-dispatches its streams.
                logger.warning(f"fleet: replica {r.name} step failed "
                               f"({e!r}); breaker evaluating "
                               f"({r.consec_errors} consecutive)")
                continue
            for uid, rec_out in stepped.items():
                rec = self._requests.get(uid)
                if rec is None:
                    continue
                rec.emitted.extend(rec_out["tokens"])
                if rec_out["done"]:
                    rec.done = True
                    rec.replica = None
                    rec.finish_reason = rec_out.get("finish_reason", "")
                merged = out.setdefault(uid, {"tokens": [], "done": False})
                merged["tokens"].extend(rec_out["tokens"])
                merged["done"] = rec_out["done"]
                if rec_out["done"]:
                    merged["finish_reason"] = rec.finish_reason
        self._publish()
        return out

    def run_all(self, requests: Sequence[RaggedRequest],
                max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Convenience: submit + pump to completion; returns full
        generations keyed by router uid (submission order)."""
        uids = [self.submit(r) for r in requests]
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        else:
            logger.warning("fleet run_all: max_steps reached with work "
                           "pending")
        return {u: list(self._requests[u].emitted) for u in uids}

    # -- lifecycle / observability ------------------------------------------
    def kill_replica(self, name: str) -> None:
        """Chaos hook: unannounced death; next ``step()`` re-dispatches."""
        self.replicas[name].kill()

    def add_replica(self, replica: EngineReplica) -> None:
        """Join a new replica to a RUNNING fleet (elastic scale-up, or
        a cross-process replica over a :class:`~.transport.
        RemoteEngineProxy`).  Same invariants as construction: unique
        name, identical page geometry — KV migration needs one
        geometry, and a remote engine advertises its page size at the
        transport handshake precisely so this check works unchanged."""
        if replica.name in self.replicas:
            raise ValueError(f"replica name {replica.name!r} already in "
                             "the fleet")
        if replica.engine.block.page_size != self._page_size:
            raise ValueError(
                f"replica {replica.name!r} page_size "
                f"{replica.engine.block.page_size} != fleet page_size "
                f"{self._page_size} — KV migration needs one geometry")
        self.replicas[replica.name] = replica
        self._m_replicas_added.inc()
        record_event("fleet_scale_up", cat="serve", replica=replica.name,
                     role=replica.role, fleet_size=len(self.replicas))
        logger.info(f"fleet: replica {replica.name} joined "
                    f"(role={replica.role}, fleet={len(self.replicas)})")
        self._publish()

    def retire_replica(self, name: str, migrate: bool = True) -> None:
        """Planned retirement.  ``migrate=True`` evacuates (KV migration
        + re-dispatch, nothing recomputed locally); ``migrate=False``
        drains in place — the engine finishes its admitted sequences and
        hands queued ones back for re-dispatch."""
        r = self.replicas[name]
        if not r.alive or r.retired:
            return
        if migrate:
            self._evacuate(r)
            return
        result = r.engine.drain(max_steps=self.config.drain_max_steps)
        self._m_drains.inc()
        unfinished: List[int] = []
        for uid, seq in result["finished"].items():
            rec = self._requests.get(uid)
            if rec is None:
                continue
            # seq.tokens = engine prompt + everything generated there;
            # the engine prompt already contained rec.emitted from hops
            # before this one
            new = seq.tokens[len(rec.request.prompt_ids) + len(rec.emitted):]
            rec.emitted.extend(int(t) for t in new)
            if seq.done:
                rec.done = True
                rec.replica = None
                rec.finish_reason = seq.finish_reason
            else:
                # drain hit drain_max_steps: the sequence is alive but
                # its replica is retiring — hand it elsewhere, else it
                # is stranded forever on a replica step() skips
                unfinished.append(uid)
        r.retired = True
        self._clear_breaker_gauge(r)
        if unfinished:
            # free the stragglers' pages/spans in the retiring engine
            # before re-running them elsewhere
            r.engine.abort_all(reason="drain_timeout")
        for uid in unfinished:
            self._redispatch(uid, charge=False)
        for seq in result["pending"]:
            self._redispatch(seq.uid, charge=False)
        self._publish()

    def request_state(self, uid: int) -> Dict[str, Any]:
        rec = self._requests[uid]
        return {"emitted": list(rec.emitted), "done": rec.done,
                "failed": rec.failed, "replica": rec.replica,
                "redispatches": rec.redispatches,
                "finish_reason": rec.finish_reason,
                "priority": rec.request.priority,
                "deadline_left_s": rec.deadline_left(),
                "trace_id": rec.trace_id}

    def health(self) -> Dict[str, Any]:
        return {name: r.health() for name, r in self.replicas.items()}


def fleet_params(model: Any, params: Any, dtype: Any, device: Any,
                 seed: int = 0) -> Any:
    """The one weight tree a fleet's replicas share, on ``device`` in the
    engines' ``dtype``: ``params`` None draws it from a ``torch.Generator``
    on ``device`` seeded with ``seed`` (as an engine given no weights
    does, so a process that draws with the same seed, device and dtype
    holds the same bits); a numpy tree is converted once; a
    :class:`ParamTree` already there in that dtype is used as it is, any
    other copied."""
    import torch

    from ..accelerator import resolve_device
    from ..models.convert import params_from_numpy
    from ..models.transformer import ParamTree
    from ..runtime.precision import cast_tree, cast_tree_copy

    device = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        return cast_tree(model.init_params(gen, device), dtype)
    if isinstance(params, dict):
        return params_from_numpy(params, model.config, device, dtype)
    if isinstance(params, ParamTree):
        return cast_tree_copy(params, dtype, device)
    raise TypeError(f"params must be a ParamTree or a numpy tree, not {type(params)}")


def build_fleet(model: Any, serving: Optional[ServingConfig] = None,
                engine_config: Any = None, params: Any = None,
                seed: int = 0, device: Any = None) -> FleetRouter:
    """Construct a disaggregated fleet over one weight copy.

    Prefill replicas get ``serving.prefill_chunk`` chunked prefill (when
    set); decode replicas keep the base engine config.  With
    ``disaggregated=False`` every replica is mixed and no migration runs.
    Every replica serves the one tree :func:`fleet_params` makes (two
    replicas of a model never hold two copies, unless ``quant_bits``
    quantizes a tree per engine).  ``device`` None means ``cuda``."""
    import dataclasses as _dc

    from ..inference.v2 import InferenceEngineV2, RaggedInferenceConfig

    serving = serving or ServingConfig()
    base = engine_config or RaggedInferenceConfig()
    if serving.speculative is not None:
        # fleet-wide speculative block overrides the engine config on
        # every replica: speculation is decode-phase-only and lossless
        # for greedy streams, so uniform application preserves the
        # migration / re-dispatch bit-identity contract as-is
        base = _dc.replace(base, speculative=serving.speculative)
    if serving.kv_tier is not None:
        # fleet-wide tiered KV cache: spill/restore is bit-identical by
        # contract, so uniform application likewise preserves the
        # migration / re-dispatch bit-identity (each replica owns its
        # own host LRU — spilled pages are replica-local, like the
        # device prefix cache they extend)
        base = _dc.replace(base, kv_tier=serving.kv_tier)
    if serving.decode_horizon is not None:
        # fleet-wide fused multi-step decode: horizons are
        # stream-identical by contract, so uniform application keeps
        # migration / re-dispatch bit-identity trivially (speculative
        # replicas stand the horizon down themselves)
        base = _dc.replace(base, decode_horizon=serving.decode_horizon)
    base.validate()
    params = fleet_params(model, params, base.torch_dtype, device, seed)

    def engine(cfg):
        return InferenceEngineV2(model, cfg, params=params, seed=seed, device=device)

    replicas: List[EngineReplica] = []
    if serving.disaggregated:
        pf_cfg = base
        if serving.prefill_chunk > 0:
            pf_cfg = _dc.replace(base, prefill_chunk=serving.prefill_chunk)
        for i in range(serving.prefill_replicas):
            replicas.append(EngineReplica(
                f"prefill{i}", engine(pf_cfg),
                role=ROLE_PREFILL, breaker_window=serving.breaker_window))
        for i in range(serving.decode_replicas):
            replicas.append(EngineReplica(
                f"decode{i}", engine(base),
                role=ROLE_DECODE, breaker_window=serving.breaker_window))
    else:
        for i in range(serving.prefill_replicas + serving.decode_replicas):
            replicas.append(EngineReplica(
                f"replica{i}", engine(base),
                role=ROLE_MIXED, breaker_window=serving.breaker_window))
    return FleetRouter(replicas, serving)

__all__ = ["FleetRouter", "build_fleet", "fleet_params", "affinity_key", "hrw_score",
           "pick_replica"]
