"""The ``serving`` config blocks (the port's counterpart of
``deepspeed_tpu/serving/config.py``): the multi-replica fleet front tier.

Parsed by ``runtime/config.py`` like every other block (a top-level
``"serving"`` key in the ds-config json) and consumed by
``serving/router.py``'s :class:`FleetRouter` / ``build_fleet``.  The
per-engine knobs (page pool geometry, chunked prefill, prefix cache) stay
in ``RaggedInferenceConfig``; these blocks describe the fleet above the
engines (pool sizes, routing policy, failure handling), the cross-process
KV transport and the autoscaler, with the JAX package's fields, defaults
and messages.  :class:`KVTierConfig` is the block ``RaggedInferenceConfig``
takes as ``kv_tier``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..inference.v2.speculative import SpeculativeConfig
from ..runtime.config_utils import ConfigModel


@dataclasses.dataclass
class KVTierConfig(ConfigModel):
    """Tiered KV cache: host-RAM spill and restore of cold prefix-cache
    pages (``serving/kv_tier.py``).

    Pages evicted from the device prefix-cache LRU are captured into a
    byte-budgeted host LRU keyed by the prefix cache's chain keys, in the
    pool's exact dtype (int8 codes and fp32 scales under ``kv_quant``),
    and restored, CRC-verified and bit-identical, when a later request's
    prefix walks past the device hit."""

    enabled: bool = False
    #: byte budget for spilled pages resident in host RAM (LRU beyond it)
    host_bytes: int = 1 << 30
    #: bound on pages pinned awaiting their copy to the host (drained at
    #: step boundaries); evictions past it are not captured
    spill_inflight: int = 64
    #: queued requests whose host-tier restores are prefetched each step
    #: (0 = admission-time restore only)
    prefetch_requests: int = 1
    #: NVMe tier under the host LRU: pages the host LRU evicts are written
    #: as one DSTPUKV2 page record per file under ``nvme_dir`` instead of
    #: dropped, and a host miss reads them back, CRC-verified
    nvme_enabled: bool = False
    #: directory of the page files; empty = a per-tier mkdtemp
    nvme_dir: str = ""
    #: byte budget for page files on disk (LRU beyond it)
    nvme_bytes: int = 16 << 30

    def validate(self) -> None:
        if self.host_bytes < 0:
            raise ValueError("kv_tier.host_bytes must be >= 0")
        if self.spill_inflight < 1:
            raise ValueError("kv_tier.spill_inflight must be >= 1")
        if self.prefetch_requests < 0:
            raise ValueError("kv_tier.prefetch_requests must be >= 0")
        if self.nvme_bytes < 0:
            raise ValueError("kv_tier.nvme_bytes must be >= 0")


@dataclasses.dataclass
class TransportConfig(ConfigModel):
    """Cross-process KV transport (``serving/transport.py``): socket
    framing + the sender's bounded connect/send retry policy.  The
    backoff schedule mirrors the ``resilience/`` elastic-agent policy
    (exponential, capped, seeded jitter) so a dead peer costs a BOUNDED
    number of connect attempts — never an infinite reconnect loop."""

    #: bounded connect/reconnect attempts before the transport gives up
    #: (the caller keeps the pages — a dead peer loses nothing)
    connect_retries: int = 5
    #: exponential backoff between attempts: base * 2^(attempt-1),
    #: capped at max, times (1 + jitter * seeded_uniform)
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    backoff_jitter: float = 0.25
    #: per-frame send/recv socket timeout (seconds); a peer that stalls
    #: longer than this mid-frame tears the connection instead of
    #: wedging the sender thread forever
    io_timeout_s: float = 30.0
    #: bounded depth of the async sender's in-flight queue (2 = double
    #: buffering: bundle N on the wire while N+1 serializes)
    sender_depth: int = 2

    def validate(self) -> None:
        if self.connect_retries < 1:
            raise ValueError("transport.connect_retries must be >= 1")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("transport backoff seconds must be >= 0")
        if self.backoff_jitter < 0:
            raise ValueError("transport.backoff_jitter must be >= 0")
        if self.io_timeout_s <= 0:
            raise ValueError("transport.io_timeout_s must be > 0")
        if self.sender_depth < 1:
            raise ValueError("transport.sender_depth must be >= 1")


@dataclasses.dataclass
class AutoscaleConfig(ConfigModel):
    """Elastic fleet sizing (``serving/autoscale.py``): grow/shrink the
    replica count from queue-depth / TTFT-violation signals, reusing
    the drain/evacuation machinery so scale-down never drops a stream."""

    enabled: bool = False
    #: replica-count bounds the policy may move between
    min_replicas: int = 1
    max_replicas: int = 4
    #: grow when fleet queue depth per accepting replica exceeds this
    #: for ``grow_streak`` consecutive pump evaluations
    grow_queue_per_replica: float = 4.0
    grow_streak: int = 2
    #: grow when NEW TTFT deadline violations appeared since the last
    #: evaluation (0 disables the TTFT rule)
    grow_on_ttft_violations: bool = True
    #: shrink when the fleet has been under this queue-depth-per-replica
    #: for ``shrink_streak`` consecutive evaluations AND the candidate
    #: replica is idle enough to evacuate cheaply
    shrink_queue_per_replica: float = 0.5
    shrink_streak: int = 8
    #: pump evaluations to wait after ANY scale action before the next
    #: (hysteresis — a fresh replica needs time to absorb load)
    cooldown_pumps: int = 8

    def validate(self) -> None:
        if self.min_replicas < 1:
            raise ValueError("autoscale.min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("autoscale.max_replicas must be >= "
                             "min_replicas")
        if self.grow_queue_per_replica <= 0:
            raise ValueError("autoscale.grow_queue_per_replica must be > 0")
        if self.shrink_queue_per_replica < 0:
            raise ValueError("autoscale.shrink_queue_per_replica must "
                             "be >= 0")
        if self.shrink_queue_per_replica >= self.grow_queue_per_replica:
            raise ValueError("autoscale.shrink_queue_per_replica must be "
                             "< grow_queue_per_replica (hysteresis band)")
        if self.grow_streak < 1 or self.shrink_streak < 1:
            raise ValueError("autoscale grow/shrink streaks must be >= 1")
        if self.cooldown_pumps < 0:
            raise ValueError("autoscale.cooldown_pumps must be >= 0")


@dataclasses.dataclass
class ServingConfig(ConfigModel):
    """Fleet topology + routing policy (docs/SERVING.md "Fleet
    serving")."""

    enabled: bool = False
    #: replicas that admit new requests and run (chunked) prefill
    prefill_replicas: int = 1
    #: replicas that continue decoding migrated sequences
    decode_replicas: int = 2
    #: prefill/decode disaggregation: ready sequences stream their KV
    #: pages from prefill to decode replicas.  False = one mixed pool of
    #: ``prefill_replicas + decode_replicas`` replicas, no migration.
    disaggregated: bool = True
    #: prompt pages hashed into the affinity key (the prefix cache's content-hash
    #: chain): more pages = finer-grained placement, fewer = broader
    #: prefix families co-located on one replica's prefix cache
    affinity_pages: int = 4
    #: least-loaded fallback threshold: the affinity choice is overridden
    #: when its load exceeds the least-loaded candidate's by MORE than
    #: this many requests (queue depth + occupied slots)
    load_gap: int = 4
    #: give up re-running a request after this many replica losses
    max_redispatch: int = 3
    #: chunked prefill size for prefill-pool replicas (tokens, rounded up
    #: to page_size by the engine); 0 = inherit the engine config
    prefill_chunk: int = 0
    #: step budget for ``InferenceEngineV2.drain`` during retirement
    drain_max_steps: int = 10_000
    #: fleet-wide speculative decoding (inference/v2/speculative.py):
    #: applied by ``build_fleet`` to EVERY replica's engine config
    #: (speculation only touches the decode phase and is lossless for
    #: greedy streams, so uniform application keeps migration /
    #: re-dispatch bit-identity trivially).  None = inherit whatever the
    #: base engine config says
    speculative: Optional[SpeculativeConfig] = None
    #: fleet-wide tiered KV cache (serving/kv_tier.py): applied by
    #: ``build_fleet`` to EVERY replica's engine config (spill/restore
    #: is bit-identical by contract, so uniform application keeps
    #: migration / re-dispatch bit-identity trivially).  None = inherit
    #: whatever the base engine config says
    kv_tier: Optional[KVTierConfig] = None
    #: fleet-wide fused multi-step decode horizon (docs/SERVING.md
    #: "Multi-step decode"): applied by ``build_fleet`` to EVERY
    #: replica's engine config.  Decode horizons are stream-identical
    #: by contract (greedy and sampled alike), so uniform application
    #: keeps migration / re-dispatch bit-identity trivially; replicas
    #: with speculative decoding enabled stand the horizon down on
    #: their own (one exclusive decode path at a time).  None =
    #: inherit whatever the base engine config says
    decode_horizon: Optional[int] = None

    # -- admission control & load shedding (serving/admission.py) -----------
    #: fleet-wide bounded queue: submissions are shed (RejectedError
    #: with a retry-after hint) once this many requests wait for
    #: admission across accepting replicas; 0 = unbounded
    max_queue_depth: int = 0
    #: KV-pool shed threshold: shed when even the coolest accepting
    #: replica's projected occupancy (current used pages + the request's
    #: estimated page cost) exceeds this fraction; 0.0 = off
    shed_occupancy: float = 0.0
    #: priority classes <= this value are NEVER shed by the rules above
    #: (they fail only when no live replica exists).  Default 0 protects
    #: exactly PRIORITY_INTERACTIVE.
    protect_priority: int = 0

    # -- replica circuit breakers (serving/replica.py state machine) --------
    #: detect gray failure: a replica whose rolling MEDIAN step latency
    #: (sustained — compile/GC spikes lift only the tail and never
    #: trip) exceeds ``breaker_latency_factor`` x the fleet median of
    #: the OTHER replicas, or which throws ``breaker_consec_errors``
    #: step exceptions in a row, trips open: drained of new placement,
    #: its in-flight streams re-dispatched (bit-identical recompute)
    breaker_enabled: bool = True
    breaker_latency_factor: float = 3.0
    breaker_consec_errors: int = 3
    #: rolling step-latency window length and the samples required
    #: before the latency rule may trip (noise floor)
    breaker_window: int = 32
    breaker_min_samples: int = 8
    #: latency floor (seconds): the fleet median is clamped up to this
    #: before the factor comparison, so microsecond-fast idle fleets
    #: don't trip on scheduler jitter
    breaker_min_latency_s: float = 0.005
    #: router pumps an open breaker waits before probing (half-open),
    #: and the healthy steps a half-open replica must serve to close
    breaker_cooldown_pumps: int = 8
    breaker_probe_steps: int = 4

    # -- live decode rebalancing (router._rebalance_decode) -----------------
    #: migrate DECODE load off hot replicas continuously (today's router
    #: only places NEW work; this moves RUNNING streams).  Bit-identity
    #: is the migration contract, so a moved stream is indistinguishable
    #: from one that stayed.
    rebalance_enabled: bool = False
    #: act when the hottest replica's load exceeds the coolest accepting
    #: peer's by MORE than this many requests
    rebalance_load_gap: int = 4
    #: also act when a replica's rolling p50 step latency exceeds this
    #: factor x the fleet median of its peers (keep BELOW
    #: breaker_latency_factor so rebalancing relieves a warm replica
    #: before the breaker declares it failed)
    rebalance_p50_factor: float = 2.0
    #: sequences moved per router pump (small: each migration steals a
    #: step slot from the destination)
    rebalance_max_per_pump: int = 2
    #: deadline awareness: a sequence with less than this many seconds
    #: of deadline budget left is never migrated (the move itself costs
    #: time the stream doesn't have)
    rebalance_min_deadline_s: float = 0.5

    #: elastic replica scaling policy (serving/autoscale.py); None =
    #: fixed fleet size
    autoscale: Optional[AutoscaleConfig] = None
    #: cross-process KV transport knobs (serving/transport.py); None =
    #: defaults (the transport is only exercised by cross-process
    #: replicas — single-process fleets never open a socket)
    transport: Optional[TransportConfig] = None

    def validate(self) -> None:
        if isinstance(self.speculative, dict):
            # Optional[...] coercion swallows nested validation errors
            # (the Union branch treats them as "try the next type"); an
            # invalid speculative block must fail HERE, not at engine
            # construction
            self.speculative = SpeculativeConfig.from_dict(self.speculative)
        if isinstance(self.kv_tier, dict):
            # same Optional[...] coercion hazard as speculative above:
            # an invalid kv_tier block must fail HERE with its own error
            self.kv_tier = KVTierConfig.from_dict(self.kv_tier)
        if self.kv_tier is not None:
            self.kv_tier.validate()
        if isinstance(self.autoscale, dict):
            # same Optional[...] coercion hazard: fail HERE, loudly
            self.autoscale = AutoscaleConfig.from_dict(self.autoscale)
        if self.autoscale is not None:
            self.autoscale.validate()
        if isinstance(self.transport, dict):
            self.transport = TransportConfig.from_dict(self.transport)
        if self.transport is not None:
            self.transport.validate()
        if self.decode_horizon is not None and self.decode_horizon < 1:
            raise ValueError("serving.decode_horizon must be >= 1 "
                             "(1 = the classic one-step decode loop)")
        if self.prefill_replicas < 0 or self.decode_replicas < 0:
            raise ValueError("serving replica counts must be >= 0")
        if self.prefill_replicas + self.decode_replicas < 1:
            raise ValueError("serving needs at least one replica")
        if self.disaggregated and self.enabled and (
                self.prefill_replicas < 1 or self.decode_replicas < 1):
            raise ValueError(
                "serving.disaggregated needs >= 1 prefill AND >= 1 decode "
                "replica (set disaggregated=false for a mixed pool)")
        if self.affinity_pages < 1:
            raise ValueError("serving.affinity_pages must be >= 1")
        if self.load_gap < 1:
            raise ValueError("serving.load_gap must be >= 1")
        if self.max_redispatch < 0:
            raise ValueError("serving.max_redispatch must be >= 0")
        if self.drain_max_steps < 1:
            raise ValueError("serving.drain_max_steps must be >= 1")
        if self.max_queue_depth < 0:
            raise ValueError("serving.max_queue_depth must be >= 0")
        if not 0.0 <= self.shed_occupancy <= 1.0:
            raise ValueError("serving.shed_occupancy must be in [0, 1] "
                             "(0 disables the pool-pressure shed rule)")
        if self.protect_priority < 0:
            raise ValueError("serving.protect_priority must be >= 0")
        if self.breaker_latency_factor <= 1.0:
            raise ValueError("serving.breaker_latency_factor must be > 1")
        if self.breaker_consec_errors < 1:
            raise ValueError("serving.breaker_consec_errors must be >= 1")
        if self.breaker_window < 2 or self.breaker_min_samples < 2:
            raise ValueError("serving.breaker_window and "
                             "breaker_min_samples must be >= 2")
        if self.breaker_min_samples > self.breaker_window:
            raise ValueError("serving.breaker_min_samples must be <= "
                             "breaker_window")
        if self.breaker_min_latency_s < 0:
            raise ValueError("serving.breaker_min_latency_s must be >= 0")
        if self.breaker_cooldown_pumps < 1 or self.breaker_probe_steps < 1:
            raise ValueError("serving.breaker_cooldown_pumps and "
                             "breaker_probe_steps must be >= 1")
        if self.rebalance_load_gap < 1:
            raise ValueError("serving.rebalance_load_gap must be >= 1")
        if self.rebalance_p50_factor <= 1.0:
            raise ValueError("serving.rebalance_p50_factor must be > 1")
        if self.rebalance_enabled and self.breaker_enabled and (
                self.rebalance_p50_factor >= self.breaker_latency_factor):
            raise ValueError(
                "serving.rebalance_p50_factor must be < "
                "breaker_latency_factor (rebalance relieves a warm "
                "replica BEFORE the breaker declares it failed)")
        if self.rebalance_max_per_pump < 1:
            raise ValueError("serving.rebalance_max_per_pump must be >= 1")
        if self.rebalance_min_deadline_s < 0:
            raise ValueError("serving.rebalance_min_deadline_s must "
                             "be >= 0")



__all__ = ["ServingConfig", "KVTierConfig", "AutoscaleConfig",
           "TransportConfig"]
