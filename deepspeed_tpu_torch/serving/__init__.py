"""Serving above the ``inference/v2`` engines (the port's counterpart of
``deepspeed_tpu/serving``): the front tier — a router with
prefix-cache-affinity placement, prefill/decode disaggregation with
KV-page migration, replica lifecycle handling (drain / health /
re-dispatch on death or preemption, circuit breakers), the cross-process
KV transport and the autoscaler — with admission control, the host and
NVMe KV tiers and the KV-page transfer between engines.

The config blocks, admission, the KV tier and the transfer import
eagerly; the router, replica, transport and autoscaler load lazily, by
the JAX package's export table.
"""

from .admission import (AdmissionController, estimate_pages, record_shed,  # noqa: F401
                        retry_after_hint, shed_counter)
from .config import (AutoscaleConfig, KVTierConfig, ServingConfig,  # noqa: F401
                     TransportConfig)
from .kv_tier import HostKVTier, NVMeKVTier, batch_page_crcs, page_slices  # noqa: F401
from .kv_transfer import (CorruptBundleError, bundle_from_bytes,  # noqa: F401
                          bundle_to_bytes, migrate_sequence, page_crcs, pages_from_bytes,
                          pages_to_bytes, rebase_deadline_left)

_LAZY = {
    "FleetRouter": "router", "build_fleet": "router", "fleet_params": "router",
    "affinity_key": "router", "hrw_score": "router",
    "pick_replica": "router",
    "EngineReplica": "replica", "ROLE_PREFILL": "replica",
    "ROLE_DECODE": "replica", "ROLE_MIXED": "replica",
    "BREAKER_CLOSED": "replica", "BREAKER_OPEN": "replica",
    "BREAKER_HALF_OPEN": "replica",
    "RejectedError": "admission",
    "EngineServer": "transport", "RemoteEngineProxy": "transport",
    "BundleSender": "transport", "pipelined_migrate": "transport",
    "spawn_engine_server": "transport", "TransportError": "transport",
    "FleetAutoscaler": "autoscale",
}

__all__ = ["AdmissionController", "estimate_pages", "record_shed", "retry_after_hint",
           "shed_counter", "ServingConfig", "KVTierConfig", "AutoscaleConfig",
           "TransportConfig", "HostKVTier", "NVMeKVTier", "page_slices", "batch_page_crcs",
           "CorruptBundleError", "bundle_from_bytes", "bundle_to_bytes", "migrate_sequence",
           "page_crcs", "pages_from_bytes", "pages_to_bytes",
           "rebase_deadline_left"] + sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
