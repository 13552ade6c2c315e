"""Serving above the ``inference/v2`` engines (the port's counterpart of
``deepspeed_tpu/serving``): what is ported so far is the KV tier, the
KV-page transfer between engines and admission control's shed policy.
The fleet router, replicas, transport and autoscaling come with ROADMAP
Queue 1 #15 ('Serving fleet').
"""

from .admission import (AdmissionController, estimate_pages, record_shed,  # noqa: F401
                        retry_after_hint, shed_counter)
from .config import KVTierConfig  # noqa: F401
from .kv_tier import HostKVTier, NVMeKVTier, batch_page_crcs, page_slices  # noqa: F401
from .kv_transfer import (CorruptBundleError, bundle_from_bytes,  # noqa: F401
                          bundle_to_bytes, migrate_sequence, page_crcs, pages_from_bytes,
                          pages_to_bytes, rebase_deadline_left)

__all__ = ["AdmissionController", "estimate_pages", "record_shed", "retry_after_hint",
           "shed_counter", "KVTierConfig", "HostKVTier", "NVMeKVTier", "page_slices", "batch_page_crcs",
           "CorruptBundleError", "bundle_from_bytes", "bundle_to_bytes", "migrate_sequence",
           "page_crcs", "pages_from_bytes", "pages_to_bytes", "rebase_deadline_left"]
