"""Serving above the ``inference/v2`` engines (the port's counterpart of
``deepspeed_tpu/serving``): what is ported so far is the KV tier and the
KV-page transfer between engines.  The fleet router, replicas,
transport, admission and autoscaling come with ROADMAP Queue 1 #15
('Serving fleet').
"""

from .config import KVTierConfig  # noqa: F401
from .kv_tier import HostKVTier, NVMeKVTier, batch_page_crcs, page_slices  # noqa: F401
from .kv_transfer import (CorruptBundleError, bundle_from_bytes,  # noqa: F401
                          bundle_to_bytes, migrate_sequence, page_crcs, pages_from_bytes,
                          pages_to_bytes, rebase_deadline_left)

__all__ = ["KVTierConfig", "HostKVTier", "NVMeKVTier", "page_slices", "batch_page_crcs",
           "CorruptBundleError", "bundle_from_bytes", "bundle_to_bytes", "migrate_sequence",
           "page_crcs", "pages_from_bytes", "pages_to_bytes", "rebase_deadline_left"]
