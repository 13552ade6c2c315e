"""The ``serving`` config blocks (the port's counterpart of
``deepspeed_tpu/serving/config.py``).

Only :class:`KVTierConfig` is ported: the block ``RaggedInferenceConfig``
takes as ``kv_tier``.  ``TransportConfig``, ``AutoscaleConfig`` and
``ServingConfig`` (the fleet above the engines) come with the serving
fleet, ROADMAP Queue 1 #15 ('Serving fleet').
"""

from __future__ import annotations

import dataclasses

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
