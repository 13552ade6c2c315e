"""Inference v2: paged continuous batching (the port's counterpart of
``deepspeed_tpu/inference/v2``)."""

from .engine_v2 import InferenceEngineV2, RaggedInferenceConfig, RaggedRequest  # noqa: F401
from .speculative import DraftModelProposer, NgramProposer, SpeculativeConfig  # noqa: F401
from .ragged import (PRIORITY_BATCH, PRIORITY_INTERACTIVE,  # noqa: F401
                     PRIORITY_NORMAL, BlockAllocator, KVBlockConfig,
                     PagedKVCache, RejectedError)
