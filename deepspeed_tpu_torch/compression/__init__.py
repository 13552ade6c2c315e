"""Model compression (the port's counterpart of ``deepspeed_tpu/
compression``): quantization-aware training, magnitude and structured
pruning, layer reduction and the redundancy clean, as functions over a
parameter tree (``compress.py``)."""

from .compress import (CompressionScheduler, LayerReductionConfig, PruneConfig,
                       QuantizeConfig, StructuredPruneConfig, distillation_loss, fake_quantize,
                       init_compression, prune_mask, redundancy_clean, student_initialization)

__all__ = ["CompressionScheduler", "LayerReductionConfig", "PruneConfig", "QuantizeConfig",
           "StructuredPruneConfig", "distillation_loss", "fake_quantize", "init_compression",
           "prune_mask", "redundancy_clean", "student_initialization"]
