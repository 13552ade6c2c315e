"""Optimized / LoRA linear layers (the port's counterpart of
``deepspeed_tpu/linear``)."""
