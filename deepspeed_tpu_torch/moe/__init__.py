"""Mixture-of-Experts layers (the port's counterpart of ``deepspeed_tpu/moe``)."""
