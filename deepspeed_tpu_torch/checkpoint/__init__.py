"""Checkpoint I/O (the port's counterpart of ``deepspeed_tpu/checkpoint/``):
Hugging Face checkpoint directories in (``hf_import``) and out
(``hf_export``)."""
