"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

Module paths mirror the JAX package (``deepspeed_tpu/inference/v2/
model_runner.py`` has its counterpart at ``deepspeed_tpu_torch/inference/
v2/model_runner.py``).  The port imports ``torch`` and numpy only: never
JAX and nothing of ``deepspeed_tpu``.

The first slice is the serving path: :class:`InferenceEngineV2` (paged
continuous batching) over a llama-family transformer, with two
hand-written CUDA kernels — flash-attention forward for prefill and paged
decode attention.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a CUDA device they raise.
"""

__version__ = "0.1.0"
