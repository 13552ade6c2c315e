"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

Module paths mirror the JAX package (``deepspeed_tpu/inference/v2/
model_runner.py`` has its counterpart at ``deepspeed_tpu_torch/inference/
v2/model_runner.py``).  The port imports ``torch`` and numpy only: never
JAX and nothing of ``deepspeed_tpu``.

Two slices are ported.  Serving: :class:`InferenceEngineV2` (paged
continuous batching) over a llama-family transformer, with hand-written
CUDA kernels for flash-attention forward (prefill) and paged decode
attention.  Training on one device: :func:`initialize` returns a
:class:`DeepSpeedTPUEngine` whose ``train_batch`` runs the model forward
through the flash kernel, the backward through the flash dQ and dK/dV
kernels, and AdamW through the fused-Adam kernel.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; without a CUDA device
they raise.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from .accelerator import DeviceLike
from .runtime.config import DeepSpeedConfig
from .runtime.engine import DeepSpeedTPUEngine, TrainState
from .runtime.module import ModelSpec

__version__ = "0.2.0"
__all__ = ["initialize", "DeepSpeedConfig", "DeepSpeedTPUEngine", "TrainState", "ModelSpec"]


def initialize(args: Any = None, model: Any = None, optimizer: Any = None,
               model_parameters: Any = None, training_data: Any = None,
               lr_scheduler: Any = None, config: Any = None, config_params: Any = None,
               device: DeviceLike = None, seed: Optional[int] = None
               ) -> Tuple[DeepSpeedTPUEngine, Any, None, Any]:
    """Create a training engine (``deepspeed_tpu.initialize``).

    Returns ``(engine, optimizer, None, lr_scheduler)``: the optimizer and
    scheduler are the engine's own handles, and no dataloader is built (the
    data pipeline is not ported; pass batches to ``train_batch``).

    ``model_parameters``, when given, is what the engine trains instead of
    the model's random init: a JAX-layout tree of numpy arrays or a port
    ``ParamTree``, adopted leaf for leaf as the fp32 master.  ``device``
    None means ``cuda``."""
    config = config if config is not None else config_params
    if config is None and args is not None and hasattr(args, "deepspeed_config"):
        config = args.deepspeed_config
    if training_data is not None:
        raise NotImplementedError("training_data: the data pipeline is not ported yet "
                                  "(ROADMAP Queue 1 #17 'Remaining modules'); pass batches "
                                  "to engine.train_batch")
    ds_config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
    engine = DeepSpeedTPUEngine(model=model, config=ds_config,
                                model_parameters=model_parameters, lr_scheduler=lr_scheduler,
                                client_optimizer=optimizer, device=device, seed=seed)
    return engine, engine.optimizer, None, engine.lr_scheduler
