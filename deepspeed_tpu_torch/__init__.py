"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

Module paths mirror the JAX package (``deepspeed_tpu/inference/v2/
model_runner.py`` has its counterpart at ``deepspeed_tpu_torch/inference/
v2/model_runner.py``).  The port imports ``torch`` and numpy only: never
JAX and nothing of ``deepspeed_tpu``.

What is ported.  Serving: :class:`InferenceEngineV2` (paged
continuous batching) over a llama-family transformer, with hand-written
CUDA kernels for flash-attention forward (prefill) and paged decode
attention, and weight-only int8/int4 weights (``quant_bits``) through the
``wq_matmul`` kernel.  MoE serving: mixtral models (``models/mixtral.py``)
through both serving engines, the dropless layer's expert matmuls through
the ``grouped_matmul`` kernel.  Training on one device: :func:`initialize` returns a
:class:`DeepSpeedTPUEngine` whose ``train_batch`` runs the model forward
through the flash kernel, the backward through the flash dQ and dK/dV
kernels, and AdamW through the fused-Adam kernel; ZeRO-Offload keeps the
fp32 master and the moments in host RAM (or on NVMe) and updates them with
the host C++ optimizers, and the hybrid engine generates with the training
weights.  Dense-cache inference:
:func:`init_inference` returns an :class:`InferenceEngine` (``generate``,
``forward``, ``module_quantize`` through the int8 quantize/dequantize
kernels).  Model families: llama, mixtral, mistral, qwen2, phi, opt,
falcon, bloom, gpt-neox, gpt2 and BERT (``models/``); Hugging Face
checkpoint directories load through ``checkpoint/hf_import.py`` (and
``init_inference(<dir>)``, ``InferenceEngineV2.from_pretrained(<dir>)``)
and are written by ``checkpoint/hf_export.py``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a CUDA device they raise.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

from .accelerator import DeviceLike, get_accelerator
from .inference.engine import InferenceConfig, InferenceEngine
from .runtime.config import DeepSpeedConfig
from .runtime.engine import DeepSpeedTPUEngine, TrainState
from .runtime.module import ModelSpec

__version__ = "0.2.0"
__all__ = ["initialize", "init_inference", "default_inference_config", "DeepSpeedConfig",
           "DeepSpeedTPUEngine", "TrainState", "ModelSpec", "InferenceConfig",
           "InferenceEngine", "add_config_arguments", "get_accelerator"]


def initialize(args: Any = None, model: Any = None, optimizer: Any = None,
               model_parameters: Any = None, training_data: Any = None,
               lr_scheduler: Any = None, config: Any = None, config_params: Any = None,
               device: DeviceLike = None, seed: Optional[int] = None
               ) -> Tuple[DeepSpeedTPUEngine, Any, Any, Any]:
    """Create a training engine (``deepspeed_tpu.initialize``).

    Returns ``(engine, optimizer, dataloader, lr_scheduler)``: the optimizer
    and scheduler are the engine's own handles; the dataloader is the
    engine's ``training_dataloader`` over ``training_data`` (an indexable
    dataset such as ``runtime/data_pipeline/indexed_dataset.
    MMapIndexedDataset``), or None, and ``engine.train_batch()`` with no
    batch draws from it.

    ``hybrid_engine.enabled`` returns a ``DeepSpeedHybridEngine``, whose
    ``generate`` reads the training engine's live weights.  An enabled
    ``elasticity`` block sets the batch size, micro batch and gradient
    accumulation for the world size (one rank), and refuses batch sizes
    given beside it unless ``ignore_non_elastic_batch_info``.

    ``model_parameters``, when given, is what the engine trains instead of
    the model's random init: a JAX-layout tree of numpy arrays or a port
    ``ParamTree``, adopted leaf for leaf as the fp32 master.  ``device``
    None means ``cuda``."""
    config = config if config is not None else config_params
    if config is None and args is not None and hasattr(args, "deepspeed_config"):
        config = args.deepspeed_config
    ds_config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
    if ds_config.elasticity.enabled:
        # the batch sizes derived from the world size keep the global batch
        # across restarts at another scale; the engine trains on one rank
        from .elasticity.elasticity import apply_elastic_config
        from .utils.logging import logger

        info = apply_elastic_config(ds_config, world_size=1)
        logger.info(f"elasticity: world=1 -> train_batch={ds_config.train_batch_size} "
                    f"micro={info['micro_batch_per_gpu']} "
                    f"gas={info['gradient_accumulation_steps']}")
    cls = DeepSpeedTPUEngine
    if ds_config.hybrid_engine.enabled:
        from .runtime.hybrid_engine import DeepSpeedHybridEngine

        cls = DeepSpeedHybridEngine
    engine = cls(model=model, config=ds_config, model_parameters=model_parameters,
                 lr_scheduler=lr_scheduler, client_optimizer=optimizer, device=device,
                 seed=seed, training_data=training_data)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


def init_inference(model: Any = None, config: Any = None, device: DeviceLike = None,
                   **kwargs: Any) -> InferenceEngine:
    """Create a dense-cache inference engine (``deepspeed_tpu.init_inference``).

    ``config``: an :class:`InferenceConfig` or a dict of its fields; keyword
    arguments naming a field override it, and ``params`` hands the engine
    its weights (a ``ParamTree`` or a JAX-layout numpy tree).  ``device``
    None means ``cuda``.  ``model`` may be a Hugging Face checkpoint
    directory: its ``config.json`` picks the family, and its weights are
    imported in the config's dtype and served."""
    cfg = config if isinstance(config, InferenceConfig) else InferenceConfig.from_dict(
        config if isinstance(config, dict) else {})
    for k, v in kwargs.items():
        if hasattr(cfg, k):
            setattr(cfg, k, v)
    cfg.validate()
    params = kwargs.get("params")
    if isinstance(model, str) and os.path.isdir(model):
        from .checkpoint.hf_import import load_hf_model
        from .models.families import causal_lm_spec

        mcfg, params = load_hf_model(model, dtype=cfg.torch_dtype)
        model = causal_lm_spec(mcfg)
    return InferenceEngine(model, cfg, params=params, device=device)


def default_inference_config() -> Dict[str, Any]:
    """The default inference config as a dict, to edit and pass back to
    :func:`init_inference`."""
    return InferenceConfig().to_dict()


def add_config_arguments(parser):
    """Add the standard flags to an argparse parser (the JAX package's
    ``add_config_arguments``: ``--deepspeed``, ``--deepspeed_config``,
    ``--local_rank``)."""
    group = parser.add_argument_group("DeepSpeed-TPU", "DeepSpeed-TPU configuration")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed-TPU")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to the config JSON")
    group.add_argument("--local_rank", type=int, default=0,
                       help="Local process index (set by the launcher)")
    return parser
