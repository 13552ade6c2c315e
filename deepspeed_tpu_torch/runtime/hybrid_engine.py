"""Hybrid engine: training and generation on one copy of the weights — the
counterpart of ``deepspeed_tpu/runtime/hybrid_engine.py``.

During RLHF the actor model alternates between training steps and
generation.  ``generate`` hands the training engine's live compute-dtype
leaves to a cached dense-cache :class:`~..inference.engine.InferenceEngine`
(``cast_tree`` to the same dtype keeps each tensor as it is), so no second
copy of the weights exists: under offload those leaves are the only
weights on the card, and every training step's update is what the next
generation reads.
"""

from __future__ import annotations

from typing import Any, Optional

from ..utils.logging import logger
from .engine import DeepSpeedTPUEngine

_DTYPE_NAMES = {"torch.bfloat16": "bf16", "torch.float16": "fp16", "torch.float32": "fp32"}


class DeepSpeedHybridEngine(DeepSpeedTPUEngine):
    """A training engine that also generates with its live weights."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._inference_engine = None
        self._in_eval = False
        hcfg = self.config.hybrid_engine
        logger.info(f"hybrid engine: max_out_tokens={hcfg.max_out_tokens} "
                    f"inference_tp_size={hcfg.inference_tp_size}")

    def eval(self) -> None:
        self._in_eval = True

    def train(self, mode: bool = True) -> None:
        self._in_eval = not mode

    @property
    def in_eval(self) -> bool:
        return self._in_eval

    def _get_inference_engine(self):
        if self._inference_engine is None:
            from ..inference.engine import InferenceConfig, InferenceEngine
            from ..models.transformer import TransformerConfig

            if not isinstance(getattr(self.model, "config", None), TransformerConfig):
                raise TypeError("hybrid engine generation needs a models/* model carrying a "
                                "TransformerConfig (models.llama.llama_model, ...)")
            hcfg = self.config.hybrid_engine
            icfg = InferenceConfig(dtype=_DTYPE_NAMES[str(self.compute_dtype)],
                                   max_seq_len=self.model.config.max_seq_len,
                                   max_out_tokens=hcfg.max_out_tokens,
                                   tensor_parallel={"tp_size": hcfg.inference_tp_size})
            self._inference_engine = InferenceEngine(self.model, icfg,
                                                     params=self._compute_params(),
                                                     device=self.device)
        return self._inference_engine

    def refresh_inference_params(self) -> None:
        """Point generation at the current training weights (the compute
        copy refreshed from the master where a step moved it; no copy)."""
        if self._inference_engine is not None:
            self._inference_engine.params = self._compute_params()

    def generate(self, input_ids: Any, max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0) -> Any:
        """Generate with the engine's live training weights."""
        self._check_live()
        was_eval = self._in_eval
        self.eval()
        try:
            engine = self._get_inference_engine()
            self.refresh_inference_params()
            if max_new_tokens is None:
                max_new_tokens = self.config.hybrid_engine.max_out_tokens
            out = engine.generate(input_ids, max_new_tokens=max_new_tokens,
                                  temperature=temperature, seed=seed)
        finally:
            self._in_eval = was_eval
        if self.config.hybrid_engine.release_inference_cache:
            self.release_inference_cache()
        return out

    def release_inference_cache(self) -> None:
        """Drop the cached inference engine (its KV caches are per call; the
        weights it points at are the training engine's)."""
        self._inference_engine = None
