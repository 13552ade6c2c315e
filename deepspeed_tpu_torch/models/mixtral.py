"""Mixtral-style MoE decoder (the port's counterpart of
``deepspeed_tpu/models/mixtral.py``).  Every layer's FFN is a top-k MoE
over ``moe_experts`` swiglu experts; ``moe_drop_tokens=False`` takes the
dropless grouped-matmul path."""

from __future__ import annotations

from typing import Optional

from ..runtime.module import ModelSpec
from .families import apply_overrides, causal_lm_spec
from .transformer import TransformerConfig

SIZES = {
    # name: (hidden, layers, heads, kv_heads, ffn, vocab, experts, top_k)
    "tiny": (64, 2, 4, 4, 128, 256, 4, 2),
    "8x160m": (768, 12, 12, 12, 2048, 32000, 8, 2),
    "8x7b": (4096, 32, 32, 8, 14336, 32000, 8, 2),
}


def mixtral_config(size: str = "8x7b", max_seq_len: int = 2048,
                   **overrides) -> TransformerConfig:
    h, l, nh, kvh, ffn, vocab, experts, top_k = SIZES[size]
    cfg = TransformerConfig(
        vocab_size=vocab, hidden_size=h, n_layers=l, n_heads=nh, n_kv_heads=kvh,
        intermediate_size=ffn, max_seq_len=max_seq_len, norm="rmsnorm",
        activation="swiglu", position="rope", causal=True,
        moe_experts=experts, moe_top_k=top_k)
    return apply_overrides(cfg, overrides)


def mixtral_model(size: str = "8x7b", max_seq_len: int = 2048,
                  config: Optional[TransformerConfig] = None,
                  **overrides) -> ModelSpec:
    """The model: ``loss_fn`` trains it (``causal_lm_loss``, aux included),
    ``apply_fn`` gives its logits."""
    cfg = config or mixtral_config(size, max_seq_len, **overrides)
    return causal_lm_spec(cfg)
