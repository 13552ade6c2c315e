"""Llama family (the port's counterpart of ``deepspeed_tpu/models/
llama.py``)."""

from __future__ import annotations

from typing import Optional

from ..runtime.module import ModelSpec
from .families import apply_overrides, causal_lm_spec
from .transformer import TransformerConfig

SIZES = {
    # name: (hidden, layers, heads, kv_heads, ffn, vocab)
    "tiny": (64, 2, 4, 4, 128, 256),  # test fixture
    "160m": (768, 12, 12, 12, 2048, 32000),
    "1b": (2048, 16, 32, 8, 5504, 32000),
    "7b": (4096, 32, 32, 32, 11008, 32000),
    "13b": (5120, 40, 40, 40, 13824, 32000),
    "70b": (8192, 80, 64, 8, 28672, 32000),
}


def llama_config(size: str = "7b", max_seq_len: int = 2048,
                 **overrides) -> TransformerConfig:
    h, l, nh, kvh, ffn, vocab = SIZES[size]
    cfg = TransformerConfig(
        vocab_size=vocab, hidden_size=h, n_layers=l, n_heads=nh, n_kv_heads=kvh,
        intermediate_size=ffn, max_seq_len=max_seq_len, norm="rmsnorm",
        activation="swiglu", position="rope", causal=True)
    return apply_overrides(cfg, overrides)


def llama_model(size: str = "7b", max_seq_len: int = 2048,
                config: Optional[TransformerConfig] = None,
                **overrides) -> ModelSpec:
    cfg = config or llama_config(size, max_seq_len, **overrides)
    return causal_lm_spec(cfg)
