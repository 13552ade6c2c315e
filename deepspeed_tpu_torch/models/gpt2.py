"""GPT-2 family (the port's counterpart of ``deepspeed_tpu/models/
gpt2.py``; the 1.3b entry is the JAX package's training comparison config
#3, GPT-2 1.3B under ZeRO-2): learned positions, layernorm, tanh gelu,
biases everywhere, tied head."""

from __future__ import annotations

from typing import Optional

from ..runtime.module import ModelSpec
from .families import apply_overrides, causal_lm_spec
from .transformer import TransformerConfig

SIZES = {
    # name: (hidden, layers, heads, max_seq_len, vocab)
    "tiny": (64, 2, 4, 256, 256),
    "124m": (768, 12, 12, 1024, 50257),
    "350m": (1024, 24, 16, 1024, 50257),
    "774m": (1280, 36, 20, 1024, 50257),
    "1.3b": (2048, 24, 16, 2048, 50257),
    "1.5b": (1600, 48, 25, 1024, 50257),
}


def gpt2_config(size: str = "124m", **overrides) -> TransformerConfig:
    h, l, nh, seq, vocab = SIZES[size]
    return apply_overrides(TransformerConfig(
        vocab_size=vocab, hidden_size=h, n_layers=l, n_heads=nh,
        intermediate_size=4 * h, max_seq_len=seq, norm="layernorm",
        activation="gelu", position="learned", causal=True, use_bias=True,
        tie_embeddings=True), overrides)


def gpt2_model(size: str = "124m", config: Optional[TransformerConfig] = None,
               **overrides) -> ModelSpec:
    return causal_lm_spec(config or gpt2_config(size, **overrides))
