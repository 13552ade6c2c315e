"""BERT family with the masked-LM pretraining loss (the port's counterpart
of ``deepspeed_tpu/models/bert.py``; the base entry is the JAX package's
training comparison config #2, BERT-base under ZeRO-1 in bf16).

BERT rides the core's post-norm mode: the norm after each residual add,
an embedding LayerNorm, segment embeddings (``embed.type``), no final
norm, non-causal attention.  :func:`init_bert_params` adds the MLM
prediction head (``mlm_head``); torch and JAX draw different numbers, so
parity tests carry JAX's weights across."""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..runtime.module import ModelSpec
from .families import apply_overrides
from .transformer import (ParamTree, TransformerConfig, _norm, flops_per_token,
                          init_transformer_params, nll_pick, transformer_forward)

SIZES = {
    # name: (hidden, layers, heads, max_seq_len, vocab)
    "tiny": (64, 2, 4, 128, 256),
    "base": (768, 12, 12, 512, 30522),
    "large": (1024, 24, 16, 512, 30522),
}


def bert_config(size: str = "base", **overrides) -> TransformerConfig:
    h, l, nh, seq, vocab = SIZES[size]
    return apply_overrides(TransformerConfig(
        vocab_size=vocab, hidden_size=h, n_layers=l, n_heads=nh,
        intermediate_size=4 * h, max_seq_len=seq, norm="layernorm",
        activation="gelu_exact", position="learned", causal=False,
        use_bias=True, tie_embeddings=True, post_norm=True), overrides)


def mlm_logits(cfg: TransformerConfig, params: ParamTree,
               hidden: torch.Tensor) -> torch.Tensor:
    """The MLM prediction head.  With an ``mlm_head`` this is BERT's full
    head (dense + activation + LayerNorm + tied decoder + bias, HF
    cls.predictions), its activation the configured one, as the FFN's;
    otherwise the plain tied projection."""
    mh = params.get("mlm_head")
    if mh is None:
        return hidden @ params.embed.tok.T
    if cfg.activation == "relu":
        act = F.relu
    elif cfg.activation == "gelu_exact":
        act = F.gelu
    else:
        act = lambda t: F.gelu(t, approximate="tanh")  # noqa: E731
    h = act(hidden @ mh.dense_w + mh.dense_b)
    h = _norm(h, mh.norm_scale, mh.norm_bias, "layernorm", cfg.norm_eps)
    return h @ params.embed.tok.T + mh.bias


def mlm_loss(cfg: TransformerConfig, params: ParamTree, batch: Any,
             rng: Any = None) -> torch.Tensor:
    """Masked-LM cross entropy.  batch: dict(input_ids, labels, optional
    attention_mask and token_type_ids); label -100 is not predicted (the HF
    convention)."""
    labels = batch["labels"]
    hidden, aux = transformer_forward(cfg, params, batch["input_ids"],
                                      batch.get("attention_mask"), batch.get("token_type_ids"))
    logp = torch.log_softmax(mlm_logits(cfg, params, hidden).float(), dim=-1)
    nll = nll_pick(logp, torch.clamp_min(labels, 0))
    sel = (labels >= 0).float()
    return (nll * sel).sum() / torch.clamp_min(sel.sum(), 1.0) + aux


def init_bert_params(cfg: TransformerConfig, generator: torch.Generator,
                     device: torch.device) -> ParamTree:
    """The transformer core and the MLM prediction head (the dense layer,
    its LayerNorm and the decoder bias: part of BERT pretraining and of
    the HF checkpoint format), drawn after the core from ``generator``."""
    p = init_transformer_params(cfg, generator, device)
    H, dt = cfg.hidden_size, cfg.dtype
    dense_w = (torch.randn((H, H), generator=generator, device=device,
                           dtype=torch.float32) * 0.02).to(dt)
    p.add_module("mlm_head", ParamTree({
        "dense_w": dense_w,
        "dense_b": torch.zeros(H, device=device, dtype=dt),
        "norm_scale": torch.ones(H, device=device, dtype=dt),
        "norm_bias": torch.zeros(H, device=device, dtype=dt),
        "bias": torch.zeros(cfg.vocab_size, device=device, dtype=dt),
    }))
    return p


def bert_model(size: str = "base", config: Optional[TransformerConfig] = None,
               **overrides) -> ModelSpec:
    """The encoder: ``loss_fn`` is :func:`mlm_loss`, ``apply_fn`` gives the
    final hidden states."""
    cfg = config or bert_config(size, **overrides)

    def apply_fn(params, batch):
        if not isinstance(batch, dict):
            return transformer_forward(cfg, params, batch)[0]
        return transformer_forward(cfg, params, batch["input_ids"],
                                   batch.get("attention_mask"),
                                   batch.get("token_type_ids"))[0]

    return ModelSpec(
        cfg, lambda gen, dev: init_bert_params(cfg, gen, dev),
        loss_fn=lambda params, batch, rng: mlm_loss(cfg, params, batch, rng),
        apply_fn=apply_fn,
        flops_per_sample=flops_per_token(cfg, cfg.max_seq_len) * cfg.max_seq_len)
