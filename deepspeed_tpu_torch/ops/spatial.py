"""Spatial / diffusers inference ops, the UNet and VAE path
(``deepspeed_tpu/ops/spatial.py``).

The NHWC bias-add family and the group norm are plain PyTorch (the
reference's fused CUDA adds exist to save eager launches; their
semantics, channels-last ``[B, HW, C]`` and fp32 statistics for the norm,
are what is kept).  :func:`diffusers_attention` is the self- and
cross-attention of a diffusers transformer block: on a CUDA tensor it runs
kernel A (``flash_attention.flash_attention_fwd``, non-causal) at every
head dim and length the kernel takes (SD's 40, 80 and 160, a 77-token
context), and on a CPU tensor the plain einsum formulation of the JAX
function (scores in the input dtype, an fp32 softmax).  A CUDA tensor
never takes the plain path.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F


def nhwc_bias_add(activation: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """activation ``[B, HW, C]`` + bias ``[C]``."""
    return activation + bias.to(activation.dtype)


def nhwc_bias_add_add(activation: torch.Tensor, bias: torch.Tensor,
                      other: torch.Tensor) -> torch.Tensor:
    """(activation + bias) + other (a residual join)."""
    return activation + bias.to(activation.dtype) + other


def nhwc_bias_add_bias_add(activation: torch.Tensor, bias: torch.Tensor, other: torch.Tensor,
                           other_bias: torch.Tensor) -> torch.Tensor:
    """(activation + bias) + (other + other_bias)."""
    return (activation + bias.to(activation.dtype) + other
            + other_bias.to(activation.dtype))


def group_norm(x: torch.Tensor, num_groups: int, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channels of ``[B, HW, C]`` (UNet resnet blocks),
    fp32 statistics."""
    B, HW, C = x.shape
    xf = x.float().reshape(B, HW, num_groups, C // num_groups)
    mu = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), keepdim=True, unbiased=False)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    out = xf.reshape(B, HW, C) * scale.float() + bias.float()
    return out.to(x.dtype)


def _attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The einsum formulation (``spatial.py:91-93``): [B, S, N, D] in,
    non-causal."""
    D = q.shape[-1]
    scores = torch.einsum("bqnd,bknd->bnqk", q, k).float()
    probs = torch.softmax(scores / math.sqrt(D), dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)


def diffusers_attention(x: torch.Tensor, params: Dict[str, Any], n_heads: int,
                        context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self or cross attention over flattened spatial tokens.

    x ``[B, HW, C]``; context ``[B, T, C_ctx]`` for cross attention (None:
    self).  params: ``wq`` ``[C, C]``, ``wk``/``wv`` ``[C_ctx, C]``, ``wo``
    ``[C, C]``, optional ``bq``/``bk``/``bv``/``bo``.  Non-causal: kernel A
    on the card, the einsum formulation on the CPU."""
    B, HW, C = x.shape
    ctx = x if context is None else context
    D = C // n_heads

    def proj(inp, w, b):
        out = inp @ params[w]
        if params.get(b) is not None:
            out = out + params[b]
        return out

    q = proj(x, "wq", "bq").reshape(B, HW, n_heads, D)
    k = proj(ctx, "wk", "bk").reshape(B, ctx.shape[1], n_heads, D)
    v = proj(ctx, "wv", "bv").reshape(B, ctx.shape[1], n_heads, D)
    if q.device.type == "cuda":
        from .flash_attention import flash_attention_fwd

        attn = flash_attention_fwd(q, k, v, causal=False)[0]
    elif q.device.type == "cpu":
        attn = _attention_plain(q, k, v)
    else:
        raise ValueError(f"diffusers_attention: unsupported device {q.device}")
    return proj(attn.reshape(B, HW, C), "wo", "bo")


def _layer_norm(h: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    hf = h.float()
    mu = hf.mean(-1, keepdim=True)
    var = hf.var(-1, keepdim=True, unbiased=False)
    out = (hf - mu) * torch.rsqrt(var + 1e-5)
    return (out * p["scale"] + p["bias"]).to(h.dtype)


def diffusers_transformer_block(x: torch.Tensor, params: Dict[str, Any], n_heads: int,
                                context: torch.Tensor, norm_groups: int = 32) -> torch.Tensor:
    """The diffusers UNet's BasicTransformerBlock: self attention, cross
    attention over ``context``, then a GEGLU feed-forward, each behind a
    layer norm with a residual."""
    h = x + diffusers_attention(_layer_norm(x, params["norm1"]), params["attn1"], n_heads)
    h = h + diffusers_attention(_layer_norm(h, params["norm2"]), params["attn2"], n_heads,
                                context=context)
    g = _layer_norm(h, params["norm3"]) @ params["ff"]["w_in"]
    val, gate = torch.chunk(g, 2, dim=-1)
    # jax.nn.gelu's default is the tanh approximation
    return h + (val * F.gelu(gate, approximate="tanh")) @ params["ff"]["w_out"]
