"""Optimized / LoRA linear layers (the port's counterpart of
``deepspeed_tpu/linear/optimized_linear.py``).

Params are a dict ``{base (frozen, optionally int8), lora_a, lora_b}``;
:func:`lora_linear` applies ``y = x @ base + (x @ a) @ b * (alpha / r)``.
An int8 base is stored as the block codec's codes and scales
(``ops/quantization.py``) and dequantized by the kernel on every call,
so only its int8 bytes stay resident.  ``base_meta`` (in, out, length)
lives on the host: reading it needs no device sync.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..accelerator import DeviceLike, resolve_device


@dataclasses.dataclass
class LoRAConfig:
    lora_r: int = 64
    lora_alpha: float = 16.0
    base_weight_sharding: int = 1


@dataclasses.dataclass
class QuantizationConfig:
    q_bits: int = 8
    group_size: int = 128


def init_lora_linear(generator: torch.Generator, in_dim: int, out_dim: int, lora: LoRAConfig,
                     quantize: Optional[QuantizationConfig] = None,
                     base: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.float32,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """A LoRA layer over ``base`` ``[in_dim, out_dim]`` (random, std 0.02,
    when None): ``lora_a`` normal / r, ``lora_b`` zeros, drawn from
    ``generator`` on ``device`` (None means ``cuda``).  With ``quantize``
    the base is stored int8 (the block codec, whatever ``q_bits`` says, as
    in JAX)."""
    device = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32).to(dtype)

    if base is None:
        base = normal(in_dim, out_dim) * 0.02
    params: Dict[str, Any] = {"lora_a": normal(in_dim, lora.lora_r) * (1.0 / lora.lora_r),
                              "lora_b": torch.zeros((lora.lora_r, out_dim), dtype=dtype,
                                                    device=device)}
    if quantize is not None:
        from ..ops.quantization import quantize_int8

        q, s, n = quantize_int8(base.to(device).contiguous().reshape(-1))
        params["base_q"] = q
        params["base_scale"] = s
        params["base_meta"] = torch.tensor([in_dim, out_dim, n], dtype=torch.int32)
    else:
        params["base"] = base.to(device)
    return params


def lora_linear(params: Dict[str, Any], x: torch.Tensor, lora: LoRAConfig) -> torch.Tensor:
    """``x @ base + (x @ lora_a) @ lora_b * (alpha / r)``; the base is
    frozen (no gradient reaches it)."""
    if "base" in params:
        base = params["base"]
    else:
        from ..ops.quantization import dequantize_int8

        d_in, d_out, n = (int(v) for v in params["base_meta"].tolist())
        base = dequantize_int8(params["base_q"], params["base_scale"], n,
                               x.dtype).reshape(d_in, d_out)
    y = x @ base.detach()
    scale = lora.lora_alpha / lora.lora_r
    return y + (x @ params["lora_a"]) @ params["lora_b"] * scale


def trainable_lora_params(params: Any) -> Any:
    """The same structure with True only for leaves whose path names a
    lora leaf (the mask that freezes everything else)."""

    def walk(node: Any, path: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}/{i}") for i, v in enumerate(node))
        return "lora_" in path

    return walk(params, "")
