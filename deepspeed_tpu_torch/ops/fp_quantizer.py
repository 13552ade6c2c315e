"""Floating-point quantization, FP8 and the emulated FP6 / FP4 grids
(``deepspeed_tpu/ops/fp_quantizer.py``).

Groupwise scaled float quantization: each group of ``group_size``
elements shares one fp32 scale that maps its absmax to the format's
largest finite value.  fp8 codes are ``torch.float8_e4m3fn`` /
``torch.float8_e5m2``; ``q_bits`` 6 and 4 keep 2 and 1 mantissa bits
(``_round_mantissa``, round half to even) on an fp8 carrier, as the JAX
package does.  Plain PyTorch: no TPU kernel stands behind it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_FP8_MAX = {"e4m3": 448.0, "e5m2": 57344.0}
_FP8_DTYPE = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
#: emulated narrow formats: q_bits -> mantissa bits kept
_EMULATED = {6: 2, 4: 1}


@dataclasses.dataclass
class FPQuantizerConfig:
    group_size: int = 512
    q_bits: int = 8
    fmt: str = "e4m3"  # the fp8 carrier: e4m3 | e5m2


class FP_Quantize:
    """Groupwise FP quantizer (the reference's ``FP_Quantize`` API)."""

    def __init__(self, group_size: int = 512, q_bits: int = 8, fmt: str = "e4m3"):
        if fmt not in _FP8_DTYPE:
            raise ValueError(f"fmt must be e4m3|e5m2, got {fmt}")
        if q_bits != 8 and q_bits not in _EMULATED:
            raise ValueError(f"q_bits must be 8, 6 or 4, got {q_bits}")
        self.config = FPQuantizerConfig(group_size, q_bits, fmt)

    def quantize(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (any shape) -> (codes fp8 ``[G, group]``, scales fp32 ``[G, 1]``),
        on x's device."""
        cfg = self.config
        flat = x.reshape(-1).float()
        pad = (-flat.numel()) % cfg.group_size
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        g = flat.reshape(-1, cfg.group_size)
        absmax = g.abs().amax(dim=-1, keepdim=True)
        # a tensor divisor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, which rounds otherwise than the CPU's
        # (and XLA's) division and gives other scales on the card
        scale = torch.clamp_min(absmax, 1e-30) / absmax.new_tensor(_FP8_MAX[cfg.fmt])
        y = g / scale
        if cfg.q_bits in _EMULATED:
            y = _round_mantissa(y, _EMULATED[cfg.q_bits])
        # a mantissa rounded up at the absmax can pass the finite range, and
        # e4m3fn has no inf: clip before the cast
        y = torch.clamp(y, -_FP8_MAX[cfg.fmt], _FP8_MAX[cfg.fmt])
        return y.to(_FP8_DTYPE[cfg.fmt]), scale

    def dequantize(self, codes: torch.Tensor, scales: torch.Tensor, orig_shape,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
        n = 1
        for d in orig_shape:
            n *= int(d)
        x = codes.float() * scales
        return x.reshape(-1)[:n].reshape(tuple(orig_shape)).to(dtype)

    def get_scales(self, scales: torch.Tensor) -> torch.Tensor:
        return scales

    def selective_dequantize(self, codes, scales, indices, orig_shape,
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Dequantize only the given group rows."""
        del orig_shape
        return (codes[indices].float() * scales[indices]).to(dtype)


def _round_mantissa(y: torch.Tensor, mbits: int) -> torch.Tensor:
    """fp32 values rounded to ``mbits`` mantissa bits, half to even: the
    value grid of an emulated narrow float."""
    bits = y.float().view(torch.int32)
    drop = 23 - mbits
    round_bit = 1 << (drop - 1)
    mask = ~((1 << drop) - 1)
    lsb = (bits >> drop) & 1
    rounded = (bits + (round_bit - 1) + lsb) & mask
    return rounded.view(torch.float32)


def quantize_fp8(x: torch.Tensor, group_size: int = 512,
                 fmt: str = "e4m3") -> Tuple[torch.Tensor, torch.Tensor]:
    """Functional fp8 quantization."""
    return FP_Quantize(group_size, 8, fmt).quantize(x)


def dequantize_fp8(codes: torch.Tensor, scales: torch.Tensor, orig_shape,
                   dtype: torch.dtype = torch.float32, group_size: int = 512,
                   fmt: str = "e4m3") -> torch.Tensor:
    return FP_Quantize(group_size, 8, fmt).dequantize(codes, scales, orig_shape, dtype)
