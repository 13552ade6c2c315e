"""Block-wise symmetric int8 quantization: the CUDA kernels
``csrc/quantization.cu`` and their plain PyTorch versions.

Replaces the TPU kernels ``deepspeed_tpu/ops/pallas/quantization.py``
``_quant_kernel`` (via ``quantize_int8``) and ``_dequant_kernel`` (via
``dequantize_int8``): a flat tensor is zero-padded to rows of 128, each
row gets one fp32 scale ``max(absmax, 1e-12) * (1/127)`` and int8 codes
``clip(round(x / scale), -127, 127)``; dequantization multiplies back in
fp32 and casts to the requested type.  The scale is a product with the
fp32 constant 1/127 because that is what the JAX kernel computes: XLA
rewrites its division by the literal 127 into that product (bit-equal to
it in ``tests/test_torch_quantization.py``, where a true division differs
in 10-19 of 301 scales).

:func:`quantize_int8` and :func:`dequantize_int8` launch their kernels for
CUDA tensors and run the plain versions for CPU tensors; a CUDA tensor the
kernels cannot take raises.  Each launch adds one to the wrapper's
``launches``.  The kernels divide ``x / scale`` in IEEE fp32 (no
reciprocal) and round ties to even, as the plain versions and the JAX
kernels do: codes, scales and dequantized values are bit-equal to the
plain version.  ``block_rows`` is the TPU
kernels' block size; it is validated and kept for API parity, and changes
nothing in the result (the CUDA kernels take one warp per row).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import op_builder

ROW = 128
#: the scale is absmax times this fp32 constant (1/127 rounded once)
INV_127 = 1.0 / 127.0
_P = ctypes.c_void_p
_SIG = {"dstpu_quantize_int8": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P],
        "dstpu_dequantize_int8": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]}


def _check_block_rows(block_rows: int) -> None:
    if block_rows <= 0:
        raise ValueError(f"block_rows must be positive, got {block_rows}")


def quantize_int8_plain(x: torch.Tensor, block_rows: int = 256
                        ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The plain version: (int8 codes [rows, 128], fp32 scales [rows, 1],
    the original length)."""
    _check_block_rows(block_rows)
    n = x.numel()
    flat = x.reshape(-1)
    pad = (-n) % ROW
    if pad:
        flat = F.pad(flat, (0, pad))
    x2 = flat.reshape(-1, ROW).float()
    # times the fp32 constant 1/127: XLA compiles the JAX kernel's division
    # by the literal 127 into that product
    scale = torch.clamp_min(x2.abs().amax(dim=-1, keepdim=True), 1e-12) * INV_127
    q = torch.clamp(torch.round(x2 / scale), -127, 127).to(torch.int8)
    return q, scale, n


def dequantize_int8_plain(q: torch.Tensor, s: torch.Tensor, orig_len: int,
                          dtype: torch.dtype = torch.float32,
                          block_rows: int = 256) -> torch.Tensor:
    """The plain version: ``(q * s)`` in fp32, cast to ``dtype``, flat,
    the first ``orig_len`` values."""
    _check_block_rows(block_rows)
    return (q.float() * s).to(dtype).reshape(-1)[:orig_len]


def quantize_int8(x: torch.Tensor, block_rows: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Flat tensor -> (int8 codes [rows, 128], fp32 scales [rows, 1],
    original length).  x: fp32, bf16 or fp16, contiguous."""
    if x.device.type == "cpu":
        return quantize_int8_plain(x, block_rows)
    _check_block_rows(block_rows)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8: x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8 takes a contiguous tensor")
    n = x.numel()
    rows = -(-n // ROW)
    q = torch.empty((rows, ROW), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    lib = op_builder.load("quantization", _SIG)
    with torch.cuda.device(x.device):
        err = lib.dstpu_quantize_int8(x.data_ptr(), q.data_ptr(), s.data_ptr(), n,
                                      op_builder.dtype_code(x.dtype),
                                      torch.cuda.current_stream(x.device).cuda_stream)
    op_builder.check(err, "quantize_int8")
    quantize_int8.launches += 1
    return q, s, n


def dequantize_int8(q: torch.Tensor, s: torch.Tensor, orig_len: int,
                    dtype: torch.dtype = torch.float32, block_rows: int = 256) -> torch.Tensor:
    """(codes, scales, original length) -> the first ``orig_len`` values,
    flat, in ``dtype`` (fp32, bf16 or fp16)."""
    if q.device.type == "cpu":
        return dequantize_int8_plain(q, s, orig_len, dtype, block_rows)
    _check_block_rows(block_rows)
    if q.device.type != "cuda" or s.device != q.device:
        raise ValueError(f"dequantize_int8: q/s on {q.device}/{s.device}")
    if q.dtype != torch.int8 or q.ndim != 2 or q.shape[1] != ROW:
        raise TypeError(f"codes must be int8 [rows, {ROW}], got {q.dtype} {tuple(q.shape)}")
    if s.dtype != torch.float32 or tuple(s.shape) != (q.shape[0], 1):
        raise TypeError(f"scales must be fp32 [{q.shape[0]}, 1], got {s.dtype} "
                        f"{tuple(s.shape)}")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError("dequantize_int8 takes contiguous codes and scales")
    if not 0 <= orig_len <= q.numel():
        raise ValueError(f"orig_len {orig_len} outside [0, {q.numel()}]")
    out = torch.empty((orig_len,), dtype=dtype, device=q.device)
    lib = op_builder.load("quantization", _SIG)
    with torch.cuda.device(q.device):
        err = lib.dstpu_dequantize_int8(q.data_ptr(), s.data_ptr(), out.data_ptr(), orig_len,
                                        op_builder.dtype_code(dtype),
                                        torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "dequantize_int8")
    dequantize_int8.launches += 1
    return out


quantize_int8.launches = 0
dequantize_int8.launches = 0
