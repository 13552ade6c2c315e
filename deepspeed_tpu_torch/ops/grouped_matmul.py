"""Grouped (block-diagonal) expert matmul: the CUDA kernel
``csrc/grouped_matmul.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``deepspeed_tpu/ops/pallas/grouped_matmul.py``
``_gmm_kernel`` (via ``grouped_matmul``).  ``x`` [P, H] holds tokens sorted
by expert and padded so that every ``block_rows`` rows belong to one expert
(``moe/sharded_moe.sort_pad_by_expert``), ``w`` [E, H, F] the stacked
expert weights, ``block_expert`` [P / block_rows] int32 the expert of each
row block.  Returns [P, F] in x's type: each block times its expert's
matrix, summed in fp32.  ``n_used`` (optional, a one-element int32 tensor
on x's device: the blocks that hold a real row, from the router) makes the
rows of every later block zeros, which is what zero padding rows give; the
kernel then never computes them, and nothing reads the count on the host.

:func:`grouped_matmul` launches the kernel for CUDA tensors and runs
:func:`grouped_matmul_plain` for CPU tensors; a CUDA tensor the kernel
cannot take raises.  Each launch adds one to ``grouped_matmul.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import op_builder

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"dstpu_grouped_matmul": [
    _P, _P, _P, _P, _P, _P,         # x w block_expert n_used out part
    _I, _I, _I, _I, _I, _I, _I,     # dtype P H F E block_rows big_tile
    _P],                            # stream
        "dstpu_grouped_matmul_splits": [_P, _P, _I, _I, _I, _I, _I, _I]}  # x w dtype P H F E block_rows

#: rows of the kernel's large output tile (bf16/fp16; fp32 takes 64); a
#: smaller block_rows takes the 16-row tile
BIG_TILE_ROWS = {torch.bfloat16: 128, torch.float16: 128, torch.float32: 64}
#: blocks gathered at once by the plain version: bounds its fp32 copy of
#: ``w[block_expert]`` (one Mixtral-8x7b expert matrix is 235 MB in fp32)
PLAIN_BLOCKS_PER_CHUNK = 4


def _shapes(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor, block_rows: int):
    if x.ndim != 2 or w.ndim != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"grouped_matmul: x [P, H] and w [E, H, F], got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    P, H = x.shape
    E, _, F = w.shape
    if block_rows <= 0 or P % block_rows:
        raise ValueError(f"grouped_matmul: {P} rows are not whole blocks of {block_rows}")
    if block_expert.shape != (P // block_rows,):
        raise ValueError(f"grouped_matmul: block_expert must be [{P // block_rows}], got "
                         f"{tuple(block_expert.shape)}")
    return P, H, E, F


def _check_n_used(n_used, x: torch.Tensor) -> None:
    if n_used is not None and (n_used.numel() != 1 or n_used.dtype != torch.int32
                               or n_used.device != x.device):
        raise ValueError(f"grouped_matmul: n_used must be one int32 on {x.device}, got "
                         f"{n_used.dtype} {tuple(n_used.shape)} on {n_used.device}")


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
                         block_rows: int = 128,
                         n_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version, the JAX function's XLA branch: gather
    ``w[block_expert]``, multiply each block in fp32, cast to x's type.  The
    gather runs ``PLAIN_BLOCKS_PER_CHUNK`` blocks at a time to bound memory.
    Expert indices are clamped to ``[0, E)``, as the kernel and JAX's
    gather do.  With ``n_used``, the rows of blocks ``>= n_used`` are zeros
    (masked on the device, no host sync)."""
    P, H, E, F = _shapes(x, w, block_expert, block_rows)
    _check_n_used(n_used, x)
    n_blocks = P // block_rows
    be = block_expert.long().clamp(0, E - 1)
    xb = x.reshape(n_blocks, block_rows, H).float()
    out = torch.empty((n_blocks, block_rows, F), dtype=x.dtype, device=x.device)
    for b0 in range(0, n_blocks, PLAIN_BLOCKS_PER_CHUNK):
        b1 = min(b0 + PLAIN_BLOCKS_PER_CHUNK, n_blocks)
        wb = w.index_select(0, be[b0:b1]).float()  # [n, H, F]
        out[b0:b1] = torch.bmm(xb[b0:b1], wb).to(x.dtype)
    if n_used is not None:
        live = torch.arange(n_blocks, device=x.device) < n_used.reshape(()).long()
        out = torch.where(live[:, None, None], out, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))
    return out.reshape(P, F)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
                   block_rows: int = 128,
                   n_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-grouped ``x @ w[block_expert[block]]`` (the JAX signature, plus
    the optional ``n_used``: called without it, the JAX function).  Every
    ``block_rows`` rows of ``x`` share one expert; P must be a multiple of
    ``block_rows`` (JAX asserts it; here it raises ValueError, which
    ``python -O`` keeps)."""
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, block_expert, block_rows, n_used)
    P, H, E, F = _shapes(x, w, block_expert, block_rows)
    _check_n_used(n_used, x)
    if x.device.type != "cuda" or w.device != x.device or block_expert.device != x.device:
        raise ValueError(f"grouped_matmul: x/w/block_expert on {x.device}/{w.device}/"
                         f"{block_expert.device}")
    if w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul: w is {w.dtype}, x is {x.dtype}")
    if block_expert.dtype != torch.int32:
        raise TypeError(f"grouped_matmul: block_expert must be int32, got {block_expert.dtype}")
    code = op_builder.dtype_code(x.dtype)
    x, w, block_expert = x.contiguous(), w.contiguous(), block_expert.contiguous()
    out = torch.empty((P, F), dtype=x.dtype, device=x.device)
    lib = op_builder.load("grouped_matmul", _SIG)
    # the kernel's K splits for this layout (1 off the wgmma kernel): fp32
    # partials that its second pass adds in split order
    splits = lib.dstpu_grouped_matmul_splits(x.data_ptr(), w.data_ptr(), code, P, H, F, E,
                                             block_rows)
    part = (torch.empty((splits, P, F), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    with torch.cuda.device(x.device):
        err = lib.dstpu_grouped_matmul(
            x.data_ptr(), w.data_ptr(), block_expert.data_ptr(),
            None if n_used is None else n_used.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), code,
            P, H, F, E, block_rows, int(block_rows >= BIG_TILE_ROWS[x.dtype]),
            torch.cuda.current_stream(x.device).cuda_stream)
    op_builder.check(err, "grouped_matmul")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
