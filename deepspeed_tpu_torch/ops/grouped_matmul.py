"""Grouped (block-diagonal) expert matmul and its backward: the CUDA
kernels G, G' and G'' of ``csrc/grouped_matmul.cu`` and their plain
PyTorch versions.

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

The backward, which the JAX package leaves to XLA's autodiff of its einsum
branch, is two products over the same row blocks: :func:`grouped_matmul_dx`
(G', dX = dY W[e]^T, reading ``w`` as stored) and :func:`grouped_matmul_dw`
(G'', dW[e] = the sum over expert e's blocks, in ascending order, of
X_b^T dY_b; no atomics, so the same bits on every call), each with its own
launch count.  :func:`grouped_matmul` goes through the autograd Function
:class:`GroupedMatmulFn` (G forward, G' and G'' backward) whenever ``x`` or
``w`` requires grad; ``block_expert`` and ``n_used`` get none.  Rows of
blocks at or past ``n_used`` are zeros in the forward whatever x and w
hold, so they get a zero dX and add nothing to dW.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..profiling.flops_profiler import report_kernel_flops
from . import op_builder

_P = ctypes.c_void_p
_I = ctypes.c_int
#: the forward's entries (also those of the parent build chip_smoke.py runs)
_FWD_SIG = {"dstpu_grouped_matmul": [
    _P, _P, _P, _P, _P, _P,         # x w block_expert n_used out part
    _I, _I, _I, _I, _I, _I, _I,     # dtype P H F E block_rows big_tile
    _P],                            # stream
    "dstpu_grouped_matmul_splits": [_P, _P, _I, _I, _I, _I, _I, _I]}  # x w dtype P H F E block_rows
_SIG = {**_FWD_SIG,
        # G': dy w block_expert n_used dx part, then as the forward
        "dstpu_grouped_matmul_dx": _FWD_SIG["dstpu_grouped_matmul"],
        "dstpu_grouped_matmul_dx_splits": _FWD_SIG["dstpu_grouped_matmul_splits"],
        # G'': x dy block_expert n_used dw, dtype P H F E block_rows, stream
        "dstpu_grouped_matmul_dw": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]}

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


def _dx_shapes(dy: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
               block_rows: int):
    """(P, F, E, H) of G': dy [P, F] against w [E, H, F]."""
    if w.ndim != 3:
        raise ValueError(f"grouped_matmul_dx: w [E, H, F], got {tuple(w.shape)}")
    return _shapes(dy, w.transpose(1, 2), block_expert, block_rows)


def _dw_shapes(x: torch.Tensor, dy: torch.Tensor, block_expert: torch.Tensor,
               block_rows: int):
    """(P, H, F) of G'': x [P, H] and dy [P, F] in whole blocks."""
    if x.ndim != 2 or dy.ndim != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"grouped_matmul_dw: x [P, H] and dy [P, F], got {tuple(x.shape)} "
                         f"and {tuple(dy.shape)}")
    P, H = x.shape
    if block_rows <= 0 or P % block_rows or block_expert.shape != (P // block_rows,):
        raise ValueError(f"grouped_matmul_dw: {P} rows in blocks of {block_rows} need "
                         f"block_expert [{P // max(block_rows, 1)}], got "
                         f"{tuple(block_expert.shape)}")
    return P, H, dy.shape[1]


def kernel_flops(P: int, H: int, F: int) -> float:
    """FLOPs of one G, G' or G'' launch (``PERF.md`` §6): ``2 P H F``, every
    row of x counted, the blocks past ``n_used`` too."""
    return 2.0 * P * H * F


def _check_n_used(n_used, x: torch.Tensor) -> None:
    if n_used is not None and (n_used.numel() != 1 or n_used.dtype != torch.int32
                               or n_used.device != x.device):
        raise ValueError(f"grouped_matmul: n_used must be one int32 on {x.device}, got "
                         f"{n_used.dtype} {tuple(n_used.shape)} on {n_used.device}")


def _mask_blocks(t: torch.Tensor, n_used) -> torch.Tensor:
    """``t`` [n_blocks, block_rows, N] with the blocks ``>= n_used`` zeros
    (masked on the device, no host sync)."""
    if n_used is None:
        return t
    live = torch.arange(t.shape[0], device=t.device) < n_used.reshape(()).long()
    return torch.where(live[:, None, None], t, torch.zeros((), dtype=t.dtype, device=t.device))


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
    return _mask_blocks(out, n_used).reshape(P, F)


def grouped_matmul_dx_plain(dy: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
                            block_rows: int = 128,
                            n_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """G' plain: ``dy [P, F] @ w[block_expert]^T`` per row block, in fp32
    and cast once to dy's type, ``PLAIN_BLOCKS_PER_CHUNK`` blocks of ``w``
    gathered at a time; rows of blocks ``>= n_used`` are zeros."""
    P, F, E, H = _dx_shapes(dy, w, block_expert, block_rows)
    _check_n_used(n_used, dy)
    n_blocks = P // block_rows
    be = block_expert.long().clamp(0, E - 1)
    gb = dy.reshape(n_blocks, block_rows, F).float()
    out = torch.empty((n_blocks, block_rows, H), dtype=dy.dtype, device=dy.device)
    for b0 in range(0, n_blocks, PLAIN_BLOCKS_PER_CHUNK):
        b1 = min(b0 + PLAIN_BLOCKS_PER_CHUNK, n_blocks)
        wb = w.index_select(0, be[b0:b1]).float()  # [n, H, F]
        out[b0:b1] = torch.bmm(gb[b0:b1], wb.transpose(1, 2)).to(dy.dtype)
    return _mask_blocks(out, n_used).reshape(P, H)


def grouped_matmul_dw_plain(x: torch.Tensor, dy: torch.Tensor, block_expert: torch.Tensor,
                            n_experts: int, block_rows: int = 128,
                            n_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """G'' plain: ``dw[e]`` = the sum over the blocks b of expert e of
    ``x_b^T dy_b``, each block's fp32 product added to an fp32 sum in
    ascending b (no ``index_add_``), cast once to x's type; zeros for an
    expert with no block.  Blocks ``>= n_used`` add nothing (their dy rows
    are masked to zeros on the device).  The block -> expert map is read
    on the host: the plain version is a reference, not the path."""
    P, H, F = _dw_shapes(x, dy, block_expert, block_rows)
    _check_n_used(n_used, x)
    n_blocks = P // block_rows
    be = block_expert.long().clamp(0, n_experts - 1).cpu()
    xb = x.reshape(n_blocks, block_rows, H)
    gb = _mask_blocks(dy.reshape(n_blocks, block_rows, F), n_used)
    out = torch.zeros((n_experts, H, F), dtype=torch.float32, device=x.device)
    for e in range(n_experts):
        for b in torch.nonzero(be == e).flatten().tolist():  # ascending
            out[e] += xb[b].float().T @ gb[b].float()
    return out.to(x.dtype)


def _launch_args(a: torch.Tensor, b: torch.Tensor, block_expert: torch.Tensor, n_used,
                 what: str):
    """A launch's device, type and contiguity checks; the contiguous
    operands."""
    if a.device.type != "cuda" or b.device != a.device or block_expert.device != a.device:
        raise ValueError(f"{what}: operands on {a.device}/{b.device}/{block_expert.device}")
    if b.dtype != a.dtype:
        raise TypeError(f"{what}: operand types {a.dtype} and {b.dtype} differ")
    if block_expert.dtype != torch.int32:
        raise TypeError(f"{what}: block_expert must be int32, got {block_expert.dtype}")
    _check_n_used(n_used, a)
    return a.contiguous(), b.contiguous(), block_expert.contiguous()


def _launch_gmm(entry: str, a: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
                n_used, P: int, H: int, F: int, E: int, block_rows: int,
                out_cols: int) -> torch.Tensor:
    """G (``entry`` dstpu_grouped_matmul, out [P, F]) or G'
    (dstpu_grouped_matmul_dx, out [P, H]) on the card, with the fp32 K-split
    scratch the library asks for."""
    code = op_builder.dtype_code(a.dtype)
    out = torch.empty((P, out_cols), dtype=a.dtype, device=a.device)
    lib = op_builder.load("grouped_matmul", _SIG)
    # the kernel's K splits for this layout (1 off the wgmma kernel): fp32
    # partials that its second pass adds in split order
    splits = getattr(lib, entry + "_splits")(a.data_ptr(), w.data_ptr(), code, P, H, F, E,
                                             block_rows)
    part = (torch.empty((splits, P, out_cols), dtype=torch.float32, device=a.device)
            if splits > 1 else None)
    with torch.cuda.device(a.device):
        err = getattr(lib, entry)(
            a.data_ptr(), w.data_ptr(), block_expert.data_ptr(),
            None if n_used is None else n_used.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), code,
            P, H, F, E, block_rows, int(block_rows >= BIG_TILE_ROWS[a.dtype]),
            torch.cuda.current_stream(a.device).cuda_stream)
    op_builder.check(err, entry[len("dstpu_"):])
    return out


def _grouped_matmul(x, w, block_expert, block_rows, n_used):
    """G, no autograd: the plain version on the CPU, the kernel on the card."""
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, block_expert, block_rows, n_used)
    P, H, E, F = _shapes(x, w, block_expert, block_rows)
    x, w, block_expert = _launch_args(x, w, block_expert, n_used, "grouped_matmul")
    out = _launch_gmm("dstpu_grouped_matmul", x, w, block_expert, n_used, P, H, F, E,
                      block_rows, F)
    grouped_matmul.launches += 1
    report_kernel_flops("grouped_matmul", kernel_flops(P, H, F))
    return out


def grouped_matmul_dx(dy: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
                      block_rows: int = 128,
                      n_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """G': ``dy [P, F] @ w[block_expert[block]]^T`` -> [P, H] in dy's type,
    the rows of blocks ``>= n_used`` zeros.  The kernel on a CUDA tensor
    (each launch one count in ``grouped_matmul_dx.launches``), the plain
    version on a CPU one."""
    if dy.device.type == "cpu":
        return grouped_matmul_dx_plain(dy, w, block_expert, block_rows, n_used)
    P, F, E, H = _dx_shapes(dy, w, block_expert, block_rows)
    dy, w, block_expert = _launch_args(dy, w, block_expert, n_used, "grouped_matmul_dx")
    out = _launch_gmm("dstpu_grouped_matmul_dx", dy, w, block_expert, n_used, P, H, F, E,
                      block_rows, H)
    grouped_matmul_dx.launches += 1
    report_kernel_flops("grouped_matmul_dx", kernel_flops(P, H, F))
    return out


def grouped_matmul_dw(x: torch.Tensor, dy: torch.Tensor, block_expert: torch.Tensor,
                      n_experts: int, block_rows: int = 128,
                      n_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """G'': ``dw [E, H, F]``, ``dw[e]`` the sum over the blocks of expert e
    below ``n_used``, in ascending order, of ``x_b^T @ dy_b``, in x's type
    (zeros for an expert with no block).  The kernel on a CUDA tensor (each
    launch one count in ``grouped_matmul_dw.launches``), the plain version
    on a CPU one."""
    if x.device.type == "cpu":
        return grouped_matmul_dw_plain(x, dy, block_expert, n_experts, block_rows, n_used)
    P, H, F = _dw_shapes(x, dy, block_expert, block_rows)
    x, dy, block_expert = _launch_args(x, dy, block_expert, n_used, "grouped_matmul_dw")
    out = torch.empty((n_experts, H, F), dtype=x.dtype, device=x.device)
    lib = op_builder.load("grouped_matmul", _SIG)
    with torch.cuda.device(x.device):
        err = lib.dstpu_grouped_matmul_dw(
            x.data_ptr(), dy.data_ptr(), block_expert.data_ptr(),
            None if n_used is None else n_used.data_ptr(), out.data_ptr(),
            op_builder.dtype_code(x.dtype), P, H, F, n_experts, block_rows,
            torch.cuda.current_stream(x.device).cuda_stream)
    op_builder.check(err, "grouped_matmul_dw")
    grouped_matmul_dw.launches += 1
    report_kernel_flops("grouped_matmul_dw", kernel_flops(P, H, F))
    return out


class GroupedMatmulFn(torch.autograd.Function):
    """G forward; G' and G'' backward (each only where its input needs a
    gradient).  ``block_expert``, ``block_rows`` and ``n_used`` get none."""

    @staticmethod
    def forward(ctx, x, w, block_expert, block_rows, n_used):
        ctx.save_for_backward(x, w, block_expert, n_used)
        ctx.block_rows = block_rows
        return _grouped_matmul(x, w, block_expert, block_rows, n_used)

    @staticmethod
    def backward(ctx, dy):
        x, w, block_expert, n_used = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_matmul_dx(dy, w, block_expert, ctx.block_rows, n_used)
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul_dw(x, dy, block_expert, w.shape[0], ctx.block_rows, n_used)
        return dx, dw, None, None, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
                   block_rows: int = 128,
                   n_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-grouped ``x @ w[block_expert[block]]`` (the JAX signature, plus
    the optional ``n_used``: called without it, the JAX function).  Every
    ``block_rows`` rows of ``x`` share one expert; P must be a multiple of
    ``block_rows`` (JAX asserts it; here it raises ValueError, which
    ``python -O`` keeps).  Differentiable in ``x`` and ``w`` (through
    :class:`GroupedMatmulFn`) when either requires grad."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmulFn.apply(x, w, block_expert, block_rows, n_used)
    return _grouped_matmul(x, w, block_expert, block_rows, n_used)


grouped_matmul.launches = 0
grouped_matmul_dx.launches = 0
grouped_matmul_dw.launches = 0
