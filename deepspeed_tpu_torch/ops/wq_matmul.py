"""Weight-only quantized matmul (int8 / packed int4): the CUDA kernel
``csrc/wq_matmul.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``deepspeed_tpu/ops/pallas/wq_matmul.py``
``_wq_kernel`` (via ``wq_matmul``): ``x @ W`` where W is stored as codes
plus fp32 scales per ``group`` rows along K, read from device memory as
codes and dequantized on the chip.

Layout (the JAX package's, so trees cross unchanged): ``scale[g, n]``
covers rows ``[g*group, (g+1)*group)`` of column n; int8 codes are
``[Kp, N]``; int4 codes store ``q + 8`` packed pairwise along K, row 2i in
the low nibble and row 2i+1 in the high one, ``[Kp/2, N]`` uint8; Kp is K
rounded up to ``group`` (padded rows are zero, and x is read as zero
there).  :func:`quantize_weight` and :func:`dequantize_weight` are plain
torch, as they are plain jnp in JAX.

:func:`wq_matmul` launches the kernel for CUDA tensors and runs
:func:`wq_matmul_plain` for CPU tensors; a CUDA tensor the kernel cannot
take raises.  The kernel takes every group the reference takes (any
positive group dividing the padded K, even for int4).  Each launch adds
one to ``wq_matmul.launches``.

The plain version is the JAX function's XLA branch: dequantize the whole
weight to fp32, multiply in fp32, cast to x's type.  On the serving path
(bf16/fp16 x, groups that are a multiple of ``KERNEL_K_STEP``, the default
128) the kernel runs on the tensor cores with W's columns in wgmma's 64
rows and the tokens in its N (:func:`_tile`), sums each group's ``x . q``
in fp32 and scales it once, where the TPU kernel multiplies by ``q * s``:
the same function, different fp32 rounding (``chip_smoke.WQ_TOL``).  fp32
x, other groups and layouts TMA cannot read run on the FMA pipes; a group
off their 32-row stage scales each code by its row's scale in fp32 (the
TPU kernel's ``q * s``), so it differs from the plain version by fp32
summation order only.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import op_builder

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"dstpu_wq_matmul": [
    _P, _P, _P, _P, _P,             # x codes scale out ws
    _I, _I, _I, _I, _I, _I, _I,     # dtype bits M K N group n_groups
    _I, _I, _I, _I, _P]}            # splits groups_per_split tile_m wgmma stream

#: K rows per pipeline stage of the tensor-core kernel: a group that is a
#: multiple takes it (bf16/fp16 x), scaling each group's sum once
KERNEL_K_STEP = 64
#: the tensor-core kernel's token tiles (wgmma's N): the smallest that holds
#: M, 128-token tiles past that
TOKEN_TILES = (8, 16, 32, 64, 128)


class Tile(NamedTuple):
    """A kernel's block: ``rows`` tokens x ``cols`` output columns, and how
    many such blocks an SM holds at once."""
    kernel: str  # "wgmma" (tensor cores, TMA-fed) or "fma" (FMA pipes)
    rows: int
    cols: int
    per_sm: int


#: the FMA-pipe kernel's tiles: up to 16 rows, then 64
TILE_FMA_DECODE = Tile("fma", 16, 64, 8)
TILE_FMA = Tile("fma", 64, 64, 2)


def quantize_weight(w: torch.Tensor, bits: int = 8,
                    group: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (codes, scale).  codes: int8 [Kp, N] (8-bit) or
    packed uint8 [Kp/2, N] (4-bit); scale: fp32 [Kp/group, N].  Symmetric
    per group: ``scale = max(absmax, 1e-12) / qmax``, ``q = clip(round(w /
    scale), -qmax, qmax)`` with qmax 127 or 7, in fp32."""
    if w.ndim != 2:
        raise ValueError(f"weight-only quant expects [K, N] matrices, got {tuple(w.shape)}")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if group <= 0 or (bits == 4 and group % 2):
        raise ValueError(f"group {group} must be positive (and even for int4)")
    K, N = w.shape
    pad = (-K) % group
    wf = F.pad(w.float(), (0, 0, 0, pad))
    Kp = K + pad
    groups = wf.reshape(Kp // group, group, N)
    qmax = 127.0 if bits == 8 else 7.0
    amax = torch.clamp_min(groups.abs().amax(dim=1), 1e-12)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the IEEE quotient JAX takes
    scale = amax / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(groups / scale[:, None, :]), -qmax, qmax).reshape(Kp, N)
    if bits == 8:
        return q.to(torch.int8), scale
    off = (q + 8).to(torch.uint8)  # [0, 15]
    return off[0::2] | (off[1::2] << 4), scale


def _unpack_int4(codes: torch.Tensor) -> torch.Tensor:
    """[Kp/2, N] uint8 -> [Kp, N] float32 in [-8, 7]."""
    lo = (codes & 0xF).to(torch.int32) - 8
    hi = (codes >> 4).to(torch.int32) - 8
    return torch.stack([lo, hi], dim=1).reshape(codes.shape[0] * 2, codes.shape[1]).float()


def dequantize_weight(codes: torch.Tensor, scale: torch.Tensor, *, bits: int, group: int,
                      k: int, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Whole-matrix dequant.  ``k``: the true (unpadded) K."""
    w = codes.float() if bits == 8 else _unpack_int4(codes)
    Kp, N = w.shape
    w = w.reshape(Kp // group, group, N) * scale[:, None, :]
    return w.reshape(Kp, N)[:k].to(dtype)


def _check(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, bits: int,
           group: int) -> Tuple[int, int, int]:
    """(K, Kp, N) after checking the codes' layout against x."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    want = torch.int8 if bits == 8 else torch.uint8
    if codes.dtype != want or codes.ndim != 2:
        raise TypeError(f"{bits}-bit codes must be 2-D {want}, got {codes.dtype} "
                        f"{tuple(codes.shape)}")
    K = x.shape[-1]
    Kp = codes.shape[0] * (2 if bits == 4 else 1)
    N = codes.shape[1]
    if group <= 0 or Kp % group or K > Kp:
        raise ValueError(f"codes cover {Kp} rows in groups of {group}; x has K={K}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (Kp // group, N):
        raise ValueError(f"scale must be fp32 {(Kp // group, N)}, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    return K, Kp, N


def wq_matmul_plain(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, *,
                    bits: int, group: int = 128) -> torch.Tensor:
    """The plain version: whole-weight dequant to fp32, fp32 matmul, cast
    to x's type (the JAX function's XLA branch)."""
    K, _, N = _check(x, codes, scale, bits, group)
    w = dequantize_weight(codes, scale, bits=bits, group=group, k=K, dtype=torch.float32)
    return (x.reshape(-1, K).float() @ w).to(x.dtype).reshape(*x.shape[:-1], N)


def kernel_takes_group(group: int, bits: int) -> bool:
    """The groups kernel W takes on the card: every group the reference
    takes, any positive one (even for int4; it must also divide the padded
    K, which :func:`_check` holds)."""
    return group > 0 and (bits != 4 or group % 2 == 0)


def _tile(M: int, dtype: torch.dtype, group: int = 128, tma: bool = True) -> Tile:
    """The kernel and block for M tokens: the tensor-core kernel for bf16/fp16
    x with a group that is a multiple of its stage and rows and codes TMA can
    read (``tma``), one warpgroup per 64 columns (two past 32 tokens, one
    block an SM; up to 32 tokens several blocks share an SM); else the FMA
    kernel."""
    if dtype != torch.float32 and group % KERNEL_K_STEP == 0 and tma:
        rows = next((t for t in TOKEN_TILES if M <= t), TOKEN_TILES[-1])
        if rows > 32:
            return Tile("wgmma", rows, 128, 1)
        return Tile("wgmma", rows, 64, 4 if rows <= 16 else 3)
    return TILE_FMA_DECODE if M <= TILE_FMA_DECODE.rows else TILE_FMA


def _tma_ok(x: torch.Tensor, codes: torch.Tensor, K: int, N: int) -> bool:
    """x's rows and the codes' rows as TMA reads them: 16-byte strides and
    16-byte aligned bases (K % 8 == 0 for 16-bit x, N % 16 == 0 bytes)."""
    return K % 8 == 0 and N % 16 == 0 and x.data_ptr() % 16 == 0 and codes.data_ptr() % 16 == 0


def _splits(sm_count: int, tiles: int, n_groups: int,
            blocks_per_sm: int) -> Tuple[int, int]:
    """(splits, groups per split): split K at group boundaries into as many
    splits as one wave of blocks holds (``blocks_per_sm`` on every SM), so
    the blocks fill the SMs and none waits for a second wave."""
    target = blocks_per_sm * sm_count
    want = min(n_groups, target // tiles)
    if want <= 1:
        return 1, n_groups
    per = -(-n_groups // want)
    return -(-n_groups // per), per


def wq_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, *,
              bits: int, group: int = 128) -> torch.Tensor:
    """``x @ W`` with W stored quantized.  x ``[..., K]`` fp32/bf16/fp16;
    codes and scale as :func:`quantize_weight` returns them.  Returns
    ``[..., N]`` in x's type."""
    if x.device.type == "cpu":
        return wq_matmul_plain(x, codes, scale, bits=bits, group=group)
    K, Kp, N = _check(x, codes, scale, bits, group)
    if x.device.type != "cuda" or codes.device != x.device or scale.device != x.device:
        raise ValueError(f"wq_matmul: x/codes/scale on {x.device}/{codes.device}/{scale.device}")
    if not kernel_takes_group(group, bits):
        raise ValueError(f"wq_matmul: group {group} is not one the kernel takes "
                         f"(positive, even for int4: kernel_takes_group)")
    if not (codes.is_contiguous() and scale.is_contiguous()):
        raise ValueError("wq_matmul takes contiguous codes and scales")
    xm = x.reshape(-1, K).contiguous()
    M = xm.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    n_groups = Kp // group
    tile = _tile(M, x.dtype, group, _tma_ok(xm, codes, K, N))
    splits, per = _splits(torch.cuda.get_device_properties(x.device).multi_processor_count,
                          -(-M // tile.rows) * -(-N // tile.cols), n_groups, tile.per_sm)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    lib = op_builder.load("wq_matmul", _SIG)
    with torch.cuda.device(x.device):
        err = lib.dstpu_wq_matmul(
            xm.data_ptr(), codes.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), op_builder.dtype_code(x.dtype), bits,
            M, K, N, group, n_groups, splits, per, tile.rows, int(tile.kernel == "wgmma"),
            torch.cuda.current_stream(x.device).cuda_stream)
    op_builder.check(err, "wq_matmul")
    wq_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


wq_matmul.launches = 0
