"""Flash-attention forward: the CUDA kernel ``csrc/flash_attention_fwd.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``deepspeed_tpu/ops/pallas/flash_attention.py``
``_fwd_kernel`` (forward only; the dq/dkv backward kernels come with the
training slice).  Layout at the public functions is the JAX package's:
q ``[B, Sq, NH, D]``, k/v ``[B, Sk, KVH, D]`` with ``NH % KVH == 0``
(query head h reads KV head ``h // (NH // KVH)``).  The kernel reads these
through their strides, so strided views (the QKV projection reshaped)
need no copy.

:func:`flash_attention_fwd` launches the kernel for CUDA tensors and runs
:func:`flash_attention_fwd_plain` for CPU tensors — the tensor's device
is the only switch, and a CUDA tensor the kernel cannot take raises.
Each launch adds one to ``flash_attention_fwd.launches``.

On the card the kernel and the plain version differ by rounding: the
kernel keeps the scores, the softmax statistics and the output sums in
fp32 and rounds only the probabilities (the PV operand) to the input
dtype, while the plain version (the XLA formulation of the JAX prefill
programs) also forms the scores in the input dtype.  Against the plain
version computed in fp32 from the same inputs, the kernel's output is
within its own rounding plus ~3.5e-3 (bf16) and its LSE within ~1e-6
(``chip_smoke.FLASH_TOL``, ``LSE_TOL``); fp32 runs on the FMA pipes in
fp32 throughout.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import op_builder

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIG = {"dstpu_flash_attention_fwd": [
    _P, _P, _P, _P, _P, _P,            # q k v o lse slopes
    _I, _I, _I, _I, _I, _I, _I,        # dtype B NH KVH Sq Sk D
    _I, _I, _I, ctypes.c_float,        # valid_k q_offset causal sm_scale
    _L, _L, _L, _L, _L, _L, _L, _L, _L,  # q/k/v strides (b, s, h)
    _P]}                               # stream


def _rows_ok(t: torch.Tensor) -> bool:
    if t.stride(3) != 1:
        return False
    if t.dtype == torch.float32:
        return True
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = True, sm_scale: Optional[float] = None,
                              alibi_slopes: Optional[torch.Tensor] = None,
                              q_offset: int = 0, valid_k: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the XLA formulation of ``paged_prefill``
    (model_runner.py:145-155), generalised by ``q_offset`` and
    ``valid_k`` to the chunk window.  Returns (o, lse [B, NH, Sq] fp32)."""
    B, Sq, NH, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    valid_k = Sk if valid_k is None else valid_k
    g = NH // KVH
    kk = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
    vv = torch.repeat_interleave(v, g, dim=2) if g > 1 else v
    scores = torch.einsum("btnd,bsnd->bnts", q, kk).float()
    scores = scores / math.sqrt(D) if sm_scale is None else scores * sm_scale
    rows = q_offset + torch.arange(Sq, device=q.device)
    cols = torch.arange(Sk, device=q.device)
    if alibi_slopes is not None:
        rel = (rows[:, None] - cols[None, :]).float()
        scores = scores + (-alibi_slopes.float()[:, None, None]) * rel
    mask = (cols < valid_k)[None, :].expand(Sq, Sk)
    if causal:
        mask = mask & (rows[:, None] >= cols[None, :])
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnts,bsnd->btnd", probs, vv), lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, sm_scale: Optional[float] = None,
                        alibi_slopes: Optional[torch.Tensor] = None,
                        q_offset: int = 0, valid_k: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked online-softmax attention.  q ``[B, Sq, NH, D]``, k/v
    ``[B, Sk, KVH, D]``; query i sits at position ``q_offset + i`` and key
    j at j (chunked prefill over a position-ordered window); keys
    ``>= valid_k`` are masked.  Returns (o ``[B, Sq, NH, D]`` in q's
    dtype, lse ``[B, NH, Sq]`` fp32)."""
    B, Sq, NH, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    valid_k = Sk if valid_k is None else int(valid_k)
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if NH % KVH != 0:
        raise ValueError(f"n_heads {NH} not a multiple of kv heads {KVH}")
    if not 0 < valid_k <= Sk:
        raise ValueError(f"valid_k {valid_k} outside (0, {Sk}]")
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                         alibi_slopes=alibi_slopes,
                                         q_offset=q_offset, valid_k=valid_k)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_fwd: q/k/v on {q.device}/{k.device}/{v.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in the kernel's {HEAD_DIMS}")
    # the kernel reads rows through their strides; the bf16/fp16 kernel copies
    # them 16 bytes at a time, so each row must start 16-byte aligned
    q, k, v = (t if _rows_ok(t) else t.contiguous() for t in (q, k, v))
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).contiguous()
        if slopes.shape != (NH,):
            raise ValueError(f"alibi_slopes shape {tuple(slopes.shape)} != ({NH},)")
    scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    o = torch.empty((B, Sq, NH, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, NH, Sq), dtype=torch.float32, device=q.device)
    lib = op_builder.load("flash_attention_fwd", _SIG)
    with torch.cuda.device(q.device):
        err = lib.dstpu_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            None if slopes is None else slopes.data_ptr(),
            op_builder.dtype_code(q.dtype), B, NH, KVH, Sq, Sk, D, valid_k,
            int(q_offset), int(bool(causal)), scale,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0

