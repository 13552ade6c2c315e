"""Flash attention: the CUDA kernels ``csrc/flash_attention_fwd.cu``
(forward) and ``csrc/flash_attention_bwd.cu`` (dQ; dK and dV), their plain
PyTorch versions, and the autograd function the training path calls.

Replaces the TPU kernels of ``deepspeed_tpu/ops/pallas/flash_attention.py``:
``_fwd_kernel`` (kernel A), ``_bwd_dq_kernel`` (kernel A') and
``_bwd_dkv_kernel`` (kernel A''), and with them ``_flash_bhsd``'s custom
VJP.  Layout at the public functions is the JAX package's: q
``[B, Sq, NH, D]``, k/v ``[B, Sk, KVH, D]`` with ``NH % KVH == 0`` (query
head h reads KV head ``h // (NH // KVH)``).  The kernels read these
through their strides, so strided views (the QKV projection reshaped)
need no copy.

Each wrapper (:func:`flash_attention_fwd`, :func:`flash_attention_bwd_dq`,
:func:`flash_attention_bwd_dkv`) launches its kernel for CUDA tensors and
runs the plain version for CPU tensors — the tensor's device is the only
switch, and a CUDA tensor the kernel cannot take raises.  Each launch adds
one to the wrapper's ``launches`` and reports its FLOPs to the FLOPs
profiler (``profiling.flops_profiler.report_kernel_flops``: ``4 D``, ``6 D``
and ``8 D`` a computed (query, key) pair).

:func:`flash_attention` is the training entry (the counterpart of the JAX
``flash_attention``): a ``torch.autograd.Function`` whose forward is kernel
A and whose backward is kernels A' and A''.

On the card the forward kernel and its plain version differ by rounding:
the kernel keeps the scores, the softmax statistics and the output sums in
fp32 and rounds only the probabilities (the PV operand) to the input
dtype, while the plain version (the XLA formulation of the JAX prefill
programs) also forms the scores in the input dtype.  Against the plain
version computed in fp32 from the same inputs, the kernel's output is
within its own rounding plus ~3.5e-3 (bf16) and its LSE within ~1e-6
(``chip_smoke.FLASH_TOL``, ``LSE_TOL``); fp32 runs on the FMA pipes in
fp32 throughout.  The backward kernels keep every sum in fp32, as the TPU
ones do; in bf16/fp16 they round P and dS (before its scale) to the input
dtype as tensor-core operands, which their plain version (fp32
throughout, like the TPU kernels) does not (fp16, and bf16 A'' past a
query-to-KV group of 4, :func:`dkv_two_terms`, keep each as two terms of
the input dtype); in fp32 they run on the FMA pipes and differ
from it by summation order only (``chip_smoke.FLASH_BWD_TOL``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..profiling.flops_profiler import attention_pairs, report_kernel_flops
from . import op_builder

NEG_INF = -1e30


#: the widest head of the compile-time instantiations; past it the kernels
#: take D as an argument (the runtime-head-dim path, fp32 on the FMA pipes)
WIDEST_INSTANCE = 256


#: FLOPs a computed (query, key) pair costs each kernel, per unit of D
#: (PERF.md §6's bounds): A forms S = QK^T and PV; A' recomputes S and dP =
#: dO V^T and forms dS K; A'' recomputes both and forms P^T dO and dS^T Q
FLOPS_PER_PAIR = {"fwd": 4.0, "dq": 6.0, "dkv": 8.0}


def kernel_takes_head_dim(D: int) -> bool:
    """The head dims the attention kernels (flash forward and backward,
    paged decode, block-sparse S) take on the card: every D >= 1, as the
    JAX kernels, which block over the whole D."""
    return D >= 1


def padded_head_dim(D: int) -> int:
    """The head dim a kernel runs at for a head of D: up to 256, D rounded
    up to a multiple of 16 (of 32 past 128), the extra columns zeros, which
    leave q . k unchanged and give output columns that are not kept; past
    256, D itself (the runtime-head-dim kernels read rows at their width)."""
    if D > WIDEST_INSTANCE:
        return D
    return -(-D // 16) * 16 if D <= 128 else -(-D // 32) * 32


def check_head_dim(D: int, what: str) -> None:
    """Raise for a head dim the kernels do not take (none below 1)."""
    if not kernel_takes_head_dim(D):
        raise ValueError(f"{what}: head_dim {D} is not positive")


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` [..., D] with zero columns up to ``width``: a new contiguous
    tensor (``t`` itself when it is already that wide)."""
    D = t.shape[-1]
    if D == width:
        return t
    out = t.new_zeros((*t.shape[:-1], width))
    out[..., :D] = t
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIG = {"dstpu_flash_attention_fwd": [
    _P, _P, _P, _P, _P, _P,            # q k v o lse slopes
    _I, _I, _I, _I, _I, _I, _I, _I,    # dtype B NH KVH Sq Sk D Dm
    _I, _I, _I, ctypes.c_float,        # valid_k q_offset causal sm_scale
    _L, _L, _L, _L, _L, _L, _L, _L, _L,  # q/k/v strides (b, s, h)
    _P]}                               # stream
_BWD_COMMON = [
    _P, _P, _P, _P, _P, _P, _P,        # q k v dO lse delta slopes
    _I, _I, _I, _I, _I, _I, _I,        # dtype B NH KVH Sq Sk D
    _I, ctypes.c_float,                # causal sm_scale
    _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L]  # q/k/v/dO strides (b, s, h)
_BWD_SIG = {"dstpu_flash_attention_bwd_dq": _BWD_COMMON + [_P, _P],  # dq stream
            "dstpu_flash_attention_bwd_dkv": _BWD_COMMON + [_P, _P, _P]}  # dk dv stream


def _rows_ok(t: torch.Tensor) -> bool:
    if t.stride(3) != 1:
        return False
    if t.dtype == torch.float32:
        return True
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def _tma_ok(t: torch.Tensor) -> bool:
    """A [B, S, H, D] tensor the backward kernels' TMA maps read in place:
    rows 16-byte aligned and no stride 0 (a map's strides are positive)."""
    return _rows_ok(t) and (t.dtype == torch.float32 or min(t.stride()[:3]) > 0)


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
    check_head_dim(D, "flash_attention_fwd")
    if q.dtype == torch.float32 or D > WIDEST_INSTANCE:
        # the FMA kernels read rows through their strides, zero past D
        q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    elif D % 8:
        # TMA maps take rows whose strides are whole 16-byte units: copy into
        # zero-padded rows
        q, k, v = (pad_head_dim(t, -(-D // 8) * 8) for t in (q, k, v))
    else:
        # the TMA maps read strided views in place; the kernel's columns past
        # D (D = 72 runs the 80-wide kernel) arrive as zeros
        q, k, v = (t if _tma_ok(t) else t.contiguous() for t in (q, k, v))
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
            op_builder.dtype_code(q.dtype), B, NH, KVH, Sq, Sk, D, q.shape[3], valid_k,
            int(q_offset), int(bool(causal)), scale,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    report_kernel_flops("flash_attention_fwd", FLOPS_PER_PAIR["fwd"] * D
                        * attention_pairs(B, NH, Sq, Sk, causal, q_offset, valid_k))
    return o, lse


flash_attention_fwd.launches = 0


# ---------------------------------------------------------------------------
# backward: kernels A' (dQ) and A'' (dK, dV)
# ---------------------------------------------------------------------------
def _bwd_from_delta(q, k, v, do, lse, delta, causal, sm_scale, alibi_slopes):
    """dq, dk, dv by the recompute formulas in fp32 (not autograd of the
    forward); ``delta`` = rowsum(O * dO) as ``[B, NH, Sq]``."""
    B, Sq, NH, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    g = NH // KVH
    scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    kk = torch.repeat_interleave(kf, g, dim=2) if g > 1 else kf
    vv = torch.repeat_interleave(vf, g, dim=2) if g > 1 else vf
    s = torch.einsum("btnd,bsnd->bnts", qf, kk) * scale
    rows = torch.arange(Sq, device=q.device)
    cols = torch.arange(Sk, device=q.device)
    if alibi_slopes is not None:
        rel = (rows[:, None] - cols[None, :]).float()
        s = s - alibi_slopes.to(device=q.device, dtype=torch.float32)[:, None, None] * rel
    vis = (rows[:, None] >= cols[None, :]) if causal else torch.ones(
        (Sq, Sk), dtype=torch.bool, device=q.device)
    p = torch.where(vis, torch.exp(s - lse[..., None].float()), torch.zeros_like(s))
    dp = torch.einsum("btnd,bsnd->bnts", dof, vv)
    ds = p * (dp - delta[..., None].float()) * scale
    dq = torch.einsum("bnts,bsnd->btnd", ds, kk)
    dk = torch.einsum("bnts,btnd->bsnd", ds, qf).reshape(B, Sk, KVH, g, D).sum(3)
    dv = torch.einsum("bnts,btnd->bsnd", p, dof).reshape(B, Sk, KVH, g, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(O * dO) in fp32 as ``[B, NH, Sq]`` (``flash_attention.py:243``)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, sm_scale: Optional[float] = None,
                              alibi_slopes: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of kernels A' and A'': P recomputed from q, k and
    ``lse`` ``[B, NH, Sq]``, dS = P * (dO V^T - delta) * scale, and dQ = dS K,
    dK = dS^T Q and dV = P^T dO, the last two summed over each KV head's
    query heads, all in fp32.  Returns (dq, dk, dv) in q's, k's and v's
    dtypes."""
    return _bwd_from_delta(q, k, v, do, lse, _delta(o, do), causal, sm_scale, alibi_slopes)


def _bwd_checks(q, k, v, do, lse, delta, alibi_slopes):
    B, Sq, NH, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or do.shape != q.shape:
        raise ValueError(f"q/k/v/dO shapes {tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)}/{tuple(do.shape)} do not match")
    if NH % KVH != 0:
        raise ValueError(f"n_heads {NH} not a multiple of kv heads {KVH}")
    if any(t.device != q.device for t in (k, v, do, lse, delta)) or q.device.type != "cuda":
        raise ValueError("flash attention backward: all tensors on one CUDA device")
    if k.dtype != q.dtype or v.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"q/k/v/dO dtypes differ: {q.dtype}/{k.dtype}/{v.dtype}/{do.dtype}")
    check_head_dim(D, "flash attention backward")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, NH, Sq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 [B, NH, Sq], got "
                             f"{t.dtype} {tuple(t.shape)}")
    Dk = padded_head_dim(D)
    if Dk != D:
        # the kernels run at Dk: zero columns leave S and dP unchanged, and
        # the gradients' extra columns are dropped
        q, k, v, do = (pad_head_dim(t, Dk) for t in (q, k, v, do))
    else:
        # read through strides; the bf16/fp16 kernels load tiles by TMA, whose
        # maps take 16-byte aligned bases and positive 16-byte strides
        q, k, v, do = (t if _tma_ok(t) else t.contiguous() for t in (q, k, v, do))
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).contiguous()
        if slopes.shape != (NH,):
            raise ValueError(f"alibi_slopes shape {tuple(slopes.shape)} != ({NH},)")
    return q, k, v, do, slopes


#: kernel A'' in bf16 keeps P and dS as two bf16 terms (hi and lo) past a
#: query-to-KV group of this many heads: each key's dK and dV then sum
#: G x Sq rounded products, and one term missed ``FLASH_BWD_TOL`` at
#: falcon-7b's 71:1.  At G <= 4 the one-term kernel meets it.
TWO_TERM_GROUP = 4
#: the C entry's type code for bf16 A'' with two terms
_BF16_TWO_TERMS = 3


def dkv_two_terms(dtype: torch.dtype, group: int, D: int) -> bool:
    """Whether kernel A'' runs its two-term bf16 instantiation: bf16, a
    group wider than :data:`TWO_TERM_GROUP`, and a compile-time head
    (``padded_head_dim(D) <= 256``; past it the runtime-head-dim kernel
    keeps P and dS in fp32).  fp16 always takes two terms, fp32 none."""
    return (dtype == torch.bfloat16 and group > TWO_TERM_GROUP
            and padded_head_dim(D) <= WIDEST_INSTANCE)


def _bwd_launch(fn: str, q, k, v, do, lse, delta, slopes, causal, scale, outs):
    B, Sq, NH, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    code = op_builder.dtype_code(q.dtype)
    if fn.endswith("dkv") and dkv_two_terms(q.dtype, NH // KVH, D):
        code = _BF16_TWO_TERMS
    lib = op_builder.load("flash_attention_bwd", _BWD_SIG)
    with torch.cuda.device(q.device):
        err = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if slopes is None else slopes.data_ptr(),
            code, B, NH, KVH, Sq, Sk, D, int(bool(causal)), scale,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), do.stride(0), do.stride(1), do.stride(2),
            *(t.data_ptr() for t in outs), torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, fn[len("dstpu_"):])


def _bwd_pairs(q: torch.Tensor, k: torch.Tensor, causal: bool) -> int:
    """(query, key) pairs the backward kernels compute (query i sees key j
    at or before i when causal)."""
    B, Sq, NH, _ = q.shape
    return attention_pairs(B, NH, Sq, k.shape[1], causal)


def _unpad(t: torch.Tensor, D: int) -> torch.Tensor:
    return t if t.shape[-1] == D else t[..., :D].contiguous()


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                           causal: bool = True, sm_scale: Optional[float] = None,
                           alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel A': dQ ``[B, Sq, NH, D]`` in q's dtype, from the forward's
    ``lse`` and ``delta`` = rowsum(O * dO), both fp32 ``[B, NH, Sq]``."""
    if q.device.type == "cpu":
        return _bwd_from_delta(q, k, v, do, lse, delta, causal, sm_scale, alibi_slopes)[0]
    D = q.shape[3]
    scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    q, k, v, do, slopes = _bwd_checks(q, k, v, do, lse, delta, alibi_slopes)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("dstpu_flash_attention_bwd_dq", q, k, v, do, lse, delta, slopes, causal,
                scale, (dq,))
    flash_attention_bwd_dq.launches += 1
    report_kernel_flops("flash_attention_bwd_dq",
                        FLOPS_PER_PAIR["dq"] * D * _bwd_pairs(q, k, causal))
    return _unpad(dq, D)


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                            causal: bool = True, sm_scale: Optional[float] = None,
                            alibi_slopes: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A'': (dK, dV) ``[B, Sk, KVH, D]`` in k's dtype, each KV head's
    gradient summed in fp32 over its query heads."""
    if q.device.type == "cpu":
        return _bwd_from_delta(q, k, v, do, lse, delta, causal, sm_scale, alibi_slopes)[1:]
    D = q.shape[3]
    scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    q, k, v, do, slopes = _bwd_checks(q, k, v, do, lse, delta, alibi_slopes)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch("dstpu_flash_attention_bwd_dkv", q, k, v, do, lse, delta, slopes, causal,
                scale, (dk, dv))
    flash_attention_bwd_dkv.launches += 1
    report_kernel_flops("flash_attention_bwd_dkv",
                        FLOPS_PER_PAIR["dkv"] * D * _bwd_pairs(q, k, causal))
    return _unpad(dk, D), _unpad(dv, D)


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        alibi_slopes: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the attention whose forward gave (o, lse): delta as a
    PyTorch reduction, then kernels A' and A'' (their plain version on the
    CPU)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         sm_scale=sm_scale, alibi_slopes=alibi_slopes)
    delta = _delta(o, do)
    kw = dict(causal=causal, sm_scale=sm_scale, alibi_slopes=alibi_slopes)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Kernel A forward, kernels A' and A'' backward (the JAX custom VJP of
    ``_flash_bhsd``): the forward keeps q, k, v, o and the fp32 lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, alibi_slopes):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                     alibi_slopes=alibi_slopes)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale, ctx.alibi_slopes = causal, sm_scale, alibi_slopes
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        # the backward is kernels A' and A'' (their plain version on the
        # CPU), not differentiable ops: a second derivative raises
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal,
                                         sm_scale=ctx.sm_scale,
                                         alibi_slopes=ctx.alibi_slopes)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    segment_mask: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None,
                    alibi_slopes: Optional[torch.Tensor] = None,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """The public attention on ``[B, S, NH, D]`` (the JAX ``flash_attention``,
    ``flash_attention.py:322``), differentiable in q, k and v.

    GQA-native: k/v may carry KVH < NH heads.  ``alibi_slopes`` ``[NH]``
    builds the bias inside the kernels from the indices.  ``segment_mask``
    (a ``[B, Sk]`` keep-mask) goes to the plain attention with the KV heads
    repeated, as the JAX function does.  ``q_offset`` places query i at
    position ``q_offset + i``; it is forward-only, as in JAX, and raises
    when an input requires grad."""
    B, Sq, NH, D = q.shape
    KVH = k.shape[2]
    if NH % KVH != 0:
        raise ValueError(f"n_heads {NH} not a multiple of kv heads {KVH}")
    if segment_mask is not None:
        from ..models.transformer import _repeat_kv, xla_attention

        bias = None
        if alibi_slopes is not None:
            # end-aligned like xla_attention's causal mask: query i sits at
            # position Sk - Sq + i
            Sk = k.shape[1]
            rel = ((Sk - Sq + torch.arange(Sq, device=q.device))[:, None]
                   - torch.arange(Sk, device=q.device)[None, :]).float()
            bias = -alibi_slopes.to(q.device).float()[None, :, None, None] * rel
        return xla_attention(q, _repeat_kv(k, NH // KVH), _repeat_kv(v, NH // KVH), causal,
                             segment_mask, bias=bias)
    if q_offset is not None:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "flash_attention: q_offset is forward-only (the backward kernels take no "
                "offset, as in the JAX package); call it under torch.no_grad()")
        return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                   alibi_slopes=alibi_slopes, q_offset=int(q_offset))[0]
    return _FlashAttention.apply(q, k, v, causal, sm_scale, alibi_slopes)
