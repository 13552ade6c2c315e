"""Evoformer attention (DS4Science ``DS4Sci_EvoformerAttention``): the CUDA
kernels ``csrc/evoformer_attn.cu`` — E (forward), E' (dQ and dbias1) and
E'' (dK, dV and dbias2) — their plain PyTorch versions, the autograd
function over them, and the dispatcher users call.

Counterpart of both ``deepspeed_tpu/ops/evoformer_attn.py`` (the XLA
formulation and the dispatch rule) and ``deepspeed_tpu/ops/pallas/
evoformer_attn.py`` (the TPU kernels ``_fwd_kernel``, ``_bwd_dq_kernel``,
``_bwd_dkv_kernel`` and their custom VJP ``_evo_core``).  Layout is the
JAX package's: q/k/v ``[B, S, N, H, D]`` (batch, MSA rows, residues,
heads, head dim); attention runs over N for each (b, s, h), with up to two
additive biases, ``bias1 [B, S, 1, 1, K]`` (the row mask) and ``bias2
[B, 1, H, Q, K]`` (the pair bias).  The kernels read q/k/v through their
strides, so no transpose is made.

:func:`evoformer_attention` follows the JAX dispatch rule word for word:
``impl="auto"`` takes the kernels only for 5-D operands with the exact
bias layouts and D in {16, 32, 64, 128}; every other call takes
:func:`evoformer_attention_xla`, as JAX takes its XLA path — that branch is
the reference's design, not a fallback, and
``evoformer_attention.plain_calls`` counts it.  The kernel branch is
:class:`_EvoformerAttention`; each of its passes (:func:`evoformer_attn_fwd`,
:func:`evoformer_attn_bwd_dq`, :func:`evoformer_attn_bwd_dkv`) launches its
kernel for CUDA tensors and runs its plain version for CPU tensors, and
counts its launches in ``launches``.

Gradients come back as JAX's autodiff returns them: the kernel branch casts
the biases to fp32 ``[B, S, K]`` / ``[B, H, Q, K]`` outside the autograd
function, so autograd reshapes dbias1 to ``[B, S, 1, 1, K]`` and dbias2 to
``[B, 1, H, Q, K]`` in each bias's dtype; a ``None`` slot has no gradient.
The bias gradients are sums taken in a fixed order (no float atomics), so
the card's gradients repeat bit for bit from call to call.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import op_builder

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
#: the kernels' query and key tile
TILE = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_STRIDES = [_L] * 12  # q, k, v: (batch, row, residue, head)
_SIG = {
    "dstpu_evoformer_attn_fwd": [_P] * 7 + [_I] * 7 + [_F, _I] + _STRIDES + [_P],
    "dstpu_evoformer_attn_bwd_dq": [_P] * 12 + [_I] * 7 + [_F] + [_I] * 4 + _STRIDES
    + [_L] * 4 + [_P],
    "dstpu_evoformer_attn_bwd_dkv": [_P] * 13 + [_I] * 7 + [_F] + [_I] * 4 + _STRIDES
    + [_L] * 4 + [_P],
    "dstpu_evoformer_attn_dkv_qranges": [_I] * 4,
    "dstpu_evoformer_attn_dq_plan": [_I] * 9 + [_P],
}


class DqPlan(NamedTuple):
    """Kernel E''s plan for a shape, as the library answers it."""

    kranges: int    #: key ranges (a grid axis; dQ partials added in order above 1)
    chunks: int     #: chunks of a (b, s)'s work (dbias1 partials added in order above 1)
    resident: int   #: bf16/fp16: 1 when a head's K/V tiles stay for all its steps
    kv_stages: int  #: bf16/fp16: K/V tiles held (resident) or the ring's stages
    q_stages: int   #: bf16/fp16: the Q/dO ring's stages
    b2_stages: int  #: bf16/fp16: the bias2 ring's stages


# ---------------------------------------------------------------------------
# the XLA formulation and the dispatcher (deepspeed_tpu/ops/evoformer_attn.py)
# ---------------------------------------------------------------------------
def evoformer_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            biases: Sequence[Optional[torch.Tensor]] = ()) -> torch.Tensor:
    """The unfused formulation (materializes the ``[..., H, Q, K]`` scores):
    scores in fp32 plus every bias broadcast, softmax, probabilities
    rounded to q's dtype before PV (``evoformer_attn.py:26-39``)."""
    if len(biases) > 2:
        raise ValueError("evoformer attention takes at most two biases")
    d = q.shape[-1]
    scores = torch.einsum("...qhd,...khd->...hqk", q, k).float()
    scores = scores / math.sqrt(d)
    for b in biases:
        if b is not None:
            scores = scores + b.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("...hqk,...khd->...qhd", probs, v)


def evoformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        biases: Sequence[Optional[torch.Tensor]] = (),
                        impl: str = "auto") -> torch.Tensor:
    """DS4Sci_EvoformerAttention semantics.  q/k/v ``[B, S, N, H, D]``;
    ``biases``: up to two (``bias1 [B, S, 1, 1, K]``, ``bias2 [B, 1, H, Q,
    K]``).  Returns ``[B, S, N, H, D]``.

    ``impl`` keeps the JAX package's names: ``"pallas"`` = kernels E, E',
    E'' under autograd (their plain passes on the CPU); ``"xla"`` = the
    unfused formulation; ``"auto"`` takes the kernels when the operands are
    5-D with the exact bias layouts per position and D in {16, 32, 64, 128},
    else the formulation."""
    if len(biases) > 2:
        raise ValueError("evoformer attention takes at most two biases")
    use_kernel = impl == "pallas"
    if impl == "auto" and q.ndim == 5:
        B, S, Q, H, D = q.shape
        K = k.shape[2]
        # per-POSITION shapes: biases[0] is the mask bias and biases[1] the
        # pair bias; a lone pair-shaped bias in slot 0 broadcasts through
        # the formulation
        shapes_ok = (
            (len(biases) < 1 or biases[0] is None
             or tuple(biases[0].shape) == (B, S, 1, 1, K))
            and (len(biases) < 2 or biases[1] is None
                 or tuple(biases[1].shape) == (B, 1, H, Q, K)))
        use_kernel = shapes_ok and D in HEAD_DIMS
    if use_kernel:
        return evoformer_attention_kernel(q, k, v, biases)
    evoformer_attention.plain_calls += 1
    return evoformer_attention_xla(q, k, v, biases)


evoformer_attention.plain_calls = 0

# torch-API-compatible alias
DS4Sci_EvoformerAttention = evoformer_attention


def evoformer_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               biases: Sequence[Optional[torch.Tensor]] = ()) -> torch.Tensor:
    """The fused path (``evoformer_attention_pallas``): the biases checked
    against their layouts and cast to fp32 ``[B, S, K]`` / ``[B, H, Q, K]``,
    then :class:`_EvoformerAttention`."""
    if len(biases) > 2:
        raise ValueError("evoformer attention takes at most two biases")
    B, S, Q, H, D = q.shape
    K = k.shape[2]
    b1 = biases[0] if len(biases) > 0 else None
    b2 = biases[1] if len(biases) > 1 else None
    if b1 is not None:
        if tuple(b1.shape) != (B, S, 1, 1, K):
            raise ValueError(f"bias1 must be [B,S,1,1,K]; got {tuple(b1.shape)}")
        b1 = b1.reshape(B, S, K).float().contiguous()
    if b2 is not None:
        if tuple(b2.shape) != (B, 1, H, Q, K):
            raise ValueError(f"bias2 must be [B,1,H,Q,K]; got {tuple(b2.shape)}")
        b2 = b2.reshape(B, H, Q, K).float().contiguous()
    return _EvoformerAttention.apply(q, k, v, b1, b2)


class _EvoformerAttention(torch.autograd.Function):
    """Kernel E forward; delta, then kernels E' and E'' backward (the JAX
    custom VJP ``_evo_core``).  Saves q, k, v, the fp32 biases, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, b1, b2):
        o, lse = evoformer_attn_fwd(q, k, v, b1, b2)
        ctx.save_for_backward(q, k, v, b1, b2, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, b1, b2, o, lse = ctx.saved_tensors
        return evoformer_attn_bwd(q, k, v, o, lse, do, b1, b2)


# ---------------------------------------------------------------------------
# plain versions of the passes
# ---------------------------------------------------------------------------
def _scores(q, k, b1, b2):
    """fp32 scores ``[B, S, H, Q, K]`` with the biases added in the
    kernels' order."""
    s = torch.einsum("bsqhd,bskhd->bshqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    if b1 is not None:
        s = s + b1.float()[:, :, None, None, :]
    if b2 is not None:
        s = s + b2.float()[:, None]
    return s


def evoformer_attn_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             b1: Optional[torch.Tensor] = None,
                             b2: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel E, fp32 inside as the TPU kernel:
    (o ``[B, S, Q, H, D]`` in q's dtype, lse ``[B, S, H, Q]`` fp32).
    ``b1`` ``[B, S, K]``, ``b2`` ``[B, H, Q, K]`` or None.  The output is
    normalized by the row's sum, as the kernel's is: ``exp(s - lse)`` would
    not be for a row masked by -1e9, whose fp32 lse cannot hold log K."""
    s = _scores(q, k, b1, b2)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bshqk,bskhd->bsqhd", p, v.float())
    return o.to(q.dtype), lse


def evoformer_attn_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                             b1: Optional[torch.Tensor] = None,
                             b2: Optional[torch.Tensor] = None):
    """The plain version of kernels E' and E'': P recomputed from ``lse``,
    dS = P (dO V^T - delta), dq = scale dS K, dk = scale dS^T Q, dv = P^T dO,
    dbias1 = dS summed over (h, q) ``[B, S, K]`` and dbias2 = dS summed over
    s ``[B, H, Q, K]``, all in fp32.  Returns (dq, dk, dv, db1, db2), the
    first three in q's, k's and v's dtypes, a bias gradient None where its
    bias is."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, b1, b2) - lse.float()[..., None])
    dp = torch.einsum("bsqhd,bskhd->bshqk", do.float(), v.float())
    ds = p * (dp - delta.float()[..., None])
    dq = torch.einsum("bshqk,bskhd->bsqhd", ds, k.float()) * scale
    dk = torch.einsum("bshqk,bsqhd->bskhd", ds, q.float()) * scale
    dv = torch.einsum("bshqk,bsqhd->bskhd", p, do.float())
    db1 = ds.sum((2, 3)) if b1 is not None else None
    db2 = ds.sum(1) if b2 is not None else None
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), db1, db2


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(o * dO) in fp32 as ``[B, S, H, Q]`` (``evoformer_attn.py:261``)."""
    return (o.float() * do.float()).sum(-1).transpose(2, 3).contiguous()


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
def _rows_ok(t: torch.Tensor) -> bool:
    if t.stride(4) != 1:
        return False
    if t.dtype == torch.float32:
        return True
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:4])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _dims(q, k):
    if q.ndim != 5 or k.ndim != 5:
        raise ValueError(f"evoformer kernels take [B, S, N, H, D]; got {tuple(q.shape)}")
    B, S, Q, H, D = q.shape
    K = k.shape[2]
    if k.shape != (B, S, K, H, D):
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    return B, S, Q, K, H, D


def _checks(q, k, v, b1, b2, extra=()):
    """Device, dtype, shape and layout checks of a kernel launch; returns the
    dims and q/k/v/extra with rows the kernels can read."""
    B, S, Q, K, H, D = _dims(q, k)
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} does not match k {tuple(k.shape)}")
    tensors = (q, k, v, *extra)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("evoformer kernels: every tensor on one CUDA device")
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"evoformer kernels: q/k/v/dO dtypes differ: "
                        f"{[t.dtype for t in tensors]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"evoformer kernels: head_dim {D} not in {HEAD_DIMS}")
    for name, t, shape in (("bias1", b1, (B, S, K)), ("bias2", b2, (B, H, Q, K))):
        if t is not None and (tuple(t.shape) != shape or t.dtype != torch.float32
                              or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"evoformer kernels: {name} must be contiguous fp32 {shape} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    rows = tuple(t if _rows_ok(t) else t.contiguous() for t in tensors)
    return (B, S, Q, K, H, D), rows


#: a block's shared memory on the H100 as the kernels opt in to it, and
#: what the resident-bias kernel keeps out of it (alignment, barriers)
_SMEM = 232448 - 2048
_SMEM_FIXED = 1024 + 256
#: the resident-bias kernel's deepest ring (stages per warpgroup)
FWD_MAX_STAGES = 4


def fwd_stages(dtype: torch.dtype, K: int, D: int, has_b2: bool) -> int:
    """Kernel E's ring for these shapes: the stages per warpgroup of the
    resident-bias tensor-core kernel, or 0 for the tile kernel (fp32, or a
    pair bias too wide to keep: its [64][K] rows, times log2(e), stay in
    shared memory beside two warpgroups' double-buffered Q tiles and bias1
    rows and rings of K and V tiles of 128 keys (64 past D = 64), and at
    least two stages must fit; at D = 32 that is K up to 512)."""
    if dtype == torch.float32:
        return 0
    bk = 128 if D <= 64 else 64           # keys per tile
    cols = _cdiv(K, bk) * bk
    bias = 4 * TILE * (cols + 8) if has_b2 else 0
    bias += 4 * 2 * 2 * cols              # each warpgroup's two bias1 rows
    free = _SMEM - _SMEM_FIXED - bias - 4 * TILE * D * 2  # two Q tiles per warpgroup
    stages = free // (4 * bk * D * 2)     # a K and a V tile per warpgroup
    return min(FWD_MAX_STAGES, stages) if stages >= 2 else 0


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:4]]


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def evoformer_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       b1: Optional[torch.Tensor] = None, b2: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel E: (o ``[B, S, Q, H, D]`` in q's dtype, lse ``[B, S, H, Q]``
    fp32).  ``b1`` fp32 ``[B, S, K]``, ``b2`` fp32 ``[B, H, Q, K]`` or None."""
    if q.device.type == "cpu":
        return evoformer_attn_fwd_plain(q, k, v, b1, b2)
    (B, S, Q, K, H, D), (q, k, v) = _checks(q, k, v, b1, b2)
    stages = fwd_stages(q.dtype, K, D, b2 is not None)
    if stages:  # TMA maps take positive strides only
        q, k, v = (t if min(t.stride()[:4]) > 0 else t.contiguous() for t in (q, k, v))
    o = torch.empty((B, S, Q, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, S, H, Q), dtype=torch.float32, device=q.device)
    lib = op_builder.load("evoformer_attn", _SIG)
    with torch.cuda.device(q.device):
        err = lib.dstpu_evoformer_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(b1), _ptr(b2), o.data_ptr(),
            lse.data_ptr(), op_builder.dtype_code(q.dtype), B, S, Q, K, H, D,
            1.0 / math.sqrt(D), stages, *_strides(q, k, v),
            torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "evoformer_attn_fwd")
    evoformer_attn_fwd.launches += 1
    return o, lse


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _bwd_inputs(q, k, v, do, lse, delta, b1, b2):
    dims, (q, k, v, do) = _checks(q, k, v, b1, b2, (do,))
    B, S, Q, K, H, D = dims
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} does not match q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, S, H, Q) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 [B, S, H, Q], got {t.dtype} "
                             f"{tuple(t.shape)}")
    return dims, (q, k, v, do)


def evoformer_attn_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                          b1: Optional[torch.Tensor] = None, b2: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel E': (dq in q's dtype, dbias1 fp32 ``[B, S, K]`` or None when
    ``b1`` is None), from the forward's ``lse`` and ``delta`` = rowsum(o *
    dO), both fp32 ``[B, S, H, Q]``."""
    if q.device.type == "cpu":
        dq, _, _, db1, _ = evoformer_attn_bwd_plain(q, k, v, do, lse, delta, b1, b2)
        return dq, db1
    (B, S, Q, K, H, D), (q, k, v, do) = _bwd_inputs(q, k, v, do, lse, delta, b1, b2)
    want = b1 is not None
    if q.dtype == torch.float32:  # the FMA kernel
        ldb, ldq = K, Q
    else:
        # the wgmma kernel: TMA maps take positive strides, and the bias,
        # lse and delta rows move in 16-byte chunks
        q, k, v, do = (t if min(t.stride()[:4]) > 0 else t.contiguous() for t in (q, k, v, do))
        ldb, ldq = _cdiv(K, 4) * 4, _cdiv(Q, 4) * 4
        b1, b2 = _padded_rows(b1, ldb), _padded_rows(b2, ldb)
        lse, delta = _padded_rows(lse, ldq), _padded_rows(delta, ldq)
    # the library's plan: the key axis in ranges whose dbias1 rows fit a
    # block (each range's dQ rows fp32 partials that the kernel's second
    # pass adds in range order), and the chunks of a (b, s)'s work (their
    # dbias1 partials added in chunk order)
    plan = dq_plan(q.dtype, B, S, Q, K, H, D, want, b2 is not None)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    db1 = torch.empty((B, S, K), dtype=torch.float32, device=q.device) if want else None
    part = (torch.empty((B * S, plan.chunks, K), dtype=torch.float32, device=q.device)
            if want and plan.chunks > 1 else None)
    dq_part = (torch.empty((plan.kranges, q.numel()), dtype=torch.float32, device=q.device)
               if plan.kranges > 1 else None)
    lib = op_builder.load("evoformer_attn", _SIG)
    with torch.cuda.device(q.device):
        err = lib.dstpu_evoformer_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(b1), _ptr(b2), dq.data_ptr(), _ptr(db1), _ptr(part),
            _ptr(dq_part), op_builder.dtype_code(q.dtype), B, S, Q, K, H, D,
            1.0 / math.sqrt(D), plan.chunks, plan.kranges, ldb, ldq, *_strides(q, k, v, do),
            torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "evoformer_attn_bwd_dq")
    evoformer_attn_bwd_dq.launches += 1
    return dq, db1


def dq_plan(dtype, B: int, S: int, Q: int, K: int, H: int, D: int, want_db1: bool,
            has_b2: bool) -> DqPlan:
    """Kernel E''s plan on the card, the library's own (nothing here mirrors
    its shared-memory sums): the key ranges (1 while the dbias1 rows of the
    whole key axis fit a block beside the tiles, more past that), the
    chunks, and in bf16/fp16 whether K and V stay resident per head and the
    rings' stages."""
    lib = op_builder.load("evoformer_attn", _SIG)
    out = (ctypes.c_int * 6)()
    op_builder.check(lib.dstpu_evoformer_attn_dq_plan(
        op_builder.dtype_code(dtype), B, S, Q, K, H, D, int(want_db1), int(has_b2), out),
        "evoformer_attn_dq_plan")
    return DqPlan(*out)


def dkv_query_ranges(dtype, Q: int, D: int, want_db2: bool) -> int:
    """How many query ranges kernel E'' cuts Q into on the card: 1 while its
    dbias2 accumulator over the whole query axis fits a block, more past
    that (the kernel's own rule, asked of the built library)."""
    lib = op_builder.load("evoformer_attn", _SIG)
    return lib.dstpu_evoformer_attn_dkv_qranges(op_builder.dtype_code(dtype), Q, D,
                                                int(want_db2))


def dkv_chunks(S: int, blocks: int, sms: int, want_db2: bool) -> int:
    """Chunks of the MSA rows s that kernel E'' splits each (b, h, key tile,
    query range) into.  Without bias2 every s is a chunk.  With it (one
    block per SM: the dbias2 accumulator fills shared memory) the chunks
    make the grid cover the SMs about four times (48 blocks at AlphaFold
    2's MSA row attention before chunks, 528 with 11), and their fp32
    dbias2 partials are added in chunk order by the second pass."""
    if not want_db2:
        return S
    return min(S, max(1, _cdiv(4 * sms, blocks)))


def _padded_rows(t: Optional[torch.Tensor], width: int) -> Optional[torch.Tensor]:
    """``t`` (fp32, contiguous) with its last dim zero-padded to ``width``
    and 16-byte aligned: kernel E'' copies these rows in whole 16-byte
    chunks.  ``t`` itself when it is already so."""
    if t is None or (t.shape[-1] == width and t.data_ptr() % 16 == 0):
        return t
    return torch.nn.functional.pad(t, (0, width - t.shape[-1])).contiguous()


def evoformer_attn_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                           b1: Optional[torch.Tensor] = None, b2: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Kernel E'': (dk, dv in k's dtype, dbias2 fp32 ``[B, H, Q, K]`` or
    None when ``b2`` is None)."""
    if q.device.type == "cpu":
        _, dk, dv, _, db2 = evoformer_attn_bwd_plain(q, k, v, do, lse, delta, b1, b2)
        return dk, dv, db2
    (B, S, Q, K, H, D), (q, k, v, do) = _bwd_inputs(q, k, v, do, lse, delta, b1, b2)
    want = b2 is not None
    lib = op_builder.load("evoformer_attn", _SIG)
    dtype = op_builder.dtype_code(q.dtype)
    if q.dtype == torch.float32:  # the FMA kernel
        ldb, ldq = K, Q
    else:
        # the wgmma kernel: TMA maps take positive strides, and the bias,
        # lse and delta rows move in 16-byte chunks
        q, k, v, do = (t if min(t.stride()[:4]) > 0 else t.contiguous() for t in (q, k, v, do))
        ldb, ldq = _cdiv(K, 4) * 4, _cdiv(Q, 4) * 4
        b1, b2 = _padded_rows(b1, ldb), _padded_rows(b2, ldb)
        lse, delta = _padded_rows(lse, ldq), _padded_rows(delta, ldq)
    # the query axis in ranges whose dbias2 accumulators fit a block; each
    # range's dK/dV are fp32 partials that the kernel's second pass adds in
    # range order
    qranges = dkv_query_ranges(q.dtype, Q, D, want)
    chunks = dkv_chunks(S, B * H * _cdiv(K, TILE) * qranges, _sm_count(q.device), want)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    db2 = torch.empty((B, H, Q, K), dtype=torch.float32, device=q.device) if want else None
    part = (torch.empty((B * H, chunks, Q * K), dtype=torch.float32, device=q.device)
            if want and chunks > 1 else None)
    kv_part = (torch.empty((qranges, 2, k.numel()), dtype=torch.float32, device=q.device)
               if qranges > 1 else None)
    with torch.cuda.device(q.device):
        err = lib.dstpu_evoformer_attn_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(b1), _ptr(b2), dk.data_ptr(), dv.data_ptr(), _ptr(db2),
            _ptr(part), _ptr(kv_part), dtype, B, S, Q, K, H, D, 1.0 / math.sqrt(D),
            chunks, qranges, ldb, ldq, *_strides(q, k, v, do),
            torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "evoformer_attn_bwd_dkv")
    evoformer_attn_bwd_dkv.launches += 1
    return dk, dv, db2


evoformer_attn_fwd.launches = 0
evoformer_attn_bwd_dq.launches = 0
evoformer_attn_bwd_dkv.launches = 0


def evoformer_attn_bwd(q, k, v, o, lse, do, b1=None, b2=None):
    """(dq, dk, dv, dbias1, dbias2) of the attention whose forward gave
    (o, lse): delta as a PyTorch reduction, then kernels E' and E'' (their
    plain version on the CPU)."""
    delta = _delta(o, do)
    if q.device.type == "cpu":
        return evoformer_attn_bwd_plain(q, k, v, do, lse, delta, b1, b2)
    dq, db1 = evoformer_attn_bwd_dq(q, k, v, do, lse, delta, b1, b2)
    dk, dv, db2 = evoformer_attn_bwd_dkv(q, k, v, do, lse, delta, b1, b2)
    return dq, dk, dv, db1, db2
