"""Paged decode attention: the CUDA kernel ``csrc/paged_attention.cu`` and
its plain PyTorch version.

Replaces the TPU kernel ``deepspeed_tpu/ops/pallas/paged_attention.py``
``_decode_kernel``: one query per sequence attends over its KV pages in
place through the page table, with GQA groups folded next to their KV
head, optional int8 pages with per-(page, slot, head) fp32 scales, and
optional ALiBi.  Slots past each sequence's position are masked.

:func:`paged_decode_attention` launches the kernel for CUDA tensors and
runs :func:`paged_decode_attention_plain` for CPU tensors.  Each launch
adds one to ``paged_decode_attention.launches``.

The plain version is the gather formulation of ``model_runner.
_gather_window_attend`` (:344): it materialises ``[B, MP * ps, KVH, D]``
and masks.  It therefore reads the trash page and every page past the
position, and a NaN stored there would reach its output through
``0 * NaN``; the kernel never loads those pages.  The kernel keeps the
probabilities and the output sums in fp32 and rounds only its output:
held against the plain version computed in fp32 from the same inputs, it
differs by no more than that rounding (``chip_smoke.PAGED_TOL``).  The
plain version in bf16 also casts the probabilities to bf16 before the PV
product, as the JAX programs do.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import op_builder
from .flash_attention import check_head_dim, padded_head_dim

NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
#: head dims past 256 (the runtime-head-dim kernel): pages of one sequence
#: each block takes; longer tables are split across blocks and merged by a
#: second kernel
PAGES_PER_SPLIT = 8
#: up to 256: the most blocks (one thread-block cluster) that share one
#: sequence's pages, the blocks per SM the split count aims at, the most
#: query rows of one kv head a block takes, and the most slots of a page a
#: block stages at a time
MAX_SPLIT = 8
BLOCKS_PER_SM = 2
MAX_ROWS = 8
MAX_CHUNK = 16
_SIG = {
    "dstpu_paged_decode_attention": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P,  # q k v k_scale v_scale table positions slopes out
        _I, _I, _I, _I, _I, _I, _I, _I, _I,  # dtype quant B NH KVH D ps MP P
        _I, _I, _I, _I,                      # n_split rows chunk tma
        ctypes.c_float, _P],                 # scale stream
    "dstpu_paged_decode_resident": [_I] * 7,  # dtype quant D ps MP rows chunk
    "dstpu_paged_decode_attention_wide": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # ... out part
        _I, _I, _I, _I, _I, _I, _I, _I,          # dtype quant B NH KVH D ps MP
        _I, ctypes.c_float, _P],                 # pages_per_split scale stream
}


def row_groups(G: int) -> Tuple[int, int]:
    """(row groups, query rows a block) up to head dim 256: a kv head's
    ``G`` query rows go to one block while they are at most ``MAX_ROWS``
    (every K/V byte then read once for the group); more (falcon-7b's 71
    over one KV head) are cut into the fewest groups of at most
    ``MAX_ROWS`` rows, near-equal, over a grid axis, so that a block's
    accumulators fit shared memory at every head dim."""
    n = -(-G // MAX_ROWS)
    return n, -(-G // n)


def page_chunk(ps: int) -> int:
    """Slots a block stages at a time up to head dim 256: the largest
    divisor of the page size ``ps`` up to ``MAX_CHUNK``, so that a stage
    stays small at any page size (a page of 16 slots is one chunk; 128 or
    256 slots, eight or sixteen) and no chunk straddles two pages."""
    return max(c for c in range(1, min(ps, MAX_CHUNK) + 1) if ps % c == 0)


def split_count(B: int, KVH: int, MP: int, sms: int, groups: int = 1,
                resident: int = BLOCKS_PER_SM) -> int:
    """Blocks per (sequence, kv head, row group) up to head dim 256, one
    cluster whose blocks each take an equal run of the sequence's live
    chunks and merge through distributed shared memory: enough that the
    grid holds about ``BLOCKS_PER_SM`` blocks an SM, but never more than
    the ``resident`` blocks an SM holds at once (the kernel's shared memory
    decides: one at Mixtral-8x7b's decode shape, three at llama-1b's), so
    the grid runs in one wave; at most ``MAX_SPLIT`` (a portable cluster)
    and at most the table's ``MP`` pages; 1 once ``B * KVH * groups``
    covers the SMs."""
    per_sm = max(1, min(BLOCKS_PER_SM, resident))
    target = per_sm * sms // max(1, B * KVH * groups)
    return max(1, min(MAX_SPLIT, MP, target))


@functools.lru_cache(maxsize=None)
def resident_blocks(dtype: torch.dtype, quant: bool, D: int, ps: int, MP: int,
                    rows: int) -> int:
    """Blocks of the kernel (head dim up to 256) one SM of the current card
    holds at once for these shapes: the built library's own answer, from
    its shared-memory plan, warps and registers."""
    lib = op_builder.load("paged_attention", _SIG)
    return lib.dstpu_paged_decode_resident(op_builder.dtype_code(dtype), int(quant), D, ps, MP,
                                           rows, page_chunk(ps))


def tma_pages(D: int) -> bool:
    """Whether the kernel copies its chunks by TMA (else by cp.async): the
    rows are the kernel's full width (D a multiple of 16, of 32 past 128),
    so every row and stride is a whole number of 16-byte vectors (TMA's
    stride rule) and the box is one row.  Head dims off those widths are
    read in place by cp.async, their tails zero-filled; past 256 the
    runtime-head-dim kernel reads device memory directly."""
    return D <= 256 and padded_head_dim(D) == D


def gather_window_attend(q: torch.Tensor, k_c: torch.Tensor, v_c: torch.Tensor,
                         page_table: torch.Tensor, vis: torch.Tensor,
                         q_pos: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None,
                         alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T] queries attend the pooled pages through a gather — the one
    formulation of ``_gather_window_attend`` (dequant, GQA, ALiBi, mask,
    fp32 softmax).  q ``[B, T, NH, D]``; pools ``[P, ps, KVH, D]``;
    page_table ``[B, MP]``; vis ``[B, T, S]`` visibility over pool slots;
    q_pos ``[B, T]``.  Returns ``[B, T, NH * D]``."""
    B, T, NH, D = q.shape
    S = vis.shape[2]
    KVH = k_c.shape[2]
    table = page_table.long()
    kk = k_c[table].reshape(B, S, KVH, D)
    vv = v_c[table].reshape(B, S, KVH, D)
    if k_scale is not None:
        kk = (kk.float() * k_scale[table].reshape(B, S, KVH)[..., None]).to(q.dtype)
        vv = (vv.float() * v_scale[table].reshape(B, S, KVH)[..., None]).to(q.dtype)
    g = NH // KVH
    if g > 1:
        kk = torch.repeat_interleave(kk, g, dim=2)
        vv = torch.repeat_interleave(vv, g, dim=2)
    scores = torch.einsum("btnd,bsnd->bnts", q, kk).float() / math.sqrt(D)
    if alibi_slopes is not None:
        rel = (q_pos[:, :, None] - torch.arange(S, device=q.device)[None, None, :]).float()
        scores = scores + (-alibi_slopes.float()[:, None, None]) * rel[:, None]
    scores = torch.where(vis[:, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnts,bsnd->btnd", probs, vv).reshape(B, T, NH * D)


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, page_table: torch.Tensor,
                                 positions: torch.Tensor,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None,
                                 alibi_slopes: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """The plain version (same signature as the kernel wrapper)."""
    B, NH, D = q.shape
    S = page_table.shape[1] * k_pool.shape[1]
    vis = torch.arange(S, device=q.device)[None, None, :] <= positions[:, None, None]
    out = gather_window_attend(q[:, None], k_pool, v_pool, page_table, vis,
                               positions[:, None], k_scale, v_scale, alibi_slopes)
    return out.reshape(B, NH, D)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           page_table: torch.Tensor, positions: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q ``[B, NH, D]``; pools ``[P, ps, KVH, D]`` (int8 codes when
    ``k_scale``/``v_scale`` ``[P, ps, KVH]`` are given); page_table
    ``[B, MP]`` int32; positions ``[B]`` int32 (the slot of the current
    token); ``alibi_slopes`` optional ``[NH]``.  Returns ``[B, NH, D]``."""
    B, NH, D = q.shape
    P, ps, KVH, Dk = k_pool.shape
    MP = page_table.shape[1]
    quant = k_scale is not None
    if Dk != D or NH % KVH != 0 or v_pool.shape != k_pool.shape:
        raise ValueError(f"q {tuple(q.shape)} vs pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)}")
    if quant != (v_scale is not None):
        raise ValueError("k_scale and v_scale go together")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, page_table, positions,
                                            k_scale, v_scale, alibi_slopes)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: q on {q.device}")
    tensors = [q, k_pool, v_pool, page_table, positions]
    if quant:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"paged_decode_attention: tensor on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError("paged_decode_attention takes contiguous tensors "
                             "(a layer's pool is pools[name][layer])")
    if page_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("page_table and positions must be int32")
    if quant:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError("quantized pools must be int8")
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError("pool scales must be fp32")
        if k_scale.shape != (P, ps, KVH) or v_scale.shape != (P, ps, KVH):
            raise ValueError(f"scale shape {tuple(k_scale.shape)} != {(P, ps, KVH)}")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pool dtype {k_pool.dtype} != q dtype {q.dtype}")
    check_head_dim(D, "paged_decode_attention")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_decode_attention copies pool rows 16 bytes at a time: "
                         "the pools must be 16-byte aligned")
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).contiguous()
        if slopes.shape != (NH,):
            raise ValueError(f"alibi_slopes shape {tuple(slopes.shape)} != ({NH},)")
    out = torch.empty_like(q)
    lib = op_builder.load("paged_attention", _SIG)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
            page_table.data_ptr(), positions.data_ptr(),
            None if slopes is None else slopes.data_ptr(), out.data_ptr())
    dims = (op_builder.dtype_code(q.dtype), int(quant), B, NH, KVH, D, ps, MP)
    with torch.cuda.device(q.device):
        if D <= 256:
            groups, rows = row_groups(NH // KVH)
            n_split = split_count(B, KVH, MP, _sm_count(q.device), groups,
                                  resident_blocks(q.dtype, quant, D, ps, MP, rows))
            err = lib.dstpu_paged_decode_attention(
                *ptrs, *dims, P, n_split, rows, page_chunk(ps), int(tma_pages(D)),
                1.0 / math.sqrt(D), stream)
        else:  # the runtime-head-dim kernel; runs of pages merged by a second kernel
            runs = -(-MP // PAGES_PER_SPLIT)
            part = (torch.empty((B * KVH * runs * (NH // KVH) * (D + 2),),
                                dtype=torch.float32, device=q.device) if runs > 1 else None)
            err = lib.dstpu_paged_decode_attention_wide(
                *ptrs, None if part is None else part.data_ptr(), *dims, PAGES_PER_SPLIT,
                1.0 / math.sqrt(D), stream)
    op_builder.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
