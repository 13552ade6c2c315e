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
import math
from typing import Optional

import torch

from . import op_builder
from .flash_attention import check_head_dim, padded_head_dim

NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
#: pages of one sequence each block of the kernel takes; longer tables are
#: split across blocks and merged by a second kernel
PAGES_PER_SPLIT = 8
_SIG = {"dstpu_paged_decode_attention": [
    _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # q k v k_scale v_scale table positions slopes out part
    _I, _I, _I, _I, _I, _I, _I, _I, _I,      # dtype quant B NH KVH D ps MP pages_per_split
    ctypes.c_float, _P]}                     # scale stream


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
    n_split = -(-MP // PAGES_PER_SPLIT)
    part = (torch.empty((B * KVH * n_split * (NH // KVH) * (padded_head_dim(D) + 2),),
                        dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    lib = op_builder.load("paged_attention", _SIG)
    with torch.cuda.device(q.device):
        err = lib.dstpu_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            page_table.data_ptr(), positions.data_ptr(),
            None if slopes is None else slopes.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            op_builder.dtype_code(q.dtype), int(quant), B, NH, KVH, D, ps, MP,
            PAGES_PER_SPLIT, 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
