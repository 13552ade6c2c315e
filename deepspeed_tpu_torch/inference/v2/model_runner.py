"""The paged programs (the port's counterpart of ``deepspeed_tpu/
inference/v2/model_runner.py``).

* :func:`paged_prefill` — one bucket-padded prompt: causal attention
  through the flash-attention forward, K/V scattered into the prompt's
  pages.
* :func:`paged_prefill_chunk` — one chunk of a prompt at a start offset
  (chunked prefill): the chunk's queries attend the sequence's page
  window through the flash forward with ``q_offset = start``.
* :func:`paged_decode` — one token for every decode slot: K/V written
  into each row's current page, attention through the paged decode
  kernel.

The pools are updated IN PLACE (``index_put_`` on each layer's slice of
``pools["k"]``/``pools["v"]``): that replaces the JAX engine's donation
of the pool buffers to each jitted program, and the functions return
the same dict they were given.  Scatters stay unconditional: inactive
rows and pad chunks write to the trash page (ragged.py); duplicate
indices there are harmless because no live token reads the trash page.

Every program ends each layer in ``_attn_out``, whose FFN is
``mlp_block(..., training=False)`` as in the JAX runner (:64): an MoE
layer routes every row it is given, the bucket-padded prompt rows and the
inactive decode slots included, and drops the aux loss.  The dropless MoE
runs its three expert matmuls through kernel G on a CUDA device.

Attention takes the kernels for CUDA tensors and their plain versions
for CPU tensors; the plain paged attention (the JAX runner's
``_gather_window_attend``, :344) lives beside its kernel as
``ops/paged_attention.gather_window_attend``.  One exception, kept from the JAX engine by design
(model_runner.py:277-281 there): chunked prefill with an int8 KV pool
attends through the plain formulation on every device, so that the
chunk's own keys enter at full precision exactly as in whole-prompt
prefill.  ``paged_prefill_chunk.plain_quant_calls`` counts those calls.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

from ...models.transformer import (ParamTree, TransformerConfig, _attn_out, _embed,
                                   _final_logits, _repeat_kv, alibi_slopes, attn_qkv)
from ...ops.flash_attention import flash_attention_fwd
from ...ops.paged_attention import gather_window_attend, paged_decode_attention

Pools = Dict[str, torch.Tensor]


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., KVH, D] -> (int8 codes, fp32 scale [..., KVH]) per head."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.round(xf / s[..., None]).to(torch.int8)
    return q, s


def _alibi_bias(cfg: TransformerConfig, qpos: torch.Tensor,
                kpos: torch.Tensor) -> torch.Tensor:
    """ALiBi score bias: qpos [..., Q], kpos [..., K] -> [..., NH, Q, K]."""
    rel = (qpos[..., :, None] - kpos[..., None, :]).float()
    slopes = alibi_slopes(cfg.n_heads, device=rel.device)
    return -slopes[:, None, None] * rel[..., None, :, :]


@functools.lru_cache(maxsize=None)
def _cached_slopes(n_heads: int, device: torch.device) -> torch.Tensor:
    return alibi_slopes(n_heads, device=device)


def _slopes(cfg: TransformerConfig, device) -> torch.Tensor | None:
    """ALiBi slopes, built once per (heads, device): a captured program
    must not copy a host list to the device."""
    if cfg.position != "alibi":
        return None
    return _cached_slopes(cfg.n_heads, torch.device(device))


def _write_pages(pools: Pools, layer_idx: int, rows: torch.Tensor,
                 k_pages: torch.Tensor, v_pages: torch.Tensor) -> None:
    """Scatter whole pages of fresh K/V into one layer's pools, in place
    (quantizing when the pool is int8) — shared by whole-prompt and
    chunked prefill.  rows: [n] page indices; k/v_pages [n, ps, KVH, D]."""
    k_c, v_c = pools["k"][layer_idx], pools["v"][layer_idx]
    if "k_scale" in pools:
        kq, ksc = _kv_quantize(k_pages)
        vq, vsc = _kv_quantize(v_pages)
        k_c[rows] = kq
        v_c[rows] = vq
        pools["k_scale"][layer_idx][rows] = ksc
        pools["v_scale"][layer_idx][rows] = vsc
    else:
        k_c[rows] = k_pages.to(k_c.dtype)
        v_c[rows] = v_pages.to(v_c.dtype)


@torch.no_grad()
def paged_prefill(cfg: TransformerConfig, params: ParamTree, pools: Pools,
                  ids: torch.Tensor, page_rows: torch.Tensor, length: int
                  ) -> Tuple[torch.Tensor, Pools]:
    """Prefill one prompt.

    ids: [S_pad] bucket-padded prompt; page_rows: [S_pad // page_size]
    page index per chunk (trash for pad chunks); length: real prompt
    length.  Pad tokens past ``length`` see only earlier slots (causal)
    and their outputs are discarded.  Returns (last-token logits [V],
    pools updated in place)."""
    S = ids.shape[0]
    ps = pools["k"].shape[2]
    positions = torch.arange(S, device=ids.device)[None]
    x = _embed(cfg, params, ids[None], positions)  # [1, S, H]
    rows = page_rows.long()
    slopes = _slopes(cfg, ids.device)
    for i, layer in enumerate(params.layers):
        q, k, v = attn_qkv(cfg, layer, x, positions)
        _write_pages(pools, i, rows, k[0].reshape(S // ps, ps, *k.shape[2:]),
                     v[0].reshape(S // ps, ps, *v.shape[2:]))
        attn, _ = flash_attention_fwd(q, k, v, causal=True, alibi_slopes=slopes)
        x, _ = _attn_out(cfg, layer, x, attn.reshape(1, S, -1))
    return _final_logits(cfg, params, x[:, length - 1])[0], pools


def _chunk_attend_concat(cfg: TransformerConfig, q: torch.Tensor, kp: torch.Tensor,
                         vp: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         start: int) -> torch.Tensor:
    """The JAX chunk formulation (model_runner.py:312-332): keys =
    [pooled window, masked to < start | this chunk's fresh keys, causal].
    q [1, C, NH, D]; kp/vp [S_prev, KVH, D]; k/v [1, C, KVH, D]."""
    C = q.shape[1]
    S_prev = kp.shape[0]
    dev = q.device
    kk = torch.cat([kp.to(q.dtype)[None], k], dim=1)
    vv = torch.cat([vp.to(q.dtype)[None], v], dim=1)
    g = cfg.n_heads // cfg.kv_heads
    kk, vv = _repeat_kv(kk, g), _repeat_kv(vv, g)
    scores = torch.einsum("btnd,bsnd->bnts", q, kk).float() / math.sqrt(cfg.head_dim)
    if cfg.position == "alibi":
        scores = scores + _alibi_bias(
            cfg, start + torch.arange(C, device=dev),
            torch.cat([torch.arange(S_prev, device=dev),
                       start + torch.arange(C, device=dev)]))
    prev_vis = (torch.arange(S_prev, device=dev) < start)[None, :].expand(C, S_prev)
    causal = torch.arange(C, device=dev)[:, None] >= torch.arange(C, device=dev)[None, :]
    mask = torch.cat([prev_vis, causal], dim=1)
    scores = torch.where(mask[None, None], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnts,bsnd->btnd", probs, vv).reshape(1, C, -1)


@torch.no_grad()
def paged_prefill_chunk(cfg: TransformerConfig, params: ParamTree, pools: Pools,
                        ids: torch.Tensor, chunk_rows: torch.Tensor,
                        prev_table: torch.Tensor, start: int, n: int
                        ) -> Tuple[torch.Tensor, Pools]:
    """Prefill ONE CHUNK of a prompt.

    ids: [C] chunk tokens (C a multiple of page_size); chunk_rows:
    [C // ps] pages receiving this chunk's K/V; prev_table: [MPb] the
    sequence's page-table prefix covering the window THROUGH this chunk
    (pool-slot index == global position); start: global position of
    ids[0] (a host int: the flash kernel takes it as its q_offset); n:
    valid tokens.  Returns (logits of token start+n-1 — meaningful on the
    final chunk — and the pools, updated in place)."""
    quant = "k_scale" in pools
    C = ids.shape[0]
    ps = pools["k"].shape[2]
    S_prev = prev_table.shape[0] * ps
    positions = start + torch.arange(C, device=ids.device)[None]
    x = _embed(cfg, params, ids[None], positions)
    rows = chunk_rows.long()
    table = prev_table.long()
    slopes = _slopes(cfg, ids.device)
    if quant:
        paged_prefill_chunk.plain_quant_calls += 1
    for i, layer in enumerate(params.layers):
        q, k, v = attn_qkv(cfg, layer, x, positions)
        _write_pages(pools, i, rows, k[0].reshape(C // ps, ps, *k.shape[2:]),
                     v[0].reshape(C // ps, ps, *v.shape[2:]))
        k_c, v_c = pools["k"][i], pools["v"][i]
        kp = k_c[table].reshape(S_prev, *k_c.shape[2:])
        vp = v_c[table].reshape(S_prev, *v_c.shape[2:])
        if quant:
            kp = kp.float() * pools["k_scale"][i][table].reshape(S_prev, -1)[..., None]
            vp = vp.float() * pools["v_scale"][i][table].reshape(S_prev, -1)[..., None]
            attn = _chunk_attend_concat(cfg, q, kp, vp, k, v, start)
        else:
            # the window covers the chunk's own slots: offset-flash's causal
            # mask handles previous chunks, in-chunk causality and the
            # trash/pad slots (they sit above every real query)
            attn, _ = flash_attention_fwd(q, kp.to(x.dtype)[None], vp.to(x.dtype)[None],
                                          causal=True, q_offset=start, alibi_slopes=slopes)
            attn = attn.reshape(1, C, -1)
        x, _ = _attn_out(cfg, layer, x, attn)
    return _final_logits(cfg, params, x[:, n - 1])[0], pools


paged_prefill_chunk.plain_quant_calls = 0


@torch.no_grad()
def paged_decode(cfg: TransformerConfig, params: ParamTree, pools: Pools,
                 last_tokens: torch.Tensor, positions: torch.Tensor,
                 page_table: torch.Tensor, active: torch.Tensor
                 ) -> Tuple[torch.Tensor, Pools]:
    """One token for every decode slot.

    last_tokens: [B]; positions: [B] int32 position of that token;
    page_table: [B, MP] int32 (trash-filled beyond each sequence's
    pages); active: [B] bool.  Returns (logits [B, V], pools updated in
    place)."""
    quant = "k_scale" in pools
    B = last_tokens.shape[0]
    ps = pools["k"].shape[2]
    trash = pools["k"].shape[1] - 1
    x = _embed(cfg, params, last_tokens[:, None], positions.long()[:, None])  # [B, 1, H]
    pos = positions.long()
    # clamp the page lookup for inactive rows; their write goes to trash
    page_idx = torch.where(
        active,
        page_table.long()[torch.arange(B, device=pos.device),
                          torch.clamp(pos // ps, max=page_table.shape[1] - 1)],
        torch.full_like(pos, trash))
    off = pos % ps
    slopes = _slopes(cfg, last_tokens.device)
    for i, layer in enumerate(params.layers):
        q, k, v = attn_qkv(cfg, layer, x, pos[:, None])
        k_c, v_c = pools["k"][i], pools["v"][i]
        ks_c = vs_c = None
        if quant:
            ks_c, vs_c = pools["k_scale"][i], pools["v_scale"][i]
            kq, ksc = _kv_quantize(k[:, 0])
            vq, vsc = _kv_quantize(v[:, 0])
            k_c[page_idx, off] = kq
            v_c[page_idx, off] = vq
            ks_c[page_idx, off] = ksc
            vs_c[page_idx, off] = vsc
        else:
            k_c[page_idx, off] = k[:, 0].to(k_c.dtype)
            v_c[page_idx, off] = v[:, 0].to(v_c.dtype)
        attn = paged_decode_attention(q[:, 0], k_c, v_c, page_table, positions,
                                      k_scale=ks_c, v_scale=vs_c,
                                      alibi_slopes=slopes).reshape(B, 1, -1)
        x, _ = _attn_out(cfg, layer, x, attn)
    return _final_logits(cfg, params, x)[:, 0], pools




@torch.no_grad()
def paged_verify(cfg: TransformerConfig, params: ParamTree, pools: Pools,
                 ids: torch.Tensor, positions: torch.Tensor, page_table: torch.Tensor,
                 active: torch.Tensor, n_valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, Pools]:
    """Score a window of ``W = k + 1`` tokens for every decode slot in one
    model call: the verify step of speculative decoding.

    :func:`paged_decode` widened from one pending token to a window (the
    last accepted token, then up to ``k`` drafts): each valid token's K/V
    is written into the sequence's pages where plain decode would write
    it, then every window query attends the pooled slots at or before its
    position, so position ``w``'s logits are what a plain decode step
    would give after consuming ``ids[:, :w + 1]``.  Rejected KV left in
    kept pages is harmless: reads are masked to the query's position and
    the next window overwrites it first.  Like the JAX runner's XLA path
    (model_runner.py:376 there) it attends through the plain gather
    formulation (``ops/paged_attention.gather_window_attend``): the paged
    kernel takes one query per sequence.

    ids: [B, W] (ids[:, 0] the last accepted token); positions: [B] int32
    position of ids[:, 0]; page_table: [B, MP] int32; active: [B] bool;
    n_valid: [B] valid tokens per row (1..W).  Invalid and inactive tokens
    write to the trash page; their logits are garbage nobody reads.
    Returns (logits [B, W, V], pools updated in place)."""
    quant = "k_scale" in pools
    B, W = ids.shape
    ps = pools["k"].shape[2]
    trash = pools["k"].shape[1] - 1
    dev = ids.device
    steps = torch.arange(W, device=dev)
    pos_w = positions.long()[:, None] + steps[None]  # [B, W]
    x = _embed(cfg, params, ids.long(), pos_w)
    valid = active[:, None] & (steps[None] < n_valid[:, None])
    MP = page_table.shape[1]
    table = page_table.long()
    page_idx = torch.where(
        valid, table[torch.arange(B, device=dev)[:, None], torch.clamp(pos_w // ps, max=MP - 1)],
        torch.full_like(pos_w, trash))
    off = pos_w % ps
    vis = torch.arange(MP * ps, device=dev)[None, None] <= pos_w[:, :, None]  # [B, W, S]
    slopes = _slopes(cfg, dev)
    for i, layer in enumerate(params.layers):
        q, k, v = attn_qkv(cfg, layer, x, pos_w)
        k_c, v_c = pools["k"][i], pools["v"][i]
        ks_c = vs_c = None
        if quant:
            ks_c, vs_c = pools["k_scale"][i], pools["v_scale"][i]
            kq, ksc = _kv_quantize(k)
            vq, vsc = _kv_quantize(v)
            k_c[page_idx, off] = kq
            v_c[page_idx, off] = vq
            ks_c[page_idx, off] = ksc
            vs_c[page_idx, off] = vsc
        else:
            k_c[page_idx, off] = k.to(k_c.dtype)
            v_c[page_idx, off] = v.to(v_c.dtype)
        attn = gather_window_attend(q, k_c, v_c, page_table, vis, pos_w, ks_c, vs_c, slopes)
        x, _ = _attn_out(cfg, layer, x, attn)
    return _final_logits(cfg, params, x), pools


# -- sampling: a counter-based hash, no host read ------------------------------
_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def _row_seed(seed: int, sid: int, position: int) -> int:
    """Counter-based per-(seed, request, position) stream id: a
    splitmix64 mix of the three, so a row's noise never depends on its
    slot or on what else is batched (the host form of the key
    :func:`gumbel_noise` computes on the device)."""
    z = (seed * _GOLDEN + sid * _MIX1 + position * _MIX2) & _M64
    z = ((z ^ (z >> 30)) * _MIX1) & _M64
    z = ((z ^ (z >> 27)) * _MIX2) & _M64
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


def _i64(c: int) -> int:
    """A 64-bit pattern as the int64 that holds it."""
    c &= _M64
    return c - (1 << 64) if c >> 63 else c


def _srl(z: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic:
    the sign bits it shifts in are masked off)."""
    return (z >> n) & ((1 << (64 - n)) - 1)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 tensors (products wrap mod 2^64)."""
    z = (z ^ _srl(z, 30)) * _i64(_MIX1)
    z = (z ^ _srl(z, 27)) * _i64(_MIX2)
    return z ^ _srl(z, 31)


def _row_key(seed: int, sids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """:func:`_row_seed` of every row, as int64 tensor ops."""
    key = (torch.full_like(sids, _i64(seed * _GOLDEN), dtype=torch.int64)
           + sids.long() * _i64(_MIX1) + positions.long() * _i64(_MIX2))
    return _mix64(key) & 0x7FFFFFFFFFFFFFFF


def gumbel_noise(seed: int, sids: torch.Tensor, positions: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Gumbel(0, 1) noise ``[B, vocab]`` in fp64, the same bits on every
    device: row b's key is ``_row_seed(seed, sids[b], positions[b])``,
    and entry v is splitmix64's (v + 1)-th draw from that key, whose top
    53 bits give a uniform u in (0, 1); noise = -log(-log u)."""
    key = _row_key(seed, sids, positions)
    ctr = torch.arange(1, vocab + 1, device=sids.device, dtype=torch.int64) * _i64(_GOLDEN)
    bits = _mix64(key[:, None] + ctr[None])
    u = (_srl(bits, 11).double() + 0.5) * 2.0 ** -53
    return -torch.log(-torch.log(u))


@torch.no_grad()
def sample_tokens(logits: torch.Tensor, temps: torch.Tensor, seed: int,
                  sids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Greedy argmax, or Gumbel-max categorical at temperature > 0, on
    the device and without a host read, so a captured decode program can
    hold it.

    Row b's noise is keyed by (seed, sids[b], positions[b]) — the
    request's stable id and the position the sampled token will occupy —
    never by the slot or the dispatch (:func:`gumbel_noise`): a K-step
    program draws what K single steps draw, a preempted-and-readmitted
    stream keeps its noise, and co-batched requests at equal positions
    never share it.  The noise and the perturbed scores are fp64 from
    integer hashes, so the CPU and the card pick the same tokens from the
    same logits.  (The JAX package folds a PRNG key the same way; the
    bits differ, greedy decoding is the cross-framework parity gate.)
    logits [B, V]; temps [B] (<= 0 = greedy); sids/positions [B].
    Returns [B] int32."""
    z = logits.float()
    greedy = torch.argmax(z, dim=-1).to(torch.int32)
    t = temps.double().clamp(min=1e-6)[:, None]
    noisy = z.double() / t + gumbel_noise(seed, sids, positions, z.shape[-1])
    sampled = torch.argmax(noisy, dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


@torch.no_grad()
def paged_multi_decode(cfg: TransformerConfig, params: ParamTree, pools: Pools,
                       last_tokens: torch.Tensor, positions: torch.Tensor,
                       page_table: torch.Tensor, active: torch.Tensor, temps: torch.Tensor,
                       eos_ids: torch.Tensor, budgets: torch.Tensor, seed: int,
                       sids: torch.Tensor, horizon: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, Pools]:
    """``horizon`` decode steps in one program: each step is the
    :func:`paged_decode` body followed by :func:`sample_tokens`, with the
    per-row active/EOS/budget masking on the device, so a finished row
    writes to the trash page and stops consuming pages; one host read
    per K tokens (engine ``_multi_decode``).

    last_tokens/positions/active/temps/sids: as the decode step;
    page_table: [B, MP] covering each row's pre-reserved headroom (nothing
    allocates mid-program); eos_ids: [B] int32 (-1 = none); budgets: [B]
    int32 tokens row b may emit (0 = inactive).  Returns (tokens [B, K]
    int32 with -1 past each row's produced count, produced [B] int32,
    pools).  Contract: the emitted stream is bit-identical to K single
    steps, greedy and sampled alike."""
    B = last_tokens.shape[0]
    act = active & (budgets > 0)
    produced = torch.zeros((B,), dtype=torch.int32, device=last_tokens.device)
    last, pos = last_tokens.long(), positions.to(torch.int32)
    none = torch.full((B,), -1, dtype=torch.int32, device=last_tokens.device)
    toks = []
    for _ in range(horizon):
        logits, pools = paged_decode(cfg, params, pools, last, pos, page_table, act)
        emit = act
        tok = torch.where(emit, sample_tokens(logits, temps, seed, sids, pos + 1), none)
        produced = produced + emit.to(torch.int32)
        eos_hit = emit & (eos_ids >= 0) & (tok == eos_ids)
        act = emit & ~eos_hit & (produced < budgets)
        last = torch.where(emit, tok.long(), last)
        pos = pos + emit.to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, dim=1), produced, pools
