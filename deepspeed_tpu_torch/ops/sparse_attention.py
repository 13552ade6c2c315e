"""Block-sparse attention: the CUDA kernel ``csrc/sparse_attention.cu``
(kernel S), its plain PyTorch version, and the ``SparsityConfig`` family
that builds the block layouts.

Replaces the TPU kernel ``deepspeed_tpu/ops/pallas/sparse_attention.py``
``_sparse_attn_kernel`` (via ``sparse_attention``).  Layout at the public
function is the JAX package's: q, k, v ``[B, S, H, D]`` -> ``[B, S, H, D]``.
A config's ``make_layout(S)`` gives ``[H, S / block, S / block]`` (1 = the
block pair is computed); a 1-head layout is broadcast over the heads.

The layout builders are numpy copies of the JAX package's, draw for draw
(BigBird's random blocks come from ``np.random.RandomState(seed)`` in the
same order), so every layout is bit-equal to JAX's.

:func:`sparse_attention` launches kernel S for CUDA tensors and runs
:func:`sparse_attention_plain` for CPU tensors (or when the caller asks for
``impl="xla"``, as in JAX); a CUDA tensor the kernel cannot take raises.
Each launch adds one to ``sparse_attention.launches``.  The JAX package has
no VJP for the kernel, and neither has the port: a CUDA call whose inputs
require a gradient raises ``NotImplementedError``.

Kernel S walks, for each query tile, only the on-blocks of its layout row:
the wrapper turns the layout into compact per-head lists (CSR: row
pointers and the key tiles to visit, none wholly above the diagonal when
causal), built once per (layout, causal, device) and kept on the device.
In bf16/fp16 a block of the kernel takes a 128-row query tile
(``CTA_ROWS``) and key tiles of :func:`cta_key_tile` keys (:func:`cta_lists`;
a layout block off 128 marks each listed tile's 16 x 16 units), and reads
q, k and v by TMA or, where TMA cannot read a tensor in place, by cp.async
(:func:`copy_route`); fp32 and head dims past 256 walk 64 x 64 tiles
(:func:`block_lists`, :func:`unit_lists`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import op_builder
from .flash_attention import (WIDEST_INSTANCE, check_head_dim, pad_head_dim,
                              padded_head_dim)

#: rows and keys of the fp32 (and runtime-head-dim) kernel's tile; a layout
#: block that is a multiple of it is cut into tiles, a smaller one is masked
#: inside the tile at ``KERNEL_UNIT`` granularity
KERNEL_TILE = 64
KERNEL_UNIT = 16
#: query rows of a block of kernel S in bf16/fp16 (two warpgroups of 64)
CTA_ROWS = 128


def cta_key_tile(D: int, masked: bool = False) -> int:
    """Keys per tile of kernel S in bf16/fp16 at the kernel's head dim D
    (:func:`padded_head_dim`): 128 up to D = 64 when the lists carry no
    unit masks (a layout block that is a multiple of 128), else 64 (half
    the masked-off work in a tile of small blocks; past D = 64 the D-wide
    output accumulators in registers)."""
    return 128 if D <= 64 and not masked else 64


def kernel_takes_block(block: int) -> bool:
    """The layout blocks kernel S takes on the card: every block, as the
    reference (which takes any block that divides S; the layout raises on
    one that does not)."""
    return block > 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIG = {"dstpu_sparse_attention": [
    _P, _P, _P, _P, _P, _P, _P, _P,      # q k v o row_ptr cols masks layout
    _I, _I, _I, _I, _I, _I, _I, _I, _I,  # dtype B S H D layout_heads block layout_block causal
    ctypes.c_float,                      # sm_scale
    _L, _L, _L, _L, _L, _L, _L, _L, _L,  # q/k/v strides (b, s, h)
    _P],                                 # stream
    "dstpu_sparse_attention_wgmma": [
    _P, _P, _P, _P, _P, _P, _P, _P,      # q k v o row_ptr cols masks layout
    _I, _I, _I, _I, _I, _I, _I, _I, _I,  # dtype B S H D layout_heads layout_block causal cp
    _I, ctypes.c_float,                  # key tile, sm_scale
    _L, _L, _L, _L, _L, _L, _L, _L, _L,  # q/k/v strides (b, s, h)
    _P]}                                 # stream


# --------------------------------------------------------------- layouts
@dataclasses.dataclass
class SparsityConfig:
    """Base layout builder (reference sparse_attention/sparsity_config.py)."""

    num_heads: int = 1
    block: int = 128

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    def _nb(self, seq_len: int) -> int:
        if seq_len % self.block:
            raise ValueError(f"seq_len {seq_len} not divisible by block "
                             f"{self.block}")
        return seq_len // self.block


@dataclasses.dataclass
class DenseSparsityConfig(SparsityConfig):
    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self._nb(seq_len)
        return np.ones((self.num_heads, nb, nb), bool)


@dataclasses.dataclass
class FixedSparsityConfig(SparsityConfig):
    """Local band + periodic global columns: ``num_local_blocks`` band, the
    last ``num_global_blocks`` of every earlier window seen by all rows."""

    num_local_blocks: int = 4
    num_global_blocks: int = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self._nb(seq_len)
        lay = np.zeros((self.num_heads, nb, nb), bool)
        for qi in range(nb):
            lo = (qi // self.num_local_blocks) * self.num_local_blocks
            lay[:, qi, lo:min(lo + self.num_local_blocks, nb)] = True
            for w in range(0, qi + 1, self.num_local_blocks):
                g0 = max(w + self.num_local_blocks - self.num_global_blocks, 0)
                lay[:, qi, g0:min(w + self.num_local_blocks, nb)] = True
        return lay


@dataclasses.dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + designated global blocks."""

    num_sliding_window_blocks: int = 3
    global_block_indices: tuple = (0,)

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self._nb(seq_len)
        lay = np.zeros((self.num_heads, nb, nb), bool)
        half = self.num_sliding_window_blocks // 2
        for qi in range(nb):
            lay[:, qi, max(0, qi - half):min(nb, qi + half + 1)] = True
        for g in self.global_block_indices:
            if g < nb:
                lay[:, :, g] = True  # everyone attends to global
                lay[:, g, :] = True  # global attends to everyone
        return lay


@dataclasses.dataclass
class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding window + global.  Random blocks are drawn per head
    from ``np.random.RandomState(seed)`` (layouts must agree across
    data-parallel workers, and with the JAX package's)."""

    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        nb = self._nb(seq_len)
        lay = np.zeros((self.num_heads, nb, nb), bool)
        half = self.num_sliding_window_blocks // 2
        rng = np.random.RandomState(self.seed)
        for qi in range(nb):
            lay[:, qi, max(0, qi - half):min(nb, qi + half + 1)] = True
        g = min(self.num_global_blocks, nb)
        lay[:, :, :g] = True
        lay[:, :g, :] = True
        for h in range(self.num_heads):
            for qi in range(nb):
                for r in rng.choice(nb, size=min(self.num_random_blocks, nb),
                                    replace=False):
                    lay[h, qi, r] = True
        return lay


def _layout(config: SparsityConfig, S: int, H: int) -> np.ndarray:
    """The config's int32 layout ``[1 or H, NB, NB]``; raises when its heads
    are neither 1 nor H (as the JAX function does)."""
    layout = np.asarray(config.make_layout(S), np.int32)
    if layout.shape[0] not in (1, H):
        raise ValueError(f"layout heads {layout.shape[0]} != {H}")
    return layout


# --------------------------------------------------------------- plain
def sparse_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           config: SparsityConfig, causal: bool = True) -> torch.Tensor:
    """The plain version, the JAX function's ``impl='xla'`` branch
    (``sparse_attention.py:188-200``): dense scores in fp32 under the
    layout expanded to a ``[H, S, S]`` mask; rows with no visible key give
    0.  Differentiable by autograd."""
    B, S, H, D = q.shape
    layout = torch.as_tensor(_layout(config, S, H), device=q.device)
    layout = layout.expand(H, *layout.shape[1:])
    blk = torch.ones((config.block, config.block), dtype=torch.int32, device=q.device)
    mask = torch.kron(layout, blk) > 0  # [H, S, S]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / math.sqrt(D))
    s = torch.where(mask[None], s, torch.full_like(s, float("-inf")))
    if causal:
        cm = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(cm[None, None], s, torch.full_like(s, float("-inf")))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


# --------------------------------------------------------------- kernel S
_LISTS: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}


def block_lists(layout: np.ndarray, causal: bool, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per layout head and block row, the ascending block columns to visit
    (only those at or below the diagonal when causal) as CSR on ``device``:
    ``row_ptr`` int32 ``[heads * NB + 1]`` and ``cols`` int32.  Built once
    per (layout, causal, device) and cached."""
    lay = np.ascontiguousarray(layout, dtype=np.int32)
    key = (hashlib.sha256(lay.tobytes()).hexdigest(), lay.shape, bool(causal), str(device))
    hit = _LISTS.get(key)
    if hit is not None:
        return hit
    on = lay > 0
    if causal:
        on = on & np.tril(np.ones(on.shape[1:], bool))[None]
    out = tuple(torch.as_tensor(x, device=device) for x in _csr(on))
    _LISTS[key] = out
    return out


def _csr(on: np.ndarray, *per_entry: np.ndarray):
    """CSR of a boolean ``[heads, rows, cols]``: row_ptr, the ascending
    columns of each row, and each array of ``per_entry`` taken at them."""
    flat = on.reshape(-1, on.shape[2])
    row_ptr = np.zeros(flat.shape[0] + 1, np.int32)
    np.cumsum(flat.sum(axis=1), out=row_ptr[1:])
    picked = [np.nonzero(flat)[1].astype(np.int32)]
    picked += [x.reshape(flat.shape)[flat].astype(np.int32) for x in per_entry]
    # an empty list still needs a valid pointer; no row reads it
    return (row_ptr, *(x if x.size else np.zeros(1, np.int32) for x in picked))


def unit_lists(layout: np.ndarray, block: int, S: int, causal: bool, device
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For a block that is not a multiple of ``KERNEL_TILE``: the layout at
    16 x 16 units, ORed into 64 x 64 tiles (the last one ragged when S is
    not a multiple of 64).  A unit is on when any of its elements is
    visible; it is partial when some are not (its rows or columns cross a
    block edge that is not a multiple of 16, or S).  Returns the tiles' CSR
    lists, as :func:`block_lists` at tile granularity, and per listed tile
    its unit mask as int32: bit ``4 * row unit + column unit`` on, the same
    bit + 16 partial (the kernel tests each element of a partial unit
    against the layout)."""
    lay = np.ascontiguousarray(layout, dtype=np.int32)
    key = ("units", hashlib.sha256(lay.tobytes()).hexdigest(), lay.shape, block, S,
           bool(causal), str(device))
    hit = _LISTS.get(key)
    if hit is not None:
        return hit
    any_on, partial = _unit_grid(lay, block, S)
    n_units = any_on.shape[1]
    tpu = KERNEL_TILE // KERNEL_UNIT  # units per tile side
    nt = -(-n_units // tpu)
    pad = nt * tpu - n_units

    def tiles(x):
        x = np.pad(x, ((0, 0), (0, pad), (0, pad)))
        x = x.reshape(lay.shape[0], nt, tpu, nt, tpu).transpose(0, 1, 3, 2, 4)
        return (x.reshape(lay.shape[0], nt, nt, tpu * tpu).astype(np.int64)
                << np.arange(tpu * tpu)).sum(-1)

    bits = tiles(any_on) | (tiles(partial) << 16)
    on = bits != 0
    if causal:
        on = on & np.tril(np.ones((nt, nt), bool))[None]
    # the upper bits as a signed int32, as the kernel reads them
    bits = bits.astype(np.uint32).view(np.int32)
    out = tuple(torch.as_tensor(x, device=device) for x in _csr(on, bits))
    _LISTS[key] = out
    return out


def _unit_grid(lay: np.ndarray, block: int, S: int) -> Tuple[np.ndarray, np.ndarray]:
    """The layout ``[heads, NB, NB]`` at 16 x 16 units: (on, partial), each
    boolean ``[heads, units, units]``.  A unit is on when any of its
    elements is visible, partial when some are not (its rows or columns
    cross a block edge that is not a multiple of 16, or S)."""
    n_units = -(-S // KERNEL_UNIT)
    # the layout blocks each unit's elements fall in: [blk_lo, blk_hi]
    lo = np.arange(n_units) * KERNEL_UNIT
    hi = np.minimum(lo + KERNEL_UNIT, S) - 1
    blk_lo, blk_hi = lo // block, hi // block
    span = np.arange(lay.shape[1])
    meet = ((span[None, :] >= blk_lo[:, None]) & (span[None, :] <= blk_hi[:, None])).astype(
        np.int64)  # [units, blocks]
    on_blocks = meet[None] @ (lay > 0).astype(np.int64) @ meet.T[None]  # [heads, units, units]
    size = blk_hi - blk_lo + 1
    full = hi - lo + 1 == KERNEL_UNIT
    whole = (size[:, None] * size[None, :]) * (full[:, None] & full[None, :])
    any_on = on_blocks > 0
    return any_on, any_on & (on_blocks != whole[None])


def cta_lists(layout: np.ndarray, block: int, S: int, causal: bool, bk: int, device
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Kernel S's walk in bf16/fp16: per layout head and 128-row query tile
    (``CTA_ROWS``), the ascending ``bk``-key tiles to visit as CSR on
    ``device`` (``row_ptr`` int32 ``[heads * ceil(S / 128) + 1]``, ``cols``
    int32 key-tile indices), under causal none wholly above the query
    tile's last row.  A block that is a multiple of 128 makes each query
    tile one layout row and each key tile part of one layout block: every
    listed tile is on whole, and ``masks`` is None.  Any other block: a
    tile is listed when any of its 16 x 16 units is on, and ``masks`` is
    uint8 ``[entries, 16]``: byte r the tile's key units on for row unit r
    (bit u: keys 16 u .. 16 u + 15 of the tile), byte 8 + r those only
    partly visible, whose elements the kernel tests against the layout.
    Built once per (layout, block, S, causal, bk, device) and cached."""
    lay = np.ascontiguousarray(layout, dtype=np.int32)
    key = ("cta", hashlib.sha256(lay.tobytes()).hexdigest(), lay.shape, block, S,
           bool(causal), bk, str(device))
    hit = _LISTS.get(key)
    if hit is not None:
        return hit
    heads = lay.shape[0]
    nq, nk = -(-S // CTA_ROWS), -(-S // bk)
    if block % CTA_ROWS == 0:
        rows = np.arange(nq) * CTA_ROWS // block
        cols = np.arange(nk) * bk // block
        on = lay[:, rows][:, :, cols] > 0  # [heads, nq, nk]
        mask16 = None
    else:
        ur, uc = CTA_ROWS // KERNEL_UNIT, bk // KERNEL_UNIT  # units per tile side
        any_on, partial = _unit_grid(lay, block, S)
        n_units = any_on.shape[1]

        def per_row_unit(x):  # [heads, nq, nk, ur] bytes: bit u = key unit u
            x = np.pad(x, ((0, 0), (0, nq * ur - n_units), (0, nk * uc - n_units)))
            x = x.reshape(heads, nq, ur, nk, uc).transpose(0, 1, 3, 2, 4).astype(np.int64)
            return (x << np.arange(uc)).sum(-1).astype(np.uint8)

        on_bits = per_row_unit(any_on)
        mask16 = np.zeros((heads, nq, nk, 16), np.uint8)
        mask16[..., :ur] = on_bits
        mask16[..., 8:8 + ur] = per_row_unit(partial)
        on = on_bits.any(-1)
    if causal:  # key tiles that start past the query tile's last row
        on = on & (np.arange(nk)[None, :] * bk
                   <= np.arange(nq)[:, None] * CTA_ROWS + CTA_ROWS - 1)[None]
    row_ptr, cols = _csr(on)
    masks = None
    if mask16 is not None:
        masks = mask16.reshape(-1, nk, 16)[on.reshape(-1, nk)]
        masks = torch.as_tensor(masks if masks.size else np.zeros((1, 16), np.uint8),
                                device=device)
    out = (torch.as_tensor(row_ptr, device=device), torch.as_tensor(cols, device=device), masks)
    _LISTS[key] = out
    return out


def _layout_bytes(layout: np.ndarray, device) -> torch.Tensor:
    """The layout as uint8 ``[heads, NB, NB]`` on ``device`` (cached)."""
    lay = np.ascontiguousarray(layout, dtype=np.int32)
    key = ("bytes", hashlib.sha256(lay.tobytes()).hexdigest(), lay.shape, str(device))
    hit = _LISTS.get(key)
    if hit is None:
        hit = _LISTS[key] = (torch.as_tensor((lay > 0).astype(np.uint8), device=device),)
    return hit[0]


def _rows_ok(t: torch.Tensor) -> bool:
    if t.stride(3) != 1:
        return False
    if t.dtype == torch.float32:
        return True
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def _cp_bytes(t: torch.Tensor) -> int:
    """The widest cp.async (16, 8 or 4 bytes) that divides ``t``'s base and
    every stride in bytes, or 0 (no cp.async reads its rows in place)."""
    if t.stride(3) != 1:
        return 0
    item = t.element_size()
    for n in (16, 8, 4):
        if t.data_ptr() % n == 0 and all(s * item % n == 0 for s in t.stride()[:3]):
            return n
    return 0


def copy_route(*ts: torch.Tensor) -> int:
    """How kernel S reads q, k and v ``[B, S, H, D]`` in bf16/fp16: 0 when
    TMA can read them all in place (rows 16-byte aligned, every stride a
    positive multiple of 16 bytes: a map's strides are positive), else the
    bytes of each cp.async the block's threads copy tiles with (the widest
    that every tensor allows; the caller copies a tensor that allows none)."""
    if all(_cp_bytes(t) == 16 and min(t.stride()[:3]) > 0 for t in ts):
        return 0
    return min(_cp_bytes(t) for t in ts)


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     config: SparsityConfig, causal: bool = True,
                     impl: str = "pallas") -> torch.Tensor:
    """q/k/v ``[B, S, H, D]`` -> ``[B, S, H, D]``, block-sparse per
    ``config``.  As in JAX, ``impl="xla"`` runs the plain version (the
    numeric oracle); any other value (JAX's default name ``"pallas"``)
    leaves the choice to the device: kernel S on CUDA, the plain version on
    the CPU."""
    B, S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"sparse_attention: q/k/v shapes {tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)} differ")
    layout = _layout(config, S, H)  # raises on a seq_len off the block
    if impl == "xla" or q.device.type == "cpu":
        return sparse_attention_plain(q, k, v, config, causal)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"sparse_attention: q/k/v on {q.device}/{k.device}/{v.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "sparse_attention: kernel S is forward only; the JAX package's Pallas kernel "
            "has no VJP either. Call it under torch.no_grad(), or pass impl='xla' for the "
            "differentiable plain version")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"sparse_attention: q/k/v dtypes differ: {q.dtype}/{k.dtype}/{v.dtype}")
    check_head_dim(D, "sparse_attention")
    Dk = padded_head_dim(D)
    if q.dtype != torch.float32 and D <= WIDEST_INSTANCE:
        return _sparse_wgmma(q, k, v, config, layout, causal, D, Dk)
    if Dk != D:  # the kernel runs at Dk on zero-padded rows; the extra columns are dropped
        q, k, v = (pad_head_dim(t, Dk) for t in (q, k, v))
    else:
        q, k, v = (t if _rows_ok(t) else t.contiguous() for t in (q, k, v))
    block, masks, elems = config.block, None, None
    if D > WIDEST_INSTANCE:  # the runtime-head-dim kernel: unit lists, every element tested
        row_ptr, cols, masks = unit_lists(layout, block, S, causal, q.device)
        elems = _layout_bytes(layout, q.device)
        block = KERNEL_TILE
    elif block % KERNEL_TILE:
        row_ptr, cols, masks = unit_lists(layout, block, S, causal, q.device)
        if block % KERNEL_UNIT:  # partial units test each element against the layout
            elems = _layout_bytes(layout, q.device)
        block = KERNEL_TILE
    else:
        row_ptr, cols = block_lists(layout, causal, q.device)
    o = torch.empty((B, S, H, Dk), dtype=q.dtype, device=q.device)
    lib = op_builder.load("sparse_attention", _SIG)
    with torch.cuda.device(q.device):
        err = lib.dstpu_sparse_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), row_ptr.data_ptr(),
            cols.data_ptr(), None if masks is None else masks.data_ptr(),
            None if elems is None else elems.data_ptr(),
            op_builder.dtype_code(q.dtype), B, S, H, Dk, layout.shape[0],
            block, config.block, int(bool(causal)), 1.0 / math.sqrt(D),
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "sparse_attention")
    sparse_attention.launches += 1
    return o if Dk == D else o[..., :D].contiguous()


sparse_attention.launches = 0


def _sparse_wgmma(q, k, v, config, layout, causal, D, Dk):
    """Kernel S in bf16/fp16 at a head dim up to 256: one block per (b, h,
    128-row query tile) over :func:`cta_lists`, q/k/v read by TMA or
    cp.async (:func:`copy_route`)."""
    B, S, H, _ = q.shape
    if Dk != D:  # the kernel runs at Dk on zero-padded rows; the extra columns are dropped
        q, k, v = (pad_head_dim(t, Dk) for t in (q, k, v))
    else:
        q, k, v = (t if _cp_bytes(t) else t.contiguous() for t in (q, k, v))
    cp = copy_route(q, k, v)
    bk = cta_key_tile(Dk, masked=config.block % CTA_ROWS != 0)
    row_ptr, cols, masks = cta_lists(layout, config.block, S, causal, bk, q.device)
    elems = _layout_bytes(layout, q.device) if config.block % KERNEL_UNIT else None
    o = torch.empty((B, S, H, Dk), dtype=q.dtype, device=q.device)
    lib = op_builder.load("sparse_attention", _SIG)
    with torch.cuda.device(q.device):
        err = lib.dstpu_sparse_attention_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), row_ptr.data_ptr(),
            cols.data_ptr(), None if masks is None else masks.data_ptr(),
            None if elems is None else elems.data_ptr(), op_builder.dtype_code(q.dtype), B, S,
            H, Dk, layout.shape[0], config.block, int(bool(causal)), cp, bk,
            1.0 / math.sqrt(D), q.stride(0), q.stride(1), q.stride(2), k.stride(0),
            k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
            torch.cuda.current_stream(q.device).cuda_stream)
    op_builder.check(err, "sparse_attention")
    sparse_attention.launches += 1
    return o if Dk == D else o[..., :D].contiguous()
