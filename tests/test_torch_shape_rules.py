"""The shapes the port's kernels take on the card, and the plain paths at
the shapes that rule newly admits, against the JAX package.

On the CPU the wrappers run their plain versions, so these tests hold the
port's function at the shapes the kernels take (head dims 72, 80, 96, 160,
288 and 320 in flash forward and backward, 72, 80, 288 and 320 in paged
decode, 288 and 320 in sparse attention, sparse
layout blocks of 8, 16, 24 and 32, ``wq_matmul`` groups of 16 and 48)
against the JAX package's Pallas kernels in interpret mode on the same
numpy inputs.  The kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.  The acceptance rules (``kernel_takes_head_dim``,
``kernel_takes_block``, ``kernel_takes_group``), the layouts kernel S
walks (64 x 64 unit tiles in fp32, 128-row query tiles with unit masks in
bf16/fp16), its key tile and its copy route (TMA or cp.async) are pure
Python and are checked here directly; kernel E''s plan is the library's
and is checked where the library can be built.

Tolerances are those of the existing tests of each op: flash forward fp32
1e-5 and bf16 2e-2 (``test_torch_flash_attention.py``), flash gradients
fp32 2e-5 and bf16 2e-2 (``test_torch_flash_attention_bwd.py``), paged
decode 1e-5 (``test_torch_paged_attention.py``), sparse 2e-5
(``test_torch_sparse_attention.py``), and ``wq_matmul`` 2e-5 plus one
output rounding for bf16 x (``test_torch_wq_matmul.py``); the reasons are
given there and do not change with the shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import families, llama, mixtral
from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas import sparse_attention as jsa
from deepspeed_tpu.ops.pallas import wq_matmul as jwq
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu.ops.pallas.paged_attention import paged_decode_attention as jax_paged
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import evoformer_attn as ev
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops import wq_matmul as twq

torch.set_num_threads(2)

JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}


# ------------------------------------------------------------------ rules
def _config_head_dims():
    """Every model config of the JAX package: (family, size) -> head dim."""
    fams = {"llama": (llama.SIZES, llama.llama_config),
            "mixtral": (mixtral.SIZES, mixtral.mixtral_config),
            "mistral": (families.MISTRAL_SIZES, families.mistral_config),
            "qwen": (families.QWEN_SIZES, families.qwen_config),
            "phi": (families.PHI_SIZES, families.phi_config),
            "opt": (families.OPT_SIZES, families.opt_config),
            "falcon": (families.FALCON_SIZES, families.falcon_config),
            "bloom": (families.BLOOM_SIZES, families.bloom_config),
            "gpt_neox": (families.NEOX_SIZES, families.gpt_neox_config)}
    return {(f, s): cfg(s).head_dim for f, (sizes, cfg) in fams.items() for s in sizes}


def test_every_config_head_dim_is_one_the_kernels_take():
    dims = _config_head_dims()
    assert {dims[("phi", "2")], dims[("gpt_neox", "20b")]} == {80, 96}
    assert {d for d in dims.values() if not fa.kernel_takes_head_dim(d)} == set()


@pytest.mark.parametrize("D", [16, 32, 48, 64, 80, 96, 112, 128])
def test_head_dim_rule_takes_multiples_of_16_to_128(D):
    assert fa.kernel_takes_head_dim(D)
    fa.check_head_dim(D, "flash")


def test_head_dim_rule_takes_every_d_from_1_to_256():
    for D in range(1, 257):
        assert fa.kernel_takes_head_dim(D), D
        fa.check_head_dim(D, "flash")


@pytest.mark.parametrize("D", [0, -1, 257, 264, 288, 320, 512, 1024])
def test_head_dim_rule_refuses_the_rest_naming_f2(D):
    """Every head dim the reference takes is taken: past 256 the
    runtime-head-dim kernels run it (the refusal there is closed); only a
    head dim below 1 raises."""
    if D >= 1:
        assert fa.kernel_takes_head_dim(D)
        fa.check_head_dim(D, "flash")
    else:
        assert not fa.kernel_takes_head_dim(D)
        with pytest.raises(ValueError, match="not positive"):
            fa.check_head_dim(D, "flash")


@pytest.mark.parametrize("D,Dk", [(1, 16), (7, 16), (8, 16), (16, 16), (72, 80), (100, 112),
                                  (128, 128), (129, 160), (160, 160), (161, 192), (255, 256),
                                  (256, 256), (257, 257), (288, 288), (321, 321), (1024, 1024)])
def test_padded_head_dim_is_the_kernels_width(D, Dk):
    """The kernels run at D rounded up to 16 (to 32 past 128) up to 256 and
    at D itself past it; pad_head_dim adds zero columns up to that width and
    leaves the rest as it was."""
    assert fa.padded_head_dim(D) == Dk
    t = torch.randn(2, 3, 1, D)
    p = fa.pad_head_dim(t, Dk)
    assert p.shape == (2, 3, 1, Dk) and torch.equal(p[..., :D], t)
    assert not p[..., D:].any()
    assert fa.pad_head_dim(t, D) is t


@pytest.mark.parametrize("block,ok", [(16, True), (32, True), (48, True), (64, True),
                                      (128, True), (8, True), (40, True), (0, False)])
def test_sparse_block_rule(block, ok):
    assert sa.kernel_takes_block(block) is ok


def test_sparse_block_rule_takes_every_block_that_divides_s():
    """Every block that divides S, as the reference: its layout builds and
    the kernel's rule takes it."""
    S = 240
    for block in range(1, S + 1):
        if S % block == 0:
            assert sa.kernel_takes_block(block), block
            cfg = sa.FixedSparsityConfig(num_heads=1, block=block, num_local_blocks=2)
            assert sa._layout(cfg, S, 1).shape == (1, S // block, S // block)


@pytest.mark.parametrize("group,bits,ok", [(16, 8, True), (48, 4, True), (128, 4, True),
                                           (10, 8, True), (6, 4, True), (7, 8, True),
                                           (7, 4, False), (0, 8, False), (-32, 8, False)])
def test_wq_group_rule(group, bits, ok):
    assert twq.kernel_takes_group(group, bits) is ok


@pytest.mark.parametrize("group", [16, 48, 10])
def test_wq_groups_off_the_stage_take_the_fma_tile(group):
    """Off the tensor-core kernel's 64-row stage the kernel runs on the FMA
    pipes for every x type, so its tile and occupancy are the fp32
    kernel's; groups that are a multiple of the stage take the tensor-core
    kernel's token tiles."""
    assert twq._tile(900, torch.bfloat16, group) == twq.TILE_FMA
    assert twq._tile(900, torch.bfloat16, 128) == twq.Tile("wgmma", 128, 128, 1)
    assert twq._tile(8, torch.bfloat16, group) == twq.TILE_FMA_DECODE
    assert twq._tile(8, torch.bfloat16, 64) == twq.Tile("wgmma", 8, 64, 4)


@pytest.mark.parametrize("D,K,stages", [(32, 384, 3), (32, 512, 2), (32, 513, 0),
                                         (32, 700, 0), (16, 384, 4), (16, 640, 2),
                                         (16, 641, 0), (64, 128, 2), (64, 129, 0),
                                         (128, 64, 2), (128, 65, 0)])
def test_evoformer_forward_keeps_the_pair_bias_resident_up_to_its_limit(D, K, stages):
    """Kernel E keeps a query tile's pair-bias rows [64][K] in shared memory
    beside two warpgroups' Q buffers, bias1 rows and K/V rings of 128-key
    tiles (64 past D = 64; at most 4 stages, at least 2); past the K where
    they no longer fit it takes the tile kernel, which stages bias2 per tile
    (stages 0), as does fp32.  AlphaFold 2's MSA row attention (K = 384,
    D = 32) keeps it."""
    for dt in (torch.bfloat16, torch.float16):
        assert ev.fwd_stages(dt, K, D, True) == stages
        # without a pair bias only the bias1 rows grow with K
        assert ev.fwd_stages(dt, K, D, False) >= 2
    assert ev.fwd_stages(torch.float32, K, D, True) == 0
    # the smem the kernel asks for fits a block whenever the rule takes it
    if stages:
        bk = 128 if D <= 64 else 64
        cols = -(-K // bk) * bk
        tiles = 2 * (2 * 64 + 2 * stages * bk) * D * 2
        bias = 4 * 64 * (cols + 8) + 4 * 2 * 2 * cols  # bias2 rows, two bias1 rows a warpgroup
        assert 1024 + tiles + bias + 8 * 2 * (4 + 2 * stages) <= 232448 - 2048


def test_evoformer_resident_limit_falls_with_k():
    """Fewer stages as K grows, never more: the limit is one threshold."""
    for D in (16, 32, 64, 128):
        st = [ev.fwd_stages(torch.bfloat16, K, D, True) for K in range(1, 1500, 7)]
        assert all(a >= b for a, b in zip(st, st[1:]))
        assert st[0] >= 2


def test_backward_tma_rows_rule():
    """The backward kernels' TMA maps read [B, S, H, D] views in place when
    their strides are positive 16-byte multiples; anything else is copied."""
    qkv = torch.zeros((2, 64, 3, 4, 32), dtype=torch.bfloat16)
    assert fa._tma_ok(qkv[:, :, 0])  # the QKV projection's q view
    assert fa._tma_ok(torch.zeros((2, 4, 64, 32), dtype=torch.bfloat16).transpose(1, 2))
    assert not fa._tma_ok(torch.zeros((2, 64, 4, 36), dtype=torch.bfloat16)[..., :32])
    assert not fa._tma_ok(torch.zeros((2, 64, 1, 32), dtype=torch.bfloat16).expand(2, 64, 4, 32))
    assert fa._tma_ok(torch.zeros((2, 64, 1, 32)).expand(2, 64, 4, 32))  # fp32: FMA kernels


# ------------------------------------------------- kernel S's unit layout
def _unit_walk(layout, block, S, causal):
    """The visible (query, key) pairs as kernel S walks them for a block off
    its tile: the listed 64 x 64 tiles, each unit whose bit is set, and the
    diagonal when causal."""
    row_ptr, cols, masks = (t.numpy() for t in sa.unit_lists(layout, block, S, causal, "cpu"))
    heads, nt = layout.shape[0], -(-S // sa.KERNEL_TILE)
    u, tpu = sa.KERNEL_UNIT, sa.KERNEL_TILE // sa.KERNEL_UNIT
    vis = np.zeros((heads, nt * sa.KERNEL_TILE, nt * sa.KERNEL_TILE), bool)
    for h in range(heads):
        for qt in range(nt):
            r = h * nt + qt
            for e in range(row_ptr[r], row_ptr[r + 1]):
                for bit in range(tpu * tpu):
                    if (masks[e] >> bit) & 1:
                        r0 = qt * sa.KERNEL_TILE + (bit // tpu) * u
                        c0 = cols[e] * sa.KERNEL_TILE + (bit % tpu) * u
                        vis[h, r0:r0 + u, c0:c0 + u] = True
    vis = vis[:, :S, :S]
    if causal:
        vis &= np.tril(np.ones((S, S), bool))
    return vis


def _element_walk(layout, block, S, causal):
    """As :func:`_unit_walk` for any block: inside a unit whose partial bit
    (bit + 16) is set, each element's own layout entry decides."""
    row_ptr, cols, masks = (t.numpy() for t in sa.unit_lists(layout, block, S, causal, "cpu"))
    heads, nt = layout.shape[0], -(-S // sa.KERNEL_TILE)
    u, tpu = sa.KERNEL_UNIT, sa.KERNEL_TILE // sa.KERNEL_UNIT
    span = nt * sa.KERNEL_TILE
    elem = np.zeros((heads, span, span), bool)
    elem[:, :S, :S] = np.kron(layout > 0, np.ones((block, block), bool))
    vis = np.zeros((heads, span, span), bool)
    for h in range(heads):
        for qt in range(nt):
            r = h * nt + qt
            for e in range(row_ptr[r], row_ptr[r + 1]):
                m = int(masks[e]) & 0xFFFFFFFF
                for bit in range(tpu * tpu):
                    if (m >> bit) & 1:
                        r0 = qt * sa.KERNEL_TILE + (bit // tpu) * u
                        c0 = cols[e] * sa.KERNEL_TILE + (bit % tpu) * u
                        blk = np.ones((u, u), bool)
                        if (m >> (16 + bit)) & 1:
                            blk = elem[h, r0:r0 + u, c0:c0 + u]
                        vis[h, r0:r0 + u, c0:c0 + u] |= blk
    vis = vis[:, :S, :S]
    if causal:
        vis &= np.tril(np.ones((S, S), bool))
    return vis


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cfg,S", [
    (lambda m: m.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=4,
                                     num_global_blocks=1), 1040),
    (lambda m: m.BigBirdSparsityConfig(num_heads=2, block=32, num_random_blocks=2), 1056),
    (lambda m: m.BSLongformerSparsityConfig(num_heads=1, block=16,
                                            num_sliding_window_blocks=5,
                                            global_block_indices=(0, 7)), 528),
    (lambda m: m.FixedSparsityConfig(num_heads=2, block=48, num_local_blocks=3), 1008),
])
def test_unit_lists_cover_exactly_the_layout(cfg, S, causal):
    """Blocks under the 64-row tile: the tiles kernel S visits and their
    unit masks cover the layout expanded to [H, S, S] (and the causal
    triangle) exactly, S off a multiple of 64 included."""
    c = cfg(sa)
    layout = sa._layout(c, S, c.num_heads)
    want = np.kron(layout > 0, np.ones((c.block, c.block), bool))
    if causal:
        want &= np.tril(np.ones((S, S), bool))
    np.testing.assert_array_equal(_unit_walk(layout, c.block, S, causal), want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cfg,S", [
    (lambda m: m.FixedSparsityConfig(num_heads=2, block=8, num_local_blocks=4,
                                     num_global_blocks=1), 520),
    (lambda m: m.BigBirdSparsityConfig(num_heads=2, block=24, num_random_blocks=2), 600),
    (lambda m: m.BSLongformerSparsityConfig(num_heads=1, block=24,
                                            num_sliding_window_blocks=3,
                                            global_block_indices=(0, 5)), 360),
    (lambda m: m.FixedSparsityConfig(num_heads=1, block=40, num_local_blocks=2), 200),
])
def test_unit_lists_cover_blocks_off_16_exactly(cfg, S, causal):
    """Blocks that are not a multiple of 16: the visited tiles, their unit
    masks and the element test inside partial units give exactly the
    layout expanded to [H, S, S]; a unit with no visible element is off."""
    c = cfg(sa)
    layout = sa._layout(c, S, c.num_heads)
    want = np.kron(layout > 0, np.ones((c.block, c.block), bool))
    if causal:
        want &= np.tril(np.ones((S, S), bool))
    np.testing.assert_array_equal(_element_walk(layout, c.block, S, causal), want)


# ------------------------------------- kernel S's 128-row tiles (bf16/fp16)
def _cta_walk(layout, block, S, causal, bk):
    """The visible (query, key) pairs as kernel S walks them in bf16/fp16:
    per 128-row query tile its listed bk-key tiles, in each the key units
    on for each 16-row unit (every unit when the lists carry no masks), the
    elements of a partly visible unit tested against the layout, and the
    diagonal when causal."""
    row_ptr, cols, masks = sa.cta_lists(layout, block, S, causal, bk, "cpu")
    row_ptr, cols = row_ptr.numpy(), cols.numpy()
    masks = None if masks is None else masks.numpy()
    heads, nq = layout.shape[0], -(-S // sa.CTA_ROWS)
    span = max(nq * sa.CTA_ROWS, -(-S // bk) * bk)
    elem = np.zeros((heads, span, span), bool)
    elem[:, :S, :S] = np.kron(layout > 0, np.ones((block, block), bool))
    u = sa.KERNEL_UNIT
    vis = np.zeros((heads, span, span), bool)
    for h in range(heads):
        for qt in range(nq):
            for e in range(row_ptr[h * nq + qt], row_ptr[h * nq + qt + 1]):
                if masks is None:
                    vis[h, qt * sa.CTA_ROWS:(qt + 1) * sa.CTA_ROWS,
                        cols[e] * bk:(cols[e] + 1) * bk] = True
                    continue
                for r in range(sa.CTA_ROWS // u):
                    for c in range(bk // u):
                        if not (masks[e, r] >> c) & 1:
                            continue
                        r0, c0 = qt * sa.CTA_ROWS + r * u, cols[e] * bk + c * u
                        part = (masks[e, 8 + r] >> c) & 1
                        vis[h, r0:r0 + u, c0:c0 + u] |= (elem[h, r0:r0 + u, c0:c0 + u] if part
                                                         else True)
    vis = vis[:, :S, :S]
    if causal:
        vis &= np.tril(np.ones((S, S), bool))
    return vis


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cfg,S", [
    (lambda m: m.FixedSparsityConfig(num_heads=2, block=128), 1024),
    (lambda m: m.BigBirdSparsityConfig(num_heads=2, block=256), 2048),
    (lambda m: m.BSLongformerSparsityConfig(num_heads=1, block=128), 768),
    (lambda m: m.BigBirdSparsityConfig(num_heads=2, block=64, num_random_blocks=2), 1024),
    (lambda m: m.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=4,
                                     num_global_blocks=1), 1040),
    (lambda m: m.BigBirdSparsityConfig(num_heads=2, block=32, num_random_blocks=2), 1056),
    (lambda m: m.FixedSparsityConfig(num_heads=2, block=48, num_local_blocks=3), 1008),
    (lambda m: m.FixedSparsityConfig(num_heads=2, block=8, num_local_blocks=4), 520),
    (lambda m: m.BigBirdSparsityConfig(num_heads=2, block=24, num_random_blocks=2), 600),
])
def test_cta_lists_cover_exactly_the_layout(cfg, S, causal, bk):
    """Kernel S in bf16/fp16: the key tiles each 128-row query tile visits,
    their unit masks and the element test inside partly visible units
    cover the layout expanded to [H, S, S] (and the causal triangle)
    exactly, for blocks of 128 and more (no masks) and for every other
    block (S off a multiple of 128 included), at both key tiles."""
    c = cfg(sa)
    layout = sa._layout(c, S, c.num_heads)
    want = np.kron(layout > 0, np.ones((c.block, c.block), bool))
    if causal:
        want &= np.tril(np.ones((S, S), bool))
    np.testing.assert_array_equal(_cta_walk(layout, c.block, S, causal, bk), want)


@pytest.mark.parametrize("block,masked", [(128, False), (256, False), (512, False),
                                          (64, True), (32, True), (16, True), (24, True)])
def test_cta_tile_of_each_block(block, masked):
    """A layout block that is a multiple of 128 is one query tile's layout
    row and holds whole key tiles: its lists carry no unit masks.  Any other
    block is masked at 16 x 16 units; blocks that are multiples of 16 mark
    no unit as partly visible."""
    S = 2048 if block % 3 else 1536
    cfg = sa.FixedSparsityConfig(num_heads=2, block=block, num_local_blocks=2)
    layout = sa._layout(cfg, S, 2)
    for bk in (64, 128):
        _, cols, masks = sa.cta_lists(layout, block, S, True, bk, "cpu")
        assert (masks is not None) == masked
        if masked:
            assert masks.shape == (cols.shape[0], 16) and masks.dtype == torch.uint8
            assert masks[:, :8].any(1).all()  # a listed tile has a unit on
            assert bool((masks[:, 8:] != 0).any()) == bool(block % 16)


@pytest.mark.parametrize("D,masked,bk", [(16, False, 128), (48, False, 128), (64, False, 128),
                                         (64, True, 64), (16, True, 64), (80, False, 64),
                                         (128, True, 64), (224, False, 64), (256, False, 64)])
def test_cta_key_tile(D, masked, bk):
    """Kernel S's key tile at the kernel's head dim: 128 keys up to D = 64
    for lists without unit masks, 64 for masked lists and past D = 64."""
    assert sa.cta_key_tile(D, masked) == bk


def test_sparse_copy_route():
    """Kernel S reads q/k/v by TMA when every base is 16-byte aligned and
    every stride a positive multiple of 16 bytes; else by cp.async of the
    widest size (16, 8, 4 bytes) that divides every base and stride, and a
    tensor that allows none is copied by the wrapper (route 0 after)."""
    x = torch.zeros((1, 256, 4, 64), dtype=torch.bfloat16)
    assert sa.copy_route(x, x, x) == 0
    wide = torch.zeros((1, 256, 4, 68), dtype=torch.bfloat16)[..., :64]  # rows 136 bytes apart
    assert sa._cp_bytes(wide) == 8 and sa.copy_route(x, wide, x) == 8
    kv = torch.zeros((1, 256, 1, 64), dtype=torch.bfloat16).expand(1, 256, 4, 64)
    assert sa._cp_bytes(kv) == 16 and sa.copy_route(x, kv, kv) == 16
    base = torch.zeros(1 * 256 * 4 * 64 + 2, dtype=torch.bfloat16)
    off4 = base[2:].view(1, 256, 4, 64)  # the base 4 bytes past 16-byte alignment
    assert sa._cp_bytes(off4) == 4 and sa.copy_route(off4, x, x) == 4
    odd = torch.zeros((1, 256, 4, 65), dtype=torch.bfloat16)[..., :64]  # rows 130 bytes apart
    assert sa._cp_bytes(odd) == 0
    assert sa._cp_bytes(odd.transpose(2, 3)) == 0  # head dim not contiguous


def test_evoformer_dq_plan_from_the_library():
    """Kernel E''s plan is the built library's own: at AlphaFold 2's MSA row
    attention one key range, one chunk, K/V resident per head and a bias2
    ring of at least two stages; a key axis past the dbias1 rows that fit
    a block is cut into ranges; fp32 keeps its chunks of (h, query tile)
    units.  Needs the library: skipped where nvcc cannot build it."""
    from deepspeed_tpu_torch.ops import op_builder

    try:
        op_builder.load("evoformer_attn", ev._SIG)
    except op_builder.KernelBuildError as e:
        pytest.skip(f"the evoformer library cannot be built here: {str(e)[:80]}")
    plan = ev.dq_plan(torch.bfloat16, 1, 512, 384, 384, 8, 32, True, True)
    assert (plan.kranges, plan.chunks, plan.resident) == (1, 1, 1) and plan.b2_stages >= 2
    assert ev.dq_plan(torch.bfloat16, 1, 2, 64, 6000, 2, 128, True, True).kranges > 1
    assert ev.dq_plan(torch.bfloat16, 1, 4, 128, 4096, 8, 128, True, True).resident == 0
    fp32 = ev.dq_plan(torch.float32, 1, 8, 130, 130, 2, 128, True, False)
    assert fp32.chunks == min(2 * 3, -(-2 * torch.cuda.get_device_properties(0)
                                       .multi_processor_count // 8))


# ---------------------------------------------- plain paths vs JAX kernels
def _flash_inputs(seed, b, s, nh, kvh, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, nh, d).astype(np.float32), rng.randn(b, s, kvh, d).astype(np.float32),
            rng.randn(b, s, kvh, d).astype(np.float32), rng.randn(b, s, nh, d).astype(np.float32))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("D", [72, 80, 96, 160])
def test_flash_forward_head_dims_match_jax(D, alibi, dt):
    q, k, v, _ = _flash_inputs(0, 1, 40, 4, 2, D)
    jkw = {"alibi_slopes": jax_alibi_slopes(4)} if alibi else {}
    tkw = {"alibi_slopes": alibi_slopes(4, device="cpu")} if alibi else {}
    want = jax_flash(*(jnp.asarray(a, JNP[dt]) for a in (q, k, v)), causal=True, block_q=16,
                     block_k=16, **jkw)
    got, _ = fa.flash_attention_fwd(*(torch.from_numpy(a).to(TORCH[dt]) for a in (q, k, v)),
                                    causal=True, **tkw)
    tol = {"fp32": 1e-5, "bf16": 2e-2}[dt]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [72, 80, 96, 160])
def test_flash_grads_head_dims_match_jax(D, causal, dt):
    """Gradients of sum(o * dO) through the port's flash_attention (plain
    forward and backward on the CPU) vs jax.grad through the Pallas
    kernels, GQA 4 over 2 and S = 40 off the 16-row tiles."""
    q, k, v, do = _flash_inputs(1, 1, 40, 4, 2, D)
    args = [jnp.asarray(a, JNP[dt]) for a in (q, k, v)]
    cot = jnp.asarray(do, JNP[dt])

    def loss(q_, k_, v_):
        o = jax_flash(q_, k_, v_, causal=causal, block_q=16, block_k=16)
        return jnp.sum((o * cot).astype(jnp.float32))

    want = [np.asarray(g.astype(jnp.float32)) for g in jax.grad(loss, (0, 1, 2))(*args)]
    t = [torch.from_numpy(a).to(TORCH[dt]).requires_grad_() for a in (q, k, v)]
    fa.flash_attention(*t, causal=causal).backward(torch.from_numpy(do).to(TORCH[dt]))
    tol = {"fp32": 2e-5, "bf16": 2e-2}[dt]
    for x, w in zip(t, want):
        np.testing.assert_allclose(x.grad.float().numpy(), w, atol=tol, rtol=tol)


@pytest.mark.parametrize("D", [72, 80])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_head_dim_80_matches_jax(quant, alibi, D):
    rng = np.random.RandomState(2)
    B, NH, KVH, ps, MP = 3, 8, 2, 8, 4
    P = B * MP + 1
    q = rng.randn(B, NH, D).astype(np.float32)
    if quant:
        k = rng.randint(-127, 128, (P, ps, KVH, D)).astype(np.int8)
        v = rng.randint(-127, 128, (P, ps, KVH, D)).astype(np.int8)
        ks, vs = ((rng.rand(P, ps, KVH) * 0.05 + 0.01).astype(np.float32) for _ in range(2))
    else:
        k, v = (rng.randn(P, ps, KVH, D).astype(np.float32) for _ in range(2))
        ks = vs = None
    pos = np.array([5, 17, 30], np.int32)
    table = np.full((B, MP), P - 1, np.int32)
    perm, n = rng.permutation(P - 1), 0
    for b, p in enumerate(pos):
        table[b, :p // ps + 1] = perm[n:n + p // ps + 1]
        n += p // ps + 1
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = jax_paged(j(q), j(k), j(v), j(table), j(pos), k_scale=j(ks), v_scale=j(vs),
                     alibi_slopes=jax_alibi_slopes(NH) if alibi else None)
    got = pa.paged_decode_attention(t(q), t(k), t(v), t(table), t(pos), k_scale=t(ks),
                                    v_scale=t(vs),
                                    alibi_slopes=alibi_slopes(NH, device="cpu") if alibi else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name,block", [("fixed", 16), ("bslongformer", 32), ("bigbird", 16),
                                        ("fixed", 8), ("bigbird", 8), ("bslongformer", 24),
                                        ("fixed", 24)])
def test_sparse_small_blocks_match_jax_pallas(name, block, causal):
    cfgs = {"fixed": lambda m: m.FixedSparsityConfig(num_heads=2, block=block,
                                                      num_local_blocks=2, num_global_blocks=1),
            "bslongformer": lambda m: m.BSLongformerSparsityConfig(
                num_heads=2, block=block, num_sliding_window_blocks=3,
                global_block_indices=(0,)),
            "bigbird": lambda m: m.BigBirdSparsityConfig(num_heads=2, block=block,
                                                         num_random_blocks=1,
                                                         num_sliding_window_blocks=3,
                                                         num_global_blocks=1)}
    rng = np.random.RandomState(3)
    S = 128 if block % 8 == 0 and 128 % block == 0 else 120
    q, k, v = ((rng.randn(1, S, 2, 64) * 0.3).astype(np.float32) for _ in range(3))
    want = np.asarray(jsa.sparse_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           cfgs[name](jsa), causal=causal, impl="pallas"))
    got = sa.sparse_attention(*(torch.from_numpy(x) for x in (q, k, v)), cfgs[name](sa),
                              causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("bits,group,K", [(8, 16, 128), (4, 48, 200), (8, 48, 144)])
def test_wq_matmul_groups_off_the_stage_match_jax(bits, group, K, dt):
    w = np.random.RandomState(4).randn(K, 96).astype(np.float32) * 0.02
    x = np.random.RandomState(5).randn(2, 5, K).astype(np.float32)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    jc, js = jwq.quantize_weight(jnp.asarray(w), bits, group=group)
    tc, ts = twq.quantize_weight(torch.from_numpy(w), bits, group=group)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    got = twq.wq_matmul(torch.from_numpy(x).to(tdt), tc, ts, bits=bits, group=group)
    rtol = 2e-5 if dt == "fp32" else 2.0 ** -8
    for impl in ("pallas", "xla"):
        want = jwq.wq_matmul(jnp.asarray(x, jdt), jc, js, bits=bits, group=group, impl=impl)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=2e-5, rtol=rtol, err_msg=impl)


# ------------------------------------------------- kernel E'' (wgmma) host rules
@pytest.mark.parametrize("S,blocks,sms,want,chunks", [
    (512, 48, 132, True, 11),    # AlphaFold 2's MSA row attention: 528 blocks
    (384, 24, 132, True, 22),    # its triangle attention (H = 4)
    (512, 48, 132, False, 512),  # no bias2: every s its own block
    (3, 8, 132, True, 3),        # never more chunks than s
    (512, 1000, 132, True, 1),
])
def test_evoformer_dkv_chunks(S, blocks, sms, want, chunks):
    """Kernel E'' splits the MSA rows into chunks that make the grid cover
    the SMs about four times when it sums dbias2 over them; without bias2
    every s is a chunk."""
    assert ev.dkv_chunks(S, blocks, sms, want) == chunks


def test_evoformer_dkv_padded_rows():
    """Bias, lse and delta rows reach kernel E'' padded to a multiple of 4
    floats (16-byte chunks) with zeros; rows already so pass as they are."""
    t = torch.arange(2 * 130, dtype=torch.float32).reshape(2, 130)
    p = ev._padded_rows(t, 132)
    assert p.shape == (2, 132) and p.is_contiguous()
    assert torch.equal(p[:, :130], t) and not p[:, 130:].any()
    u = torch.zeros((2, 128))
    assert ev._padded_rows(u, 128) is u
    assert ev._padded_rows(None, 8) is None
