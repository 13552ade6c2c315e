"""The port's weight-only quantized matmul (``ops/wq_matmul.py``) vs the
JAX package's (``deepspeed_tpu/ops/pallas/wq_matmul.py``), on the same
numpy inputs on the CPU.

``quantize_weight`` / ``dequantize_weight`` are plain arithmetic on both
sides and must be bit-equal (codes, scales and dequantized weights).  The
matmul on the CPU is the plain version (whole dequant, fp32 matmul): held
against the JAX XLA branch and the Pallas kernel in interpret mode (which
sums ``x @ (q * s)`` per group) within 2e-5 in fp32 (the JAX package's own
limit for this kernel, ``tests/unit/test_inference_v2.py``: summation
order only) and, with bf16 x, within one bf16 rounding of the output
(2^-8 relative) plus 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import wq_matmul as jwq
from deepspeed_tpu_torch.ops import wq_matmul as twq

torch.set_num_threads(2)


def _w(K, N, seed=0):
    return np.random.RandomState(seed).randn(K, N).astype(np.float32) * 0.02


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("K", [128, 200])
def test_quantize_dequantize_bit_equal_to_jax(bits, K):
    w = _w(K, 96)
    jc, js = jwq.quantize_weight(jnp.asarray(w), bits, group=64)
    tc, ts = twq.quantize_weight(torch.from_numpy(w), bits, group=64)
    assert tc.dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jd = jwq.dequantize_weight(jc, js, bits=bits, group=64, k=K, dtype=jdt)
        td = twq.dequantize_weight(tc, ts, bits=bits, group=64, k=K, dtype=dt)
        np.testing.assert_array_equal(td.float().numpy(), np.asarray(jd, np.float32))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("K", [128, 200])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_wq_matmul_matches_jax_kernel_and_xla(bits, K, dt):
    w = _w(K, 96)
    x = np.random.RandomState(1).randn(2, 5, K).astype(np.float32)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    jc, js = jwq.quantize_weight(jnp.asarray(w), bits, group=64)
    tc, ts = twq.quantize_weight(torch.from_numpy(w), bits, group=64)
    got = twq.wq_matmul(torch.from_numpy(x).to(tdt), tc, ts, bits=bits, group=64)
    assert got.shape == (2, 5, 96) and got.dtype == tdt
    rtol = 2e-5 if dt == "fp32" else 2.0 ** -8
    for impl in ("pallas", "xla"):
        want = jwq.wq_matmul(jnp.asarray(x, jdt), jc, js, bits=bits, group=64, impl=impl)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=2e-5, rtol=rtol, err_msg=impl)


def test_int4_packing_low_nibble_is_even_row():
    """Row 2i in the low nibble, row 2i+1 in the high one, stored as q + 8."""
    w = np.zeros((64, 1), np.float32)
    w[0, 0], w[1, 0] = 1.0, -1.0  # group absmax 1: q = 7 and -7
    codes, scale = twq.quantize_weight(torch.from_numpy(w), 4, group=64)
    assert int(codes[0, 0]) == (7 + 8) | ((-7 + 8) << 4)
    assert int(codes[1, 0]) == 8 | (8 << 4)
    np.testing.assert_allclose(scale.numpy(), [[1.0 / 7.0]])


def test_wq_matmul_rejects_bad_layouts():
    w = torch.from_numpy(_w(128, 32))
    codes, scale = twq.quantize_weight(w, 8, group=64)
    x = torch.zeros((3, 128))
    with pytest.raises(TypeError, match="codes"):
        twq.wq_matmul(x, codes.to(torch.uint8), scale, bits=8, group=64)
    with pytest.raises(ValueError, match="scale"):
        twq.wq_matmul(x, codes, scale.to(torch.float16), bits=8, group=64)
    with pytest.raises(ValueError, match="K=129"):
        twq.wq_matmul(torch.zeros((3, 129)), codes, scale, bits=8, group=64)


@pytest.mark.parametrize("sms,tiles,n_groups,per_sm", [
    (132, 64, 32, 8), (132, 500, 32, 8), (132, 2000, 32, 8), (132, 1, 7, 8), (8, 3, 86, 8),
    (132, 256, 32, 1), (132, 32, 86, 1)])
def test_split_k_covers_every_group_once(sms, tiles, n_groups, per_sm):
    """The kernel's split of K: whole groups, every group in exactly one
    split, no empty split, no split when the tiles fill the card, and no
    more blocks than one wave holds."""
    splits, per = twq._splits(sms, tiles, n_groups, per_sm)
    assert 1 <= splits <= n_groups and splits * per >= n_groups > (splits - 1) * per
    target = per_sm * sms
    if tiles >= target:
        assert splits == 1
    else:
        assert splits * tiles <= target or splits == 1
        assert splits > 1 or target // tiles < 2 or n_groups == 1


def test_tiles_follow_rows_and_type():
    """bf16/fp16 x takes the tensor-core kernel with the token tile that
    holds M (128-token tiles past that); fp32 x takes the FMA kernel, whose
    tile is 16 rows at decode and 64 past it."""
    assert twq._tile(8, torch.bfloat16) == twq.Tile("wgmma", 8, 64, 4)
    assert twq._tile(900, torch.float16) == twq.Tile("wgmma", 128, 128, 1)
    assert twq._tile(17, torch.float32) == twq.TILE_FMA
    assert twq._tile(8, torch.float32) == twq.TILE_FMA_DECODE


@pytest.mark.parametrize("M,rows,cols,per_sm", [
    (1, 8, 64, 4), (8, 8, 64, 4), (9, 16, 64, 4), (16, 16, 64, 4), (17, 32, 64, 3),
    (32, 32, 64, 3), (33, 64, 128, 1), (64, 64, 128, 1), (65, 128, 128, 1),
    (900, 128, 128, 1)])
def test_token_tile_is_the_smallest_that_holds_m(M, rows, cols, per_sm):
    """wgmma's N is the token count: decode (8 slots) runs m64n8 with no
    padded rows; a single warpgroup per block (several blocks an SM) up to
    32 tokens, two past that (one block an SM)."""
    for dt in (torch.bfloat16, torch.float16):
        t = twq._tile(M, dt)
        assert t == twq.Tile("wgmma", rows, cols, per_sm)
        assert M <= t.rows or t.rows == twq.TOKEN_TILES[-1]
        assert twq._tile(M, dt, 64) == t  # any group that is a multiple of the stage
    # a layout TMA cannot read takes the FMA kernel at the same M
    assert twq._tile(M, torch.bfloat16, 128, tma=False).kernel == "fma"


def test_tma_rule_reads_aligned_rows_and_codes():
    """The tensor-core kernel reads x and the codes by TMA: K % 8 == 0 (x's
    rows 16-byte strides), N % 16 == 0 (the codes' rows) and 16-byte aligned
    bases; anything else takes the FMA kernel."""
    x = torch.zeros((3, 1024), dtype=torch.bfloat16)
    codes = torch.zeros((1024, 256), dtype=torch.int8)
    assert twq._tma_ok(x, codes, 1024, 256)
    assert not twq._tma_ok(x, codes, 1003, 256)
    assert not twq._tma_ok(x, codes, 1024, 200)
    assert not twq._tma_ok(x.view(-1)[1:1025].view(1, 1024), codes, 1024, 256)
