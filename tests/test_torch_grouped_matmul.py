"""The port's grouped (block-diagonal) expert matmul vs the JAX package's
``grouped_matmul``, through its XLA branch and through the Pallas kernel in
interpret mode (as the JAX package's own tests run it on the CPU).

Tolerances: fp32 1e-5 (both sum in fp32, in other orders); bf16: both
multiply the bf16 inputs in fp32 and round once to bf16, so a fp32 sum that
differs in its last bits may round to the neighbouring bf16 value: one bf16
ulp, rtol 2^-7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.grouped_matmul import grouped_matmul as jax_gmm
from deepspeed_tpu_torch.ops import grouped_matmul as gm

torch.set_num_threads(2)

TOL = {"fp32": (1e-5, 1e-5), "bf16": (1e-6, 2.0 ** -7)}  # (atol, rtol)
JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _inputs(block_rows, dt, E=3, H=32, F=48, order=(0, 2, 1, 1, 0), seed=0):
    """x [len(order) * block_rows, H], w [E, H, F] and a non-monotone
    block -> expert map, as numpy, rounded to ``dt`` first."""
    rng = np.random.RandomState(seed)
    x = rng.randn(len(order) * block_rows, H).astype(np.float32)
    w = rng.randn(E, H, F).astype(np.float32)
    if dt == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        w = np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32)
    return x, w, np.asarray(order, np.int32)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("block_rows", [8, 128])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_plain_matches_jax(impl, block_rows, dt):
    x, w, be = _inputs(block_rows, dt)
    want = jax_gmm(jnp.asarray(x, JNP[dt]), jnp.asarray(w, JNP[dt]), jnp.asarray(be),
                   block_rows=block_rows, impl=impl)
    got = gm.grouped_matmul_plain(torch.from_numpy(x).to(TORCH[dt]),
                                  torch.from_numpy(w).to(TORCH[dt]), torch.from_numpy(be),
                                  block_rows=block_rows)
    assert got.dtype == TORCH[dt] and tuple(got.shape) == want.shape
    atol, rtol = TOL[dt]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


#: the layouts the backward's cluster kernels pair and tile differently
#: (chip_smoke.py phase 21) through the forward, as (H, F, block_rows,
#: block -> expert map over 4 experts): an odd count of 128-row tiles of H,
#: an odd count of 128-column tiles of F, an odd run of tiles starting at an
#: odd tile at the last expert, two experts alternating, also with an F
#: (G''s K) of three steps of 64
CORNERS = {"h384_odd_row_tiles": (384, 256, 8, (0, 0, 1, 3, 3)),
           "f384_odd_col_tiles": (128, 384, 8, (0, 2, 2, 3, 1)),
           "odd_run_at_last_expert": (32, 48, 128, (0, 0, 0, 1, 1, 2, 2, 3, 3, 3)),
           "alternating_experts": (32, 48, 8, (0, 1) * 6),
           "alternating_experts_f192": (32, 192, 8, (0, 1) * 6)}


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("corner", sorted(CORNERS))
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_plain_matches_jax_at_backward_kernel_corners(impl, corner, dt):
    H, F, block_rows, order = CORNERS[corner]
    x, w, be = _inputs(block_rows, dt, E=4, H=H, F=F, order=order, seed=2)
    # weights at a layer's init scale, ~1/sqrt(H) (a power of two keeps them
    # exact in bf16), so the fp32 sums stay O(1) as the limits assume
    w = w * np.float32(2.0 ** -round(np.log2(H) / 2))
    want = jax_gmm(jnp.asarray(x, JNP[dt]), jnp.asarray(w, JNP[dt]), jnp.asarray(be),
                   block_rows=block_rows, impl=impl)
    got = gm.grouped_matmul_plain(torch.from_numpy(x).to(TORCH[dt]),
                                  torch.from_numpy(w).to(TORCH[dt]), torch.from_numpy(be),
                                  block_rows=block_rows)
    atol, rtol = TOL[dt]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def test_plain_gathers_in_chunks_like_one_einsum(monkeypatch):
    """More blocks than ``PLAIN_BLOCKS_PER_CHUNK``: the chunked gather gives
    what one gather of every block gives."""
    x, w, be = _inputs(8, "fp32", order=(2, 0, 1, 2, 2, 0, 1))
    xt, wt, bt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(be)
    want = torch.einsum("bph,bhf->bpf", xt.reshape(7, 8, -1), wt[bt.long()]).reshape(56, -1)
    monkeypatch.setattr(gm, "PLAIN_BLOCKS_PER_CHUNK", 3)
    np.testing.assert_allclose(gm.grouped_matmul_plain(xt, wt, bt, 8).numpy(), want.numpy(),
                               atol=1e-5, rtol=1e-5)


def test_wrapper_takes_the_plain_version_on_the_cpu_without_counting():
    x, w, be = _inputs(8, "fp32")
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(be))
    before = gm.grouped_matmul.launches
    assert torch.equal(gm.grouped_matmul(*args, block_rows=8),
                       gm.grouped_matmul_plain(*args, block_rows=8))
    assert gm.grouped_matmul.launches == before


def test_rows_must_fill_whole_blocks():
    x, w, be = _inputs(8, "fp32")
    with pytest.raises(ValueError, match="whole blocks"):
        gm.grouped_matmul(torch.from_numpy(x[:-1]), torch.from_numpy(w),
                          torch.from_numpy(be), block_rows=8)
    with pytest.raises(ValueError, match="block_expert"):
        gm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(be[:-1]), block_rows=8)


def test_expert_index_is_clamped():
    """An index outside [0, E) takes the nearest expert (the kernel clamps
    too: it never reads outside ``w``)."""
    x, w, _ = _inputs(8, "fp32")
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = gm.grouped_matmul_plain(xt, wt, torch.tensor([-1, 5, 1, 1, 0], dtype=torch.int32), 8)
    want = gm.grouped_matmul_plain(xt, wt, torch.tensor([0, 2, 1, 1, 0], dtype=torch.int32), 8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("n_used", [0, 2, 4, 5])
def test_plain_with_n_used_is_jax_on_the_used_blocks_and_zeros_after(n_used, dt):
    """``n_used`` (the blocks that hold a real row, a device int): the rows
    of the first n_used blocks are JAX's ``grouped_matmul`` (through the
    Pallas kernel in interpret mode), the rest zeros, whatever x holds
    there; without it the function is JAX's on every row."""
    block_rows = 8
    x, w, be = _inputs(block_rows, dt)
    want = np.asarray(jax_gmm(jnp.asarray(x, JNP[dt]), jnp.asarray(w, JNP[dt]),
                              jnp.asarray(be), block_rows=block_rows, impl="pallas"), np.float32)
    xt, wt = torch.from_numpy(x).to(TORCH[dt]), torch.from_numpy(w).to(TORCH[dt])
    nu = torch.tensor([n_used], dtype=torch.int32)
    got = gm.grouped_matmul(xt, wt, torch.from_numpy(be), block_rows, nu).float().numpy()
    rows = n_used * block_rows
    atol, rtol = TOL[dt]
    np.testing.assert_allclose(got[:rows], want[:rows], atol=atol, rtol=rtol)
    assert not got[rows:].any()
    full = gm.grouped_matmul(xt, wt, torch.from_numpy(be), block_rows).float().numpy()
    np.testing.assert_allclose(full, want, atol=atol, rtol=rtol)


def test_n_used_must_be_one_int32():
    x, w, be = _inputs(8, "fp32")
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(be), 8)
    with pytest.raises(ValueError, match="n_used"):
        gm.grouped_matmul(*args, torch.tensor([1, 2], dtype=torch.int32))
    with pytest.raises(ValueError, match="n_used"):
        gm.grouped_matmul(*args, torch.tensor([1], dtype=torch.int64))


def test_dropless_layer_counts_the_blocks_it_uses():
    """The router's padded layout: the blocks up to the last that holds an
    assignment are used; the trailing all-padding ones are not."""
    from deepspeed_tpu_torch.moe.sharded_moe import sort_pad_by_expert

    key = torch.tensor([3, 0, 3, 1, 3, 0, 3], dtype=torch.int64)  # experts 0, 1, 3 of 4
    _, dest, n_rows, be = sort_pad_by_expert(key, 4, 2)
    n_used = int((torch.where(dest < n_rows, dest, -2).max() // 2 + 1).item())
    # expert 0: 2 rows (1 block), 1: 1 row (1 block), 3: 4 rows (2 blocks)
    assert n_used == 4 and n_rows // 2 > n_used
    assert be[:n_used].tolist() == [0, 1, 3, 3]
