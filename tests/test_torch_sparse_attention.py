"""The port's block-sparse attention on the CPU (the plain path of kernel S)
vs the JAX package's ``sparse_attention`` (the Pallas kernel in interpret
mode), and its layout builders vs JAX's, bit for bit.

Sizes are the JAX test's (``tests/unit/ops/test_sparse_attention.py``: B=2,
S=512, H=2, D=64, block 128).  Tolerance 2e-5 in fp32: both sides compute
the same softmax in fp32; the Pallas kernel accumulates it online block by
block where the plain version takes it over the dense masked row, so only
summation order differs (outputs are O(0.3)).  Kernel S itself is checked
against the plain version on the card by ``chip_smoke.py`` (phase 18),
which also checks that a CUDA call with inputs that require a gradient
raises."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import sparse_attention as jsa
from deepspeed_tpu_torch.ops import sparse_attention as sa

torch.set_num_threads(2)

B, S, H, D = 2, 512, 2, 64
BLOCK = 128
TOL = 2e-5
CONFIGS = {
    "dense": lambda m, h: m.DenseSparsityConfig(num_heads=h, block=BLOCK),
    "fixed": lambda m, h: m.FixedSparsityConfig(num_heads=h, block=BLOCK, num_local_blocks=2,
                                                num_global_blocks=1),
    "bslongformer": lambda m, h: m.BSLongformerSparsityConfig(
        num_heads=h, block=BLOCK, num_sliding_window_blocks=3, global_block_indices=(0,)),
    "bigbird": lambda m, h: m.BigBirdSparsityConfig(num_heads=h, block=BLOCK,
                                                    num_random_blocks=1,
                                                    num_sliding_window_blocks=3,
                                                    num_global_blocks=1),
}
DEFAULTS = {
    "dense": lambda m, h: m.DenseSparsityConfig(num_heads=h),
    "fixed": lambda m, h: m.FixedSparsityConfig(num_heads=h),
    "bslongformer": lambda m, h: m.BSLongformerSparsityConfig(num_heads=h),
    "bigbird": lambda m, h: m.BigBirdSparsityConfig(num_heads=h, seed=7),
}


def _qkv(seed=0, s=S, h=H):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, s, h, D) * 0.3).astype(np.float32) for _ in range(3)]


def _jax(q, k, v, cfg, causal):
    return np.asarray(jsa.sparse_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg,
                                           causal=causal, impl="pallas"))


def _port(q, k, v, cfg, causal, **kw):
    return sa.sparse_attention(*(torch.from_numpy(x) for x in (q, k, v)), cfg, causal=causal,
                               **kw).numpy()


@pytest.mark.parametrize("name", list(DEFAULTS))
@pytest.mark.parametrize("seq_len", [1024, 2048])
@pytest.mark.parametrize("heads", [1, 4])
def test_layouts_bit_equal_to_jax(name, seq_len, heads):
    want = DEFAULTS[name](jsa, heads).make_layout(seq_len)
    got = DEFAULTS[name](sa, heads).make_layout(seq_len)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_config_fields_and_defaults_match_jax():
    for name in DEFAULTS:
        j, p = DEFAULTS[name](jsa, 3), DEFAULTS[name](sa, 3)
        assert type(j).__name__ == type(p).__name__
        assert vars(j) == vars(p)
    assert sa.SparsityConfig().block == jsa.SparsityConfig().block == 128


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("causal", [True, False])
def test_sparse_matches_jax_pallas(name, causal):
    q, k, v = _qkv()
    want = _jax(q, k, v, CONFIGS[name](jsa, H), causal)
    got = _port(q, k, v, CONFIGS[name](sa, H), causal)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_heads_broadcast_from_one_layout_head():
    q, k, v = _qkv(1)
    want = _jax(q, k, v, CONFIGS["bigbird"](jsa, 1), True)
    got = _port(q, k, v, CONFIGS["bigbird"](sa, 1), True)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _empty_row(module, row):
    class EmptyRow(module.FixedSparsityConfig):
        def make_layout(self, seq_len):
            lay = super().make_layout(seq_len)
            lay[:, row, :] = False
            return lay
    return EmptyRow(num_heads=H, block=BLOCK, num_local_blocks=2)


@pytest.mark.parametrize("causal", [True, False])
def test_empty_layout_row_gives_zero(causal):
    """A block row with no on-block: its queries see no key and give 0, as
    the JAX kernel does (no NaN)."""
    q, k, v = _qkv(2)
    got = _port(q, k, v, _empty_row(sa, 2), causal)
    assert np.isfinite(got).all()
    assert (got[:, 2 * BLOCK:3 * BLOCK] == 0).all()
    np.testing.assert_allclose(got, _jax(q, k, v, _empty_row(jsa, 2), causal), rtol=TOL,
                               atol=TOL)


def test_seq_len_off_the_block_raises():
    q, k, v = _qkv(3, s=BLOCK + 64)
    with pytest.raises(ValueError, match="not divisible"):
        _port(q, k, v, CONFIGS["fixed"](sa, H), True)


def test_impl_xla_is_the_plain_version():
    q, k, v = _qkv(4)
    cfg = CONFIGS["fixed"](sa, H)
    np.testing.assert_array_equal(_port(q, k, v, cfg, True, impl="xla"),
                                  _port(q, k, v, cfg, True))


def test_plain_version_is_differentiable_on_the_cpu():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(5))
    out = sa.sparse_attention(q, k, v, CONFIGS["bslongformer"](sa, H))
    out.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))
    assert sa.sparse_attention.launches == 0  # the CPU never launches kernel S


@pytest.mark.parametrize("causal", [True, False])
def test_block_lists_are_the_layout_rows(causal):
    """Kernel S's CSR lists hold, per layout head and block row, exactly the
    on-blocks (only those at or below the diagonal when causal), ascending,
    and are cached."""
    lay = CONFIGS["bigbird"](sa, 3).make_layout(1024)
    row_ptr, cols = sa.block_lists(lay, causal, "cpu")
    nb = lay.shape[1]
    assert row_ptr.dtype == cols.dtype == torch.int32 and row_ptr.numel() == 3 * nb + 1
    for h in range(3):
        for qi in range(nb):
            r = h * nb + qi
            want = np.nonzero(lay[h, qi, :qi + 1 if causal else nb])[0]
            np.testing.assert_array_equal(cols[row_ptr[r]:row_ptr[r + 1]].numpy(), want)
    again = sa.block_lists(lay, causal, "cpu")
    assert again[0] is row_ptr and again[1] is cols
