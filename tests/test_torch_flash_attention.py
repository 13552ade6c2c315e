"""The port's flash-attention forward (plain version, the CPU path) vs the
JAX package's Pallas flash attention run in interpret mode.

The same numpy inputs go through both.  Tolerances: fp32 1e-5 (both
sides keep fp32 scores and softmax; only summation order differs); bf16
2e-2 (the port's plain version follows the XLA prefill formulation,
which forms scores in bf16 and casts the probabilities to bf16 before
the PV product, while the Pallas kernel stays fp32 to the output)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas.flash_attention import _fwd as jax_fwd
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

TOL = {"fp32": 1e-5, "bf16": 2e-2}
JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _inputs(seed, b, sq, sk, nh, kvh, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, nh, d).astype(np.float32)
    k = rng.randn(b, sk, kvh, d).astype(np.float32)
    v = rng.randn(b, sk, kvh, d).astype(np.float32)
    return q, k, v


def _both(q, k, v, dt, **kw):
    """Run JAX (interpret-mode Pallas) and the port on the same arrays."""
    slopes = kw.pop("alibi", False)
    nh = q.shape[2]
    jkw = dict(kw)
    tkw = dict(kw)
    if slopes:
        jkw["alibi_slopes"] = jax_alibi_slopes(nh)
        tkw["alibi_slopes"] = alibi_slopes(nh, device="cpu")
    want = jax_flash(*(jnp.asarray(a, JNP[dt]) for a in (q, k, v)),
                     block_q=16, block_k=16, **jkw)
    got, _ = fa.flash_attention_fwd(*(torch.from_numpy(a).to(TORCH[dt]) for a in (q, k, v)),
                                    **tkw)
    return (np.asarray(want.astype(jnp.float32)), got.float().numpy())


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("kvh", [4, 2, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax(causal, kvh, dt):
    q, k, v = _inputs(0, 2, 32, 32, 4, kvh, 16)
    want, got = _both(q, k, v, dt, causal=causal)
    np.testing.assert_allclose(got, want, atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_flash_uneven_sq(dt):
    """Sq not a multiple of the block (40 vs 16): the JAX side pads."""
    q, k, v = _inputs(1, 1, 40, 40, 8, 2, 32)
    want, got = _both(q, k, v, dt, causal=True)
    np.testing.assert_allclose(got, want, atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("alibi", [False, True])
def test_flash_q_offset_padded_window(alibi, dt):
    """Chunked prefill: a 16-query chunk at q_offset 24 over a 48-slot
    window (slots 40..47 are pad/trash above every query)."""
    q, _, _ = _inputs(2, 1, 16, 48, 8, 2, 16)
    _, k, v = _inputs(3, 1, 16, 48, 8, 2, 16)
    want, got = _both(q, k, v, dt, causal=True, q_offset=24, alibi=alibi)
    np.testing.assert_allclose(got, want, atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_flash_alibi(dt):
    q, k, v = _inputs(4, 2, 32, 32, 8, 8, 16)
    want, got = _both(q, k, v, dt, causal=True, alibi=True)
    np.testing.assert_allclose(got, want, atol=TOL[dt], rtol=TOL[dt])


def test_flash_lse_and_valid_k_match_jax():
    """The fp32 log-sum-exp the kernel keeps for the backward, with
    columns >= valid_k masked, against the Pallas ``_fwd``."""
    q, k, v = _inputs(5, 1, 32, 48, 4, 2, 16)
    valid_k = 40
    bh = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(-1, a.shape[1], a.shape[3]))
    _, lse = jax_fwd(bh(q), bh(k), bh(v), jnp.zeros((4, 1), jnp.float32),
                     0.25, True, 16, 16, valid_k=valid_k, q_per_kv=2)
    o, lse_t = fa.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                      causal=True, valid_k=valid_k)
    np.testing.assert_allclose(lse_t.numpy().reshape(4, 32), np.asarray(lse)[..., 0],
                               atol=1e-5, rtol=1e-5)
    assert o.shape == q.shape


def test_flash_cpu_takes_plain_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 1, 16, 16, 4, 2, 16))
    before = fa.flash_attention_fwd.launches
    got, _ = fa.flash_attention_fwd(q, k, v, causal=True)
    want, _ = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    assert torch.equal(got, want)
    assert fa.flash_attention_fwd.launches == before


def test_flash_bf16_inputs_round_like_jax():
    """numpy -> bf16 rounds identically on both sides, so the bf16 cases
    above compare the same inputs."""
    x = np.random.RandomState(7).randn(64).astype(np.float32)
    a = np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)
    b = torch.from_numpy(x).bfloat16().float().numpy()
    np.testing.assert_array_equal(a, b)
