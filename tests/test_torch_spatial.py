"""The port's spatial / diffusers ops (``ops/spatial.py``) against the JAX
package's on the CPU: the same numpy weights and activations through both,
in fp32 (the JAX side takes its plain einsum path off the TPU, the port
its plain path on CPU tensors).

Tolerance 1e-5 absolute and relative for the blocks (the same fp32
formulas; the two packages' GEMMs and reductions sum in other orders) and
for the attention and the norms; the bias adds exactly.  Kernel A on the
card is held against the plain path by ``chip_smoke.py``'s
``spatial_phase``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import spatial as jsp
from deepspeed_tpu_torch.ops import spatial as tsp

torch.set_num_threads(2)
TOL = 1e-5


def _attn_params(rng, C, Cctx, bias):
    p = {"wq": rng.randn(C, C) / np.sqrt(C), "wk": rng.randn(Cctx, C) / np.sqrt(Cctx),
         "wv": rng.randn(Cctx, C) / np.sqrt(Cctx), "wo": rng.randn(C, C) / np.sqrt(C)}
    if bias:
        p.update({k: rng.randn(C) * 0.1 for k in ("bq", "bk", "bv", "bo")})
    return {k: v.astype(np.float32) for k, v in p.items()}


def _block_params(rng, C, Cctx):
    ln = lambda: {"scale": (1 + 0.1 * rng.randn(C)).astype(np.float32),  # noqa: E731
                  "bias": (0.1 * rng.randn(C)).astype(np.float32)}
    return {"norm1": ln(), "norm2": ln(), "norm3": ln(),
            "attn1": _attn_params(rng, C, C, False), "attn2": _attn_params(rng, C, Cctx, False),
            "ff": {"w_in": (rng.randn(C, 8 * C) / np.sqrt(C)).astype(np.float32),
                   "w_out": (rng.randn(4 * C, C) / np.sqrt(4 * C)).astype(np.float32)}}


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("C,heads,HW,T,Cctx", [(64, 8, 64, 77, 48), (80, 2, 16, 77, 32),
                                                 (160, 4, 24, 7, 160)],
                         ids=["d8_cross77", "d40_cross77", "d40_odd"])
def test_transformer_block_matches_jax(C, heads, HW, T, Cctx):
    rng = np.random.RandomState(C + HW)
    p = _block_params(rng, C, Cctx)
    x = rng.randn(2, HW, C).astype(np.float32)
    ctx = rng.randn(2, T, Cctx).astype(np.float32)
    want = jsp.diffusers_transformer_block(jnp.asarray(x), _map(p, jnp.asarray), heads,
                                           jnp.asarray(ctx))
    got = tsp.diffusers_transformer_block(torch.from_numpy(x), _map(p, torch.from_numpy), heads,
                                          torch.from_numpy(ctx))
    _close(got.numpy(), want)


@pytest.mark.parametrize("cross,bias", [(False, False), (True, True)], ids=["self", "cross_bias"])
def test_attention_matches_jax(cross, bias):
    rng = np.random.RandomState(3)
    C, heads = 40, 1
    p = _attn_params(rng, C, 24 if cross else C, bias)
    x = rng.randn(2, 33, C).astype(np.float32)
    ctx = rng.randn(2, 77, 24).astype(np.float32) if cross else None
    want = jsp.diffusers_attention(jnp.asarray(x), _map(p, jnp.asarray), heads,
                                   None if ctx is None else jnp.asarray(ctx))
    got = tsp.diffusers_attention(torch.from_numpy(x), _map(p, torch.from_numpy), heads,
                                  None if ctx is None else torch.from_numpy(ctx))
    _close(got.numpy(), want)


def test_bias_adds_and_group_norm_match_jax():
    rng = np.random.RandomState(5)
    a, o = (rng.randn(2, 16, 64).astype(np.float32) for _ in range(2))
    b, ob = (rng.randn(64).astype(np.float32) for _ in range(2))
    J, T = (jnp.asarray, torch.from_numpy)
    np.testing.assert_array_equal(tsp.nhwc_bias_add(T(a), T(b)).numpy(),
                                  np.asarray(jsp.nhwc_bias_add(J(a), J(b))))
    np.testing.assert_array_equal(tsp.nhwc_bias_add_add(T(a), T(b), T(o)).numpy(),
                                  np.asarray(jsp.nhwc_bias_add_add(J(a), J(b), J(o))))
    np.testing.assert_array_equal(
        tsp.nhwc_bias_add_bias_add(T(a), T(b), T(o), T(ob)).numpy(),
        np.asarray(jsp.nhwc_bias_add_bias_add(J(a), J(b), J(o), J(ob))))
    _close(tsp.group_norm(T(a), 8, T(b), T(ob)).numpy(), jsp.group_norm(J(a), 8, J(b), J(ob)))


def test_a_meta_tensor_is_refused():
    """Only CPU tensors take the plain path (a CUDA tensor takes kernel A)."""
    x = torch.empty((1, 4, 8), device="meta")
    p = {k: torch.empty((8, 8), device="meta") for k in ("wq", "wk", "wv", "wo")}
    with pytest.raises(ValueError, match="unsupported device"):
        tsp.diffusers_attention(x, p, 2)
