"""The port's fused Adam (plain version, the CPU path of kernel C) vs the
JAX package's ``fused_adam_update`` (the Pallas kernel in interpret mode).

The same numpy p/g/m/v go through both for three consecutive steps.
Tolerance: 2 ulps of fp32 relative (2^-22) plus 1e-9 absolute — both sides
evaluate the same fp32 expressions in the same order, and XLA and PyTorch
may round exp and sqrt an ulp apart.  A bf16 first moment is compared to
one bf16 ulp (2^-7 relative): an ulp of difference in the fp32 value
before rounding can move it to the neighbouring bf16 value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.fused_adam import fused_adam_update as jax_adam
from deepspeed_tpu_torch.ops import fused_adam as fa

torch.set_num_threads(2)

RTOL, ATOL = 2.0 ** -22, 1e-9
M_DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(got: torch.Tensor, want, rtol=RTOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=ATOL)


@pytest.mark.parametrize("n", [1, 127, 128, 1000])
@pytest.mark.parametrize("mu", ["fp32", "bf16"])
@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_matches_jax(adam_w_mode, wd, bias_correction, mu, n):
    rng = np.random.RandomState(n)
    p = rng.randn(n).astype(np.float32)
    m = (rng.randn(n) * 1e-3).astype(np.float32)
    v = np.abs(rng.randn(n) * 1e-4).astype(np.float32)
    jdt, tdt = M_DT[mu]
    jp, jm, jv = jnp.asarray(p), jnp.asarray(m, jdt), jnp.asarray(v)
    tp, tm, tv = torch.from_numpy(p.copy()), torch.from_numpy(m).to(tdt), torch.from_numpy(v.copy())
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd, adam_w_mode=adam_w_mode,
                 bias_correction=bias_correction)
    for step, lr in ((1, 1e-3), (2, 5e-4), (3, 2e-3)):
        g = (rng.randn(n) * 1e-2).astype(np.float32)
        jp, jm, jv = jax_adam(jp, jnp.asarray(g), jm, jv, jnp.asarray(step), lr, **hyper)
        fa.fused_adam_update(tp, torch.from_numpy(g), tm, tv,
                             torch.tensor([float(step), lr], dtype=torch.float32), **hyper)
        assert tm.dtype == tdt and tp.dtype == torch.float32
        _close(tp, jp)
        _close(tm, jm.astype(jnp.float32), rtol=RTOL if mu == "fp32" else 2.0 ** -7)
        _close(tv, jv)


def test_fused_adam_cpu_takes_plain_in_place_and_counts_no_launch():
    p, g = torch.randn(300), torch.randn(300) * 1e-2
    m, v = torch.zeros(300), torch.zeros(300)
    ptr, orig = p.data_ptr(), p.clone()
    p2, m2, v2 = p.clone(), m.clone(), v.clone()
    sc = torch.tensor([1.0, 1e-3])
    before = fa.fused_adam_update.launches
    fa.fused_adam_update(p, g, m, v, sc, weight_decay=0.1)
    fa.fused_adam_plain(p2, g, m2, v2, sc, weight_decay=0.1)
    assert fa.fused_adam_update.launches == before
    assert p.data_ptr() == ptr  # updated in place
    assert torch.equal(p, p2) and torch.equal(m, m2) and torch.equal(v, v2)
    assert not torch.equal(p, orig)


def test_fused_adam_rejects_bad_inputs():
    p = torch.zeros(8)
    sc = torch.tensor([1.0, 1e-3])
    with pytest.raises(TypeError, match="fp32"):
        fa.fused_adam_update(p.double(), p.double(), p.double(), p.double(), sc)
    with pytest.raises(ValueError, match="shapes"):
        fa.fused_adam_update(p, torch.zeros(9), p.clone(), p.clone(), sc)
    with pytest.raises(ValueError, match="step, lr"):
        fa.fused_adam_update(p, p.clone(), p.clone(), p.clone(), torch.tensor([1.0]))
