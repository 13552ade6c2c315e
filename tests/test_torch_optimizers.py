"""The port's optimizers (``runtime/optimizers.py``, ``runtime/fp16/
onebit.py``) against the JAX package's ``build_optimizer`` on the CPU.

The same seeded numpy leaves (a 2-D matrix, a tall 2-D matrix, a 1-D
vector and a 3-D block) and five steps of seeded gradients go through
both; after every step each leaf's params agree within 2e-6 absolute,
fp32.  The two compute the same formulas with the sums, square roots and
matrix products of two libraries (XLA's and PyTorch's CPU kernels): the
differences seen are a few ulps of the unit-sized updates, times lr 1e-3.
The 1-bit family runs with ``freeze_step`` 2, so the five steps cross
from exact warm-up into the compressed stage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepspeed_tpu.runtime import lr_schedules as jsched
from deepspeed_tpu.runtime import optimizers as jopt
from deepspeed_tpu_torch.runtime import lr_schedules as tsched
from deepspeed_tpu_torch.runtime import optimizers as topt

torch.set_num_threads(2)

LR = 1e-3
SHAPES = {"w": (16, 24), "tall": (24, 8), "b": (24,), "blk": (2, 4, 8)}
CASES = {
    "lamb": {"weight_decay": 0.1},
    "lion": {"weight_decay": 0.1},
    "adagrad": {},
    "sgd": {"momentum": 0.9},
    "sgd_nesterov": {"momentum": 0.9, "nesterov": True},
    "muon": {"weight_decay": 0.1},
    "onebitadam": {"freeze_step": 2, "weight_decay": 0.1},
    "zerooneadam": {"var_freeze_step": 2, "var_update_interval": 2},
    "onebitlamb": {"freeze_step": 2, "weight_decay": 0.1},
}


def _run(case, steps=5):
    name = case.split("_")[0]
    params = {"lr": LR, **CASES[case]}
    rng = np.random.RandomState(0)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(steps)]
    jtx, _ = jopt.build_optimizer(name, params, jsched.get_schedule(None, {}, LR))
    ttx, _ = topt.build_optimizer(name, params, tsched.get_schedule(None, {}, LR))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    keys = sorted(SHAPES)
    tp = [torch.from_numpy(p0[k].copy()) for k in keys]
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for g in grads:
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tu, tstate = ttx.update([torch.from_numpy(g[k]) for k in keys], tstate, tp)
        tp = [p + u for p, u in zip(tp, tu)]
        for k, t in zip(keys, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=0, atol=2e-6,
                                       err_msg=f"{case} leaf {k}")
    return tp, p0


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_jax(case):
    tp, p0 = _run(case)
    assert all(not np.array_equal(t.numpy(), p0[k]) for t, k in zip(tp, sorted(SHAPES)))


def test_muon_orthogonalises_2d_leaves_only():
    """Newton-Schulz output has singular values near 1 (optax's quintic
    lands in about [0.7, 1.2]); a 1-D leaf takes Adam."""
    x = torch.from_numpy(np.random.RandomState(3).randn(16, 24).astype(np.float32))
    s = torch.linalg.svdvals(topt.orthogonalize_newton_schulz(x))
    assert float(s.min()) > 0.5 and float(s.max()) < 1.3
