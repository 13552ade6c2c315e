"""The port's runtime utilities, Hessian eigenvalue and environment report
against the JAX package's, on the CPU with the same numpy inputs.

* ``runtime/utils.py``: ``clip_grad_norm_`` (norm and clipped leaves within
  1e-6 relative: fp32 sums in another order), ``flatten_tree`` /
  ``unflatten_tree`` (the buffer exactly, JAX's leaf order), the partition
  helpers exactly, ``set_random_seed`` (``random`` and numpy draw the same
  numbers after either package seeds them; torch's generator as
  ``torch.manual_seed`` leaves it), ``see_memory_usage`` (the same gauge
  names published);
* ``runtime/eigenvalue.py``: ``top_eigenvalue`` from the same start vector
  (JAX's draw, carried across) within 1e-4 relative on an MLP loss and on
  a quadratic of known spectrum; a loss through the flash attention's
  ``autograd.Function`` raises;
* ``env_report.py``: its report without a card."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import eigenvalue as jeig
from deepspeed_tpu.runtime import utils as jutils
from deepspeed_tpu.telemetry import registry as jreg
from deepspeed_tpu_torch.runtime import eigenvalue as teig
from deepspeed_tpu_torch.runtime import utils as tutils
from deepspeed_tpu_torch.telemetry import registry as treg

torch.set_num_threads(2)


def _grads(seed):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(7, 5).astype(np.float32), "b": rng.randn(11).astype(np.float32) * 3,
            "c": {"d": rng.randn(2, 3, 4).astype(np.float32)}}


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_grad_norm_matches_jax(max_norm):
    g = _grads(1)
    jc, jn = jutils.clip_grad_norm_(jax.tree_util.tree_map(jnp.asarray, g), max_norm)
    leaves = jax.tree_util.tree_leaves(g)
    tc, tn = tutils.clip_grad_norm_([torch.from_numpy(x) for x in leaves], max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for got, want in zip(tc, jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_flatten_unflatten_matches_jax():
    g = _grads(2)
    jflat, _, jshapes = jutils.flatten_tree(jax.tree_util.tree_map(jnp.asarray, g))
    tflat, tdef, tshapes = tutils.flatten_tree(
        {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else torch.from_numpy(v)) for k, v in reversed(list(g.items()))})
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    assert tshapes == jshapes
    back = tutils.unflatten_tree(tflat, tdef, tshapes)
    np.testing.assert_array_equal(back["c"]["d"].numpy(), g["c"]["d"])
    np.testing.assert_array_equal(back["a"].numpy(), g["a"])


def test_flatten_a_param_tree_round_trips():
    from deepspeed_tpu_torch.models.transformer import ParamTree

    tree = ParamTree({"w": torch.arange(6.0).reshape(2, 3), "sub": {"b": torch.ones(4)}})
    flat, tdef, shapes = tutils.flatten_tree(tree)
    assert flat.tolist() == [0, 1, 2, 3, 4, 5, 1, 1, 1, 1] and shapes == [(2, 3), (4,)]
    back = tutils.unflatten_tree(flat * 2, tdef, shapes)
    assert back.sub.b.tolist() == [2, 2, 2, 2] and back.w[1, 2].item() == 10


@pytest.mark.parametrize("n,parts", [(10, 3), (7, 7), (3, 5), (100, 8)])
def test_partitions_match_jax(n, parts):
    assert tutils.partition_uniform(n, parts) == jutils.partition_uniform(n, parts)
    w = np.random.RandomState(n).rand(n).tolist()
    assert tutils.partition_balanced(w, parts) == jutils.partition_balanced(w, parts)


def test_set_random_seed_seeds_the_host_generators_as_jax():
    draws = []
    for mod in (jutils, tutils):
        mod.set_random_seed(123)
        draws.append((random.random(), np.random.rand(3).tolist()))
    assert draws[0] == draws[1]
    gen = tutils.set_random_seed(7)
    a = torch.rand(4)
    torch.manual_seed(7)
    assert torch.equal(a, torch.rand(4))
    assert torch.equal(torch.rand(2, generator=gen),
                       torch.rand(2, generator=torch.Generator().manual_seed(7)))


def test_see_memory_usage_publishes_the_jax_gauges(monkeypatch):
    # each package's process ledger binds its gauges to the registry of its
    # creation: start both from none, on fresh registries, so that what an
    # earlier test in this worker left behind (a ledger made under a
    # registry it had swapped in) cannot hide the gauges
    from deepspeed_tpu.telemetry import memory as jmem
    from deepspeed_tpu_torch.telemetry import memory as tmem

    for reg, mem in ((jreg, jmem), (treg, tmem)):
        monkeypatch.setattr(reg, "_default_registry", reg.MetricsRegistry())
        monkeypatch.setattr(mem, "_default_ledger", None)
    names = ("deepspeed_tpu_memory_bytes_in_use", "deepspeed_tpu_memory_peak_bytes_in_use",
             "deepspeed_tpu_memory_bytes_limit")
    jutils.see_memory_usage("x", force=True)
    stats = tutils.see_memory_usage("x", force=True)
    assert stats["bytes_in_use"] > 0 and stats["bytes_limit"] > 0
    for n in names:
        assert n in jreg.get_registry()._metrics and n in treg.get_registry()._metrics, n
    assert treg.get_registry().get(names[0]).value() == stats["bytes_in_use"]


# ------------------------------------------------------------ eigenvalue
def _jax_start(params, seed):
    """JAX's start vector of top_eigenvalue (its own draw), as numpy."""
    leaves = jax.tree_util.tree_leaves(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return [np.array(jax.random.normal(k, x.shape, jnp.float32)) for k, x in zip(keys, leaves)]


def test_top_eigenvalue_of_a_known_quadratic():
    n = 2048
    rng = np.random.RandomState(0)
    lam = np.concatenate([[5.0, -2.0], rng.uniform(-1.5, 1.5, n - 2)]).astype(np.float32)
    q, _ = np.linalg.qr(rng.randn(n, n))
    A = ((q * lam) @ q.T).astype(np.float32)
    p = {"x": rng.randn(n).astype(np.float32)}
    want = float(jeig.top_eigenvalue(lambda t: 0.5 * t["x"] @ (jnp.asarray(A) @ t["x"]),
                                     jax.tree_util.tree_map(jnp.asarray, p),
                                     jax.random.PRNGKey(3)))
    At = torch.from_numpy(A)
    got = float(teig.top_eigenvalue(lambda ps: 0.5 * ps[0] @ (At @ ps[0]),
                                    [torch.from_numpy(p["x"])],
                                    v0=[torch.from_numpy(v) for v in _jax_start(p, 3)]))
    assert abs(got - want) <= 1e-4 * abs(want)
    assert abs(got - 5.0) <= 1e-3 * 5.0


def test_top_eigenvalue_of_an_mlp_loss():
    rng = np.random.RandomState(1)
    x, y = rng.randn(16, 8).astype(np.float32), rng.randn(16, 1).astype(np.float32)
    p = {"b1": rng.randn(12).astype(np.float32) * 0.1, "w1": rng.randn(8, 12).astype(np.float32),
         "w2": rng.randn(12, 1).astype(np.float32)}

    def jloss(t):
        return jnp.mean((jnp.tanh(x @ t["w1"] + t["b1"]) @ t["w2"] - y) ** 2)

    def tloss(ps):  # the leaves in JAX's (sorted) order: b1, w1, w2
        h = torch.tanh(torch.from_numpy(x) @ ps[1] + ps[0])
        return torch.mean((h @ ps[2] - torch.from_numpy(y)) ** 2)

    want = float(jeig.top_eigenvalue(jloss, jax.tree_util.tree_map(jnp.asarray, p),
                                     jax.random.PRNGKey(5)))
    leaves = [torch.from_numpy(v) for v in jax.tree_util.tree_leaves(p)]
    got = float(teig.top_eigenvalue(tloss, leaves,
                                    v0=[torch.from_numpy(v) for v in _jax_start(p, 5)]))
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


def test_top_eigenvalue_through_the_flash_function_raises():
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention

    g = torch.Generator().manual_seed(0)
    qkv = [torch.randn(1, 8, 2, 16, generator=g) for _ in range(3)]
    with pytest.raises(RuntimeError, match="hand-written kernel"):
        teig.top_eigenvalue(lambda ps: flash_attention(*ps, causal=True).square().sum(), qkv,
                            generator=torch.Generator().manual_seed(1), max_iters=2)


def test_top_eigenvalue_needs_a_start():
    with pytest.raises(ValueError, match="v0 or a torch.Generator"):
        teig.top_eigenvalue(lambda ps: ps[0].sum(), [torch.ones(2)])


# ------------------------------------------------------------ env report
def test_env_report_runs_without_a_card(capsys):
    from deepspeed_tpu_torch import env_report
    from deepspeed_tpu_torch.ops import op_builder

    rep = env_report.report()
    assert rep["cuda_available"] is False and rep["device_count"] == 0
    assert rep["torch"] == torch.__version__
    assert set(rep["kernels"]) == set(op_builder.SOURCES)
    for name, k in rep["kernels"].items():
        assert k["arch"] == "sm_90a" and op_builder._lib_path(name).name.endswith(
            f"_{k['digest']}.so")
    assert env_report.main([]) == 0
    assert "no CUDA device" in capsys.readouterr().out
