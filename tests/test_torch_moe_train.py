"""MoE training in the port against the JAX package, on the same numpy
inputs on the CPU: the grouped matmul's backward (G' and G'' plain
versions against ``jax.vjp`` of the JAX ``grouped_matmul``, its XLA
branch), the autograd Function, ``moe_ffn``'s gradients against
``jax.grad`` (dropless and capacity), Mixtral ``tiny``'s
``causal_lm_loss`` and its gradients for every leaf, and three
``initialize`` -> ``train_batch`` steps against the JAX engine.

Tolerances, and why:
  * fp32 1e-5 (the forward tests' limit): the same formulas summed in
    another order.  Gradients are held leaf by leaf to their largest
    magnitude: max |g_port - g_jax| <= 1e-5 * max |g_jax|; a layer's
    gradients to max(1, max |g_jax|), as the layer tests scale outputs: a
    route whose true derivative cancels exactly (top-1 renormalised to 1)
    leaves each framework its own rounding of O(1) terms.
  * bf16 G': both compute dy_f32 @ w_f32^T and round once to bf16, so a
    fp32 sum that differs in its last bits may round to the neighbouring
    bf16 value: one bf16 ulp (rtol 2^-7), as the forward's test.
  * bf16 G'': the port sums each expert's blocks in fp32 and rounds once;
    its limit is that rounding against a float64 sum of the same bf16
    inputs (rtol 2^-8, atol 1e-6).  JAX rounds each block's product to bf16
    and its scatter-add sums them in bf16, one rounding per block: against
    JAX, 2^-6 of the largest |dw|.
  * The engine: fp32 limits of ``tests/test_torch_engine.py`` (loss and grad
    norm 1e-5 relative, master weights 5e-5 absolute, 5e-6 on average).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.moe import sharded_moe as jm
from deepspeed_tpu.ops.pallas.grouped_matmul import grouped_matmul as jax_gmm
from deepspeed_tpu_torch.models import mixtral as tmixtral
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.moe import sharded_moe as tm
from deepspeed_tpu_torch.ops import grouped_matmul as gm

torch.set_num_threads(2)

JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}
GRAD_TOL = 1e-5


def _np(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


def _rounded(a, dt):
    return np.asarray(jnp.asarray(a, JNP[dt]), np.float32) if dt == "bf16" else a


# ---------------------------------------------------------------------------
# G' and G'': the grouped matmul's backward
# ---------------------------------------------------------------------------
#: block -> expert maps over 4 experts: the router's sorted layout with
#: expert 1 holding no row, a non-monotone map, and one expert everywhere
ORDERS = {"sorted_no_rows_e1": (0, 0, 2, 3, 3, 3), "nonmonotone": (2, 0, 3, 1, 1, 0),
          "one_expert": (3, 3, 3, 3, 3, 3)}
#: the layouts the cluster kernels G' and G'' pair and tile differently
#: (chip_smoke.py phase 21), as (H, F, block_rows, block -> expert map):
#: an odd count of 128-row tiles of H (a cluster's second block past H in
#: G'' and past N in G'), an odd count of 128-column tiles of F, a run of
#: an odd count of tiles starting at an odd tile at the last expert, and
#: two experts alternating (more runs than G''s grid has slots), also with
#: a K of G' (F) of three steps of 64, fewer than its ring's stages
KERNEL_CORNERS = {"h384_odd_row_tiles": (384, 256, 16, (0, 0, 1, 3, 3)),
                  "f384_odd_col_tiles": (128, 384, 16, (0, 2, 2, 3, 1)),
                  "odd_run_at_last_expert": (24, 40, 128, (0, 0, 0, 1, 1, 2, 2, 3, 3, 3)),
                  "alternating_experts": (24, 40, 16, (0, 1) * 6),
                  "alternating_experts_k192": (24, 192, 16, (0, 1) * 6)}


def _bwd_inputs(block_rows, dt, order, E=4, H=24, F=40, seed=0):
    rng = np.random.RandomState(seed)
    P = len(order) * block_rows
    x = _rounded(rng.randn(P, H).astype(np.float32), dt)
    w = _rounded(rng.randn(E, H, F).astype(np.float32), dt)
    dy = _rounded(rng.randn(P, F).astype(np.float32), dt)
    return x, w, dy, np.asarray(order, np.int32)


def _jax_vjp(x, w, dy, be, block_rows, dt, n_used=None):
    """(dx, dw) of the JAX grouped_matmul (XLA branch) at cotangent dy, the
    rows of blocks >= n_used masked out of dy (the port's n_used makes those
    rows zeros whatever x and w hold)."""
    if n_used is not None:
        dy = dy.copy()
        dy[n_used * block_rows:] = 0
    f = lambda a, b: jax_gmm(a, b, jnp.asarray(be), block_rows=block_rows, impl="xla")  # noqa: E731
    _, vjp = jax.vjp(f, jnp.asarray(x, JNP[dt]), jnp.asarray(w, JNP[dt]))
    return vjp(jnp.asarray(dy, JNP[dt]))


def _check_plain_bwd_against_jax(x, w, dy, be, block_rows, dt):
    """G' and G'' plain on (x, w, dy, be) against jax.vjp of the einsum
    branch (the limits of the module docstring); returns (dx, dw)."""
    jdx, jdw = _jax_vjp(x, w, dy, be, block_rows, dt)
    T = TORCH[dt]
    tw, tbe = torch.from_numpy(w).to(T), torch.from_numpy(be)
    dx = gm.grouped_matmul_dx_plain(torch.from_numpy(dy).to(T), tw, tbe, block_rows)
    dw = gm.grouped_matmul_dw_plain(torch.from_numpy(x).to(T), torch.from_numpy(dy).to(T),
                                    tbe, 4, block_rows)
    assert dx.dtype == dw.dtype == T and tuple(dw.shape) == w.shape
    if dt == "fp32":
        np.testing.assert_allclose(_np(dx), _np(jdx), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(dw), _np(jdw), atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(_np(dx), _np(jdx), atol=1e-6, rtol=2.0 ** -7)
        xb = x.reshape(-1, block_rows, x.shape[1]).astype(np.float64)
        gb = dy.reshape(-1, block_rows, dy.shape[1]).astype(np.float64)
        exact = np.zeros(w.shape)
        for b, e in enumerate(be):
            exact[e] += xb[b].T @ gb[b]
        np.testing.assert_allclose(_np(dw), exact, atol=1e-6, rtol=2.0 ** -8)
        assert np.abs(_np(dw) - _np(jdw)).max() <= 2.0 ** -6 * np.abs(exact).max()
    return dx, dw


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("block_rows", [128, 64, 16])
def test_backward_plain_versions_match_jax_vjp(block_rows, order, dt):
    x, w, dy, be = _bwd_inputs(block_rows, dt, ORDERS[order])
    _, dw = _check_plain_bwd_against_jax(x, w, dy, be, block_rows, dt)
    if order == "sorted_no_rows_e1":
        assert not dw[1].any()  # an expert with no rows: zeros


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("corner", sorted(KERNEL_CORNERS))
def test_backward_plain_versions_match_jax_vjp_at_kernel_corners(corner, dt):
    H, F, block_rows, order = KERNEL_CORNERS[corner]
    x, w, dy, be = _bwd_inputs(block_rows, dt, order, H=H, F=F, seed=11)
    _check_plain_bwd_against_jax(x, w, dy, be, block_rows, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_backward_with_n_used_0_is_zeros(dt):
    """n_used 0: every block is padding, so the forward is zeros whatever x
    and w hold; dX and dW are zeros, as JAX gives on the masked cotangent."""
    x, w, dy, be = _bwd_inputs(16, dt, ORDERS["nonmonotone"], seed=9)
    jdx, jdw = _jax_vjp(x, w, dy, be, 16, dt, n_used=0)
    T = TORCH[dt]
    n_used = torch.tensor([0], dtype=torch.int32)
    dx = gm.grouped_matmul_dx(torch.from_numpy(dy).to(T), torch.from_numpy(w).to(T),
                              torch.from_numpy(be), 16, n_used)
    dw = gm.grouped_matmul_dw(torch.from_numpy(x).to(T), torch.from_numpy(dy).to(T),
                              torch.from_numpy(be), 4, 16, n_used)
    assert dx.shape == x.shape and tuple(dw.shape) == w.shape
    assert not dx.any() and not dw.any()
    assert not np.asarray(jdx, np.float32).any() and not np.asarray(jdw, np.float32).any()


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("block_rows", [128, 16])
def test_backward_honours_n_used(block_rows, dt):
    """Blocks >= n_used are zeros in the forward whatever x and w hold: their
    rows get a zero dX and add nothing to dW (JAX on the masked cotangent)."""
    x, w, dy, be = _bwd_inputs(block_rows, dt, ORDERS["nonmonotone"], seed=3)
    jdx, jdw = _jax_vjp(x, w, dy, be, block_rows, dt, n_used=4)
    T = TORCH[dt]
    n_used = torch.tensor([4], dtype=torch.int32)
    dx = gm.grouped_matmul_dx_plain(torch.from_numpy(dy).to(T), torch.from_numpy(w).to(T),
                                    torch.from_numpy(be), block_rows, n_used)
    dw = gm.grouped_matmul_dw_plain(torch.from_numpy(x).to(T), torch.from_numpy(dy).to(T),
                                    torch.from_numpy(be), 4, block_rows, n_used)
    assert not dx[4 * block_rows:].any()
    tol = dict(atol=1e-5, rtol=1e-5) if dt == "fp32" else dict(atol=1e-6, rtol=2.0 ** -7)
    np.testing.assert_allclose(_np(dx), _np(jdx), **tol)
    if dt == "fp32":
        np.testing.assert_allclose(_np(dw), _np(jdw), **tol)
    else:
        assert np.abs(_np(dw) - _np(jdw)).max() <= 2.0 ** -6 * np.abs(_np(jdw)).max()


def test_dw_plain_sums_each_expert_in_ascending_block_order():
    """dW[e] is the fp32 sum of its blocks' products in ascending block
    order, bit for bit."""
    x, w, dy, be = _bwd_inputs(8, "fp32", (1, 0, 1, 1, 2, 1), seed=5)
    got = gm.grouped_matmul_dw_plain(torch.from_numpy(x), torch.from_numpy(dy),
                                     torch.from_numpy(be), 4, 8)
    xb, gb = torch.from_numpy(x).reshape(6, 8, -1), torch.from_numpy(dy).reshape(6, 8, -1)
    want = torch.zeros(w.shape)
    for b in range(6):  # ascending b: expert 1's blocks 0, 2, 3, 5 in that order
        want[int(be[b])] += xb[b].T @ gb[b]
    assert torch.equal(got, want)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_autograd_function_gives_the_plain_backward(dt):
    """grouped_matmul goes through GroupedMatmulFn when an input requires
    grad: its gradients are the plain G' and G'' (bit for bit on the CPU),
    block_expert and n_used get none, and nothing is counted as a launch."""
    x, w, dy, be = _bwd_inputs(16, dt, ORDERS["nonmonotone"], seed=7)
    T = TORCH[dt]
    tx = torch.from_numpy(x).to(T).requires_grad_(True)
    tw = torch.from_numpy(w).to(T).requires_grad_(True)
    tbe, n_used = torch.from_numpy(be), torch.tensor([5], dtype=torch.int32)
    before = (gm.grouped_matmul.launches, gm.grouped_matmul_dx.launches,
              gm.grouped_matmul_dw.launches)
    out = gm.grouped_matmul(tx, tw, tbe, 16, n_used)
    assert isinstance(out.grad_fn, gm.GroupedMatmulFn._backward_cls)
    assert torch.equal(out, gm.grouped_matmul_plain(tx.detach(), tw.detach(), tbe, 16, n_used))
    g = torch.from_numpy(dy).to(T)
    dx, dw = torch.autograd.grad(out, (tx, tw), g)
    assert torch.equal(dx, gm.grouped_matmul_dx_plain(g, tw.detach(), tbe, 16, n_used))
    assert torch.equal(dw, gm.grouped_matmul_dw_plain(tx.detach(), g, tbe, 4, 16, n_used))
    # block_expert and n_used: no edge in the graph
    assert [f for f, _ in out.grad_fn.next_functions][2:] == [None, None]
    assert (gm.grouped_matmul.launches, gm.grouped_matmul_dx.launches,
            gm.grouped_matmul_dw.launches) == before
    # no input requiring grad: no Function
    assert gm.grouped_matmul(tx.detach(), tw.detach(), tbe, 16).grad_fn is None


def test_backward_wrappers_check_shapes():
    x, w, dy, be = _bwd_inputs(16, "fp32", ORDERS["nonmonotone"])
    tx, tw, tdy, tbe = map(torch.from_numpy, (x, w, dy, be))
    with pytest.raises(ValueError, match="block_expert"):
        gm.grouped_matmul_dx(tdy, tw, tbe[:-1], 16)
    with pytest.raises(ValueError, match="whole blocks"):
        gm.grouped_matmul_dx(tdy[:-1], tw, tbe, 16)
    with pytest.raises(ValueError, match="x \\[P, H\\] and dy"):
        gm.grouped_matmul_dw(tx[:-16], tdy, tbe, 4, 16)
    with pytest.raises(ValueError, match="n_used"):
        gm.grouped_matmul_dw(tx, tdy, tbe, 4, 16, torch.tensor([2]))


# ---------------------------------------------------------------------------
# the MoE layer's gradients
# ---------------------------------------------------------------------------
def _layer_inputs(E, H, F, swiglu, seed=4):
    rng = np.random.RandomState(seed)
    ex = {"w_up": rng.randn(E, H, F) * 0.2, "w_down": rng.randn(E, F, H) * 0.2}
    if swiglu:
        ex["w_gate"] = rng.randn(E, H, F) * 0.2
    ex = {k: v.astype(np.float32) for k, v in ex.items()}
    gate_w = (rng.randn(H, E) * 0.5).astype(np.float32)
    x = rng.randn(2, 7, H).astype(np.float32)
    r = rng.randn(2, 7, H).astype(np.float32)  # the cotangent of the output
    return x, gate_w, ex, r


def _port_layer_grads(x, gate_w, ex, r, cfg, activation):
    tx = torch.from_numpy(x).requires_grad_(True)
    tg = torch.from_numpy(gate_w).requires_grad_(True)
    tex = {k: torch.from_numpy(v).requires_grad_(True) for k, v in ex.items()}
    out, aux = tm.moe_ffn(tx, tg, tex, cfg, activation=activation)
    loss = (out * torch.from_numpy(r)).sum() + aux
    grads = torch.autograd.grad(loss, [tx, tg, *tex.values()])
    return loss.detach(), dict(zip(["x", "gate_w", *tex], grads))


@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("drop", [False, True])
def test_moe_ffn_grads_match_jax(drop, top_k, activation, norm_topk):
    """d(sum(out * r) + aux) with respect to x, the router and every expert
    stack, dropless and capacity, fp32; two backward passes bit-equal."""
    E, H, F = 6, 16, 24
    x, gate_w, ex, r = _layer_inputs(E, H, F, activation == "swiglu")
    kw = dict(num_experts=E, top_k=top_k, norm_topk=norm_topk, drop_tokens=drop)
    jc, tc = jm.MoEConfig(**kw), tm.MoEConfig(**kw)

    def jloss(x_, g_, ex_):
        out, aux = jm.moe_ffn(x_, g_, ex_, jc, activation=activation)
        return jnp.sum(out * jnp.asarray(r)) + aux

    wl, (wx, wg, wex) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gate_w), {k: jnp.asarray(v) for k, v in ex.items()})
    loss, got = _port_layer_grads(x, gate_w, ex, r, tc, activation)
    assert abs(float(loss) - float(wl)) <= GRAD_TOL * max(1.0, abs(float(wl)))
    want = {"x": wx, "gate_w": wg, **wex}
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        assert np.abs(_np(got[k]) - w).max() <= GRAD_TOL * max(1.0, np.abs(w).max()), k
    _, again = _port_layer_grads(x, gate_w, ex, r, tc, activation)
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_dispatch_backward_sums_in_ascending_expert_order_without_index_put():
    """The dropless dispatch's backward (``_Dispatch``): each token's
    gradient is the fp32 sum of its k rows in ascending expert order, bit
    for bit and the same on two calls, with many ties in ``token_of`` (every
    token K = 4 times over 5 experts), and no accumulating ``index_put_`` /
    ``index_add_`` writes the token gradient: autograd's own backward of
    ``xt[token_of]`` would, which gives no fixed order of summation on a
    card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    T, H, E, K = 24, 8, 5, 4
    rng = np.random.RandomState(11)
    cfg = tm.MoEConfig(num_experts=E, top_k=K, drop_tokens=False)
    ex = {k: torch.from_numpy((rng.randn(E, *s) * 0.3).astype(np.float32))
          for k, s in (("w_gate", (H, 16)), ("w_up", (H, 16)), ("w_down", (16, H)))}
    gate_w = torch.from_numpy(rng.randn(H, E).astype(np.float32))
    x0 = torch.from_numpy(rng.randn(1, T, H).astype(np.float32))
    r = torch.from_numpy(rng.randn(1, T, H).astype(np.float32))

    class Accumulating(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.into_tokens = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            acc = (name.startswith("index_put") or name.startswith("_index_put_impl")) and (
                (len(args) > 3 and args[3]) or kwargs.get("accumulate", False))
            if (acc or name.startswith("index_add")) and tuple(args[0].shape) == (T, H):
                self.into_tokens += 1
            return func(*args, **(kwargs or {}))

    def grad_x():
        x = x0.clone().requires_grad_(True)
        out, _ = tm.moe_ffn_dropless(x, gate_w, ex, cfg, block_rows=8)
        mode = Accumulating()
        with mode:
            (g,) = torch.autograd.grad((out * r).sum(), x)
        return g, mode.into_tokens

    g1, n1 = grad_x()
    g2, n2 = grad_x()
    assert n1 == n2 == 0
    assert torch.equal(g1, g2)
    # the same sum taken by hand from the gradient _Dispatch receives: each
    # token's rows of the sorted buffer, in ascending expert order
    seen = {}
    orig = tm._Dispatch.backward

    def spy(ctx, g):
        seen["g"], seen["pos"] = g, ctx.saved_tensors[0]
        grads = orig(ctx, g)
        seen["dxt"] = grads[0]
        return grads

    tm._Dispatch.backward = staticmethod(spy)
    try:
        g3, _ = grad_x()
    finally:
        tm._Dispatch.backward = staticmethod(orig)
    g, pos = seen["g"], seen["pos"]
    assert tuple(pos.shape) == (T, K)
    want = g[pos[:, 0]]
    for k in range(1, K):
        want = want + g[pos[:, k]]
    assert torch.equal(seen["dxt"], want)
    assert torch.equal(g3, g1)


# ---------------------------------------------------------------------------
# Mixtral tiny: the loss and every leaf's gradient, and the engine
# ---------------------------------------------------------------------------
MOE_VARIANTS = {"plain": {}, "shared": dict(moe_shared_expert=48),
                "residual": dict(moe_use_residual=True)}


def _mixtral(**kw):
    return (jmixtral.mixtral_config("tiny", max_seq_len=64, **kw),
            tmixtral.mixtral_config("tiny", max_seq_len=64, **kw))


def _weights(jcfg, tcfg, seed=0):
    tree = jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        jcfg, jax.random.PRNGKey(seed)))
    return tree, jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(
        tree, tcfg, "cpu", torch.float32)


def _leaf_grads(tp):
    g = tp.map(lambda t: t)
    for (_, dst), (_, src) in zip(g.named_parameters(), tp.named_parameters()):
        dst.data = src.grad
    return dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(g)))


@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("variant", sorted(MOE_VARIANTS))
def test_mixtral_causal_lm_loss_and_grads_match_jax(variant, drop):
    """causal_lm_loss (the aux loss added) and d loss / d every leaf of
    Mixtral tiny, fp32, against jax.value_and_grad."""
    jcfg, tcfg = _mixtral(moe_drop_tokens=drop, **MOE_VARIANTS[variant])
    _, jp, tp = _weights(jcfg, tcfg)
    for p in tp.parameters():
        p.requires_grad_(True)
    ids = np.random.RandomState(5).randint(0, jcfg.vocab_size, (2, 17))
    wl, wg = jax.value_and_grad(lambda p: jt.causal_lm_loss(jcfg, p, jnp.asarray(ids)))(jp)
    loss = tt.causal_lm_loss(tcfg, tp, torch.from_numpy(ids))
    loss.backward()
    assert abs(float(loss.detach()) - float(wl)) <= GRAD_TOL * abs(float(wl))
    got = _leaf_grads(tp)
    flat = jax.tree_util.tree_leaves_with_path(wg)
    assert len(flat) == len(got)
    for path, w in flat:
        w = np.asarray(w, np.float32)
        err = np.abs(got[path] - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (jax.tree_util.keystr(path), err)


def test_mixtral_engine_matches_jax_for_three_steps():
    """initialize -> train_batch on Mixtral tiny, dropless, fp32, fused
    AdamW: three steps against the JAX engine from the same numpy weights
    (loss, grad norm, lr each step; the fp32 master at the end)."""
    ds = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1,
                                                    "fused_kernel": True}},
          "gradient_clipping": 1.0, "zero_optimization": {"stage": 1},
          "data_types": {"grad_accum_dtype": "fp32"}}
    jmodel = jmixtral.mixtral_model("tiny", max_seq_len=32, moe_drop_tokens=False)
    tmodel = tmixtral.mixtral_model("tiny", max_seq_len=32, moe_drop_tokens=False)
    tree = jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        jmodel.config, jax.random.PRNGKey(0)))
    je, *_ = deepspeed_tpu.initialize(model=jmodel, config=dict(ds),
                                      model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    te, *_ = deepspeed_tpu_torch.initialize(model=tmodel, config=dict(ds),
                                            model_parameters=tree, device="cpu")
    rng = np.random.RandomState(1)
    for _ in range(3):
        ids = rng.randint(0, jmodel.config.vocab_size, (1, 2, 17))
        lj = float(je.train_batch(jnp.asarray(ids, jnp.int32)))
        lt = float(te.train_batch(ids))
        assert abs(lt - lj) <= 1e-5 * abs(lj), (lt, lj)
        nj, nt = je.get_global_grad_norm(), te.get_global_grad_norm()
        assert abs(nt - nj) <= 1e-5 * nj, (nt, nj)
        assert te.get_lr() == pytest.approx(je.get_lr(), rel=1e-6)
    want = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), je.get_params()))
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(te.get_params())))
    assert len(got) == len(want)
    diffs = []
    for path, w in want:
        d = np.abs(got[path] - w)
        diffs.append(d.ravel())
        assert d.max() <= 5e-5, (jax.tree_util.keystr(path), d.max())
    assert np.concatenate(diffs).mean() <= 5e-6
