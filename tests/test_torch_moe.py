"""The port's MoE layer (``moe/sharded_moe.py`` and the MoE branch of the
model's FFN) vs the JAX package's, on the same numpy inputs on the CPU.

Routing (expert indices, the sort, the padded destinations, the block ->
expert map, the capacity dispatch mask) must be equal exactly; gate
probabilities, combine weights and aux losses within 1e-6 (fp32 softmax
of the same logits).  Layer outputs: fp32 1e-5 (summation order only);
bf16 2e-2 relative to the output's scale (bf16 matmuls round their
outputs, XLA and PyTorch accumulate in other orders).  Routing parity is
held in fp32: in bf16 a near-tied top-k choice can flip between two
frameworks that round the router matmul differently."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.moe import sharded_moe as jm
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.moe import sharded_moe as tm

torch.set_num_threads(2)

JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}
OUT_TOL = {"fp32": 1e-5, "bf16": 2e-2}


def _logits(T=12, E=6, seed=0, ties=False):
    z = np.random.RandomState(seed).randn(T, E).astype(np.float32)
    if ties:  # exact ties in the top two places of some rows
        z[::3, 1] = z[::3, 4] = z[::3].max(axis=1) + 1.0
    return z


def _cfgs(**kw):
    return jm.MoEConfig(**kw), tm.MoEConfig(**kw)


def _np(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 0.1])
@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_gate_and_aux(top_k, norm_topk, z_loss, ties):
    z = _logits(ties=ties)
    jc, tc = _cfgs(num_experts=6, top_k=top_k, norm_topk=norm_topk, z_loss_coef=z_loss)
    want = jm._gate_and_aux(jnp.asarray(z), jc)
    got = tm._gate_and_aux(torch.from_numpy(z), tc)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in ((got[0], want[0]), (got[2], want[2]), (got[3], want[3])):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("capacity", [2, 3, 8])
@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_top_k_gating_capacity_and_drops(top_k, norm_topk, capacity):
    z = _logits(T=16)
    jc, tc = _cfgs(num_experts=6, top_k=top_k, norm_topk=norm_topk)
    wc, wd, wa = jm.top_k_gating(jnp.asarray(z), jc, capacity)
    gc, gd, ga = tm.top_k_gating(torch.from_numpy(z), tc, capacity)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(ga), float(wa), rtol=1e-6)
    if capacity == 2:
        assert gd.sum() < 16 * top_k  # some assignments were dropped


@pytest.mark.parametrize("block_rows", [4, 8])
@pytest.mark.parametrize("invalid", [False, True])
def test_sort_pad_by_expert_bit_equal(invalid, block_rows):
    E = 5
    key = np.random.RandomState(3).randint(0, E, 37)
    key[[2, 9]] = 0  # a crowded expert
    if invalid:
        key[[0, 5, 11]] = E  # rows that must sort last and drop
        key[7] = E + 3
    want = jm.sort_pad_by_expert(jnp.asarray(key, jnp.int32), E, block_rows)
    got = tm.sort_pad_by_expert(torch.from_numpy(key), E, block_rows)
    assert got[2] == want[2]
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].dtype == torch.int32
    if invalid:
        assert (got[1] == got[2]).sum() == 4


def _experts(E, H, F, swiglu, dt, seed=4):
    rng = np.random.RandomState(seed)
    ex = {"w_up": rng.randn(E, H, F) * 0.2, "w_down": rng.randn(E, F, H) * 0.2}
    if swiglu:
        ex["w_gate"] = rng.randn(E, H, F) * 0.2
    ex = {k: v.astype(np.float32) for k, v in ex.items()}
    gate_w = (rng.randn(H, E) * 0.5).astype(np.float32)
    return ({k: jnp.asarray(v, JNP[dt]) for k, v in ex.items()}, jnp.asarray(gate_w, JNP[dt]),
            {k: torch.from_numpy(v).to(TORCH[dt]) for k, v in ex.items()},
            torch.from_numpy(gate_w).to(TORCH[dt]))


def _close_scaled(got, want, dt):
    want = np.asarray(want, np.float32)
    err = np.abs(_np(got) - want).max()
    assert err <= OUT_TOL[dt] * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_moe_ffn_dropless_matches_jax(top_k, norm_topk, activation, dt):
    E, H, F = 6, 16, 24
    jex, jgw, tex, tgw = _experts(E, H, F, activation == "swiglu", dt)
    x = np.random.RandomState(5).randn(2, 7, H).astype(np.float32)
    jc, tc = _cfgs(num_experts=E, top_k=top_k, norm_topk=norm_topk, drop_tokens=False)
    want, waux = jm.moe_ffn(jnp.asarray(x, JNP[dt]), jgw, jex, jc, activation=activation)
    got, gaux = tm.moe_ffn(torch.from_numpy(x).to(TORCH[dt]), tgw, tex, tc,
                           activation=activation)
    assert got.dtype == TORCH[dt]
    _close_scaled(got, want, dt)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5 if dt == "fp32" else 2e-2)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_moe_ffn_capacity_matches_jax(top_k, activation, dt, training):
    """The capacity path, priced with capacity_factor (training) or
    eval_capacity_factor: 14 tokens over 6 experts drop some assignments."""
    E, H, F = 6, 16, 24
    jex, jgw, tex, tgw = _experts(E, H, F, activation == "swiglu", dt, seed=6)
    x = np.random.RandomState(7).randn(2, 7, H).astype(np.float32)
    jc, tc = _cfgs(num_experts=E, top_k=top_k, capacity_factor=0.8, min_capacity=2)
    want, waux = jm.moe_ffn(jnp.asarray(x, JNP[dt]), jgw, jex, jc, activation=activation,
                            training=training)
    got, gaux = tm.moe_ffn(torch.from_numpy(x).to(TORCH[dt]), tgw, tex, tc,
                           activation=activation, training=training)
    _close_scaled(got, want, dt)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5 if dt == "fp32" else 2e-2)


def test_dropless_combine_sums_in_ascending_expert_order():
    """bf16, top-4: each token's four gated expert outputs are added to 0 in
    ascending expert order, rounding to bf16 after each add, on any device."""
    E, H, F = 6, 16, 24
    _, _, tex, tgw = _experts(E, H, F, True, "bf16", seed=8)
    x = torch.from_numpy(np.random.RandomState(9).randn(1, 9, H).astype(np.float32)).bfloat16()
    cfg = tm.MoEConfig(num_experts=E, top_k=4, drop_tokens=False)
    got, _ = tm.moe_ffn_dropless(x, tgw, tex, cfg)
    xt = x.reshape(9, H)
    _, idx, gate_k, _ = tm._gate_and_aux(xt @ tgw, cfg)
    want = torch.zeros((9, H), dtype=torch.bfloat16)
    for t in range(9):
        for k in torch.argsort(idx[t]).tolist():
            e = int(idx[t, k])
            xe = xt[t:t + 1].float()
            h = (torch.nn.functional.silu((xe @ tex["w_gate"][e].float()).bfloat16())
                 * (xe @ tex["w_up"][e].float()).bfloat16())
            y = (h.float() @ tex["w_down"][e].float()).bfloat16()
            want[t] = want[t] + (y[0] * gate_k[t, k].bfloat16())
    assert torch.equal(got.reshape(9, H), want)


def test_noisy_gating_needs_a_generator_and_draws_from_it():
    z = torch.from_numpy(_logits())
    for policy in ("Jitter", "RSample"):
        cfg = tm.MoEConfig(num_experts=6, noisy_gate_policy=policy)
        with pytest.raises(ValueError, match="Generator"):
            tm._gate_and_aux(z, cfg)
        a = tm._gate_and_aux(z, cfg, torch.Generator().manual_seed(1))[0]
        b = tm._gate_and_aux(z, cfg, torch.Generator().manual_seed(1))[0]
        clean = tm._gate_and_aux(z, tm.MoEConfig(num_experts=6))[0]
        assert torch.equal(a, b) and not torch.equal(a, clean)
    with pytest.raises(ValueError, match="noisy_gate_policy"):
        tm._gate_and_aux(z, tm.MoEConfig(num_experts=6, noisy_gate_policy="Gumbel"))


def test_expert_parallel_dispatch_raises_naming_its_item():
    cfg = tm.MoEConfig()
    assert tm.ep_dispatch_active(cfg) is False
    with pytest.raises(NotImplementedError, match="Queue 1 #8/#9"):
        tm.ep_dispatch_active(cfg, expert_parallel_size=2)
    with pytest.raises(ValueError, match="ep_dispatch"):
        tm.moe_ffn(torch.zeros((1, 2, 4)), torch.zeros((4, 8)), {}, tm.MoEConfig(
            ep_dispatch="shard_map"))


def test_compute_capacity_matches_jax():
    for tokens in (1, 14, 1024):
        for training in (True, False):
            jc, tc = _cfgs(num_experts=8, top_k=2)
            assert tm.compute_capacity(tokens, tc, training) == \
                jm.compute_capacity(tokens, jc, training)


# -- the MoE branch of the model's FFN: shared expert and PR-MoE residual ----
LAYER = dict(vocab_size=64, hidden_size=32, n_layers=2, n_heads=4, intermediate_size=48,
             max_seq_len=32, moe_experts=4)
VARIANTS = {
    "plain": {},
    "shared_expert": dict(moe_shared_expert=40, moe_norm_topk=False, moe_top_k=4),
    "residual": dict(moe_use_residual=True),
    "residual_gelu": dict(moe_use_residual=True, activation="gelu"),
    "shared_and_residual": dict(moe_shared_expert=24, moe_use_residual=True),
}


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mlp_block_moe_matches_jax(variant, drop, training):
    kw = dict(LAYER, moe_drop_tokens=drop, **VARIANTS[variant])
    jcfg, tcfg = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    tree = jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    for name in ("coef", "shared_gate"):  # non-zero mixers, so both branches count
        if name in tree["layers"]["mlp"]:
            tree["layers"]["mlp"][name] = rng.randn(*tree["layers"]["mlp"][name].shape
                                                    ).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tcfg, "cpu")
    x = rng.randn(2, 5, 32).astype(np.float32)
    want, waux = jt.mlp_block(jcfg, jax.tree_util.tree_map(lambda a: a[1], jp["layers"]),
                              jnp.asarray(x), training=training)
    got, gaux = tt.mlp_block(tcfg, tp.layers[1], torch.from_numpy(x), training=training)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5)


def test_serving_prices_capacity_with_the_eval_factor():
    """mlp_block(training=False) routes with eval_capacity_factor (1.0):
    with capacity_factor 4 the training call keeps every assignment, the
    serving call of the same layer drops some."""
    kw = dict(LAYER, moe_capacity_factor=4.0)
    cfg = tt.TransformerConfig(**kw)
    tp = tt.init_transformer_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn((1, 16, 32), generator=torch.Generator().manual_seed(1))
    full = dataclasses.replace(cfg, moe_drop_tokens=False)
    want = tt.mlp_block(full, tp.layers[0], x, training=False)[0]
    assert torch.allclose(tt.mlp_block(cfg, tp.layers[0], x, training=True)[0], want,
                          atol=1e-6)
    assert not torch.allclose(tt.mlp_block(cfg, tp.layers[0], x, training=False)[0], want,
                              atol=1e-6)
