"""The port's model core vs the JAX package's, on the JAX package's own
initialised weights carried across as numpy (``params_from_numpy``).

Tolerances: fp32 1e-5 (same formulas, same rounding points; CPU matmul
summation order differs); bf16 2e-2 relative (bf16 matmuls round their
outputs, and XLA and PyTorch accumulate in different orders).

Training: the loss and the parameter gradients of ``causal_lm_loss``
against ``jax.grad``.  Each gradient leaf is held to its largest magnitude:
max |g_port - g_jax| <= tol * max |g_jax|, tol 1e-5 in fp32 (observed
2e-6) and 5e-2 in bf16 (observed 1.8e-2: every op rounds to bf16, at other
points in XLA's fusions than in PyTorch's kernels)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models import mixtral as tmixtral
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

TOL = {"fp32": 1e-5, "bf16": 2e-2}
JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}

CONFIGS = {
    "tiny": dict(size="tiny"),
    # narrow GQA: hidden 128, 4 layers, 8 heads over 2 kv heads, vocab 512
    "gqa": dict(size="tiny", hidden_size=128, n_layers=4, n_heads=8,
                n_kv_heads=2, intermediate_size=256, vocab_size=512),
}


CONFIGS["160m_2l"] = dict(size="160m", n_layers=2)  # the 160m width, cut to 2 layers


def _configs(name, **port_kw):
    kw = dict(CONFIGS[name])
    size = kw.pop("size")
    return (jllama.llama_config(size, max_seq_len=64, **kw),
            tllama.llama_config(size, max_seq_len=64, **kw, **port_kw))


def _weights(jcfg, tcfg, dt, seed=0):
    """JAX init -> numpy (fp32) -> (JAX tree in dt, port ParamTree in dt)."""
    tree = jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        jcfg, jax.random.PRNGKey(seed)))
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, JNP[dt]), tree)
    return tree, jp, params_from_numpy(tree, tcfg, "cpu", TORCH[dt])


def _layer(jp, i):
    return jax.tree_util.tree_map(lambda a: a[i], jp["layers"])


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


def _x(shape, dt, seed=1):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(a, JNP[dt]), torch.from_numpy(a).to(TORCH[dt])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(kind, dt):
    xj, xt = _x((2, 5, 32), dt)
    s = np.random.RandomState(2).rand(32).astype(np.float32) + 0.5
    b = np.random.RandomState(3).randn(32).astype(np.float32)
    want = jt._norm(xj, jnp.asarray(s, JNP[dt]), jnp.asarray(b, JNP[dt]), kind, 1e-5)
    got = tt._norm(xt, torch.from_numpy(s).to(TORCH[dt]),
                   torch.from_numpy(b).to(TORCH[dt]), kind, 1e-5)
    assert got.dtype == TORCH[dt]
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("pct", [1.0, 0.5])
def test_rope(pct, dt):
    xj, xt = _x((2, 7, 4, 32), dt)
    pos = np.array([[3, 4, 5, 6, 7, 8, 9], [100, 101, 102, 103, 104, 105, 106]])
    want = jt._rope(xj, 10000.0, jnp.asarray(pos), pct)
    got = tt._rope(xt, 10000.0, torch.from_numpy(pos), pct)
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ["tiny", "gqa"])
def test_attn_qkv(name, dt):
    jcfg, tcfg = _configs(name)
    _, jp, tp = _weights(jcfg, tcfg, dt)
    xj, xt = _x((2, 6, jcfg.hidden_size), dt)
    pos = np.tile(np.arange(6)[None] + 3, (2, 1))
    want = jt.attn_qkv(jcfg, _layer(jp, 1), xj, jnp.asarray(pos))
    got = tt.attn_qkv(tcfg, tp.layers[1], xt, torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ["tiny", "gqa"])
def test_mlp_block(name, dt):
    jcfg, tcfg = _configs(name)
    _, jp, tp = _weights(jcfg, tcfg, dt)
    xj, xt = _x((2, 6, jcfg.hidden_size), dt)
    want, _ = jt.mlp_block(jcfg, _layer(jp, 0), xj, training=False)
    got, aux = tt.mlp_block(tcfg, tp.layers[0], xt, training=False)
    assert aux is None  # a dense FFN has no aux loss (JAX returns 0)
    _close(got, want, dt)


@pytest.mark.parametrize("act", ["gelu", "gelu_exact", "relu"])
def test_mlp_block_dense_activations_with_bias(act):
    """Non-llama FFNs: layernorm + biased up/down projections."""
    kw = dict(vocab_size=64, hidden_size=32, n_layers=2, n_heads=4, max_seq_len=32,
              norm="layernorm", activation=act, position="learned", use_bias=True)
    jcfg = jt.TransformerConfig(**kw)
    tcfg = tt.TransformerConfig(**kw)
    tree, jp, tp = _weights(jcfg, tcfg, "fp32")
    # non-zero biases so the bias terms are exercised
    rng = np.random.RandomState(4)
    for name in ("b_up", "b_down"):
        tree["layers"]["mlp"][name] = rng.randn(*tree["layers"]["mlp"][name].shape
                                                ).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tcfg, "cpu")
    xj, xt = _x((1, 5, 32), "fp32")
    want, _ = jt.mlp_block(jcfg, _layer(jp, 1), xj, training=False)
    _close(tt.mlp_block(tcfg, tp.layers[1], xt)[0], want, "fp32")


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("tie", [False, True])
def test_logits_fn(tie, dt):
    jcfg, tcfg = _configs("gqa")
    jcfg = dataclasses.replace(jcfg, tie_embeddings=tie)
    tcfg = dataclasses.replace(tcfg, tie_embeddings=tie)
    _, jp, tp = _weights(jcfg, tcfg, dt)
    xj, xt = _x((2, 3, jcfg.hidden_size), dt)
    _close(tt.logits_fn(tcfg, tp, xt), jt.logits_fn(jcfg, jp, xj), dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True), (True, True)])
def test_xla_attention(causal, masked, dt):
    """The plain attention (kv already repeated), with an end-aligned
    causal mask over Sq < Sk, a [B, Sk] keep-mask and an additive bias."""
    qj, qt = _x((2, 5, 4, 16), dt, seed=5)
    kj, kt = _x((2, 7, 4, 16), dt, seed=6)
    vj, vt = _x((2, 7, 4, 16), dt, seed=7)
    bias = np.random.RandomState(8).randn(1, 4, 5, 7).astype(np.float32)
    keep = np.ones((2, 7), bool)
    keep[1, :3] = False
    mj, mt = (jnp.asarray(keep), torch.from_numpy(keep)) if masked else (None, None)
    want = jt.xla_attention(qj, kj, vj, causal, mj, bias=jnp.asarray(bias))
    got = tt.xla_attention(qt, kt, vt, causal, mt, bias=torch.from_numpy(bias))
    _close(got, want, dt)


def test_alibi_slopes_match():
    for n in (4, 8, 12, 32):
        np.testing.assert_array_equal(tt.alibi_slopes(n, device="cpu").numpy(),
                                      np.asarray(jt.alibi_slopes(n)))


def test_weight_bridge_round_trip_and_layout():
    jcfg, tcfg = _configs("gqa")
    tree, _, tp = _weights(jcfg, tcfg, "fp32")
    assert len(tp.layers) == jcfg.n_layers
    assert tuple(tp.layers[2].attn.wk.shape) == tree["layers"]["attn"]["wk"].shape[1:]
    back = params_to_numpy(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)


def test_init_shapes_match_jax_tree():
    """The port's own seeded init builds the JAX tree, leaf for leaf."""
    jcfg, tcfg = _configs("gqa")
    tree = jax.eval_shape(lambda k: jt.init_transformer_params(jcfg, k),
                          jax.random.PRNGKey(0))
    mine = params_to_numpy(tllama.llama_model(config=tcfg).init_params(
        torch.Generator().manual_seed(0), "cpu"))
    want = {jax.tree_util.keystr(p): leaf.shape
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    got = {jax.tree_util.keystr(p): leaf.shape
           for p, leaf in jax.tree_util.tree_leaves_with_path(mine)}
    assert got == want


def test_not_ported_model_features_raise():
    """Post-norm models, once refused, now build JAX's tree (an embedding
    norm, the segment table, no final norm) and match JAX's forward and
    loss on its weights within ``TOL``."""
    kw = dict(vocab_size=32, hidden_size=16, n_layers=2, n_heads=2, norm="layernorm",
              activation="gelu_exact", position="learned", causal=False, use_bias=True,
              tie_embeddings=True, post_norm=True, max_seq_len=16)
    jcfg, tcfg = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    mine = params_to_numpy(tt.init_transformer_params(tcfg, torch.Generator(), "cpu"))
    tree = jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        jcfg, jax.random.PRNGKey(0)))
    shapes = [{jax.tree_util.keystr(p): a.shape for p, a in
               jax.tree_util.tree_leaves_with_path(t)} for t in (mine, tree)]
    assert shapes[0] == shapes[1] and "final_norm" not in mine and "type" in mine["embed"]
    ids = np.random.RandomState(3).randint(0, 32, (2, 9)).astype(np.int32)
    tt_ids = (ids[::-1] % 2).copy()
    tp = params_from_numpy(tree, tcfg, "cpu")
    hj, _ = jt.transformer_forward(jcfg, tree, jnp.asarray(ids), None, jnp.asarray(tt_ids))
    ht, _ = tt.transformer_forward(tcfg, tp, torch.from_numpy(ids).long(), None,
                                   torch.from_numpy(tt_ids).long())
    _close(ht, hj, "fp32")
    _close(tt.causal_lm_loss(tcfg, tp, torch.from_numpy(ids).long()),
           jt.causal_lm_loss(jcfg, tree, jnp.asarray(ids)), "fp32")


@pytest.mark.parametrize("drop", [True, False])
def test_mixtral_trains_through_loss_and_initialize(drop):
    """MoE models train: causal_lm_loss and the model's loss_fn give a
    finite loss with a gradient for every leaf (the aux loss included),
    and initialize -> train_batch takes a step on the CPU."""
    model = tmixtral.mixtral_model("tiny", max_seq_len=32, moe_drop_tokens=drop)
    tp = model.init_params(torch.Generator().manual_seed(0), "cpu")
    for p in tp.parameters():
        p.requires_grad_(True)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 8)))
    loss = tt.causal_lm_loss(model.config, tp, ids)
    assert torch.equal(loss, model.loss_fn(tp, ids, None)) and torch.isfinite(loss)
    loss.backward()
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0) for p in tp.parameters())
    import deepspeed_tpu_torch

    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config={"train_micro_batch_size_per_gpu": 2,
                             "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}},
        device="cpu")
    first = float(engine.train_batch(ids[None]))
    assert np.isfinite(first) and int(engine.state.step) == 1


@pytest.mark.parametrize("bits", [8, 4])
def test_mm_sends_a_quantized_subtree_to_wq_matmul(bits):
    """The weight seam: a ``{"wq", "scale"}`` sub-tree goes through
    ``wq_matmul`` with the config's bits and group, a tensor through ``@``."""
    from deepspeed_tpu_torch.ops.wq_matmul import quantize_weight, wq_matmul_plain

    w = torch.from_numpy(np.random.RandomState(0).randn(96, 40).astype(np.float32))
    codes, scale = quantize_weight(w, bits, group=32)
    cfg = tt.TransformerConfig(vocab_size=32, hidden_size=96, n_layers=1, n_heads=2,
                               wq_bits=bits, wq_group=32)
    x = torch.from_numpy(np.random.RandomState(1).randn(3, 96).astype(np.float32))
    got = tt._mm(cfg, x, tt.ParamTree({"wq": codes, "scale": scale}))
    assert torch.equal(got, wq_matmul_plain(x, codes, scale, bits=bits, group=32))
    assert torch.equal(tt._mm(cfg, x, w), x @ w)


# ---------------------------------------------------------------------------
# training forward, loss and gradients
# ---------------------------------------------------------------------------
GRAD_TOL = {"fp32": 1e-5, "bf16": 5e-2}
LOSS_TOL = {"fp32": 1e-5, "bf16": 5e-3}


def _batch(vocab, kind, seed=0, B=2, S=17):
    """(jax batch, port batch) of one kind: raw ids, a dict with labels, a
    dict with a padding attention_mask."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S))
    if kind == "ids":
        return jnp.asarray(ids), torch.from_numpy(ids)
    out = {"input_ids": ids}
    if kind == "labels":
        out["labels"] = rng.randint(0, vocab, (B, S))
    if kind == "mask":
        mask = np.ones((B, S), np.int32)
        mask[1, 11:] = 0
        out["attention_mask"] = mask
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _grads_to_numpy(tp):
    """The .grad of every leaf of a ParamTree, in the JAX layout."""
    g = tp.map(lambda t: t)
    for (_, dst), (_, src) in zip(g.named_parameters(), tp.named_parameters()):
        dst.data = src.grad
    return params_to_numpy(g)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ["tiny", "160m_2l"])
def test_transformer_forward(name, dt):
    jcfg, tcfg = _configs(name)
    _, jp, tp = _weights(jcfg, tcfg, dt)
    ids = np.random.RandomState(3).randint(0, jcfg.vocab_size, (2, 12))
    want, _ = jt.transformer_forward(jcfg, jp, jnp.asarray(ids))
    got, aux = tt.transformer_forward(tcfg, tp, torch.from_numpy(ids))
    assert got.dtype == TORCH[dt] and float(aux) == 0.0
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("kind,chunk", [("ids", 0), ("labels", 0), ("mask", 0), ("ids", 8),
                                        ("mask", 4)])
def test_causal_lm_loss(kind, chunk, dt):
    """Labels, a padding mask and the tiled loss (loss_chunk divides S-1=16)."""
    jcfg, tcfg = _configs("gqa", loss_chunk=chunk)
    jcfg = dataclasses.replace(jcfg, loss_chunk=chunk)
    _, jp, tp = _weights(jcfg, tcfg, dt)
    jb, tb = _batch(jcfg.vocab_size, kind)
    want = float(jt.causal_lm_loss(jcfg, jp, jb))
    got = tt.causal_lm_loss(tcfg, tp, tb)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= LOSS_TOL[dt] * max(1.0, abs(want))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("impl,kind", [("xla", "mask"), ("flash", "labels")])
@pytest.mark.parametrize("name", ["tiny", "160m_2l"])
def test_param_grads_match_jax(name, impl, kind, dt):
    """d loss / d params for every leaf, through the plain attention with a
    padding mask and through the flash path (its CPU plain forward and
    backward) with labels."""
    jcfg, tcfg = _configs(name, attn_impl=impl)
    _, jp, tp = _weights(jcfg, tcfg, dt)
    for p in tp.parameters():
        p.requires_grad_(True)
    jb, tb = _batch(jcfg.vocab_size, kind, seed=5)
    want_loss, want = jax.value_and_grad(lambda p: jt.causal_lm_loss(jcfg, p, jb))(jp)
    loss = tt.causal_lm_loss(tcfg, tp, tb)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_TOL[dt] * abs(float(want_loss))
    got = dict(jax.tree_util.tree_leaves_with_path(_grads_to_numpy(tp)))
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(got)
    for path, w in flat:
        w = np.asarray(w, np.float32)
        err = np.abs(got[path] - w).max()
        assert err <= GRAD_TOL[dt] * np.abs(w).max(), (jax.tree_util.keystr(path), err)


def test_flops_per_token_and_param_count_match_jax():
    for name in ("tiny", "gqa", "160m_2l"):
        jcfg, tcfg = _configs(name)
        assert tt.param_count(tcfg) == jt.param_count(jcfg)
        assert tt.flops_per_token(tcfg, 1024) == jt.flops_per_token(jcfg, 1024)
    jm, tm = jllama.llama_model("1b", max_seq_len=1024), tllama.llama_model("1b", max_seq_len=1024)
    assert tm.flops_per_sample == jm.flops_per_sample


def test_llama_model_spec_wires_loss_and_apply():
    jcfg, tcfg = _configs("tiny")
    tree, jp, tp = _weights(jcfg, tcfg, "fp32")
    jm, tm = jllama.llama_model(config=jcfg), tllama.llama_model(config=tcfg)
    ids = np.random.RandomState(4).randint(0, jcfg.vocab_size, (2, 9))
    np.testing.assert_allclose(float(tm.loss_fn(tp, torch.from_numpy(ids), None)),
                               float(jm.loss_fn(jp, jnp.asarray(ids), None)), rtol=1e-5)
    _close(tm.apply_fn(tp, {"input_ids": torch.from_numpy(ids)}),
           jm.apply_fn(jp, {"input_ids": jnp.asarray(ids)}), "fp32")


def test_pick_attn_and_training_options():
    cfg = tllama.llama_config("tiny")
    assert tt._pick_attn(cfg, torch.device("cpu")) is tt.xla_attention  # auto: plain on CPU
    assert tt._pick_attn(cfg, torch.device("cuda")).handles_gqa  # auto: flash on a card
    for impl in ("ulysses", "ring", "fpdt"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tt._pick_attn(dataclasses.replace(cfg, attn_impl=impl), torch.device("cpu"))
    tp = tllama.llama_model(config=cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    ids = torch.zeros((1, 4), dtype=torch.long)
    # remat runs, and changes no number
    for a, b in zip(tt.transformer_forward(dataclasses.replace(cfg, remat=True), tp, ids),
                    tt.transformer_forward(cfg, tp, ids)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dropout"):
        tt.transformer_forward(dataclasses.replace(cfg, dropout=0.1), tp, ids)


def test_param_tree_trainable_leaves_and_frozen_default():
    jcfg, tcfg = _configs("tiny")
    tree, _, frozen = _weights(jcfg, tcfg, "fp32")
    assert not any(p.requires_grad for p in frozen.parameters())  # serving stays frozen
    trainable = frozen.map(lambda t: t.to(torch.bfloat16), requires_grad=True)
    assert all(p.requires_grad and p.dtype == torch.bfloat16 for p in trainable.parameters())
    assert [n for n, _ in trainable.named_parameters()] == [n for n, _ in frozen.named_parameters()]


# ---------------------------------------------------------------------------
# mixtral (MoE) models
# ---------------------------------------------------------------------------
MOE_VARIANTS = {"plain": {}, "residual_shared": dict(moe_use_residual=True,
                                                     moe_shared_expert=48)}


def _mixtral(size="tiny", **kw):
    return (jmixtral.mixtral_config(size, max_seq_len=64, **kw),
            tmixtral.mixtral_config(size, max_seq_len=64, **kw))


@pytest.mark.parametrize("variant", sorted(MOE_VARIANTS))
def test_mixtral_init_tree_matches_jax(variant):
    """The port's seeded init builds JAX's tree, name for name and shape for
    shape, and the bridge carries the [L, E, H, F] expert leaves across as
    per-layer [E, H, F] and back."""
    jcfg, tcfg = _mixtral(**MOE_VARIANTS[variant])
    tree = jax.eval_shape(lambda k: jt.init_transformer_params(jcfg, k),
                          jax.random.PRNGKey(0))
    mine = params_to_numpy(tmixtral.mixtral_model(config=tcfg).init_params(
        torch.Generator().manual_seed(0), "cpu"))
    want = {jax.tree_util.keystr(p): leaf.shape
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    got = {jax.tree_util.keystr(p): leaf.shape
           for p, leaf in jax.tree_util.tree_leaves_with_path(mine)}
    assert got == want
    assert want["['layers']['mlp']['w_down']"] == (2, 4, 128, 64)
    full, _, tp = _weights(jcfg, tcfg, "fp32")
    assert tuple(tp.layers[1].mlp.w_gate.shape) == (4, 64, 128)
    back = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(tp)))
    for path, a in jax.tree_util.tree_leaves_with_path(full):
        np.testing.assert_array_equal(back[path], a)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("variant", sorted(MOE_VARIANTS))
def test_mixtral_forward_and_logits_match_jax(variant, drop, dt):
    """transformer_forward (training-style blocks: capacity from
    moe_capacity_factor) hidden states and summed aux, and apply_fn's
    logits."""
    jcfg, tcfg = _mixtral(moe_drop_tokens=drop, **MOE_VARIANTS[variant])
    tree, jp, tp = _weights(jcfg, tcfg, dt)
    if dt == "bf16":
        # routing parity is held in fp32: in bf16 a near-tied top-k choice
        # (or the capacity drop that follows it) can flip between XLA's
        # and PyTorch's rounding of the router matmul, so here the router is
        # scaled until no choice of this input is within bf16 rounding of a tie
        tree["layers"]["mlp"]["router"] = tree["layers"]["mlp"]["router"] * 50.0
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, JNP[dt]), tree)
        tp = params_from_numpy(tree, tcfg, "cpu", TORCH[dt])
    ids = np.random.RandomState(3).randint(0, jcfg.vocab_size, (2, 12))
    want, waux = jt.transformer_forward(jcfg, jp, jnp.asarray(ids))
    got, gaux = tt.transformer_forward(tcfg, tp, torch.from_numpy(ids))
    assert got.dtype == TORCH[dt] and gaux.dtype == torch.float32
    _close(got, want, dt)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=TOL[dt])
    jm = jmixtral.mixtral_model(config=jcfg)
    tm = tmixtral.mixtral_model(config=tcfg)
    _close(tm.apply_fn(tp, {"input_ids": torch.from_numpy(ids)}),
           jm.apply_fn(jp, {"input_ids": jnp.asarray(ids)}), dt)


def test_mixtral_param_count_and_flops_match_jax():
    for size in ("tiny", "8x160m", "8x7b"):
        for kw in ({}, dict(moe_use_residual=True), dict(moe_shared_expert=512),
                   dict(n_layers=16)):
            jcfg, tcfg = _mixtral(size, **kw)
            assert tt.param_count(tcfg) == jt.param_count(jcfg)
            assert tt.flops_per_token(tcfg, 1024) == jt.flops_per_token(jcfg, 1024)
    jm = jmixtral.mixtral_model("8x7b", max_seq_len=1024)
    tm = tmixtral.mixtral_model("8x7b", max_seq_len=1024)
    assert tm.flops_per_sample == jm.flops_per_sample
    # the 16-layer Mixtral-8x7b of the card's serving run: 23.48B parameters
    assert tt.param_count(_mixtral("8x7b", n_layers=16)[1]) == 23_482_335_232
