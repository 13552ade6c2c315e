"""The port's compression (``deepspeed_tpu_torch/compression``) against the
JAX package's: the compression tests of ``tests/unit/test_aux2.py``
mirrored, and the same numpy weights through both packages.

Tolerances, and why: the transforms (fake quantization, magnitude and
structured masks), the keep indices and the shrunk arrays are bit-equal
in fp32 (the same per-element operations on the same values; the scale
is one division, the threshold one element of the input); the losses of
the shrunk models against the masked ones rtol 1e-5 (the JAX test's:
zero terms dropped from fp32 sums), and port against JAX rtol 1e-5 (the
same formulas summed in another order); ``distillation_loss`` and its
gradient rtol 1e-6 (one softmax over the vocabulary, fp32), the gradient's
relative to its largest element: each element is a difference of two
softmax probabilities, which cancel, so its own relative error is
unbounded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.compression import compress as J
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.compression import compress as T
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

LLAMA_ALL = {"compression_training": {
    "weight_quantization": {"shared_parameters": {"enabled": True, "bits": 8}},
    "sparse_pruning": {"shared_parameters": {"enabled": True, "ratio": 0.5}},
    "head_pruning": {"shared_parameters": {"enabled": True, "dense_ratio": 0.5}},
    "channel_pruning": {"shared_parameters": {"enabled": True, "dense_ratio": 0.75}}}}
STRUCTURED = {"compression_training": {
    "head_pruning": {"shared_parameters": {"enabled": True, "dense_ratio": 0.5}},
    "channel_pruning": {"shared_parameters": {"enabled": True, "dense_ratio": 0.5}}}}


def _trees(seed=0, **overrides):
    """(JAX config, JAX params, port config, port params) from one draw."""
    jcfg = jllama.llama_config("tiny", max_seq_len=16, **overrides)
    jp = jt.init_transformer_params(jcfg, jax.random.PRNGKey(seed))
    tcfg = tllama.llama_config("tiny", max_seq_len=16, **overrides)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _assert_trees_equal(jtree, ttree):
    """Every leaf of the JAX tree bit-equal (and equal in shape) to the
    port's, through the port's JAX-layout export."""
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(ttree)))
    want = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jtree))
    assert len(got) == len(want)
    for path, w in want:
        g = got[path]
        assert g.shape == w.shape and np.array_equal(g, w), jax.tree_util.keystr(path)


def _ids(vocab=256, shape=(2, 16), seed=0):
    return np.random.RandomState(seed).randint(0, vocab, shape)


def _losses(jcfg, jp, tcfg, tp, ids):
    lj = float(jt.causal_lm_loss(jcfg, jp, {"input_ids": jnp.asarray(ids, jnp.int32)}, None))
    with torch.no_grad():
        lt = float(tt.causal_lm_loss(tcfg, tp, torch.as_tensor(ids)))
    return lj, lt


# --- test_aux2.py's tests, mirrored -----------------------------------------
def test_fake_quantize_ste_gradient():
    w = torch.linspace(-1, 1, 64, requires_grad=True)
    (T.fake_quantize(w, 4) ** 2).sum().backward()
    assert torch.isfinite(w.grad).all()
    q = T.fake_quantize(w.detach(), 4)
    assert len(np.unique(q.numpy().round(6))) <= 16
    # the straight-through estimator: d sum(fq(w)^2) / dw = 2 fq(w), as JAX's
    gj = jax.grad(lambda x: jnp.sum(J.fake_quantize(x, 4) ** 2))(jnp.linspace(-1, 1, 64))
    np.testing.assert_array_equal(w.grad.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(q.numpy(), np.asarray(J.fake_quantize(jnp.linspace(-1, 1, 64),
                                                                        4)))


def test_prune_and_scheduler():
    w = np.random.RandomState(0).randn(32, 32).astype(np.float32)
    params = {"layer": {"w": torch.from_numpy(w.copy()), "b": torch.zeros(32)}}
    cfg = {"compression_training": {
        "sparse_pruning": {"shared_parameters": {"enabled": True, "ratio": 0.5,
                                                 "schedule_offset": 0}}}}
    out, sched = T.init_compression(params, cfg)
    assert (out["layer"]["w"] == 0).float().mean().item() == pytest.approx(0.5, abs=0.05)
    jout, _ = J.init_compression({"layer": {"w": jnp.asarray(w), "b": jnp.zeros(32)}}, cfg)
    np.testing.assert_array_equal(out["layer"]["w"].numpy(), np.asarray(jout["layer"]["w"]))
    assert torch.equal(params["layer"]["w"], torch.from_numpy(w))  # the input untouched
    # before the offset nothing happens
    sched2 = T.CompressionScheduler({"sparse_pruning": {
        "shared_parameters": {"enabled": True, "ratio": 0.5, "schedule_offset": 100}}})
    out2 = sched2.transform_params(params, global_step=0)
    assert (out2["layer"]["w"] == 0).float().mean().item() < 0.1


def test_structured_pruning_and_physical_clean():
    """Head and channel pruning mask whole structures, and redundancy_clean
    slices them out: the shrunk model's loss equals the masked model's, in
    both packages, and the two packages agree."""
    jcfg, jp, tcfg, tp = _trees()
    masked, sched = T.init_compression(tp, STRUCTURED, n_heads=tcfg.n_heads)
    up = torch.stack([lay.mlp.w_up for lay in masked.layers])
    assert ((up == 0).all(dim=1).sum(-1) == tcfg.ffn_size // 2).all()
    ids = _ids()
    shrunk, new_cfg = T.redundancy_clean(tp, sched, tcfg)
    assert new_cfg.ffn_size == tcfg.ffn_size // 2 and new_cfg.n_heads == tcfg.n_heads // 2
    assert shrunk.layers[0].mlp.w_up.shape[-1] == tcfg.ffn_size // 2
    assert shrunk.layers[0].attn.wo.shape[0] == (tcfg.n_heads // 2) * tcfg.head_dim
    with torch.no_grad():
        lm = float(tt.causal_lm_loss(tcfg, masked, torch.as_tensor(ids)))
        ls = float(tt.causal_lm_loss(new_cfg, shrunk, torch.as_tensor(ids)))
    np.testing.assert_allclose(ls, lm, rtol=1e-5)
    jm, jsched = J.init_compression(jp, STRUCTURED, n_heads=jcfg.n_heads)
    jshrunk, jnew = J.redundancy_clean(jp, jsched, jcfg)
    _assert_trees_equal(jm, masked)
    _assert_trees_equal(jshrunk, shrunk)
    for f in ("n_heads", "n_kv_heads", "intermediate_size", "head_dim_override"):
        assert getattr(new_cfg, f) == getattr(jnew, f), f
    lj, lt = _losses(jnew, jshrunk, new_cfg, shrunk, ids)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)


def test_structured_pruning_respects_per_method_offsets():
    """head offset 0, channel offset 1000: at step 0 only heads prune."""
    _, _, tcfg, tp = _trees()
    comp = {"compression_training": {
        "head_pruning": {"shared_parameters": {"enabled": True, "dense_ratio": 0.5,
                                               "schedule_offset": 0}},
        "channel_pruning": {"shared_parameters": {"enabled": True, "dense_ratio": 0.5,
                                                  "schedule_offset": 1000}}}}
    masked, sched = T.init_compression(tp, comp, n_heads=tcfg.n_heads)
    up = torch.stack([lay.mlp.w_up for lay in masked.layers])
    assert not (up == 0).all(dim=1).any(), "channels pruned early"
    wo = torch.stack([lay.attn.wo for lay in masked.layers])
    assert (wo == 0).all(dim=2).any(), "heads not pruned at offset 0"
    masked2 = sched.transform_params(tp, 1000, n_heads=tcfg.n_heads)
    up2 = torch.stack([lay.mlp.w_up for lay in masked2.layers])
    assert (up2 == 0).all(dim=1).any()


def test_structured_pruning_non_transformer_degrades_gracefully():
    params = {"w1": torch.ones(8, 8), "w2": torch.ones(8, 4)}
    comp = {"compression_training": {"head_pruning": {"shared_parameters": {"enabled": True}}}}
    out, sched = T.init_compression(params, comp, n_heads=4)
    assert not sched.head_prune.enabled
    assert torch.equal(out["w1"], torch.ones(8, 8))


def test_layer_reduction_student_init():
    _, teacher_j, _, teacher = _trees(n_layers=4)
    _, _, _, student = _trees(seed=1, n_layers=2)
    config = {"compression_training": {"layer_reduction": {
        "enabled": True, "keep_number_layer": 2, "teacher_layer": [1, 3]}}}
    out, _ = T.init_compression(student, config, teacher_params=teacher)
    for i, t in enumerate((1, 3)):
        for a, b in zip(out.layers[i].parameters(), teacher.layers[t].parameters()):
            assert torch.equal(a, b)
    assert torch.equal(out.embed.tok, teacher.embed.tok)
    jout, _ = J.init_compression(jax.tree_util.tree_map(jnp.asarray, params_to_numpy(student)),
                                 config, teacher_params=teacher_j)
    _assert_trees_equal(jout, out)
    bad = {"compression_training": {"layer_reduction": {
        "enabled": True, "keep_number_layer": 2, "teacher_layer": [1, 9]}}}
    with pytest.raises(ValueError, match="out of range"):
        T.init_compression(student, bad, teacher_params=teacher)
    _, _, _, s3 = _trees(seed=2, n_layers=3)
    with pytest.raises(ValueError, match="shape mismatch"):
        T.init_compression(s3, config, teacher_params=teacher)


def test_layer_reduction_student_beats_random_init():
    """A 2-layer student initialised from a trained 4-layer teacher (trained
    with the port's engine) starts at a lower loss than a random 2-layer
    student, and the KD loss is differentiable with vanishing gradients at
    logit equality."""
    teacher_model = tllama.llama_model("tiny", max_seq_len=32, n_layers=4)
    config = {"train_micro_batch_size_per_gpu": 8,
              "optimizer": {"type": "Adam", "params": {"lr": 5e-3}}, "bf16": {"enabled": True}}
    engine, *_ = deepspeed_tpu_torch.initialize(model=teacher_model, config=config,
                                                device="cpu", seed=0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 8, 32)))
    for _ in range(25):
        engine.train_batch(ids)
    teacher = engine.get_params()
    student_model = tllama.llama_model("tiny", max_seq_len=32, n_layers=2)
    random_student = student_model.init_params(torch.Generator().manual_seed(7), "cpu")
    kd_cfg = {"compression_training": {"layer_reduction": {
        "enabled": True, "keep_number_layer": 2, "teacher_layer": [0, 3]}}}
    distilled, _ = T.init_compression(random_student, kd_cfg, teacher_params=teacher)
    with torch.no_grad():
        l_rand = float(student_model.loss_fn(random_student, ids[0], None))
        l_dist = float(student_model.loss_fn(distilled, ids[0], None))
    assert l_dist < l_rand, (l_dist, l_rand)
    r = np.random.RandomState(3)
    t_logits = torch.from_numpy(r.randn(8, 32, 256).astype(np.float32))
    s_logits = torch.from_numpy(r.randn(8, 32, 256).astype(np.float32))
    kd = T.distillation_loss(s_logits, t_logits, temperature=2.0)
    assert torch.isfinite(kd) and float(kd) > 0
    s = t_logits.clone().requires_grad_(True)
    T.distillation_loss(s, t_logits).backward()
    assert float(s.grad.abs().max()) < 1e-3


# --- parity with the JAX package -------------------------------------------
@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
def test_init_compression_and_keeps_are_bit_equal(kv_heads):
    jcfg, jp, tcfg, tp = _trees(n_kv_heads=kv_heads)
    before = params_to_numpy(tp)
    jo, js = J.init_compression(jp, LLAMA_ALL, n_heads=jcfg.n_heads)
    to, ts = T.init_compression(tp, LLAMA_ALL, n_heads=tcfg.n_heads)
    _assert_trees_equal(jo, to)
    np.testing.assert_array_equal(ts._chan_keep.numpy(), np.asarray(js._chan_keep))
    np.testing.assert_array_equal(ts._head_keep.numpy(), np.asarray(js._head_keep))
    # the caller's tree is untouched, and a second step reuses the masks
    after = params_to_numpy(tp)
    for k in ("embed", "lm_head"):
        for kk in before[k]:
            np.testing.assert_array_equal(before[k][kk], after[k][kk])
    masks = ts._masks
    _assert_trees_equal(js.transform_params(jp, 5, n_heads=jcfg.n_heads),
                        ts.transform_params(tp, 5, n_heads=tcfg.n_heads))
    assert ts._masks is masks


@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
def test_redundancy_clean_matches_jax(kv_heads, caplog):
    jcfg, jp, tcfg, tp = _trees(n_kv_heads=kv_heads)
    _, js = J.init_compression(jp, LLAMA_ALL, n_heads=jcfg.n_heads)
    _, ts = T.init_compression(tp, LLAMA_ALL, n_heads=tcfg.n_heads)
    from deepspeed_tpu_torch.utils import logging as tlogging

    tlogging.logger.addHandler(caplog.handler)
    try:
        tshrunk, tnew = T.redundancy_clean(tp, ts, tcfg)
    finally:
        tlogging.logger.removeHandler(caplog.handler)
    jshrunk, jnew = J.redundancy_clean(jp, js, jcfg)
    _assert_trees_equal(jshrunk, tshrunk)
    for f in ("n_heads", "n_kv_heads", "intermediate_size", "head_dim_override"):
        assert getattr(tnew, f) == getattr(jnew, f), f
    gqa_warned = any("keeping masked heads" in r.getMessage() for r in caplog.records)
    assert gqa_warned == (kv_heads is not None)
    assert tnew.n_heads == (tcfg.n_heads if kv_heads else tcfg.n_heads // 2)
    lj, lt = _losses(jnew, jshrunk, tnew, tshrunk, _ids(seed=1))
    np.testing.assert_allclose(lt, lj, rtol=1e-5)


def test_distillation_loss_and_gradient_match_jax():
    r = np.random.RandomState(5)
    s, t = (r.randn(4, 8, 256).astype(np.float32) for _ in range(2))
    lj, gj = jax.value_and_grad(lambda x: J.distillation_loss(x, jnp.asarray(t), 2.0))(
        jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_(True)
    lt = T.distillation_loss(st, torch.from_numpy(t), 2.0)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    gj = np.asarray(gj)
    np.testing.assert_allclose(st.grad.numpy(), gj, rtol=0, atol=1e-6 * np.abs(gj).max())


def test_regex_modules_select_the_same_leaves():
    jcfg, jp, tcfg, tp = _trees()
    comp = {"compression_training": {
        "weight_quantization": {"shared_parameters": {"enabled": True, "bits": 4}},
        "sparse_pruning": {"shared_parameters": {"enabled": True, "ratio": 0.7}}}}
    js, ts = J.CompressionScheduler(comp["compression_training"]), \
        T.CompressionScheduler(comp["compression_training"])
    for s in (js, ts):
        s.quant.modules = [r"\['attn'\]\['w[qk]'\]"]
        s.prune.modules = [r"mlp.*w_down", r"lm_head"]
    jo, to = js.transform_params(jp, 0), ts.transform_params(tp, 0)
    _assert_trees_equal(jo, to)
    # the selection took: wq changed, wv did not; w_down pruned, w_up not
    assert not torch.equal(to.layers[0].attn.wq, tp.layers[0].attn.wq)
    assert torch.equal(to.layers[0].attn.wv, tp.layers[0].attn.wv)
    assert (to.layers[0].mlp.w_down == 0).any() and not (to.layers[0].mlp.w_up == 0).any()


def test_tied_magnitudes_keep_ties_and_sort_stably():
    """``>=`` keeps every element tied with the threshold, and equal channel
    and head importances keep the lower indices (a stable argsort), as in
    the JAX package."""
    w = np.array([[1, -2, 2, 3], [2, -2, 0.5, 1]], np.float32)
    tm, jm = T.prune_mask(torch.from_numpy(w), 0.5), J.prune_mask(jnp.asarray(w), 0.5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tm.sum()) == 5  # k = 4, but five elements tie at |w| >= 2
    jcfg, jp, tcfg, tp = _trees()
    ones = jax.tree_util.tree_map(jnp.ones_like, jp)  # every channel and head tied
    tones = params_from_numpy(jax.tree_util.tree_map(np.asarray, ones), tcfg, device="cpu")
    jo, js = J.init_compression(ones, STRUCTURED, n_heads=jcfg.n_heads)
    to, ts = T.init_compression(tones, STRUCTURED, n_heads=tcfg.n_heads)
    _assert_trees_equal(jo, to)
    np.testing.assert_array_equal(ts._chan_keep.numpy(), np.asarray(js._chan_keep))
    np.testing.assert_array_equal(ts._head_keep.numpy(), np.asarray(js._head_keep))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_radix_select_is_the_sorted_kth_largest(dtype):
    """The pruning threshold's selection against a sort of the concatenated
    magnitudes, with ties, zeros and members of several sizes."""
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(n, generator=g).to(dtype).abs() for n in (1000, 37, 513)]
    xs.append(torch.tensor([0.0, 0.0, 2.0, 2.0, 2.0], dtype=dtype))
    flat = torch.sort(torch.cat(xs).float()).values
    n = flat.numel()
    for k in (1, 2, 3, 7, n // 3, n // 2, n - 5, n - 1, n):
        got = T._kth_largest(xs, k)
        assert got.dtype == torch.float32 and float(got) == float(flat[-k]), k
