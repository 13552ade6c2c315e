"""BERT (``models/bert.py``, the core's post-norm mode) against the JAX
package's, on JAX's initialised weights carried across as numpy, in fp32
on the CPU.

  * the forward (``transformer_forward``: embedding norm, segment
    embeddings, the norm after each residual add, no final norm) and the
    MLM head's logits, with and without ``attention_mask`` and
    ``token_type_ids``, within 1e-5 (``test_torch_model.TOL``);
  * ``mlm_loss`` within 1e-5 relative;
  * the flash path (non-causal forward and backward, their plain versions
    on the CPU) against the plain attention: loss and gradients within
    1e-5;
  * 3 engine steps (AdamW, clipping 1.0), one of them with an
    ``attention_mask``: loss and grad norm within 1e-5 relative each step,
    the master weights within 1e-4 absolute and 1e-7 on average (the
    rule of ``test_torch_families.py``: Adam's step near eps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jb
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import bert as tb
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

TOL = 1e-5
LR = 1e-3
B, S, V = 2, 24, 256


@pytest.fixture(scope="module")
def bert():
    jm, tm = jb.bert_model("tiny"), tb.bert_model("tiny")
    tree = jax.tree_util.tree_map(np.asarray, jb.init_bert_params(
        jm.config, jax.random.PRNGKey(11)))
    rng = np.random.RandomState(12)  # biases and norm scales off 0 and 1
    tree = jax.tree_util.tree_map(lambda a: a + rng.randn(*a.shape).astype(a.dtype) * 0.05,
                                  tree)
    return jm, tm, tree


def _batch(seed, mask=False, types=False):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    labels = np.where(rng.rand(B, S) < 0.3, ids, -100).astype(np.int32)
    batch = {"input_ids": ids, "labels": labels}
    if mask:
        am = np.ones((B, S), np.int32)
        am[0, 17:] = 0
        am[1, 9:] = 0
        batch["attention_mask"] = am
    if types:
        batch["token_type_ids"] = (np.arange(S)[None] >= rng.randint(4, S, (B, 1))).astype(
            np.int32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def test_init_tree_matches_jax(bert):
    """The port's own init builds JAX's tree (``embed.type``,
    ``embed.norm``, ``mlm_head``, no ``final_norm``), leaf for leaf."""
    jm, tm, tree = bert
    mine = params_to_numpy(tm.init_params(torch.Generator().manual_seed(0), "cpu"))
    want = {jax.tree_util.keystr(p): a.shape
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    got = {jax.tree_util.keystr(p): a.shape
           for p, a in jax.tree_util.tree_leaves_with_path(mine)}
    assert got == want
    assert "final_norm" not in mine and "type" in mine["embed"] and "mlm_head" in mine


@pytest.mark.parametrize("mask,types", [(False, False), (True, False), (False, True),
                                        (True, True)])
def test_forward_and_mlm_loss_match_jax(bert, mask, types):
    jm, tm, tree = bert
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tm.config, "cpu")
    batch = _batch(13, mask, types)
    jb_, tb_ = _j(batch), _t(batch)
    hj, _ = jt.transformer_forward(jm.config, jp, jb_["input_ids"], jb_.get("attention_mask"),
                                   jb_.get("token_type_ids"))
    ht, _ = tt.transformer_forward(tm.config, tp, tb_["input_ids"], tb_.get("attention_mask"),
                                   tb_.get("token_type_ids"))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tm.apply_fn(tp, tb_).numpy(), np.asarray(jm.apply_fn(jp, jb_)),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tb.mlm_logits(tm.config, tp, ht).numpy(),
                               np.asarray(jb.mlm_logits(jm.config, jp, hj)), atol=TOL, rtol=TOL)
    lj = float(jb.mlm_loss(jm.config, jp, jb_))
    lt = float(tb.mlm_loss(tm.config, tp, tb_))
    assert abs(lt - lj) <= TOL * abs(lj)


@pytest.mark.parametrize("act", ["gelu_exact", "gelu", "relu"])
def test_mlm_head_activation_follows_config(bert, act):
    """The head's activation is the configured one (HF
    BertPredictionHeadTransform), as JAX's."""
    jm, tm, tree = bert
    jc = jb.bert_config("tiny", activation=act)
    tc = tb.bert_config("tiny", activation=act)
    h = np.random.RandomState(14).randn(B, S, jc.hidden_size).astype(np.float32)
    want = jb.mlm_logits(jc, jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(h))
    got = tb.mlm_logits(tc, params_from_numpy(tree, tc, "cpu"), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_flash_path_matches_plain_attention(bert):
    """attn_impl="flash" (the non-causal flash forward and backward; their
    plain versions on the CPU) against the plain attention."""
    _, tm, tree = bert
    batch = _t(_batch(15))
    out = {}
    for impl in ("xla", "flash"):
        cfg = tb.bert_config("tiny", attn_impl=impl)
        tp = params_from_numpy(tree, cfg, "cpu")
        for p in tp.parameters():
            p.requires_grad_(True)
        loss = tb.mlm_loss(cfg, tp, batch)
        loss.backward()
        out[impl] = (loss.detach(), {n: p.grad for n, p in tp.named_parameters()})
    assert abs(float(out["flash"][0]) - float(out["xla"][0])) <= TOL * abs(float(out["xla"][0]))
    for n, g in out["xla"][1].items():
        np.testing.assert_allclose(out["flash"][1][n].numpy(), g.numpy(),
                                   atol=TOL * max(1.0, float(g.abs().max())), rtol=0,
                                   err_msg=n)


def test_three_engine_steps_match_jax(bert):
    jm, tm, tree = bert
    ds = {"train_micro_batch_size_per_gpu": B,
          "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.1}},
          "gradient_clipping": 1.0, "zero_optimization": {"stage": 1}}
    je, *_ = deepspeed_tpu.initialize(model=jm, config=dict(ds),
                                      model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    te, *_ = deepspeed_tpu_torch.initialize(model=tm, config=dict(ds), model_parameters=tree,
                                            device="cpu")
    for step, (mask, types) in enumerate(((False, True), (True, True), (False, False))):
        batch = {k: v[None] for k, v in _batch(20 + step, mask, types).items()}
        lj = float(je.train_batch(_j(batch)))
        lt = float(te.train_batch(batch))
        assert abs(lt - lj) <= TOL * abs(lj), (step, lt, lj)
        nj, nt = je.get_global_grad_norm(), te.get_global_grad_norm()
        assert abs(nt - nj) <= TOL * nj, (step, nt, nj)
    want = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), je.get_params()))
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(te.get_params())))
    assert len(got) == len(want)
    diffs = []
    for path, w in want:
        d = np.abs(got[path] - w)
        diffs.append(d.ravel())
        assert d.max() <= 1e-4, (jax.tree_util.keystr(path), d.max())
    assert np.concatenate(diffs).mean() <= 1e-7


def test_generative_engines_refuse_post_norm(bert):
    _, tm, tree = bert
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2

    with pytest.raises(NotImplementedError, match="post_norm"):
        InferenceEngineV2(tm, params=tree, device="cpu")
    with pytest.raises(NotImplementedError, match="post_norm"):
        deepspeed_tpu_torch.init_inference(tm, config={"dtype": "fp32"}, params=tree,
                                           device="cpu")
