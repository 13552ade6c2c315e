"""The other model families (``models/families.py``, ``models/gpt2.py``)
against the JAX package's, on JAX's initialised weights carried across as
numpy (``params_from_numpy``), in fp32 on the CPU.

Per family, at its ``tiny`` size (NH != KVH where the family allows it:
mistral 4/2, qwen2 4/2, phi 4/2, falcon 4/1):
  * the logits and the loss of ``transformer_forward`` / ``causal_lm_loss``
    within ``TOL`` (the limits of ``test_torch_model.py``: fp32 1e-5, the
    same formulas summed in another order);
  * greedy streams of the paged engine token-identical to JAX's
    ``InferenceEngineV2`` (whole and chunked prefill);
  * one engine step (AdamW, clipping 1.0): the loss and the grad norm
    within 1e-5 relative, the master weights within 1e-4 absolute and
    1e-7 on average (Adam's first step moves a weight by lr * g / (|g| +
    eps), which for a gradient near eps = 1e-8 depends on its last digits:
    observed 5.3e-5 at lr 1e-3 in one of 16,384 elements, 8.5e-9 on
    average);
  * weight-only quantization picks the same leaves as JAX's rule (biases,
    norms, embeddings and the biased head's bias full precision) and
    gives JAX's codes and scales bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.quantization import \
    quantize_inference_params as jax_quantize_params
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import RaggedRequest as JaxRequest
from deepspeed_tpu.models import families as jf
from deepspeed_tpu.models import gpt2 as jg
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.inference.quantization import quantize_inference_params
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, RaggedInferenceConfig,
                                              RaggedRequest)
from deepspeed_tpu_torch.models import families as tf
from deepspeed_tpu_torch.models import gpt2 as tg
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(2)

TOL = 1e-5  # fp32, test_torch_model.TOL["fp32"]
LR = 1e-3

#: family -> (JAX model builder, port model builder, tiny overrides)
FAMILIES = {
    "mistral": (jf.mistral_model, tf.mistral_model, {}),
    "qwen2": (jf.qwen_model, tf.qwen_model, {"n_kv_heads": 2}),
    "phi": (jf.phi_model, tf.phi_model, {"n_kv_heads": 2}),
    "opt": (jf.opt_model, tf.opt_model, {}),
    "falcon": (jf.falcon_model, tf.falcon_model, {}),
    "bloom": (jf.bloom_model, tf.bloom_model, {}),
    "gpt_neox": (jf.gpt_neox_model, tf.gpt_neox_model, {}),
    "gpt2": (jg.gpt2_model, tg.gpt2_model, {}),
}


def _models(family):
    jb, tb, kw = FAMILIES[family]
    kw = dict(kw, max_seq_len=128)
    jm, tm = jb("tiny", **kw), tb("tiny", **kw)
    tree = jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        jm.config, jax.random.PRNGKey(3)))
    # the JAX init leaves biases at 0 and norms at 1: perturb them, so a
    # leaf read in the wrong place shows
    rng = np.random.RandomState(4)
    tree = jax.tree_util.tree_map(lambda a: a + rng.randn(*a.shape).astype(a.dtype) * 0.05,
                                  tree)
    return jm, tm, tree


def _ids(shape, vocab, seed=5):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sizes_match_jax(family):
    """Every size of the family's table builds the JAX config, field for
    field."""
    table = {"mistral": "MISTRAL_SIZES", "qwen2": "QWEN_SIZES", "phi": "PHI_SIZES",
             "opt": "OPT_SIZES", "falcon": "FALCON_SIZES", "bloom": "BLOOM_SIZES",
             "gpt_neox": "NEOX_SIZES", "gpt2": "SIZES"}[family]
    jmod, tmod = (jg, tg) if family == "gpt2" else (jf, tf)
    assert getattr(tmod, table) == getattr(jmod, table)
    jb, tb, _ = FAMILIES[family]
    for size in getattr(jmod, table):
        jc, tc = jb(size).config, tb(size).config
        for field in ("vocab_size", "hidden_size", "n_layers", "n_heads", "kv_heads",
                      "head_dim", "ffn_size", "max_seq_len", "norm", "activation",
                      "position", "causal", "embed_norm", "tie_embeddings", "rope_theta",
                      "norm_eps", "use_bias", "qkv_bias", "rotary_pct", "parallel_block",
                      "parallel_norms", "post_norm"):
            assert getattr(tc, field) == getattr(jc, field), (size, field)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_and_loss_match_jax(family):
    jm, tm, tree = _models(family)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tm.config, "cpu")
    assert params_to_numpy(tp).keys() == tree.keys()
    ids = _ids((2, 24), jm.config.vocab_size)
    want = jm.apply_fn(jp, jnp.asarray(ids))
    got = tm.apply_fn(tp, torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    lj = float(jt.causal_lm_loss(jm.config, jp, jnp.asarray(ids)))
    lt = float(tt.causal_lm_loss(tm.config, tp, torch.from_numpy(ids).long()))
    assert abs(lt - lj) <= TOL * abs(lj)


#: whole-prompt prefill for every family; the 16-token chunked prefill
#: (the flash forward with a query offset) for ALiBi and the 71:1-style
#: multi-query layout
PAGED_CASES = [(f, {}) for f in sorted(FAMILIES)] + [
    (f, {"prefill_chunk": 16}) for f in ("bloom", "falcon")]


@pytest.mark.parametrize("family,extra", PAGED_CASES,
                         ids=[f"{f}-{'chunked' if e else 'whole'}" for f, e in PAGED_CASES])
def test_greedy_paged_streams_match_jax(family, extra):
    jm, tm, tree = _models(family)
    rng = np.random.RandomState(6)
    prompts = [list(map(int, rng.randint(0, jm.config.vocab_size, n))) for n in (5, 17, 30, 9)]
    cfg = dict(dtype="fp32", page_size=8, num_pages=64, max_seqs=4, max_pages_per_seq=8,
               **extra)
    want = JaxEngine(jm, JaxConfig(**cfg), params=jax.tree_util.tree_map(
        jnp.asarray, tree)).generate_all(
        [JaxRequest(prompt_ids=p, max_new_tokens=8) for p in prompts])
    eng = InferenceEngineV2(tm, RaggedInferenceConfig(**cfg), params=tree, device="cpu")
    got = eng.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=8) for p in prompts])
    assert got == want
    assert (eng.stats()["prefill_chunk_calls"] > 0) == bool(extra)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_engine_step_matches_jax(family):
    """One train_batch of both engines from the same weights and batch."""
    jm, tm, tree = _models(family)
    ds = {"train_micro_batch_size_per_gpu": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.1}},
          "gradient_clipping": 1.0}
    je, *_ = deepspeed_tpu.initialize(model=jm, config=dict(ds),
                                      model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    te, *_ = deepspeed_tpu_torch.initialize(model=tm, config=dict(ds), model_parameters=tree,
                                            device="cpu")
    ids = _ids((1, 2, 17), jm.config.vocab_size, seed=7)
    lj = float(je.train_batch(jnp.asarray(ids)))
    lt = float(te.train_batch(ids))
    assert abs(lt - lj) <= 1e-5 * abs(lj)
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
    nj, nt = je.get_global_grad_norm(), te.get_global_grad_norm()
    assert abs(nt - nj) <= 1e-5 * nj, (nt, nj)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_weight_quantization_picks_jax_leaves(family):
    jm, tm, tree = _models(family)
    want, jb, ja = jax_quantize_params(jax.tree_util.tree_map(jnp.asarray, tree), 8, 64,
                                       min_size=1024)
    got, tb, ta = quantize_inference_params(params_from_numpy(tree, tm.config, "cpu"), 8, 64,
                                            min_size=1024)
    assert (tb, ta) == (jb, ja)
    w, g = _flat(jax.tree_util.tree_map(np.asarray, want)), _flat(params_to_numpy(got))
    assert sorted(w) == sorted(g)
    quantized = {k for k in w if k.endswith("/wq")}
    assert quantized and not any("/b" in k or "norm" in k or "embed" in k for k in quantized)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
