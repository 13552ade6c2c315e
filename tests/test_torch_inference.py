"""The port's dense-cache inference engine (``inference/engine.py``,
``init_inference``), its dense KV-cache model path and the LoRA layer vs
the JAX package's, on the same numpy weights on the CPU.

Greedy generations must be token-identical in fp32, before and after
``module_quantize``, for llama and for the mixtral MoE under both
``moe_drop_tokens`` settings; ``module_quantize`` must leave every parameter
bit-equal to JAX's (its int8 codec runs as the JAX kernels do, in
interpret mode here), including at a width whose leaves do not fill
128-wide rows, where rows span layer boundaries of JAX's stacked leaves.
Logits: 1e-5 in fp32 (summation order only).  Sampling cannot match JAX's
PRNG; the top-k / top-p filter is compared instead, mask for mask, on
fixed logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.engine import InferenceConfig as JaxConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.linear import optimized_linear as jlin
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.llama import llama_model as jax_llama
from deepspeed_tpu.models.mixtral import mixtral_model as jax_mixtral
from deepspeed_tpu_torch.inference.engine import (InferenceConfig, InferenceEngine,
                                                  filter_logits)
from deepspeed_tpu_torch.linear import optimized_linear as tlin
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.models.llama import llama_model
from deepspeed_tpu_torch.models.mixtral import mixtral_model

torch.set_num_threads(2)

#: the tiny llama, and a width whose leaves do not fill 128-wide rows
#: (hidden 80 = 4 heads of 20, FFN 100, vocab 250)
WIDTHS = {"tiny": {}, "w80": dict(hidden_size=80, n_heads=4, n_kv_heads=4,
                                  intermediate_size=100, vocab_size=250)}


def _models(width="tiny"):
    kw = WIDTHS[width]
    return jax_llama("tiny", max_seq_len=64, **kw), llama_model("tiny", max_seq_len=64, **kw)


@pytest.fixture(scope="module")
def tiny():
    jm, tm = _models()
    params = jm.init_params(jax.random.PRNGKey(0))
    return jm, tm, params, jax.tree_util.tree_map(np.asarray, params)


def _prompt(B=2, T=7, vocab=256, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, T)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def test_forward_with_cache_matches_jax(tiny):
    """Prefill 10 tokens, then two single-token decode steps: logits and
    the written cache slots within 1e-5."""
    jm, tm, params, np_params = tiny
    tp = params_from_numpy(np_params, tm.config, "cpu")
    ids = _prompt(T=10, seed=1)
    jcache = jt.init_kv_cache(jm.config, 2, 16, jnp.float32)
    tcache = tt.init_kv_cache(tm.config, 2, 16, torch.float32, device="cpu")
    steps = [(ids, 0), (ids[:, -1:] + 1, 10), (ids[:, -1:] + 2, 11)]
    for step_ids, pos in steps:
        jl, jcache = jt.forward_with_cache(jm.config, params, jnp.asarray(step_ids), jcache,
                                           jnp.full((2,), pos, jnp.int32))
        tl, tcache = tt.forward_with_cache(tm.config, tp, torch.from_numpy(step_ids).long(),
                                           tcache, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    assert tcache["length"] == int(jcache["length"]) == 12
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name][:, :, :12].numpy(),
                                   np.asarray(jcache[name])[:, :, :12], atol=1e-5, rtol=1e-5)


def test_init_inference_greedy_matches_jax_before_and_after_module_quantize(tiny):
    jm, tm, params, np_params = tiny
    prompt = _prompt()
    jeng = deepspeed_tpu.init_inference(jm, config={"dtype": "fp32"}, params=params)
    teng = deepspeed_tpu_torch.init_inference(tm, config={"dtype": "fp32"}, params=np_params,
                                              device="cpu")
    assert isinstance(teng, InferenceEngine) and teng.device.type == "cpu"
    want = np.asarray(jeng.generate(prompt, max_new_tokens=8))
    got = teng.generate(prompt, max_new_tokens=8)
    assert got.shape == (2, 15)
    np.testing.assert_array_equal(got.numpy(), want)
    jeng.module_quantize()
    teng.module_quantize()
    np.testing.assert_array_equal(teng.generate(prompt, max_new_tokens=8).numpy(),
                                  np.asarray(jeng.generate(prompt, max_new_tokens=8)))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_module_quantize_params_equal_jax_leaf_for_leaf(width, dtype):
    jm, tm = _models(width)
    params = jm.init_params(jax.random.PRNGKey(3))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    jeng = JaxEngine(jm, JaxConfig(dtype=dtype), params=params)
    teng = InferenceEngine(tm, InferenceConfig(dtype=dtype), params=np_params, device="cpu")
    jeng.module_quantize()
    teng.module_quantize()
    want = _flat(jax.tree_util.tree_map(np.asarray, jeng.params))
    got = _flat(params_to_numpy(teng.params))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a [H] leaf stays as it was (the stacked [L, H] norms are coded above)
    before = _flat(np_params)
    np.testing.assert_array_equal(got["final_norm/scale"], before["final_norm/scale"])
    if width == "w80":  # 2 x 80 norm elements: one 128-row spans both layers
        assert before["layers/norm1/scale"].size % 128 != 0


def test_forward_logits_match_jax(tiny):
    jm, tm, params, np_params = tiny
    ids = _prompt(T=12, seed=2)
    jeng = JaxEngine(jm, JaxConfig(dtype="fp32"), params=params)
    teng = InferenceEngine(tm, InferenceConfig(dtype="fp32"), params=np_params, device="cpu")
    np.testing.assert_allclose(teng(ids).numpy(), np.asarray(jeng(ids)), atol=1e-5, rtol=1e-5)


CASES = [(0.7, 5, 0.0), (1.0, 0, 0.9), (1.3, 20, 0.5), (0.5, 300, 0.3), (2.0, 1, 0.0),
         (1.0, 0, 1e-9)]


@pytest.mark.parametrize("temperature,top_k,top_p", CASES)
def test_top_k_top_p_keep_masks_equal_jax(tiny, monkeypatch, temperature, top_k, top_p):
    """JAX's decode body samples from the filtered logits; a stand-in for
    ``jax.random.categorical`` records them.  The port's filter keeps the
    same tokens with the same values."""
    jm, _, params, _ = tiny
    logits = np.random.RandomState(11).randn(3, jm.config.vocab_size).astype(np.float32) * 3
    seen = []

    def categorical(key, lg, axis=-1):
        jax.debug.callback(lambda a: seen.append(np.asarray(a)), lg)
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    jeng = JaxEngine(jm, JaxConfig(dtype="fp32"), params=params)
    cache = jt.init_kv_cache(jm.config, 3, 4, jnp.float32)
    jeng._decode_body(jeng.params, jnp.asarray(logits), cache, jnp.asarray(0, jnp.int32),
                      jax.random.PRNGKey(0), steps=1, temperature=temperature, top_k=top_k,
                      top_p=top_p)
    jax.effects_barrier()
    want = seen[0]
    got = filter_logits(torch.from_numpy(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], rtol=1e-6)
    assert np.isfinite(got).sum(-1).min() >= 1


def test_sampling_is_seeded_and_top_k_1_is_greedy(tiny):
    _, tm, _, np_params = tiny
    eng = InferenceEngine(tm, InferenceConfig(dtype="fp32", max_seq_len=64), params=np_params,
                          device="cpu")
    prompt = _prompt(B=1, seed=5)
    greedy = eng.generate(prompt, max_new_tokens=6)
    assert torch.equal(eng.generate(prompt, 6, temperature=0.8, top_k=1, seed=3), greedy)
    assert torch.equal(eng.generate(prompt, 6, temperature=0.8, top_p=1e-9, seed=3), greedy)
    a = eng.generate(prompt, 6, temperature=1.5, seed=1)
    assert torch.equal(a, eng.generate(prompt, 6, temperature=1.5, seed=1))
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate(prompt, max_new_tokens=60)


def test_generate_and_forward_take_ids_as_tensor_array_or_list(tiny):
    """Ids given as a tensor are used as they are (a CUDA tensor has no numpy
    view), as an array or a list converted; all give the same stream."""
    _, tm, _, np_params = tiny
    eng = InferenceEngine(tm, InferenceConfig(dtype="fp32"), params=np_params, device="cpu")
    prompt = _prompt(seed=6)
    want = eng.generate(prompt, max_new_tokens=4)
    assert torch.equal(eng.generate(torch.from_numpy(prompt), max_new_tokens=4), want)
    assert torch.equal(eng.generate(prompt.tolist(), max_new_tokens=4), want)
    assert torch.equal(eng(torch.from_numpy(prompt)), eng(prompt))


@pytest.mark.parametrize("quantized", [False, True])
def test_lora_linear_matches_jax(quantized):
    lora = jlin.LoRAConfig(lora_r=4, lora_alpha=8)
    quant = jlin.QuantizationConfig() if quantized else None
    base = np.random.RandomState(0).randn(16, 200).astype(np.float32) * 0.1
    jp = jlin.init_lora_linear(jax.random.PRNGKey(0), 16, 200, lora, quantize=quant,
                               base=jnp.asarray(base))
    jp["lora_b"] = jnp.asarray(np.random.RandomState(1).randn(4, 200).astype(np.float32))
    tp = tlin.init_lora_linear(torch.Generator().manual_seed(0), 16, 200,
                               tlin.LoRAConfig(lora_r=4, lora_alpha=8),
                               quantize=tlin.QuantizationConfig() if quantized else None,
                               base=torch.from_numpy(base), device="cpu")
    assert sorted(tp) == sorted(jp)
    if quantized:  # the same base gives the same codes
        np.testing.assert_array_equal(tp["base_q"].numpy(), np.asarray(jp["base_q"]))
        np.testing.assert_array_equal(tp["base_scale"].numpy(), np.asarray(jp["base_scale"]))
        np.testing.assert_array_equal(tp["base_meta"].numpy(), np.asarray(jp["base_meta"]))
    # the adapters from the JAX layer, so both compute the same function
    for k in ("lora_a", "lora_b"):
        tp[k] = torch.from_numpy(np.array(jp[k]))
    x = np.random.RandomState(2).randn(3, 16).astype(np.float32)
    want = np.asarray(jlin.lora_linear(jp, jnp.asarray(x), lora))
    got = tlin.lora_linear(tp, torch.from_numpy(x), tlin.LoRAConfig(lora_r=4, lora_alpha=8))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert tlin.trainable_lora_params(tp) == jax.tree_util.tree_map(
        bool, jlin.trainable_lora_params(jp))


def test_lora_base_is_frozen():
    lora = tlin.LoRAConfig(lora_r=4, lora_alpha=8)
    p = tlin.init_lora_linear(torch.Generator().manual_seed(0), 16, 8, lora, device="cpu")
    for k in ("base", "lora_a", "lora_b"):
        p[k].requires_grad_()
    tlin.lora_linear(p, torch.ones((2, 16)), lora).square().sum().backward()
    assert p["base"].grad is None and p["lora_b"].grad.abs().max() > 0
    nested = tlin.trainable_lora_params({"layer": p, "head": [torch.zeros(1)]})
    assert nested == {"layer": {"base": False, "lora_a": True, "lora_b": True},
                      "head": [False]}


def test_tensor_parallel_and_hf_directory_raise_naming_their_items(tiny, tmp_path):
    _, tm, _, _ = tiny
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        InferenceConfig.from_dict({"tensor_parallel": {"tp_size": 2}})
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        deepspeed_tpu_torch.init_inference(tm, config={"dtype": "fp32"},
                                           tensor_parallel={"tp_size": 2}, device="cpu")
    # a directory is read as a Hugging Face checkpoint: an empty one raises
    # the FileNotFoundError JAX's init_inference raises
    with pytest.raises(FileNotFoundError) as want:
        deepspeed_tpu.init_inference(str(tmp_path))
    with pytest.raises(FileNotFoundError) as got:
        deepspeed_tpu_torch.init_inference(str(tmp_path), device="cpu")
    assert type(got.value) is type(want.value) and got.value.filename == want.value.filename


def test_default_inference_config_round_trip(tiny):
    _, tm, _, np_params = tiny
    cfg = deepspeed_tpu_torch.default_inference_config()
    assert cfg == deepspeed_tpu.default_inference_config()
    cfg.update(dtype="fp32", max_seq_len=64)
    eng = deepspeed_tpu_torch.init_inference(tm, config=cfg, params=np_params, device="cpu")
    assert eng.generate(np.zeros((1, 4), np.int32), max_new_tokens=2).shape == (1, 6)
    assert eng.config.max_seq_len == 64 and eng.params.embed.tok.dtype == torch.float32


@pytest.mark.parametrize("drop", [False, True])
def test_mixtral_generate_and_module_quantize_match_jax(drop):
    """The dense-cache path through the MoE (``forward_with_cache`` ->
    ``mlp_block(training=False)``): greedy streams equal JAX's, and
    ``module_quantize`` codes the stacked [L, E, H, F] expert leaves leaf for
    leaf as JAX does, after which the streams still agree."""
    jm = jax_mixtral("tiny", max_seq_len=64, moe_drop_tokens=drop)
    tm = mixtral_model("tiny", max_seq_len=64, moe_drop_tokens=drop)
    params = jm.init_params(jax.random.PRNGKey(2))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    jeng = JaxEngine(jm, JaxConfig(dtype="fp32"), params=params)
    teng = deepspeed_tpu_torch.init_inference(tm, config={"dtype": "fp32"}, params=np_params,
                                              device="cpu")
    prompt = _prompt(B=3, T=9, seed=7)
    np.testing.assert_array_equal(teng.generate(prompt, max_new_tokens=8).numpy(),
                                  np.asarray(jeng.generate(prompt, max_new_tokens=8)))
    np.testing.assert_allclose(teng(prompt).numpy(), np.asarray(jeng(prompt)), atol=1e-5,
                               rtol=1e-5)
    jeng.module_quantize()
    teng.module_quantize()
    want = _flat(jax.tree_util.tree_map(np.asarray, jeng.params))
    got = _flat(params_to_numpy(teng.params))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(teng.generate(prompt, max_new_tokens=8).numpy(),
                                  np.asarray(jeng.generate(prompt, max_new_tokens=8)))
