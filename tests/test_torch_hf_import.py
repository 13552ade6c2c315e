"""Hugging Face checkpoint I/O (``checkpoint/hf_import.py``,
``checkpoint/hf_export.py``) against the JAX package's, on the CPU.

Every directory is written from seeded weights by an exporter (no
published checkpoint is read):
  * for every ``model_type`` that ``config_from_hf`` takes, a directory
    written by JAX's ``save_hf_checkpoint`` is imported by both packages:
    the configs agree field for field and the parameters bit for bit;
  * the port's export (single file and sharded) is read back by JAX's
    importer, bit-equal to the tree it was written from;
  * the fused-QKV layouts against a hand-built ground truth with NH != KVH
    where the family allows it (falcon's grouped new architecture, both
    norm layouts) and the per-head ``[NH, 3, D]`` interleave of bloom and
    gpt-neox;
  * BF16 (kept bf16 on the host, never widened), sharded-index and
    ``pytorch_model.bin`` directories;
  * the refused variants raise JAX's ``ValueError`` texts;
  * ``init_inference(<dir>)`` and ``InferenceEngineV2.from_pretrained(<dir>)``
    serve greedy streams equal to JAX's.
"""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import hf_export as jx
from deepspeed_tpu.checkpoint import hf_import as ji
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngineV2
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxRaggedConfig
from deepspeed_tpu.inference.v2 import RaggedRequest as JaxRequest
from deepspeed_tpu.models import bert as jb
from deepspeed_tpu.models import families as jf
from deepspeed_tpu.models import gpt2 as jg
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.models import mixtral as jm
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.checkpoint import hf_export as tx
from deepspeed_tpu_torch.checkpoint import hf_import as ti
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, RaggedInferenceConfig,
                                              RaggedRequest)
from deepspeed_tpu_torch.models.convert import params_from_numpy

torch.set_num_threads(2)

#: model_type -> the JAX config of a tiny model of that family (NH != KVH
#: wherever the family's checkpoint layout allows it)
CONFIGS = {
    "llama": lambda: jl.llama_config("tiny", n_kv_heads=2),
    "mistral": lambda: jf.mistral_config("tiny"),
    "qwen2": lambda: jf.qwen_config("tiny", n_kv_heads=2),
    "phi3": lambda: jl.llama_config("tiny", n_kv_heads=2),
    "mixtral": lambda: jm.mixtral_config("tiny", n_kv_heads=2),
    "qwen2_moe": lambda: jm.mixtral_config("tiny", n_kv_heads=2, qkv_bias=True,
                                           moe_shared_expert=96, moe_norm_topk=False,
                                           moe_drop_tokens=False),
    "gpt2": lambda: jg.gpt2_config("tiny"),
    "opt": lambda: jf.opt_config("tiny"),
    "phi": lambda: jf.phi_config("tiny", n_kv_heads=2),
    "falcon": lambda: jf.falcon_config("tiny"),
    "bloom": lambda: jf.bloom_config("tiny"),
    "gpt_neox": lambda: jf.gpt_neox_config("tiny"),
    "bert": lambda: jb.bert_config("tiny"),
}
#: the config fields both packages' TransformerConfig carry (dtype aside)
FIELDS = ("vocab_size", "hidden_size", "n_layers", "n_heads", "n_kv_heads",
          "intermediate_size", "max_seq_len", "norm", "activation", "position", "causal",
          "embed_norm", "tie_embeddings", "rope_theta", "norm_eps", "use_bias", "qkv_bias",
          "rotary_pct", "parallel_block", "parallel_norms", "post_norm", "type_vocab_size",
          "moe_experts", "moe_top_k", "moe_shared_expert", "moe_norm_topk", "moe_drop_tokens")


def _tree(model_type, seed=0):
    cfg = CONFIGS[model_type]()
    init = jb.init_bert_params if model_type == "bert" else jt.init_transformer_params
    tree = jax.tree_util.tree_map(np.asarray, init(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed + 1)  # biases and norms off 0 and 1
    tree = jax.tree_util.tree_map(lambda a: a + rng.randn(*a.shape).astype(a.dtype) * 0.05,
                                  tree)
    return cfg, tree


def _read_back(model_type, tree):
    """The tree an import of ``tree``'s export gives: phi's head always
    carries a bias in HF, which the exporters write as zeros."""
    if model_type == "phi" and "b" not in tree["lm_head"]:
        w = tree["lm_head"]["w"]
        return dict(tree, lm_head=dict(tree["lm_head"], b=np.zeros(w.shape[1], w.dtype)))
    return tree


def _flat(tree, pre=""):
    """Leaves by path as numpy (tensors and bf16 arrays widened to fp32,
    which is exact)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[pre + k] = (v.float() if v.is_floating_point() else v).numpy()
        else:
            a = np.asarray(v)
            out[pre + k] = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return out


def _assert_bit_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _assert_same_config(tc, jc):
    for f in FIELDS:
        assert getattr(tc, f) == getattr(jc, f), f


@pytest.mark.parametrize("model_type", sorted(CONFIGS))
def test_import_of_jax_export_is_bit_equal(model_type, tmp_path):
    cfg, tree = _tree(model_type)
    jx.save_hf_checkpoint(str(tmp_path), cfg, tree, model_type)
    jc, jp = ji.load_hf_model(str(tmp_path))
    tc, tp = ti.load_hf_model(str(tmp_path))
    _assert_same_config(tc, jc)
    _assert_bit_equal(tp, jp)
    _assert_bit_equal(tp, _read_back(model_type, tree))  # the tree it was written from
    assert all(t.dtype == torch.float32 for t in ti._leaves(tp) if t.is_floating_point())


@pytest.mark.parametrize("model_type", sorted(CONFIGS))
def test_import_keeps_its_state_and_the_load_consumes_it(model_type, tmp_path):
    """``import_hf_params`` leaves the caller's state dict as it was; the
    load's own import pops every per-layer tensor as it stacks it (so the
    host holds the weights once), with the same tree as a result."""
    cfg, tree = _tree(model_type)
    jx.save_hf_checkpoint(str(tmp_path), cfg, tree, model_type)
    tc, _ = ti.load_hf_model(str(tmp_path))
    state = ti.load_state_dict(str(tmp_path))
    before = dict(state)
    kept = ti.import_hf_params(tc, state, model_type)
    assert state.keys() == before.keys() and all(state[k] is v for k, v in before.items())
    consumed = ti._import(tc, state, model_type)
    _assert_bit_equal(consumed, kept)
    per_layer = re.compile(r"\.(layers|h|layer)\.\d+\.")
    assert not [k for k in state if per_layer.search(k)]
    assert [k for k in before if per_layer.search(k)]


@pytest.mark.parametrize("shard", [None, 4096])
@pytest.mark.parametrize("model_type", sorted(CONFIGS))
def test_port_export_reads_back_in_jax(model_type, shard, tmp_path):
    """The port's export of a ParamTree, read by JAX's importer, gives the
    tree back bit for bit; sharded, it writes JAX-readable shards and an
    index.  The state dicts of both exporters are equal, name for name."""
    cfg, tree = _tree(model_type)
    tcfg = ti.config_from_hf(jx.hf_config_dict(cfg, model_type))
    tx.save_hf_checkpoint(str(tmp_path), tcfg, params_from_numpy(tree, tcfg, "cpu"),
                          model_type, max_shard_bytes=shard)
    files = sorted(os.listdir(tmp_path))
    if shard:
        assert "model.safetensors.index.json" in files and len(files) > 3
    else:
        assert files == ["config.json", "model.safetensors"]
    _, jp = ji.load_hf_model(str(tmp_path))
    _assert_bit_equal(jp, _read_back(model_type, tree))
    want = jx.export_hf_state(cfg, tree, model_type)
    got = tx.export_hf_state(tcfg, tree, model_type)  # the stacked numpy tree as well
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    with open(tmp_path / "config.json") as f:
        written = json.load(f)
    assert written == dict(jx.hf_config_dict(cfg, model_type), torch_dtype="float32")


def _falcon_new_arch_dir(path, n_ln):
    """A falcon new-decoder-architecture directory built by hand: 4 query
    heads over 2 KV heads, the fused rows grouped per KV head as
    ``[q_1, q_2, k, v]``; returns the q, k, v weights it holds."""
    NH, KVH, D, H, L, V = 4, 2, 8, 32, 2, 80
    rng = np.random.RandomState(30)
    state, truth = {}, {"wq": [], "wk": [], "wv": []}
    for i in range(L):
        q = rng.randn(NH * D, H).astype(np.float32)
        k = rng.randn(KVH * D, H).astype(np.float32)
        v = rng.randn(KVH * D, H).astype(np.float32)
        fused = np.concatenate([q.reshape(KVH, NH // KVH, D, H), k.reshape(KVH, 1, D, H),
                                v.reshape(KVH, 1, D, H)], axis=1).reshape(-1, H)
        pre = f"transformer.h.{i}."
        state[pre + "self_attention.query_key_value.weight"] = fused
        state[pre + "self_attention.dense.weight"] = rng.randn(H, NH * D).astype(np.float32)
        state[pre + "mlp.dense_h_to_4h.weight"] = rng.randn(4 * H, H).astype(np.float32)
        state[pre + "mlp.dense_4h_to_h.weight"] = rng.randn(H, 4 * H).astype(np.float32)
        for ln in (("ln_attn", "ln_mlp") if n_ln == 2 else ("input_layernorm",)):
            state[pre + ln + ".weight"] = rng.randn(H).astype(np.float32)
            state[pre + ln + ".bias"] = rng.randn(H).astype(np.float32)
        for n, w in (("wq", q), ("wk", k), ("wv", v)):
            truth[n].append(w.T)
    state["transformer.word_embeddings.weight"] = rng.randn(V, H).astype(np.float32)
    state["transformer.ln_f.weight"] = rng.randn(H).astype(np.float32)
    state["transformer.ln_f.bias"] = rng.randn(H).astype(np.float32)
    jx.write_safetensors(os.path.join(path, "model.safetensors"), state)
    c = {"model_type": "falcon", "vocab_size": V, "hidden_size": H, "num_hidden_layers": L,
         "num_attention_heads": NH, "num_kv_heads": KVH, "new_decoder_architecture": True,
         "parallel_attn": True, "bias": False, "max_position_embeddings": 64}
    if n_ln == 1:
        c["num_ln_in_parallel_attn"] = 1
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(c, f)
    return {k: np.stack(v) for k, v in truth.items()}


@pytest.mark.parametrize("n_ln", [2, 1])
def test_falcon_grouped_qkv_split(n_ln, tmp_path):
    """Falcon's new decoder architecture (40b/180b: ln_attn + ln_mlp;
    11b: one input_layernorm): q heads grouped by KV head."""
    truth = _falcon_new_arch_dir(str(tmp_path), n_ln)
    jc, jp = ji.load_hf_model(str(tmp_path))
    tc, tp = ti.load_hf_model(str(tmp_path))
    _assert_same_config(tc, jc)
    assert tc.kv_heads == 2 and tc.parallel_norms == n_ln
    assert ("norm2" in tp["layers"]) == (n_ln == 2)
    _assert_bit_equal(tp, jp)
    for k, w in truth.items():
        np.testing.assert_array_equal(tp["layers"]["attn"][k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("model_type", ["bloom", "gpt_neox"])
def test_per_head_fused_qkv_split(model_type, tmp_path):
    """bloom / gpt-neox rows are per-head ``[q_h, k_h, v_h]`` triples: the
    port's split against an interleave built here."""
    cfg, tree = _tree(model_type)
    jx.save_hf_checkpoint(str(tmp_path), cfg, tree, model_type)
    _, tp = ti.load_hf_model(str(tmp_path))
    state = ti.load_state_dict(str(tmp_path))
    attn = "transformer.h.0.self_attention" if model_type == "bloom" \
        else "gpt_neox.layers.0.attention"
    NH, D = cfg.n_heads, cfg.head_dim
    a = tree["layers"]["attn"]
    built = np.stack([a[k][0].T.reshape(NH, D, -1) for k in ("wq", "wk", "wv")], 1)
    np.testing.assert_array_equal(state[f"{attn}.query_key_value.weight"].numpy(),
                                  built.reshape(NH * 3 * D, -1))
    for k in ("wq", "wk", "wv", "bq", "bk", "bv"):
        np.testing.assert_array_equal(tp["layers"]["attn"][k].numpy(), a[k], err_msg=k)


def test_bf16_directory_stays_bf16(tmp_path):
    """A BF16 checkpoint is read as 16-bit words viewed as bfloat16 (no
    ml_dtypes), bit-equal to JAX's read, and stays bf16 on its way to the
    engine when the engine's dtype is bf16."""
    cfg, tree = _tree("falcon")
    jx.save_hf_checkpoint(str(tmp_path), cfg, tree, "falcon", dtype=jnp.bfloat16)
    state = ti.load_state_dict(str(tmp_path))
    assert all(t.dtype == torch.bfloat16 for t in state.values())
    _, jp = ji.load_hf_model(str(tmp_path), dtype=jnp.bfloat16)
    tc, tp = ti.load_hf_model(str(tmp_path), dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in ti._leaves(tp))
    _assert_bit_equal(tp, jp)
    eng = InferenceEngineV2(deepspeed_tpu_torch.models.llama_model(config=tc),
                            RaggedInferenceConfig(dtype="bf16"), params=tp, device="cpu")
    assert eng.params.layers[0].attn.wq.dtype == torch.bfloat16
    # the port writes bf16 back as it read it
    out = tmp_path / "again"
    tx.save_hf_checkpoint(str(out), tc, tp, "falcon")
    again = ti.load_state_dict(str(out))
    assert sorted(again) == sorted(state)
    for k, t in state.items():
        assert again[k].dtype == torch.bfloat16 and torch.equal(again[k], t), k
    with open(out / "config.json") as f:
        assert json.load(f)["torch_dtype"] == "bfloat16"


def test_pytorch_bin_directories(tmp_path):
    """``pytorch_model.bin`` and a sharded ``.bin`` index, bf16 and fp32."""
    cfg, tree = _tree("qwen2")
    state = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in jx.export_hf_state(cfg, tree, "qwen2").items()}
    state["model.norm.weight"] = state["model.norm.weight"].to(torch.bfloat16)
    single, sharded = tmp_path / "single", tmp_path / "sharded"
    for d in (single, sharded):
        d.mkdir()
        with open(d / "config.json", "w") as f:
            json.dump(jx.hf_config_dict(cfg, "qwen2"), f)
    torch.save(state, single / "pytorch_model.bin")
    names = sorted(state)
    halves = {"a.bin": names[::2], "b.bin": names[1::2]}
    for fn, keys in halves.items():
        torch.save({k: state[k] for k in keys}, sharded / fn)
    with open(sharded / "pytorch_model.bin.index.json", "w") as f:
        json.dump({"weight_map": {k: fn for fn, keys in halves.items() for k in keys}}, f)
    for d in (single, sharded):
        _, jp = ji.load_hf_model(str(d))
        _, tp = ti.load_hf_model(str(d))
        _assert_bit_equal(tp, jp)
        assert ti.load_state_dict(str(d))["model.norm.weight"].dtype == torch.bfloat16


def test_safetensors_reader_and_writer_round_trip(tmp_path):
    """Every dtype the format names, through the port's writer and both
    readers (the port's header padded to 8 bytes, JAX's not)."""
    rng = np.random.RandomState(40)
    tensors = {"f64": torch.from_numpy(rng.randn(3, 5)),
               "f32": torch.from_numpy(rng.randn(7).astype(np.float32)),
               "f16": torch.from_numpy(rng.randn(2, 3).astype(np.float16)),
               "bf16": torch.from_numpy(rng.randn(4, 4).astype(np.float32)).to(torch.bfloat16),
               "i64": torch.arange(5), "i32": torch.arange(3, dtype=torch.int32),
               "i16": torch.arange(4, dtype=torch.int16),
               "i8": torch.arange(-3, 3, dtype=torch.int8),
               "u8": torch.arange(9, dtype=torch.uint8), "bool": torch.tensor([True, False]),
               "scalar": torch.tensor(2.5)}
    path = str(tmp_path / "t.safetensors")
    tx.write_safetensors(path, tensors)
    with open(path, "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0
    got = ti.read_safetensors(path)
    jgot = ji.read_safetensors(path)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
        assert np.array_equal(np.asarray(jgot[k]).astype(np.float64),
                              t.double().numpy()), k
    jpath = str(tmp_path / "j.safetensors")  # JAX's writer: an unpadded header
    jx.write_safetensors(jpath, {"a": np.arange(3, dtype=np.float32),
                                 "b": np.ones((2, 2), ml_dtypes.bfloat16)})
    back = ti.read_safetensors(jpath)
    assert torch.equal(back["a"], torch.arange(3, dtype=torch.float32))
    assert back["b"].dtype == torch.bfloat16 and bool((back["b"] == 1).all())


def _hf(model_type, **extra):
    return dict(jx.hf_config_dict(CONFIGS[model_type](), model_type), **extra)


REFUSED = {
    "opt_post_ln": _hf("opt", do_layer_norm_before=False),
    "opt_projection": _hf("opt", word_embed_proj_dim=32),
    "opt_activation": _hf("opt", activation_function="silu"),
    "phi_qk_layernorm": _hf("phi", qk_layernorm=True),
    "bert_activation": _hf("bert", hidden_act="silu"),
    "bert_relative": _hf("bert", position_embedding_type="relative_key"),
    "bloom_post_ln_residual": _hf("bloom", apply_residual_connection_post_layernorm=True),
    "neox_sequential": _hf("gpt_neox", use_parallel_residual=False),
    "falcon_sequential": _hf("falcon", parallel_attn=False),
    "falcon_mha": _hf("falcon", multi_query=False),
    "falcon_alibi": _hf("falcon", alibi=True),
    "falcon_bias": _hf("falcon", bias=True),
    "phi3_longrope": _hf("phi3", rope_scaling={"type": "longrope"}),
    "qwen2_moe_mixed": _hf("qwen2_moe", decoder_sparse_step=2),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_variants_raise_jax_errors(case):
    with pytest.raises(ValueError) as want:
        ji.config_from_hf(REFUSED[case])
    with pytest.raises(ValueError) as got:
        ti.config_from_hf(REFUSED[case])
    assert str(got.value) == str(want.value)


EXPORT_REFUSED = {
    "gpt2_untied": ("gpt2", dict(tie_embeddings=False)),
    "mixtral_residual": ("mixtral", dict(moe_use_residual=True)),
    "mixtral_qwen_state": ("qwen2_moe", dict()),
    "qwen2_moe_no_shared": ("mixtral", dict(qkv_bias=True)),
    "falcon_grouped": ("falcon", dict(n_kv_heads=2)),
    "phi_sequential": ("phi", dict(parallel_block=False)),
    "bert_pre_norm": ("bert", dict(post_norm=False)),
}


@pytest.mark.parametrize("case", sorted(EXPORT_REFUSED))
def test_export_refusals_match_jax(case):
    src, change = EXPORT_REFUSED[case]
    model_type = {"mixtral_qwen_state": "mixtral",
                  "qwen2_moe_no_shared": "qwen2_moe"}.get(case, src)
    cfg, tree = _tree(src)
    if case == "gpt2_untied":
        tree = dict(tree, lm_head={"w": tree["embed"]["tok"].T.copy()})
    jcfg = dataclasses.replace(cfg, **change)
    tcfg = dataclasses.replace(ti.config_from_hf(jx.hf_config_dict(cfg, src)), **change)
    with pytest.raises(ValueError) as want:
        jx.export_hf_state(jcfg, tree, model_type)
    with pytest.raises(ValueError) as got:
        tx.export_hf_state(tcfg, tree, model_type)
    assert str(got.value) == str(want.value)


def _prompts(vocab, seed=41):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, n))) for n in (6, 19, 11)]


@pytest.mark.parametrize("model_type", ["falcon", "bloom"])
def test_from_pretrained_streams_match_jax(model_type, tmp_path):
    cfg, tree = _tree(model_type)
    tx.save_hf_checkpoint(str(tmp_path), ti.config_from_hf(jx.hf_config_dict(cfg, model_type)),
                          tree, model_type, max_shard_bytes=8192)
    kw = dict(dtype="fp32", page_size=8, num_pages=32, max_seqs=2, max_pages_per_seq=8)
    prompts = _prompts(cfg.vocab_size)
    want = JaxEngineV2.from_pretrained(str(tmp_path), JaxRaggedConfig(**kw)).generate_all(
        [JaxRequest(prompt_ids=p, max_new_tokens=6) for p in prompts])
    eng = InferenceEngineV2.from_pretrained(str(tmp_path), RaggedInferenceConfig(**kw),
                                            device="cpu")
    assert eng.cfg.n_heads == cfg.n_heads and eng.cfg.kv_heads == cfg.kv_heads
    got = eng.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=6) for p in prompts])
    assert got == want


@pytest.mark.parametrize("model_type", ["qwen2", "gpt2"])
def test_init_inference_from_directory_matches_jax(model_type, tmp_path):
    cfg, tree = _tree(model_type)
    jx.save_hf_checkpoint(str(tmp_path), cfg, tree, model_type)
    ids = np.random.RandomState(42).randint(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    want = np.asarray(deepspeed_tpu.init_inference(str(tmp_path), config={"dtype": "fp32"})
                      .generate(ids, max_new_tokens=6))
    eng = deepspeed_tpu_torch.init_inference(str(tmp_path), config={"dtype": "fp32"},
                                             device="cpu")
    np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=6).numpy(), want)
