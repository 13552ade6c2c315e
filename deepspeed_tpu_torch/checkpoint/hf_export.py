"""Export parameters to a Hugging Face checkpoint directory (the port's
counterpart of ``deepspeed_tpu/checkpoint/hf_export.py``).

The inverse name map of ``hf_import`` plus a native safetensors writer.
The parameters are a port ``ParamTree`` (per-layer trees) or the JAX tree
(layers stacked on axis 0) of numpy arrays or tensors; tensors are
exported where they live and copied to the host one at a time as the file
is written, so a model on the card crosses once, in its own dtype.

Families: llama / mistral / qwen2 / phi3 (re-fused projections), mixtral,
qwen2-moe, gpt2 (Conv1D, no transposes), opt (position offset re-added),
phi (biased head), falcon (7b-style re-fused multi-query QKV), bloom and
gpt-neox (per-head fused QKV), bert (with its MLM head).
Unrepresentable states (PR-MoE residuals, an untied gpt2 head, biased or
grouped-KV falcon, ...) are refused rather than dropped, with the JAX
exporter's messages.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models.transformer import ParamTree, TransformerConfig
from ..utils.logging import logger

_TO_ST = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
          torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
          torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
_HF_DTYPE = {torch.float64: "float64", torch.float32: "float32", torch.float16: "float16",
             torch.bfloat16: "bfloat16"}

State = Dict[str, torch.Tensor]


def _t(x: Any) -> torch.Tensor:
    """A leaf as a tensor where it lives (numpy arrays on the host; an
    ml_dtypes bfloat16 array as ``torch.bfloat16``)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def write_safetensors(path: str, tensors: Dict[str, Any]) -> None:
    """Native safetensors writer (inverse of ``hf_import.read_safetensors``):
    the header padded with spaces to a multiple of 8 bytes, as the format
    allows, so every tensor starts aligned; each tensor is copied to the
    host as it is written."""
    header: Dict[str, Any] = {}
    off = 0
    for name, x in tensors.items():
        t = _t(x)
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _TO_ST[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    hjson = json.dumps(header).encode()
    hjson += b" " * (-len(hjson) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for x in tensors.values():
            t = _t(x).contiguous().cpu()
            f.write(t.reshape(-1).view(torch.uint8).numpy())


def _tree(params: Any) -> Dict[str, Any]:
    """The parameters as nested dicts whose ``layers`` leaves are indexable
    by layer: stacked leaves as they are, a ParamTree's per-layer trees
    turned into one list per leaf."""
    if not isinstance(params, ParamTree):
        return params

    def walk(mod: nn.Module) -> Dict[str, Any]:
        out: Dict[str, Any] = {n: p.detach() for n, p in mod._parameters.items()}
        for n, child in mod._modules.items():
            out[n] = _per_leaf([walk(c) for c in child]) if isinstance(
                child, nn.ModuleList) else walk(child)
        return out

    return walk(params)


def _per_leaf(trees):
    first = trees[0]
    return {k: _per_leaf([t[k] for t in trees]) if isinstance(v, dict)
            else [t[k] for t in trees] for k, v in first.items()}


def _unstack(stacked, transpose: bool = True):
    for i in range(len(stacked)):
        w = _t(stacked[i])
        yield i, (w.T if transpose else w)


def export_hf_state(cfg: TransformerConfig, params: Any,
                    model_type: str = "llama") -> State:
    """Parameters -> HF state dict (tensors where the parameters live)."""
    params = _tree(params)
    family = {"bert": _export_bert, "opt": _export_opt, "phi": _export_phi,
              "falcon": _export_falcon, "bloom": _export_bloom,
              "gpt_neox": _export_gpt_neox, "qwen2_moe": _export_qwen2_moe}.get(model_type)
    if family is not None:
        return family(cfg, params)
    if model_type == "phi3":
        # the llama layout, then the projections re-fused as HF Phi3 stores
        # them: qkv_proj rows [q | k | v], gate_up_proj rows [gate | up]
        host = export_hf_state(cfg, params, "llama")
        for i in range(cfg.n_layers):
            pre = f"model.layers.{i}"
            host[f"{pre}.self_attn.qkv_proj.weight"] = torch.cat(
                [host.pop(f"{pre}.self_attn.{n}_proj.weight") for n in ("q", "k", "v")])
            host[f"{pre}.mlp.gate_up_proj.weight"] = torch.cat(
                [host.pop(f"{pre}.mlp.gate_proj.weight"), host.pop(f"{pre}.mlp.up_proj.weight")])
        return host
    if model_type == "gpt2":
        if not cfg.tie_embeddings and "lm_head" in params:
            # GPT2LMHeadModel always ties lm_head to wte on load
            raise ValueError(
                "hf_export: gpt2 checkpoints are always tied in HF; an "
                "untied lm_head cannot be represented — retrain with "
                "tie_embeddings=True or export another family")
        return _export_gpt2(cfg, params)
    host: State = {"model.embed_tokens.weight": _t(params["embed"]["tok"]),
                   "model.norm.weight": _t(params["final_norm"]["scale"])}
    if not cfg.tie_embeddings and "lm_head" in params:
        host["lm_head.weight"] = _t(params["lm_head"]["w"]).T
    layers = params["layers"]
    for ours, theirs in {"wq": "q_proj", "wk": "k_proj", "wv": "v_proj",
                         "wo": "o_proj"}.items():
        for i, w in _unstack(layers["attn"][ours]):
            host[f"model.layers.{i}.self_attn.{theirs}.weight"] = w
    if cfg.qkv_bias:
        for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            for i, b in _unstack(layers["attn"][ours], transpose=False):
                host[f"model.layers.{i}.self_attn.{theirs}.bias"] = b
    for i, s in _unstack(layers["norm1"]["scale"], transpose=False):
        host[f"model.layers.{i}.input_layernorm.weight"] = s
    for i, s in _unstack(layers["norm2"]["scale"], transpose=False):
        host[f"model.layers.{i}.post_attention_layernorm.weight"] = s
    mlp = layers["mlp"]
    if cfg.moe_experts > 0:  # mixtral
        if cfg.moe_use_residual:
            raise ValueError(
                "hf_export: PR-MoE (moe_use_residual) has no mixtral "
                "checkpoint representation; export without residual experts")
        if cfg.moe_shared_expert or not cfg.moe_norm_topk:
            raise ValueError(
                "hf_export: this model carries qwen2-moe states "
                "(moe_shared_expert / moe_norm_topk=False) — export with "
                "model_type='qwen2_moe' instead of 'mixtral'")
        for i, g in _unstack(mlp["router"]):
            host[f"model.layers.{i}.block_sparse_moe.gate.weight"] = g
        for ours, theirs in {"w_gate": "w1", "w_down": "w2", "w_up": "w3"}.items():
            for i, full in _unstack(mlp[ours], transpose=False):  # [E, in, out]
                for e in range(full.shape[0]):
                    host[f"model.layers.{i}.block_sparse_moe.experts.{e}."
                         f"{theirs}.weight"] = full[e].T
    else:
        for ours, theirs in {"w_gate": "gate_proj", "w_up": "up_proj",
                             "w_down": "down_proj"}.items():
            for i, w in _unstack(mlp[ours]):
                host[f"model.layers.{i}.mlp.{theirs}.weight"] = w
    return host


def _export_gpt2(cfg: TransformerConfig, params: Dict[str, Any]) -> State:
    host: State = {"transformer.wte.weight": _t(params["embed"]["tok"]),
                   "transformer.wpe.weight": _t(params["embed"]["pos"]),
                   "transformer.ln_f.weight": _t(params["final_norm"]["scale"]),
                   "transformer.ln_f.bias": _t(params["final_norm"]["bias"])}
    lay = params["layers"]
    a, m = lay["attn"], lay["mlp"]
    for i in range(cfg.n_layers):
        pre = f"transformer.h.{i}"
        host[f"{pre}.attn.c_attn.weight"] = torch.cat(
            [_t(a[k][i]) for k in ("wq", "wk", "wv")], dim=1)
        host[f"{pre}.attn.c_attn.bias"] = torch.cat([_t(a[k][i]) for k in ("bq", "bk", "bv")])
        for hf, leaf in (("attn.c_proj.weight", a["wo"]), ("attn.c_proj.bias", a["bo"]),
                         ("mlp.c_fc.weight", m["w_up"]), ("mlp.c_fc.bias", m["b_up"]),
                         ("mlp.c_proj.weight", m["w_down"]),
                         ("mlp.c_proj.bias", m["b_down"])):
            host[f"{pre}.{hf}"] = _t(leaf[i])
        for ln, theirs in (("norm1", "ln_1"), ("norm2", "ln_2")):
            host[f"{pre}.{theirs}.weight"] = _t(lay[ln]["scale"][i])
            host[f"{pre}.{theirs}.bias"] = _t(lay[ln]["bias"][i])
    return host


def _emit_stacked(host: State, tree: Dict[str, Any], spec, fmt: str) -> None:
    """Per-layer leaves to per-layer HF names: ``spec`` is (hf_suffix,
    our_key, transpose) triples, ``fmt`` the name template."""
    for hf, ours, transpose in spec:
        for i, w in _unstack(tree[ours], transpose=transpose):
            host[fmt.format(i=i, hf=hf)] = w


def _export_bert(cfg: TransformerConfig, params: Dict[str, Any]) -> State:
    if not cfg.post_norm:
        raise ValueError(
            "hf_export: bert checkpoints are post-norm; a pre-norm model "
            "has no BERT representation")
    if "type" not in params.get("embed", {}):
        raise ValueError(
            "hf_export: bert checkpoints carry token_type embeddings; a "
            "model trained with type_vocab_size=0 has no representation")
    if "mlm_head" not in params:
        raise ValueError(
            "hf_export: this bert model has no mlm_head (plain tied "
            "projection); BERT checkpoints need the full prediction head — "
            "import one from HF or add an mlm_head before exporting")
    e = params["embed"]
    host: State = {
        "bert.embeddings.word_embeddings.weight": _t(e["tok"]),
        "bert.embeddings.position_embeddings.weight": _t(e["pos"]),
        "bert.embeddings.token_type_embeddings.weight": _t(e["type"]),
        "bert.embeddings.LayerNorm.weight": _t(e["norm"]["scale"]),
        "bert.embeddings.LayerNorm.bias": _t(e["norm"]["bias"]),
    }
    lay = params["layers"]
    fmt = "bert.encoder.layer.{i}.{hf}"
    _emit_stacked(host, lay["attn"], [
        ("attention.self.query.weight", "wq", True),
        ("attention.self.key.weight", "wk", True),
        ("attention.self.value.weight", "wv", True),
        ("attention.output.dense.weight", "wo", True),
        ("attention.self.query.bias", "bq", False),
        ("attention.self.key.bias", "bk", False),
        ("attention.self.value.bias", "bv", False),
        ("attention.output.dense.bias", "bo", False)], fmt)
    _emit_stacked(host, lay["mlp"], [
        ("intermediate.dense.weight", "w_up", True),
        ("intermediate.dense.bias", "b_up", False),
        ("output.dense.weight", "w_down", True),
        ("output.dense.bias", "b_down", False)], fmt)
    for ln, hf in (("norm1", "attention.output.LayerNorm"), ("norm2", "output.LayerNorm")):
        _emit_stacked(host, lay[ln], [(f"{hf}.weight", "scale", False),
                                      (f"{hf}.bias", "bias", False)], fmt)
    mh = params["mlm_head"]
    host["cls.predictions.transform.dense.weight"] = _t(mh["dense_w"]).T
    host["cls.predictions.transform.dense.bias"] = _t(mh["dense_b"])
    host["cls.predictions.transform.LayerNorm.weight"] = _t(mh["norm_scale"])
    host["cls.predictions.transform.LayerNorm.bias"] = _t(mh["norm_bias"])
    host["cls.predictions.bias"] = _t(mh["bias"])
    return host


def _export_opt(cfg: TransformerConfig, params: Dict[str, Any]) -> State:
    pre = "model.decoder"
    pos = _t(params["embed"]["pos"])
    host: State = {
        f"{pre}.embed_tokens.weight": _t(params["embed"]["tok"]),
        # OPT's two padding-offset rows, dropped at import, re-added as
        # zeros (only pad positions read them)
        f"{pre}.embed_positions.weight": torch.cat(
            [torch.zeros((2, pos.shape[1]), dtype=pos.dtype, device=pos.device), pos]),
        f"{pre}.final_layer_norm.weight": _t(params["final_norm"]["scale"]),
        f"{pre}.final_layer_norm.bias": _t(params["final_norm"]["bias"]),
    }
    lay = params["layers"]
    fmt = pre + ".layers.{i}.{hf}"
    _emit_stacked(host, lay["attn"], [
        ("self_attn.q_proj.weight", "wq", True),
        ("self_attn.k_proj.weight", "wk", True),
        ("self_attn.v_proj.weight", "wv", True),
        ("self_attn.out_proj.weight", "wo", True),
        ("self_attn.q_proj.bias", "bq", False),
        ("self_attn.k_proj.bias", "bk", False),
        ("self_attn.v_proj.bias", "bv", False),
        ("self_attn.out_proj.bias", "bo", False)], fmt)
    _emit_stacked(host, lay["mlp"], [
        ("fc1.weight", "w_up", True), ("fc1.bias", "b_up", False),
        ("fc2.weight", "w_down", True), ("fc2.bias", "b_down", False)], fmt)
    for ln, hf in (("norm1", "self_attn_layer_norm"), ("norm2", "final_layer_norm")):
        _emit_stacked(host, lay[ln], [(f"{hf}.weight", "scale", False),
                                      (f"{hf}.bias", "bias", False)], fmt)
    if not cfg.tie_embeddings and "lm_head" in params:
        host["lm_head.weight"] = _t(params["lm_head"]["w"]).T
    return host


def _export_phi(cfg: TransformerConfig, params: Dict[str, Any]) -> State:
    if not cfg.parallel_block:
        raise ValueError(
            "hf_export: phi checkpoints are parallel-attention; a "
            "sequential-block model's norm2 weights have no representation")
    host: State = {
        "model.embed_tokens.weight": _t(params["embed"]["tok"]),
        "model.final_layernorm.weight": _t(params["final_norm"]["scale"]),
        "model.final_layernorm.bias": _t(params["final_norm"]["bias"]),
    }
    lay = params["layers"]
    fmt = "model.layers.{i}.{hf}"
    _emit_stacked(host, lay["attn"], [
        ("self_attn.q_proj.weight", "wq", True),
        ("self_attn.k_proj.weight", "wk", True),
        ("self_attn.v_proj.weight", "wv", True),
        ("self_attn.dense.weight", "wo", True),
        ("self_attn.q_proj.bias", "bq", False),
        ("self_attn.k_proj.bias", "bk", False),
        ("self_attn.v_proj.bias", "bv", False),
        ("self_attn.dense.bias", "bo", False)], fmt)
    _emit_stacked(host, lay["mlp"], [
        ("mlp.fc1.weight", "w_up", True), ("mlp.fc1.bias", "b_up", False),
        ("mlp.fc2.weight", "w_down", True), ("mlp.fc2.bias", "b_down", False)], fmt)
    _emit_stacked(host, lay["norm1"], [("input_layernorm.weight", "scale", False),
                                       ("input_layernorm.bias", "bias", False)], fmt)
    if not cfg.tie_embeddings and "lm_head" in params:
        w = _t(params["lm_head"]["w"])
        host["lm_head.weight"] = w.T
        b = params["lm_head"].get("b")
        # PhiForCausalLM always has the head's bias: zeros when absent
        host["lm_head.bias"] = (_t(b) if b is not None else
                                torch.zeros(cfg.vocab_size, dtype=w.dtype, device=w.device))
    return host


def _export_falcon(cfg: TransformerConfig, params: Dict[str, Any]) -> State:
    if not cfg.parallel_block:
        raise ValueError(
            "hf_export: falcon checkpoints are parallel-attention; a "
            "sequential-block model's norm2 weights have no representation")
    if cfg.use_bias:
        raise ValueError(
            "hf_export: biased falcon-family models have no 7b-style "
            "checkpoint representation (falcon bias=false) — retrain "
            "without use_bias or export another family")
    if cfg.kv_heads != 1 or cfg.parallel_norms != 1:
        raise ValueError(
            "hf_export: only multi-query (kv_heads=1, single-norm) falcon "
            "models map onto the 7b-style fused QKV layout; grouped-KV / "
            "dual-norm falcon (new_decoder_architecture) is not supported")
    host: State = {
        "transformer.word_embeddings.weight": _t(params["embed"]["tok"]),
        "transformer.ln_f.weight": _t(params["final_norm"]["scale"]),
        "transformer.ln_f.bias": _t(params["final_norm"]["bias"]),
    }
    lay = params["layers"]
    a, m, n1 = lay["attn"], lay["mlp"], lay["norm1"]
    for i in range(cfg.n_layers):
        pre = f"transformer.h.{i}"
        # q | k | v rows re-fused ([out, in] orientation)
        host[f"{pre}.self_attention.query_key_value.weight"] = torch.cat(
            [_t(a[k][i]).T for k in ("wq", "wk", "wv")])
        host[f"{pre}.self_attention.dense.weight"] = _t(a["wo"][i]).T
        host[f"{pre}.mlp.dense_h_to_4h.weight"] = _t(m["w_up"][i]).T
        host[f"{pre}.mlp.dense_4h_to_h.weight"] = _t(m["w_down"][i]).T
        host[f"{pre}.input_layernorm.weight"] = _t(n1["scale"][i])
        host[f"{pre}.input_layernorm.bias"] = _t(n1["bias"][i])
    if not cfg.tie_embeddings and "lm_head" in params:
        host["lm_head.weight"] = _t(params["lm_head"]["w"]).T
    return host


def _export_qwen2_moe(cfg: TransformerConfig, params: Dict[str, Any]) -> State:
    """Inverse of the qwen2_moe import map: routed experts under
    mlp.experts.{e}, the shared expert and its sigmoid gate, the router at
    mlp.gate, qwen2-style q/k/v biases."""
    if not cfg.moe_experts:
        raise ValueError("hf_export: qwen2_moe export needs an MoE model "
                         "(moe_experts > 0)")
    if cfg.moe_use_residual:
        raise ValueError("hf_export: PR-MoE residual weights have no "
                         "qwen2_moe representation")
    if not cfg.moe_shared_expert:
        raise ValueError("hf_export: qwen2_moe checkpoints require a "
                         "shared expert (moe_shared_expert > 0); export "
                         "shared-expert-free MoE as model_type='mixtral'")
    if not cfg.qkv_bias:
        raise ValueError("hf_export: qwen2_moe checkpoints carry q/k/v "
                         "biases; retrain with qkv_bias=True (an absent "
                         "bias would crash the qwen2_moe importer)")
    host: State = {"model.embed_tokens.weight": _t(params["embed"]["tok"]),
                   "model.norm.weight": _t(params["final_norm"]["scale"])}
    if not cfg.tie_embeddings and "lm_head" in params:
        host["lm_head.weight"] = _t(params["lm_head"]["w"]).T
    lay = params["layers"]
    _emit_stacked(host, lay["attn"], [
        ("q_proj.weight", "wq", True), ("k_proj.weight", "wk", True),
        ("v_proj.weight", "wv", True), ("o_proj.weight", "wo", True),
        ("q_proj.bias", "bq", False), ("k_proj.bias", "bk", False),
        ("v_proj.bias", "bv", False)], "model.layers.{i}.self_attn.{hf}")
    _emit_stacked(host, lay["norm1"], [("weight", "scale", False)],
                  "model.layers.{i}.input_layernorm.{hf}")
    _emit_stacked(host, lay["norm2"], [("weight", "scale", False)],
                  "model.layers.{i}.post_attention_layernorm.{hf}")
    mlp = lay["mlp"]
    _emit_stacked(host, mlp, [
        ("gate.weight", "router", True),
        ("shared_expert.gate_proj.weight", "shared_w_gate", True),
        ("shared_expert.up_proj.weight", "shared_w_up", True),
        ("shared_expert.down_proj.weight", "shared_w_down", True),
        ("shared_expert_gate.weight", "shared_gate", True)], "model.layers.{i}.mlp.{hf}")
    for ours, theirs in {"w_gate": "gate_proj", "w_up": "up_proj",
                         "w_down": "down_proj"}.items():
        for i, full in _unstack(mlp[ours], transpose=False):  # [E, in, out]
            for e in range(full.shape[0]):
                host[f"model.layers.{i}.mlp.experts.{e}.{theirs}.weight"] = full[e].T
    return host


def hf_config_dict(cfg: TransformerConfig, model_type: str = "llama") -> Dict[str, Any]:
    """The HF ``config.json`` of ``cfg`` for ``model_type``."""
    if model_type == "gpt2":
        return {"model_type": "gpt2", "architectures": ["GPT2LMHeadModel"],
                "vocab_size": cfg.vocab_size, "n_embd": cfg.hidden_size,
                "n_layer": cfg.n_layers, "n_head": cfg.n_heads,
                "n_positions": cfg.max_seq_len, "n_inner": cfg.ffn_size,
                "layer_norm_epsilon": cfg.norm_eps}
    if model_type == "bert":
        return {"model_type": "bert", "architectures": ["BertForMaskedLM"],
                "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                "num_hidden_layers": cfg.n_layers,
                "num_attention_heads": cfg.n_heads,
                "intermediate_size": cfg.ffn_size,
                "max_position_embeddings": cfg.max_seq_len,
                "type_vocab_size": cfg.type_vocab_size,
                # our "gelu" is HF's tanh approximation ("gelu_new"),
                # "gelu_exact" HF's "gelu"
                "hidden_act": {"gelu_exact": "gelu", "gelu": "gelu_new",
                               "relu": "relu"}.get(cfg.activation, "gelu"),
                "layer_norm_eps": cfg.norm_eps, "tie_word_embeddings": True}
    if model_type == "opt":
        return {"model_type": "opt", "architectures": ["OPTForCausalLM"],
                "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                "num_hidden_layers": cfg.n_layers,
                "num_attention_heads": cfg.n_heads, "ffn_dim": cfg.ffn_size,
                "max_position_embeddings": cfg.max_seq_len,
                "do_layer_norm_before": True, "word_embed_proj_dim": cfg.hidden_size,
                "activation_function": ("relu" if cfg.activation == "relu"
                                        else "gelu_new" if cfg.activation == "gelu"
                                        else "gelu"),
                "tie_word_embeddings": bool(cfg.tie_embeddings)}
    if model_type == "phi":
        return {"model_type": "phi", "architectures": ["PhiForCausalLM"],
                "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                "num_hidden_layers": cfg.n_layers,
                "num_attention_heads": cfg.n_heads,
                "num_key_value_heads": cfg.kv_heads,
                "intermediate_size": cfg.ffn_size,
                "max_position_embeddings": cfg.max_seq_len,
                "partial_rotary_factor": cfg.rotary_pct,
                "layer_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
                "tie_word_embeddings": bool(cfg.tie_embeddings)}
    if model_type == "bloom":
        return {"model_type": "bloom", "architectures": ["BloomForCausalLM"],
                "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                "n_layer": cfg.n_layers, "n_head": cfg.n_heads,
                "seq_length": cfg.max_seq_len, "layer_norm_epsilon": cfg.norm_eps,
                "tie_word_embeddings": bool(cfg.tie_embeddings)}
    if model_type == "gpt_neox":
        return {"model_type": "gpt_neox", "architectures": ["GPTNeoXForCausalLM"],
                "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                "num_hidden_layers": cfg.n_layers,
                "num_attention_heads": cfg.n_heads,
                "intermediate_size": cfg.ffn_size,
                "max_position_embeddings": cfg.max_seq_len,
                "rotary_pct": cfg.rotary_pct, "rotary_emb_base": cfg.rope_theta,
                "use_parallel_residual": True,
                "hidden_act": "gelu" if cfg.activation == "gelu_exact" else "gelu_new",
                "layer_norm_eps": cfg.norm_eps,
                "tie_word_embeddings": bool(cfg.tie_embeddings)}
    if model_type == "falcon":
        return {"model_type": "falcon", "architectures": ["FalconForCausalLM"],
                "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                "num_hidden_layers": cfg.n_layers,
                "num_attention_heads": cfg.n_heads, "multi_query": True,
                "num_kv_heads": 1, "new_decoder_architecture": False,
                "parallel_attn": True, "bias": False,
                "max_position_embeddings": cfg.max_seq_len,
                "layer_norm_epsilon": cfg.norm_eps, "rope_theta": cfg.rope_theta,
                "tie_word_embeddings": bool(cfg.tie_embeddings)}
    arch = {"llama": "LlamaForCausalLM", "mistral": "MistralForCausalLM",
            "qwen2": "Qwen2ForCausalLM", "phi3": "Phi3ForCausalLM",
            "mixtral": "MixtralForCausalLM"}.get(model_type, "LlamaForCausalLM")
    out = {"model_type": model_type, "architectures": [arch],
           "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
           "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
           "num_key_value_heads": cfg.kv_heads,
           "intermediate_size": cfg.intermediate_size or cfg.ffn_size,
           "max_position_embeddings": cfg.max_seq_len,
           "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
           "tie_word_embeddings": bool(cfg.tie_embeddings)}
    if model_type == "mixtral":
        out["num_local_experts"] = cfg.moe_experts
        out["num_experts_per_tok"] = cfg.moe_top_k
    if model_type == "qwen2_moe":
        out.update(architectures=["Qwen2MoeForCausalLM"], num_experts=cfg.moe_experts,
                   num_experts_per_tok=cfg.moe_top_k, moe_intermediate_size=cfg.ffn_size,
                   shared_expert_intermediate_size=cfg.moe_shared_expert,
                   norm_topk_prob=bool(cfg.moe_norm_topk), decoder_sparse_step=1,
                   mlp_only_layers=[])
    if model_type == "phi3":
        # Phi3Config's default pad_token_id (32000) would exceed a small vocab
        out["pad_token_id"] = 0
    return out


def checkpoint_to_hf(ckpt_dir: str, tag: str, out_dir: str, cfg: TransformerConfig,
                     model_type: str = "llama", dtype: Optional[torch.dtype] = None) -> str:
    """A training checkpoint (the consolidated layout of
    ``checkpoint/saving.py``, the port's or the JAX engine's) -> an HF
    directory, without building an engine.  Reads only the ``.params``
    members (bf16 ones stored as ``uint16``): the fp32 master, or under
    offload the compute-dtype leaves.  The caller's ``cfg`` is checked
    against the tensors first, with the JAX exporter's messages.  The
    partitioned layout raises (ROADMAP Queue 1 #8)."""
    import re

    from .saving import META_FILE, MODEL_FILE, PARTITIONED_META, NpzReader, refuse_partitioned

    path = os.path.join(ckpt_dir, tag)
    if os.path.exists(os.path.join(path, PARTITIONED_META)):
        refuse_partitioned(f"checkpoint_to_hf({path})")
    with open(os.path.join(path, META_FILE)) as f:
        bf16 = set(json.load(f).get("bfloat16_keys", {}))
    params: Dict[str, Any] = {}
    reader = NpzReader(os.path.join(path, MODEL_FILE))
    try:
        for key in reader.keys():
            if not key.startswith(".params"):
                continue
            arr = reader.read(key)
            t = torch.from_numpy(arr)
            if key in bf16 or arr.dtype == np.uint16:  # stored bf16
                t = t.view(torch.bfloat16)
            node = params
            parts = re.findall(r"\['([^']+)'\]", key)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
    finally:
        reader.close()
    # the config is the caller's, not stored in the checkpoint: check it
    # against the tensors before mapping
    tok = params.get("embed", {}).get("tok")
    if tok is not None and tuple(tok.shape) != (cfg.vocab_size, cfg.hidden_size):
        raise ValueError(
            f"checkpoint embed table is {tuple(tok.shape)} but the supplied "
            f"config says (vocab={cfg.vocab_size}, hidden={cfg.hidden_size})"
            f" — pass the config the model was trained with (CLI: "
            f"--override vocab_size=... hidden_size=...)")
    wq = params.get("layers", {}).get("attn", {}).get("wq")
    if wq is not None and wq.shape[0] != cfg.n_layers:
        raise ValueError(
            f"checkpoint has {wq.shape[0]} layers but the supplied config "
            f"says n_layers={cfg.n_layers}")
    if ("lm_head" in params) != (not cfg.tie_embeddings):
        # a tied checkpoint exported as untied would leave lm_head random
        raise ValueError(
            f"checkpoint {'has' if 'lm_head' in params else 'lacks'} an "
            f"lm_head but the supplied config says tie_embeddings="
            f"{cfg.tie_embeddings} — pass --override tie_embeddings="
            f"{str('lm_head' not in params).lower()}")
    save_hf_checkpoint(out_dir, cfg, params, model_type, dtype=dtype)
    return out_dir


def save_hf_checkpoint(model_dir: str, cfg: TransformerConfig, params: Any,
                       model_type: str = "llama", dtype: Optional[torch.dtype] = None,
                       max_shard_bytes: Optional[int] = None) -> None:
    """Write a transformers-loadable checkpoint directory: ``config.json``
    and ``model.safetensors``, or with ``max_shard_bytes`` (and more bytes
    than that) the shards ``model-0000k-of-0000n.safetensors`` of at most
    that size each (one tensor past it alone) and their
    ``model.safetensors.index.json``.  ``dtype`` casts the floating
    tensors as they are written.

        save_hf_checkpoint("out/", cfg, engine.get_params())
    """
    os.makedirs(model_dir, exist_ok=True)
    state = export_hf_state(cfg, params, model_type)
    if dtype is not None:
        state = {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}
    sizes = {k: v.numel() * v.element_size() for k, v in state.items()}
    total = sum(sizes.values())
    if max_shard_bytes is None or total <= max_shard_bytes:
        write_safetensors(os.path.join(model_dir, "model.safetensors"), state)
    else:
        shards, cur, cur_bytes = [], {}, 0
        for k, v in state.items():
            if cur and cur_bytes + sizes[k] > max_shard_bytes:
                shards.append(cur)
                cur, cur_bytes = {}, 0
            cur[k] = v
            cur_bytes += sizes[k]
        shards.append(cur)
        weight_map = {}
        for j, shard in enumerate(shards):
            name = f"model-{j + 1:05d}-of-{len(shards):05d}.safetensors"
            write_safetensors(os.path.join(model_dir, name), shard)
            weight_map.update(dict.fromkeys(shard, name))
        with open(os.path.join(model_dir, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f,
                      indent=1)
    hf_cfg = hf_config_dict(cfg, model_type)
    # torch_dtype names what was written: the widest floating type
    floats = [v.dtype for v in state.values() if v.is_floating_point()]
    hf_cfg["torch_dtype"] = _HF_DTYPE[max(floats, key=lambda d: d.itemsize)
                                      if floats else torch.float32]
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=1)
    n = sum(v.numel() for v in state.values())
    logger.info(f"hf_export: wrote {n / 1e6:.1f}M params ({model_type}) to {model_dir}")


def _fuse_qkv_per_head(wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                       bq: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor, NH: int, D: int):
    """Inverse of ``hf_import._split_fused_qkv_per_head``: ``[in, NH*D]``
    weights (and ``[NH*D]`` biases) -> the per-head interleaved fused
    ``[NH*3*D, in]`` weight and its bias."""
    win = wq.shape[0]
    g = torch.stack([w.T.reshape(NH, D, win) for w in (wq, wk, wv)], dim=1)  # [NH, 3, D, in]
    fused_b = torch.stack([b.reshape(NH, D) for b in (bq, bk, bv)], dim=1)
    return g.reshape(NH * 3 * D, win), fused_b.reshape(NH * 3 * D)


def _export_neox_style_layers(cfg: TransformerConfig, params: Dict[str, Any], host: State,
                              layer_fmt: str, attn: str) -> State:
    """The bloom/gpt-neox layers (inverse of ``hf_import._import_neox_style``)."""
    lay = params["layers"]
    a, m = lay["attn"], lay["mlp"]
    for i in range(cfg.n_layers):
        pre = layer_fmt.format(i=i)
        fw, fb = _fuse_qkv_per_head(*(_t(a[k][i]) for k in ("wq", "wk", "wv", "bq", "bk", "bv")),
                                    cfg.n_heads, cfg.head_dim)
        host[f"{pre}{attn}.query_key_value.weight"] = fw
        host[f"{pre}{attn}.query_key_value.bias"] = fb
        host[f"{pre}{attn}.dense.weight"] = _t(a["wo"][i]).T
        host[f"{pre}{attn}.dense.bias"] = _t(a["bo"][i])
        host[f"{pre}mlp.dense_h_to_4h.weight"] = _t(m["w_up"][i]).T
        host[f"{pre}mlp.dense_h_to_4h.bias"] = _t(m["b_up"][i])
        host[f"{pre}mlp.dense_4h_to_h.weight"] = _t(m["w_down"][i]).T
        host[f"{pre}mlp.dense_4h_to_h.bias"] = _t(m["b_down"][i])
        for ours, theirs in (("norm1", "input_layernorm"),
                             ("norm2", "post_attention_layernorm")):
            host[f"{pre}{theirs}.weight"] = _t(lay[ours]["scale"][i])
            host[f"{pre}{theirs}.bias"] = _t(lay[ours]["bias"][i])
    return host


def _export_bloom(cfg: TransformerConfig, params: Dict[str, Any]) -> State:
    emb = params["embed"]
    host: State = {
        "transformer.word_embeddings.weight": _t(emb["tok"]),
        "transformer.word_embeddings_layernorm.weight": _t(emb["norm"]["scale"]),
        "transformer.word_embeddings_layernorm.bias": _t(emb["norm"]["bias"]),
        "transformer.ln_f.weight": _t(params["final_norm"]["scale"]),
        "transformer.ln_f.bias": _t(params["final_norm"]["bias"]),
    }
    _export_neox_style_layers(cfg, params, host, "transformer.h.{i}.", "self_attention")
    if not cfg.tie_embeddings and "lm_head" in params:
        host["lm_head.weight"] = _t(params["lm_head"]["w"]).T
    return host


def _export_gpt_neox(cfg: TransformerConfig, params: Dict[str, Any]) -> State:
    host: State = {
        "gpt_neox.embed_in.weight": _t(params["embed"]["tok"]),
        "gpt_neox.final_layer_norm.weight": _t(params["final_norm"]["scale"]),
        "gpt_neox.final_layer_norm.bias": _t(params["final_norm"]["bias"]),
    }
    _export_neox_style_layers(cfg, params, host, "gpt_neox.layers.{i}.", "attention")
    if not cfg.tie_embeddings and "lm_head" in params:
        host["embed_out.weight"] = _t(params["lm_head"]["w"]).T
    return host
