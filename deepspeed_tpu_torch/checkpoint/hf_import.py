"""Import Hugging Face checkpoint directories (the port's counterpart of
``deepspeed_tpu/checkpoint/hf_import.py``).

One name-mapping importer per family produces the JAX parameter tree
(``init_transformer_params`` layout: nested dicts, layers stacked on a
leading ``[L, ...]`` axis, matmul weights ``[in, out]``) with CPU tensors
as leaves, in the checkpoint's own dtype; ``convert.params_from_numpy``
moves it to the device layer by layer, so a bf16 checkpoint is never
widened on the host.  ``load_hf_model`` pops each per-layer tensor from
the state dict as it copies it into its stacked leaf, so a load holds
the checkpoint's bytes about once in host RAM (``chip_smoke.py`` reads
the resident set during falcon-7b's load).  Every entry point (the training engine and both
inference engines) takes that tree.

Formats: ``model.safetensors`` and its sharded index, read by a native
reader (8-byte header length, JSON header, raw little-endian buffer;
BF16 read as 16-bit words viewed as ``torch.bfloat16``), and
``pytorch_model*.bin`` read with ``torch.load(weights_only=True)``.
The JAX reader maps the file and views it; this one reads each tensor
into its own buffer, which leaves no view into a read-only mapping in the
returned tree.

Families: llama / mistral / qwen2 / qwen2-moe / mixtral / gpt2 / opt / phi
/ phi3 / falcon / bloom / gpt-neox / bert, with the JAX importer's
conventions: ``nn.Linear`` weights ``[out, in]`` are transposed (GPT-2's
Conv1D is ``[in, out]`` already); llama-family RoPE is rotate-half, as
the core's; fused QKV weights are split per family.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import torch

from ..models.convert import _leaves
from ..models.transformer import TransformerConfig
from ..utils.logging import logger

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}

State = Dict[str, torch.Tensor]


def read_safetensors(path: str) -> State:
    """Every tensor of a safetensors file, each read into a new CPU tensor
    of its stored dtype."""
    out: State = {}
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        base = 8 + hlen
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            start, end = meta["data_offsets"]
            t = torch.empty(meta["shape"], dtype=_ST_DTYPES[meta["dtype"]])
            buf = t.reshape(-1).view(torch.uint8).numpy()
            if buf.nbytes != end - start:
                raise ValueError(f"{path}: {name} holds {end - start} bytes, "
                                 f"its shape and dtype {buf.nbytes}")
            f.seek(base + start)
            if f.readinto(buf) != buf.nbytes:
                raise ValueError(f"{path}: {name} is cut short")
            out[name] = t
    return out


def _shards(index_path: str):
    with open(index_path) as f:
        return sorted(set(json.load(f)["weight_map"].values()))


def load_state_dict(model_dir: str) -> State:
    """All weights of an HF checkpoint directory as CPU tensors."""
    st_index = os.path.join(model_dir, "model.safetensors.index.json")
    pt_index = os.path.join(model_dir, "pytorch_model.bin.index.json")
    if os.path.exists(st_index):
        sd: State = {}
        for shard in _shards(st_index):
            sd.update(read_safetensors(os.path.join(model_dir, shard)))
        return sd
    single_st = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(single_st):
        return read_safetensors(single_st)
    if os.path.exists(pt_index):
        shards = _shards(pt_index)
    elif os.path.exists(os.path.join(model_dir, "pytorch_model.bin")):
        shards = ["pytorch_model.bin"]
    else:
        raise FileNotFoundError(
            f"no model.safetensors[.index.json] or pytorch_model.bin "
            f"in {model_dir}")
    sd = {}
    for shard in shards:
        sd.update(torch.load(os.path.join(model_dir, shard), map_location="cpu",
                             weights_only=True))
    return sd


def config_from_hf(model_dir_or_cfg: Any) -> TransformerConfig:
    """HF ``config.json`` (a directory or the parsed dict) ->
    :class:`TransformerConfig`, with the JAX importer's refusals."""
    if isinstance(model_dir_or_cfg, dict):
        c = model_dir_or_cfg
    else:
        with open(os.path.join(model_dir_or_cfg, "config.json")) as f:
            c = json.load(f)
    mtype = c.get("model_type", "llama")
    if mtype == "gpt2":
        h = c["n_embd"]
        return TransformerConfig(
            vocab_size=c["vocab_size"], hidden_size=h,
            n_layers=c["n_layer"], n_heads=c["n_head"],
            intermediate_size=c.get("n_inner") or 4 * h,
            max_seq_len=c.get("n_positions", 1024), norm="layernorm",
            activation="gelu", position="learned", causal=True,
            use_bias=True, tie_embeddings=True,
            norm_eps=c.get("layer_norm_epsilon", 1e-5))
    if mtype == "opt":
        # pre-norm decoder, learned positions (the +2 offset is dropped at
        # weight import), relu FFN
        if not c.get("do_layer_norm_before", True):
            raise ValueError("hf_import: post-layernorm OPT variants "
                             "(do_layer_norm_before=false, 350m) are not "
                             "supported by the pre-norm runtime")
        if c.get("word_embed_proj_dim", c["hidden_size"]) != c["hidden_size"]:
            raise ValueError(
                "hf_import: OPT variants with an embedding projection "
                "(word_embed_proj_dim != hidden_size) are not supported — "
                "project_in/project_out have no runtime counterpart")
        act = c.get("activation_function", "relu")
        if act not in ("relu", "gelu", "gelu_new"):
            raise ValueError(f"hf_import: OPT activation_function '{act}' "
                             f"not supported (relu/gelu)")
        return TransformerConfig(
            vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
            n_layers=c["num_hidden_layers"],
            n_heads=c["num_attention_heads"],
            intermediate_size=c["ffn_dim"],
            max_seq_len=c.get("max_position_embeddings", 2048),
            # HF OPT's 'gelu' is the exact erf form
            norm="layernorm",
            activation=("relu" if act == "relu"
                        else "gelu" if act == "gelu_new" else "gelu_exact"),
            position="learned", causal=True, use_bias=True,
            tie_embeddings=bool(c.get("tie_word_embeddings", True)))
    if mtype == "phi":
        if c.get("qk_layernorm"):
            raise ValueError("hf_import: phi variants with qk_layernorm "
                             "are not supported — the q/k layernorm "
                             "weights have no runtime counterpart")
        return TransformerConfig(
            vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
            n_layers=c["num_hidden_layers"],
            n_heads=c["num_attention_heads"],
            n_kv_heads=c.get("num_key_value_heads") or c["num_attention_heads"],
            intermediate_size=c["intermediate_size"],
            max_seq_len=c.get("max_position_embeddings", 2048),
            norm="layernorm", activation="gelu", position="rope",
            causal=True, use_bias=True, parallel_block=True,
            rotary_pct=float(c.get("partial_rotary_factor", 0.5)),
            norm_eps=c.get("layer_norm_eps", 1e-5),
            rope_theta=float(c.get("rope_theta", 10000.0)),
            tie_embeddings=bool(c.get("tie_word_embeddings", False)))
    if mtype == "bert":
        act = c.get("hidden_act", "gelu")
        if act not in ("gelu", "gelu_new", "relu"):
            raise ValueError(f"hf_import: bert hidden_act '{act}' "
                             f"not supported")
        if c.get("position_embedding_type", "absolute") != "absolute":
            raise ValueError(
                "hf_import: relative-position BERT variants "
                "(position_embedding_type != absolute) are not supported — "
                "their attention bias has no runtime counterpart")
        return TransformerConfig(
            vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
            n_layers=c["num_hidden_layers"],
            n_heads=c["num_attention_heads"],
            intermediate_size=c["intermediate_size"],
            max_seq_len=c.get("max_position_embeddings", 512),
            norm="layernorm",
            activation={"gelu": "gelu_exact", "gelu_new": "gelu",
                        "relu": "relu"}[act],
            position="learned", causal=False, use_bias=True,
            tie_embeddings=True, post_norm=True,
            type_vocab_size=c.get("type_vocab_size", 2),
            norm_eps=c.get("layer_norm_eps", 1e-12))
    if mtype == "bloom":
        if c.get("apply_residual_connection_post_layernorm"):
            raise ValueError(
                "hf_import: bloom variants with "
                "apply_residual_connection_post_layernorm are not "
                "supported — the runtime's residual reads the raw stream")
        h = c["hidden_size"]
        return TransformerConfig(
            vocab_size=c["vocab_size"], hidden_size=h,
            n_layers=c["n_layer"], n_heads=c["n_head"],
            intermediate_size=4 * h,
            max_seq_len=c.get("seq_length", 2048),  # ALiBi: no position table
            norm="layernorm", activation="gelu",  # BloomGelu: tanh approximation
            position="alibi", causal=True, use_bias=True, embed_norm=True,
            tie_embeddings=bool(c.get("tie_word_embeddings", True)),
            norm_eps=c.get("layer_norm_epsilon", 1e-5))
    if mtype == "gpt_neox":
        if not c.get("use_parallel_residual", True):
            raise ValueError("hf_import: gpt_neox with "
                             "use_parallel_residual=false (sequential "
                             "residual) is not supported by the "
                             "parallel-block runtime")
        return TransformerConfig(
            vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
            n_layers=c["num_hidden_layers"],
            n_heads=c["num_attention_heads"],
            intermediate_size=c["intermediate_size"],
            max_seq_len=c.get("max_position_embeddings", 2048),
            norm="layernorm",
            activation={"gelu": "gelu_exact", "gelu_new": "gelu",
                        "gelu_fast": "gelu"}.get(c.get("hidden_act", "gelu"), "gelu_exact"),
            position="rope", rotary_pct=float(c.get("rotary_pct", 0.25)),
            rope_theta=float(c.get("rotary_emb_base", 10000.0)),
            causal=True, use_bias=True, parallel_block=True, parallel_norms=2,
            tie_embeddings=bool(c.get("tie_word_embeddings", False)),
            norm_eps=c.get("layer_norm_eps", 1e-5))
    if mtype == "falcon":
        if not c.get("parallel_attn", True):
            raise ValueError("hf_import: sequential-attention falcon "
                             "variants are not supported by the "
                             "parallel-block runtime")
        new_arch = bool(c.get("new_decoder_architecture"))
        if not new_arch and not c.get("multi_query", True):
            # old-arch multi_query=false interleaves q/k/v per head inside
            # the fused weight; the grouped split would misread it
            raise ValueError("hf_import: falcon multi_query=false "
                             "(per-head-interleaved fused QKV) is not "
                             "supported — 7b-style multi-query is")
        if c.get("alibi"):
            raise ValueError("hf_import: alibi-position falcon variants "
                             "are not supported (runtime is rotary)")
        if c.get("bias"):
            raise ValueError("hf_import: biased falcon variants are not "
                             "supported (7b/40b-style bias=false is)")
        nh = c["num_attention_heads"]
        # the new architecture defaults to separate ln_attn/ln_mlp;
        # falcon-11B-style sets num_ln_in_parallel_attn=1
        n_ln = int(c.get("num_ln_in_parallel_attn") or (2 if new_arch else 1))
        return TransformerConfig(
            vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
            n_layers=c["num_hidden_layers"], n_heads=nh,
            parallel_norms=n_ln,
            n_kv_heads=c.get("num_kv_heads", nh) if new_arch else 1,
            intermediate_size=4 * c["hidden_size"],
            max_seq_len=c.get("max_position_embeddings", 2048),
            norm="layernorm", activation="gelu_exact", position="rope",
            causal=True, parallel_block=True,
            norm_eps=c.get("layer_norm_epsilon", 1e-5),
            rope_theta=float(c.get("rope_theta", 10000.0)),
            tie_embeddings=bool(c.get("tie_word_embeddings", True)))
    kv = c.get("num_key_value_heads", c["num_attention_heads"])
    cfg = TransformerConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        n_layers=c["num_hidden_layers"], n_heads=c["num_attention_heads"],
        n_kv_heads=kv, intermediate_size=c["intermediate_size"],
        max_seq_len=c.get("max_position_embeddings", 2048),
        norm="rmsnorm", activation="swiglu", position="rope", causal=True,
        norm_eps=c.get("rms_norm_eps", 1e-6),
        rope_theta=float(c.get("rope_theta", 10000.0)),
        tie_embeddings=bool(c.get("tie_word_embeddings", False)))
    if mtype == "mixtral":
        cfg.moe_experts = c["num_local_experts"]
        cfg.moe_top_k = c.get("num_experts_per_tok", 2)
    if mtype == "qwen2":
        cfg.qkv_bias = True
    if mtype == "phi3" and c.get("rope_scaling"):
        # long-context phi3 variants use longrope (per-dim scale tables)
        raise ValueError("hf_import: phi3 rope_scaling (longrope) is "
                         "unsupported; use a 4k-context phi3 variant")
    if mtype == "qwen2_moe":
        if c.get("decoder_sparse_step", 1) != 1 or c.get("mlp_only_layers"):
            raise ValueError(
                "hf_import: qwen2_moe variants mixing dense and sparse "
                "layers (decoder_sparse_step != 1 / mlp_only_layers) are "
                "unsupported — every layer must be MoE")
        cfg.qkv_bias = True
        cfg.moe_experts = c["num_experts"]
        cfg.moe_top_k = c.get("num_experts_per_tok", 4)
        # the experts use moe_intermediate_size, not the dense width
        cfg.intermediate_size = c["moe_intermediate_size"]
        cfg.moe_shared_expert = c.get("shared_expert_intermediate_size", 0)
        cfg.moe_norm_topk = bool(c.get("norm_topk_prob", False))
        cfg.moe_drop_tokens = False  # exact per-token routing
    return cfg


def _stack_parts(state: State, names, split, transpose: bool = False) -> list:
    """One ``[len(names), ...]`` tensor for each part that ``split`` cuts
    from the tensor named ``names[i]``.  Each named tensor is popped from
    ``state`` once its parts are copied into place, so the importers turn
    a state dict into the stacked tree with one copy of the weights on the
    host and one layer more.  ``transpose``: each is returned as the view
    with its last two axes swapped (``nn.Linear``'s ``[out, in]`` read as
    ``[in, out]``): the host copies rows as stored, and
    ``convert.params_from_numpy`` transposes them on the device."""
    outs = None
    for i, name in enumerate(names):
        parts = split(state.pop(name))
        if outs is None:
            outs = [torch.empty((len(names), *t.shape), dtype=t.dtype) for t in parts]
        for out, t in zip(outs, parts):
            out[i].copy_(t)
    return [out.mT if transpose else out for out in outs]


def _stack(state: State, pattern: str, n: int, transpose: bool = True) -> torch.Tensor:
    return _stack_parts(state, [pattern.format(i=i) for i in range(n)], lambda t: [t],
                        transpose)[0]


def _experts(state: State, fmt: str, L: int, E: int) -> torch.Tensor:
    """``[L, E, in, out]`` from per-expert ``[out, in]`` weights named
    ``fmt.format(i=layer, e=expert)``."""
    names = [fmt.format(i=i, e=e) for i in range(L) for e in range(E)]
    flat = _stack_parts(state, names, lambda t: [t])[0]
    return flat.view(L, E, *flat.shape[1:]).mT


def import_hf_params(cfg: TransformerConfig, state: State,
                     model_type: str = "llama") -> Dict[str, Any]:
    """HF state dict -> the ``init_transformer_params`` layout (``state``
    is left as it was)."""
    return _import(cfg, dict(state), model_type)


def _import(cfg: TransformerConfig, state: State, model_type: str) -> Dict[str, Any]:
    """:func:`import_hf_params` consuming ``state``: every per-layer tensor
    is popped from it as it is stacked."""
    L = cfg.n_layers
    family = {"gpt2": _import_gpt2, "opt": _import_opt, "phi": _import_phi,
              "falcon": _import_falcon, "bloom": _import_bloom,
              "gpt_neox": _import_gpt_neox, "bert": _import_bert}.get(model_type)
    if family is not None:
        return family(cfg, state)
    if model_type == "phi3":
        # llama-shaped with fused projections: qkv_proj rows are [q | k | v]
        # and gate_up_proj rows [gate | up]; split them into llama names
        qd = cfg.n_heads * cfg.head_dim
        kvd = cfg.kv_heads * cfg.head_dim
        for i in range(L):
            pre = f"model.layers.{i}"
            qkv = state.pop(f"{pre}.self_attn.qkv_proj.weight")
            state[f"{pre}.self_attn.q_proj.weight"] = qkv[:qd]
            state[f"{pre}.self_attn.k_proj.weight"] = qkv[qd:qd + kvd]
            state[f"{pre}.self_attn.v_proj.weight"] = qkv[qd + kvd:]
            gu = state.pop(f"{pre}.mlp.gate_up_proj.weight")
            state[f"{pre}.mlp.gate_proj.weight"] = gu[:cfg.ffn_size]
            state[f"{pre}.mlp.up_proj.weight"] = gu[cfg.ffn_size:]
    p: Dict[str, Any] = {
        "embed": {"tok": state["model.embed_tokens.weight"]},
        "final_norm": {"scale": state["model.norm.weight"]},
    }
    attn = {ours: _stack(state, f"model.layers.{{i}}.self_attn.{hf}_proj.weight", L)
            for ours, hf in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o"))}
    if cfg.qkv_bias:  # qwen2
        for ours, hf in (("bq", "q"), ("bk", "k"), ("bv", "v")):
            attn[ours] = _stack(state, f"model.layers.{{i}}.self_attn.{hf}_proj.bias", L,
                                transpose=False)
    layers: Dict[str, Any] = {
        "attn": attn,
        "norm1": {"scale": _stack(state, "model.layers.{i}.input_layernorm.weight", L,
                                  transpose=False)},
        "norm2": {"scale": _stack(state, "model.layers.{i}.post_attention_layernorm.weight",
                                  L, transpose=False)},
    }
    if model_type == "qwen2_moe":
        E = cfg.moe_experts
        pre = "model.layers.{i}.mlp."
        layers["mlp"] = {
            "router": _stack(state, pre + "gate.weight", L),
            "w_gate": _experts(state, pre + "experts.{e}.gate_proj.weight", L, E),
            "w_up": _experts(state, pre + "experts.{e}.up_proj.weight", L, E),
            "w_down": _experts(state, pre + "experts.{e}.down_proj.weight", L, E),
            # the always-on shared expert and its per-token sigmoid gate
            "shared_w_gate": _stack(state, pre + "shared_expert.gate_proj.weight", L),
            "shared_w_up": _stack(state, pre + "shared_expert.up_proj.weight", L),
            "shared_w_down": _stack(state, pre + "shared_expert.down_proj.weight", L),
            "shared_gate": _stack(state, pre + "shared_expert_gate.weight", L),
        }
    elif cfg.moe_experts > 0:  # mixtral
        E = cfg.moe_experts
        pre = "model.layers.{i}.block_sparse_moe."
        layers["mlp"] = {
            "router": _stack(state, pre + "gate.weight", L),
            "w_gate": _experts(state, pre + "experts.{e}.w1.weight", L, E),
            "w_down": _experts(state, pre + "experts.{e}.w2.weight", L, E),
            "w_up": _experts(state, pre + "experts.{e}.w3.weight", L, E),
        }
    else:
        layers["mlp"] = {ours: _stack(state, f"model.layers.{{i}}.mlp.{hf}_proj.weight", L)
                         for ours, hf in (("w_gate", "gate"), ("w_up", "up"),
                                          ("w_down", "down"))}
    p["layers"] = layers
    if not cfg.tie_embeddings:
        key = "lm_head.weight" if "lm_head.weight" in state else "model.embed_tokens.weight"
        p["lm_head"] = {"w": state[key].T}
    return p


def _import_gpt2(cfg: TransformerConfig, state: State) -> Dict[str, Any]:
    L = cfg.n_layers

    def st(name):  # Conv1D stores [in, out]: no transpose anywhere
        return _stack(state, "transformer.h.{i}." + name, L, transpose=False)

    def qkv(name):  # c_attn's [.., 3H] columns are [q | k | v]
        return _stack_parts(state, [f"transformer.h.{i}.attn.c_attn.{name}" for i in range(L)],
                            lambda t: torch.chunk(t, 3, dim=-1))

    wq, wk, wv = qkv("weight")
    bq, bk, bv = qkv("bias")
    return {
        "embed": {"tok": state["transformer.wte.weight"],
                  "pos": state["transformer.wpe.weight"]},
        "final_norm": {"scale": state["transformer.ln_f.weight"],
                       "bias": state["transformer.ln_f.bias"]},
        "layers": {
            "attn": {"wq": wq, "wk": wk, "wv": wv, "bq": bq, "bk": bk, "bv": bv,
                     "wo": st("attn.c_proj.weight"), "bo": st("attn.c_proj.bias")},
            "mlp": {"w_up": st("mlp.c_fc.weight"), "b_up": st("mlp.c_fc.bias"),
                    "w_down": st("mlp.c_proj.weight"), "b_down": st("mlp.c_proj.bias")},
            "norm1": {"scale": st("ln_1.weight"), "bias": st("ln_1.bias")},
            "norm2": {"scale": st("ln_2.weight"), "bias": st("ln_2.bias")},
        },
    }


def _linear_layers(state: State, fmt: str, L: int, spec) -> Dict[str, torch.Tensor]:
    """``{ours: stacked}`` for (ours, hf name) pairs of a ``[L, ...]``
    family: weights transposed, biases (names ending ``bias``) not."""
    return {ours: _stack(state, fmt + hf, L, transpose=not hf.endswith("bias"))
            for ours, hf in spec}


def _norm_pair(state: State, fmt: str, L: int) -> Dict[str, torch.Tensor]:
    return {"scale": _stack(state, fmt + ".weight", L, transpose=False),
            "bias": _stack(state, fmt + ".bias", L, transpose=False)}


def _import_opt(cfg: TransformerConfig, state: State) -> Dict[str, Any]:
    """OPTForCausalLM: pre-norm decoder; ``embed_positions`` carries a +2
    padding offset, so rows 0-1 are dropped and ``positions = arange(S)``
    index the table the way OPT's ``position + 2`` does."""
    L, pre = cfg.n_layers, "model.decoder"
    fmt = pre + ".layers.{i}."
    p: Dict[str, Any] = {
        "embed": {"tok": state[f"{pre}.embed_tokens.weight"],
                  "pos": state[f"{pre}.embed_positions.weight"][2:]},
        "final_norm": {"scale": state[f"{pre}.final_layer_norm.weight"],
                       "bias": state[f"{pre}.final_layer_norm.bias"]},
        "layers": {
            "attn": _linear_layers(state, fmt + "self_attn.", L, (
                ("wq", "q_proj.weight"), ("wk", "k_proj.weight"), ("wv", "v_proj.weight"),
                ("wo", "out_proj.weight"), ("bq", "q_proj.bias"), ("bk", "k_proj.bias"),
                ("bv", "v_proj.bias"), ("bo", "out_proj.bias"))),
            "mlp": _linear_layers(state, fmt, L, (
                ("w_up", "fc1.weight"), ("b_up", "fc1.bias"),
                ("w_down", "fc2.weight"), ("b_down", "fc2.bias"))),
            "norm1": _norm_pair(state, fmt + "self_attn_layer_norm", L),
            "norm2": _norm_pair(state, fmt + "final_layer_norm", L),
        },
    }
    if not cfg.tie_embeddings and "lm_head.weight" in state:
        p["lm_head"] = {"w": state["lm_head.weight"].T}
    return p


def _import_phi(cfg: TransformerConfig, state: State) -> Dict[str, Any]:
    """PhiForCausalLM: parallel attention + MLP sharing one input
    layernorm, partial rotary, biased projections and a biased head."""
    L, fmt = cfg.n_layers, "model.layers.{i}."
    p: Dict[str, Any] = {
        "embed": {"tok": state["model.embed_tokens.weight"]},
        "final_norm": {"scale": state["model.final_layernorm.weight"],
                       "bias": state["model.final_layernorm.bias"]},
        "layers": {
            "attn": _linear_layers(state, fmt + "self_attn.", L, (
                ("wq", "q_proj.weight"), ("wk", "k_proj.weight"), ("wv", "v_proj.weight"),
                ("wo", "dense.weight"), ("bq", "q_proj.bias"), ("bk", "k_proj.bias"),
                ("bv", "v_proj.bias"), ("bo", "dense.bias"))),
            "mlp": _linear_layers(state, fmt + "mlp.", L, (
                ("w_up", "fc1.weight"), ("b_up", "fc1.bias"),
                ("w_down", "fc2.weight"), ("b_down", "fc2.bias"))),
            "norm1": _norm_pair(state, fmt + "input_layernorm", L),
        },
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": state["lm_head.weight"].T, "b": state["lm_head.bias"]}
    return p


def _import_bert(cfg: TransformerConfig, state: State) -> Dict[str, Any]:
    """BertForMaskedLM: post-norm encoder — attention.output.LayerNorm is
    the post-attention norm (norm1), output.LayerNorm the post-FFN norm
    (norm2); the embeddings sum word, position and token type, then a
    LayerNorm; the MLM head is dense + activation + LayerNorm + tied
    decoder + bias (cls.predictions)."""
    L, fmt = cfg.n_layers, "bert.encoder.layer.{i}."
    e = "bert.embeddings."
    p: Dict[str, Any] = {
        "embed": {
            "tok": state[e + "word_embeddings.weight"],
            "pos": state[e + "position_embeddings.weight"],
            "type": state[e + "token_type_embeddings.weight"],
            "norm": {"scale": state[e + "LayerNorm.weight"],
                     "bias": state[e + "LayerNorm.bias"]},
        },
        "layers": {
            "attn": _linear_layers(state, fmt + "attention.", L, (
                ("wq", "self.query.weight"), ("wk", "self.key.weight"),
                ("wv", "self.value.weight"), ("wo", "output.dense.weight"),
                ("bq", "self.query.bias"), ("bk", "self.key.bias"),
                ("bv", "self.value.bias"), ("bo", "output.dense.bias"))),
            "mlp": _linear_layers(state, fmt, L, (
                ("w_up", "intermediate.dense.weight"), ("b_up", "intermediate.dense.bias"),
                ("w_down", "output.dense.weight"), ("b_down", "output.dense.bias"))),
            "norm1": _norm_pair(state, fmt + "attention.output.LayerNorm", L),
            "norm2": _norm_pair(state, fmt + "output.LayerNorm", L),
        },
    }
    if "cls.predictions.transform.dense.weight" in state:
        t = "cls.predictions.transform."
        p["mlm_head"] = {
            "dense_w": state[t + "dense.weight"].T,
            "dense_b": state[t + "dense.bias"],
            "norm_scale": state[t + "LayerNorm.weight"],
            "norm_bias": state[t + "LayerNorm.bias"],
            "bias": state["cls.predictions.bias"],
        }
    return p


def _import_falcon(cfg: TransformerConfig, state: State) -> Dict[str, Any]:
    """FalconForCausalLM.  The fused ``query_key_value`` rows are grouped
    per KV head as ``[q_1 .. q_{NH/KVH}, k, v]``; with one KV head (7b's
    multi-query) that is the block layout, so one split covers both
    architectures.  The new architecture's separate ``ln_attn``/``ln_mlp``
    become norm1/norm2, as the config (not the keys) says."""
    L, NH, KVH, D = cfg.n_layers, cfg.n_heads, cfg.kv_heads, cfg.head_dim

    def split(w):  # q, k, v rows
        g = w.reshape(KVH, NH // KVH + 2, D, w.shape[-1])
        return [g[:, :-2].reshape(NH * D, -1), g[:, -2].reshape(KVH * D, -1),
                g[:, -1].reshape(KVH * D, -1)]

    wq, wk, wv = _stack_parts(
        state, [f"transformer.h.{i}.self_attention.query_key_value.weight" for i in range(L)],
        split, transpose=True)
    new_arch = cfg.parallel_norms >= 2
    fmt = "transformer.h.{i}."
    p: Dict[str, Any] = {
        "embed": {"tok": state["transformer.word_embeddings.weight"]},
        "final_norm": {"scale": state["transformer.ln_f.weight"],
                       "bias": state["transformer.ln_f.bias"]},
        "layers": {
            "attn": {"wq": wq, "wk": wk, "wv": wv,
                     "wo": _stack(state, fmt + "self_attention.dense.weight", L)},
            "mlp": {"w_up": _stack(state, fmt + "mlp.dense_h_to_4h.weight", L),
                    "w_down": _stack(state, fmt + "mlp.dense_4h_to_h.weight", L)},
            "norm1": _norm_pair(state, fmt + ("ln_attn" if new_arch else "input_layernorm"),
                                L),
        },
    }
    if new_arch:
        p["layers"]["norm2"] = _norm_pair(state, fmt + "ln_mlp", L)
    if not cfg.tie_embeddings and "lm_head.weight" in state:
        p["lm_head"] = {"w": state["lm_head.weight"].T}
    return p


def load_hf_model(model_dir: str, dtype: torch.dtype = None
                  ) -> Tuple[TransformerConfig, Dict[str, Any]]:
    """A checkpoint directory -> (config, parameter tree of CPU tensors)
    ready for the training or inference engines; floating leaves in
    ``dtype`` (None: the config's, fp32)::

        cfg, params = load_hf_model("/path/to/llama-2-7b", torch.bfloat16)
        engine = InferenceEngineV2(causal_lm_spec(cfg), params=params)
    """
    with open(os.path.join(model_dir, "config.json")) as f:
        raw = json.load(f)
    cfg = config_from_hf(raw)
    model_type = raw.get("model_type", "llama")
    # the state dict is consumed as it is stacked, and each leaf replaced
    # by its cast in place: the host holds the weights about once
    params = _import(cfg, load_state_dict(model_dir), model_type)
    dt = dtype or cfg.dtype

    def cast(node):
        for k, v in node.items():
            node[k] = cast(v) if isinstance(v, dict) else (
                v.to(dt) if v.is_floating_point() else v)
        return node

    cast(params)
    n = sum(t.numel() for t in _leaves(params))
    logger.info(f"hf_import: loaded {n / 1e6:.1f}M params ({model_type}) from {model_dir}")
    return cfg, params


def _split_fused_qkv_per_head(t: torch.Tensor, NH: int, D: int) -> list:
    """HF bloom/gpt-neox fused ``query_key_value`` weight or bias: rows are
    per-head ``[q_h, k_h, v_h]`` triples, layout ``(NH, 3, D, ...)``.
    Returns the q, k and v rows: weights ``[NH*D, in]``, biases
    ``[NH*D]``."""
    g = t.reshape(NH, 3, D, *t.shape[1:])
    return [g[:, j].reshape(NH * D, *t.shape[1:]) for j in range(3)]


def _import_neox_style(cfg: TransformerConfig, state: State, layer_fmt: str,
                       attn: str) -> Dict[str, Any]:
    """The bloom/gpt-neox layers: per-head fused QKV split,
    dense_h_to_4h/dense_4h_to_h MLP, input/post-attention layernorms.
    ``layer_fmt``: e.g. "transformer.h.{i}."; ``attn``: the attention
    module's name ("self_attention" / "attention")."""
    L, NH, D = cfg.n_layers, cfg.n_heads, cfg.head_dim
    fused = [layer_fmt.format(i=i) + attn + ".query_key_value" for i in range(L)]
    out = {"attn": {}}
    for kind, names in ((".weight", ("wq", "wk", "wv")), (".bias", ("bq", "bk", "bv"))):
        out["attn"].update(zip(names, _stack_parts(
            state, [f + kind for f in fused], lambda t: _split_fused_qkv_per_head(t, NH, D),
            transpose=kind == ".weight")))
    out["attn"].update(_linear_layers(state, layer_fmt + attn + ".dense.", L, (
        ("wo", "weight"), ("bo", "bias"))))
    out["mlp"] = _linear_layers(state, layer_fmt + "mlp.", L, (
        ("w_up", "dense_h_to_4h.weight"), ("b_up", "dense_h_to_4h.bias"),
        ("w_down", "dense_4h_to_h.weight"), ("b_down", "dense_4h_to_h.bias")))
    out["norm1"] = _norm_pair(state, layer_fmt + "input_layernorm", L)
    out["norm2"] = _norm_pair(state, layer_fmt + "post_attention_layernorm", L)
    return out


def _import_bloom(cfg: TransformerConfig, state: State) -> Dict[str, Any]:
    """BloomForCausalLM: ALiBi (no position table), per-head fused QKV,
    word_embeddings_layernorm, biases everywhere, the head tied unless the
    checkpoint carries its own ``lm_head.weight``."""
    p = {
        "embed": {"tok": state["transformer.word_embeddings.weight"],
                  "norm": {"scale": state["transformer.word_embeddings_layernorm.weight"],
                           "bias": state["transformer.word_embeddings_layernorm.bias"]}},
        "final_norm": {"scale": state["transformer.ln_f.weight"],
                       "bias": state["transformer.ln_f.bias"]},
        "layers": _import_neox_style(cfg, state, "transformer.h.{i}.", "self_attention"),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": state["lm_head.weight"].T}
    return p


def _import_gpt_neox(cfg: TransformerConfig, state: State) -> Dict[str, Any]:
    """GPTNeoXForCausalLM: per-head fused QKV, partial rotary, parallel
    residual with separate input/post-attention norms, untied embed_out."""
    p = {
        "embed": {"tok": state["gpt_neox.embed_in.weight"]},
        "final_norm": {"scale": state["gpt_neox.final_layer_norm.weight"],
                       "bias": state["gpt_neox.final_layer_norm.bias"]},
        "layers": _import_neox_style(cfg, state, "gpt_neox.layers.{i}.", "attention"),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": state["embed_out.weight"].T}
    return p
