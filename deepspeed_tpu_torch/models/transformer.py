"""Transformer model core — the serving (paged and dense-cache) and
single-device training subset of ``deepspeed_tpu/models/transformer.py``.

Parameters live in :class:`ParamTree` modules that mirror the JAX
parameter tree name for name (``params.embed.tok``,
``params.layers[i].attn.wq``), so the weight bridge (``convert.py``) is a
mechanical walk.  Two differences from the JAX layout:

* the JAX tree stacks layers on a leading ``[L, ...]`` axis for
  ``lax.scan``; here ``params.layers`` is an ``nn.ModuleList`` with one
  tree per layer, because PyTorch runs the layer loop eagerly;
* matmul weights keep the JAX ``[in, out]`` layout (``x @ W``), so no
  transposes cross the bridge.

A weight leaf may be a weight-only quantized ``{"wq", "scale"}`` sub-tree
(``inference/quantization.py``); :func:`_mm` sends those to the
``wq_matmul`` kernel.  :func:`forward_with_cache` is the dense KV-cache
path of the inference v1 engine.

With ``moe_experts > 0`` every layer's FFN is a mixtral-style MoE
(``moe/sharded_moe.py``): a router ``[H, E]`` and stacked experts
``[E, H, F]`` / ``[E, F, H]``, optionally a qwen2-moe shared expert and a
PR-MoE dense residual.  ``mlp_block`` returns the layer's aux loss beside
its output; serving passes ``training=False`` (the capacity path then
prices capacity with ``eval_capacity_factor``) and drops the aux;
:func:`causal_lm_loss` adds the layers' summed aux to the loss, as JAX's
does, and trains every MoE leaf (the dropless layer's expert matmuls through
the grouped-matmul kernels G, G' and G'').

The training forward (:func:`transformer_forward`, :func:`causal_lm_loss`)
runs the layers as a Python loop where JAX scans them, and differentiates
through PyTorch autograd; attention goes through :func:`_pick_attn`, which
takes the flash kernels (forward A, backward A' and A'') on a CUDA device
and the plain attention on the CPU, as JAX picks flash on the TPU.  With
``remat`` each block runs under activation checkpointing with
``remat_policy`` (``runtime/activation_checkpointing/checkpointing.py``):
the recompute runs the same kernels on the same inputs, so losses and
gradients are bit-equal to those without.

The functions below are plain functions on tensors with the JAX
rounding points kept: ``_norm`` and ``_rope`` compute in fp32 and cast
back, and the plain attention takes the softmax in fp32 and casts the
probabilities back to the input dtype before the PV product.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import DeviceLike, resolve_device

#: the ROADMAP item that brings the part of the JAX model core the port
#: leaves out (named in the NotImplementedError it raises)
ROADMAP_SP = "ROADMAP Queue 1 'Sequence parallelism'"


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: Optional[int] = None  # GQA; None => MHA
    intermediate_size: Optional[int] = None  # None => 4x (gelu) / llama 8/3 rule
    max_seq_len: int = 2048
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "swiglu"  # swiglu | gelu | gelu_exact | relu
    position: str = "rope"  # rope | learned | alibi | none
    causal: bool = True
    #: bloom-style word_embeddings_layernorm on a pre-norm model
    embed_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    use_bias: bool = False  # gpt2/bert style proj biases
    qkv_bias: bool = False  # bias on q/k/v only (qwen2 style)
    rotary_pct: float = 1.0  # fraction of head_dim under rope (phi/neox)
    parallel_block: bool = False  # x + attn(ln x) + mlp(ln x)
    parallel_norms: int = 1
    #: post-norm (original-transformer/BERT ordering): the norm AFTER each
    #: residual add, norm1(x + attn(x)) and norm2(h + ffn(h)); the embeddings
    #: get their own norm and there is no final norm.  Encoder-style: the
    #: generative engines refuse it.
    post_norm: bool = False
    #: segment-embedding table size of a post-norm encoder (BERT
    #: type_vocab_size); 0 disables the table
    type_vocab_size: int = 2
    dtype: torch.dtype = torch.float32  # params storage dtype at init
    #: the JAX config's dropout field, which its model core never applies;
    #: only 0.0 is accepted here
    dropout: float = 0.0
    #: activation checkpointing of each block, with a policy name of
    #: ``checkpointing.POLICY_MAP`` (the JAX field's jax.checkpoint_policies
    #: names)
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    attn_impl: str = "auto"  # auto | xla | flash (ulysses | ring | fpdt raise)
    # MoE (mixtral-style: every layer's MLP is replaced when moe_experts > 0)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    #: qwen2-moe shared expert: its FFN width (0 = off); its output is added
    #: to the routed output, scaled by sigmoid(x @ shared_gate) per token
    moe_shared_expert: int = 0
    #: renormalize the kept top-k gate probs to sum 1 (mixtral)
    moe_norm_topk: bool = True
    moe_drop_tokens: bool = True  # False => dropless sort + grouped-matmul path
    #: EP dispatch: "auto" | "spmd" (one device: the local path either way)
    moe_ep_dispatch: str = "auto"
    #: PR-MoE residual: a dense MLP beside the MoE, mixed by a learned
    #: 2-way coefficient
    moe_use_residual: bool = False
    #: tiled logits + loss: sequence chunk size (0 = off)
    loss_chunk: int = 0
    #: numerics observatory (set by the training engine around the loss
    #: of a boundary step): the forward takes a [L, 3] (l2_norm, max_abs,
    #: nonfinite) row per block output and causal_lm_loss returns
    #: (loss, act) (telemetry/numerics.py)
    numerics_act_stats: bool = False
    #: weight-only quantized inference: big matmul weights stored as int8 /
    #: int4 codes + fp32 group scales; 0 = off.  Set by InferenceEngineV2 on
    #: ITS OWN config copy, never on a shared one.
    wq_bits: int = 0
    wq_group: int = 128
    head_dim_override: Optional[int] = None

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.hidden_size // self.n_heads

    @property
    def ffn_size(self) -> int:
        if self.intermediate_size:
            return self.intermediate_size
        if self.activation == "swiglu":
            return ((int(self.hidden_size * 8 / 3) + 255) // 256) * 256
        return 4 * self.hidden_size


class ParamTree(nn.Module):
    """A named tree of parameters: tensor leaves become ``nn.Parameter``s,
    dict children become sub-trees, and a list of dicts becomes an
    ``nn.ModuleList`` (the per-layer trees).  Leaves are frozen unless
    ``requires_grad`` (the training engine's compute copy).  A leaf whose
    name is an ``nn.Module`` attribute (BERT's ``embed.type``) is held under
    that name all the same and read through :meth:`get`."""

    def __init__(self, tree: Dict[str, Any], requires_grad: bool = False):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, torch.Tensor):
                leaf = nn.Parameter(v, requires_grad=requires_grad and v.is_floating_point())
                if hasattr(nn.Module, name):
                    self._parameters[name] = leaf
                else:
                    self.register_parameter(name, leaf)
            elif isinstance(v, dict):
                self.add_module(name, ParamTree(v, requires_grad))
            elif isinstance(v, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(t, requires_grad) for t in v))
            else:
                raise TypeError(f"parameter leaf {name!r}: {type(v)}")

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default: Any = None) -> Any:
        if name in self._parameters:
            return self._parameters[name]
        return self._modules.get(name, default)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor],
            requires_grad: bool = False) -> "ParamTree":
        """A new tree of the same structure with ``fn`` applied to every
        leaf (e.g. the training engine's compute-dtype copy)."""

        def walk(mod: nn.Module) -> Dict[str, Any]:
            out: Dict[str, Any] = {n: fn(p.detach()) for n, p in mod._parameters.items()}
            for n, child in mod._modules.items():
                out[n] = ([walk(c) for c in child] if isinstance(child, nn.ModuleList)
                          else walk(child))
            return out

        return ParamTree(walk(self), requires_grad)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_transformer_params(cfg: TransformerConfig, generator: torch.Generator,
                            device: torch.device) -> ParamTree:
    """The JAX initialiser's tree and scales (normal, std 0.02; output
    projections 0.02/sqrt(2L); norm scales 1, biases 0), drawn from
    ``generator`` on ``device``.  torch and JAX draw different numbers
    from the same seed: parity tests carry JAX's weights across with
    ``convert.params_from_numpy`` instead.  A post-norm model norms its
    embeddings instead of its final hidden state, and carries the segment
    table ``embed.type`` when ``type_vocab_size > 0``."""
    H, L = cfg.hidden_size, cfg.n_layers
    D, NH, KVH = cfg.head_dim, cfg.n_heads, cfg.kv_heads
    Fs, V = cfg.ffn_size, cfg.vocab_size
    dt = cfg.dtype
    std = 0.02
    proj_out_std = std / math.sqrt(2 * L)

    def nrm(*shape, s=std):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * s).to(dt)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dt)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dt)

    def norm():
        n = {"scale": ones(H)}
        if cfg.norm == "layernorm":
            n["bias"] = zeros(H)
        return n

    p: Dict[str, Any] = {"embed": {"tok": nrm(V, H)}}
    if not cfg.post_norm:
        p["final_norm"] = norm()
        if cfg.embed_norm:  # bloom word_embeddings_layernorm
            p["embed"]["norm"] = norm()
    else:
        p["embed"]["norm"] = norm()
        if cfg.type_vocab_size > 0:
            p["embed"]["type"] = nrm(cfg.type_vocab_size, H)
    if cfg.position == "learned":
        p["embed"]["pos"] = nrm(cfg.max_seq_len, H)
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": nrm(H, V)}
    layers = []
    for _ in range(L):
        attn = {"wq": nrm(H, NH * D), "wk": nrm(H, KVH * D),
                "wv": nrm(H, KVH * D), "wo": nrm(NH * D, H, s=proj_out_std)}
        if cfg.use_bias or cfg.qkv_bias:
            attn.update(bq=zeros(NH * D), bk=zeros(KVH * D), bv=zeros(KVH * D))
        if cfg.use_bias:
            attn["bo"] = zeros(H)
        if cfg.moe_experts > 0:
            mlp = _init_moe(cfg, nrm, zeros, proj_out_std)
        elif cfg.activation == "swiglu":
            mlp = {"w_gate": nrm(H, Fs), "w_up": nrm(H, Fs),
                   "w_down": nrm(Fs, H, s=proj_out_std)}
        else:
            mlp = {"w_up": nrm(H, Fs), "w_down": nrm(Fs, H, s=proj_out_std)}
        if cfg.use_bias:
            mlp.update(b_up=zeros(Fs), b_down=zeros(H))
        layer = {"attn": attn, "mlp": mlp, "norm1": norm()}
        if not cfg.parallel_block or cfg.parallel_norms >= 2:
            layer["norm2"] = norm()
        layers.append(layer)
    p["layers"] = layers
    return ParamTree(p)


def _init_moe(cfg: TransformerConfig, nrm: Callable, zeros: Callable,
              proj_out_std: float) -> Dict[str, torch.Tensor]:
    """One layer's MoE leaves, the JAX tree's: router ``[H, E]``, experts
    ``w_gate``/``w_up`` ``[E, H, F]`` and ``w_down`` ``[E, F, H]`` (whatever
    the activation), the PR-MoE residual and the shared expert."""
    H, E, Fs = cfg.hidden_size, cfg.moe_experts, cfg.ffn_size
    mlp = {"router": nrm(H, E), "w_gate": nrm(E, H, Fs), "w_up": nrm(E, H, Fs),
           "w_down": nrm(E, Fs, H, s=proj_out_std)}
    if cfg.moe_use_residual:
        mlp.update(res_w_up=nrm(H, Fs), res_w_down=nrm(Fs, H, s=proj_out_std),
                   coef=zeros(H, 2))
    if cfg.moe_shared_expert > 0:
        Fsh = cfg.moe_shared_expert
        mlp.update(shared_w_gate=nrm(H, Fsh), shared_w_up=nrm(H, Fsh),
                   shared_w_down=nrm(Fsh, H, s=proj_out_std), shared_gate=zeros(H, 1))
    return mlp


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------
def _mm(cfg: TransformerConfig, x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ W`` through the weight-access seam: W is a plain tensor or a
    weight-only quantized ``{"wq", "scale"}`` sub-tree, which goes to the
    ``wq_matmul`` kernel (its plain version on the CPU) with the config's
    ``wq_bits`` and ``wq_group``."""
    if isinstance(w, ParamTree) and "wq" in w:
        from ..ops.wq_matmul import wq_matmul

        return wq_matmul(x, w.wq, w.scale, bits=cfg.wq_bits, group=cfg.wq_group)
    return x @ w


def _norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
          kind: str, eps: float) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        out = xf * scale.float()
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
        if bias is not None:
            out = out + bias.float()
    return out.to(x.dtype)


def _rope(x: torch.Tensor, theta: float, positions: torch.Tensor,
          pct: float = 1.0) -> torch.Tensor:
    """Rotary embedding on [..., S, NH, D] (split-half rotation, fp32
    angles); ``pct`` < 1 rotates only the leading fraction of the head
    dim (phi/gpt-neox partial rotary).  positions: [B, S]."""
    d_full = x.shape[-1]
    d = d_full if pct >= 1.0 else (int(d_full * pct) // 2) * 2
    x_rot, x_pass = x[..., :d], x[..., d:]
    freqs = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32, device=x.device)
                      / d * math.log(theta))
    angles = positions[:, :, None, None].float() * freqs  # [B, S, 1, d/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return out if d == d_full else torch.cat([out, x_pass], dim=-1)


def alibi_slopes(n_heads: int, device: DeviceLike = None) -> torch.Tensor:
    """ALiBi per-head slopes (Press et al.; HF bloom's build_alibi_tensor),
    on ``device`` (None means ``cuda``)."""
    device = resolve_device(device)
    p = 2 ** math.floor(math.log2(n_heads))
    base = [2 ** (-(2 ** -(math.log2(p) - 3)) * (i + 1)) for i in range(p)]
    if p < n_heads:
        base += [2 ** (-(2 ** -(math.log2(2 * p) - 3)) * (i + 1))
                 for i in range(0, 2 * (n_heads - p), 2)]
    return torch.tensor(base, dtype=torch.float32, device=device)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KVH, D] -> [B, S, KVH * n_rep, D] (jnp.repeat on axis 2)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, mask: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain attention, [B, S, NH, D] (k/v already repeated to NH
    heads): scores in the input dtype, fp32 softmax, probabilities cast
    back before the PV product.  ``bias`` is broadcastable to
    [B, NH, S_q, S_k]; ``mask`` is a [B, S_k] keep-mask."""
    d = q.shape[-1]
    scores = torch.einsum("bsnd,btnd->bnst", q, k).float() / math.sqrt(d)
    if bias is not None:
        scores = scores + bias
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        cmask = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device).tril(s_k - s_q)
        scores = torch.where(cmask, scores, torch.full_like(scores, -1e30))
    if mask is not None:
        scores = torch.where(mask[:, None, None, :].bool(), scores,
                             torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, v)


def attn_qkv(cfg: TransformerConfig, layer: ParamTree, x: torch.Tensor,
             positions: torch.Tensor):
    """norm1 + QKV projection + rope.  x: [B, T, H] -> q [B, T, NH, D],
    k/v [B, T, KVH, D] (pre-GQA-repeat).  positions: [B, T]."""
    B, T, _ = x.shape
    NH, KVH, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    a = layer.attn
    qb = cfg.use_bias or cfg.qkv_bias
    h = x if cfg.post_norm else _norm(x, layer.norm1.scale,
                                      layer.norm1.get("bias"), cfg.norm,
                                      cfg.norm_eps)
    q = _mm(cfg, h, a.wq)
    k = _mm(cfg, h, a.wk)
    v = _mm(cfg, h, a.wv)
    if qb:
        q, k, v = q + a.bq, k + a.bk, v + a.bv
    q, k, v = q.reshape(B, T, NH, D), k.reshape(B, T, KVH, D), v.reshape(B, T, KVH, D)
    if cfg.position == "rope":
        q = _rope(q, cfg.rope_theta, positions, cfg.rotary_pct)
        k = _rope(k, cfg.rope_theta, positions, cfg.rotary_pct)
    return q, k, v


Aux = Optional[torch.Tensor]


def mlp_block(cfg: TransformerConfig, layer: ParamTree, x: torch.Tensor,
              training: bool = True) -> Tuple[torch.Tensor, Aux]:
    """norm2 + FFN with residual: ``(x + ffn(norm(x)), aux)``, aux the MoE
    load-balance loss (None for a dense FFN, where JAX returns 0).  A
    parallel block with one shared norm (falcon-7b/phi) reads norm1."""
    ln = layer.norm1 if cfg.parallel_block and cfg.parallel_norms < 2 else layer.norm2
    h = _norm(x, ln.scale, ln.get("bias"), cfg.norm, cfg.norm_eps)
    h, aux = _ffn(cfg, layer, h, training)
    return x + h, aux


def _moe_ffn(cfg: TransformerConfig, m: ParamTree, h: torch.Tensor,
             training: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN: routed experts, plus the shared expert and the PR-MoE
    residual when the config has them."""
    from ..moe.sharded_moe import MoEConfig, _gelu, moe_ffn

    moe_cfg = MoEConfig(num_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                        capacity_factor=cfg.moe_capacity_factor,
                        aux_loss_coef=cfg.moe_aux_coef, drop_tokens=cfg.moe_drop_tokens,
                        norm_topk=cfg.moe_norm_topk, ep_dispatch=cfg.moe_ep_dispatch)
    experts = {k: getattr(m, k) for k in ("w_gate", "w_up", "w_down") if k in m}
    out, aux = moe_ffn(h, m.router, experts, moe_cfg, activation=cfg.activation,
                       training=training)
    if cfg.moe_shared_expert > 0:
        # qwen2-moe: the shared expert sees every token, gated per token
        sh = _mm(cfg, F.silu(_mm(cfg, h, m.shared_w_gate)) * _mm(cfg, h, m.shared_w_up),
                 m.shared_w_down)
        sgate = torch.sigmoid((h @ m.shared_gate).float())
        out = out + (sgate * sh.float()).to(out.dtype)
    if cfg.moe_use_residual:
        # PR-MoE: a dense MLP beside the MoE, mixed per token
        act = F.silu if cfg.activation == "swiglu" else _gelu
        res = _mm(cfg, act(_mm(cfg, h, m.res_w_up)), m.res_w_down)
        coef = torch.softmax((h @ m.coef).float(), dim=-1)
        out = (out * coef[..., 0:1] + res * coef[..., 1:2]).to(out.dtype)
    return out, aux


def _ffn(cfg: TransformerConfig, layer: ParamTree, h: torch.Tensor,
         training: bool = True) -> Tuple[torch.Tensor, Aux]:
    """The raw FFN (no norm, no residual) and its aux loss (None: dense)."""
    m = layer.mlp
    if cfg.moe_experts > 0:
        return _moe_ffn(cfg, m, h, training)
    if cfg.activation == "swiglu":
        return _mm(cfg, F.silu(_mm(cfg, h, m.w_gate)) * _mm(cfg, h, m.w_up), m.w_down), None
    if cfg.activation == "relu":
        act = F.relu
    elif cfg.activation == "gelu_exact":
        act = F.gelu
    else:  # "gelu" = tanh approximation (HF gelu_new)
        act = lambda t: F.gelu(t, approximate="tanh")  # noqa: E731
    up = _mm(cfg, h, m.w_up)
    if cfg.use_bias:
        up = up + m.b_up
    out = _mm(cfg, act(up), m.w_down)
    if cfg.use_bias:
        out = out + m.b_down
    return out, None


def _attn_out(cfg: TransformerConfig, layer: ParamTree, x: torch.Tensor,
              attn: torch.Tensor, training: bool = False) -> Tuple[torch.Tensor, Aux]:
    """Output projection + residual/parallel-block/post-norm epilogue of a
    block, shared by the training forward (``training=True``) and the paged
    and dense-cache inference bodies.  attn: [B, T, NH * D].  Returns (the
    block's output, the FFN's aux loss)."""
    attn_delta = _mm(cfg, attn, layer.attn.wo)
    if cfg.use_bias:
        attn_delta = attn_delta + layer.attn.bo
    if cfg.parallel_block:
        out, aux = mlp_block(cfg, layer, x, training)
        return out + attn_delta, aux
    if cfg.post_norm:
        # BERT ordering: the norm after each residual add
        n1, n2 = layer.norm1, layer.norm2
        h = _norm(x + attn_delta, n1.scale, n1.get("bias"), cfg.norm, cfg.norm_eps)
        ffn, aux = _ffn(cfg, layer, h, training)
        return _norm(h + ffn, n2.scale, n2.get("bias"), cfg.norm, cfg.norm_eps), aux
    return mlp_block(cfg, layer, x + attn_delta, training)


def _embed(cfg: TransformerConfig, params: ParamTree, ids: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """Token (+ learned position) embedding (+ bloom embedding norm) of the
    inference paths; ids/positions [B, T] -> [B, T, H]."""
    x = params.embed.tok[ids]
    if cfg.position == "learned":
        pos_idx = torch.clamp(positions, max=params.embed.pos.shape[0] - 1)
        x = x + params.embed.pos[pos_idx]
    if "norm" in params.embed:
        x = _norm(x, params.embed.norm.scale, params.embed.norm.get("bias"),
                  cfg.norm, cfg.norm_eps)
    return x


def _final_logits(cfg: TransformerConfig, params: ParamTree,
                  x: torch.Tensor) -> torch.Tensor:
    hidden = _norm(x, params.final_norm.scale, params.final_norm.get("bias"),
                   cfg.norm, cfg.norm_eps)
    return logits_fn(cfg, params, hidden)


def logits_fn(cfg: TransformerConfig, params: ParamTree,
              hidden: torch.Tensor) -> torch.Tensor:
    """LM-head logits; a weight-only quantized head goes through ``_mm``."""
    if cfg.tie_embeddings:
        return hidden @ params.embed.tok.T
    out = _mm(cfg, hidden, params.lm_head.w)
    b = params.lm_head.get("b")
    return out if b is None else out + b


# ---------------------------------------------------------------------------
# training forward and loss
# ---------------------------------------------------------------------------
def _pick_attn(cfg: TransformerConfig, device: torch.device) -> Callable:
    """The attention for ``cfg.attn_impl``: "auto" takes flash on a CUDA
    device and the plain attention on the CPU (JAX: flash on the TPU);
    "flash" takes the flash path on either (on the CPU its plain forward and
    backward); "xla" the plain attention.  Flash reads grouped KV heads
    itself and builds ALiBi from the indices."""
    impl = cfg.attn_impl
    if impl in ("ulysses", "ring", "fpdt"):
        raise NotImplementedError(f"attn_impl={impl!r} is not ported yet ({ROADMAP_SP})")
    if impl not in ("auto", "xla", "flash"):
        raise ValueError(f"unknown attn_impl {impl!r}")
    if impl == "auto":
        impl = "flash" if device.type == "cuda" else "xla"
    if impl == "xla":
        return xla_attention
    from ..ops.flash_attention import flash_attention

    def fn(q, k, v, causal, mask=None, alibi=None):
        return flash_attention(q, k, v, causal=causal, segment_mask=mask, alibi_slopes=alibi)

    fn.handles_gqa = True
    fn.handles_alibi = True
    return fn


def _block(cfg: TransformerConfig, x: torch.Tensor, layer: ParamTree,
           positions: torch.Tensor, mask: Optional[torch.Tensor],
           attn_fn: Callable) -> Tuple[torch.Tensor, Aux]:
    """One transformer block, [B, S, H] -> ([B, S, H], aux)."""
    B, S, _ = x.shape
    NH, KVH, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q, k, v = attn_qkv(cfg, layer, x, positions)
    if not getattr(attn_fn, "handles_gqa", False):
        k = _repeat_kv(k, NH // KVH)
        v = _repeat_kv(v, NH // KVH)
    if cfg.position == "alibi":
        slopes = alibi_slopes(NH, device=x.device)
        if getattr(attn_fn, "handles_alibi", False):
            attn = attn_fn(q, k, v, cfg.causal, mask, alibi=slopes)
        else:
            rel = (positions[:, None, :, None] - positions[:, None, None, :]).float()
            attn = attn_fn(q, k, v, cfg.causal, mask, bias=-slopes[None, :, None, None] * rel)
    else:
        attn = attn_fn(q, k, v, cfg.causal, mask)
    return _attn_out(cfg, layer, x, attn.reshape(B, S, NH * D), training=True)


def transformer_forward(cfg: TransformerConfig, params: ParamTree, input_ids: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        token_type_ids: Optional[torch.Tensor] = None,
                        with_act_stats: bool = False) -> Tuple[torch.Tensor, ...]:
    """[B, S] int tokens -> ([B, S, H] final hidden states, aux loss summed
    over the layers (0 for dense models)).  The JAX ``lax.scan`` over the
    stacked layers is a loop over the per-layer trees.  MoE layers run as
    JAX's training block does (``training=True``: capacity from
    ``moe_capacity_factor``).  A model with a segment table adds
    ``embed.type[token_type_ids]`` (zeros when None); a post-norm model
    returns its last block's output, which already ends in a norm.

    ``with_act_stats`` (numerics observatory): a third element, the
    ``[L, 3]`` activation-health rows (``telemetry.numerics.
    activation_stats``) of each block's output, taken OUTSIDE the block
    call (so a remat'd block's recompute in the backward takes none) and
    read without an autograd edge (the forward's bits do not change)."""
    if cfg.dropout:
        raise ValueError("dropout: the model core applies none (the JAX package's field is "
                         "unused too); leave it at 0.0")
    B, S = input_ids.shape
    x = params.embed.tok[input_ids]
    positions = torch.arange(S, device=input_ids.device).expand(B, S)
    if cfg.position == "learned":
        x = x + params.embed.pos[:S][None]
    if "type" in params.embed:  # BERT segment embeddings
        tt = token_type_ids if token_type_ids is not None else torch.zeros_like(input_ids)
        x = x + params.embed.get("type")[tt]
    if "norm" in params.embed:
        n = params.embed.norm
        x = _norm(x, n.scale, n.get("bias"), cfg.norm, cfg.norm_eps)
    attn_fn = _pick_attn(cfg, x.device)
    block = _block
    if cfg.remat:
        from ..runtime.activation_checkpointing.checkpointing import checkpoint_wrapper

        block = checkpoint_wrapper(_block, policy=cfg.remat_policy)
    if with_act_stats:
        # lazy: telemetry stays an optional dependency of the model code
        from ..telemetry.numerics import activation_stats as _act_row
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    act_rows = []
    for layer in params.layers:
        x, a = block(cfg, x, layer, positions, mask, attn_fn)
        if a is not None:
            aux = aux + a
        if with_act_stats:
            act_rows.append(_act_row(x))
    act = torch.stack(act_rows) if with_act_stats else None
    if cfg.post_norm:
        return (x, aux, act) if with_act_stats else (x, aux)
    fn = params.final_norm
    hidden = _norm(x, fn.scale, fn.get("bias"), cfg.norm, cfg.norm_eps)
    return (hidden, aux, act) if with_act_stats else (hidden, aux)


def nll_pick(logp: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-logp[target] (JAX contracts with a one-hot for its partitioner; a
    gather picks the same value and has the same gradient)."""
    return -logp.gather(-1, targets.long()[..., None])[..., 0]


def _tiled_nll(cfg: TransformerConfig, params: ParamTree, hidden: torch.Tensor,
               targets: torch.Tensor, mask: Optional[torch.Tensor], chunk: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of the NLL and of the mask over sequence chunks, each chunk's
    logits recomputed in the backward (``torch.utils.checkpoint``), so the
    full [B, S, V] logits never exist at once."""
    from torch.utils.checkpoint import checkpoint

    def chunk_nll(h, t, m):
        logp = torch.log_softmax(logits_fn(cfg, params, h).float(), dim=-1)
        return (nll_pick(logp, t) * m).sum(), m.sum()

    S = hidden.shape[1]
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, chunk):
        h, t = hidden[:, s0:s0 + chunk], targets[:, s0:s0 + chunk]
        m = (mask[:, s0:s0 + chunk] if mask is not None
             else torch.ones(t.shape, dtype=torch.float32, device=t.device))
        ds, dc = checkpoint(chunk_nll, h, t, m, use_reentrant=False)
        nll_sum, cnt = nll_sum + ds, cnt + dc
    return nll_sum, cnt


def causal_lm_loss(cfg: TransformerConfig, params: ParamTree, batch: Any,
                   rng: Any = None) -> torch.Tensor:
    """Next-token cross entropy plus the MoE layers' summed aux loss (0 for
    a dense model).  batch: dict(input_ids, optional labels, optional
    attention_mask) or a raw [B, S] token tensor.

    With ``cfg.numerics_act_stats`` set (by the training engine, around a
    boundary step's loss), returns ``(loss, act)`` where ``act`` is the
    forward's ``[L, 3]`` per-layer activation-health rows."""
    if isinstance(batch, dict):
        ids = batch["input_ids"]
        labels = batch.get("labels", ids)
        mask = batch.get("attention_mask")
    else:
        ids, labels, mask = batch, batch, None
    with_act = bool(cfg.numerics_act_stats)
    fwd = transformer_forward(cfg, params, ids, mask, with_act_stats=with_act)
    hidden, aux = fwd[0], fwd[1]
    act = fwd[2] if with_act else None

    def _out(loss):
        return (loss, act) if with_act else loss

    hidden = hidden[:, :-1]
    targets = labels[:, 1:]
    m = mask[:, 1:].float() if mask is not None else None
    if cfg.loss_chunk and hidden.shape[1] > cfg.loss_chunk:
        if hidden.shape[1] % cfg.loss_chunk == 0:
            nll_sum, cnt = _tiled_nll(cfg, params, hidden, targets, m, cfg.loss_chunk)
            return _out(nll_sum / torch.clamp_min(cnt, 1.0) + aux)
        from ..utils.logging import warning_once

        warning_once(f"loss_chunk={cfg.loss_chunk} does not divide sequence "
                     f"{hidden.shape[1]} (seq_len-1); materializing the full [B, S, V] "
                     f"logits — pick a loss_chunk dividing seq_len-1")
    logp = torch.log_softmax(logits_fn(cfg, params, hidden).float(), dim=-1)
    nll = nll_pick(logp, targets)
    if m is not None:
        return _out((nll * m).sum() / torch.clamp_min(m.sum(), 1.0) + aux)
    return _out(nll.mean() + aux)


# ---------------------------------------------------------------------------
# dense KV-cache decode path (inference v1)
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  dtype: Optional[torch.dtype] = None,
                  device: DeviceLike = None) -> Dict[str, Any]:
    """``{"k", "v"}`` of ``[L, B, max_len, KVH, D]`` zeros and ``"length"``
    (a host int), on ``device`` (None means ``cuda``)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    dt = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device), "length": 0}


def _block_decode(cfg: TransformerConfig, x: torch.Tensor, layer: ParamTree,
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  position: int) -> torch.Tensor:
    """One block for the token slice x ``[B, T, H]`` at positions
    ``[position, position + T)``: writes this slice's K/V into the layer's
    cache views ``[B, S, KVH, D]`` in place, then attends the cache through
    the plain attention, as JAX computes it (scores in the input type, fp32
    softmax, token t sees slots <= position + t).  JAX attends all S slots
    with the later ones masked; here the slots past ``position + T``, which
    the mask zeroes exactly, are not read."""
    B, T, _ = x.shape
    NH, KVH, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    dev = x.device
    q, k, v = attn_qkv(cfg, layer, x, (position + torch.arange(T, device=dev))[None].expand(B, T))
    end = position + T
    k_cache[:, position:end] = k.to(k_cache.dtype)
    v_cache[:, position:end] = v.to(v_cache.dtype)
    kk = _repeat_kv(k_cache[:, :end], NH // KVH)
    vv = _repeat_kv(v_cache[:, :end], NH // KVH)
    scores = torch.einsum("btnd,bsnd->bnts", q, kk).float() / math.sqrt(D)
    limit = (position + torch.arange(T, device=dev))[:, None]
    slot = torch.arange(end, device=dev)[None, :]
    if cfg.position == "alibi":
        scores = scores - alibi_slopes(NH, device=dev)[None, :, None, None] \
            * (limit - slot).float()
    scores = torch.where(slot <= limit, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    return _attn_out(cfg, layer, x,
                     torch.einsum("bnts,bsnd->btnd", probs, vv).reshape(B, T, NH * D))[0]


@torch.no_grad()
def forward_with_cache(cfg: TransformerConfig, params: ParamTree, input_ids: torch.Tensor,
                       cache: Dict[str, Any], position: int
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill or decode: run ``[B, T]`` tokens against and into the cache
    from ``position`` (a host int, the same for every row, as the JAX
    engine's dense decode uses).  Returns (logits ``[B, T, V]``, the cache,
    updated in place with ``"length"`` = position + T)."""
    if cfg.post_norm:
        raise NotImplementedError(
            "post_norm models (BERT-style encoders) have no KV-cache generative path")
    B, T = input_ids.shape
    if position + T > cache["k"].shape[2]:
        raise ValueError(f"positions [{position}, {position + T}) exceed the cache's "
                         f"{cache['k'].shape[2]} slots")
    positions = (position + torch.arange(T, device=input_ids.device))[None].expand(B, T)
    x = _embed(cfg, params, input_ids, positions)
    for i, layer in enumerate(params.layers):
        x = _block_decode(cfg, x, layer, cache["k"][i], cache["v"][i], position)
    cache["length"] = position + T
    return _final_logits(cfg, params, x), cache


def _moe_mlp_params(cfg: TransformerConfig, experts: int) -> int:
    """One layer's FFN parameters by the JAX formula: a dense FFN, or
    ``experts`` expert FFNs plus the router, the PR-MoE residual and the
    shared expert."""
    mlp = cfg.hidden_size * cfg.ffn_size * (3 if cfg.activation == "swiglu" else 2)
    if cfg.moe_experts <= 0:
        return mlp
    mlp = mlp * experts + cfg.hidden_size * cfg.moe_experts
    if cfg.moe_use_residual:
        mlp += 2 * cfg.hidden_size * cfg.ffn_size + 2 * cfg.hidden_size
    if cfg.moe_shared_expert > 0:
        mlp += 3 * cfg.hidden_size * cfg.moe_shared_expert + cfg.hidden_size
    return mlp


def param_count(cfg: TransformerConfig) -> int:
    """Stored parameter count: embeddings, attention and ALL experts' FFNs
    (what the weight bytes need); ``flops_per_token`` prices only the
    active top-k experts."""
    mlp = _moe_mlp_params(cfg, cfg.moe_experts)
    return (cfg.vocab_size * cfg.hidden_size * (1 if cfg.tie_embeddings else 2)
            + cfg.n_layers * (cfg.hidden_size * cfg.head_dim * (cfg.n_heads + 2 * cfg.kv_heads)
                              + cfg.n_heads * cfg.head_dim * cfg.hidden_size + mlp))


def flops_per_token(cfg: TransformerConfig, seq_len: int) -> float:
    """6 * N_active + attention flops per token (training forward and
    backward), the JAX formula: an MoE layer counts its router and the
    ``moe_top_k`` experts a token flows through."""
    mlp = _moe_mlp_params(cfg, cfg.moe_top_k)
    n_params = (cfg.vocab_size * cfg.hidden_size * (1 if cfg.tie_embeddings else 2)
                + cfg.n_layers * (cfg.hidden_size * cfg.head_dim * (cfg.n_heads + 2 * cfg.kv_heads)
                                  + cfg.n_heads * cfg.head_dim * cfg.hidden_size + mlp))
    return 6.0 * n_params + 12 * cfg.n_layers * cfg.hidden_size * seq_len
