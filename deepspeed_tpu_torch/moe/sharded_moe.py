"""Mixture-of-Experts: top-k gating, the capacity path and the dropless
grouped-matmul path (the port's counterpart of
``deepspeed_tpu/moe/sharded_moe.py``).

Two formulations of one layer, chosen by ``MoEConfig.drop_tokens``:

* capacity (``drop_tokens=True``): dispatch and combine are dense einsums
  against a ``[tokens, experts, capacity]`` one-hot, and tokens beyond an
  expert's capacity are dropped.  JAX leaves these einsums to XLA; here
  they are ``torch.einsum``.
* dropless (``drop_tokens=False``): every (token, expert) assignment is
  sorted by expert and padded to whole ``block_rows`` blocks
  (:func:`sort_pad_by_expert`), and the three expert matmuls run through
  the grouped matmul (``ops/grouped_matmul.py``: kernel G on the card, G'
  and G'' in its backward).

Both formulations train: gradients reach ``x``, the router (through the
gate probabilities and the aux loss) and every expert stack.

Both keep every shape static, so the layer never reads a value back to
the host: counts are a ``scatter_add_`` (``bincount`` syncs on CUDA to
size its output), the padded buffer has its worst-case size, and rows
that JAX drops through an out-of-range scatter index land in one spare row
that is sliced off.

Routing follows ``jax.lax.top_k``: the k largest gate probabilities,
equal values in ascending expert order (a stable descending sort).  The
dropless combine adds each token's k contributions in ascending expert
order in the activation type, the order of XLA's scatter-add over the
expert-sorted updates, so the sum is the same on every run and device.
The dispatch's backward keeps that rule: the gradient of each token sums
its k rows of the sorted buffer in ascending expert order, in fp32
(:class:`_Dispatch`), where autograd's own backward of the gather
``xt[token_of]`` is an accumulating ``index_put_`` with no order of
summation fixed on the card.

Expert parallelism (``moe/ep_dispatch.py``) is not ported: the port runs
on one device with no expert mesh axis, where the JAX package takes the
local path too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

#: the ROADMAP items behind what this module leaves out
ROADMAP_EP = ("ROADMAP Queue 1 #8/#9 'ZeRO across ranks' and 'Communication' "
              "(expert-parallel dispatch, moe/ep_dispatch.py)")

Experts = Dict[str, torch.Tensor]


@dataclasses.dataclass
class MoEConfig:
    """The JAX config, field for field up to the expert-parallel knobs."""

    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    aux_loss_coef: float = 0.01
    z_loss_coef: float = 0.0
    drop_tokens: bool = True
    noisy_gate_policy: Optional[str] = None  # None | 'Jitter' | 'RSample'
    #: renormalize the kept top-k gate probs to sum 1; qwen2-moe uses raw
    #: softmax values
    norm_topk: bool = True
    #: expert-parallel dispatch: "auto" | "spmd" (both local on one device;
    #: the JAX config's EP send capacity and all-to-all compression come
    #: with expert parallelism)
    ep_dispatch: str = "auto"


def compute_capacity(tokens: int, cfg: MoEConfig, training: bool = True) -> int:
    factor = cfg.capacity_factor if training else cfg.eval_capacity_factor
    cap = int(tokens * factor * cfg.top_k / cfg.num_experts)
    return max(cap, cfg.min_capacity)


def ep_dispatch_active(cfg: MoEConfig, expert_parallel_size: int = 1) -> bool:
    """Whether the explicit all-to-all EP path would run.  The port has one
    device and no expert mesh axis (size 1), so it takes the local path;
    an expert axis > 1 raises."""
    if cfg.ep_dispatch not in ("auto", "spmd"):
        raise ValueError(f"ep_dispatch must be 'auto' or 'spmd', got {cfg.ep_dispatch!r}")
    if expert_parallel_size > 1:
        raise NotImplementedError(
            f"an expert mesh axis of {expert_parallel_size}: expert-parallel MoE is not "
            f"ported yet ({ROADMAP_EP})")
    return False


def _top_k(gates: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values along the last axis, ties in
    ascending index order (``jax.lax.top_k``)."""
    return torch.sort(gates, dim=-1, descending=True, stable=True).indices[..., :k]


def _gate_and_aux(logits: torch.Tensor, cfg: MoEConfig,
                  generator: Optional[torch.Generator] = None):
    """Shared top-k gate probabilities + load-balance aux (no capacity).
    logits [T, E].  Returns (gates [T, E] fp32, expert_idx [T, K] int64,
    gate_k [T, K] fp32, aux fp32 scalar).

    Noisy gating draws from ``generator`` (``Jitter``: logits times
    U(0.98, 1.02); ``RSample``: plus N(0, 1) / E), where JAX draws from its
    rng; a policy without a generator raises (JAX skips the noise when no
    rng is passed, which no serving path does)."""
    E = logits.shape[-1]
    policy = cfg.noisy_gate_policy
    if policy not in (None, "Jitter", "RSample"):
        raise ValueError(f"noisy_gate_policy must be None, 'Jitter' or 'RSample', got {policy!r}")
    if policy is not None:
        if generator is None:
            raise ValueError(f"noisy_gate_policy={policy!r} needs a torch.Generator for its "
                             f"noise; set the policy to None for noise-free routing")
        if policy == "Jitter":
            u = torch.rand(logits.shape, generator=generator, device=logits.device)
            logits = logits * (0.98 + 0.04 * u)
        else:
            logits = logits + torch.randn(logits.shape, generator=generator,
                                          device=logits.device) / E
    gates = torch.softmax(logits.float(), dim=-1)
    expert_idx = _top_k(gates, cfg.top_k)  # [T, K]
    me = gates.mean(dim=0)
    ce = F.one_hot(expert_idx[:, 0], E).float().mean(dim=0)
    aux = (me * ce).sum() * E * cfg.aux_loss_coef
    if cfg.z_loss_coef > 0:
        aux = aux + cfg.z_loss_coef * torch.logsumexp(logits.float(), dim=-1).square().mean()
    gate_k = gates.gather(1, expert_idx)  # [T, K]
    if cfg.norm_topk:
        gate_k = gate_k / torch.clamp_min(gate_k.sum(-1, keepdim=True), 1e-9)
    return gates, expert_idx, gate_k, aux


def top_k_gating(logits: torch.Tensor, cfg: MoEConfig, capacity: int,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dispatch/combine tensors of the capacity path.  logits [T, E].
    Returns (combine [T, E, C] fp32, dispatch_mask [T, E, C] bool, aux).
    Assignments beyond an expert's capacity are dropped, k-major: every
    token's first choice is placed before any second choice."""
    T, E = logits.shape
    K = cfg.top_k
    gates, expert_idx, _, aux = _gate_and_aux(logits, cfg, generator)
    onehot = F.one_hot(expert_idx, E).float()  # [T, K, E]
    # position of each (token, k) within its expert's buffer
    flat = onehot.transpose(0, 1).reshape(K * T, E)
    pos_flat = torch.cumsum(flat, dim=0) - flat
    pos = pos_flat.reshape(K, T, E).transpose(0, 1)  # [T, K, E]
    position = (pos * onehot).sum(-1)  # [T, K]
    keep = position < capacity
    gate_k = gates.gather(1, expert_idx) * keep.float()
    if cfg.norm_topk:
        gate_k = gate_k / torch.clamp_min(gate_k.sum(-1, keepdim=True), 1e-9)
    cap_onehot = (position[..., None] == torch.arange(
        capacity, dtype=position.dtype, device=position.device)).float()  # [T, K, C]
    combine = torch.einsum("tk,tke,tkc->tec", gate_k, onehot,
                           cap_onehot * keep[..., None].float())
    return combine, combine > 0, aux


def sort_pad_by_expert(key: torch.Tensor, n_experts: int, block_rows: int):
    """Sort rows by expert key and give each its row in a buffer padded to
    whole blocks per expert.  ``key`` values >= n_experts mark invalid rows:
    they sort to the end and get ``dest == n_rows``.

    Returns (order, dest, n_rows, block_expert):
      order        [N] int64 sorted row order (stable)
      dest         [N] int64 padded-buffer row of each SORTED position
      n_rows       the static buffer size (worst case, whole blocks)
      block_expert [n_rows / block_rows] int32 expert of each row block
                   (trailing all-padding blocks belong to expert E - 1)"""
    N = key.shape[0]
    E = n_experts
    dev = key.device
    key = key.long()
    counts = torch.zeros(E + 1, dtype=torch.long, device=dev).scatter_add_(
        0, torch.clamp(key, max=E), torch.ones_like(key))[:E]
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    starts_raw = torch.cumsum(counts, 0) - counts
    padded = (counts + block_rows - 1) // block_rows * block_rows
    starts_b = torch.cumsum(padded, 0) - padded
    n_rows = (-(-N // block_rows) + E) * block_rows
    se = torch.clamp(key_s, 0, E - 1)
    dest = torch.where(key_s < E,
                       starts_b[se] + (torch.arange(N, device=dev) - starts_raw[se]),
                       torch.full_like(key_s, n_rows))
    block_starts = torch.arange(n_rows // block_rows, device=dev) * block_rows
    block_expert = torch.clamp(torch.searchsorted(starts_b, block_starts, right=True) - 1,
                               0, E - 1).to(torch.int32)
    return order, dest, n_rows, block_expert


def _gelu(t: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(t, approximate="tanh")


class _Dispatch(torch.autograd.Function):
    """``xt[token_of]``: token rows gathered into expert-sorted order.  Its
    backward sums each token's k rows of the gradient in ascending expert
    order (``pos`` [T, K]: the sorted positions of the token's
    assignments, in that order), in fp32, cast once: a fixed order, so two
    backward passes give the same bits on every device."""

    @staticmethod
    def forward(ctx, xt, token_of, pos):
        ctx.save_for_backward(pos)
        return xt[token_of]

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        acc = g[pos[:, 0]].float()
        for k in range(1, pos.shape[1]):
            acc = acc + g[pos[:, k]].float()
        return acc.to(g.dtype), None, None


def _expert_ffn_blocks(xs: torch.Tensor, experts: Experts, block_expert: torch.Tensor,
                       activation: str, block_rows: int,
                       n_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The three grouped matmuls of one FFN over sorted+padded tokens;
    ``n_used`` (a device int32) lets them skip the all-padding blocks."""
    from ..ops.grouped_matmul import grouped_matmul

    def gm(a, w):
        return grouped_matmul(a, w, block_expert, block_rows, n_used)

    if activation == "swiglu":
        h = F.silu(gm(xs, experts["w_gate"])) * gm(xs, experts["w_up"])
    else:
        h = _gelu(gm(xs, experts["w_up"]))
    return gm(h, experts["w_down"])


def moe_ffn_dropless(x: torch.Tensor, gate_w: torch.Tensor, experts: Experts,
                     cfg: MoEConfig, activation: str = "swiglu",
                     generator: Optional[torch.Generator] = None,
                     block_rows: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """``drop_tokens=False``: no token is ever dropped.  Assignments are
    sorted by expert into a static worst-case buffer of ``(ceil(T K /
    block_rows) + E) * block_rows`` rows, the expert FFN runs as three
    grouped matmuls, and each token sums its k gated outputs."""
    B, S, H = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.top_k
    xt = x.reshape(T, H)

    logits = xt @ gate_w
    _, expert_idx, gate_k, aux = _gate_and_aux(logits, cfg, generator)

    order, dest, n_rows, block_expert = sort_pad_by_expert(expert_idx.reshape(T * K), E,
                                                           block_rows)
    token_of = order // K
    by_expert = torch.argsort(expert_idx, dim=-1)  # [T, K]: each token's choices, ascending
    # the sorted position of each token's assignments, in ascending expert
    # order (``order`` inverted)
    pos = torch.empty_like(order).scatter_(0, order, torch.arange(T * K, device=x.device))
    pos = pos.reshape(T, K).gather(1, by_expert)
    # one spare row takes what JAX's scatter drops (dest == n_rows)
    xs = torch.zeros((n_rows + 1, H), dtype=x.dtype, device=x.device)
    xs.index_copy_(0, dest, _Dispatch.apply(xt, token_of, pos))
    # the blocks up to the last one that holds an assignment: the rest are
    # all padding, so the grouped matmuls skip them (read on the device)
    n_used = (torch.where(dest < n_rows, dest, -block_rows).max() // block_rows + 1).to(
        torch.int32).reshape(1)
    ys = _expert_ffn_blocks(xs[:n_rows], experts, block_expert, activation, block_rows, n_used)

    # the combine, per token in ascending expert order: row of each
    # assignment (t, k) in the buffer, then its gated output
    rows = dest[pos]
    gates = gate_k.gather(1, by_expert).to(ys.dtype)
    out = torch.zeros((T, H), dtype=x.dtype, device=x.device)
    for k in range(K):
        out = out + (ys[rows[:, k]] * gates[:, k, None]).to(x.dtype)
    return out.reshape(B, S, H), aux


def moe_ffn(x: torch.Tensor, gate_w: torch.Tensor, experts: Experts, cfg: MoEConfig,
            activation: str = "swiglu", generator: Optional[torch.Generator] = None,
            training: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward over [B, S, H] (the reference's MOELayer.forward).

    experts: stacked weights {w_gate/w_up: [E, H, F], w_down: [E, F, H]}
    (w_gate only for swiglu).  Returns (out [B, S, H], aux_loss).  The
    capacity path prices capacity with ``capacity_factor`` when
    ``training`` and ``eval_capacity_factor`` otherwise."""
    ep_dispatch_active(cfg)  # one device: always the local path
    if not cfg.drop_tokens:
        return moe_ffn_dropless(x, gate_w, experts, cfg, activation, generator)
    B, S, H = x.shape
    T = B * S
    xt = x.reshape(T, H)
    capacity = compute_capacity(T, cfg, training)

    logits = xt @ gate_w
    combine, dispatch, aux = top_k_gating(logits, cfg, capacity, generator)

    expert_in = torch.einsum("tec,th->ech", dispatch.to(x.dtype), xt)
    if activation == "swiglu":
        h = F.silu(torch.einsum("ech,ehf->ecf", expert_in, experts["w_gate"]))
        h = h * torch.einsum("ech,ehf->ecf", expert_in, experts["w_up"])
    else:
        h = _gelu(torch.einsum("ech,ehf->ecf", expert_in, experts["w_up"]))
    expert_out = torch.einsum("ecf,efh->ech", h, experts["w_down"])

    out = torch.einsum("tec,ech->th", combine.to(x.dtype), expert_out)
    return out.reshape(B, S, H), aux
