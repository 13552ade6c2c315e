"""Mixed precision: loss scaling and dtype policy (the port's counterpart of
``deepspeed_tpu/runtime/precision.py``).

The loss-scale state lives on the device as 0-d tensors and is updated with
``torch.where``, as the JAX engine carries it in its TrainState pytree and
updates it with ``lax.cond``: the update itself needs no host value.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, Sequence

import torch
from torch import nn


@dataclasses.dataclass
class LossScaleState:
    """Dynamic loss-scale state: fp32 scale and int32 trackers, 0-d tensors."""

    cur_scale: torch.Tensor
    growth_tracker: torch.Tensor  # good steps since the last overflow
    hysteresis_tracker: torch.Tensor

    @staticmethod
    def create(config, device: torch.device) -> "LossScaleState":
        init = config.loss_scale if config.loss_scale > 0 else 2.0 ** config.initial_scale_power
        return LossScaleState(
            cur_scale=torch.tensor(init, dtype=torch.float32, device=device),
            growth_tracker=torch.tensor(0, dtype=torch.int32, device=device),
            hysteresis_tracker=torch.tensor(config.hysteresis, dtype=torch.int32,
                                            device=device))


def check_overflow(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """0-d bool tensor: True if any gradient holds an inf or a NaN."""
    flags = [torch.logical_not(torch.isfinite(g).all()) for g in grads]
    if not flags:
        return torch.tensor(False)
    return torch.stack(flags).any()


def _tensor_leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return []


def nonfinite_count(tree: Any) -> torch.Tensor:
    """Total inf and NaN elements over a tree of tensors (dicts, lists,
    ``ParamTree``s) as a 0-d int32 tensor on the leaves' device, with no
    host read: the counting sibling of :func:`check_overflow`."""
    leaves = _tensor_leaves(tree)
    if not leaves:
        return torch.tensor(0, dtype=torch.int32)
    return sum(torch.logical_not(torch.isfinite(g.float())).sum()
               for g in leaves).to(torch.int32)


def loss_scale_summary(state: LossScaleState) -> dict:
    """The dynamic loss-scale state's scalars, for the numerics stats tree."""
    return {"cur_scale": state.cur_scale,
            "growth_tracker": state.growth_tracker,
            "hysteresis_tracker": state.hysteresis_tracker}


def update_loss_scale(state: LossScaleState, overflow: torch.Tensor,
                      config) -> LossScaleState:
    """Dynamic scaling: on overflow the hysteresis tracker drops by one and
    the scale halves (not below ``min_loss_scale``) once it is exhausted,
    and the growth tracker resets; after ``loss_scale_window`` clean steps
    the scale doubles.  A clean step replenishes the hysteresis unless
    ``consecutive_hysteresis``.  Static scaling (loss_scale > 0) never
    changes."""
    if config.loss_scale > 0:
        return state
    hyst = state.hysteresis_tracker - 1
    over_scale = torch.where(hyst <= 0,
                             torch.clamp_min(state.cur_scale / 2.0, config.min_loss_scale),
                             state.cur_scale)
    tracker = state.growth_tracker + 1
    grow = tracker >= config.loss_scale_window
    clean_scale = torch.where(grow, state.cur_scale * 2.0, state.cur_scale)
    clean_tracker = torch.where(grow, torch.zeros_like(tracker), tracker)
    clean_hyst = (state.hysteresis_tracker if config.consecutive_hysteresis
                  else torch.full_like(state.hysteresis_tracker, config.hysteresis))
    return LossScaleState(
        cur_scale=torch.where(overflow, over_scale, clean_scale),
        growth_tracker=torch.where(overflow, torch.zeros_like(tracker),
                                   clean_tracker).to(torch.int32),
        hysteresis_tracker=torch.where(overflow, torch.clamp_min(hyst, 0),
                                       clean_hyst).to(torch.int32))


def global_grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every gradient leaf, in fp32 (a 0-d tensor)."""
    if not grads:
        return torch.tensor(0.0)
    return torch.sqrt(torch.stack([g.float().square().sum() for g in grads]).sum())


def clip_by_global_norm(grads: Sequence[torch.Tensor], norm: torch.Tensor,
                        clip: float) -> List[torch.Tensor]:
    """Each leaf times ``min(1, clip / (norm + 1e-6))``."""
    scale = torch.clamp_max(clip / (norm + 1e-6), 1.0)
    return [g * scale.to(g.dtype) for g in grads]


def cast_tree(params: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast floating-point parameters only (ints/bools pass through), in
    place."""
    for p in params.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return params


def cast_tree_copy(params: Any, dtype: torch.dtype, device: torch.device) -> Any:
    """``params`` (a ``ParamTree``) on ``device`` with its floating leaves
    in ``dtype``, never altering the tree given: returned as it is when
    every leaf already lies there in that dtype (no second copy of the
    weights), else a new tree built leaf by leaf, every leaf a copy."""
    def placed(t: torch.Tensor) -> bool:
        return (t.device.type == device.type
                and (device.index is None or t.device.index == device.index)
                and (not t.is_floating_point() or t.dtype == dtype))

    if all(placed(p) for p in params.parameters()):
        return params
    return params.map(lambda t: t.to(device=device, copy=True,
                                     dtype=dtype if t.is_floating_point() else t.dtype))

