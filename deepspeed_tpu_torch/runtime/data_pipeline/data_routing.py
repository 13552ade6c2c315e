"""Data routing: random-LTD and progressive layer drop (PLD) — the port's
counterpart of ``deepspeed_tpu/runtime/data_pipeline/data_routing.py``.

* random-LTD: each middle layer processes only a random subset of tokens;
  the kept count follows a linear schedule from ``start_token_budget`` to
  the full sequence, and dropped tokens bypass the layer (identity).
* PLD: layer *i* of *L* is kept with probability ``theta(t) ** ((i + 1) /
  L)``, theta decaying from 1 toward ``theta`` with factor ``gamma``; a kept
  layer's delta is rescaled by 1 / keep_prob so the expectation holds.

The schedules (:meth:`RandomLTDConfig.token_budget`,
:class:`ProgressiveLayerDrop`) are the JAX module's formulas.  The random
draws come from an explicit ``torch.Generator`` (the kept positions, the
keep decision); torch and JAX draw different numbers from the same seed,
so parity with JAX holds given the same kept positions or keep decision,
which :func:`random_ltd_apply` and :func:`pld_apply` take as arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch


# ------------------------------------------------------------- random-LTD
@dataclasses.dataclass
class RandomLTDConfig:
    """random_ltd block of data_efficiency config (the JAX config's
    fields)."""

    enabled: bool = False
    total_layer_num: int = 12
    random_ltd_layer_num: int = 8  # middle layers under LTD
    start_token_budget: int = 128
    schedule_steps: int = 1000  # linear ramp to the full sequence

    def token_budget(self, step: int, seq_len: int) -> int:
        """Kept-token count at ``step`` (linear ramp)."""
        if not self.enabled or step >= self.schedule_steps:
            return seq_len
        frac = step / max(1, self.schedule_steps)
        k = int(self.start_token_budget + frac * (seq_len - self.start_token_budget))
        return min(max(k, 1), seq_len)


def random_ltd_indices(generator: torch.Generator, seq_len: int, budget: int,
                       batch: int, device: Any = None) -> torch.Tensor:
    """``budget`` kept token positions per batch row, sorted: [B, budget]
    int64, drawn from ``generator`` (a random permutation per row)."""
    rows = [torch.sort(torch.randperm(seq_len, generator=generator)[:budget]).values
            for _ in range(batch)]
    out = torch.stack(rows) if rows else torch.empty((0, budget), dtype=torch.int64)
    return out.to(device) if device is not None else out


def random_ltd_apply(block_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                     keep_idx: torch.Tensor) -> torch.Tensor:
    """Run ``block_fn`` on the kept tokens only; dropped tokens pass through
    unchanged (gather -> layer -> scatter).  x: [B, S, H]; keep_idx: [B, K]
    sorted positions."""
    idx = keep_idx.to(device=x.device, dtype=torch.int64)[..., None].expand(
        -1, -1, x.shape[-1])
    processed = block_fn(torch.gather(x, 1, idx))
    return x.scatter(1, idx, processed.to(x.dtype))


# ------------------------------------------------------------------ PLD
@dataclasses.dataclass
class PLDConfig:
    """progressive_layer_drop block (the JAX config's fields)."""

    enabled: bool = False
    theta: float = 0.5  # asymptotic keep probability
    gamma: float = 0.001  # decay speed


class ProgressiveLayerDrop:
    """Keep-probability schedule: theta(t) = (1 - theta_bar) * exp(-gamma t)
    + theta_bar."""

    def __init__(self, config: Optional[PLDConfig] = None,
                 theta: float = 0.5, gamma: float = 0.001):
        self.config = config or PLDConfig(enabled=True, theta=theta, gamma=gamma)
        self.current_theta = 1.0

    def get_theta(self) -> float:
        return self.current_theta

    def update_state(self, global_step: int) -> float:
        c = self.config
        self.current_theta = float((1.0 - c.theta) * np.exp(-c.gamma * global_step)
                                   + c.theta)
        return self.current_theta

    def get_state(self) -> Dict[str, Any]:
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def layer_keep_prob(self, layer_idx: int, num_layers: int) -> float:
        """Deeper layers drop more: theta ** ((l + 1) / L)."""
        depth_frac = (layer_idx + 1) / max(1, num_layers)
        return float(self.current_theta ** depth_frac)


def pld_apply(block_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
              rng: Union[torch.Generator, bool], keep_prob: float,
              training: bool = True) -> torch.Tensor:
    """Skip a block (identity) with probability 1 - keep_prob; a kept block's
    delta is divided by keep_prob.  At eval, or keep_prob >= 1, the block
    always runs as is.  ``rng``: a ``torch.Generator`` to draw the keep
    decision from, or the decision itself (a bool)."""
    if not training or keep_prob >= 1.0:
        return block_fn(x)
    if isinstance(rng, torch.Generator):
        keep = bool(torch.rand((), generator=rng) < keep_prob)
    else:
        keep = bool(rng)
    if not keep:
        return x
    return x + (block_fn(x) - x) / keep_prob
