"""Learning-rate schedules (the port's counterpart of ``deepspeed_tpu/
runtime/lr_schedules.py``): LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR,
WarmupCosineLR.

Each is a function ``step -> lr`` of the 0-based optimizer step, written in
fp32 torch ops so that it runs where its argument lives: on a 0-d device
tensor inside the training step (no value crosses to the host, as the JAX
schedule compiles into the update) and on a plain int for ``get_lr()``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

Schedule = Callable[[Any], torch.Tensor]

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False, **_) -> Schedule:
    def schedule(step):
        interval = _f32(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = torch.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return schedule


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log", **_) -> Schedule:
    def schedule(step):
        s = torch.clamp_max(_f32(step), float(warmup_num_steps))
        frac = s / max(warmup_num_steps, 1)
        if warmup_type == "log":
            gamma = torch.log(1.0 + frac * (math.e - 1.0))
        else:
            gamma = frac
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma

    return schedule


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_) -> Schedule:
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def schedule(step):
        step = _f32(step)
        decay = torch.clamp_min(
            (total_num_steps - step) / max(1.0, total_num_steps - warmup_num_steps), 0.0)
        return torch.where(step < warmup_num_steps, warm(step), warmup_max_lr * decay)

    return schedule


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                     warmup_max_lr: float = 0.001, **_) -> Schedule:
    def schedule(step):
        step = _f32(step)
        warm_frac = warmup_min_ratio + (1 - warmup_min_ratio) * torch.clamp_max(
            step / max(1, warmup_num_steps), 1.0)
        progress = torch.clamp((step - warmup_num_steps)
                               / max(1, total_num_steps - warmup_num_steps), 0.0, 1.0)
        cos = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (1 + torch.cos(math.pi * progress))
        ratio = torch.where(step < warmup_num_steps, warm_frac, cos)
        return warmup_max_lr * ratio

    return schedule


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0, **_) -> Schedule:
    second = (cycle_second_step_size if cycle_second_step_size is not None
              else cycle_first_step_size)
    total = cycle_first_step_size + second

    def schedule(step):
        step = _f32(step)
        up = torch.clamp(step / cycle_first_step_size, 0.0, 1.0)
        down = torch.clamp((step - cycle_first_step_size) / max(1, second), 0.0, 1.0)
        in_cycle_lr = torch.where(
            step <= cycle_first_step_size,
            cycle_min_lr + (cycle_max_lr - cycle_min_lr) * up,
            cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down)
        if decay_step_size > 0:
            decay_steps = torch.clamp_min(step - total, 0.0) / decay_step_size
            post = cycle_min_lr / (1.0 + decay_steps * decay_lr_rate)
        else:
            post = torch.full_like(step, cycle_min_lr)
        return torch.where(step <= total, in_cycle_lr, post)

    return schedule


_FACTORIES: Dict[str, Callable[..., Schedule]] = {
    LR_RANGE_TEST: lr_range_test,
    ONE_CYCLE: one_cycle,
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    WARMUP_COSINE_LR: warmup_cosine_lr,
}


def get_schedule(name: Optional[str], params: Dict[str, Any], base_lr: float) -> Schedule:
    """A schedule from a DeepSpeed ``scheduler`` block; the constant
    ``base_lr`` when none is configured."""
    if not name:
        return lambda step: torch.full_like(_f32(step), base_lr)
    if name not in _FACTORIES:
        raise ValueError(f"Unknown lr scheduler '{name}'. Known: {list(_FACTORIES)}")
    return _FACTORIES[name](**params)


class LRSchedulerShim:
    """Object-style wrapper for API parity with torch schedulers
    (``scheduler.step()``, ``get_lr()``, state_dict round trip)."""

    def __init__(self, schedule: Schedule):
        self.schedule = schedule
        self._step = 0

    def step(self, increment: int = 1) -> None:
        self._step += increment

    def get_lr(self):
        return [float(self.schedule(self._step))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"step": self._step}

    def load_state_dict(self, sd):
        self._step = sd["step"]
