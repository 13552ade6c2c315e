"""Curriculum learning + data efficiency — the port's copy of
``deepspeed_tpu/runtime/data_pipeline/curriculum.py`` (plain numpy).

Reference: ``runtime/data_pipeline/`` — CurriculumScheduler (difficulty
ramps, e.g. sequence length), DeepSpeedDataSampler (curriculum-aware
sampling), variable batch size & LR.  Sequence-length curricula step
through the same FIXED ladder of bucket lengths as the JAX package (there
each bucket compiles once; here it keeps the two packages' difficulties
and batches identical).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np



@dataclasses.dataclass
class CurriculumConfig:
    enabled: bool = False
    curriculum_type: str = "seqlen"
    min_difficulty: int = 64
    max_difficulty: int = 1024
    schedule_type: str = "fixed_linear"  # fixed_linear | fixed_root | fixed_discrete
    total_curriculum_step: int = 10000
    difficulty_step: int = 8
    root_degree: int = 2
    difficulty: Optional[List[int]] = None  # for fixed_discrete
    max_step: Optional[List[int]] = None

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "CurriculumConfig":
        d = dict(d or {})
        sched = d.pop("schedule_config", {})
        merged = {**d, **sched}
        return cls(**{k: v for k, v in merged.items()
                      if k in {f.name for f in dataclasses.fields(cls)}})


class CurriculumScheduler:
    """step -> difficulty (reference data_pipeline/curriculum_scheduler.py)."""

    def __init__(self, config: CurriculumConfig):
        self.config = config
        self.current_difficulty = config.min_difficulty

    def get_difficulty(self, global_step: int) -> int:
        c = self.config
        if c.schedule_type == "fixed_discrete":
            diffs = c.difficulty or [c.max_difficulty]
            steps = c.max_step or []
            idx = sum(1 for s in steps if global_step >= s)
            return diffs[min(idx, len(diffs) - 1)]
        frac = min(1.0, global_step / max(1, c.total_curriculum_step))
        if c.schedule_type == "fixed_root":
            frac = frac ** (1.0 / c.root_degree)
        raw = c.min_difficulty + (c.max_difficulty - c.min_difficulty) * frac
        # snap to the difficulty_step ladder: the sequence shapes form a small set
        snapped = int(raw // c.difficulty_step) * c.difficulty_step
        return max(c.min_difficulty, min(snapped, c.max_difficulty))

    def update_difficulty(self, global_step: int) -> int:
        self.current_difficulty = self.get_difficulty(global_step)
        return self.current_difficulty


def apply_seqlen_curriculum(batch: Dict[str, Any], difficulty: int) -> Dict[str, Any]:
    """Truncate token batches to the current difficulty (reference
    seqlen-based curriculum applied in the GPT pretrain path)."""
    out = {}
    for k, v in batch.items():
        if hasattr(v, "ndim") and v.ndim >= 2 and v.shape[-1] > difficulty:
            out[k] = v[..., :difficulty]
        else:
            out[k] = v
    return out


class DeepSpeedDataSampler:
    """Curriculum-aware sampler: difficulty-scored samples released as the
    curriculum advances (reference data_sampling/data_sampler.py)."""

    def __init__(self, difficulties: np.ndarray, scheduler: CurriculumScheduler,
                 batch_size: int, seed: int = 0, drop_last: bool = True):
        self.difficulties = np.asarray(difficulties)
        self.scheduler = scheduler
        self.batch_size = batch_size
        self.seed = seed
        self.global_step = 0

    def set_step(self, step: int) -> None:
        self.global_step = step

    def next_indices(self) -> np.ndarray:
        diff = self.scheduler.update_difficulty(self.global_step)
        eligible = np.nonzero(self.difficulties <= diff)[0]
        if eligible.size == 0:
            eligible = np.argsort(self.difficulties)[:self.batch_size]
        rng = np.random.RandomState(self.seed + self.global_step)
        return rng.choice(eligible, size=self.batch_size,
                          replace=eligible.size < self.batch_size)


@dataclasses.dataclass
class VariableBatchConfig:
    """Variable batch size & LR (reference
    data_sampling/variable_batch_size_and_lr.py:492): batch by token budget,
    scale LR by batch-size ratio."""

    max_tokens_per_batch: int = 8192
    lr_scaling_method: str = "linear"  # linear | sqrt | none


def batch_by_token_budget(seq_lens: np.ndarray, cfg: VariableBatchConfig):
    """Greedy pack sample indices into batches under the token budget;
    returns (list of index arrays, lr multipliers)."""
    order = np.argsort(seq_lens)
    batches, cur, cur_tokens = [], [], 0
    max_len_in_cur = 0
    for i in order:
        sl = int(seq_lens[i])
        new_max = max(max_len_in_cur, sl)
        if cur and new_max * (len(cur) + 1) > cfg.max_tokens_per_batch:
            batches.append(np.asarray(cur))
            cur, max_len_in_cur = [], 0
            new_max = sl
        cur.append(i)
        max_len_in_cur = new_max
    if cur:
        batches.append(np.asarray(cur))
    ref = max(len(b) for b in batches)
    mults = []
    for b in batches:
        r = len(b) / ref
        if cfg.lr_scaling_method == "linear":
            mults.append(r)
        elif cfg.lr_scaling_method == "sqrt":
            mults.append(float(np.sqrt(r)))
        else:
            mults.append(1.0)
    return batches, mults
