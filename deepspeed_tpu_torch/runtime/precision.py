"""Mixed-precision helpers (the serving subset of ``deepspeed_tpu/runtime/
precision.py``)."""

from __future__ import annotations

import torch
from torch import nn


def cast_params(params: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast floating-point parameters only (ints/bools pass through), in
    place — the counterpart of ``cast_tree``."""
    for p in params.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return params
