"""Model contract (the port's counterpart of ``deepspeed_tpu/runtime/
module.py``): a :class:`ModelSpec` carries the model's ``config`` and an
``init_params(generator, device)`` that builds its parameters from an
explicit ``torch.Generator`` on an explicit device."""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..accelerator import DeviceLike, resolve_device


class ModelSpec:
    def __init__(self, config: Any,
                 init_params: Callable[[torch.Generator, torch.device], Any]):
        self.config = config
        self._init_params = init_params

    def init_params(self, generator: torch.Generator,
                    device: DeviceLike = None) -> Any:
        """Random parameters drawn from ``generator``, which must live on
        ``device`` (a CUDA generator for CUDA parameters).  ``device``
        None means ``cuda``, as everywhere in the port."""
        return self._init_params(generator, resolve_device(device))
