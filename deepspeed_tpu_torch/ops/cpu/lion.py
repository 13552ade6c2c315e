"""Host Lion: the counterpart of ``deepspeed_tpu/ops/cpu/lion.py``'s
``DeepSpeedCPULion`` over ``csrc/lion/cpu_lion.cpp``."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..op_builder import CPULionBuilder
from ._common import as_grads, check_params


class DeepSpeedCPULion:
    def __init__(self, lr: float = 1e-4, betas=(0.9, 0.99), weight_decay: float = 0.0):
        self.lib = CPULionBuilder().load()
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.weight_decay = weight_decay
        self._m: Dict[int, Optional[np.ndarray]] = {}

    def step(self, params: np.ndarray, grads: np.ndarray, key: int = 0,
             lr: Optional[float] = None) -> np.ndarray:
        """In-place Lion step on a contiguous fp32 shard; returns params."""
        check_params(params)
        grads = as_grads(grads, params.size)
        if key not in self._m:
            self._m[key] = np.zeros(params.size, np.float32)
        rc = self.lib.dstpu_lion_step(
            params.ctypes.data, grads.ctypes.data, self._m[key].ctypes.data, params.size,
            np.float32(lr or self.lr), np.float32(self.beta1), np.float32(self.beta2),
            np.float32(self.weight_decay))
        if rc != 0:
            raise RuntimeError(f"cpu lion step failed rc={rc}")
        return params

    def state_dict(self) -> Dict[str, Any]:
        return {"m": {k: v.copy() for k, v in self._m.items()}}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self._m = {k: np.asarray(v) for k, v in sd["m"].items()}
