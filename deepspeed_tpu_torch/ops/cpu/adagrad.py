"""Host Adagrad: the counterpart of ``deepspeed_tpu/ops/cpu/adagrad.py``'s
``DeepSpeedCPUAdagrad`` over ``csrc/adagrad/cpu_adagrad.cpp``."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..op_builder import CPUAdagradBuilder
from ._common import as_grads, check_params


class DeepSpeedCPUAdagrad:
    def __init__(self, lr: float = 1e-2, eps: float = 1e-10, weight_decay: float = 0.0):
        self.lib = CPUAdagradBuilder().load()
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self._v: Dict[int, Optional[np.ndarray]] = {}

    def step(self, params: np.ndarray, grads: np.ndarray, key: int = 0,
             lr: Optional[float] = None) -> np.ndarray:
        """In-place Adagrad step on a contiguous fp32 shard; returns params."""
        check_params(params)
        grads = as_grads(grads, params.size)
        if key not in self._v:
            self._v[key] = np.zeros(params.size, np.float32)
        rc = self.lib.dstpu_adagrad_step(
            params.ctypes.data, grads.ctypes.data, self._v[key].ctypes.data, params.size,
            np.float32(lr or self.lr), np.float32(self.eps), np.float32(self.weight_decay))
        if rc != 0:
            raise RuntimeError(f"cpu adagrad step failed rc={rc}")
        return params

    def state_dict(self) -> Dict[str, Any]:
        return {"v": {k: v.copy() for k, v in self._v.items()}}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self._v = {k: np.asarray(v) for k, v in sd["v"].items()}
