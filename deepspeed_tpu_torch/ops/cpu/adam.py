"""Host Adam (ZeRO-Offload's optimizer): the counterpart of
``deepspeed_tpu/ops/cpu/adam.py``'s ``DeepSpeedCPUAdam``.

fp32 master shards and both moments live in host RAM as numpy arrays; each
step runs the SIMD C++ Adam (``csrc/adam/cpu_adam.cpp``, OpenMP-threaded;
its ctypes call releases the GIL) on one contiguous shard, in place.  Step
counts are kept per key (bias correction is per parameter, and separate
counts make concurrent per-leaf steps safe: SuperOffload's workers).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..op_builder import CPUAdamBuilder
from ._common import as_grads, check_params


class DeepSpeedCPUAdam:
    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True,
                 bias_correction: bool = True):
        self.lib = CPUAdamBuilder().load()
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.bias_correction = bias_correction
        self._m: Dict[int, Optional[np.ndarray]] = {}
        self._v: Dict[int, Optional[np.ndarray]] = {}
        self._t: Dict[int, int] = {}

    @property
    def step_count(self) -> int:
        return max(self._t.values(), default=0)

    def _state_for(self, key: int, n: int):
        if key not in self._m:
            self._m[key] = np.zeros(n, np.float32)
            self._v[key] = np.zeros(n, np.float32)
        return self._m[key], self._v[key]

    def _args(self, lr: Optional[float]):
        return (np.float32(lr or self.lr), np.float32(self.beta1), np.float32(self.beta2),
                np.float32(self.eps), np.float32(self.weight_decay), int(self.adamw_mode),
                int(self.bias_correction))

    def step(self, params: np.ndarray, grads: np.ndarray, key: int = 0,
             lr: Optional[float] = None) -> np.ndarray:
        """In-place Adam step on a contiguous fp32 shard; returns params."""
        check_params(params)
        grads = as_grads(grads, params.size)
        m, v = self._state_for(key, params.size)
        self._t[key] = t = self._t.get(key, 0) + 1
        rc = self.lib.dstpu_adam_step(params.ctypes.data, grads.ctypes.data, m.ctypes.data,
                                      v.ctypes.data, params.size, t, *self._args(lr))
        if rc != 0:
            raise RuntimeError(f"cpu adam step failed rc={rc}")
        return params

    def step_bf16_grads(self, params: np.ndarray, grads_bf16: np.ndarray, key: int = 0,
                        lr: Optional[float] = None) -> np.ndarray:
        """Adam step with bf16 grads (a uint16 view); returns the updated
        params rounded to bf16 (uint16 view), the master staying fp32."""
        check_params(params)
        g = np.ascontiguousarray(grads_bf16.view(np.uint16))
        if g.size != params.size:
            raise ValueError(f"grads have {g.size} elements, params {params.size}")
        m, v = self._state_for(key, params.size)
        out = np.empty(params.size, np.uint16)
        self._t[key] = t = self._t.get(key, 0) + 1
        rc = self.lib.dstpu_adam_step_bf16g(params.ctypes.data, g.ctypes.data, m.ctypes.data,
                                            v.ctypes.data, out.ctypes.data, params.size, t,
                                            *self._args(lr))
        if rc != 0:
            raise RuntimeError(f"cpu adam step failed rc={rc}")
        return out

    def state_dict(self) -> Dict[str, Any]:
        return {"t": dict(self._t),
                "m": {k: v.copy() for k, v in self._m.items()},
                "v": {k: v.copy() for k, v in self._v.items()}}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        if "t" in sd:
            self._t = {k: int(v) for k, v in sd["t"].items()}
        else:  # a single global count (the older checkpoint layout)
            self._t = {k: int(sd.get("step", 0)) for k in sd["m"]}
        self._m = {k: np.asarray(v) for k, v in sd["m"].items()}
        self._v = {k: np.asarray(v) for k, v in sd["v"].items()}
