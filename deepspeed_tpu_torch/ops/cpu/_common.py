"""Argument checks shared by the host optimizer ops."""

from __future__ import annotations

import numpy as np


def check_params(params: np.ndarray) -> None:
    """The host ops update ``params`` in place through its pointer: it must be
    a C-contiguous fp32 array."""
    if not isinstance(params, np.ndarray) or params.dtype != np.float32 \
            or not params.flags["C_CONTIGUOUS"]:
        raise TypeError("params must be a C-contiguous float32 numpy array, got "
                        f"{getattr(params, 'dtype', type(params))}")


def as_grads(grads: np.ndarray, n: int) -> np.ndarray:
    g = np.ascontiguousarray(grads, np.float32)
    if g.size != n:
        raise ValueError(f"grads have {g.size} elements, params {n}")
    return g
