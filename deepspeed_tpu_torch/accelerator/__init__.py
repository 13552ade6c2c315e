"""Accelerator (the port's counterpart of ``deepspeed_tpu/accelerator``).

The one entry is :func:`resolve_device`, through which every entry point
of the port picks its device: ``cuda`` unless the caller asks for the CPU
explicitly, and never the CPU on its own.  The rest of the reference
accelerator ABI is ported with the first slice that calls it.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["DeviceLike", "resolve_device"]

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA request without a CUDA device
    raises: only an explicit ``"cpu"`` runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepspeed_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
