"""Model-FLOPs-utilization accounting (the port's copy of
``deepspeed_tpu/telemetry/mfu.py``).

One canonical peak-FLOPs table (dense bf16, per chip) shared by the
telemetry gauges and the smoke's own MFU figure — a second copy of this
table drifting is how MFU numbers stop being comparable.  Sources:
published specs (H100 SXM 989T dense bf16; TPU v4 275T, v5e 197T, v5p
459T, v6e "Trillium" 918T).  On CUDA the device kind is the card's name
(``torch.cuda.get_device_name``: "NVIDIA H100 80GB HBM3"), matched
against the table like the JAX package's TPU ``device_kind``.

``DSTPU_PEAK_FLOPS`` overrides the lookup (useful on CPU smoke runs or
unlisted hardware).  The CPU entry is a nominal 1 TFLOP/s so host runs
still report a non-zero, clearly-not-a-chip number; a card that matches
no row falls to it too.
"""

from __future__ import annotations

import os
from typing import Any, Optional

#: per-chip peak dense-bf16 FLOP/s, keyed by device-kind substring
#: (matched case-insensitively, first hit wins — order specific to
#: generic)
PEAK_BF16_FLOPS = {
    "H100": 989e12,
    "TPU v5p": 459e12,
    "TPU v5 lite": 197e12,
    "TPU v5e": 197e12,
    "TPU v6 lite": 918e12,
    "TPU v6e": 918e12,
    "TPU v4": 275e12,
    "TPU v3": 123e12,
    "TPU v2": 45e12,
    "cpu": 1e12,  # nominal, so CPU runs still report something
}


def peak_flops_for_kind(device_kind: str) -> float:
    """Peak FLOP/s for a device-kind string (``DSTPU_PEAK_FLOPS`` wins)."""
    env = os.environ.get("DSTPU_PEAK_FLOPS")
    if env:
        return float(env)
    kind = str(device_kind).lower()
    for name, peak in PEAK_BF16_FLOPS.items():
        if name.lower() in kind:
            return peak
    return PEAK_BF16_FLOPS["cpu"]


def device_kind(device: Any = None) -> str:
    """The kind string of a torch device: the CUDA device's name, or
    ``"cpu"`` (default: the current CUDA device when a card is present)."""
    import torch

    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def peak_flops_for_device(device: Any = None) -> float:
    """Peak FLOP/s for a torch device (default: the current CUDA device,
    else the CPU)."""
    return peak_flops_for_kind(device_kind(device))


def mfu(model_flops: float, elapsed_s: float, n_chips: int = 1,
        device: Any = None, peak_flops: Optional[float] = None) -> float:
    """Model FLOPs utilization: useful-model FLOPs over what ``n_chips``
    could have done in ``elapsed_s`` at peak.  ``model_flops`` must be
    the MODEL cost (e.g. ``6*N + attn`` per token for training), not
    hardware-counter FLOPs — rematerialization must not inflate the
    number."""
    if elapsed_s <= 0 or n_chips <= 0:
        return 0.0
    peak = peak_flops if peak_flops is not None else peak_flops_for_device(device)
    if peak <= 0:
        return 0.0
    return float(model_flops) / elapsed_s / (n_chips * peak)
