"""Accelerator (the port's counterpart of ``deepspeed_tpu/accelerator``).

:func:`resolve_device` is how every entry point of the port picks its
device: ``cuda`` unless the caller asks for the CPU explicitly, and never
the CPU on its own.  :func:`memory_stats` and :func:`memory_counters` are
the reference's ``memory_stats()`` by its keys (``bytes_in_use``,
``peak_bytes_in_use``, ``bytes_limit``) for the memory ledger.  The rest
of the reference accelerator ABI is ported with the first slice that
calls it.
"""

from __future__ import annotations

import os
import resource
import sys
from typing import Dict, Union

import torch

__all__ = ["DeviceLike", "resolve_device", "default_device", "memory_stats",
           "memory_counters"]

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


def default_device() -> torch.device:
    """The device process-wide telemetry reads: the current CUDA device
    when a card is present, else the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def memory_counters(device: DeviceLike = None) -> Dict[str, int]:
    """``bytes_in_use`` and ``peak_bytes_in_use`` only: on CUDA the caching
    allocator's allocated bytes now and at peak (what
    ``torch.cuda.memory_allocated`` and ``max_memory_allocated`` return),
    read from one call of its statistics; on the CPU the process's
    resident set and its peak."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        alloc = torch.cuda.memory_stats_as_nested_dict(dev)["allocated_bytes"]["all"]
        return {"bytes_in_use": int(alloc["current"]), "peak_bytes_in_use": int(alloc["peak"])}
    return _cpu_stats(with_limit=False)


def memory_stats(device: DeviceLike = None) -> Dict[str, int]:
    """The counters of :func:`memory_counters` and ``bytes_limit``: on CUDA
    the card's total memory (``torch.cuda.mem_get_info``), on the CPU the
    host's ``MemTotal`` (the JAX package's ``CPUAccelerator`` reading)."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        out = memory_counters(dev)
        out["bytes_limit"] = int(torch.cuda.mem_get_info(dev)[1])
        return out
    return _cpu_stats(with_limit=True)


def _cpu_stats(with_limit: bool) -> Dict[str, int]:
    stats: Dict[str, int] = {}
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    # ru_maxrss is KiB on Linux, bytes on macOS
    stats["peak_bytes_in_use"] = peak if sys.platform == "darwin" else peak * 1024
    try:
        with open("/proc/self/statm") as f:
            stats["bytes_in_use"] = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        if with_limit:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        stats["bytes_limit"] = int(line.split()[1]) * 1024
                        break
    except OSError:
        stats.setdefault("bytes_in_use", stats["peak_bytes_in_use"])
    return stats
