"""Accelerator abstraction (the port's counterpart of
``deepspeed_tpu/accelerator``).

:class:`Accelerator` is the JAX package's name-compatible surface over
``torch.cuda`` (:class:`CUDAAccelerator`: real streams and events, the
CUDA generators, the caching allocator's statistics under the JAX key
names, ``nccl``) or over the host (:class:`CPUAccelerator`: no-op stream
and event shims, the CPU generator, the process's resident set, ``gloo``).
:func:`get_accelerator` picks one as the JAX package does: the
``DS_ACCELERATOR`` environment variable first (``cuda`` or ``cpu``), then
``cuda`` when ``torch.cuda.is_available()``, else ``cpu``; it caches the
choice under a lock, and :func:`set_accelerator` replaces it.

:func:`resolve_device` is how every entry point of the port picks its
device: ``cuda`` unless the caller asks for the CPU explicitly, and never
the CPU on its own.  :func:`memory_stats` and :func:`memory_counters` read
the caching allocator (or the host) for the accelerators and the memory
ledger.
"""

from __future__ import annotations

import os
import resource
import sys
import threading
from typing import Any, Dict, List, Optional, Union

import torch

__all__ = ["DeviceLike", "resolve_device", "default_device", "memory_stats",
           "memory_counters", "Accelerator", "CUDAAccelerator", "CPUAccelerator",
           "get_accelerator", "set_accelerator"]

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


class _NoOpStream:
    """The host has no streams: a context that orders nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def synchronize(self) -> None:
        pass

    def wait_stream(self, other) -> None:  # noqa: ARG002
        pass


class _NoOpEvent:
    def record(self, stream=None) -> None:  # noqa: ARG002
        pass

    def synchronize(self) -> None:
        pass

    def wait(self, stream=None) -> None:  # noqa: ARG002
        pass

    def elapsed_time(self, other) -> float:  # noqa: ARG002
        return 0.0


class Accelerator:
    """The JAX package's accelerator surface; the subclasses bind it to a
    device type."""

    _name = "cpu"
    _communication_backend = "gloo"

    # --- identity -------------------------------------------------------
    def device_name(self, device_index: Optional[int] = None) -> str:
        if device_index is None:
            return self._name
        return f"{self._name}:{device_index}"

    def is_available(self) -> bool:
        return self.device_count() > 0

    def device_count(self) -> int:
        return 1

    def current_device(self) -> int:
        return 0

    def current_device_name(self) -> str:
        return self.device_name(self.current_device())

    def set_device(self, device_index: int) -> None:  # noqa: ARG002
        pass

    def _device(self, device_index: Optional[int] = None) -> torch.device:
        """The ``torch.device`` of ``device_index`` (None: the current one)."""
        idx = self.current_device() if device_index is None else device_index
        return torch.device(self._name, idx) if self._name == "cuda" else torch.device("cpu")

    # --- execution ------------------------------------------------------
    def synchronize(self, device_index: Optional[int] = None) -> None:  # noqa: ARG002
        pass

    def Stream(self, *a, **k) -> Any:  # noqa: N802, ARG002
        return _NoOpStream()

    def stream(self, stream) -> Any:  # noqa: ARG002
        return _NoOpStream()

    def current_stream(self, device_index=None) -> Any:  # noqa: ARG002
        return _NoOpStream()

    def default_stream(self, device_index=None) -> Any:  # noqa: ARG002
        return _NoOpStream()

    def Event(self, *a, **k) -> Any:  # noqa: N802, ARG002
        return _NoOpEvent()

    def device_supports_graphs(self) -> bool:
        return False

    # --- RNG ------------------------------------------------------------
    def manual_seed(self, seed: int) -> None:
        torch.manual_seed(int(seed))

    def initial_seed(self) -> int:
        return torch.initial_seed()

    def default_generator(self, device_index: int = 0) -> torch.Generator:  # noqa: ARG002
        return torch.default_generator

    # --- memory ---------------------------------------------------------
    def memory_stats(self, device_index: Optional[int] = None) -> Dict[str, int]:
        return memory_stats(self._device(device_index))

    def memory_counters(self, device_index: Optional[int] = None) -> Dict[str, int]:
        """``bytes_in_use`` and ``peak_bytes_in_use`` from one cheap read."""
        return memory_counters(self._device(device_index))

    def aggregate_memory_stats(self) -> Dict[str, int]:
        """Memory stats summed over this process's devices, key by key."""
        out: Dict[str, int] = {}
        for i in range(self.device_count()):
            for k, v in self.memory_stats(i).items():
                out[k] = out.get(k, 0) + int(v)
        return out

    def memory_allocated(self, device_index: Optional[int] = None) -> int:
        return int(self.memory_counters(device_index).get("bytes_in_use", 0))

    def max_memory_allocated(self, device_index: Optional[int] = None) -> int:
        return int(self.memory_counters(device_index).get("peak_bytes_in_use", 0))

    def reset_peak_memory_stats(self, device_index: Optional[int] = None) -> None:  # noqa: ARG002
        pass  # the process's peak resident set cannot be reset

    def total_memory(self, device_index: Optional[int] = None) -> int:
        return int(self.memory_stats(device_index).get("bytes_limit", 0))

    def available_memory(self, device_index: Optional[int] = None) -> int:
        s = self.memory_stats(device_index)
        return max(0, int(s.get("bytes_limit", 0)) - int(s.get("bytes_in_use", 0)))

    def empty_cache(self) -> None:
        pass

    # --- dtype support --------------------------------------------------
    def is_bf16_supported(self) -> bool:
        return True

    def is_fp16_supported(self) -> bool:
        return True

    def is_fp8_supported(self) -> bool:
        return False

    def supported_dtypes(self) -> List[torch.dtype]:
        out = [torch.float32, torch.bfloat16, torch.float16]
        if self.is_fp8_supported():
            out += [torch.float8_e4m3fn, torch.float8_e5m2]
        return out

    # --- comm / ops -----------------------------------------------------
    def communication_backend_name(self) -> str:
        return self._communication_backend

    def create_op_builder(self, name: str):
        from ..ops.op_builder import get_builder

        return get_builder(name)

    def get_op_builder(self, name: str):
        from ..ops.op_builder import get_builder

        return type(get_builder(name))

    # --- misc -----------------------------------------------------------
    def range_push(self, msg: str) -> None:
        """Open a named range on the profiler's host timeline; ranges nest
        and ``range_pop`` closes the innermost."""
        rf = torch.profiler.record_function(msg)
        rf.__enter__()
        self._ranges = getattr(self, "_ranges", [])
        self._ranges.append(rf)

    def range_pop(self) -> None:
        ranges = getattr(self, "_ranges", [])
        if ranges:
            ranges.pop().__exit__(None, None, None)

    def lazy_call(self, callback) -> None:
        callback()

    def communication_backend_version(self) -> str:
        return torch.__version__

    def handles_memory_backpressure(self) -> bool:
        return False

    def visible_devices_envs(self) -> List[str]:
        return []


class CUDAAccelerator(Accelerator):
    """The card: every method over ``torch.cuda``."""

    _name = "cuda"
    _communication_backend = "nccl"

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def current_device(self) -> int:
        return torch.cuda.current_device()

    def set_device(self, device_index: int) -> None:
        torch.cuda.set_device(device_index)

    def device_kind(self) -> str:
        """The card's name (``nvidia-smi``'s ``name``)."""
        return torch.cuda.get_device_name(self.current_device())

    def synchronize(self, device_index: Optional[int] = None) -> None:
        torch.cuda.synchronize(device_index)

    def Stream(self, *a, **k) -> torch.cuda.Stream:  # noqa: N802
        return torch.cuda.Stream(*a, **k)

    def stream(self, stream):
        return torch.cuda.stream(stream)

    def current_stream(self, device_index=None) -> torch.cuda.Stream:
        return torch.cuda.current_stream(device_index)

    def default_stream(self, device_index=None) -> torch.cuda.Stream:
        return torch.cuda.default_stream(device_index)

    def Event(self, *a, **k) -> torch.cuda.Event:  # noqa: N802
        """A CUDA event that records timing unless ``enable_timing=False``
        (``elapsed_time`` needs it)."""
        k.setdefault("enable_timing", True)
        return torch.cuda.Event(*a, **k)

    def device_supports_graphs(self) -> bool:
        return True

    def manual_seed(self, seed: int) -> None:
        torch.cuda.manual_seed(int(seed))

    def initial_seed(self) -> int:
        return torch.cuda.initial_seed()

    def default_generator(self, device_index: int = 0) -> torch.Generator:
        return torch.cuda.default_generators[device_index]

    def reset_peak_memory_stats(self, device_index: Optional[int] = None) -> None:
        torch.cuda.reset_peak_memory_stats(device_index)

    def empty_cache(self) -> None:
        torch.cuda.empty_cache()

    def is_bf16_supported(self) -> bool:
        return torch.cuda.is_bf16_supported()

    def is_fp8_supported(self) -> bool:
        return torch.cuda.get_device_capability(self.current_device()) >= (8, 9)

    def range_push(self, msg: str) -> None:
        torch.cuda.nvtx.range_push(msg)

    def range_pop(self) -> None:
        torch.cuda.nvtx.range_pop()

    def communication_backend_version(self) -> str:
        return ".".join(str(v) for v in torch.cuda.nccl.version())

    def visible_devices_envs(self) -> List[str]:
        return ["CUDA_VISIBLE_DEVICES"]


class CPUAccelerator(Accelerator):
    """The host: the CPU tests' accelerator (the JAX package's
    ``CPUAccelerator``): no-op stream and event shims, the process's
    resident set as its memory."""

    _name = "cpu"
    _communication_backend = "gloo"

    def aggregate_memory_stats(self) -> Dict[str, int]:
        return self.memory_stats()


_lock = threading.Lock()
_accelerator: Optional[Accelerator] = None


def get_accelerator() -> Accelerator:
    """The process's accelerator: ``DS_ACCELERATOR`` (``cuda`` or ``cpu``)
    when set, else ``cuda`` when a card is present, else ``cpu``; chosen
    once and cached."""
    global _accelerator
    if _accelerator is not None:
        return _accelerator
    with _lock:
        if _accelerator is not None:
            return _accelerator
        name = os.environ.get("DS_ACCELERATOR", "").lower()
        if not name:
            name = "cuda" if torch.cuda.is_available() else "cpu"
        if name not in ("cuda", "cpu"):
            raise ValueError(f"DS_ACCELERATOR={name!r}: the port knows 'cuda' and 'cpu'")
        _accelerator = CUDAAccelerator() if name == "cuda" else CPUAccelerator()
        return _accelerator


def set_accelerator(acc: Optional[Accelerator]) -> None:
    """Replace the cached accelerator (None: detect again at the next
    :func:`get_accelerator`)."""
    global _accelerator
    with _lock:
        _accelerator = acc
