"""Build and bind the port's CUDA kernels (counterpart of
``deepspeed_tpu/ops/op_builder.py``).

At first use each ``csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and
loaded with ``ctypes``.  Sources include the shared headers of ``csrc/``
(``hopper.cuh``: mbarriers, TMA, ``wgmma``) through ``-I csrc``.
Libraries land in ``build/kernels/`` at the repo root (git-ignored;
``DSTPU_TORCH_BUILD`` overrides), named by a digest of the source, every
``csrc/*.cuh`` header and the flags, so an edited source or header is
rebuilt and never read stale.  All sources build in parallel, one ``nvcc`` each.  A build
failure raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {
    "flash_attention_fwd": CSRC / "flash_attention_fwd.cu",
    "flash_attention_bwd": CSRC / "flash_attention_bwd.cu",
    "paged_attention": CSRC / "paged_attention.cu",
    "fused_adam": CSRC / "fused_adam.cu",
    "wq_matmul": CSRC / "wq_matmul.cu",
    "quantization": CSRC / "quantization.cu",
    "grouped_matmul": CSRC / "grouped_matmul.cu",
    "sparse_attention": CSRC / "sparse_attention.cu",
    "evoformer_attn": CSRC / "evoformer_attn.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-I", str(CSRC)]


class KernelBuildError(RuntimeError):
    pass


def build_dir() -> Path:
    env = os.environ.get("DSTPU_TORCH_BUILD")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or NVCC): the port's "
                           "CUDA kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS[:-1]).encode())  # not the checkout's path
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per kernel: seconds its nvcc took and what ptxas printed (registers,
#: shared memory, spills) — chip_smoke.py reports both
build_log: Dict[str, Dict[str, object]] = {}


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    all nvcc processes started together.  Returns seconds per kernel
    compiled in this call; raises KernelBuildError on any failure."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        final = _lib_path(n)
        tmp = final.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs.append((n, final, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    secs: Dict[str, float] = {}
    errors: List[str] = []
    for n, final, tmp, t0, p in procs:
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        build_log[n] = {"seconds": secs[n], "log": log}
        if p.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n].name} "
                          f"(exit {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, final)  # atomic: a reader never sees half a file
    if errors:
        raise KernelBuildError("\n".join(errors))
    return secs


def load(name: str, signatures: Dict[str, Sequence[type]]) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed, with ``argtypes`` set
    for every function in ``signatures`` (restype int: the CUDA error)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with cudaError_t {err}")


def dtype_code(dtype) -> int:
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    if dtype not in codes:
        raise TypeError(f"unsupported dtype {dtype} (fp32, bf16 or fp16)")
    return codes[dtype]
