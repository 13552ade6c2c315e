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

Host ops (:class:`HostOpBuilder`): the ZeRO-Offload optimizers and the
async-I/O engine are the repo's own host C++ (``csrc/adam/cpu_adam.cpp``,
``csrc/lion/cpu_lion.cpp``, ``csrc/adagrad/cpu_adagrad.cpp``,
``csrc/aio/aio_engine.cpp`` at the repo root), compiled in place by
``g++ -O3 -shared -fPIC -std=c++17 -fopenmp`` with the SIMD flag sets the
JAX package's builder tries, in its order (``-march=native``, then
``-mavx2 -mfma``, then none), so both packages run the same host code.
Each library lands in ``build/kernels/host/``, named by a digest of the
source, the flag sets, the compiler's version and the host CPU's ISA
flags (a ``-march=native`` build never loads on another CPU), written
under a temporary name and renamed into place (concurrent builders never
see half a file).  A failed build raises.
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
#: the repo root's host C++ (shared with the JAX package, compiled here
#: by the port's own builder)
HOST_CSRC = CSRC.parent.parent / "csrc"
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
    all nvcc processes started together; each build reports one compile
    (kind ``nvcc``) to the recompile sentinel's stream.  Returns seconds
    per kernel compiled in this call; raises KernelBuildError on any
    failure."""
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
    from ..telemetry.compile_sentinel import note_compile

    for n in todo:
        note_compile("nvcc", secs[n])
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


# ---------------------------------------------------------------------------
# host ops: g++ into build/kernels/host/, bound with ctypes
# ---------------------------------------------------------------------------
_c_p, _c_i, _c_i64, _c_f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
HOST_BASE_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp"]
#: tried in order, the first that compiles is kept (the JAX builder's list)
SIMD_CANDIDATES = [["-march=native"], ["-mavx2", "-mfma"], []]


def _host_isa() -> str:
    """The CPU's ISA flags line (``/proc/cpuinfo``): part of a host op's
    digest, so a library built with ``-march=native`` on one CPU is never
    loaded on another."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform

    return platform.processor() or platform.machine()


def _cxx() -> str:
    """``g++`` from PATH, as the JAX package's builder runs it."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise KernelBuildError("g++ not found on PATH: the host ops are built from source")
    return cxx


def _cxx_version(cxx: str) -> str:
    out = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    if out.returncode != 0:
        raise KernelBuildError(f"{cxx} --version failed: {out.stderr}")
    return out.stdout.splitlines()[0] if out.stdout else ""


class HostOpBuilder:
    """One host C++ op: ``load()`` compiles it if its library is missing and
    binds ``signatures`` (name -> (restype, argtypes))."""

    name = ""
    source = ""  # relative to the repo root's csrc/
    extra_flags: List[str] = []
    simd_candidates: List[List[str]] = [[]]
    signatures: Dict[str, tuple] = {}

    def lib_path(self) -> Path:
        cxx = _cxx()
        h = hashlib.sha256((HOST_CSRC / self.source).read_bytes())
        h.update(repr((HOST_BASE_FLAGS, self.simd_candidates, self.extra_flags)).encode())
        h.update(_cxx_version(cxx).encode())
        h.update(_host_isa().encode())
        return build_dir() / "host" / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        final = self.lib_path()
        if final.exists():
            return final
        src = HOST_CSRC / self.source
        final.parent.mkdir(parents=True, exist_ok=True)
        tmp = final.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cxx = _cxx()
        errors = []
        for simd in self.simd_candidates:
            cmd = [cxx, *HOST_BASE_FLAGS, *simd, str(src), "-o", str(tmp), *self.extra_flags]
            p = subprocess.run(cmd, capture_output=True, text=True)
            if p.returncode == 0:
                os.replace(tmp, final)  # atomic: a reader never sees half a file
                build_log[self.name] = {"flags": simd, "log": p.stderr}
                return final
            errors.append(f"{' '.join(simd) or '(no SIMD flags)'}: {p.stderr}")
            tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"{cxx} failed for {src.name} with every flag set:\n"
                               + "\n".join(errors))

    def load(self) -> ctypes.CDLL:
        with _lock:
            lib = _libs.get(self.name)
            if lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for fn, (restype, argtypes) in self.signatures.items():
                    f = getattr(lib, fn)
                    f.restype = restype
                    f.argtypes = list(argtypes)
                _libs[self.name] = lib
            return lib


class CPUAdamBuilder(HostOpBuilder):
    name = "cpu_adam"
    source = "adam/cpu_adam.cpp"
    simd_candidates = SIMD_CANDIDATES
    signatures = {
        # params grads exp_avg exp_avg_sq n step lr b1 b2 eps wd adamw bias_correction
        "dstpu_adam_step": (_c_i, [_c_p, _c_p, _c_p, _c_p, _c_i64, _c_i64, _c_f, _c_f,
                                   _c_f, _c_f, _c_f, _c_i, _c_i]),
        # params grads_bf16 exp_avg exp_avg_sq params_bf16_out n step lr ...
        "dstpu_adam_step_bf16g": (_c_i, [_c_p, _c_p, _c_p, _c_p, _c_p, _c_i64, _c_i64, _c_f,
                                         _c_f, _c_f, _c_f, _c_f, _c_i, _c_i]),
        "dstpu_simd_width": (_c_i, []),
    }


class CPULionBuilder(HostOpBuilder):
    name = "cpu_lion"
    source = "lion/cpu_lion.cpp"
    simd_candidates = SIMD_CANDIDATES
    signatures = {"dstpu_lion_step": (_c_i, [_c_p, _c_p, _c_p, _c_i64, _c_f, _c_f, _c_f, _c_f])}


class CPUAdagradBuilder(HostOpBuilder):
    name = "cpu_adagrad"
    source = "adagrad/cpu_adagrad.cpp"
    simd_candidates = SIMD_CANDIDATES
    signatures = {"dstpu_adagrad_step": (_c_i, [_c_p, _c_p, _c_p, _c_i64, _c_f, _c_f, _c_f])}


class AsyncIOBuilder(HostOpBuilder):
    name = "async_io"
    source = "aio/aio_engine.cpp"
    extra_flags = ["-lpthread"]
    signatures = {
        "dstpu_aio_create": (_c_p, [_c_i, _c_i, _c_i]),
        "dstpu_aio_create_ex": (_c_p, [_c_i, _c_i, _c_i, _c_i]),
        "dstpu_aio_destroy": (None, [_c_p]),
        "dstpu_aio_pwrite": (_c_i64, [_c_p, ctypes.c_char_p, _c_p, _c_i64, _c_i64]),
        "dstpu_aio_pread": (_c_i64, [_c_p, ctypes.c_char_p, _c_p, _c_i64, _c_i64]),
        "dstpu_aio_drain": (_c_i64, [_c_p]),
        "dstpu_aio_wait": (_c_i, [_c_p, _c_i64]),
        "dstpu_aio_pending": (_c_i64, [_c_p]),
        "dstpu_aio_backend_kind": (_c_i, [_c_p]),
        "dstpu_pin_alloc": (_c_p, [_c_i64]),
        "dstpu_pin_free": (None, [_c_p, _c_i64]),
    }


