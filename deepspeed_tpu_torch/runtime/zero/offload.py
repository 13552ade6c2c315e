"""Optimizer state in host RAM (ZeRO-Offload) and its NVMe spill
(ZeRO-Infinity): the counterpart of ``deepspeed_tpu/runtime/zero/offload.py``.

The fp32 master weights and the optimizer moments live in host RAM as
numpy arrays, one flat array per parameter leaf (the port's leaves in
``named_parameters()`` order).  Each boundary hands the host the gradients,
the SIMD C++ optimizer (``ops/cpu``: Adam, or Lion / Adagrad by the
optimizer's name) updates master and moments in place, and the caller
copies the compute-dtype params back to the device.

With ``nvme_path`` the step is pipelined like the reference's
``PipelinedOptimizerSwapper``: leaf i+1's moment reads are in flight while
leaf i runs its update (ping-pong read handles, so waiting on leaf i
never waits on leaf i+1's prefetch), and spills drain in windows of
``spill_window`` leaves behind the compute.

A step is ``begin_step`` -> ``step_leaves`` over consecutive runs of leaves
-> ``finish_step``: the engine streams gradients through bounded host
buffers and hands each run over as it lands.  :meth:`apply_step` is the
JAX module's whole-list call (scale, clip, update every leaf).

Held in RAM, each leaf's moments are allocated (and touched) with its
master, so the host state is whole from the start: a checkpoint load
(``checkpoint/saving.py``, through :meth:`checkpoint_state`) fills the
live arrays in place, one leaf at a time, as the first step would.
"""

from __future__ import annotations

import mmap
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops.cpu.adam import DeepSpeedCPUAdam
from ...utils.logging import logger


def scale_and_clip(grads_flat: List[np.ndarray], denom: float, grad_clip: float,
                   shapes: Optional[List[Tuple[int, ...]]] = None
                   ) -> Tuple[List[np.ndarray], float]:
    """Scale grads by 1/denom, take the global norm (each leaf's fp32 dot,
    summed in float64), clip.  ``shapes=None`` flattens each leaf; otherwise
    leaves are reshaped."""
    gs = []
    sq = 0.0
    for i, g in enumerate(grads_flat):
        g = np.asarray(g, np.float32)
        g = (g.ravel() if shapes is None else g.reshape(shapes[i])) / denom
        sq += float(np.dot(g.ravel(), g.ravel()))
        gs.append(g)
    norm = float(np.sqrt(sq))
    scale = clip_coefficient(norm, grad_clip)
    if scale is not None:
        gs = [g * scale for g in gs]
    return gs, norm


def clip_coefficient(norm: float, grad_clip: float) -> Optional[float]:
    """The factor the gradients are multiplied by, or None when they are not
    clipped."""
    if grad_clip > 0 and norm > grad_clip:
        return grad_clip / (norm + 1e-6)
    return None


def _leaves(params: Any) -> List[Any]:
    if isinstance(params, torch.nn.Module):
        return [p for _, p in params.named_parameters()]
    return list(params)


def _host_copy(x: Any) -> np.ndarray:
    """A flat fp32 host array of ``x`` that shares no memory with it (a
    device tensor's copy to the host is new already: no second copy)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", torch.float32)
        arr = t.numpy().ravel()
        return arr.copy() if t.data_ptr() == x.data_ptr() else arr
    return np.asarray(x, np.float32).ravel().copy()


def resident_zeros(n: int) -> np.ndarray:
    """fp32 zeros whose pages are mapped now (``np.zeros`` maps them at the
    first write, so the host's resident set would grow then): one write a
    page faults each in, zeroed by the kernel."""
    a = np.zeros(n, np.float32)
    a[::mmap.PAGESIZE // a.itemsize] = 0.0
    return a


class SpilledMoment:
    """Leaf ``key``'s moment in its NVMe spill file, read whole into a new
    host array and written back from one.  ``moments`` is the host op's dict
    for this moment: a key it lacks is a moment the first step has not made
    yet, which reads as the zeros that step starts from; a write puts the
    moment on disk and marks it so (None), so the next step fetches it."""

    dtype = np.dtype(np.float32)

    def __init__(self, path: str, size: int, moments: Dict[int, Any], key: int):
        self.path, self.size, self.shape = path, size, (size,)
        self.moments, self.key = moments, key

    def read(self) -> np.ndarray:
        out = np.zeros(self.size, np.float32)
        if self.key not in self.moments:
            return out
        view = memoryview(out).cast("B")
        with open(self.path, "rb", buffering=0) as f:
            got = 0
            while got < view.nbytes:
                n = f.readinto(view[got:])
                if not n:
                    raise OSError(f"{self.path}: spill file ends early")
                got += n
        return out

    def write(self, a: np.ndarray) -> None:
        with open(self.path, "wb") as f:
            f.write(memoryview(np.ascontiguousarray(a, np.float32)).cast("B"))
        self.moments[self.key] = None


def build_cpu_optimizer(optimizer_config: Dict[str, Any]):
    """The host op the optimizer's name selects: Lion, Adagrad, else Adam."""
    params = dict(optimizer_config.get("params") or {})
    otype = str(optimizer_config.get("type", "adamw")).lower()
    wd = float(params.get("weight_decay", 0.0))
    if "lion" in otype:
        from ...ops.cpu.lion import DeepSpeedCPULion

        betas = params.get("betas", (0.9, 0.99))
        return DeepSpeedCPULion(lr=float(params.get("lr", 1e-4)),
                                betas=(float(betas[0]), float(betas[1])), weight_decay=wd)
    if "adagrad" in otype:
        from ...ops.cpu.adagrad import DeepSpeedCPUAdagrad

        return DeepSpeedCPUAdagrad(lr=float(params.get("lr", 1e-2)),
                                   eps=float(params.get("eps", 1e-10)), weight_decay=wd)
    betas = params.get("betas", (0.9, 0.999))
    return DeepSpeedCPUAdam(lr=float(params.get("lr", 1e-3)),
                            betas=(float(betas[0]), float(betas[1])),
                            eps=float(params.get("eps", 1e-8)), weight_decay=wd,
                            adamw_mode=bool(params.get("adam_w_mode", True))
                            or otype.endswith("w"))


class HostOffloadedOptimizer:
    """Host master state and the boundary step over it.  ``abstract_params``
    is taken for the JAX module's signature; the leaves arrive with
    :meth:`initialize_master` (or :meth:`adopt_master`)."""

    def __init__(self, abstract_params: Any, optimizer_config: Dict[str, Any],
                 grad_clip: float = 0.0, nvme_path: Optional[str] = None,
                 aio_threads: int = 4, shared_handles: bool = True):
        self.cpu_adam = build_cpu_optimizer(optimizer_config)
        self.grad_clip = grad_clip
        self.master: List[np.ndarray] = []
        self.nvme_path = nvme_path
        self._nvme = bool(nvme_path)
        self._aio = None
        #: spill-drain cadence: host RAM holds about this many leaves' moments
        #: while writes stay off the critical path
        self.spill_window = 4
        if nvme_path:
            os.makedirs(nvme_path, exist_ok=True)
        # shared_handles=False: a subclass brings its own per-worker handles
        if nvme_path and shared_handles:
            from ...ops.cpu.aio import AsyncIOHandle

            self._aio = AsyncIOHandle(thread_count=aio_threads)
            self._fetch_aio = [AsyncIOHandle(thread_count=max(1, aio_threads // 2)),
                               AsyncIOHandle(thread_count=max(1, aio_threads // 2))]
            self._inflight_fetch: List[list] = [[], []]
            self._spill_pending: List[int] = []
        self._issued_upto = -1  # highest leaf whose moment fetch was issued this step

    def initialize_master(self, init_params: Any) -> None:
        """fp32 host copies of ``init_params`` (a ParamTree or a sequence of
        tensors / arrays), one flat array per leaf."""
        self.master = [_host_copy(x) for x in _leaves(init_params)]
        for i in range(len(self.master)):
            self._alloc_moments(i)
        logger.info(f"host-offload: {sum(m.size for m in self.master) / 1e6:.1f}M fp32 master "
                    f"elements in host RAM")

    def adopt_master(self, i: int, leaf: torch.Tensor) -> None:
        """Append leaf ``i``'s fp32 host copy (the engine moves the master one
        leaf at a time, freeing each device copy as it goes)."""
        if i != len(self.master):
            raise ValueError(f"adopt_master: leaf {i} out of order ({len(self.master)} held)")
        self.master.append(_host_copy(leaf))
        self._alloc_moments(i)

    def _alloc_moments(self, i: int) -> None:
        """Leaf ``i``'s zero moments in RAM (with NVMe they are made at the
        first step and spilled)."""
        if not self._nvme:
            for _, d in self._moment_dicts():
                d[i] = resident_zeros(self.master[i].size)

    # -- host memory accounting ------------------------------------------------
    def master_bytes(self) -> int:
        """Host RAM held by the fp32 master leaves."""
        return int(sum(m.nbytes for m in self.master if m is not None))

    def moment_bytes(self) -> int:
        """Host RAM held by resident optimizer moments (spilled leaves count 0)."""
        return int(sum(v.nbytes for _, d in self._moment_dicts() for v in d.values()
                       if v is not None))

    def _moment_dicts(self):
        """Adam keeps m and v, Lion m, Adagrad v: spill and fetch what exists."""
        return [(attr.strip("_"), getattr(self.cpu_adam, attr)) for attr in ("_m", "_v")
                if getattr(self.cpu_adam, attr, None) is not None]

    # -- the NVMe layout: one file per moment and leaf ---------------------------
    def _submit_fetch(self, aio, key: int, n: int):
        entries = []
        for name, d in self._moment_dicts():
            buf = np.empty(n, np.float32)
            aio.async_pread(buf, f"{self.nvme_path}/{name}_{key}.bin")
            entries.append((d, buf))
        return entries

    @staticmethod
    def _install_fetch(entries, key: int) -> None:
        for d, buf in entries:
            d[key] = buf

    def _submit_spill(self, aio, key: int) -> bool:
        dicts = self._moment_dicts()
        if not dicts or any(d.get(key) is None for _, d in dicts):
            return False  # absent, or already on disk
        for name, d in dicts:
            aio.async_pwrite(d[key], f"{self.nvme_path}/{name}_{key}.bin")
        return True

    def _free_moments(self, key: int) -> None:
        for _, d in self._moment_dicts():
            d[key] = None  # spilled

    def _needs_fetch(self, key: int) -> bool:
        # present but None: on disk; absent: first step, the op zero-fills
        dicts = self._moment_dicts()
        return bool(dicts) and key in dicts[0][1] and dicts[0][1][key] is None

    def _fetch_with(self, aio, key: int) -> None:
        """Synchronous fetch on a private handle (SuperOffload's workers)."""
        if self._nvme and self._needs_fetch(key):
            entries = self._submit_fetch(aio, key, self.master[key].size)
            aio.drain()
            self._install_fetch(entries, key)

    def _spill_with(self, aio, key: int) -> None:
        """Spill leaf ``key``'s moments on a private handle and free them."""
        if self._nvme and self._submit_spill(aio, key):
            aio.drain()
            self._free_moments(key)

    # -- the pipelined swap on the shared handles --------------------------------
    def _issue_fetch(self, key: int) -> None:
        if key >= len(self.master) or key <= self._issued_upto:
            return
        self._issued_upto = key
        if self._needs_fetch(key):
            slot = key % 2
            entries = self._submit_fetch(self._fetch_aio[slot], key, self.master[key].size)
            self._inflight_fetch[slot].append((key, entries))

    def _commit_fetch(self, slot: int) -> None:
        if self._inflight_fetch[slot]:
            self._fetch_aio[slot].drain()
            for key, entries in self._inflight_fetch[slot]:
                self._install_fetch(entries, key)
            self._inflight_fetch[slot] = []

    def _issue_spill(self, key: int) -> None:
        if self._submit_spill(self._aio, key):
            self._spill_pending.append(key)

    def _flush_spills(self) -> None:
        if self._spill_pending:
            self._aio.drain()
            for key in self._spill_pending:
                self._free_moments(key)
            self._spill_pending = []

    # -- the boundary step ---------------------------------------------------------
    def begin_step(self, lr: float) -> None:
        self._issued_upto = -1

    def step_leaves(self, start: int, grads: Sequence[np.ndarray], lr: float) -> None:
        """Update leaves ``start .. start + len(grads) - 1`` from their scaled,
        clipped fp32 gradients, in place."""
        for k, g in enumerate(grads):
            i = start + k
            if self.master[i].size != np.size(g):
                raise ValueError(f"grad/master size mismatch at leaf {i}")
            if self._aio is None:
                self.cpu_adam.step(self.master[i], g, key=i, lr=lr)
                continue
            self._issue_fetch(i)
            self._issue_fetch(i + 1)
            self._commit_fetch(i % 2)
            self.cpu_adam.step(self.master[i], g, key=i, lr=lr)
            self._issue_spill(i)
            self._issue_fetch(i + 2)
            if len(self._spill_pending) >= self.spill_window:
                self._flush_spills()

    def finish_step(self, lr: float) -> Iterable[int]:
        """End the step; returns the leaves changed after their ``step_leaves``
        (none here: the caller's copies of the others are current)."""
        if self._aio is not None:
            self._flush_spills()
        return ()

    def apply_step(self, grads_flat: List[np.ndarray], lr: float,
                   denom: float) -> Tuple[List[np.ndarray], float]:
        """Scale, clip and update every leaf; returns (master leaves, global
        grad norm)."""
        gs, norm = scale_and_clip(grads_flat, denom, self.grad_clip)
        self.begin_step(lr)
        self.step_leaves(0, gs, lr)
        self.finish_step(lr)
        return self.master, norm

    def master_as_tree(self, like: torch.nn.Module) -> torch.nn.Module:
        """The master as a CPU ParamTree shaped like ``like`` (no copy)."""
        it = iter(self.master)
        return like.map(lambda t: torch.from_numpy(next(it).reshape(t.shape)))

    def state_dict(self) -> Dict[str, Any]:
        return {"adam": self.cpu_adam.state_dict(), "master": [m.copy() for m in self.master]}

    # -- checkpoints: the live arrays, read and refilled in place ---------------
    def _spill_file(self, name: str, key: int) -> str:
        return f"{self.nvme_path}/{name}_{key}.bin"

    def checkpoint_state(self) -> Dict[str, List[Any]]:
        """The host arrays a checkpoint holds, by name, one entry per leaf:
        the live flat fp32 arrays (every moment in RAM exists from the
        start), or a :class:`SpilledMoment` for a moment on NVMe or not
        made yet there.  Making the list changes nothing: a load writes
        only what it loads."""
        out: Dict[str, List[Any]] = {"master": list(self.master)}
        for name, d in self._moment_dicts():
            out[name] = [d[i] if d.get(i) is not None else
                         SpilledMoment(self._spill_file(name, i), m.size, d, i)
                         for i, m in enumerate(self.master)]
        return out

    def checkpoint_scalars(self) -> Dict[str, np.ndarray]:
        """The host op's per-leaf step counts (Adam's bias correction)."""
        t = getattr(self.cpu_adam, "_t", None)
        if t is None:
            return {}
        return {"t": np.asarray([t.get(i, 0) for i in range(len(self.master))], np.int64)}

    def load_checkpoint_scalars(self, scalars: Dict[str, np.ndarray]) -> None:
        if "t" in scalars and hasattr(self.cpu_adam, "_t"):
            self.cpu_adam._t = {i: int(x) for i, x in enumerate(scalars["t"]) if x}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.cpu_adam.load_state_dict(sd["adam"])
        self.master = [np.asarray(m) for m in sd["master"]]

    def close(self) -> None:
        """Stop the I/O handles' threads."""
        for h in [self._aio, *getattr(self, "_fetch_aio", [])]:
            if h is not None:
                h.close()
