"""Pluggable checkpoint engines — the port's copy of
``deepspeed_tpu/runtime/checkpoint_engine/engines.py`` (numpy on the host;
the fast engine writes through the port's ``ops/cpu/aio.py``).

Reference: ``runtime/checkpoint_engine/checkpoint_engine.py`` with torch
(sync), fast (AIO writer), decoupled (async background commit), nebula,
datastates variants.  Here:

  * ``NumpyCheckpointEngine`` — synchronous .npz writer (torch-equivalent).
  * ``FastCheckpointEngine``  — raw per-array writes through the C++ AIO
    engine (deepspeed/io fast_file_writer role).
  * ``DecoupledCheckpointEngine`` — hands the save to a background thread;
    ``commit()`` joins at the next boundary (reference
    decoupled_checkpoint_engine.py semantics).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

import numpy as np



class CheckpointSaveError(RuntimeError):
    """A (possibly background) checkpoint write failed.  Carries the
    failed path so an async failure surfacing later is attributed to
    the save that OWNED it, not whichever step happened to join."""

    def __init__(self, msg: str, path: Optional[str] = None):
        super().__init__(msg)
        self.path = path


class CheckpointEngine:
    def save(self, arrays: Dict[str, np.ndarray], path: str) -> None:
        raise NotImplementedError

    def load(self, path: str) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def commit(self, tag: str) -> bool:
        return True


class NumpyCheckpointEngine(CheckpointEngine):
    def save(self, arrays, path):
        np.savez(path, **arrays)

    def load(self, path):
        if not path.endswith(".npz"):
            path = path + ".npz"
        data = np.load(path)
        return {k: data[k] for k in data.files}


class FastCheckpointEngine(CheckpointEngine):
    """Raw binary per-tensor files + a json manifest, written through the
    AIO thread pool so large checkpoints overlap serialization with disk."""

    def __init__(self, thread_count: int = 4, block_size: int = 1 << 22):
        from ...ops.cpu.aio import AsyncIOHandle

        self.aio = AsyncIOHandle(thread_count=thread_count, block_size=block_size)

    def save(self, arrays, path):
        os.makedirs(path, exist_ok=True)
        manifest = {}
        for i, (key, arr) in enumerate(arrays.items()):
            shape = list(np.shape(arr))  # before ascontiguousarray: it
            arr = np.ascontiguousarray(arr)  # promotes 0-d to (1,)
            entry = {"dtype": str(arr.dtype), "shape": shape}
            if arr.size == 0:
                # zero-size arrays round-trip explicitly via the
                # manifest alone — a 0-byte AIO write is ambiguous
                # (indistinguishable from a torn file) and wasteful
                entry["empty"] = True
            else:
                fname = f"t{i:05d}.bin"
                entry["file"] = fname
                self.aio.async_pwrite(arr, os.path.join(path, fname))
            manifest[key] = entry
        self.aio.drain()
        # tmp-file + fsync + atomic rename (resilience/commit.py's
        # primitive): a crash after the data writes but mid-manifest
        # must not leave an undetectably half-described directory —
        # the manifest either fully exists or not at all
        # (no manifest = no checkpoint)
        from ...resilience.commit import atomic_write_text

        atomic_write_text(os.path.join(path, "manifest.json"),
                          json.dumps(manifest))

    def load(self, path):
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        arrs = []
        for key, info in manifest.items():
            arr = np.empty(info["shape"], np.dtype(info["dtype"]))
            if info.get("empty") or arr.size == 0:
                out[key] = arr  # no backing file by contract
                continue
            self.aio.async_pread(arr.reshape(-1).view(np.uint8),
                                 os.path.join(path, info["file"]))
            arrs.append((key, arr))
        self.aio.drain()
        for key, arr in arrs:
            out[key] = arr
        return out


class DecoupledCheckpointEngine(CheckpointEngine):
    """Async save: snapshot is taken synchronously (host copies), the write
    happens on a background thread; ``commit`` blocks until durable."""

    def __init__(self, inner: Optional[CheckpointEngine] = None):
        self.inner = inner or NumpyCheckpointEngine()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: path of the save the in-flight (or last-joined) thread owns —
        #: error attribution must name IT, not the save that joins
        self._inflight_path: Optional[str] = None

    def save(self, arrays, path):
        # one in flight at a time: join the previous save first.  If it
        # failed, the error raised HERE names the previous save's
        # tag/path (self._inflight_path), so the failure is attributed
        # to the step that owned it — not silently blamed on this one.
        self._join_inflight()
        snapshot = {k: np.array(v, copy=True) for k, v in arrays.items()}
        self._inflight_path = path

        def _run():
            try:
                self.inner.save(snapshot, path)
            except BaseException as e:  # surfaced at the owning commit
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def load(self, path):
        self._join_inflight()
        return self.inner.load(path)

    def commit(self, tag: str) -> bool:
        """Join the in-flight write (the owning step boundary calls this
        with ITS tag before the commit-protocol finalize)."""
        self._join_inflight(tag=tag)
        return True

    def _join_inflight(self, tag: Optional[str] = None) -> None:
        if self._thread is None:
            return
        self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            failed = self._inflight_path
            self._inflight_path = None
            raise CheckpointSaveError(
                f"decoupled checkpoint: background save of '{failed}'"
                f"{f' (committing tag {tag!r})' if tag else ''} "
                f"failed: {err!r}", path=failed) from err
        self._inflight_path = None


class NebulaCheckpointEngine(DecoupledCheckpointEngine):
    """Nebula-style async tiered checkpointing (reference
    runtime/checkpoint_engine/nebula_checkpoint_engine.py wraps the
    torch_nebula service).  The service itself is Azure-only; the port
    keeps the same async commit contract over the decoupled engine."""


class DataStatesCheckpointEngine(DecoupledCheckpointEngine):
    """DataStates-LLM-style async checkpointing (reference
    datastates/ + runtime/checkpoint_engine/datastates_checkpoint_engine.py):
    host-buffered async flush, same engine contract."""


def make_checkpoint_engine(config) -> CheckpointEngine:
    """From the ``checkpoint`` config block."""
    kind = str(getattr(config.checkpoint, "writer", "") or "").lower()
    if kind not in ("", "nebula", "datastates"):
        raise ValueError(f"unknown checkpoint.writer '{kind}'; "
                         "expected '', 'nebula' or 'datastates'")
    if kind == "nebula":
        return NebulaCheckpointEngine()
    if kind == "datastates":
        return DataStatesCheckpointEngine()
    if getattr(config.checkpoint, "async_save", False):
        return DecoupledCheckpointEngine()
    if getattr(config.checkpoint, "parallel_write_pipeline", False):
        return FastCheckpointEngine(thread_count=config.aio.thread_count,
                                    block_size=config.aio.block_size)
    return NumpyCheckpointEngine()
