"""Checkpoint save/load in the consolidated layout — the port's counterpart
of ``deepspeed_tpu/checkpoint/saving.py``.

A tag directory holds ``model_states.npz``, keyed by the JAX package's
``jax.tree_util.keystr`` paths of its ``TrainState`` (``.step``,
``.params['layers']['attn']['wq']``, ``.opt_state[0].mu[...]``, ...), with
the per-layer leaves of the port stacked on a leading ``[L, ...]`` axis as
the JAX tree stores them, and ``meta.json`` with the JAX fields (counters,
the lr scheduler's state, ``client_state``, ``bfloat16_keys``,
``zero_stage``).  bf16 arrays are stored as their ``uint16`` bits and
listed under ``bfloat16_keys``.  So a checkpoint of either package loads
into the other.  The save goes through the verified atomic commit of
``resilience/commit.py``: staging directory, checksum manifest, one
rename, the ``latest`` pointer.

The writer streams.  Each array is written as its slices one after
another (a stacked member as its layers), with the ``.npy`` header first
and the CRC32 chained over the slices, so the file is byte for byte what
``np.savez`` writes for the stacked arrays, and no stacked copy is ever
made.  A tensor on the card crosses through a pinned staging buffer, two
of them alternating so the next slice's copy runs under this slice's
write; host arrays are written from where they live.  The reader goes the
other way: each slice is read straight into its live buffer (a host array
or tensor in place; a device tensor through the staging buffers).

Under ``offload_optimizer`` (cpu, nvme, SuperOffload, ZenFlow) the
``.params`` are the compute-dtype leaves on the card, as the JAX engine
writes them, and the host optimizer's fp32 master and moments go under
keys of their own, ``.offload['master'][...]``, ``.offload['m'][...]``,
... (the JAX engine's save omits them, ROADMAP #F6; its loader ignores
keys it does not know).  Moments spilled to NVMe are read from, and
written back to, their spill files one leaf at a time.  Nothing of the
host state is staged on the card.

One process holds the whole state: the barriers of the JAX module are
no-ops here, and the partitioned layout (``partitioned_meta.json``) is
refused, naming ROADMAP Queue 1 #8.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
import zipfile
import zlib
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..resilience.commit import crc32_combine
from ..utils.logging import logger

MODEL_FILE = "model_states.npz"
META_FILE = "meta.json"
LATEST = "latest"
#: the partitioned layout's marker file (JAX ``checkpoint/partitioned.py``)
PARTITIONED_META = "partitioned_meta.json"
ROADMAP_PARTITIONED = "ROADMAP Queue 1 #8 'ZeRO 1/2/3 across ranks'"

_NP = {torch.float32: np.float32, torch.float16: np.float16, torch.bfloat16: np.uint16,
       torch.float64: np.float64, torch.int64: np.int64, torch.int32: np.int32,
       torch.int16: np.int16, torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_}


def barrier(name: str) -> None:
    """The JAX module's ``comm.barrier``: one rank, nothing to wait for."""


def refuse_partitioned(what: str) -> None:
    raise NotImplementedError(f"{what}: the partitioned checkpoint layout is not ported yet "
                              f"({ROADMAP_PARTITIONED})")


# ---------------------------------------------------------------------------
# the .npz container, streamed
# ---------------------------------------------------------------------------
def _bytes(a: np.ndarray) -> memoryview:
    return memoryview(np.ascontiguousarray(a).reshape(-1)).cast("B")


class NpzWriter:
    """Writes an ``.npz`` member by member as ``np.savez`` does (ZIP_STORED,
    zip64, ``.npy`` members), each member from a sequence of slices whose
    concatenation is its C-order data."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._zf = zipfile.ZipFile(self._f, mode="w", compression=zipfile.ZIP_STORED,
                                   allowZip64=True)
        self.bytes = 0

    def add(self, key: str, dtype: Any, shape: Tuple[int, ...],
            parts: Iterable[np.ndarray]) -> int:
        """Write member ``key``; returns the CRC32 of its data (what
        ``array_checksums`` gives for the whole array)."""
        header = {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
                  "fortran_order": False, "shape": tuple(int(s) for s in shape)}
        want = int(np.prod(header["shape"], dtype=np.int64)) * np.dtype(dtype).itemsize
        head = io.BytesIO()
        # the header np.savez writes (version 1.0: ours are far below its 64 KiB)
        np.lib.format.write_array_header_1_0(head, header)
        head = head.getvalue()
        n = 0
        with self._zf.open(key + ".npy", "w", force_zip64=True) as fid:
            fid.write(head)
            for part in parts:
                buf = _bytes(part)
                fid.write(buf)
                n += buf.nbytes
        if n != want:
            raise ValueError(f"checkpoint member {key}: wrote {n} bytes, shape {shape} "
                             f"of {np.dtype(dtype)} holds {want}")
        self.bytes += n
        # the data's CRC from the member's (header + data), which zipfile
        # took as it wrote: one pass over the bytes, not two
        member_crc = self._zf.infolist()[-1].CRC
        return member_crc ^ crc32_combine(zlib.crc32(head), 0, n)

    def close(self) -> None:
        try:
            self._zf.close()
        finally:
            self._f.close()


@dataclasses.dataclass
class _Entry:
    dtype: np.dtype
    shape: Tuple[int, ...]
    offset: int  # the data's first byte in the file
    nbytes: int
    head: bytes  # the .npy header, part of the zip member's CRC
    crc: int


class NpzReader:
    """Reads the members of an ``.npz`` that ``np.savez`` wrote (stored, not
    compressed, as both packages write them) slice by slice straight from
    the file into caller buffers, with no copy in between.  ``check_crc``
    checks each member's zip CRC (a tag the commit manifest already
    verified needs no second pass)."""

    def __init__(self, path: str, check_crc: bool = True):
        self.path = path
        self.check_crc = check_crc
        self._zf = zipfile.ZipFile(path)
        self._f = open(path, "rb", buffering=0)
        self.entries: Dict[str, _Entry] = {}
        for info in self._zf.infolist():
            if not info.filename.endswith(".npy"):
                continue
            key = info.filename[:-4]
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: member {key} is compressed; checkpoints are "
                                 f"written by np.savez, stored")
            self._f.seek(info.header_offset)
            local = self._f.read(30)
            name_len, extra_len = struct.unpack("<HH", local[26:30])
            start = info.header_offset + 30 + name_len + extra_len
            self._f.seek(start)
            version = np.lib.format.read_magic(self._f)
            shape, fortran, dtype = _read_header(self._f, version)
            if fortran and len(shape) > 1:
                raise ValueError(f"{path}: member {key} is Fortran-ordered")
            off = self._f.tell()
            self._f.seek(start)
            head = self._f.read(off - start)
            self.entries[key] = _Entry(dtype, tuple(shape), off, info.file_size - (off - start),
                                       head, info.CRC)

    def close(self) -> None:
        self._f.close()
        self._zf.close()

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    def keys(self) -> List[str]:
        return list(self.entries)

    def read_into(self, key: str, targets: Iterable[memoryview]) -> None:
        """Fill ``targets`` (writable byte buffers, in order) with member
        ``key``'s data; their sizes must add up to its size."""
        e = self.entries[key]
        crc = zlib.crc32(e.head) if self.check_crc else 0
        pos = e.offset
        for t in targets:
            self._f.seek(pos)
            got = 0
            while got < t.nbytes:
                n = self._f.readinto(t[got:])
                if not n:
                    raise OSError(f"{self.path}: member {key} ends early")
                got += n
            if self.check_crc:
                crc = zlib.crc32(t, crc)
            pos += t.nbytes
        if pos - e.offset != e.nbytes:
            raise ValueError(f"checkpoint member {key}: {e.nbytes} bytes, targets take "
                             f"{pos - e.offset}")
        if self.check_crc and (crc & 0xFFFFFFFF) != e.crc:
            raise OSError(f"{self.path}: member {key} fails its CRC32")

    def read(self, key: str) -> np.ndarray:
        """Member ``key`` as a new array."""
        e = self.entries[key]
        out = np.empty(e.shape, e.dtype)
        self.read_into(key, [_bytes_w(out)])
        return out


def _read_header(fp, version):
    if version == (1, 0):
        return np.lib.format.read_array_header_1_0(fp)
    if version == (2, 0):
        return np.lib.format.read_array_header_2_0(fp)
    raise ValueError(f"unsupported .npy version {version}")


def _bytes_w(a: np.ndarray) -> memoryview:
    """A writable byte view of a C-contiguous array."""
    if not a.flags["C_CONTIGUOUS"]:
        raise ValueError("checkpoint target must be C-contiguous")
    return memoryview(a.reshape(-1)).cast("B")


# ---------------------------------------------------------------------------
# the engine's state as checkpoint members
# ---------------------------------------------------------------------------
class _Zeros:
    """A slice of zeros (the empty accumulation buffer), written from one
    shared buffer."""

    def __init__(self, shape: Tuple[int, ...], dtype: np.dtype):
        self.shape, self.dtype = tuple(shape), np.dtype(dtype)


@dataclasses.dataclass
class Member:
    """One array of the checkpoint: its key, stored dtype and shape, and its
    slices (torch tensors on any device, numpy arrays, host spill files or
    zeros), concatenated on the leading axis when there is more than one."""

    key: str
    dtype: np.dtype
    shape: Tuple[int, ...]
    slices: List[Any]
    bf16: bool = False


def _np_dtype(t: Any) -> Tuple[np.dtype, bool]:
    if isinstance(t, torch.Tensor):
        return np.dtype(_NP[t.dtype]), t.dtype == torch.bfloat16
    if isinstance(t, _Zeros):
        return t.dtype, False
    return np.dtype(t.dtype), False


def _member(key: str, slices: List[Any], shape: Optional[Tuple[int, ...]] = None,
            stacked: bool = False) -> Member:
    dt, bf16 = _np_dtype(slices[0])
    one = tuple(shape) if shape is not None else tuple(slices[0].shape)
    full = (len(slices),) + one if stacked else one
    return Member(key, dt, full, slices, bf16)


def leaf_paths(tree: torch.nn.Module) -> List[Tuple[str, Optional[int]]]:
    """Each leaf's JAX path and layer index, in ``named_parameters`` order:
    ``layers.3.attn.wq`` -> (``['layers']['attn']['wq']``, 3),
    ``embed.tok`` -> (``['embed']['tok']``, None)."""
    out = []
    for name, _ in tree.named_parameters():
        parts = name.split(".")
        if len(parts) > 2 and parts[0] == "layers" and parts[1].isdigit():
            out.append(("".join(f"['{p}']" for p in [parts[0]] + parts[2:]), int(parts[1])))
        else:
            out.append(("".join(f"['{p}']" for p in parts), None))
    return out


def _group(paths: List[Tuple[str, Optional[int]]], per_leaf: List[Any],
           shapes: List[Tuple[int, ...]], prefix: str) -> List[Member]:
    """Members ``prefix + path`` from per-leaf entries (None skips a leaf),
    layer slices stacked in layer order, sorted by key as the JAX tree
    flattens dicts."""
    groups: Dict[str, List[Tuple[Optional[int], Any, Tuple[int, ...]]]] = {}
    for (path, layer), x, shp in zip(paths, per_leaf, shapes):
        if x is not None:
            groups.setdefault(path, []).append((layer, x, shp))
    out = []
    for path in sorted(groups):
        items = groups[path]
        if items[0][0] is None:
            out.append(_member(prefix + path, [items[0][1]], _shape_of(items[0])))
        else:
            items.sort(key=lambda t: t[0])
            if [t[0] for t in items] != list(range(len(items))):
                raise ValueError(f"checkpoint: layers of {path} are not 0..{len(items) - 1}")
            out.append(_member(prefix + path, [t[1] for t in items], _shape_of(items[0]),
                               stacked=True))
    return out


def _shape_of(item) -> Tuple[int, ...]:
    """A per-leaf entry's shape: the leaf's when it holds the leaf's count
    of elements (a flat host array of the leaf), else its own (a per-column
    mask)."""
    _, x, leaf_shape = item
    if isinstance(x, (_Zeros, torch.Tensor)):
        return tuple(x.shape)
    n = int(np.prod(leaf_shape, dtype=np.int64))
    return tuple(leaf_shape) if x.size == n else tuple(x.shape)


#: the port's optimizer state keys -> the JAX ``TrainState.opt_state``
#: paths, by optimizer kind, in the JAX tree's order; a list key's path
#: gets the leaf's parameter path appended, "step" is the 0-d count
_OPT_LAYOUTS = {
    "fused": [("m", "['m']"), ("step", "['step']"), ("v", "['v']")],
    "adam": [("step", "[0].count"), ("m", "[0].mu"), ("v", "[0].nu"), ("step", "[2].count")],
    "lamb": [("step", "[0].count"), ("m", "[0].mu"), ("v", "[0].nu"), ("step", "[3].count")],
    "lion": [("step", "[0].count"), ("m", "[0].mu"), ("step", "[2].count")],
    "adagrad": [("sum_sq", "[0].sum_of_squares"), ("step", "[1].count")],
    "sgd": [("trace", "[0].trace"), ("step", "[1].count")],
    "onebit": [("step", ".count"), ("m", ".m"), ("v", ".v"), ("error", ".error")],
}


def opt_layout(engine) -> List[Tuple[str, str]]:
    """The (state key, JAX path) pairs of the engine's optimizer state; an
    optimizer whose JAX state has another tree (muon's partition, a
    client optimizer) keeps the port's own keys under ``.opt_state``."""
    from ..runtime import optimizers as O

    state = engine.state.opt_state
    if not isinstance(state, dict):
        return []
    name = str(engine.config.optimizer.type or "adamw").lower()
    if getattr(engine.optimizer, "direct_update", None) is not None:
        kind = "fused"
    elif engine._client_optimizer:
        kind = None
    elif name in O.ADAM_FAMILY:
        kind = "adam"
    elif name == O.LAMB_OPTIMIZER:
        kind = "lamb"
    elif name in O.LION_OPTIMIZERS:
        kind = "lion"
    elif name == O.ADAGRAD_OPTIMIZER:
        kind = "adagrad"
    elif name == O.SGD_OPTIMIZER:
        kind = "sgd"
    elif name in (O.ONEBIT_ADAM, O.ZERO_ONE_ADAM, O.ONEBIT_LAMB):
        kind = "onebit"
    else:
        kind = None
    if kind is not None and {k for k, _ in _OPT_LAYOUTS[kind]} == set(state):
        return _OPT_LAYOUTS[kind]
    return [(k, f"['{k}']") for k in sorted(state)]


def _opt_members(engine, paths, shapes) -> List[Member]:
    state = engine.state.opt_state
    out = []
    for k, jpath in opt_layout(engine):
        v = state[k]
        if isinstance(v, list):
            out += _group(paths, v, shapes, ".opt_state" + jpath)
        else:
            out.append(_member(".opt_state" + jpath, [v]))
    return out


def state_members(engine, with_grad_acc: bool = True) -> List[Member]:
    """The engine's training state as checkpoint members, in the JAX
    ``TrainState``'s order, then the host optimizer's own."""
    st = engine.state
    paths = leaf_paths(st.params)
    leaves = [p.detach() for _, p in st.params.named_parameters()]
    shapes = [tuple(p.shape) for p in leaves]
    out = [_member(".step", [st.step]),
           _member(".micro_step", [torch.tensor(st.micro_step, dtype=torch.int32)])]
    out += _group(paths, leaves, shapes, ".params")
    out += _opt_members(engine, paths, shapes)
    if with_grad_acc:
        acc_np = np.dtype(_NP[engine.grad_accum_dtype])
        acc = st.grad_acc if st.grad_acc is not None else \
            [_Zeros(s, acc_np) for s in shapes]
        out += _group(paths, [a.detach() if isinstance(a, torch.Tensor) else a for a in acc],
                      shapes, ".grad_acc")
    if st.loss_scale is not None:
        ls = st.loss_scale
        out += [_member(".loss_scale.cur_scale", [ls.cur_scale]),
                _member(".loss_scale.growth_tracker", [ls.growth_tracker]),
                _member(".loss_scale.hysteresis_tracker", [ls.hysteresis_tracker])]
    out += [_member(".skipped_steps", [st.skipped_steps]),
            _member(".global_grad_norm", [st.global_grad_norm])]
    return out


def host_members(engine, host_state: Dict[str, List[Any]],
                 host_scalars: Dict[str, np.ndarray]) -> List[Member]:
    """The host optimizer's arrays (``.offload['<name>']<path>``) and
    scalars (``.offload['<name>']``)."""
    tree = engine._compute
    paths = leaf_paths(tree)
    shapes = [tuple(p.shape) for _, p in tree.named_parameters()]
    out = [_member(f".offload['{k}']", [np.asarray(v)]) for k, v in host_scalars.items()]
    for name, per_leaf in host_state.items():
        out += _group(paths, per_leaf, shapes, f".offload['{name}']")
    return out


# ---------------------------------------------------------------------------
# moving slices between the card, host buffers and the file
# ---------------------------------------------------------------------------
class _Stager:
    """Two pinned host buffers, alternating, for the slices of tensors on
    the card: the next slice's copy is in flight while this one is written
    (or this one's upload runs while the next is read)."""

    def __init__(self, slices: Iterable[Any]):
        cap = max((s.numel() * s.element_size() for s in slices
                   if isinstance(s, torch.Tensor) and s.is_cuda), default=0)
        self.cap = cap
        self.bufs = [torch.empty(cap, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)] if cap else []
        self.events: List[Optional[torch.cuda.Event]] = [None, None]
        self.i = 0

    def take(self) -> Tuple[torch.Tensor, int]:
        """The next buffer, once the copy last issued on it has finished."""
        j = self.i
        self.i ^= 1
        if self.events[j] is not None:
            self.events[j].synchronize()
            self.events[j] = None
        return self.bufs[j], j

    def mark(self, j: int) -> None:
        ev = torch.cuda.Event()
        ev.record()
        self.events[j] = ev

    def drain(self) -> None:
        for j, ev in enumerate(self.events):
            if ev is not None:
                ev.synchronize()
                self.events[j] = None


def _tensor_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).view(torch.uint8)


def _host_view(x: Any) -> np.ndarray:
    """A host slice's data as a numpy array (no copy for host tensors and
    arrays; a spilled moment is read from its file)."""
    if isinstance(x, torch.Tensor):
        return _tensor_bytes(x).numpy()
    if hasattr(x, "read"):
        return x.read()
    return np.asarray(x)


def _save_parts(member: Member, stager: _Stager, zeros: Callable[[int], np.ndarray]
                ) -> Iterator[np.ndarray]:
    """The member's slices as host arrays, in order; device slices copied
    one ahead through the stager."""
    pending = None
    for s in member.slices:
        if isinstance(s, torch.Tensor) and s.is_cuda:
            buf, j = stager.take()
            n = s.numel() * s.element_size()
            buf[:n].copy_(_tensor_bytes(s), non_blocking=True)
            stager.mark(j)
            item = (buf[:n], j)
        elif isinstance(s, _Zeros):
            item = _ZerosParts(int(np.prod(s.shape, dtype=np.int64)) * s.dtype.itemsize)
        else:
            item = _host_view(s)
        if pending is not None:
            yield from _finish(pending, stager, zeros)
        pending = item
    if pending is not None:
        yield from _finish(pending, stager, zeros)


class _ZerosParts:
    def __init__(self, nbytes: int):
        self.nbytes = nbytes


def _finish(item, stager: _Stager, zeros) -> Iterator[np.ndarray]:
    if isinstance(item, tuple):
        buf, j = item
        ev = stager.events[j]
        if ev is not None:
            ev.synchronize()
        yield buf.numpy()
    elif isinstance(item, _ZerosParts):
        left = item.nbytes
        while left:
            z = zeros(left)
            yield z
            left -= z.nbytes
    else:
        yield item


def write_members(path: str, members: List[Member]) -> Tuple[Dict[str, int], int]:
    """Write ``members`` into the ``.npz`` at ``path``; returns (CRC32 of
    each member's data, bytes written)."""
    stager = _Stager(s for m in members for s in m.slices)
    chunk = np.zeros(64 << 20, np.uint8)

    def zeros(n: int) -> np.ndarray:
        return chunk[:min(n, chunk.nbytes)]

    crcs = {}
    w = NpzWriter(path)
    try:
        for m in members:
            crcs[m.key] = w.add(m.key, m.dtype, m.shape, _save_parts(m, stager, zeros))
    finally:
        w.close()
        stager.drain()
    return crcs, w.bytes


def read_members(reader: NpzReader, members: List[Member]) -> List[str]:
    """Fill each member's slices in place from ``reader``; returns the keys
    the file lacks (each kept at its current value, with a warning)."""
    stager = _Stager(s for m in members for s in m.slices)
    missing = []
    for m in members:
        if m.key not in reader:
            logger.warning(f"checkpoint missing {m.key}; keeping current value")
            missing.append(m.key)
            continue
        e = reader.entries[m.key]
        if tuple(e.shape) != tuple(m.shape) or np.dtype(e.dtype) != np.dtype(m.dtype):
            raise ValueError(f"checkpoint member {m.key}: {np.dtype(e.dtype)} "
                             f"{tuple(e.shape)} in the file, {np.dtype(m.dtype)} "
                             f"{tuple(m.shape)} in the engine")
        def targets():
            # a generator: the code after each yield (the upload, the spill
            # write) runs when the reader asks for the next target, i.e.
            # once this one is full
            for s in m.slices:
                if isinstance(s, torch.Tensor) and s.is_cuda:
                    buf, j = stager.take()
                    n = s.numel() * s.element_size()
                    yield memoryview(buf[:n].numpy())
                    _tensor_bytes(s).copy_(buf[:n], non_blocking=True)
                    stager.mark(j)
                elif isinstance(s, torch.Tensor):
                    yield memoryview(_tensor_bytes(s).numpy())
                elif hasattr(s, "write"):  # a moment in its spill file
                    tmp = np.empty(s.size, s.dtype)
                    yield _bytes_w(tmp)
                    s.write(tmp)
                else:
                    yield _bytes_w(s)

        reader.read_into(m.key, targets())
    stager.drain()
    return missing


# ---------------------------------------------------------------------------
# save and load
# ---------------------------------------------------------------------------
def _sync(engine) -> None:
    """Every queued copy into or out of the state has finished (the
    offload_param boundary's last pushes to the pinned master)."""
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[dict] = None,
                    keep_n: Optional[int] = None) -> str:
    """Save through the verified atomic commit protocol
    (``resilience/commit.py``): files land in a ``tmp.<tag>`` staging
    dir, a checksum manifest is written, and one atomic rename commits.
    Returns the tag's path."""
    from ..resilience.commit import checkpoint_commit

    engine._check_live()
    tag = tag or f"global_step{engine.global_steps}"
    path = os.path.join(save_dir, tag)
    barrier("pre-save")
    _sync(engine)
    members = state_members(engine)
    host = engine.offload_optimizer
    if host is not None:
        scalars = host.checkpoint_scalars()
        members += host_members(engine, host.checkpoint_state(), scalars)
    commit_meta = {"global_steps": engine.global_steps, "world": 1, "mesh": {"data": 1}}
    try:
        # numerics observatory: if the anomaly sentinel fired since the
        # last save, stamp the incident into this tag's commit manifest —
        # resume-time triage (``manifest_meta``, the load-time warning)
        # sees WHAT fired and WHICH layer.  Consume-once: only the first
        # checkpoint after the incident carries it.
        from ..telemetry.numerics import pending_incident_meta

        inc = pending_incident_meta()
        if inc is not None:
            commit_meta["numerics_incident"] = inc
    # dstpu-lint: allow[swallow] annotation only — a broken sentinel must
    # never block the checkpoint itself
    except Exception:
        pass
    os.makedirs(save_dir, exist_ok=True)
    with checkpoint_commit(save_dir, tag, meta=commit_meta, keep_n=keep_n) as staging:
        # the manifest is finalized after this block: the CRCs the write
        # computes land in its meta
        crcs, nbytes = write_members(os.path.join(staging, MODEL_FILE), members)
        commit_meta["array_crc32"] = crcs
        meta = {
            "tag": tag,
            "global_steps": engine.global_steps,
            "micro_steps": engine.micro_steps,
            "lr_scheduler": engine.lr_scheduler.state_dict(),
            "client_state": client_state or {},
            "bfloat16_keys": {m.key: "bfloat16" for m in members if m.bf16},
            "zero_stage": engine.config.zero_config.stage,
            "offload": type(host).__name__ if host is not None else None,
        }
        with open(os.path.join(staging, META_FILE), "w") as f:
            json.dump(meta, f, indent=2, default=str)
    barrier("post-save")
    logger.info(f"saved checkpoint {path} ({nbytes / 1e9:.2f} GB)")
    return path


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True,
                    load_lr_scheduler_states: bool = True,
                    verified: bool = False) -> Tuple[Optional[str], dict]:
    """Fill the engine's state in place from tag ``tag`` (None: the
    ``latest`` verified one).  ``verified``: the commit manifest's
    checksums were just checked, so the members' own CRCs are not read
    again.  Returns (path, client_state), or (None, {}) when nothing is
    loadable."""
    if tag is None:
        from ..resilience.commit import resolve_tag

        tag, report = resolve_tag(load_dir)
        if tag is None:
            logger.warning(f"no loadable checkpoint in {load_dir}; nothing loaded")
            return None, {}
        verified = report["verified"]
    path = os.path.join(load_dir, tag)
    if os.path.exists(os.path.join(path, PARTITIONED_META)):
        refuse_partitioned(f"load_checkpoint({path})")
    engine._check_live()
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    _sync(engine)
    st = engine.state
    reader = NpzReader(os.path.join(path, MODEL_FILE), check_crc=not verified)
    try:
        micro = int(reader.read(".micro_step")) if ".micro_step" in reader else 0
        if micro:  # saved between micro-steps: the accumulation buffer too
            st.grad_acc = [torch.empty(p.shape, dtype=engine.grad_accum_dtype,
                                       device=p.device) for _, p in st.params.named_parameters()]
        members = [m for m in state_members(engine, with_grad_acc=bool(micro))
                   if m.key != ".micro_step"
                   and (load_optimizer_states or not m.key.startswith(".opt_state"))]
        host = engine.offload_optimizer
        if host is not None:
            if load_optimizer_states:
                scalars = host.checkpoint_scalars()
                for k in scalars:
                    key = f".offload['{k}']"
                    if key in reader:
                        scalars[k] = reader.read(key)
                    else:
                        logger.warning(f"checkpoint missing {key}; keeping current value")
                host.load_checkpoint_scalars(scalars)
            arrays = host.checkpoint_state()
            if not load_optimizer_states:  # the moments stay the engine's own
                arrays = {"master": arrays["master"]}
            members += host_members(engine, arrays, {})
        read_members(reader, members)
    finally:
        reader.close()
    _sync(engine)
    st.micro_step = micro
    engine._acc_dirty = micro > 0
    # the compute copy is refreshed from the loaded master as a step
    # refreshes it (under offload_optimizer it is what was loaded)
    engine._compute_fresh = engine.offload_optimizer is not None
    engine.global_steps = int(meta["global_steps"])
    engine.micro_steps = int(meta.get("micro_steps", 0))
    if load_lr_scheduler_states and meta.get("lr_scheduler"):
        engine.lr_scheduler.load_state_dict(meta["lr_scheduler"])
    logger.info(f"loaded checkpoint {path}")
    return path, meta.get("client_state", {})
