"""Verified atomic checkpoint commits — the port's copy of
``deepspeed_tpu/resilience/commit.py`` (plain Python and numpy).

The failure mode this module exists for is not a bug but a SIGKILL (or a
flaky filesystem) landing in the middle of a checkpoint write: a torn
directory that ``load_checkpoint`` would happily deserialize into
garbage.  Every checkpoint save therefore goes through a commit
protocol:

1. **Stage** — all files are written into ``tmp.<tag>`` next to the
   final tag directory (same filesystem, so the rename below is atomic).
2. **Manifest** — ``commit_manifest.json`` records a per-file size +
   CRC32 plus step/world/mesh metadata.  It is itself written via
   tmp-file + ``os.replace`` and fsync'd, AFTER the data files are
   fsync'd — its presence implies the data it describes is durable.
3. **Commit point** — one atomic ``os.replace(tmp.<tag>, <tag>)``.  A
   crash strictly before it leaves only a ``tmp.*`` directory (garbage-
   collected at the next finalize); a crash after it leaves a fully
   verified checkpoint.
4. **LATEST pointer** — the ``latest`` tag file is rewritten via the
   same tmp+rename, then partial staging dirs and tags beyond ``keep_n``
   are garbage-collected.

``resolve_tag`` is the load-side half: it verifies the candidate against
its manifest and, on corruption, logs the incident, counts it in
``deepspeed_tpu_resilience_corrupt_checkpoints_total`` and falls back to
the newest previous tag that verifies — instead of crashing or silently
loading garbage.  Checkpoints from before this protocol (no manifest)
still load, flagged as unverified.

``io_retry`` wraps checkpoint I/O in bounded exponential backoff for
transient filesystem errors; ``chaos.io_fault_point`` hooks let the
fault-injection harness exercise every path deterministically.  (The
JAX module also notes a corrupt tag in the flight recorder; that waits
for ROADMAP Queue 1 #16.)
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.logging import logger
from . import chaos, metrics

MANIFEST = "commit_manifest.json"
STAGING_PREFIX = "tmp."
LATEST = "latest"
COMMIT_FORMAT = "dstpu-commit-v1"


class CommitError(RuntimeError):
    """A checkpoint commit could not be completed."""


class CorruptCheckpointError(RuntimeError):
    """An explicitly requested tag failed verification."""

    def __init__(self, msg: str, tag: str = "", problems: Optional[list] = None):
        super().__init__(msg)
        self.tag = tag
        self.problems = problems or []


# ------------------------------------------------------------------ io utils
def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    """Durability of the directory entry itself (the rename / the new
    file name).  Not supported on every platform — best effort."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path: str, text: str) -> None:
    """tmp-file + fsync + atomic rename: readers see the old content or
    the new content, never a torn write."""
    chaos.io_fault_point(path, "write")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def _gf2_times(mat: List[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: List[int]) -> List[int]:
    return [_gf2_times(mat, mat[n]) for n in range(32)]


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC32 of A + B from crc1 = CRC32(A), crc2 = CRC32(B) and len(B)
    (zlib's ``crc32_combine``, which Python's ``zlib`` does not expose)."""
    if len2 <= 0:
        return (crc1 ^ crc2) & 0xFFFFFFFF
    odd = [0xEDB88320] + [1 << n for n in range(31)]  # one zero bit
    even = _gf2_square(odd)  # two
    odd = _gf2_square(even)  # four
    while True:
        even = _gf2_square(odd)
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return (crc1 ^ crc2) & 0xFFFFFFFF


#: files past this size are checksummed in parts of this size on threads
#: (zlib and pread release the interpreter lock), the parts' CRCs combined
_CRC_PART = 256 << 20


def _crc32_range(fd: int, off: int, n: int, chunk: int = 8 << 20) -> int:
    crc, end = 0, off + n
    while off < end:
        block = os.pread(fd, min(chunk, end - off), off)
        if not block:
            raise OSError(f"file ends early at byte {off}")
        crc = zlib.crc32(block, crc)
        off += len(block)
    return crc


def _crc32_file(path: str, chunk: int = 1 << 20) -> int:
    """The file's CRC32; a large file's parts on up to 8 threads."""
    chaos.io_fault_point(path, "read")
    size = os.path.getsize(path)
    fd = os.open(path, os.O_RDONLY)
    try:
        if size <= _CRC_PART:
            return _crc32_range(fd, 0, size, chunk) & 0xFFFFFFFF
        spans = [(o, min(_CRC_PART, size - o)) for o in range(0, size, _CRC_PART)]
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            parts = list(pool.map(lambda s: _crc32_range(fd, *s), spans))
    finally:
        os.close(fd)
    crc = parts[0]
    for c, (_, n) in zip(parts[1:], spans[1:]):
        crc = crc32_combine(crc, c, n)
    return crc & 0xFFFFFFFF


def array_checksums(arrays: Dict[str, Any]) -> Dict[str, int]:
    """Per-array CRC32s (forensics: WHICH array flipped, not just which
    file) — stored in the manifest meta by the npz writers.  CRCs the
    array buffer directly (no .tobytes() copy: a checkpoint-sized
    transient host allocation per save would defeat RAM-budgeted
    offload hosts).  A streamed member's CRC chained over its slices in
    order (``zlib.crc32(part, crc)``) is the same number."""
    import numpy as np

    return {k: zlib.crc32(np.ascontiguousarray(v)) & 0xFFFFFFFF
            for k, v in arrays.items()}


def io_retry(fn: Callable[[], Any], retries: int = 3,
             base_delay_s: float = 0.1, max_delay_s: float = 5.0,
             what: str = "checkpoint io",
             exceptions: Tuple[type, ...] = (OSError,)) -> Any:
    """Bounded exponential backoff around transient-FS-error-prone I/O.

    Retries only ``exceptions`` (default: ``OSError`` — the transient
    class; corruption and programming errors propagate immediately).
    Each retry increments ``deepspeed_tpu_resilience_io_retries_total``.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except exceptions as e:
            attempt += 1
            if attempt > max(0, int(retries)):
                raise
            delay = min(max_delay_s, base_delay_s * (2 ** (attempt - 1)))
            # deterministic decorrelation: stagger concurrent retriers
            # without a global RNG (pid-keyed, reproducible in tests)
            delay *= 1.0 + 0.25 * ((os.getpid() + attempt) % 7) / 7.0
            metrics.io_retries_total().inc()
            logger.warning(f"resilience: {what} failed ({e}); retry "
                           f"{attempt}/{retries} in {delay:.2f}s")
            time.sleep(delay)


# ------------------------------------------------------------ commit protocol
def staging_path(save_dir: str, tag: str) -> str:
    return os.path.join(save_dir, STAGING_PREFIX + tag)


def begin_commit(save_dir: str, tag: str) -> str:
    """Create (or reset) the staging directory for ``tag`` and return
    its path.  A stale staging dir from a crashed earlier attempt of the
    SAME tag is discarded — it is unfinalized by definition."""
    if not tag or "/" in tag or tag.startswith(STAGING_PREFIX):
        raise CommitError(f"invalid checkpoint tag {tag!r}")
    staging = staging_path(save_dir, tag)
    shutil.rmtree(staging, ignore_errors=True)
    os.makedirs(staging)
    return staging


def finalize_commit(save_dir: str, tag: str, meta: Optional[dict] = None,
                    keep_n: Optional[int] = None,
                    update_latest: bool = True) -> str:
    """Manifest + fsync + atomic rename + LATEST update + GC.  Returns
    the final tag path."""
    staging = staging_path(save_dir, tag)
    if not os.path.isdir(staging):
        raise CommitError(f"no staging dir for tag {tag!r} at {staging}")
    files: Dict[str, dict] = {}
    for dirpath, _dirs, names in os.walk(staging):
        for name in sorted(names):
            if name == MANIFEST:
                continue
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, staging)
            # the file's flush to disk runs under its checksum pass
            with ThreadPoolExecutor(max_workers=1) as pool:
                synced = pool.submit(_fsync_file, full)
                files[rel] = {"bytes": os.path.getsize(full),
                              "crc32": _crc32_file(full)}
                synced.result()
    # the manifest's timestamp orders tags for humans and retention tools
    manifest = {"format": COMMIT_FORMAT, "tag": tag, "ts": time.time(),
                "files": files, "meta": dict(meta or {})}
    atomic_write_text(os.path.join(staging, MANIFEST),
                      json.dumps(manifest, indent=2, default=str))
    _fsync_dir(staging)
    final = os.path.join(save_dir, tag)
    if os.path.isdir(final):
        # re-save of an existing tag: the old content is replaced as one
        # unit (remove then rename — the window exposes no torn tag, only
        # a missing one, which resolve_tag treats as not-a-candidate)
        shutil.rmtree(final)
    chaos.io_fault_point(final, "rename")
    os.replace(staging, final)
    _fsync_dir(save_dir)
    if update_latest:
        atomic_write_text(os.path.join(save_dir, LATEST), tag)
    gc_tags(save_dir, keep_n=keep_n)
    return final


@contextlib.contextmanager
def checkpoint_commit(save_dir: str, tag: str, meta: Optional[dict] = None,
                      keep_n: Optional[int] = None,
                      update_latest: bool = True):
    """``with checkpoint_commit(dir, tag, ...) as staging:`` — write the
    checkpoint files into ``staging``; on clean exit the commit is
    finalized (manifest, fsync, atomic rename, LATEST, GC).  On
    exception the staging dir is left for GC and nothing is committed —
    the previous checkpoint remains the newest valid one."""
    staging = begin_commit(save_dir, tag)
    yield staging
    finalize_commit(save_dir, tag, meta=meta, keep_n=keep_n,
                    update_latest=update_latest)


#: files whose presence marks a directory as a checkpoint tag: the
#: commit manifest, or a known (pre-protocol) checkpoint layout.  GC
#: and fallback resolution must NEVER treat a foreign subdirectory of
#: save_dir (tensorboard/, logs/, ...) as a deletable/loadable tag.
_TAG_MARKERS = (MANIFEST, "meta.json", "partitioned_meta.json",
                "model_states.npz")


def _looks_like_tag(path: str) -> bool:
    return any(os.path.exists(os.path.join(path, m)) for m in _TAG_MARKERS)


def list_tags(save_dir: str) -> List[str]:
    """Committed tag directories, newest first (manifest ts, falling
    back to directory mtime for pre-protocol checkpoints).  Only
    directories with a recognizable checkpoint layout count."""
    if not os.path.isdir(save_dir):
        return []
    out = []
    for name in os.listdir(save_dir):
        full = os.path.join(save_dir, name)
        if not os.path.isdir(full) or name.startswith(STAGING_PREFIX) \
                or not _looks_like_tag(full):
            continue
        order = os.path.getmtime(full)
        man = os.path.join(full, MANIFEST)
        if os.path.exists(man):
            try:
                with open(man) as f:
                    order = float(json.load(f).get("ts", order))
            except (OSError, ValueError):
                pass
        out.append((order, name))
    return [name for _ts, name in sorted(out, reverse=True)]


def gc_tags(save_dir: str, keep_n: Optional[int] = None) -> List[str]:
    """Remove partial ``tmp.*`` staging dirs (always) and committed tags
    beyond the newest ``keep_n`` (only when a budget is given).  Returns
    the removed names."""
    removed = []
    if not os.path.isdir(save_dir):
        return removed
    for name in os.listdir(save_dir):
        if name.startswith(STAGING_PREFIX):
            shutil.rmtree(os.path.join(save_dir, name), ignore_errors=True)
            removed.append(name)
    if keep_n is not None and keep_n >= 1:
        for name in list_tags(save_dir)[int(keep_n):]:
            shutil.rmtree(os.path.join(save_dir, name), ignore_errors=True)
            removed.append(name)
    if removed:
        logger.info(f"resilience: gc removed {removed} from {save_dir}")
    return removed


# --------------------------------------------------------------- verification
def verify_tag(save_dir: str, tag: str) -> dict:
    """Check ``tag`` against its commit manifest.

    Returns ``{"ok", "verified", "exists", "problems", "meta"}``:
    ``ok`` means safe to load; ``verified`` distinguishes a
    checksum-verified tag from a pre-protocol one (no manifest) that is
    accepted on trust; ``exists``/``not_checkpoint`` separate a
    missing or foreign directory from actual data corruption (only the
    latter counts toward the corruption metric).
    """
    path = os.path.join(save_dir, tag)
    if not os.path.isdir(path):
        return {"ok": False, "verified": False, "exists": False, "meta": {},
                "problems": [f"tag directory missing: {path}"]}
    if not _looks_like_tag(path):
        return {"ok": False, "verified": False, "exists": True,
                "not_checkpoint": True, "meta": {},
                "problems": [f"not a checkpoint layout: {path}"]}
    man = os.path.join(path, MANIFEST)
    if not os.path.exists(man):
        return {"ok": True, "verified": False, "exists": True, "meta": {},
                "problems": []}
    try:
        with open(man) as f:
            manifest = json.load(f)
        files = manifest["files"]
    except (OSError, ValueError, KeyError) as e:
        return {"ok": False, "verified": False, "exists": True, "meta": {},
                "problems": [f"torn/unreadable manifest: {e}"]}
    problems = []
    for rel, info in files.items():
        full = os.path.join(path, rel)
        if not os.path.exists(full):
            problems.append(f"missing file {rel}")
            continue
        size = os.path.getsize(full)
        if size != info.get("bytes"):
            problems.append(f"{rel}: size {size} != manifest "
                            f"{info.get('bytes')}")
            continue
        try:
            crc = _crc32_file(full)
        except OSError as e:
            problems.append(f"{rel}: unreadable ({e})")
            continue
        want = info.get("crc32")
        if crc != want:
            want_s = format(want, "#010x") if isinstance(want, int) else repr(want)
            problems.append(f"{rel}: crc32 {crc:#010x} != manifest {want_s}")
    return {"ok": not problems, "verified": True, "exists": True,
            "meta": manifest.get("meta", {}), "problems": problems}


def manifest_meta(save_dir: str, tag: str) -> dict:
    """The caller-supplied ``meta`` block of a committed tag's manifest
    (``{}`` for pre-protocol tags / unreadable manifests).  Cheap — no
    checksum pass — so resume paths can triage (e.g. a
    ``numerics_incident`` stamped by the anomaly sentinel) without
    paying a full :func:`verify_tag`."""
    man = os.path.join(save_dir, tag, MANIFEST)
    try:
        with open(man) as f:
            return dict(json.load(f).get("meta") or {})
    except (OSError, ValueError, TypeError):
        return {}


def _record_corruption(save_dir: str, tag: str, problems: list) -> None:
    metrics.corrupt_checkpoints_total().inc()
    logger.error(f"resilience: checkpoint {save_dir}/{tag} FAILED "
                 f"verification: {problems}")


def resolve_tag(load_dir: str, tag: Optional[str] = None) -> Tuple[Optional[str], dict]:
    """Resolve which tag to load, verified.

    * explicit ``tag``: verify it; corruption raises
      :class:`CorruptCheckpointError` (the caller asked for THIS tag —
      silently loading a sibling would be worse than failing).
    * ``tag=None``: start from the ``latest`` pointer and walk back
      through committed tags (newest first) until one verifies; every
      corrupt candidate is counted, incident-logged and skipped.
      Returns ``(None, report)`` when nothing loadable exists.
    """
    if tag is not None:
        report = verify_tag(load_dir, tag)
        if not report["ok"]:
            if not report["exists"]:
                # a typo'd / never-saved tag is not corruption: no
                # counter, no incident — just a plain lookup failure
                raise FileNotFoundError(
                    f"checkpoint tag {tag!r} not found in {load_dir}")
            if report.get("not_checkpoint"):
                raise CorruptCheckpointError(
                    f"{load_dir}/{tag} is not a checkpoint layout",
                    tag=tag, problems=report["problems"])
            _record_corruption(load_dir, tag, report["problems"])
            raise CorruptCheckpointError(
                f"checkpoint tag {tag!r} in {load_dir} failed verification: "
                f"{report['problems']}", tag=tag, problems=report["problems"])
        return tag, report

    candidates: List[str] = []
    latest = os.path.join(load_dir, LATEST)
    if os.path.exists(latest):
        with open(latest) as f:
            pointed = f.read().strip()
        if pointed:
            candidates.append(pointed)
    for name in list_tags(load_dir):
        if name not in candidates:
            candidates.append(name)
    for cand in candidates:
        report = verify_tag(load_dir, cand)
        if report["ok"]:
            if cand != (candidates[0] if candidates else None):
                logger.info(f"resilience: falling back to previous good "
                         f"tag '{cand}' in {load_dir}")
            return cand, report
        if report["exists"] and not report.get("not_checkpoint"):
            _record_corruption(load_dir, cand, report["problems"])
        else:
            # stale/dangling `latest` pointer (the only way a missing
            # or foreign candidate gets here): skip, don't count it as
            # data corruption
            logger.warning(f"resilience: latest pointer target "
                           f"'{cand}' in {load_dir} is "
                           f"{report['problems']}; skipping")
    return None, {"ok": False, "verified": False, "exists": False,
                  "meta": {},
                  "problems": [f"no loadable checkpoint in {load_dir}"]}
