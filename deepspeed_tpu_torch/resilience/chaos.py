"""Fault-injection (chaos) harness — the port's copy of
``deepspeed_tpu/resilience/chaos.py``: the I/O fault hook the commit
protocol calls, the kill point and the simulated preemption notice, the
gray-failure injectors, and the on-disk corrupters.

Injection points: the commit protocol calls ``io_fault_point(path, op)``
around manifest/pointer writes, checksum reads and the commit rename;
``install_io_fault`` plants a hook there (``FlakyIO`` below is the
standard one).  The on-disk corrupters (``bitflip_array``,
``tear_manifest``, ``make_partial_staging``, ``corrupt_latest_pointer``)
mutate a finished checkpoint directory the way a crash or a bad disk
would.  Every injector is deterministic: a count or a seed drives it.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Callable, Optional, Tuple

# ----------------------------------------------------------- I/O fault hook
_io_fault: Optional[Callable[[str, str], None]] = None


def install_io_fault(hook: Optional[Callable[[str, str], None]]) -> None:
    """Install (or clear, with None) the process I/O fault hook."""
    global _io_fault
    _io_fault = hook


def io_fault_point(path: str, op: str) -> None:
    """Called by the commit protocol before checkpoint I/O; the
    installed hook may sleep (slow FS) or raise OSError (failing FS)."""
    if _io_fault is not None:
        _io_fault(path, op)


class FlakyIO:
    """Raise ``OSError`` for the first ``fail_ops`` matching operations
    (optionally after ``slow_s`` of injected latency), then pass —
    the transient-FS profile ``io_retry`` exists for.  Deterministic:
    the failure count, not a probability, drives it."""

    def __init__(self, fail_ops: int = 2, slow_s: float = 0.0,
                 match: str = "", ops: Tuple[str, ...] = ("write", "rename")):
        self.remaining = int(fail_ops)
        self.slow_s = float(slow_s)
        self.match = match
        self.ops = tuple(ops)
        self.calls = 0

    def __call__(self, path: str, op: str) -> None:
        if op not in self.ops or (self.match and self.match not in str(path)):
            return
        self.calls += 1
        if self.slow_s:
            time.sleep(self.slow_s)
        if self.remaining > 0:
            self.remaining -= 1
            raise OSError(f"chaos: injected {op} failure on {path} "
                          f"({self.remaining} more to come)")


# ------------------------------------------------------------ kill-at-step
KILL_EXIT_CODE = 137  # what a SIGKILLed process reports


def kill_point(step: int, kill_at_step: Optional[int],
               exit_code: int = KILL_EXIT_CODE) -> None:
    """Hard-kill the process (``os._exit`` — no atexit, no flushes, the
    honest simulation of a SIGKILL) when ``step`` reaches
    ``kill_at_step``.  No-op when ``kill_at_step`` is None."""
    if kill_at_step is not None and step == kill_at_step:
        os._exit(exit_code)


def simulate_preemption(target, reason: str = "chaos:simulated-maintenance") -> None:
    """Deliver a maintenance notice to a ``PreemptionWatcher`` (or
    anything exposing ``.watcher`` or ``.notify``)."""
    watcher = getattr(target, "watcher", target)
    watcher.notify(reason)


# --------------------------------------------------- gray-failure injectors
# The failure modes liveness checks never see: a replica that is SLOW
# (not dead), a step that THROWS (not crashes), a KV pool that SHRINKS
# (not OOMs).  All are deterministic/seeded so any failing drill replays
# from its logged seed.  SlowReplica/FlakyStep are hooks a serving
# replica calls at the top of every step (the fleet that installs them
# is not ported yet); PoolSqueeze works on the port's ``BlockAllocator``.
class ChaosStepError(RuntimeError):
    """The injected step exception ``FlakyStep`` raises."""


class SlowReplica:
    """Per-step latency injection: every step of the afflicted replica
    sleeps ``delay_s`` (+ seeded jitter up to ``jitter_s``) before
    running — the gray-failure profile of a replica on a sick host or a
    congested interconnect.  Deterministic for a fixed seed."""

    def __init__(self, delay_s: float = 0.05, jitter_s: float = 0.0,
                 seed: int = 0):
        self.delay_s = float(delay_s)
        self.jitter_s = float(jitter_s)
        self._rng = random.Random(seed)
        self.calls = 0

    def __call__(self, replica=None) -> None:
        self.calls += 1
        time.sleep(self.delay_s + (self._rng.random() * self.jitter_s
                                   if self.jitter_s else 0.0))


class FlakyStep:
    """Seeded step-exception injection: raise :class:`ChaosStepError`
    for the first ``fail_steps`` steps (deterministic count — the
    consecutive-error breaker profile), or with probability ``p`` per
    step under a seeded RNG (the intermittent-fault profile).  The hook
    fires BEFORE the engine step, so engine state is never torn."""

    def __init__(self, fail_steps: int = 3, p: float = 0.0, seed: int = 0):
        self.remaining = int(fail_steps)
        self.p = float(p)
        self._rng = random.Random(seed)
        self.calls = 0
        self.raised = 0

    def __call__(self, replica=None) -> None:
        self.calls += 1
        fail = False
        if self.remaining > 0:
            self.remaining -= 1
            fail = True
        elif self.p and self._rng.random() < self.p:
            fail = True
        if fail:
            self.raised += 1
            raise ChaosStepError(
                f"chaos: injected step failure #{self.raised}"
                + (f" ({self.remaining} deterministic left)"
                   if self.remaining else ""))


class PoolSqueeze:
    """Shrink an engine's allocatable KV pool by holding ``pages``
    truly-free pages out of circulation (never evicting prefix-cache
    LRU content) — the slow-leak / noisy-neighbor memory profile that
    turns admission into preemption storms.  Context manager; or call
    ``release()`` explicitly."""

    def __init__(self, engine, pages: int):
        take = min(int(pages), engine.allocator.uncached_free_pages)
        self.engine = engine
        self.held = engine.allocator.alloc(take) if take > 0 else []

    @property
    def pages(self) -> int:
        return len(self.held)

    def release(self) -> None:
        if self.held:
            self.engine.allocator.free(self.held)
            self.held = []

    def __enter__(self) -> "PoolSqueeze":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# ------------------------------------------------------- on-disk corrupters
def bitflip_array(save_dir: str, tag: str, seed: int = 0) -> Tuple[str, int]:
    """Flip one bit in the largest data file of a committed tag (seeded
    choice of offset) — the classic undetectable-without-checksums
    corruption.  Returns (relative file, byte offset)."""
    path = os.path.join(save_dir, tag)
    candidates = []
    for dirpath, _dirs, names in os.walk(path):
        for name in names:
            if name == "commit_manifest.json":
                continue
            full = os.path.join(dirpath, name)
            candidates.append((os.path.getsize(full), full))
    if not candidates:
        raise FileNotFoundError(f"no data files under {path}")
    size, victim = max(candidates)
    if size == 0:
        raise ValueError(f"largest file {victim} is empty; nothing to flip")
    offset = random.Random(seed).randrange(size)
    with open(victim, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0x01]))
    return os.path.relpath(victim, path), offset


def tear_manifest(save_dir: str, tag: str, keep_fraction: float = 0.5) -> str:
    """Truncate a tag's commit manifest mid-file — the torn-write shape
    a crash between write and fsync leaves behind."""
    man = os.path.join(save_dir, tag, "commit_manifest.json")
    size = os.path.getsize(man)
    with open(man, "r+b") as f:
        f.truncate(max(1, int(size * keep_fraction)))
    return man


def make_partial_staging(save_dir: str, tag: str,
                         n_files: int = 2, seed: int = 0) -> str:
    """Fabricate a ``tmp.<tag>`` staging dir with partial garbage — the
    debris of a save killed before its commit point.  GC must remove
    it; resolve_tag must never consider it."""
    staging = os.path.join(save_dir, f"tmp.{tag}")
    os.makedirs(staging, exist_ok=True)
    rng = random.Random(seed)
    for i in range(n_files):
        with open(os.path.join(staging, f"partial_{i}.bin"), "wb") as f:
            f.write(bytes(rng.randrange(256) for _ in range(64)))
    return staging


def corrupt_latest_pointer(save_dir: str, target: str = "no_such_tag") -> str:
    """Point ``latest`` at a tag that does not exist (stale pointer
    after a GC race or manual surgery)."""
    latest = os.path.join(save_dir, "latest")
    with open(latest, "w") as f:
        f.write(target)
    return latest


def read_manifest(save_dir: str, tag: str) -> dict:
    with open(os.path.join(save_dir, tag, "commit_manifest.json")) as f:
        return json.load(f)
