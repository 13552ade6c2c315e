"""Parallel experiment scheduler for autotuning
(``deepspeed_tpu/autotuning/scheduler.py``).

Experiments (ds-config candidates) are queued, card slots on hosts are
reserved, trials run concurrently up to the slot limit and
``max_parallel``, results land in per-experiment records, and running
trials are joined before the tuner picks a winner.  The runner callable
executes a trial: :class:`SubprocessTrialRunner` runs the user's script
with the candidate config as a JSON file and reads one metrics JSON line
back; tests pass a plain function.  Scheduling is threading only: reserve,
run and release under one condition variable.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shlex
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..utils.logging import logger


@dataclasses.dataclass
class Node:
    """A host with ``slots`` schedulable card slots."""

    host: str
    slots: int

    def __post_init__(self):
        self.free = self.slots


@dataclasses.dataclass
class Reservation:
    """Slots held on one node for a running experiment."""

    node: Node
    n_slots: int

    def restore(self) -> None:
        self.node.free += self.n_slots


class ResourceManager:
    """Queue experiments, run them concurrently within slot limits.

    ``runner(exp, reservation) -> float | None``: execute one experiment on
    the reserved slots and return its throughput metric (None = failed).
    ``slots_per_exp``: cards each trial needs; an experiment never spans
    nodes.  ``max_parallel``
    caps concurrently running experiments below the raw slot capacity.
    """

    def __init__(self, nodes: List[Node],
                 runner: Callable[[Dict[str, Any], Reservation], Optional[float]],
                 slots_per_exp: int = 1,
                 max_parallel: Optional[int] = None):
        if not nodes:
            raise ValueError("ResourceManager needs at least one node")
        if all(n.slots < slots_per_exp for n in nodes):
            raise ValueError(
                f"no node has {slots_per_exp} slots "
                f"(max {max(n.slots for n in nodes)})")
        self.nodes = nodes
        self.runner = runner
        self.slots_per_exp = slots_per_exp
        self.max_parallel = max_parallel
        self._cv = threading.Condition()
        self._queue: List[Dict[str, Any]] = []
        self._names = set()
        self._running: Dict[int, threading.Thread] = {}
        self.finished: List[Dict[str, Any]] = []
        self._count = 0

    def schedule_experiments(self, exps: List[Dict[str, Any]]) -> None:
        with self._cv:
            for exp in exps:
                name = exp.get("name") or json.dumps(
                    exp.get("config", exp), sort_keys=True)
                if name in self._names:
                    continue  # already scheduled
                self._names.add(name)
                exp = dict(exp)
                exp["exp_id"] = self._count
                exp["name"] = name
                self._count += 1
                self._queue.append(exp)
            self._cv.notify_all()

    def _reserve(self) -> Optional[Reservation]:
        for node in self.nodes:
            if node.free >= self.slots_per_exp:
                node.free -= self.slots_per_exp
                return Reservation(node, self.slots_per_exp)
        return None

    def _worker(self, exp: Dict[str, Any], res: Reservation) -> None:
        # perf_counter, not time.time(): elapsed must survive an NTP step
        t0 = time.perf_counter()
        try:
            tput = self.runner(exp, res)
            err = None
        except Exception as e:  # a crashed trial must not kill the scheduler
            tput, err = None, f"{type(e).__name__}: {e}"
        with self._cv:
            res.restore()
            self.finished.append({
                "exp_id": exp["exp_id"], "name": exp["name"],
                "config": exp.get("config"), "throughput": tput,
                "error": err, "host": res.node.host,
                "elapsed": time.perf_counter() - t0,
            })
            del self._running[exp["exp_id"]]
            self._cv.notify_all()
        if err:
            logger.warning(f"autotuning exp {exp['name']} failed: {err}")

    def run(self, early_stop_patience: Optional[int] = None,
            metric_larger_is_better: bool = True) -> List[Dict[str, Any]]:
        """Drain the queue.  ``early_stop_patience``: after this many
        consecutive finished experiments without a new best metric, the
        remaining queue is dropped (running ones still join)."""
        best = None
        since_best = 0
        with self._cv:
            while True:
                # dispatch as much as capacity allows
                while (self._queue
                       and (self.max_parallel is None
                            or len(self._running) < self.max_parallel)):
                    res = self._reserve()
                    if res is None:
                        break
                    exp = self._queue.pop(0)
                    th = threading.Thread(target=self._worker,
                                          args=(exp, res), daemon=True)
                    self._running[exp["exp_id"]] = th
                    th.start()
                if not self._queue and not self._running:
                    break
                n_before = len(self.finished)
                self._cv.wait(timeout=1.0)
                for rec in self.finished[n_before:]:
                    m = rec["throughput"]
                    if m is None:
                        since_best += 1
                        continue
                    better = (best is None
                              or (m > best if metric_larger_is_better
                                  else m < best))
                    if better:
                        best, since_best = m, 0
                    else:
                        since_best += 1
                if (early_stop_patience is not None
                        and since_best >= early_stop_patience
                        and self._queue):
                    logger.info(
                        f"autotuning: early stop — no improvement in "
                        f"{since_best} trials, dropping "
                        f"{len(self._queue)} queued experiments")
                    self._queue.clear()
        return list(self.finished)

    def parallel_peak(self) -> int:
        """Max experiments that can run at once under current limits."""
        cap = sum(n.slots // self.slots_per_exp for n in self.nodes)
        return cap if self.max_parallel is None else min(cap, self.max_parallel)


#: hosts treated as "this machine" — no launcher prefix needed
_LOCAL_HOSTS = ("", "localhost", "127.0.0.1")


class SubprocessTrialRunner:
    """Run one experiment as a subprocess of ``user_script``: the candidate
    config is written to ``<results_dir>/<name>/exp.json``, the script is
    invoked with ``--exp_config <path>`` plus ``user_args``, the card slots
    are passed in ``DSTPU_TRIAL_SLOTS`` / ``DSTPU_TRIAL_HOST``, and the LAST
    line of stdout that parses as JSON must carry ``{"throughput":
    <float>}``; stderr is saved beside the config.

    On a reserved host that is not this machine the command is prefixed
    with ``launcher``, a template whose elements may hold ``{host}``
    (default ssh); the trial env rides as ``env K=V`` tokens so it crosses
    the launcher, and paths are absolute (a shared file system).  A trial is
    one self-contained experiment on one host, not a rank of a job
    (``launcher.runner.build_launch_commands`` starts those)."""

    def __init__(self, user_script: str, user_args: Optional[List[str]] = None,
                 results_dir: str = "autotuning_results",
                 timeout_s: float = 600.0,
                 launcher: Optional[List[str]] = None):
        self.user_script = os.path.abspath(user_script)
        self.user_args = list(user_args or [])
        self.results_dir = os.path.abspath(results_dir)
        self.timeout_s = timeout_s
        # ConnectTimeout bounds the ssh setup: the remote timeout starts
        # only after the connection
        self.launcher = (launcher if launcher is not None
                         else ["ssh", "-o", "BatchMode=yes",
                               "-o", "ConnectTimeout=15", "{host}"])

    def __call__(self, exp: Dict[str, Any], res: Reservation) -> Optional[float]:
        exp_dir = os.path.join(self.results_dir, str(exp["name"]).replace("/", "_"))
        os.makedirs(exp_dir, exist_ok=True)
        cfg_path = os.path.join(exp_dir, "exp.json")
        with open(cfg_path, "w") as f:
            json.dump(exp.get("config", {}), f)
        env = dict(os.environ)
        trial_env = {"DSTPU_TRIAL_SLOTS": str(res.n_slots),
                     "DSTPU_TRIAL_HOST": res.node.host}
        env.update(trial_env)
        cmd = [sys.executable, self.user_script, "--exp_config", cfg_path,
               *self.user_args]
        local_timeout = self.timeout_s
        if res.node.host not in _LOCAL_HOSTS:
            prefix = [a.format(host=res.node.host) for a in self.launcher]
            # ssh joins its trailing arguments into one remote shell command:
            # quote every token and hand ssh one string.  The timeout runs on
            # the remote host (-k escalates to SIGKILL), so a local ssh kill
            # cannot leave a trial holding the reserved cards; the local
            # timer is only the backstop for a hung transport.
            remote = ["env", *[f"{k}={v}" for k, v in trial_env.items()],
                      "timeout", "-k", "10", str(int(self.timeout_s)), *cmd]
            cmd = prefix + [" ".join(shlex.quote(t) for t in remote)]
            local_timeout = self.timeout_s + 30
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=local_timeout,
            env=env)
        with open(os.path.join(exp_dir, "stderr.log"), "w") as f:
            f.write(proc.stderr)
        if proc.returncode != 0:
            return None
        for line in reversed(proc.stdout.strip().splitlines()):
            try:
                rec = json.loads(line)
            except (ValueError, TypeError):
                continue
            if isinstance(rec, dict) and "throughput" in rec:
                return float(rec["throughput"])
        return None
