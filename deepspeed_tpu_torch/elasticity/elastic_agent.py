"""Elastic runtime recovery (``deepspeed_tpu/elasticity/elastic_agent.py``).

The agent is a launcher-side watchdog.  Each attempt re-reads the
hostfile (a resize between attempts is a changed host set and world
size), launches the training script once per card of every host
(``launcher.runner.build_launch_commands``) and waits.  Exit codes follow
``resilience/preemption.py``:

* ``EXIT_RESUMABLE`` (75), a preemption after its emergency save:
  relaunch at once without using up ``max_restarts``, bounded by
  ``max_preemption_restarts``; the script auto-resumes from the save;
* a non-resumable code (``NON_RESUMABLE_EXIT_CODES``: 78 config, 64
  usage, 2 argparse): stop, a relaunch would fail the same way;
* any other non-zero code, a crash: relaunch up to ``max_restarts`` times
  after an exponential backoff with jitter from a seeded generator
  (``restart_delay_s`` doubled per consecutive failure, capped at
  ``max_restart_delay_s``, plus up to ``backoff_jitter`` of it).

The agent's process runs no training and installs no signal handler;
each attempt is noted on the flight recorder when one is installed.
"""

from __future__ import annotations

import random
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional

from ..resilience.preemption import EXIT_RESUMABLE, NON_RESUMABLE_EXIT_CODES
from ..utils.logging import logger
from .elasticity import compute_elastic_config  # noqa: F401  (re-export)

DEFAULT_COORD_PORT = 29500


class ElasticAgent:
    def __init__(self, hostfile: Optional[str] = None, include: str = "",
                 exclude: str = "", max_restarts: int = 3,
                 master_addr: Optional[str] = None,
                 master_port: int = DEFAULT_COORD_PORT, ssh_port: int = 22,
                 restart_delay_s: float = 1.0, max_restart_delay_s: float = 60.0,
                 backoff_jitter: float = 0.25,
                 non_resumable_exit_codes: Optional[Iterable[int]] = None,
                 max_preemption_restarts: int = 16,
                 export_env: Optional[Dict[str, str]] = None,
                 seed: Optional[int] = None):
        self.hostfile = hostfile
        self.include = include
        self.exclude = exclude
        self.max_restarts = int(max_restarts)
        self.master_addr = master_addr
        self.master_port = master_port
        self.ssh_port = ssh_port
        self.restart_delay_s = float(restart_delay_s)
        self.max_restart_delay_s = float(max_restart_delay_s)
        self.backoff_jitter = float(backoff_jitter)
        self.non_resumable_exit_codes = set(
            NON_RESUMABLE_EXIT_CODES if non_resumable_exit_codes is None
            else non_resumable_exit_codes)
        self.max_preemption_restarts = int(max_preemption_restarts)
        self.export_env = export_env
        self.attempts = 0
        self.preemptions = 0
        self.failures = 0
        self.world_sizes: List[int] = []  # processes (cards) of each attempt
        self.delays: List[float] = []  # the backoff slept before each crash relaunch
        self.exit_codes: List[int] = []
        self._rand = random.Random(seed)

    def _hosts(self) -> "OrderedDict[str, List[int]]":
        """Each host's cards, from the hostfile re-read every attempt."""
        from ..launcher.runner import parse_hostfile, select_cards

        if self.hostfile:
            return select_cards(parse_hostfile(self.hostfile), self.include, self.exclude)
        return OrderedDict([("localhost", [0])])

    def _run_attempt(self, cmds: List[List[str]]) -> int:
        from ..launcher.runner import run_commands

        return run_commands(cmds)

    def _backoff_delay(self, consecutive_failures: int) -> float:
        """base x 2^(failures - 1), capped, then up to ``backoff_jitter`` of
        it on top from the agent's seeded generator."""
        delay = min(self.max_restart_delay_s,
                    self.restart_delay_s * (2 ** max(0, consecutive_failures - 1)))
        return delay * (1.0 + self.backoff_jitter * self._rand.random())

    def _note(self, **fields) -> None:
        """The attempt on the flight recorder's event ring, when one is
        installed (the restart history survives into incident dumps)."""
        from ..telemetry.flight import get_flight_recorder

        fr = get_flight_recorder()
        if fr is not None:
            fr.note("elastic_attempt", **fields)

    def run(self, script: str, script_args: Optional[List[str]] = None) -> int:
        from ..launcher.runner import build_launch_commands

        script_args = list(script_args or [])
        self.attempts = self.preemptions = self.failures = 0
        while True:
            hosts = self._hosts()
            world = sum(len(ids) for ids in hosts.values())
            self.attempts += 1
            self.world_sizes.append(world)
            self._note(attempt=self.attempts, world=world, failures=self.failures,
                       preemptions=self.preemptions)
            cmds = build_launch_commands(hosts, script, script_args, self.master_addr,
                                         self.master_port, export_env=self.export_env,
                                         ssh_port=self.ssh_port)
            if self.attempts > 1:
                logger.warning(f"elastic agent: relaunch (attempt {self.attempts}, "
                               f"{self.failures}/{self.max_restarts} failures, "
                               f"{self.preemptions} preemptions) on {world} card(s)")
            rc = self._run_attempt(cmds)
            self.exit_codes.append(rc)
            if rc == 0:
                return 0
            self._note(attempt=self.attempts, world=world, rc=rc)
            if rc == EXIT_RESUMABLE:
                self.preemptions += 1
                if self.preemptions > self.max_preemption_restarts:
                    logger.error(f"elastic agent: {self.preemptions} preemption exits exceed "
                                 "max_preemption_restarts; giving up")
                    return rc
                logger.warning(f"elastic agent: resumable exit rc={rc} (preemption "
                               f"{self.preemptions}); relaunching to auto-resume")
                continue
            if rc in self.non_resumable_exit_codes:
                logger.error(f"elastic agent: non-resumable exit rc={rc}; not relaunching")
                return rc
            self.failures += 1
            logger.warning(f"elastic agent: attempt {self.attempts} exited rc={rc} "
                           f"(failure {self.failures}/{self.max_restarts})")
            if self.failures > self.max_restarts:
                return rc
            delay = self._backoff_delay(self.failures)
            self.delays.append(delay)
            if delay > 0:
                logger.warning(f"elastic agent: backing off {delay:.2f}s before relaunch")
                time.sleep(delay)
