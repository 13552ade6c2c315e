"""Cluster launcher (``deepspeed_tpu/launcher/runner.py``): hostfile
parsing, include/exclude filters, the ssh / pdsh / MPI / SLURM launches
and the elastic agent.

    python -m deepspeed_tpu_torch.launcher.runner --hostfile hosts train.py --args

One process per card, as the reference's ``launch.py`` runs one per GPU
(the JAX package runs one per host, which drives every local chip): a
hostfile line ``host slots=N`` gives N cards, ``--include host:0,2``
keeps cards 0 and 2 of ``host`` and ``--exclude host:1`` drops card 1.
Each process gets ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE`` and
``CUDA_VISIBLE_DEVICES`` (its one card, which it sees as ``cuda:0``).  On
this machine card i is the i-th entry of the ``CUDA_VISIBLE_DEVICES`` the
launcher inherited, so a job a scheduler pinned to some cards stays on
them.  A job whose hosts are all this machine spawns its processes
directly; any other host is reached over ssh.  The first process to fail
ends the job: its siblings get SIGTERM, then SIGKILL.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Union

from ..resilience.preemption import EXIT_RESUMABLE
from ..utils.logging import logger

DEFAULT_COORD_PORT = 29500
#: seconds the other ranks of a failed job get between SIGTERM and SIGKILL
#: (time for a training loop's emergency save)
STOP_GRACE_S = 60.0
_LOCAL = ("localhost", "127.0.0.1")


def parse_hostfile(path_or_text: str, is_text: bool = False) -> "OrderedDict[str, int]":
    """``host slots=N`` per line (``#`` starts a comment; slots default 1)."""
    if is_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    hosts: "OrderedDict[str, int]" = OrderedDict()
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.split("#")[0].strip()
        if not line:
            continue
        parts = line.split()
        host, slots = parts[0], 1
        for p in parts[1:]:
            if p.startswith("slots="):
                slots = int(p.split("=", 1)[1])
        if host in hosts:
            raise ValueError(f"hostfile line {lineno}: duplicate host {host}")
        hosts[host] = slots
    if not hosts:
        raise ValueError("hostfile is empty")
    return hosts


def filter_hosts(hosts: "OrderedDict[str, int]", include: str = "",
                 exclude: str = "") -> "OrderedDict[str, int]":
    """``--include host1@host2`` / ``--exclude``: whole hosts (a ``host:0,1``
    slot list selects its host, as in the JAX package)."""
    def parse(sel: str) -> List[str]:
        return [h.split(":")[0] for h in sel.split("@") if h]

    out = OrderedDict(hosts)
    if include:
        keep = parse(include)
        unknown = [h for h in keep if h not in hosts]
        if unknown:
            raise ValueError(f"--include hosts not in hostfile: {unknown}")
        out = OrderedDict((h, hosts[h]) for h in hosts if h in keep)
    if exclude:
        drop = parse(exclude)
        unknown = [h for h in drop if h not in hosts]
        if unknown:
            raise ValueError(f"--exclude hosts not in hostfile: {unknown}")
        out = OrderedDict((h, s) for h, s in out.items() if h not in drop)
    if not out:
        raise ValueError("no hosts remain after include/exclude filtering")
    return out


def select_cards(hosts: "OrderedDict[str, int]", include: str = "",
                 exclude: str = "") -> "OrderedDict[str, List[int]]":
    """The cards (slot indices) of each host the job runs on, as the
    reference's ``parse_inclusion_exclusion``: :func:`filter_hosts`' hosts,
    then a ``host:0,2`` in ``include`` keeps only those cards of its host
    and one in ``exclude`` drops them (a bare host in ``exclude`` drops the
    whole host)."""
    def split(sel: str):
        whole, cards = [], {}
        for item in filter(None, sel.split("@")):
            host, _, ids = item.partition(":")
            if ids:
                cards[host] = [int(i) for i in ids.split(",")]
            else:
                whole.append(host)
        return whole, cards

    _, keep = split(include)
    drop_hosts, drop = split(exclude)
    unknown = [h for h in drop if h not in hosts]
    if unknown:
        raise ValueError(f"--exclude hosts not in hostfile: {unknown}")
    out: "OrderedDict[str, List[int]]" = OrderedDict()
    for host, slots in filter_hosts(hosts, include, "@".join(drop_hosts)).items():
        ids = keep.get(host, list(range(slots)))
        bad = [i for i in ids + drop.get(host, []) if not 0 <= i < slots]
        if bad:
            raise ValueError(f"{host}: cards {bad} outside its slots={slots}")
        ids = [i for i in ids if i not in drop.get(host, [])]
        if ids:
            out[host] = ids
    if not out:
        raise ValueError("no hosts remain after include/exclude filtering")
    return out


def process_envs(hosts: "OrderedDict[str, Union[int, Sequence[int]]]",
                 master_addr: Optional[str] = None,
                 master_port: int = DEFAULT_COORD_PORT) -> List[tuple]:
    """``(host, env)`` of every process of the job, in rank order.  A host
    maps to its slot count or to its cards (:func:`select_cards`); its
    processes take consecutive ranks.  On this machine card i is the i-th
    entry of the inherited ``CUDA_VISIBLE_DEVICES`` (unset, device i), and
    a card past its end raises; a remote host's card i is its device i."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    pinned = None if visible is None else [c.strip() for c in visible.split(",") if c.strip()]
    master_addr = master_addr or next(iter(hosts))
    cards = [(h, list(range(c)) if isinstance(c, int) else list(c)) for h, c in hosts.items()]
    world = sum(len(ids) for _, ids in cards)
    out, rank = [], 0
    for host, ids in cards:
        for local, card in enumerate(ids):
            dev = str(card)
            if host in _LOCAL and pinned is not None:
                if card >= len(pinned):
                    raise ValueError(f"{host}: card {card} asked for, but CUDA_VISIBLE_DEVICES="
                                     f"{visible!r} shows {len(pinned)} card(s)")
                dev = pinned[card]
            out.append((host, {"MASTER_ADDR": master_addr, "MASTER_PORT": str(master_port),
                               "RANK": str(rank), "LOCAL_RANK": str(local),
                               "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(len(ids)),
                               "CUDA_VISIBLE_DEVICES": dev}))
            rank += 1
    return out


def build_launch_commands(hosts: "OrderedDict[str, Union[int, Sequence[int]]]", script: str,
                          script_args: List[str], master_addr: Optional[str] = None,
                          master_port: int = DEFAULT_COORD_PORT,
                          export_env: Optional[Dict[str, str]] = None,
                          ssh_port: int = 22) -> List[List[str]]:
    """One command per process (per card): ``bash -c`` when every host is
    this machine, else ssh to the process's host (each rank then gets the
    same clean login environment).  The shell ``exec``s Python, so a signal
    sent to the command reaches the training process."""
    all_local = all(h in _LOCAL for h in hosts)
    cmds = []
    for host, env in process_envs(hosts, master_addr, master_port):
        env.update(export_env or {})
        envstr = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
        inner = (f"cd {shlex.quote(os.getcwd())} && exec env {envstr} "
                 f"{shlex.quote(sys.executable)} -u {shlex.quote(script)} "
                 + " ".join(shlex.quote(a) for a in script_args))
        cmds.append(["bash", "-c", inner] if all_local
                    else ["ssh", "-p", str(ssh_port), host, inner])
    return cmds


def _stop(procs: List[subprocess.Popen]) -> None:
    """SIGTERM every live process, SIGKILL what is left after
    ``STOP_GRACE_S``."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        p.terminate()
    deadline = time.monotonic() + STOP_GRACE_S
    for p in live:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def run_commands(cmds: List[List[str]]) -> int:
    """Start every command and watch them all.  The first to exit non-zero
    ends the job: the others get SIGTERM (a training loop with
    ``resilience`` on saves and exits 75) and SIGKILL after
    ``STOP_GRACE_S``.
    Returns 0 when every process exited 0; 75 (resumable) when every
    process that did not exited 75; else the first failure's code that is
    not 75."""
    procs = [subprocess.Popen(cmd) for cmd in cmds]
    first = None  # the code of the first process seen to fail
    try:
        while True:
            codes = [p.poll() for p in procs]
            first = next((c for c in codes if c not in (None, 0)), None)
            if first is not None or None not in codes:
                break
            time.sleep(0.1)
    finally:
        _stop(procs)
    codes = [p.returncode for p in procs]
    if all(c in (0, EXIT_RESUMABLE) for c in codes):
        return EXIT_RESUMABLE if EXIT_RESUMABLE in codes else 0
    if first != EXIT_RESUMABLE:
        return first
    return next(c for c in codes if c not in (0, EXIT_RESUMABLE))


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser("deepspeed_tpu_torch.launcher")
    parser.add_argument("--hostfile", default=None)
    parser.add_argument("--include", default="")
    parser.add_argument("--exclude", default="")
    parser.add_argument("--master_addr", default=None)
    parser.add_argument("--master_port", type=int, default=DEFAULT_COORD_PORT)
    parser.add_argument("--ssh_port", type=int, default=22)
    parser.add_argument("--force_multi", action="store_true")
    parser.add_argument("--launcher", default="ssh",
                        choices=["ssh", "pdsh", "openmpi", "mpich", "impi", "slurm", "mvapich"],
                        help="multinode backend")
    parser.add_argument("--elastic_training", action="store_true",
                        help="relaunch on failure and after a resumable exit, re-reading "
                             "the hostfile each attempt (elasticity.elastic_agent)")
    parser.add_argument("--max_elastic_restarts", type=int, default=3)
    parser.add_argument("script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    if args.elastic_training:
        if args.launcher != "ssh":
            parser.error("--elastic_training relaunches over ssh only; --launcher "
                         f"{args.launcher} is not supported with it")
        from ..elasticity.elastic_agent import ElasticAgent

        agent = ElasticAgent(hostfile=args.hostfile, include=args.include,
                             exclude=args.exclude, max_restarts=args.max_elastic_restarts,
                             master_addr=args.master_addr, master_port=args.master_port,
                             ssh_port=args.ssh_port)
        return agent.run(args.script, args.script_args)

    if args.hostfile:
        hosts = select_cards(parse_hostfile(args.hostfile), args.include, args.exclude)
    else:
        hosts = OrderedDict([("localhost", [0])])

    if args.launcher != "ssh":
        from .multinode_runner import get_runner

        if any(ids != list(range(len(ids))) for ids in hosts.values()):
            parser.error(f"--launcher {args.launcher} starts each host's first slots cards; "
                         "a host:cards list is honoured by the ssh launcher only")
        counts = OrderedDict((h, len(ids)) for h, ids in hosts.items())
        runner = get_runner(args.launcher, counts, master_addr=args.master_addr,
                            master_port=args.master_port)
        cmd = runner.get_cmd(args.script, args.script_args)
        logger.info(f"launcher[{args.launcher}]: {' '.join(cmd)}")
        return subprocess.call(cmd)
    return run_commands(build_launch_commands(hosts, args.script, args.script_args,
                                              args.master_addr, args.master_port,
                                              ssh_port=args.ssh_port))


if __name__ == "__main__":
    sys.exit(main())
