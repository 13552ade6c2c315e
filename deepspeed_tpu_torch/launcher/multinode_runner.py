"""Multinode runners: pdsh, OpenMPI, MPICH, Intel MPI, SLURM, MVAPICH
(``deepspeed_tpu/launcher/multinode_runner.py``).

Each runner turns (hosts, script, args, env exports) into ONE scheduler or
MPI command that starts the job on every node.  The port runs one process
per card (a hostfile's ``slots=N`` counts cards), so a job of H hosts is
``sum(slots)`` processes.  Every process gets ``MASTER_ADDR``,
``MASTER_PORT`` and ``WORLD_SIZE`` from the command; its own rank and
local rank come from the backend's variables (``RANK_ENVS``,
``LOCAL_RANK_ENVS``: ``OMPI_COMM_WORLD_RANK``, ``PMI_RANK``,
``SLURM_PROCID``, ...), which :func:`rank_env` maps onto ``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE`` and ``LOCAL_WORLD_SIZE``; pdsh starts one
shell per host, which starts the host's processes with them set.  A
process uses card ``LOCAL_RANK`` (or card 0 of the ``CUDA_VISIBLE_DEVICES``
the ssh launcher sets).
"""

from __future__ import annotations

import os
import shlex
import sys
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional

DEFAULT_COORD_PORT = 29500

#: where each backend puts a process's rank, world size, local rank and
#: local world size, first match wins (the port's own copy of the JAX
#: package's ``comm.comm`` contract, with the one-process-per-card names
#: first)
RANK_ENVS = ("RANK", "OMPI_COMM_WORLD_RANK", "PMI_RANK", "SLURM_PROCID", "MV2_COMM_WORLD_RANK")
SIZE_ENVS = ("WORLD_SIZE", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE", "SLURM_NTASKS",
             "MV2_COMM_WORLD_SIZE")
LOCAL_RANK_ENVS = ("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK", "MPI_LOCALRANKID",
                   "SLURM_LOCALID", "MV2_COMM_WORLD_LOCAL_RANK")
LOCAL_SIZE_ENVS = ("LOCAL_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_SIZE", "MPI_LOCALNRANKS",
                   "SLURM_NTASKS_PER_NODE", "MV2_COMM_WORLD_LOCAL_SIZE")


def _first(env: Mapping[str, str], names, default: str) -> str:
    for n in names:
        if env.get(n) not in (None, ""):
            return env[n]
    return default


def rank_env(env: Optional[Mapping[str, str]] = None) -> Dict[str, str]:
    """``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` of
    this process from whichever launcher started it (a process started
    alone is rank 0 of 1)."""
    env = os.environ if env is None else env
    return {"RANK": _first(env, RANK_ENVS, "0"), "WORLD_SIZE": _first(env, SIZE_ENVS, "1"),
            "LOCAL_RANK": _first(env, LOCAL_RANK_ENVS, "0"),
            "LOCAL_WORLD_SIZE": _first(env, LOCAL_SIZE_ENVS, "1")}


class MultiNodeRunner:
    """Base: the env every process of the job shares."""

    name = "base"
    launcher_binary = ""

    def __init__(self, hosts: "OrderedDict[str, int]", master_addr: Optional[str] = None,
                 master_port: int = DEFAULT_COORD_PORT,
                 export_env: Optional[Dict[str, str]] = None):
        if not hosts:
            raise ValueError("no hosts")
        self.hosts = hosts
        self.master_addr = master_addr or next(iter(hosts))
        self.master_port = master_port
        self.export_env = dict(export_env or {})

    @property
    def n(self) -> int:
        """Processes of the job: one per card."""
        return sum(self.hosts.values())

    def base_env(self) -> Dict[str, str]:
        env = {"MASTER_ADDR": self.master_addr, "MASTER_PORT": str(self.master_port),
               "WORLD_SIZE": str(self.n)}
        env.update(self.export_env)
        return env

    def backend_exists(self) -> bool:  # pragma: no cover - depends on the host
        import shutil

        return shutil.which(self.launcher_binary) is not None

    def get_cmd(self, script: str, script_args: List[str]) -> List[str]:
        raise NotImplementedError


def _script_part(script: str, script_args: List[str]) -> List[str]:
    return [sys.executable, "-u", script] + list(script_args)


class PDSHRunner(MultiNodeRunner):
    """pdsh fan-out: one shell per host (``%n`` its index in the ``-w``
    list), which starts that host's ``slots`` processes with their ranks
    (hosts of equal slot counts: rank = ``%n`` x slots + local rank) and
    waits for them."""

    name = "pdsh"
    launcher_binary = "pdsh"

    def get_cmd(self, script: str, script_args: List[str]) -> List[str]:
        slots = set(self.hosts.values())
        if len(slots) != 1:
            raise ValueError(f"pdsh launches hosts of one slot count; got {dict(self.hosts)}")
        per = slots.pop()
        env = self.base_env()
        env["PDSH_RCMD_TYPE"] = env.get("PDSH_RCMD_TYPE", "ssh")
        exports = " ".join(f"export {k}={shlex.quote(v)};" for k, v in env.items())
        run = " ".join(shlex.quote(p) for p in _script_part(script, script_args))
        spawn = (f"for lr in $(seq 0 {per - 1}); do RANK=$((%n * {per} + lr)) LOCAL_RANK=$lr "
                 f"LOCAL_WORLD_SIZE={per} CUDA_VISIBLE_DEVICES=$lr {run} & done; "
                 "rc=0; for j in $(jobs -p); do wait $j || rc=$?; done; exit $rc")
        inner = f"{exports} cd {shlex.quote(os.getcwd())} && {spawn}"
        return ["pdsh", "-S", "-f", "1024", "-w", ",".join(self.hosts), inner]


class OpenMPIRunner(MultiNodeRunner):
    """mpirun, a host's slots as its cards; ranks arrive as
    ``OMPI_COMM_WORLD_RANK`` / ``_LOCAL_RANK``."""

    name = "openmpi"
    launcher_binary = "mpirun"

    def get_cmd(self, script: str, script_args: List[str]) -> List[str]:
        cmd = ["mpirun", "-n", str(self.n), "--host",
               ",".join(f"{h}:{s}" for h, s in self.hosts.items()),
               "--mca", "btl", "^openib"]
        for k, v in self.base_env().items():
            cmd += ["-x", f"{k}={v}"]
        return cmd + _script_part(script, script_args)


class MPICHRunner(MultiNodeRunner):
    """mpiexec (hydra); ranks arrive as ``PMI_RANK`` / ``MPI_LOCALRANKID``."""

    name = "mpich"
    launcher_binary = "mpiexec"

    def get_cmd(self, script: str, script_args: List[str]) -> List[str]:
        cmd = ["mpiexec", "-n", str(self.n), "-hosts",
               ",".join(f"{h}:{s}" for h, s in self.hosts.items())]
        for k, v in self.base_env().items():
            cmd += ["-genv", k, v]
        return cmd + _script_part(script, script_args)


class IMPIRunner(MPICHRunner):
    """Intel MPI: hydra-compatible."""

    name = "impi"


class SlurmRunner(MultiNodeRunner):
    """srun; ranks arrive as ``SLURM_PROCID`` / ``SLURM_LOCALID``."""

    name = "slurm"
    launcher_binary = "srun"

    def get_cmd(self, script: str, script_args: List[str]) -> List[str]:
        per = max(self.hosts.values())
        cmd = ["srun", "--ntasks", str(self.n), "--ntasks-per-node", str(per),
               "--nodelist", ",".join(self.hosts)]
        exports = self.base_env()
        cmd += [f"--export=ALL,{','.join(f'{k}={v}' for k, v in exports.items())}"]
        return cmd + _script_part(script, script_args)


class MVAPICHRunner(MultiNodeRunner):
    """mpirun_rsh; ranks arrive as ``MV2_COMM_WORLD_RANK`` / ``_LOCAL_RANK``.
    The host list (a host once per card) goes to a temporary hostfile
    (mpirun_rsh has no inline host syntax)."""

    name = "mvapich"
    launcher_binary = "mpirun_rsh"

    def get_cmd(self, script: str, script_args: List[str]) -> List[str]:
        import tempfile

        hf = tempfile.NamedTemporaryFile("w", prefix="dstpu_mvapich_", suffix=".hosts",
                                         delete=False)
        hf.write("".join(f"{h}\n" * s for h, s in self.hosts.items()))
        hf.close()
        cmd = ["mpirun_rsh", "-np", str(self.n), "-hostfile", hf.name]
        cmd += [f"{k}={v}" for k, v in self.base_env().items()]
        return cmd + _script_part(script, script_args)


RUNNERS = {r.name: r for r in (PDSHRunner, OpenMPIRunner, MPICHRunner, IMPIRunner,
                               SlurmRunner, MVAPICHRunner)}


def get_runner(name: str, hosts: "OrderedDict[str, int]", **kw) -> MultiNodeRunner:
    if name not in RUNNERS:
        raise ValueError(f"unknown launcher backend {name!r}; available: {sorted(RUNNERS)}")
    return RUNNERS[name](hosts, **kw)
