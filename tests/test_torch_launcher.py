"""The port's launcher (``launcher/runner.py``, ``launcher/multinode_runner.py``)
and elastic agent (``elasticity/elastic_agent.py``) against the JAX
package's, on the CPU.  Small Python scripts stand in for training (no
engine is built).

* ``parse_hostfile`` / ``filter_hosts``: equal results and equal refusals;
* the launch commands carry the JAX package's hosts, script and arguments;
  where JAX starts one process per host with ``DSTPU_*``, the port starts
  one per card (``slots``) with ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE`` and
  ``CUDA_VISIBLE_DEVICES`` (card i of this machine the i-th of the
  inherited ``CUDA_VISIBLE_DEVICES``; ``host:cards`` lists select cards);
* the first process to fail stops its siblings, and the job's code is
  theirs as the agent reads it;
* the multinode runners name the same hosts and script, the port's with
  the card count;
* ``ElasticAgent``: the same restart decisions, attempts, preemption
  count, return code and backoff delays as the JAX agent for the same
  exit-code sequence and seed; a real script that exits 75 is relaunched
  without using up ``max_restarts``."""

import json
import os
import shlex
import sys
import textwrap
from collections import OrderedDict

import pytest
import torch

from deepspeed_tpu.elasticity import elastic_agent as jagent
from deepspeed_tpu.launcher import multinode_runner as jmn
from deepspeed_tpu.launcher import runner as jrun
from deepspeed_tpu_torch.elasticity import elastic_agent as tagent
from deepspeed_tpu_torch.launcher import multinode_runner as tmn
from deepspeed_tpu_torch.launcher import runner as trun

torch.set_num_threads(2)

HOSTFILES = {
    "one": "localhost slots=1\n",
    "two_local": "localhost slots=2\n",
    "cluster": "# a comment\nworker-0 slots=4\nworker-1 slots=4  # trailing\n\nworker-2\n",
}


def _outcome(fn, *a):
    try:
        return fn(*a)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("name", sorted(HOSTFILES))
def test_parse_and_filter_match_jax(name, tmp_path):
    path = tmp_path / "hosts"
    path.write_text(HOSTFILES[name])
    assert trun.parse_hostfile(str(path)) == jrun.parse_hostfile(str(path))
    hosts = trun.parse_hostfile(HOSTFILES[name], is_text=True)
    assert hosts == jrun.parse_hostfile(HOSTFILES[name], is_text=True)
    names = list(hosts)
    for inc, exc in [("", ""), (names[0], ""), ("", names[0]), (f"{names[0]}:0,1", ""),
                     ("nohost", ""), ("", "@".join(names))]:
        assert _outcome(trun.filter_hosts, hosts, inc, exc) == \
            _outcome(jrun.filter_hosts, hosts, inc, exc), (inc, exc)


@pytest.mark.parametrize("text", ["", "# only a comment\n", "a slots=1\na slots=2\n"])
def test_bad_hostfiles_raise_as_in_jax(text):
    assert _outcome(trun.parse_hostfile, text, True) == _outcome(jrun.parse_hostfile, text, True)
    assert _outcome(trun.parse_hostfile, text, True)[0] == "ValueError"


def _split(cmd):
    """(transport, host, env, script and args) of one launch command."""
    inner = cmd[-1]
    toks = shlex.split(inner)
    i = toks.index("&&")
    rest = toks[i + 1:]
    env = dict(t.split("=", 1) for t in rest if "=" in t and not t.startswith("-")
               and rest.index(t) < rest.index(sys.executable))
    tail = rest[rest.index(sys.executable) + 2:]  # past "-u"
    return cmd[0], (cmd[-2] if cmd[0] == "ssh" else "local"), env, tail


@pytest.mark.parametrize("name", sorted(HOSTFILES))
def test_launch_commands_carry_the_jax_hosts_script_and_args(name, monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    hosts = trun.parse_hostfile(HOSTFILES[name], is_text=True)
    args = ["--deepspeed_config", "ds config.json", "--lr=3e-4"]
    jcmds = jrun.build_launch_commands(hosts, "train.py", args, None, 29511)
    tcmds = trun.build_launch_commands(hosts, "train.py", args, None, 29511,
                                       export_env={"NCCL_DEBUG": "WARN"})
    world = sum(hosts.values())
    assert len(jcmds) == len(hosts) and len(tcmds) == world
    master = next(iter(hosts))
    rank = 0
    for jcmd, (host, slots) in zip(jcmds, hosts.items()):
        jt, jh, jenv, jtail = _split(jcmd)
        assert jenv["DSTPU_COORDINATOR"] == f"{master}:29511"
        for local in range(slots):
            tt, th, tenv, ttail = _split(tcmds[rank])
            assert (tt, th, ttail) == (jt, jh, jtail) and ttail[0] == "train.py"
            assert tenv == {"MASTER_ADDR": master, "MASTER_PORT": "29511", "RANK": str(rank),
                            "LOCAL_RANK": str(local), "WORLD_SIZE": str(world),
                            "LOCAL_WORLD_SIZE": str(slots), "CUDA_VISIBLE_DEVICES": str(local),
                            "NCCL_DEBUG": "WARN"}
            rank += 1


@pytest.mark.parametrize("backend", sorted(tmn.RUNNERS))
def test_multinode_runners_name_the_jax_hosts_and_script(backend):
    hosts = OrderedDict([("n0", 2), ("n1", 2)])
    jcmd = jmn.get_runner(backend, hosts, master_port=29600).get_cmd("t.py", ["--x", "1"])
    tcmd = tmn.get_runner(backend, hosts, master_port=29600).get_cmd("t.py", ["--x", "1"])
    assert tcmd[0] == jcmd[0]
    jtxt, ttxt = " ".join(jcmd), " ".join(tcmd)
    if backend == "mvapich":  # mpirun_rsh reads its hosts from a file
        files = [c[c.index("-hostfile") + 1] for c in (jcmd, tcmd)]
        jtxt, ttxt = (t + " " + open(f).read() for t, f in zip((jtxt, ttxt), files))
        assert open(files[1]).read().split() == ["n0", "n0", "n1", "n1"]  # one line a card
        for f in files:
            os.remove(f)
    for h in hosts:
        assert h in jtxt and h in ttxt
    assert "t.py" in ttxt and "--x" in ttxt
    assert "MASTER_ADDR" in ttxt and "MASTER_PORT" in ttxt and "WORLD_SIZE" in ttxt
    assert "DSTPU_COORDINATOR" not in ttxt
    if backend != "pdsh":
        assert str(4) in tcmd  # the card count, where JAX starts one process a host
    with pytest.raises(ValueError, match="unknown launcher backend"):
        tmn.get_runner("nope", hosts)


def test_rank_env_reads_each_backend():
    assert tmn.rank_env({}) == {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                                "LOCAL_WORLD_SIZE": "1"}
    assert tmn.rank_env({"OMPI_COMM_WORLD_RANK": "5", "OMPI_COMM_WORLD_SIZE": "8",
                         "OMPI_COMM_WORLD_LOCAL_RANK": "1",
                         "OMPI_COMM_WORLD_LOCAL_SIZE": "4"}) == {
        "RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}
    assert tmn.rank_env({"SLURM_PROCID": "3", "SLURM_NTASKS": "4", "RANK": "2"})["RANK"] == "2"
    assert set(jmn.RANK_ENVS[1:]) <= set(tmn.RANK_ENVS)


_ENV_SCRIPT = textwrap.dedent("""
    import json, os, sys
    keys = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "CUDA_VISIBLE_DEVICES",
            "MASTER_ADDR", "MASTER_PORT")
    out = sys.argv[1]
    with open(os.path.join(out, "rank" + os.environ["RANK"] + ".json"), "w") as f:
        json.dump({k: os.environ.get(k) for k in keys} | {"argv": sys.argv[2:]}, f)
""")


def test_main_starts_one_process_per_card(tmp_path, monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    script = tmp_path / "env.py"
    script.write_text(_ENV_SCRIPT)
    hf = tmp_path / "hosts"
    hf.write_text("localhost slots=2\n")
    rc = trun.main(["--hostfile", str(hf), "--master_port", "29533", str(script), str(tmp_path),
                    "--flag", "v"])
    assert rc == 0
    seen = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    for r, s in enumerate(seen):
        assert s == {"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
                     "LOCAL_WORLD_SIZE": "2", "CUDA_VISIBLE_DEVICES": str(r),
                     "MASTER_ADDR": "localhost", "MASTER_PORT": "29533", "argv": ["--flag", "v"]}


CARD_CASES = {  # (include, exclude) on "localhost slots=4\nworker-0 slots=2" -> cards
    "all": ("", "", {"localhost": [0, 1, 2, 3], "worker-0": [0, 1]}),
    "include_cards": ("localhost:1,3", "", {"localhost": [1, 3]}),
    "exclude_a_card": ("", "localhost:0@worker-0", {"localhost": [1, 2, 3]}),
    "include_then_exclude": ("localhost:0,2@worker-0", "localhost:2",
                             {"localhost": [0], "worker-0": [0, 1]}),
    "card_past_slots": ("localhost:4", "", ValueError),
    "excluded_to_nothing": ("localhost:1", "localhost:1", ValueError),
    "unknown_excluded": ("", "nohost:0", ValueError),
}


@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_select_cards_honours_card_lists(name):
    inc, exc, want = CARD_CASES[name]
    hosts = trun.parse_hostfile("localhost slots=4\nworker-0 slots=2\n", is_text=True)
    if want is ValueError:
        with pytest.raises(ValueError):
            trun.select_cards(hosts, inc, exc)
        return
    assert trun.select_cards(hosts, inc, exc) == OrderedDict(want)
    # the whole hosts kept are the JAX package's (which drops card lists)
    if not exc:
        assert list(trun.select_cards(hosts, inc, exc)) == list(jrun.filter_hosts(hosts, inc))


def test_local_cards_follow_the_inherited_visible_devices(monkeypatch):
    hosts = OrderedDict([("localhost", [1, 2]), ("worker-0", [0, 1])])
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,6,7")
    envs = trun.process_envs(hosts)
    assert [(h, e["CUDA_VISIBLE_DEVICES"], e["LOCAL_RANK"], e["RANK"]) for h, e in envs] == [
        ("localhost", "6", "0", "0"), ("localhost", "7", "1", "1"),
        ("worker-0", "0", "0", "2"), ("worker-0", "1", "1", "3")]
    assert all(e["WORLD_SIZE"] == "4" and e["LOCAL_WORLD_SIZE"] == "2" for _, e in envs)
    for visible, cards in (("5", 1), ("", 0)):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
        with pytest.raises(ValueError, match=f"shows {cards} card"):
            trun.process_envs(OrderedDict([("localhost", cards + 1)]))


def test_main_keeps_the_cards_a_scheduler_pinned(tmp_path, monkeypatch):
    script = tmp_path / "env.py"
    script.write_text(_ENV_SCRIPT)
    hf = tmp_path / "hosts"
    hf.write_text("localhost slots=3\n")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5,6")
    assert trun.main(["--hostfile", str(hf), "--include", "localhost:0,2", "--master_port",
                      "29534", str(script), str(tmp_path)]) == 0
    seen = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert [(s["CUDA_VISIBLE_DEVICES"], s["LOCAL_RANK"], s["WORLD_SIZE"]) for s in seen] == [
        ("3", "0", "2"), ("6", "1", "2")]


_RANKS_SCRIPT = textwrap.dedent("""
    import os, signal, sys, time
    code, handler = int(sys.argv[1]), sys.argv[2]
    if os.environ["RANK"] == "1":
        time.sleep(0.5)
        sys.exit(code)
    if handler == "resumable":  # as the preemption handler: save, exit 75
        signal.signal(signal.SIGTERM, lambda *a: sys.exit(75))
    time.sleep(60)
    sys.exit(0)
""")


@pytest.mark.parametrize("code,handler,want", [(1, "resumable", 1), (75, "resumable", 75),
                                               (75, "none", -15), (0, "none", 0)],
                         ids=["crash", "all_resumable", "sibling_killed", "ok"])
def test_the_first_failure_stops_its_siblings(tmp_path, code, handler, want, monkeypatch):
    import time

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    script = tmp_path / "ranks.py"
    # rank 0 ends by itself when rank 1 succeeds
    script.write_text(_RANKS_SCRIPT.replace("time.sleep(60)", "time.sleep(60 if "
                                            f"{code} else 1)"))
    t0 = time.monotonic()
    rc = trun.run_commands(trun.build_launch_commands(
        OrderedDict([("localhost", 2)]), str(script), [str(code), handler]))
    assert rc == want and time.monotonic() - t0 < 30.0


# ---------------------------------------------------------------- the agent
SEQUENCES = {"crash_then_ok": [1, 1, 0], "preempt_twice": [75, 75, 0],
             "config_error": [78], "usage_error": [64], "argparse": [2],
             "crashes_past_budget": [1, 1, 1, 1, 1], "mixed": [75, 1, 75, 1, 0],
             "preempt_loop": [75] * 6}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_agent_decides_as_jax(name, tmp_path, monkeypatch):
    hf = tmp_path / "hosts"
    hf.write_text("localhost slots=1\n")
    out = []
    for mod in (jagent, tagent):
        codes = iter(SEQUENCES[name])
        slept = []
        monkeypatch.setattr(mod.time, "sleep", slept.append)
        agent = mod.ElasticAgent(hostfile=str(hf), max_restarts=3, max_preemption_restarts=4,
                                 restart_delay_s=0.5, seed=11)
        agent._run_attempt = lambda cmds: next(codes)
        rc = agent.run("train.py", ["--a"])
        out.append((rc, agent.attempts, agent.preemptions, agent.world_sizes, agent.delays,
                    slept))
    assert out[0] == out[1]


def test_agent_rereads_the_hostfile_and_counts_cards(tmp_path):
    hf = tmp_path / "hosts"
    hf.write_text("localhost slots=2\n")
    agent = tagent.ElasticAgent(hostfile=str(hf), seed=0, restart_delay_s=0.0)
    seen = []

    def attempt(cmds):
        seen.append(len(cmds))
        hf.write_text("localhost slots=1\n")  # the job shrinks between attempts
        return 1 if len(seen) == 1 else 0

    agent._run_attempt = attempt
    assert agent.run("t.py") == 0
    assert seen == [2, 1] and agent.world_sizes == [2, 1] and agent.failures == 1


_PREEMPT_SCRIPT = textwrap.dedent("""
    import os, sys
    mark = sys.argv[1]
    if not os.path.exists(mark):
        open(mark, "w").close()
        sys.exit(75)  # preempted after its emergency save
    sys.exit(0)
""")


def test_agent_relaunches_a_resumable_exit_without_using_the_budget(tmp_path):
    script = tmp_path / "s.py"
    script.write_text(_PREEMPT_SCRIPT)
    hf = tmp_path / "hosts"
    hf.write_text("localhost slots=1\n")
    rc = trun.main(["--hostfile", str(hf), "--elastic_training", "--max_elastic_restarts", "0",
                    str(script), str(tmp_path / "mark")])
    assert rc == 0


def test_agent_stops_at_the_budget_and_on_a_config_error(tmp_path):
    for code, want_attempts in ((3, 2), (78, 1)):
        script = tmp_path / f"exit{code}.py"
        script.write_text(f"import sys; sys.exit({code})\n")
        agent = tagent.ElasticAgent(max_restarts=1, restart_delay_s=0.0, seed=0)
        assert agent.run(str(script)) == code
        assert agent.attempts == want_attempts and agent.exit_codes == [code] * want_attempts
