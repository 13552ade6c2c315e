"""The port's static analysis (``deepspeed_tpu_torch/analysis``) against
the JAX package's: the hazard lint's tests of
``tests/unit/test_static_analysis.py`` and the metric lint's of
``tests/unit/test_metric_names.py`` mirrored on fixture trees under the
port's paths; the same fixture source at the JAX path and at the port
path giving the same ``(rule, line)``s for every form the JAX lint knows,
torch's device reads firing only in the port's; the port's own tree clean
with every suppression reasoned; and the catalog rows the port leaves
pending exactly those registered by JAX modules the port has not yet.
Everything is compared exactly."""

import os

import pytest
import torch

from deepspeed_tpu.analysis import lint as jlint
from deepspeed_tpu.analysis import metric_lint as jmetric
from deepspeed_tpu_torch.analysis import lint as tlint
from deepspeed_tpu_torch.analysis import metric_lint as tmetric

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": ("deepspeed_tpu", jlint), "port": ("deepspeed_tpu_torch", tlint)}


def _write_tree(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    (root / "tools").mkdir(exist_ok=True)
    return str(root)


def _port_tree(root, files):
    return _write_tree(root, {f"deepspeed_tpu_torch/{k}": v for k, v in files.items()})


#: the JAX hazard tests' fixture sources, by the package-relative path
#: they sit at; every one lints the same in both packages
FIXTURES = {
    "item_in_decode_loop": {"inference/v2/engine_v2.py":
                            "def _step_impl(self):\n    tok = logits.item()\n    return tok\n"},
    "cold_item": {"inference/v2/engine_v2.py":
                  "def _debug_dump(self):\n    return logits.item()\n"},
    "socket_recv": {"serving/router.py":
                    "def step(self):\n    return self._poll_remote()\n"
                    "def _poll_remote(self):\n    data = self._sock.recv(4096)\n    return data\n"},
    "socket_accept": {"inference/v2/engine_v2.py":
                      "def step(self):\n    conn, _ = self.listener.accept()\n    return conn\n"},
    "reachability": {"runtime/engine.py":
                     "def train_batch(self, batch):\n    self._report(1.0)\n"
                     "def _report(self, loss):\n    self._publish(loss)\n"
                     "def _publish(self, loss):\n    v = float(loss)\n"},
    "pipe_tick": {"runtime/pipe/engine.py":
                  "def _pipe_body(params, ids, labels, stage_arr, pipe_comm):\n"
                  "    s = float(stage_arr)\n    return s\n"},
    "pipe_overlap_monolithic": {
        "runtime/pipe/overlap.py": "def reduce_stage_grads(self, dlayers):\n"
                                   "    return psum_tree(dlayers)\n",
        "runtime/zero/overlap.py": "def _compressed_bucket_reduce(x):\n"
                                   "    return bucketed_map(x)\n"},
    "numerics_item": {"runtime/engine.py":
                      "def train_batch(self, batch):\n"
                      "    state, loss, stats = self._fused(batch)\n"
                      "    self._last_numerics = stats\n"
                      "    gn = stats['grad_norm'].item()\n    return loss\n"},
    "numerics_boundary": {"runtime/engine.py":
                          "def train_batch(self, batch):\n    self._numerics_boundary()\n"
                          "def _numerics_boundary(self):\n"
                          "    # dstpu-lint: allow[host-sync] boundary cadence pull\n"
                          "    host = jax.device_get(self._last_numerics)\n    return host\n"},
    "rules": {"runtime/worker.py":
              "import time, random\nt0 = time.time()\nx = random.randint(0, 3)\n"
              "def f(acc=[]):\n    try:\n        pass\n    except Exception:\n        pass\n",
              "runtime/zero/strategy.py": "def specs(tree):\n    return [k for k in set(tree)]\n"},
    "bad_markers": {"runtime/worker.py":
                    "import time\nt0 = time.time()  # dstpu-lint: allow[wall-clock]\n"
                    "t1 = time.time()  # dstpu-lint: allow[wall-clok] typoed rule\n"},
    "docstring_marker": {"runtime/engine.py":
                         'def train_batch(self, loss):\n    """Example:\n'
                         "    # dstpu-lint: allow[host-sync] docs only\n"
                         '    """\n    return float(loss)\n'},
    "nested_def": {"runtime/engine.py":
                   "def train_batch(self, x):\n    def inner():\n        return float(x)\n"
                   "    return inner()\n"},
    "marker_rides": {"runtime/engine.py":
                     "def train_batch(self, loss, scale):\n"
                     "    # dstpu-lint: allow[host-sync] boundary cadence; the\n"
                     "    # queue is already drained here\n"
                     "    log(f'{float(loss)} '\n        f'{float(scale)}')\n"},
    "slo_exemplar": {"serving/slo_x.py":
                     "class Shed:\n    def __init__(self, reg):\n"
                     "        self._m_shed = reg.counter(\n"
                     "            'deepspeed_tpu_serving_slo_shed_total', 'h')\n"
                     "    def bad(self):\n        self._m_shed.inc(reason='queue_full')\n"
                     "    def good(self, tid):\n        self._m_shed.inc(reason='queue_full')\n"
                     "        slo_exemplar('deepspeed_tpu_serving_slo_shed_total', tid)\n"},
}


def _lint(which, tmp_path, files):
    pkg, mod = PKGS[which]
    root = _write_tree(tmp_path / which, {f"{pkg}/{k}": v for k, v in files.items()})
    return mod.check(root)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_the_same_source_lints_the_same_at_both_paths(name, tmp_path):
    got = {w: [(v.rule, v.lineno, os.path.relpath(v.rel, PKGS[w][0])) for v in
               _lint(w, tmp_path, FIXTURES[name])] for w in PKGS}
    assert got["port"] == got["jax"]


def test_torch_device_reads_fire_only_in_the_port(tmp_path):
    src = {"runtime/engine.py":
           "def train_batch(self, batch):\n"
           "    a = batch.cpu()\n"
           "    b = a.numpy()\n"
           "    torch.cuda.synchronize()\n"
           "    self._stream.synchronize()\n"
           "    return b\n"}
    assert _lint("jax", tmp_path, src) == []
    port = _lint("port", tmp_path, src)
    assert [(v.rule, v.lineno) for v in port] == [("host-sync", n) for n in (2, 3, 4, 5)]
    assert "torch.cuda.synchronize()" in port[2].message and ".synchronize()" in port[3].message
    assert ".cpu()" in port[0].message and ".numpy()" in port[1].message


# --- the hazard tests of test_static_analysis.py, on the port's paths --------
def test_package_hazard_clean_with_documented_suppressions():
    violations = tlint.check(REPO)
    assert not violations, "\n".join(str(v) for v in violations)
    sups = tlint.suppressions(REPO)
    assert sups, "expected the port's documented suppressions"
    for rel, ln, rules, reason in sups:
        assert rel.startswith("deepspeed_tpu_torch")
        assert reason.strip(), f"{rel}:{ln}: allow[{rules}] without a reason"
        assert rules <= set(tlint.RULES), (rel, ln, rules)


def test_the_module_entry_point_exits_nonzero_on_a_violation(tmp_path, capsys):
    assert tlint.main([REPO]) == 0
    root = _port_tree(tmp_path, FIXTURES["item_in_decode_loop"])
    assert tlint.main([root]) == 1
    assert "host-sync" in capsys.readouterr().out


def test_hazard_item_in_decode_loop_fails(tmp_path):
    violations = tlint.check(_port_tree(tmp_path, FIXTURES["item_in_decode_loop"]))
    assert len(violations) == 1
    v = violations[0]
    assert v.rule == "host-sync" and ".item()" in v.message and "_step_impl" in v.message
    assert tlint.check(_port_tree(tmp_path / "cold", FIXTURES["cold_item"])) == []


def test_hazard_blocking_socket_in_step_root_fails(tmp_path):
    violations = tlint.check(_port_tree(tmp_path, FIXTURES["socket_recv"]))
    assert [v.rule for v in violations] == ["socket-hot"]
    assert ".recv()" in violations[0].message and "_poll_remote" in violations[0].message
    violations = tlint.check(_port_tree(tmp_path / "acc", FIXTURES["socket_accept"]))
    assert [v.rule for v in violations] == ["socket-hot"]
    root3 = _port_tree(tmp_path / "cold", {
        "serving/router.py": "def _sender_thread(self):\n    return self._sock.recv(4096)\n"})
    assert tlint.check(root3) == []


def test_hazard_reachability_through_helpers(tmp_path):
    violations = tlint.check(_port_tree(tmp_path, FIXTURES["reachability"]))
    assert [v.rule for v in violations] == ["host-sync"]
    assert "_publish" in violations[0].message


def test_hazard_pipe_tick_body_is_hot_and_overlap_waits_for_its_file(tmp_path):
    violations = tlint.check(_port_tree(tmp_path, FIXTURES["pipe_tick"]))
    assert [v.rule for v in violations] == ["host-sync"]
    assert "_pipe_body" in violations[0].message
    violations = tlint.check(_port_tree(tmp_path / "mono", FIXTURES["pipe_overlap_monolithic"]))
    assert [v.rule for v in violations] == ["grad-overlap"]
    assert "monolithic fp post-backward all-reduce" in violations[0].message
    # without the port's runtime/zero/overlap.py (ROADMAP Queue 1 #9) the
    # overlap contracts wait: the transformer has no hook point to keep yet
    alone = {"runtime/pipe/overlap.py": FIXTURES["pipe_overlap_monolithic"][
        "runtime/pipe/overlap.py"], "models/transformer.py": "def transformer_forward():\n"
                                                             "    return 0\n"}
    assert tlint.check(_port_tree(tmp_path / "gate", alone)) == []
    ok = dict(FIXTURES["pipe_overlap_monolithic"], **{
        "runtime/pipe/overlap.py": "def reduce_stage_grads(self, dlayers):\n"
                                   "    return coalesce_flat(bucketed_map(dlayers))\n"})
    assert tlint.check(_port_tree(tmp_path / "ok", ok)) == []


def test_hazard_numerics_stats_pull_is_boundary_cadence_only(tmp_path):
    violations = tlint.check(_port_tree(tmp_path, FIXTURES["numerics_item"]))
    assert [v.rule for v in violations] == ["host-sync"]
    assert ".item()" in violations[0].message and "train_batch" in violations[0].message
    assert tlint.check(_port_tree(tmp_path / "boundary", FIXTURES["numerics_boundary"])) == []


def test_hazard_rules_fire_and_allowlist_suppresses(tmp_path):
    rules = sorted(v.rule for v in tlint.check(_port_tree(tmp_path, FIXTURES["rules"])))
    assert rules == ["mutable-default", "pytree-order", "swallow", "unseeded-random",
                     "wall-clock"], rules
    root2 = _port_tree(tmp_path / "ok", {"runtime/worker.py":
                                         "import time, random\n"
                                         "t0 = time.time()  # dstpu-lint: allow[wall-clock] "
                                         "record stamp\n"
                                         "# dstpu-lint: allow[unseeded-random] fixture only\n"
                                         "x = random.randint(0, 3)\n"})
    assert tlint.check(root2) == []
    msgs = "\n".join(v.message for v in tlint.check(
        _port_tree(tmp_path / "bad", FIXTURES["bad_markers"])))
    assert "without a reason" in msgs and "unknown rule" in msgs


def test_hazard_docstring_marker_is_not_a_suppression(tmp_path):
    root = _port_tree(tmp_path, FIXTURES["docstring_marker"])
    assert [v.rule for v in tlint.check(root)] == ["host-sync"]
    assert tlint.suppressions(root) == []


def test_hazard_nested_def_reported_once(tmp_path):
    assert len(tlint.check(_port_tree(tmp_path, FIXTURES["nested_def"]))) == 1


def test_hazard_marker_rides_comment_block_and_statement(tmp_path):
    assert tlint.check(_port_tree(tmp_path, FIXTURES["marker_rides"])) == []


def test_hazard_slo_exemplar_contract_fails_by_name(tmp_path):
    vs = [v for v in tlint.check(_port_tree(tmp_path, FIXTURES["slo_exemplar"]))
          if v.rule == "slo-exemplar"]
    assert len(vs) == 1
    assert "deepspeed_tpu_serving_slo_shed_total.inc() in 'bad'" in vs[0].message
    assert "offending trace_id" in vs[0].message


# --- the metric lint: test_metric_names.py's nine tests, on the port --------
def test_package_metric_names_pass():
    errors = tmetric.check(REPO)
    assert not errors, "\n".join(errors)
    names = set(tmetric.collect(REPO))
    assert "deepspeed_tpu_train_phase_seconds" in names
    assert "deepspeed_tpu_serving_decode_seconds" in names
    # the comms logger's family waits for its module (ROADMAP Queue 1 #9)
    assert "deepspeed_tpu_comm_bytes_total" in tmetric.pending_rows(REPO)
    assert tmetric.main([REPO]) == 0


def _port_pkg(tmp_path):
    pkg = tmp_path / "deepspeed_tpu_torch"
    pkg.mkdir()
    return pkg


def test_lint_catches_violations(tmp_path):
    pkg = _port_pkg(tmp_path)
    (pkg / "a.py").write_text("reg.counter('deepspeed_tpu_BadCase_total')\n"
                              "reg.gauge('deepspeed_tpu_dup')\n")
    (pkg / "b.py").write_text("reg.counter('deepspeed_tpu_dup')\n"
                              "Counter('deepspeed_tpu_ok_total')\n")
    joined = "\n".join(tmetric.check(str(tmp_path)))
    assert "deepspeed_tpu_BadCase_total" in joined
    assert "multiple types" in joined and "2 call sites" in joined
    assert "deepspeed_tpu_ok_total'" not in joined
    assert tmetric.main([str(tmp_path)]) == 1


def test_catalog_drift_both_directions(tmp_path):
    pkg = _port_pkg(tmp_path)
    docs = tmp_path / "docs"
    docs.mkdir()
    (pkg / "a.py").write_text(
        "reg.counter('deepspeed_tpu_documented_total')\n"
        "reg.counter('deepspeed_tpu_undocumented_total')\n"
        "reg.counter('deepspeed_tpu_combined_hits_total')\n"
        "reg.counter('deepspeed_tpu_combined_misses_total')\n")
    (docs / "OBSERVABILITY.md").write_text(
        "| name | type |\n|---|---|\n"
        "| `deepspeed_tpu_documented_total` | counter |\n"
        "| `deepspeed_tpu_combined_hits_total` / `_misses_total` | counter |\n"
        "| `deepspeed_tpu_ghost_rows_total` | counter |\n"
        "| `deepspeed_tpu_comm_ghost_total` | counter |\n")
    joined = "\n".join(tmetric.check(str(tmp_path)))
    assert "deepspeed_tpu_undocumented_total" in joined
    assert "deepspeed_tpu_ghost_rows_total" in joined and "dead catalog row" in joined
    assert "deepspeed_tpu_documented_total'" not in joined
    assert "deepspeed_tpu_combined_hits_total" not in joined
    assert "deepspeed_tpu_combined_misses_total" not in joined
    # a comm row is pending while the port has no comm/comms_logger.py, dead after
    assert "deepspeed_tpu_comm_ghost_total" not in joined
    assert set(tmetric.pending_rows(str(tmp_path))) == {"deepspeed_tpu_comm_ghost_total"}
    (pkg / "comm").mkdir()
    (pkg / "comm" / "comms_logger.py").write_text("x = 1\n")
    assert "deepspeed_tpu_comm_ghost_total" in "\n".join(tmetric.check(str(tmp_path)))


def test_catalog_checks_skipped_without_doc(tmp_path):
    pkg = _port_pkg(tmp_path)
    (pkg / "a.py").write_text("reg.counter('deepspeed_tpu_lonely_total')\n")
    assert tmetric.check(str(tmp_path)) == []


@pytest.mark.parametrize("family,owner,good,rogue", [
    ("reqtrace", "reqtrace.py", "deepspeed_tpu_serving_reqtrace_requests_total",
     "deepspeed_tpu_serving_reqtrace_forked_requests"),
    ("numerics", "numerics.py", "deepspeed_tpu_train_numerics_anomalies_total",
     "deepspeed_tpu_train_numerics_forked_total")])
def test_family_is_single_owner_by_module(tmp_path, family, owner, good, rogue):
    pkg = _port_pkg(tmp_path)
    (pkg / "telemetry").mkdir()
    (pkg / "telemetry" / owner).write_text(f"reg.counter('{good}')\n")
    (pkg / "rogue.py").write_text(f"reg.gauge('{rogue}')\n")
    joined = "\n".join(tmetric.check(str(tmp_path)))
    assert rogue in joined and "outside the family owner" in joined
    assert "telemetry" in joined and owner in joined
    assert good not in joined


@pytest.mark.parametrize("prefix,owner,names", [
    ("deepspeed_tpu_serving_reqtrace_", "reqtrace.py", {
        "deepspeed_tpu_serving_reqtrace_requests_total",
        "deepspeed_tpu_serving_reqtrace_phase_seconds_total",
        "deepspeed_tpu_serving_reqtrace_open_requests",
        "deepspeed_tpu_serving_reqtrace_exemplars_total"}),
    ("deepspeed_tpu_train_numerics_", "numerics.py", {
        "deepspeed_tpu_train_numerics_anomalies_total",
        "deepspeed_tpu_train_numerics_boundaries_total",
        "deepspeed_tpu_train_numerics_grad_nonfinite_elems",
        "deepspeed_tpu_train_numerics_grad_norm_median",
        "deepspeed_tpu_train_numerics_divergence_failures_total"})])
def test_package_registers_family_in_owner_module(prefix, owner, names):
    found = tmetric.collect(REPO)
    family = {n: s for n, s in found.items() if n.startswith(prefix)}
    assert set(family) == names
    want = os.path.join("deepspeed_tpu_torch", "telemetry", owner)
    for n, sites in family.items():
        assert all(f == want for f, _ln, _t in sites), (n, sites)


def test_lint_ignores_unrelated_calls(tmp_path):
    pkg = _port_pkg(tmp_path)
    (pkg / "a.py").write_text("itertools.count('x')\ncollections.Counter('abc')\n"
                              "reg.counter(name_variable)\n")
    assert tmetric.check(str(tmp_path)) == []


def test_pending_rows_are_those_of_jax_modules_the_port_lacks():
    """Every catalog row the port does not register is registered in the
    JAX package by files with no port counterpart, and is pending; no
    other row is."""
    jax_found = jmetric.collect(REPO)
    port_found = tmetric.collect(REPO)
    promised = tmetric.collect_catalog(REPO)

    def unported(rel):
        return not os.path.exists(os.path.join(
            REPO, "deepspeed_tpu_torch", os.path.relpath(rel, "deepspeed_tpu")))

    missing = {n for n in promised if n not in port_found}
    assert missing and all(n in jax_found and all(unported(f) for f, _l, _t in jax_found[n])
                           for n in missing), sorted(missing)
    assert set(tmetric.pending_rows(REPO)) == missing
    owners = {f for n in missing for f, _l, _t in jax_found[n]}
    assert owners == {os.path.join("deepspeed_tpu", "comm", "comms_logger.py")}
