"""Training telemetry of the port against the JAX package's, on the CPU.

The same inputs, made from a numpy seed, go through both packages:

* the stall watchdog (verdicts, counters), the MFU table and arithmetic
  (every JAX row, plus the port's H100 row);
* the goodput ledger under one scripted clock and compile stream
  (``summary()`` equal), and its cross-attempt run file written by one
  package and read by the other;
* the numerics builders on seeded fp32 / bf16 / fp16 trees with NaN and
  Inf planted in chosen leaves and layers — JAX's stacked ``[L, ...]``
  layers against the port's list of per-layer trees: norms within 1e-6
  relative, max-abs, counts, path strings and checksums exactly (a flipped
  mantissa bit included);
* the ``NumericsLedger`` on one seeded report stream that fires every
  detector (anomalies, counters, incident, ``summary()``, ``state_dict()``
  loaded across the packages);
* the ``Telemetry`` bundle (parts built, export cadence, ``close()``
  releasing only what it installed), ``wall_clock_breakdown`` and
  ``sanity_checks``;
* both training engines end to end on a tiny llama (2 layers) with
  numerics (activation stats on), goodput, watchdog, memory, sentinel and
  flight on, ``steps_per_print`` 2, 6 steps: fp32 at gas 1 and 2, and
  fp16 through overflow steps; under ``offload_optimizer`` one step.

Tolerances of the engine cases: fp32 as ``test_torch_engine.py`` holds
the two engines (loss and grad norm 1e-5 relative, the same formulas
summed in another order), the per-layer norms within 1e-5; fp16 compute
as that file holds it too (loss 2e-3, norms 2e-2 relative: each op rounds
to 16 bits at other points in XLA's fusions than in PyTorch's kernels);
counts exact in every case.
"""

import importlib
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.telemetry as jtel
import deepspeed_tpu.telemetry.flight as jflight
import deepspeed_tpu.telemetry.goodput as jgood
import deepspeed_tpu.telemetry.memory as jmem
import deepspeed_tpu.telemetry.numerics as jnum
import deepspeed_tpu.telemetry.registry as jreg
import deepspeed_tpu.telemetry.watchdog as jwd
import deepspeed_tpu_torch
import deepspeed_tpu_torch.telemetry as ttel
import deepspeed_tpu_torch.telemetry.flight as tflight
import deepspeed_tpu_torch.telemetry.goodput as tgood
import deepspeed_tpu_torch.telemetry.memory as tmem
import deepspeed_tpu_torch.telemetry.numerics as tnum
import deepspeed_tpu_torch.telemetry.registry as treg
import deepspeed_tpu_torch.telemetry.watchdog as twd
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.runtime import config as tconfig

torch.set_num_threads(2)

# the packages export a function named like the module: import the modules
jmfu = importlib.import_module("deepspeed_tpu.telemetry.mfu")
tmfu = importlib.import_module("deepspeed_tpu_torch.telemetry.mfu")


@pytest.fixture(autouse=True)
def fresh_process_defaults():
    """Each case starts from fresh registries and no installed process
    defaults in either package, and leaves none behind."""
    saved = (jreg.get_registry(), treg.get_registry())
    for reg, mem, fl, gp, nm in ((jreg, jmem, jflight, jgood, jnum),
                                 (treg, tmem, tflight, tgood, tnum)):
        reg.set_registry(reg.MetricsRegistry())
        mem.set_memory_ledger(None)
        fl.install_flight_recorder(None)
        gp.set_goodput_ledger(None)
        nm.set_numerics_ledger(None)
    yield
    for reg, mem, fl, gp, nm in ((jreg, jmem, jflight, jgood, jnum),
                                 (treg, tmem, tflight, tgood, tnum)):
        mem.set_memory_ledger(None)
        fl.install_flight_recorder(None)
        gp.set_goodput_ledger(None)
        nm.set_numerics_ledger(None)
    jreg.set_registry(saved[0])
    treg.set_registry(saved[1])


def _close(a, b, rel, what=""):
    a, b = float(a), float(b)
    if math.isnan(a) or math.isnan(b):
        assert math.isnan(a) and math.isnan(b), (what, a, b)
    elif math.isinf(a) or math.isinf(b):
        assert a == b, (what, a, b)
    else:
        assert abs(a - b) <= rel * max(abs(a), 1e-30), (what, a, b)


# ------------------------------------------------------- watchdog and MFU
def test_watchdog_gives_the_same_verdicts():
    rng = np.random.RandomState(0)
    times = list(0.1 + 0.01 * rng.rand(12)) + [0.5, 0.6, 0.1, 0.11] + \
        list(0.1 + 0.01 * rng.rand(6)) + [0.45]
    seen = []
    for pkg in (jwd, twd):
        fired = []
        wd = pkg.StallWatchdog(multiple=3.0, window=8, name="train",
                               on_stall=lambda n, s, r: fired.append((n, s, round(r, 9))))
        verdicts = [wd.observe(t, step=i) for i, t in enumerate(times)]
        seen.append((verdicts, wd.stall_count, fired))
    assert seen[0] == seen[1]
    assert sum(seen[0][0]) == 3 and len(seen[0][2]) == 2  # two incident edges
    with pytest.raises(ValueError):
        twd.StallWatchdog(multiple=1.0)


def test_mfu_table_and_arithmetic(monkeypatch):
    monkeypatch.delenv("DSTPU_PEAK_FLOPS", raising=False)
    for kind in jmfu.PEAK_BF16_FLOPS:
        assert tmfu.peak_flops_for_kind(kind) == jmfu.peak_flops_for_kind(kind), kind
    for kind in ("TPU v5 lite", "tpu v6e", "Some accelerator"):
        assert tmfu.peak_flops_for_kind(kind) == jmfu.peak_flops_for_kind(kind)
    assert tmfu.peak_flops_for_kind("NVIDIA H100 80GB HBM3") == 989e12
    assert tmfu.peak_flops_for_device("cpu") == 1e12
    for args in ((1e15, 2.0, 1, 1e12), (3e14, 0.5, 4, 197e12), (1.0, 0.0, 1, 1e12)):
        f, s, n, peak = args
        assert tmfu.mfu(f, s, n_chips=n, peak_flops=peak) == \
            jmfu.mfu(f, s, n_chips=n, peak_flops=peak)
    monkeypatch.setenv("DSTPU_PEAK_FLOPS", "5e13")
    assert tmfu.peak_flops_for_kind("NVIDIA H100 80GB HBM3") == 5e13


# --------------------------------------------------------------- goodput
class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive_goodput(pkg, monkeypatch, run_file="", steps=range(1, 9), seed=0):
    """A seeded sequence of steps, phases and an override under a fixed
    clock and a scripted compile stream."""
    rng = np.random.RandomState(seed)
    compile_total = [0.0]
    monkeypatch.setattr(pkg, "_compile_seconds_total", lambda: compile_total[0])
    clock = _Clock()
    led = pkg.GoodputLedger(run_file=run_file, now_fn=clock)
    for step in steps:
        dt = float(0.05 + 0.05 * rng.rand())
        if step % 3 == 0:
            compile_total[0] += 0.01  # a build inside this step
        clock.t += dt + 0.002
        led.observe_step(dt, step=step, stalled=(step == 5))
        if step == 4:
            clock.t += 0.3
            led.observe_phase("checkpoint_save", 0.25)
        if step == 6:
            with led.override("restart"):
                led.observe_phase("checkpoint_load", 0.1)
            led.observe_phase("eval", 0.07)
    compile_total[0] += 0.02  # outside any phase: swept at summary time
    clock.t += 0.5
    return led


def test_goodput_summary_is_equal(monkeypatch):
    js = _drive_goodput(jgood, monkeypatch).summary()
    ts = _drive_goodput(tgood, monkeypatch).summary()
    assert ts == js
    assert abs(sum(ts["buckets"].values()) - ts["lifetime_seconds"]) < 1e-9
    with pytest.raises(ValueError):
        tgood.GoodputLedger().observe_phase("step", 1.0)


@pytest.mark.parametrize("first,second", [(jgood, tgood), (tgood, jgood)],
                         ids=["jax_then_port", "port_then_jax"])
def test_goodput_run_file_crosses_attempts(first, second, tmp_path, monkeypatch):
    """Attempt 1 (one package) runs steps 1-6 and closes; attempt 2 (the
    other, or the same) resumes at step 4: steps 4-6 are recompute."""
    results = []
    for second_pkg in (second, first):
        path = str(tmp_path / f"run_{second_pkg.__name__}.json")
        _drive_goodput(first, monkeypatch, run_file=path, steps=range(1, 7)).close()
        led = _drive_goodput(second_pkg, monkeypatch, run_file=path, steps=range(4, 10), seed=1)
        s = led.close()
        results.append((s["run"], s["buckets"]["restart"], s["recomputed_steps"]))
    assert results[0] == results[1]
    # steps 4-6 re-ran; step 5 rated a stall, the other two recompute
    assert results[0][2] == 2 and results[0][0]["attempts"] == 2


# ------------------------------------------------------ numerics builders
L_LAYERS = 3
_DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
       "fp16": (jnp.float16, torch.float16)}


def _np_tree(dtype, seed=0, poison=True):
    """(JAX tree with stacked layers, port tree with a list of layers) of
    the same values; fp16 values large enough that squares need fp32."""
    rng = np.random.RandomState(seed)
    jd, td = _DT[dtype]
    scale = 300.0 if dtype == "fp16" else 1.0

    def arr(*shape):
        return (rng.randn(*shape) * scale).astype(np.float32)

    raw = {"embed": {"tok": arr(17, 8)}, "final_norm": {"scale": arr(8)},
           "layers": {"attn": {"wq": arr(L_LAYERS, 8, 8), "wo": arr(L_LAYERS, 8, 8)},
                      "mlp": {"w_up": arr(L_LAYERS, 8, 12)},
                      "norm1": {"scale": arr(L_LAYERS, 8)}},
           "lm_head": {"w": arr(8, 17)}}
    if poison:
        raw["layers"]["attn"]["wo"][1, 2, 3] = np.nan
        raw["layers"]["mlp"]["w_up"][2, 0, 0] = np.inf
        raw["layers"]["mlp"]["w_up"][2, 1, 5] = -np.inf
        raw["embed"]["tok"][4, 4] = np.nan

    def jtree(node):
        return {k: jtree(v) for k, v in node.items()} if isinstance(node, dict) \
            else jnp.asarray(node).astype(jd)

    j = jtree(raw)
    # the bits JAX holds (NaN payloads included), so the port holds the same
    ib = {4: (np.uint32, torch.int32), 2: (np.uint16, torch.int16)}
    bits = jax.tree_util.tree_map(
        lambda x: np.array(x).view(ib[x.dtype.itemsize][0]).astype(np.int64), j)

    def ttree(node, i=None):
        if isinstance(node, dict):
            return {k: ttree(v, i) for k, v in node.items()}
        width = torch.empty((), dtype=td).element_size()
        b = node if i is None else node[i]
        b = np.where(b >= 2 ** (8 * width - 1), b - 2 ** (8 * width), b)
        return torch.from_numpy(b.astype(np.int64)).to(ib[width][1]).view(td)

    t = {k: ttree(v) for k, v in bits.items() if k != "layers"}
    t["layers"] = [ttree(bits["layers"], i) for i in range(L_LAYERS)]
    return j, t


def _assert_health(jh, th, rel=1e-6):
    for k in ("norm", "max_abs"):
        a, b = np.asarray(jh[k], np.float64).ravel(), th[k].double().numpy().ravel()
        assert a.shape == b.shape, k
        for x, y in zip(a, b):
            _close(x, y, rel if k == "norm" else 0.0, k)
    np.testing.assert_array_equal(np.asarray(jh["nonfinite"]), th["nonfinite"].numpy())


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "fp16"])
def test_numerics_builders_agree(dtype):
    j, t = _np_tree(dtype)
    inv = 1.0 / 3.0
    _assert_health(jnum.tree_health(j), tnum.tree_health(t))
    _assert_health(jnum.tree_health(j, inv_scale=jnp.float32(inv)),
                   tnum.tree_health(t, inv_scale=torch.tensor(inv, dtype=torch.float32)))
    _assert_health(jnum.stacked_health(j["layers"]), tnum.stacked_health(t["layers"]))
    # the port also takes the JAX layout (a stacked tree) as JAX does
    stacked = {k: v for k, v in t.items() if k != "layers"}
    stacked["layers"] = {"w": torch.stack([lay["attn"]["wq"] for lay in t["layers"]])}
    _assert_health(jnum.stacked_health({"w": j["layers"]["attn"]["wq"]}),
                   tnum.stacked_health(stacked["layers"]))
    jl, tl = jnum.leaf_nonfinite(j), tnum.leaf_nonfinite(t)
    assert list(jl) == list(tl)  # the JAX path strings, in JAX's order
    assert {k: int(v) for k, v in jl.items()} == {k: int(v) for k, v in tl.items()}
    assert int(tl["layers/mlp/w_up"]) == 2 and int(tl["embed/tok"]) == 1
    jc, tc = jnum.leaf_checksums(j), tnum.leaf_checksums(t)
    assert list(jc) == list(tc)
    assert {k: int(v) for k, v in jc.items()} == {k: int(v) for k, v in tc.items()}
    # one flipped mantissa bit in one layer changes the checksum, in both
    flipped = [dict(lay) for lay in t["layers"]]
    flipped[1] = dict(flipped[1], norm1={"scale": t["layers"][1]["norm1"]["scale"].clone()})
    w = flipped[1]["norm1"]["scale"]
    ib = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[w.element_size()]
    w.view(ib)[0] ^= 1
    t2 = dict(t, layers=flipped)
    jw = np.asarray(j["layers"]["norm1"]["scale"])
    ub = {1: np.uint8, 2: np.uint16, 4: np.uint32}[jw.dtype.itemsize]
    jw = jw.copy()
    jw.view(ub)[1, 0] ^= 1
    j2 = dict(j, layers=dict(j["layers"], norm1={"scale": jnp.asarray(jw)}))
    t2c, j2c = tnum.leaf_checksums(t2), jnum.leaf_checksums(j2)
    assert int(t2c["layers/norm1/scale"]) == int(j2c["layers/norm1/scale"]) != \
        int(tc["layers/norm1/scale"])
    # activation rows
    x = np.random.RandomState(3).randn(2, 5, 8).astype(np.float32)
    x[1, 2, 3] = np.inf
    jx = jnp.asarray(x).astype(_DT[dtype][0])
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(_DT[dtype][1])
    ja, ta = np.asarray(jnum.activation_stats(jx)), tnum.activation_stats(tx).numpy()
    np.testing.assert_array_equal(ja[1:], ta[1:])
    _close(ja[0], ta[0], 1e-6)


def _named(tree, prefix=""):
    """(dotted name, tensor) pairs of a port tree, lists indexed."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = []
    for k, v in items:
        name = f"{prefix}{k}"
        out += _named(v, name + ".") if isinstance(v, (dict, list)) else [(name, v)]
    return out


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "fp16"])
def test_engine_leaf_stats_fold_to_the_builders(dtype):
    """The training engine's boundary path — per-tensor norms, one pull,
    exact counts only where a norm is nonfinite, folded on the host —
    gives what JAX's builders give on the stacked tree."""
    j, t = _np_tree(dtype)
    named = _named(t)
    host = tnum.pull_to_host({"s": tnum.leaf_stats([v for _, v in named]),
                              "k": torch.tensor(2)})
    folded = tnum.fold_leaf_stats(host["s"], tnum.leaf_index([n for n, _ in named]), scale=0.5)
    jh = jnum.tree_health(j, inv_scale=jnp.float32(0.5))
    _close(folded["whole"]["norm"], jh["norm"], 1e-6)
    assert folded["whole"]["max_abs"] == float(jh["max_abs"]) or \
        (math.isnan(folded["whole"]["max_abs"]) and math.isnan(float(jh["max_abs"])))
    assert folded["whole"]["nonfinite"] == int(jh["nonfinite"])
    assert folded["leaf"] == {k: int(v) for k, v in jnum.leaf_nonfinite(j).items()}
    jl = jnum.stacked_health(j["layers"], inv_scale=jnp.float32(0.5))
    tl = folded["layers"]
    np.testing.assert_array_equal(tl["nonfinite"], np.asarray(jl["nonfinite"]))
    np.testing.assert_array_equal(tl["max_abs"], np.asarray(jl["max_abs"], np.float64))
    for a, b in zip(tl["norm"], np.asarray(jl["norm"])):
        _close(a, b, 1e-6)
    assert int(host["k"]) == 2


def test_stacked_health_none_means_what_it_means_in_jax():
    assert tnum.stacked_health([]) is None and jnum.stacked_health({}) is None
    a = {"w": torch.ones(2, 2)}
    assert tnum.stacked_health([a, {"v": torch.ones(2, 2)}]) is None
    assert tnum.stacked_health({"a": torch.ones(2, 3), "b": torch.ones(3, 3)}) is None
    assert jnum.stacked_health({"a": jnp.ones((2, 3)), "b": jnp.ones((3, 3))}) is None
    names = ["embed.tok", "layers.0.attn.wq", "layers.1.attn.wq", "layers.10.attn.wq"]
    assert tnum.leaf_index(names) == [("embed/tok", None), ("layers/attn/wq", 0),
                                      ("layers/attn/wq", 1), ("layers/attn/wq", 10)]
    # layers 0, 1 and 10 are not a stack: no per-layer vectors
    host = {"norm": np.ones(4), "max_abs": np.ones(4), "nonfinite": np.zeros(4, np.int64)}
    assert tnum.fold_leaf_stats(host, tnum.leaf_index(names))["layers"] is None


def test_pull_to_host_keeps_kinds():
    stats = {"a": torch.tensor(1.5), "n": torch.tensor(3, dtype=torch.int32),
             "v": {"x": torch.arange(3, dtype=torch.float32)}, "k": None}
    host = tnum.pull_to_host(stats)
    assert host["a"] == 1.5 and int(host["n"]) == 3 and host["k"] is None
    assert isinstance(host["n"], np.integer)
    np.testing.assert_array_equal(host["v"]["x"], [0, 1, 2])


# --------------------------------------------------------- the sentinel
def _report_stream(pkg):
    """One seeded report stream that fires every detector."""
    rng = np.random.RandomState(0)
    reps = []
    for i in range(12):
        reps.append({"step": 2 * (i + 1), "loss": float(3.0 - 0.05 * i + 0.01 * rng.rand()),
                     "grad_norm": float(1.0 + 0.1 * rng.rand()), "skipped_steps": 0,
                     "grad_nonfinite": 0})
    reps.append(dict(reps[-1], step=26, loss=30.0))  # loss spike
    reps.append(dict(reps[-2], step=28, grad_norm=50.0))  # grad spike
    reps.append(dict(reps[-3], step=30, grad_nonfinite=7, first_nonfinite_layer=1,
                     first_nonfinite_leaf="layers/attn/wo", loss=float("nan")))
    reps.append(dict(reps[-4], step=32, skipped_steps=4))  # overflow storm
    for k in range(9):  # stagnant
        reps.append(dict(reps[-5], step=34 + 2 * k, loss=2.5, skipped_steps=4))
    div = pkg.compare_rank_checksums({0: {"a": 1, "b": 2}, 1: {"a": 1, "b": 3}})
    reps.append(dict(reps[-1], step=60, loss=2.4, divergence=div))
    return reps


def test_numerics_ledger_fires_the_same_anomalies():
    out = []
    for pkg, reg in ((jnum, jreg), (tnum, treg)):
        cfg = (jconfig if pkg is jnum else tconfig).NumericsConfig.from_dict(
            {"enabled": True, "min_history": 4, "stagnant_boundaries": 8})
        led = pkg.NumericsLedger(cfg)
        pkg.set_numerics_ledger(led)
        anomalies = [led.observe_boundary(r) for r in _report_stream(pkg)]
        r = reg.get_registry()
        counters = {k: r.counter("deepspeed_tpu_train_numerics_anomalies_total", "",
                                 labelnames=("kind",)).value(kind=k) for k in pkg.ANOMALY_KINDS}
        incident = pkg.pending_incident_meta()
        out.append((anomalies, dict(led.anomaly_counts), counters, led.summary(),
                    led.state_dict(), incident, pkg.last_numerics_summary()))
    assert json.dumps(out[0], sort_keys=True) == json.dumps(out[1], sort_keys=True)
    kinds = set(out[1][1])
    assert kinds == set(tnum.ANOMALY_KINDS), kinds
    # state dicts load across the packages
    for src, dst_pkg, dst_cfg in ((out[0][4], tnum, tconfig), (out[1][4], jnum, jconfig)):
        led = dst_pkg.NumericsLedger(dst_cfg.NumericsConfig.from_dict({"enabled": True}))
        led.load_state_dict(src)
        assert led.state_dict() == src


# ------------------------------------------------------ the bundle
_TEL = {"enabled": True, "export_interval": 3, "numerics": {"enabled": True},
        "stall_watchdog": {"multiple": 4.0}, "timeline": {"every_n_steps": 5}}


@pytest.mark.parametrize("block", [
    _TEL, {"enabled": True}, {"enabled": True, "goodput": {"enabled": False},
                               "memory": {"enabled": False}, "flight_recorder": {"enabled": False},
                               "recompile_sentinel": {"enabled": False},
                               "stall_watchdog": {"enabled": False},
                               "timeline": {"enabled": False}}], ids=["full", "defaults", "bare"])
def test_bundle_builds_the_same_parts_and_exports_at_the_same_steps(block, tmp_path):
    parts = ("jsonl", "prom_file", "prom_http", "watchdog", "flight", "sentinel", "ledger",
             "timeline", "goodput", "numerics")
    seen = []
    for pkg, cfgmod in ((jtel, jconfig), (ttel, tconfig)):
        b = dict(block, prometheus_path=str(tmp_path / f"{pkg.__name__}.prom"))
        tel = pkg.Telemetry(cfgmod.TelemetryConfig.from_dict(b), loop="train")
        built = tuple(getattr(tel, p) is not None for p in parts)
        writes = []
        tel.prom_file.write = lambda w=writes: w.append(True)
        cadence = []
        for step in [1, 2, 3, 4, 7, 8, 9, 10, 14, 16]:
            n = len(writes)
            tel.export(step)
            cadence.append(len(writes) > n)
        tel.close()
        seen.append((built, cadence, tel.export_interval))
    assert seen[0] == seen[1]


def test_bundle_close_releases_only_what_it_installed(tmp_path):
    for pkg, cfgmod, fl, gp, nm in ((jtel, jconfig, jflight, jgood, jnum),
                                    (ttel, tconfig, tflight, tgood, tnum)):
        cfg = cfgmod.TelemetryConfig.from_dict(
            dict(_TEL, flight_recorder={"path": str(tmp_path)}))
        first = pkg.Telemetry(cfg)
        second = pkg.Telemetry(cfg)
        assert fl.get_flight_recorder() is second.flight
        first.close()
        assert (fl.get_flight_recorder(), gp.get_goodput_ledger(), nm.get_numerics_ledger()) \
            == (second.flight, second.goodput, second.numerics)
        second.close()
        assert (fl.get_flight_recorder(), gp.get_goodput_ledger(),
                nm.get_numerics_ledger()) == (None, None, None)


# ---------------------------------------------------- the engines, end to end
def _cfg(dtype="fp32", gas=1, tmp=None, watchdog=False, **extra):
    """The engines' ds-config.  The stall watchdog is off unless asked for:
    it rates a step against the wall-clock median of the steps before it,
    so on a loaded host one slow step would turn a numerics comparison
    into a scheduling one (``test_a_slow_step_is_a_stall_only_with_the_
    watchdog_on`` shows it)."""
    ds = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": gas,
          "steps_per_print": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
          "gradient_clipping": 1.0, "zero_optimization": {"stage": 1},
          "data_types": {"grad_accum_dtype": "fp32"},
          "telemetry": {"enabled": True, "numerics": {"enabled": True, "min_history": 2},
                        "stall_watchdog": {"enabled": watchdog},
                        "flight_recorder": {"path": str(tmp)}}}
    if dtype == "fp16":
        ds["fp16"] = {"enabled": True, "initial_scale_power": 20, "hysteresis": 1}
    ds.update(extra)
    return ds


def _tree():
    cfg = jllama.llama_config("tiny", max_seq_len=32)
    return jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        cfg, jax.random.PRNGKey(0)))


def _run(pkg, ds, tree, batches):
    """One engine from ``ds`` over ``batches``: its boundary reports, its
    registry's family names and training counters."""
    if pkg is deepspeed_tpu:
        e, *_ = pkg.initialize(model=jllama.llama_model("tiny", max_seq_len=32),
                               config=json.loads(json.dumps(ds)),
                               model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
        reg = jreg.get_registry()
    else:
        e, *_ = pkg.initialize(model=tllama.llama_model("tiny", max_seq_len=32),
                               config=json.loads(json.dumps(ds)), model_parameters=tree,
                               device="cpu")
        reg = treg.get_registry()
    reports = []
    for b in batches:
        e.train_batch(jnp.asarray(b) if pkg is deepspeed_tpu else b)
        if e.global_steps % ds["steps_per_print"] == 0:
            reports.append(e.numerics_report()["last_report"])
    summary = e.goodput_summary()
    e.close()
    names = {m.name for m in reg._metrics.values()}

    def counter(name, **labels):
        m = reg._metrics.get(name)
        return None if m is None else m.value(**labels)

    counters = {n: counter(f"deepspeed_tpu_train_{n}")
                for n in ("steps_total", "skipped_steps_total")}
    counters.update({k: counter("deepspeed_tpu_train_numerics_anomalies_total", kind=k)
                     for k in jnum.ANOMALY_KINDS})
    return reports, names, counters, summary, e


def _compare_reports(jr, tr, rel, layer_rel):
    assert len(jr) == len(tr) > 0
    for a, b in zip(jr, tr):
        assert set(a) == set(b), set(a) ^ set(b)
        for k, v in a.items():
            if k == "layers":
                assert set(v) == set(b[k])
                for name, vals in v.items():
                    assert len(vals) == len(b[k][name]) == 2, name
                    for x, y in zip(vals, b[k][name]):
                        if name.endswith("nonfinite"):
                            assert x == y, name
                        else:
                            _close(x, y, layer_rel, name)
            elif isinstance(v, float):
                _close(v, b[k], rel, k)
            else:
                assert v == b[k], (k, v, b[k])


@pytest.mark.parametrize("dtype,gas", [("fp32", 1), ("fp32", 2), ("fp16", 1)],
                         ids=["fp32_gas1", "fp32_gas2", "fp16_overflow"])
def test_engines_give_the_same_boundary_reports(dtype, gas, tmp_path):
    tree = _tree()
    rng = np.random.RandomState(1)
    batches = [rng.randint(0, 256, (gas, 2, 17)) for _ in range(6)]
    ds = _cfg(dtype, gas, tmp_path)
    jr, jn, jc, _, _ = _run(deepspeed_tpu, ds, tree, batches)
    tr, tn, tc, summary, te = _run(deepspeed_tpu_torch, ds, tree, batches)
    low = dtype == "fp16"
    _compare_reports(jr, tr, 2e-3 if low else 1e-5, 2e-2 if low else 1e-5)
    assert all("act_norm" in r["layers"] and "param_norm" in r["layers"] for r in tr)
    assert tn == jn, (sorted(jn - tn), sorted(tn - jn))
    assert tc == jc and tc["steps_total"] == 6
    if low:
        assert tc["skipped_steps_total"] >= 1  # the overflow step(s) were counted
        # a boundary step overflowed: its nonfinite gradients were counted
        # and named, and the sentinel fired on them in both packages
        bad = [r for r in tr if r["grad_nonfinite"] > 0]
        assert bad and all(r["first_nonfinite_leaf"] for r in bad)
        assert tc["nonfinite"] >= 1
    assert summary["productive_steps"] == 6
    assert abs(sum(summary["buckets"].values()) - summary["lifetime_seconds"]) < 1e-9


class _SteppedClock:
    """A stand-in for the engine's ``time`` module: ``perf_counter`` gives
    each train_batch call (two reads: its start and its end) ``durations[i]``
    seconds of wall time."""

    def __init__(self, durations):
        self.durations, self.reads, self.now = list(durations), 0, 1000.0

    def perf_counter(self):
        if self.reads % 2 == 1:  # the end of step reads // 2
            self.now += self.durations[self.reads // 2]
        else:
            self.now += 1.0  # the gap between steps
        self.reads += 1
        return self.now


@pytest.mark.parametrize("watchdog", [True, False], ids=["watchdog_on", "watchdog_off"])
def test_a_slow_step_is_a_stall_only_with_the_watchdog_on(watchdog, tmp_path, monkeypatch):
    """The cause of the boundary-report test's flakes: with the watchdog on
    (multiple 3, five samples) a sixth step longer than 3x the median of
    the first five is rated a stall, and goodput counts it out of the
    productive steps; with the watchdog off the same step is productive."""
    import deepspeed_tpu_torch.runtime.engine as teng

    tree = _tree()
    rng = np.random.RandomState(1)
    batches = [rng.randint(0, 256, (1, 2, 17)) for _ in range(6)]
    monkeypatch.setattr(teng, "time", _SteppedClock([0.1] * 5 + [0.35]))
    stalls = treg.get_registry().counter("deepspeed_tpu_stalled_steps_total", "",
                                         labelnames=("loop",))
    before = stalls.value(loop="train")
    _, _, counters, summary, _ = _run(deepspeed_tpu_torch, _cfg(tmp=tmp_path, watchdog=watchdog),
                                      tree, batches)
    assert counters["steps_total"] == 6
    assert stalls.value(loop="train") - before == (1 if watchdog else 0)
    assert summary["productive_steps"] == (5 if watchdog else 6)
    assert summary["buckets"]["stall"] == (pytest.approx(0.35) if watchdog else 0.0)


def test_offload_boundary_reads_host_scalars_only(tmp_path):
    tree = _tree()
    batches = [np.random.RandomState(2).randint(0, 256, (1, 2, 17))]
    ds = _cfg(tmp=tmp_path, steps_per_print=1,
              zero_optimization={"stage": 1, "offload_optimizer": {"device": "cpu"}})
    jr, jn, jc, _, _ = _run(deepspeed_tpu, ds, tree, batches)
    tr, tn, tc, _, te = _run(deepspeed_tpu_torch, ds, tree, batches)
    # the JAX engine runs on the test mesh's 8-way data axis, where its
    # divergence audit has ranks to compare; the port has one rank
    assert jr[0].pop("divergence")["ok"]
    assert set(tr[0]) == set(jr[0]) == {"step", "loss", "grad_norm", "skipped_steps"}
    _compare_reports(jr, tr, 1e-5, 1e-5)
    assert te._last_numerics is None and tc == jc and tn == jn


def test_memory_ledger_attributes_the_training_state(tmp_path):
    ds = _cfg(tmp=tmp_path, bf16={"enabled": True})
    e, *_ = deepspeed_tpu_torch.initialize(model=tllama.llama_model("tiny", max_seq_len=32),
                                           config=ds, device="cpu", seed=0)
    e.train_batch(np.random.RandomState(0).randint(0, 256, (1, 2, 17)))
    comps = tmem.get_memory_ledger().collect()["components"]

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    assert comps["master_params"]["device"] == nbytes(e.state.params.parameters())
    assert comps["params"]["device"] == nbytes(e._compute.parameters())
    assert comps["optimizer_state"]["device"] == nbytes(e._opt_tensors())
    assert comps["grads"]["device"] == 0  # consumed at the boundary
    assert comps["train_scalars"]["device"] == 4 + 4 + 4
    e.close()
    assert "master_params" not in tmem.get_memory_ledger().collect()["components"]


def test_wall_clock_breakdown_logs_the_same_timers(tmp_path):
    tree = _tree()
    ds = _cfg(tmp=tmp_path, wall_clock_breakdown=True, gradient_accumulation_steps=2)
    logged = []
    for pkg in (deepspeed_tpu, deepspeed_tpu_torch):
        if pkg is deepspeed_tpu:
            e, *_ = pkg.initialize(model=jllama.llama_model("tiny", max_seq_len=32),
                                   config=json.loads(json.dumps(ds)),
                                   model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
        else:
            e, *_ = pkg.initialize(model=tllama.llama_model("tiny", max_seq_len=32),
                                   config=json.loads(json.dumps(ds)), model_parameters=tree,
                                   device="cpu")
        rec = []
        real = e.timers.log
        e.timers.log = lambda names, **k: (rec.append((e.global_steps, [
            n for n in names if n in e.timers.timers])), real(names, **k))
        rng = np.random.RandomState(0)
        for _ in range(4):
            for _ in range(2):
                ids = rng.randint(0, 256, (2, 17))
                e.forward(jnp.asarray(ids) if pkg is deepspeed_tpu else ids)
                e.backward()
            e.step()
        e.close()
        logged.append(rec)
    assert logged[0] == logged[1] == [(2, ["fwd", "bwd", "step"]), (4, ["fwd", "bwd", "step"])]


def test_sanity_checks_raise_on_nonfinite_loss(tmp_path, monkeypatch):
    tree = _tree()
    tree["embed"]["tok"] = tree["embed"]["tok"].copy()
    tree["embed"]["tok"][:] = np.nan
    batch = np.random.RandomState(0).randint(0, 256, (1, 2, 17))
    for dtype, steps_ok in (("fp32", 0), ("fp16", 3)):
        raised = []
        for pkg in (deepspeed_tpu, deepspeed_tpu_torch):
            ds = _cfg(dtype, tmp=tmp_path, sanity_checks=True)
            if pkg is deepspeed_tpu:
                e, *_ = pkg.initialize(model=jllama.llama_model("tiny", max_seq_len=32),
                                       config=ds,
                                       model_parameters=jax.tree_util.tree_map(jnp.asarray,
                                                                               tree))
            else:
                e, *_ = pkg.initialize(model=tllama.llama_model("tiny", max_seq_len=32),
                                       config=ds, model_parameters=tree, device="cpu")
            monkeypatch.setattr(type(e), "_SANITY_MAX_SKIP_RUN", 3)
            n = 0
            with pytest.raises(FloatingPointError, match="non-finite loss"):
                for _ in range(10):
                    e.train_batch(jnp.asarray(batch) if pkg is deepspeed_tpu else batch)
                    n += 1
            raised.append(n)
            e.close()
        assert raised == [steps_ok, steps_ok], (dtype, raised)


def test_flight_dump_carries_the_training_records(tmp_path):
    ds = _cfg(tmp=tmp_path, resilience={"enabled": False})
    e, *_ = deepspeed_tpu_torch.initialize(model=tllama.llama_model("tiny", max_seq_len=32),
                                           config=ds, device="cpu", seed=0)
    for _ in range(2):
        e.train_batch(np.random.RandomState(0).randint(0, 256, (1, 2, 17)))
    path = e.telemetry.flight.dump(reason="manual")
    kinds = [json.loads(line)["kind"] for line in open(path)]
    assert "goodput" in kinds and "numerics" in kinds
    names = [json.loads(line).get("name") for line in open(path)]
    assert "train_batch" in names
    e.close()
    assert os.path.dirname(path) == str(tmp_path)
