"""The fleet's SLO machinery (the fleet cases of
``tests/unit/test_serving_slo.py``): the replica's three-state circuit
breaker, the router's breakers over a flaky or a slow replica, load
shedding at the front door, deadlines through the fleet and a failed
submit leaving no ghost record — each held against the JAX package's
fleet on the same inputs, on the CPU.

The breaker reads step times, so every latency here is injected: the
state-machine cases record scripted times by hand, and the fleet cases
replace the replica module's clock with one that a per-step hook
advances by a scripted delay (the ``SlowReplica`` profile without a
sleep), in both packages alike.  Nothing depends on the host's speed.
Streams are compared exactly (fp32 tiny llama, 2 layers, pages of 8)."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import RaggedRequest as JaxRequest
from deepspeed_tpu.models.llama import llama_model as jax_llama
from deepspeed_tpu.resilience import chaos as jchaos
from deepspeed_tpu.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import replica as jrep
from deepspeed_tpu.serving import router as jrouter
from deepspeed_tpu.serving.admission import RejectedError as JaxRejectedError
from deepspeed_tpu.telemetry import get_registry as jax_registry
from deepspeed_tpu_torch.inference.v2 import (PRIORITY_BATCH, PRIORITY_NORMAL, InferenceEngineV2,
                                              RaggedInferenceConfig, RaggedRequest,
                                              RejectedError)
from deepspeed_tpu_torch.models.llama import llama_model
from deepspeed_tpu_torch.resilience import chaos as tchaos
from deepspeed_tpu_torch.serving import ServingConfig
from deepspeed_tpu_torch.serving import replica as trep
from deepspeed_tpu_torch.serving import router as trouter
from deepspeed_tpu_torch.serving.admission import shed_counter
from deepspeed_tpu_torch.telemetry import get_registry

torch.set_num_threads(2)

CFG = dict(dtype="fp32", page_size=8, num_pages=64, max_seqs=4, max_pages_per_seq=12)
PKG = {"port": (trep, trouter, ServingConfig, RaggedRequest, tchaos, get_registry),
       "jax": (jrep, jrouter, JaxServingConfig, JaxRequest, jchaos, jax_registry)}


def _prompt(n, seed=0, vocab=256):
    return list(map(int, np.random.RandomState(seed).randint(0, vocab, n)))


# ----------------------------- the breaker state machine --------------------
def _breaker_cfg(pkg, **kw):
    base = dict(breaker_latency_factor=3.0, breaker_consec_errors=3, breaker_window=16,
                breaker_min_samples=4, breaker_min_latency_s=0.0, breaker_cooldown_pumps=3,
                breaker_probe_steps=2)
    base.update(kw)
    return PKG[pkg][2](**base)


def _bare_replica(pkg, window=16):
    eng = SimpleNamespace(queue_depth=0, active_count=0,
                          allocator=SimpleNamespace(free_pages=32, num_pages=32))
    return PKG[pkg][0].EngineReplica("r0", eng, breaker_window=window)


#: scripted breaker drills: (config overrides, [("rec", dt, error) |
#: ("eval", fleet_median)]); each transcript is the transitions and states
DRILLS = {
    "latency_trip_recovery_cycle": ({}, [("rec", 0.1, False)] * 6 + [
        ("eval", 0.0), ("eval", 0.01), ("eval", 0.01), ("eval", 0.01), ("eval", 0.01),
        ("rec", 0.005, False), ("eval", 0.01), ("rec", 0.005, False), ("eval", 0.01)]),
    "median_rule_ignores_spikes": ({}, [("rec", 0.005, False)] * 10 + [
        ("rec", 1.5, False), ("eval", 0.005)]),
    "consecutive_error_trip_and_reset": ({"breaker_consec_errors": 3}, [
        ("rec", 0.01, True), ("rec", 0.01, True), ("rec", 0.01, False), ("eval", 0.0)]
        + [("rec", 0.01, True)] * 3 + [("eval", 0.0)]),
    "half_open_retrip_on_errors": ({"breaker_cooldown_pumps": 1}, [("rec", 0.01, True)] * 3 + [
        ("eval", 0.0), ("eval", 0.0)] + [("rec", 0.01, True)] * 3 + [("eval", 0.0)]),
    "intermittent_errors_trip_majority_window": (
        {"breaker_consec_errors": 3, "breaker_min_samples": 4},
        [("rec", 1e-6, True), ("rec", 0.01, False)] * 4 + [("eval", 0.0)]),
    "half_open_single_error_retrips": (
        {"breaker_cooldown_pumps": 1, "breaker_probe_steps": 2, "breaker_consec_errors": 3},
        [("rec", 0.01, True)] * 3 + [("eval", 0.0), ("eval", 0.0), ("rec", 0.01, False),
                                     ("rec", 0.01, True), ("rec", 0.01, False),
                                     ("rec", 0.01, False), ("eval", 0.0)]),
    "half_open_still_slow_retrips_not_recovers": (
        {"breaker_cooldown_pumps": 1, "breaker_probe_steps": 2, "breaker_min_samples": 8,
         "breaker_window": 16},
        [("rec", 0.1, False)] * 8 + [("eval", 0.01), ("eval", 0.01), ("rec", 0.1, False),
                                     ("eval", 0.01), ("rec", 0.1, False), ("eval", 0.01),
                                     ("eval", 0.01), ("rec", 0.008, False),
                                     ("rec", 0.008, False), ("eval", 0.01)]),
}

#: the transitions each drill must take (the JAX test's assertions)
WANT = {
    "latency_trip_recovery_cycle": [None, "trip", None, None, "probe", None, "recover"],
    "median_rule_ignores_spikes": [None],
    "consecutive_error_trip_and_reset": [None, "trip"],
    "half_open_retrip_on_errors": ["trip", "probe", "trip"],
    "intermittent_errors_trip_majority_window": ["trip"],
    "half_open_single_error_retrips": ["trip", "probe", "trip"],
    "half_open_still_slow_retrips_not_recovers": ["trip", "probe", None, "trip", "probe",
                                                  "recover"],
}


def _drill(pkg, name):
    overrides, script = DRILLS[name]
    cfg = _breaker_cfg(pkg, **overrides)
    r = _bare_replica(pkg, window=cfg.breaker_window)
    out = []
    for op in script:
        if op[0] == "rec":
            r._record_step(op[1], error=op[2])
        else:
            out.append((r.breaker_eval(op[1], cfg), r.breaker, r.lat_samples, r.consec_errors,
                        r.step_errors, r.accepts_new()))
    return out, r.step_p50(), r.step_p95()


@pytest.mark.parametrize("name", sorted(DRILLS))
def test_breaker_drill_equals_jax(name):
    """The same recorded step times and errors drive both packages'
    breakers through the same transitions, states and rolling stats."""
    got = _drill("port", name)
    assert [t[0] for t in got[0]] == WANT[name]
    assert got == _drill("jax", name)


def test_breaker_median_rule_ignores_spikes():
    cfg = _breaker_cfg("port")
    r = _bare_replica("port")
    for _ in range(10):
        r._record_step(0.005, error=False)
    r._record_step(1.5, error=False)
    assert r.step_p95() > 1.0 > 0.01 > r.step_p50()
    assert r.breaker_eval(0.005, cfg) is None and r.breaker == trep.BREAKER_CLOSED


def test_breaker_open_drains_placement_half_open_readmits():
    cfg = _breaker_cfg("port")
    r = _bare_replica("port")
    for _ in range(6):
        r._record_step(0.1, error=False)
    assert r.breaker_eval(0.01, cfg) == "trip"
    assert r.breaker == trep.BREAKER_OPEN and not r.accepts_new()
    for _ in range(2):
        r.breaker_eval(0.01, cfg)
    assert r.breaker_eval(0.01, cfg) == "probe"
    assert r.breaker == trep.BREAKER_HALF_OPEN and r.accepts_new() and r.lat_samples == 0


def test_breaker_health_surface():
    for pkg in ("port", "jax"):
        r = _bare_replica(pkg)
        r._record_step(0.004, error=False)
        h = r.health()
        assert h["breaker"] == "closed" and h["step_errors"] == 0
        assert h["step_p50_s"] == pytest.approx(0.004, abs=1e-3)
    assert _bare_replica("port").health().keys() == _bare_replica("jax").health().keys()


def test_serving_config_slo_validation():
    ServingConfig(max_queue_depth=8, shed_occupancy=0.9, breaker_latency_factor=2.5).validate()
    for bad in (dict(shed_occupancy=1.5), dict(breaker_latency_factor=1.0),
                dict(breaker_min_samples=64, breaker_window=8), dict(max_queue_depth=-1)):
        with pytest.raises(ValueError):
            ServingConfig(**bad).validate()
    cfg = ServingConfig.from_dict({"max_queue_depth": 6, "shed_occupancy": 0.8,
                                   "breaker_consec_errors": 5})
    assert (cfg.max_queue_depth, cfg.shed_occupancy, cfg.breaker_consec_errors) == (6, 0.8, 5)


def test_request_slo_defaults():
    r = RaggedRequest(prompt_ids=[1, 2])
    assert r.priority == PRIORITY_NORMAL and r.deadline_s is None
    e = RejectedError("test", retry_after_s=2.5, priority=1)
    assert e.retry_after_s == 2.5 and "retry after 2.50s" in str(e)


# ----------------------------- engines and fleets ---------------------------
@pytest.fixture(scope="module")
def weights():
    jmodel = jax_llama("tiny", max_seq_len=128)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    return {"jax_model": jmodel, "jax": params,
            "numpy": jax.tree_util.tree_map(np.asarray, params),
            "model": llama_model("tiny", max_seq_len=128)}


def _fleet(pkg, weights, **serving):
    _rep, router, scfg, _req, _c, _reg = PKG[pkg]
    serving = scfg(**dict(dict(enabled=True, prefill_replicas=1, decode_replicas=2,
                               disaggregated=True, prefill_chunk=8), **serving))
    if pkg == "jax":
        return router.build_fleet(weights["jax_model"], serving, engine_config=JaxConfig(**CFG),
                                  params=weights["jax"])
    return router.build_fleet(weights["model"], serving,
                              engine_config=RaggedInferenceConfig(**CFG),
                              params=weights["numpy"], device="cpu")


def _control(weights, reqs):
    eng = InferenceEngineV2(weights["model"], RaggedInferenceConfig(**CFG),
                            params=weights["numpy"], device="cpu")
    got = eng.generate_all([RaggedRequest(prompt_ids=list(r.prompt_ids),
                                          max_new_tokens=r.max_new_tokens) for r in reqs])
    return [got[u] for u in sorted(got)]


def test_engine_bounded_queue_rejects(weights):
    eng = InferenceEngineV2(weights["model"], RaggedInferenceConfig(**CFG, max_queue_depth=2),
                            params=weights["numpy"], device="cpu")
    eng.put(RaggedRequest(prompt_ids=_prompt(10), max_new_tokens=4))
    eng.put(RaggedRequest(prompt_ids=_prompt(10, 1), max_new_tokens=4))
    s0 = shed_counter().total()
    with pytest.raises(RejectedError) as ei:
        eng.put(RaggedRequest(prompt_ids=_prompt(10, 2), max_new_tokens=4,
                              priority=PRIORITY_BATCH))
    assert ei.value.reason == "engine_queue_full" and ei.value.retry_after_s > 0
    assert shed_counter().total() == s0 + 1
    # multi-candidate placers own the shed accounting: nothing counted
    with pytest.raises(RejectedError):
        eng.put(RaggedRequest(prompt_ids=_prompt(10, 3), max_new_tokens=4,
                              priority=PRIORITY_BATCH), record_shed=False)
    assert shed_counter().total() == s0 + 1
    for _ in range(30):
        if not eng.has_work():
            break
        eng.step()
    eng.put(RaggedRequest(prompt_ids=_prompt(10, 2), max_new_tokens=4))
    eng.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_fleet_submit_failure_leaves_no_ghost_record(weights, pkg):
    fleet = _fleet(pkg, weights)
    req = PKG[pkg][3]
    with pytest.raises(ValueError):
        fleet.submit(req(prompt_ids=_prompt(500), max_new_tokens=4))
    assert not fleet.has_work()
    u = fleet.submit(req(prompt_ids=_prompt(12), max_new_tokens=4))
    while fleet.has_work():
        fleet.step()
    assert len(fleet.request_state(u)["emitted"]) == 4


def _drive_fleet(fleet, reqs, chaos_at=None, hook=None):
    """Submit, pump until a stream runs on a decode replica, install
    ``hook`` (a chaos hook) on that replica, pump to the end.  Returns
    the streams, the victim, its breaker state and the transcript of
    breaker states per pump."""
    uids = [fleet.submit(r) for r in reqs]
    victim = None
    states = []
    for _ in range(400):
        if not fleet.has_work():
            break
        fleet.step()
        states.append(tuple(r.breaker for r in fleet.replicas.values()))
        if victim is None and hook is not None:
            victim = next((n for n, r in fleet.replicas.items() if n.startswith("decode")
                           and any(fleet.request_state(u)["replica"] == n for u in uids)), None)
            if victim is not None:
                fleet.replicas[victim].inject_chaos(hook())
    return {"streams": [fleet.request_state(u)["emitted"] for u in uids], "victim": victim,
            "breaker": fleet.replicas[victim].breaker if victim else None,
            "failed": [fleet.request_state(u)["failed"] for u in uids],
            "redispatches": [fleet.request_state(u)["redispatches"] for u in uids],
            "states": states}


@pytest.fixture(scope="module")
def flaky_runs(weights):
    out = {}
    for pkg in ("jax", "port"):
        trips = PKG[pkg][5]().counter("deepspeed_tpu_serving_slo_breaker_trips_total",
                                      "breakers tripped open")
        t0 = trips.total()
        req, chaos = PKG[pkg][3], PKG[pkg][4]
        reqs = [req(prompt_ids=_prompt(18 + i, seed=i), max_new_tokens=8) for i in range(4)]
        run = _drive_fleet(_fleet(pkg, weights, breaker_consec_errors=3,
                                  breaker_cooldown_pumps=50), reqs,
                           hook=lambda: chaos.FlakyStep(fail_steps=3, seed=0))
        run["trips"] = trips.total() - t0
        out[pkg] = run
    return out


def test_fleet_flaky_replica_trips_breaker_streams_bit_identical(weights, flaky_runs):
    """Three consecutive step errors on a decode replica open its breaker
    once; its streams re-dispatch and every stream equals the single
    engine's and the JAX fleet's, with the same breaker states each pump."""
    got, want = flaky_runs["port"], flaky_runs["jax"]
    assert got["breaker"] == trep.BREAKER_OPEN and got["trips"] == 1
    reqs = [RaggedRequest(prompt_ids=_prompt(18 + i, seed=i), max_new_tokens=8)
            for i in range(4)]
    assert got["streams"] == _control(weights, reqs)
    assert not any(got["failed"])
    for k in ("streams", "victim", "breaker", "failed", "redispatches", "states", "trips"):
        assert got[k] == want[k], k


class _ScriptedClock:
    """The replica module's ``time`` for a fleet run: ``perf_counter``
    advances only when a replica's chaos hook says how long its step
    took, so every recorded step time is scripted."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def _slow_fleet_run(pkg, weights, monkeypatch):
    rep_mod, _r, _s, req, _c, reg = PKG[pkg]
    clock = _ScriptedClock()
    monkeypatch.setattr(rep_mod, "time", clock)
    fleet = _fleet(pkg, weights, breaker_min_samples=4, breaker_window=8,
                   breaker_cooldown_pumps=50)
    for r in fleet.replicas.values():  # every healthy step takes 10 ms
        r.inject_chaos(lambda _r, c=clock: setattr(c, "now", c.now + 0.01))

    def slow():  # the victim's steps take 100 ms: the SlowReplica profile
        return lambda _r, c=clock: setattr(c, "now", c.now + 0.1)

    trips = reg().counter("deepspeed_tpu_serving_slo_breaker_trips_total",
                          "breakers tripped open")
    t0 = trips.total()
    reqs = [req(prompt_ids=_prompt(14 + 3 * i, seed=70 + i), max_new_tokens=24)
            for i in range(4)]
    run = _drive_fleet(fleet, reqs, hook=slow)
    run["trips"] = trips.total() - t0
    run["p50"] = {n: r.step_p50() for n, r in fleet.replicas.items()}
    return run


def test_fleet_slow_replica_trips_latency_breaker_like_jax(weights, monkeypatch):
    """A decode replica whose steps take 10x its peer's (injected) trips
    the latency rule; its streams re-dispatch bit-identically; the port's
    breaker states each pump, its streams and its rolling medians are the
    JAX fleet's on the same injected times."""
    got = _slow_fleet_run("port", weights, monkeypatch)
    want = _slow_fleet_run("jax", weights, monkeypatch)
    assert got["breaker"] == trep.BREAKER_OPEN and got["trips"] == 1
    reqs = [RaggedRequest(prompt_ids=_prompt(14 + 3 * i, seed=70 + i), max_new_tokens=24)
            for i in range(4)]
    assert got["streams"] == _control(weights, reqs)
    for k in ("streams", "victim", "breaker", "failed", "redispatches", "states", "trips",
              "p50"):
        assert got[k] == want[k], k


def _shed_run(pkg, weights):
    _rep, _r, _s, req, _c, _reg = PKG[pkg]
    err = RejectedError if pkg == "port" else JaxRejectedError
    fleet = _fleet(pkg, weights, max_queue_depth=3, protect_priority=0)
    out = []
    for i in range(8):
        prio = 0 if i % 4 == 3 else 2
        try:
            u = fleet.submit(req(prompt_ids=_prompt(10 + i, seed=90 + i), max_new_tokens=3,
                                 priority=prio))
            out.append(("ok", u, fleet.request_state(u)["replica"]))
        except err as e:
            out.append(("shed", e.reason, e.retry_after_s))
    while fleet.has_work():
        fleet.step()
    return out, [fleet.request_state(o[1])["emitted"] for o in out if o[0] == "ok"]


def test_fleet_sheds_at_the_queue_bound_like_jax(weights):
    """``max_queue_depth`` 3 across the accepting replicas: batch-class
    submissions past it are shed with a retry hint, interactive ones never;
    the same decisions, placements and streams as the JAX fleet."""
    got = _shed_run("port", weights)
    assert [o[0] for o in got[0]].count("shed") > 0
    assert all(o[0] == "ok" for i, o in enumerate(got[0]) if i % 4 == 3)
    assert got == _shed_run("jax", weights)


def _deadline_run(pkg, weights):
    req = PKG[pkg][3]
    fleet = _fleet(pkg, weights)
    live = fleet.submit(req(prompt_ids=_prompt(12, seed=5), max_new_tokens=5, deadline_s=600.0))
    dead = fleet.submit(req(prompt_ids=_prompt(12, seed=6), max_new_tokens=5, deadline_s=0.0))
    while fleet.has_work():
        fleet.step()
    return [(fleet.request_state(u)["emitted"], fleet.request_state(u)["finish_reason"])
            for u in (live, dead)]


def test_fleet_deadlines_like_jax(weights):
    """An exhausted deadline expires at the engine with finish_reason
    ``deadline`` and no token; a live one finishes; as in the JAX fleet."""
    got = _deadline_run("port", weights)
    assert got[1] == ([], "deadline") and len(got[0][0]) == 5
    assert got == _deadline_run("jax", weights)
