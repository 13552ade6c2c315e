"""The serving fleet: the port's ``serving/router.py``, ``replica.py`` and
``autoscale.py`` and the engine's ``drain`` / ``inflight_uids`` /
``ready_uids`` against the JAX package's, on the CPU.

Each case of ``tests/unit/test_serving_fleet.py`` has a counterpart here
(its KV-transfer cases — allocator adoption, bundle bytes and trace
blocks, export/import round trips, copy on write, dtype refusal — are in
``test_torch_kv_transfer.py``).  Across the packages: the affinity key's
bytes, the rendezvous scores and the placement choice (exact); the
config blocks' refusals (the same messages); one disaggregated run
through both packages' ``build_fleet`` on the same numpy weights (the same
replica per request, the same migrations, the same streams: exact, fp32
tiny llama, 2 layers, pages of 8); the kill and preemption legs against a
single-engine control (exact); ``drain``, ``inflight_uids`` and
``ready_uids`` against the JAX engine on the same queue; and the
autoscaler's decision each pump equal to JAX's over the same stub fleets.
Nothing here reads a wall clock: the breaker's latency rule is fed
recorded step times."""

import importlib.util
import logging
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import RaggedRequest as JaxRequest
from deepspeed_tpu.models.llama import llama_model as jax_llama
from deepspeed_tpu.serving import AutoscaleConfig as JaxAutoscaleConfig
from deepspeed_tpu.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import autoscale as jauto
from deepspeed_tpu.serving import replica as jrep
from deepspeed_tpu.serving import router as jrouter
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, RaggedInferenceConfig,
                                              RaggedRequest)
from deepspeed_tpu_torch.models.llama import llama_model
from deepspeed_tpu_torch.serving import AutoscaleConfig, ServingConfig
from deepspeed_tpu_torch.serving import autoscale as tauto
from deepspeed_tpu_torch.serving import replica as trep
from deepspeed_tpu_torch.serving import router as trouter
from deepspeed_tpu_torch.serving.router import (affinity_key, build_fleet, hrw_score,
                                                pick_replica)

torch.set_num_threads(2)

CFG = dict(dtype="fp32", page_size=8, num_pages=64, max_seqs=4, max_pages_per_seq=12)


def _cand(name, load=0):
    return SimpleNamespace(name=name, load=lambda load=load: load)


def _prompt(n, seed=0, vocab=256):
    return list(map(int, np.random.RandomState(seed).randint(0, vocab, n)))


# ----------------------------- routing policy -------------------------------
def test_affinity_key_deterministic_and_prefix_grouped():
    ps = 8
    prompt = list(range(40))
    assert affinity_key(prompt, ps) == affinity_key(list(prompt), ps)
    other = prompt[:2 * ps] + [99] * 10
    assert affinity_key(prompt, ps, affinity_pages=2) == affinity_key(other, ps, affinity_pages=2)
    assert (affinity_key(prompt, ps, affinity_pages=2)
            != affinity_key([1] + prompt[1:], ps, affinity_pages=2))
    assert affinity_key([1, 2, 3], ps) == affinity_key([1, 2, 3], ps)
    assert affinity_key([1, 2, 3], ps) != affinity_key([1, 2, 4], ps)


def test_hrw_pick_deterministic_and_stable():
    key = affinity_key(list(range(16)), 8)
    cands = [_cand(n) for n in ("a", "b", "c")]
    first, via = pick_replica(key, cands, load_gap=4)
    assert via == "affinity"
    for _ in range(3):
        again, _ = pick_replica(key, list(reversed(cands)), load_gap=4)
        assert again.name == first.name
    losers = [c for c in cands if c.name != first.name]
    kept, _ = pick_replica(key, [c for c in cands if c is not losers[0]], load_gap=4)
    assert kept.name == first.name


def test_least_loaded_fallback_and_tie_break():
    key = affinity_key(list(range(16)), 8)
    hot = max(("a", "b", "c"), key=lambda n: (hrw_score(key, n), n))
    cold = sorted(n for n in ("a", "b", "c") if n != hot)
    cands = [_cand(hot, 4)] + [_cand(n, 1) for n in cold]
    assert pick_replica(key, cands, load_gap=4)[0].name == hot
    cands = [_cand(hot, 9)] + [_cand(n, 1) for n in cold]
    got, via = pick_replica(key, cands, load_gap=4)
    assert (got.name, via) == (cold[0], "least_loaded")


@pytest.mark.parametrize("n,pages,ps,seed", [(3, 4, 8, 0), (8, 4, 8, 1), (40, 2, 8, 2),
                                             (40, 4, 8, 3), (900, 4, 16, 4), (33, 1, 16, 5)])
def test_placement_equals_jax(n, pages, ps, seed):
    """The same prompt gives the same affinity bytes, the same rendezvous
    score per replica name and the same choice at every load (exact)."""
    prompt = _prompt(n, seed=seed, vocab=32000)
    key = affinity_key(prompt, ps, pages)
    assert key == jrouter.affinity_key(prompt, ps, pages)
    names = ["prefill0", "decode0", "decode1", "replica7", "auto0"]
    assert [hrw_score(key, m) for m in names] == [jrouter.hrw_score(key, m) for m in names]
    rng = np.random.RandomState(seed)
    for _ in range(8):
        loads = rng.randint(0, 10, len(names)).tolist()
        cands = [_cand(m, ld) for m, ld in zip(names, loads)]
        got, via = pick_replica(key, cands, 4)
        want, jvia = jrouter.pick_replica(key, cands, 4)
        assert (got.name, via) == (want.name, jvia)


# ----------------------------- config blocks --------------------------------
def test_serving_config_validation():
    cfg = ServingConfig.from_dict({"enabled": True, "prefill_replicas": 2, "decode_replicas": 3})
    assert (cfg.prefill_replicas, cfg.decode_replicas) == (2, 3)
    for bad in ({"enabled": True, "disaggregated": True, "prefill_replicas": 0},
                {"affinity_pages": 0}, {"prefill_replicas": 0, "decode_replicas": 0}):
        with pytest.raises(ValueError):
            ServingConfig.from_dict(bad)
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    ds = DeepSpeedConfig({"serving": {"enabled": True, "load_gap": 2}})
    assert ds.serving.enabled and ds.serving.load_gap == 2


BAD_BLOCKS = [
    {"enabled": True, "disaggregated": True, "prefill_replicas": 0},
    {"affinity_pages": 0}, {"prefill_replicas": 0, "decode_replicas": 0},
    {"load_gap": 0}, {"max_redispatch": -1}, {"drain_max_steps": 0},
    {"decode_horizon": 0}, {"max_queue_depth": -1}, {"shed_occupancy": 1.5},
    {"protect_priority": -1}, {"breaker_latency_factor": 1.0},
    {"breaker_consec_errors": 0}, {"breaker_window": 8, "breaker_min_samples": 64},
    {"breaker_window": 1}, {"breaker_min_latency_s": -1.0}, {"breaker_cooldown_pumps": 0},
    {"rebalance_load_gap": 0}, {"rebalance_p50_factor": 1.0},
    {"rebalance_enabled": True, "rebalance_p50_factor": 50.0},
    {"rebalance_max_per_pump": 0}, {"rebalance_min_deadline_s": -1.0},
    {"autoscale": {"min_replicas": 3, "max_replicas": 2}},
    {"autoscale": {"grow_queue_per_replica": 1.0, "shrink_queue_per_replica": 2.0}},
    {"autoscale": {"min_replicas": 0}}, {"autoscale": {"grow_streak": 0}},
    {"autoscale": {"cooldown_pumps": -1}}, {"transport": {"connect_retries": 0}},
    {"transport": {"backoff_jitter": -1.0}}, {"transport": {"io_timeout_s": 0}},
    {"transport": {"sender_depth": 0}}, {"transport": {"backoff_base_s": -1}},
    {"kv_tier": {"host_bytes": -1}}, {"speculative": {"mode": "nope"}}]


@pytest.mark.parametrize("block", BAD_BLOCKS)
def test_serving_block_refusals_equal_jax(block):
    """Each bad ``serving`` block raises ValueError in both packages with
    the same message."""
    with pytest.raises(ValueError) as want:
        JaxServingConfig.from_dict(block)
    with pytest.raises(ValueError) as got:
        ServingConfig.from_dict(block)
    assert str(got.value) == str(want.value)


def test_serving_block_defaults_equal_jax():
    block = {"enabled": True, "prefill_chunk": 256, "speculative": {"mode": "ngram", "k": 3},
             "kv_tier": {"enabled": True}, "autoscale": {"enabled": True, "max_replicas": 3},
             "transport": {"sender_depth": 4}, "decode_horizon": 4}
    want, got = JaxServingConfig.from_dict(block), ServingConfig.from_dict(block)
    for name in got.__dataclass_fields__:
        w, g = getattr(want, name), getattr(got, name)
        if hasattr(g, "__dataclass_fields__"):
            assert {k: getattr(g, k) for k in g.__dataclass_fields__} \
                == {k: getattr(w, k) for k in g.__dataclass_fields__}, name
        else:
            assert g == w, name


def test_rebalance_config_validation():
    with pytest.raises(ValueError):
        ServingConfig(rebalance_enabled=True, rebalance_max_per_pump=0).validate()
    with pytest.raises(ValueError, match="breaker_latency_factor"):
        ServingConfig(rebalance_enabled=True, breaker_enabled=True,
                      rebalance_p50_factor=50.0).validate()


def test_autoscale_config_validation():
    with pytest.raises(ValueError):
        AutoscaleConfig(min_replicas=3, max_replicas=2).validate()
    with pytest.raises(ValueError, match="hysteresis"):
        AutoscaleConfig(grow_queue_per_replica=1.0, shrink_queue_per_replica=2.0).validate()
    sc = ServingConfig(autoscale={"enabled": True, "max_replicas": 3})
    sc.validate()
    assert sc.autoscale.max_replicas == 3


# ----------------------------- stub fleets (both packages) ------------------
class _StubEngine:
    """Pure-python engine for routing-policy tests: holds decode-ready
    uids, moves them through the real ``migrate_sequence`` plumbing."""

    def __init__(self, uids=(), queue=0):
        self.block = SimpleNamespace(page_size=8)
        self.allocator = SimpleNamespace(free_pages=32, num_pages=64)
        self.queue_depth = queue
        self.uids = list(uids)
        self.imported = []
        self.released = []
        self.trace_owner = None

    @property
    def active_count(self):
        return len(self.uids)

    def has_work(self):
        return bool(self.uids) or self.queue_depth > 0

    def ready_uids(self):
        return list(self.uids)

    def export_sequence(self, uid):
        return SimpleNamespace(uid=uid, n_pages=2, trace=None)

    def import_sequence(self, bundle):
        self.uids.append(bundle.uid)
        self.imported.append(bundle.uid)
        return True

    def release_sequence(self, uid, reason=""):
        self.uids.remove(uid)
        self.released.append(uid)

    def abort_all(self, reason="abort"):
        out, self.uids = list(self.uids), []
        return out


PKG = {"port": (trouter, trep, tauto, ServingConfig, AutoscaleConfig),
       "jax": (jrouter, jrep, jauto, JaxServingConfig, JaxAutoscaleConfig)}


def _stub_fleet(*engines, config=None, pkg="port"):
    router, rep, _auto, serving_cfg, _a = PKG[pkg]
    reps = [rep.EngineReplica(f"s{i}", e, role=rep.ROLE_MIXED) for i, e in enumerate(engines)]
    return router.FleetRouter(reps, config or serving_cfg())


def test_rebalance_moves_bounded_load_off_hot_replica():
    cfg = ServingConfig(rebalance_enabled=True, rebalance_load_gap=4, rebalance_max_per_pump=2)
    hot, cold = _StubEngine(uids=[1, 2, 3, 4, 5, 6]), _StubEngine()
    router = _stub_fleet(hot, cold, config=cfg)
    router._rebalance_decode()
    assert cold.imported == [1, 2] and hot.released == [1, 2]
    assert sorted(hot.uids) == [3, 4, 5, 6]
    router._rebalance_decode()
    assert cold.imported == [1, 2]


def test_rebalance_skips_deadline_starved_streams():
    cfg = ServingConfig(rebalance_enabled=True, rebalance_load_gap=2, rebalance_max_per_pump=8,
                        rebalance_min_deadline_s=0.5)
    hot, cold = _StubEngine(uids=[1, 2, 3, 4]), _StubEngine()
    router = _stub_fleet(hot, cold, config=cfg)
    router._requests[2] = trouter._RequestRecord(
        RaggedRequest(prompt_ids=[1], uid=2, deadline_s=1e-9))
    router._rebalance_decode()
    assert 2 in hot.uids and 2 not in cold.imported
    assert sorted(cold.imported) == [1, 3, 4]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_rebalance_p50_signal_spots_warm_replica(pkg):
    """The latency rule relieves a warm replica at a lower threshold than
    the breaker's, on recorded step times (both packages alike)."""
    cfg = PKG[pkg][3](rebalance_enabled=True, rebalance_p50_factor=2.0, breaker_enabled=True)
    router = _stub_fleet(_StubEngine(uids=[1]), _StubEngine(uids=[2]), _StubEngine(uids=[3]),
                         config=cfg, pkg=pkg)
    reps = list(router.replicas.values())
    need = cfg.breaker_min_samples
    for r in reps:
        for _ in range(need):
            r._record_step(0.01, error=False)
    assert router._hot_decode_replica(reps) is None
    for _ in range(2 * need + 1):
        reps[1]._record_step(10 * cfg.breaker_min_latency_s, error=False)
    assert router._hot_decode_replica(reps) is reps[1]


def test_add_replica_checks_name_and_geometry():
    router = _stub_fleet(_StubEngine())
    router.add_replica(trep.EngineReplica("joined", _StubEngine()))
    assert set(router.replicas) == {"s0", "joined"}
    with pytest.raises(ValueError, match="already in"):
        router.add_replica(trep.EngineReplica("joined", _StubEngine()))
    wrong = _StubEngine()
    wrong.block.page_size = 16
    with pytest.raises(ValueError, match="one geometry"):
        router.add_replica(trep.EngineReplica("odd", wrong))


# ----------------------------- autoscaler: each pump's decision vs JAX ------
def _autoscaler(pkg, router, spawn=None, **kw):
    _r, _rep, auto, _s, acfg = PKG[pkg]
    kw.setdefault("enabled", True)
    return auto.FleetAutoscaler(router, acfg(**kw), spawn_replica=spawn)


def _grow_on_pressure(pkg):
    rep = PKG[pkg][1]
    router = _stub_fleet(_StubEngine(queue=9), pkg=pkg)
    spawned = []

    def spawn(i):
        spawned.append(i)
        return rep.EngineReplica(f"auto{i}", _StubEngine())

    a = _autoscaler(pkg, router, spawn, grow_queue_per_replica=4.0, grow_streak=2,
                    grow_on_ttft_violations=False, max_replicas=2, cooldown_pumps=3)
    decisions = [a.evaluate() for _ in range(12)]
    return decisions, spawned, sorted(router.replicas), list(a.grown)


def _grow_on_ttft(pkg):
    rep = PKG[pkg][1]
    registry = (__import__("deepspeed_tpu.telemetry", fromlist=["x"]) if pkg == "jax"
                else __import__("deepspeed_tpu_torch.telemetry", fromlist=["x"])).get_registry()
    router = _stub_fleet(_StubEngine(queue=1), pkg=pkg)
    a = _autoscaler(pkg, router, lambda i: rep.EngineReplica(f"auto{i}", _StubEngine()),
                    grow_queue_per_replica=100.0, grow_streak=99, max_replicas=2)
    decisions = [a.evaluate()]
    registry.counter("deepspeed_tpu_serving_slo_ttft_violations_total",
                     "ttft violations").inc(3)
    decisions.append(a.evaluate())
    return decisions, sorted(router.replicas)


def _shrink_lifo(pkg):
    rep = PKG[pkg][1]
    base, extra = _StubEngine(), _StubEngine(uids=[7, 8])
    router = _stub_fleet(base, pkg=pkg)
    router.add_replica(rep.EngineReplica("auto0", extra))
    a = _autoscaler(pkg, router, shrink_queue_per_replica=0.5, shrink_streak=2, min_replicas=1,
                    cooldown_pumps=0, grow_streak=99, grow_on_ttft_violations=False)
    a.grown = ["auto0"]
    decisions = [a.evaluate() for _ in range(10)]
    return (decisions, router.replicas["auto0"].retired, extra.uids, sorted(base.imported),
            list(a.grown), router.replicas["s0"].retired)


def _spawn_failure(pkg):
    router = _stub_fleet(_StubEngine(queue=50), pkg=pkg)

    def bad_spawn(i):
        raise RuntimeError("factory broke")

    a = _autoscaler(pkg, router, bad_spawn, grow_queue_per_replica=1.0, grow_streak=1,
                    max_replicas=4, cooldown_pumps=0)
    trail = []
    for _ in range(40):
        a.evaluate()
        trail.append((a._spawn_failures, a._spawn_backoff))
    return trail, len(router.replicas)


def test_autoscaler_grows_on_sustained_queue_pressure():
    decisions, spawned, names, grown = _grow_on_pressure("port")
    assert decisions[:2] == [None, "grow"] and spawned == [0]
    assert names == ["auto0", "s0"] and grown == ["auto0"]
    assert (decisions, spawned, names, grown) == _grow_on_pressure("jax")


def test_autoscaler_grows_on_new_ttft_violations():
    got = _grow_on_ttft("port")
    assert got == ([None, "grow"], ["auto0", "s0"])
    assert got == _grow_on_ttft("jax")


def test_autoscaler_shrinks_lifo_via_evacuation_never_drops():
    got = _shrink_lifo("port")
    decisions, retired, left, moved, grown, base_retired = got
    assert decisions[:2] == [None, "shrink"] and all(d is None for d in decisions[2:])
    assert retired and left == [] and moved == [7, 8] and grown == [] and not base_retired
    assert got == _shrink_lifo("jax")


def test_autoscaler_spawn_failure_backs_off_bounded():
    trail, n = _spawn_failure("port")
    fails = trail[-1][0]
    skips = sum(1 for f, b in trail if f and b)
    assert 0 < fails < 8 and skips > fails and n == 1
    assert (trail, n) == _spawn_failure("jax")


# ----------------------------- engines --------------------------------------
@pytest.fixture(scope="module")
def weights():
    jmodel = jax_llama("tiny", max_seq_len=128)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    return {"jax_model": jmodel, "jax": params,
            "numpy": jax.tree_util.tree_map(np.asarray, params),
            "model": llama_model("tiny", max_seq_len=128)}


def _port_engine(weights, **kw):
    return InferenceEngineV2(weights["model"], RaggedInferenceConfig(**dict(CFG, **kw)),
                             params=weights["numpy"], device="cpu")


def _jax_engine(weights, **kw):
    return JaxEngine(weights["jax_model"], JaxConfig(**dict(CFG, **kw)), params=weights["jax"])


def _control(weights, reqs, **kw):
    eng = _port_engine(weights, **kw)
    got = eng.generate_all([RaggedRequest(prompt_ids=list(r.prompt_ids),
                                          max_new_tokens=r.max_new_tokens) for r in reqs])
    eng.close()
    return [got[u] for u in sorted(got)]


def _traced_fleet(fleet):
    """Record every migration attempt (uid, source, destination, moved)."""
    log = []
    orig = fleet._try_migrate

    def traced(uid, src):
        before = {n: r.engine.ready_uids() if r.alive and not r.retired else []
                  for n, r in fleet.replicas.items()}
        ok = orig(uid, src)
        dst = next((n for n, r in fleet.replicas.items() if r is not src and r.alive
                    and not r.retired and uid in r.engine.ready_uids()
                    and uid not in before[n]), None)
        log.append((uid, src.name, dst, ok))
        return ok

    fleet._try_migrate = traced
    return log


def _run_fleet(fleet, reqs, max_steps=400):
    log = _traced_fleet(fleet)
    uids = [fleet.submit(r) for r in reqs]
    placed = [fleet.request_state(u)["replica"] for u in uids]
    for _ in range(max_steps):
        if not fleet.has_work():
            break
        fleet.step()
    return {"placed": placed, "migrations": log,
            "streams": [fleet.request_state(u)["emitted"] for u in uids],
            "decode_steps": {n: r.engine._decode_steps for n, r in fleet.replicas.items()}}


def _disagg_reqs(request_cls):
    shared = _prompt(16, seed=3)
    return [request_cls(prompt_ids=shared + _prompt(3 + i, seed=10 + i), max_new_tokens=6)
            for i in range(3)] + [
        request_cls(prompt_ids=_prompt(30 + i, seed=50 + i), max_new_tokens=6) for i in range(3)]


@pytest.fixture(scope="module")
def jax_disaggregated(weights):
    fleet = jrouter.build_fleet(
        weights["jax_model"], JaxServingConfig(enabled=True, prefill_replicas=1,
                                               decode_replicas=2, prefill_chunk=8),
        engine_config=JaxConfig(**dict(CFG, enable_prefix_cache=True)), params=weights["jax"])
    return _run_fleet(fleet, _disagg_reqs(JaxRequest))


def test_disaggregated_fleet_matches_single_engine_and_jax(weights, jax_disaggregated):
    """Both packages' ``build_fleet`` (1 prefill replica chunking at 8, 2
    decode replicas, prefix cache on) on the same weights: the same replica
    for each request, the same migrations, the same streams, and those
    streams the single engine's (exact, fp32)."""
    reqs = _disagg_reqs(RaggedRequest)
    fleet = build_fleet(weights["model"], ServingConfig(enabled=True, prefill_replicas=1,
                                                        decode_replicas=2, prefill_chunk=8),
                        engine_config=RaggedInferenceConfig(**dict(CFG, enable_prefix_cache=True)),
                        params=weights["numpy"], device="cpu")
    engines = [r.engine for r in fleet.replicas.values()]
    assert all(e.params is engines[0].params for e in engines)  # one tree
    got = _run_fleet(fleet, reqs)
    assert got["placed"] == jax_disaggregated["placed"]
    assert got["migrations"] == jax_disaggregated["migrations"]
    assert got["streams"] == jax_disaggregated["streams"]
    assert got["streams"] == _control(weights, reqs, enable_prefix_cache=True)
    assert got["decode_steps"] == jax_disaggregated["decode_steps"]
    assert got["decode_steps"]["decode0"] + got["decode_steps"]["decode1"] >= len(reqs)
    assert got["decode_steps"]["prefill0"] <= len(reqs)
    assert any(ok for *_x, ok in got["migrations"])
    for r in fleet.replicas.values():
        r.engine.assert_no_leaks()


def test_disaggregated_fleet_matches_single_engine(weights):
    """The JAX case at its size: 1 prefill + 1 decode replica."""
    base = dict(CFG, enable_prefix_cache=True)
    shared = _prompt(16, seed=3)
    reqs = [RaggedRequest(prompt_ids=shared + _prompt(3 + i, seed=10 + i), max_new_tokens=6)
            for i in range(3)]
    fleet = build_fleet(weights["model"], ServingConfig(enabled=True, prefill_replicas=1,
                                                        decode_replicas=1, prefill_chunk=8),
                        engine_config=RaggedInferenceConfig(**base), params=weights["numpy"],
                        device="cpu")
    got = fleet.run_all(reqs)
    assert [got[i] for i in range(3)] == _control(weights, reqs, **base)
    assert fleet.replicas["decode0"].engine._decode_steps >= 3
    assert fleet.replicas["prefill0"].engine._decode_steps <= len(reqs)


def _mid_stream(fleet, uids, new_tokens, prefix="decode"):
    for _ in range(80):
        fleet.step()
        states = [fleet.request_state(u) for u in uids]
        if any((s["replica"] or "").startswith(prefix) and 1 <= len(s["emitted"]) < new_tokens
               for s in states):
            return states
    raise AssertionError("no stream reached a decode replica mid-stream")


def _finish(fleet, uids):
    for _ in range(400):
        if not fleet.has_work():
            break
        fleet.step()
    assert not fleet.has_work()
    return [fleet.request_state(u) for u in uids]


def _lifecycle_fleet(weights, **serving):
    return build_fleet(weights["model"], ServingConfig(
        enabled=True, prefill_replicas=1, decode_replicas=2, prefill_chunk=8, **serving),
        engine_config=RaggedInferenceConfig(**dict(CFG, enable_prefix_cache=True)),
        params=weights["numpy"], device="cpu")


def test_redispatch_after_replica_death(weights):
    shared = _prompt(16, seed=4)
    reqs = [RaggedRequest(prompt_ids=shared + _prompt(3 + i, seed=20 + i), max_new_tokens=8)
            for i in range(3)]
    want = _control(weights, reqs, enable_prefix_cache=True)
    fleet = _lifecycle_fleet(weights)
    uids = [fleet.submit(r) for r in reqs]
    states = _mid_stream(fleet, uids, 8)
    victims = [s["replica"] for s in states if (s["replica"] or "").startswith("decode")]
    fleet.kill_replica(victims[0])
    states = _finish(fleet, uids)
    assert [s["emitted"] for s in states] == want
    assert any(s["redispatches"] >= 1 for s in states)
    assert not any(s["failed"] for s in states)


@pytest.mark.parametrize("leg", ["kill", "preempt"])
def test_kill_and_preemption_legs_match_the_control(weights, leg):
    """A decode replica killed mid-stream (its streams re-dispatched), or
    sent a preemption notice (its decode-ready streams migrate, the rest
    re-dispatch): every stream equals the single engine's (exact); no
    surviving engine leaks a page."""
    reqs = [RaggedRequest(prompt_ids=_prompt(12 + 5 * i, seed=60 + i), max_new_tokens=10)
            for i in range(6)]
    want = _control(weights, reqs, enable_prefix_cache=True)
    fleet = _lifecycle_fleet(weights)
    uids = [fleet.submit(r) for r in reqs]
    states = _mid_stream(fleet, uids, 10)
    victim = next(s["replica"] for s in states if (s["replica"] or "").startswith("decode"))
    owned = sum(1 for s in states if s["replica"] == victim)
    if leg == "kill":
        fleet.kill_replica(victim)
    else:
        fleet.replicas[victim].watcher.notify("maintenance")
    states = _finish(fleet, uids)
    assert [s["emitted"] for s in states] == want
    assert not any(s["failed"] for s in states)
    r = fleet.replicas[victim]
    assert r.retired
    if leg == "kill":
        assert sum(s["redispatches"] for s in states) >= 1
    else:
        assert r.alive and owned >= 1 and not r.engine.has_work()
        assert all(s["redispatches"] == 0 for s in states)  # migrated, not recomputed
    for name, rep in fleet.replicas.items():
        if rep.alive:
            rep.engine.assert_no_leaks()


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("breaker", ["smoke", "on"])
def test_smoke_fleet_fails_on_a_replica_step_error(weights, breaker):
    """``chip_smoke.py``'s fleet config turns the breaker off, so a decode
    replica whose step raises (a kernel that did not launch, a CUDA error)
    makes the smoke's ``serve_fleet`` raise that error.  With the breaker
    on, the router logs the same fault and recomputes the replica's
    streams elsewhere, and every stream still comes out whole: the reason
    the smoke turns it off."""
    smoke = _chip_smoke()
    serving = smoke.fleet_serving(1, 2)
    assert serving.breaker_enabled is False
    if breaker == "on":
        serving = ServingConfig(**dict(vars(serving), breaker_enabled=True))
    fleet = build_fleet(weights["model"], serving,
                        engine_config=RaggedInferenceConfig(**dict(CFG, enable_prefix_cache=True)),
                        params=weights["numpy"], device="cpu")

    def failed_launch():
        raise RuntimeError("CUDA error: unspecified launch failure")

    fleet.replicas["decode0"].engine.step = failed_launch
    reqs = [RaggedRequest(prompt_ids=_prompt(12 + 3 * i, seed=90 + i), max_new_tokens=6)
            for i in range(4)]
    if breaker == "smoke":
        with pytest.raises(RuntimeError, match="launch failure"):
            smoke.serve_fleet(fleet, reqs, 6)
        assert fleet.replicas["decode0"].step_errors == 1
    else:
        out = smoke.serve_fleet(fleet, reqs, 6)
        assert out["streams"] == _control(weights, reqs, enable_prefix_cache=True)
        assert fleet.replicas["decode0"].step_errors >= 1


def test_planned_retirement_spares_redispatch_budget(weights):
    reqs = [RaggedRequest(prompt_ids=_prompt(10 + i, seed=40 + i), max_new_tokens=4)
            for i in range(4)]
    want = _control(weights, reqs)
    fleet = build_fleet(weights["model"], ServingConfig(enabled=True, prefill_replicas=1,
                                                        decode_replicas=1, disaggregated=False,
                                                        max_redispatch=0),
                        engine_config=RaggedInferenceConfig(**CFG), params=weights["numpy"],
                        device="cpu")
    uids = [fleet.submit(r) for r in reqs]
    victim = next(fleet.request_state(u)["replica"] for u in uids)
    fleet.retire_replica(victim, migrate=False)
    states = _finish(fleet, uids)
    assert not any(s["failed"] for s in states)
    assert all(s["redispatches"] == 0 for s in states)
    assert [s["emitted"] for s in states] == want


def test_close_aborts_inflight_loudly(weights):
    from deepspeed_tpu_torch.utils.logging import logger as ds_logger

    eng = _port_engine(weights, enable_prefix_cache=True)
    eng.put(RaggedRequest(prompt_ids=_prompt(12), max_new_tokens=4))
    messages = []
    handler = logging.Handler()
    handler.emit = lambda rec: messages.append(rec.getMessage())
    ds_logger.addHandler(handler)
    try:
        eng.close()
    finally:
        ds_logger.removeHandler(handler)
    assert not eng.has_work()
    assert any("aborted 1 unfinished" in m for m in messages), messages


def _uid_views(eng, steps):
    """inflight and ready uids after each of ``steps`` steps, then the
    drain's finished states and pending uids."""
    views = []
    for _ in range(steps):
        eng.step()
        views.append((eng.inflight_uids(), eng.ready_uids()))
    res = eng.drain()
    fin = {int(u): (list(map(int, s.tokens)), s.done, s.generated)
           for u, s in res["finished"].items()}
    return views, fin, [s.uid for s in res["pending"]], eng.has_work()


def test_drain_inflight_and_ready_uids_equal_jax(weights):
    """Six requests on four slots, chunked at 8: the uids in flight and
    decode-ready after each step, then ``drain``'s finished states and
    handed-back queue, the same in both packages; afterwards both refuse
    a new request."""
    port, jeng = _port_engine(weights, prefill_chunk=8), _jax_engine(weights, prefill_chunk=8)
    for i in range(6):
        p = _prompt(10 + 3 * i, seed=30 + i)
        port.put(RaggedRequest(prompt_ids=p, max_new_tokens=4))
        jeng.put(JaxRequest(prompt_ids=p, max_new_tokens=4))
    assert port.inflight_uids() == jeng.inflight_uids() == list(range(6))
    got, want = _uid_views(port, 3), _uid_views(jeng, 3)
    assert got == want
    views, fin, pending, has_work = got
    assert any(ready for _i, ready in views) and pending and not has_work
    assert all(done and gen == 4 for _t, done, gen in fin.values())
    for eng, req in ((port, RaggedRequest), (jeng, JaxRequest)):
        with pytest.raises(RuntimeError, match="draining"):
            eng.put(req(prompt_ids=_prompt(8), max_new_tokens=2))


def test_engine_drain_finishes_inflight_and_returns_queued(weights):
    eng = _port_engine(weights)
    uids = [eng.put(RaggedRequest(prompt_ids=_prompt(10 + i, seed=30 + i), max_new_tokens=4))
            for i in range(6)]
    eng.step()
    result = eng.drain()
    finished, pending = result["finished"], result["pending"]
    assert len(finished) + len(pending) == 6
    assert all(s.done and s.generated == 4 for s in finished.values())
    assert all(s.generated == 0 for s in pending)
    assert not eng.has_work()
    with pytest.raises(RuntimeError):
        eng.put(RaggedRequest(prompt_ids=_prompt(8), max_new_tokens=2))
    assert set(finished) | {s.uid for s in pending} == set(uids)


def test_fleet_health_and_breaker_gauge_surface(weights):
    fleet = _lifecycle_fleet(weights)
    h = fleet.health()
    assert set(h) == {"prefill0", "decode0", "decode1"}
    assert all(v["breaker"] == "closed" and v["alive"] for v in h.values())
    assert h["decode0"]["kv_free_fraction"] == 1.0 and h["decode0"]["role"] == "decode"
