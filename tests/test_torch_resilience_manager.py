"""Preemption, emergency save and auto-resume of the port's training engine
(``resilience.ResilienceManager``, ``resilience/preemption.py``, the
``resilience`` config block) against the JAX package's, on the CPU, with
a tiny llama in fp32:

* a preemption notice (``chaos.simulate_preemption``) before step 3 gives
  the same emergency tag and exit code (75) in both packages;
* a fresh engine auto-resumes from it and continues bit-equal to an
  unbroken run, and counts the restore (goodput's ``restart`` > 0);
* ``keep_n`` collects the same tags; ``io_retries`` outlasts two injected
  I/O failures;
* a tag emergency-saved by either package auto-resumes into the other,
  whose losses then match the saving package's own continuation within
  the fp32 tolerance of ``test_torch_engine.py`` (1e-5 relative: the same
  formulas summed in another order);
* the watcher restores the signal handlers it replaced, and a real
  SIGTERM delivered while its handler is installed becomes a request.
"""

import json
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.telemetry.flight as jflight
import deepspeed_tpu.telemetry.goodput as jgood
import deepspeed_tpu.telemetry.numerics as jnum
import deepspeed_tpu_torch
import deepspeed_tpu_torch.telemetry.flight as tflight
import deepspeed_tpu_torch.telemetry.goodput as tgood
import deepspeed_tpu_torch.telemetry.numerics as tnum
from deepspeed_tpu import resilience as jres
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch import resilience as tres
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.convert import params_to_numpy
from deepspeed_tpu_torch.resilience import chaos as tchaos
from deepspeed_tpu_torch.resilience.commit import list_tags

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def no_process_defaults():
    yield
    for fl, gp, nm in ((jflight, jgood, jnum), (tflight, tgood, tnum)):
        fl.install_flight_recorder(None)
        gp.set_goodput_ledger(None)
        nm.set_numerics_ledger(None)
    tchaos.install_io_fault(None)


def _ds(save_dir, flight_dir=None, **res):
    ds = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
          "gradient_clipping": 1.0, "zero_optimization": {"stage": 1},
          "resilience": {"enabled": True, "save_dir": str(save_dir), "keep_n": 2,
                         "watch_signals": False, **res}}
    if flight_dir is not None:
        ds["telemetry"] = {"enabled": True, "numerics": {"enabled": True},
                           "flight_recorder": {"path": str(flight_dir)}}
    return ds


def _tree():
    cfg = jllama.llama_config("tiny", max_seq_len=32)
    return jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        cfg, jax.random.PRNGKey(0)))


def _engine(pkg, ds, tree):
    if pkg is deepspeed_tpu:
        e, *_ = pkg.initialize(model=jllama.llama_model("tiny", max_seq_len=32),
                               config=json.loads(json.dumps(ds)),
                               model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    else:
        e, *_ = pkg.initialize(model=tllama.llama_model("tiny", max_seq_len=32),
                               config=json.loads(json.dumps(ds)), model_parameters=tree,
                               device="cpu")
    return e


def _batches(n=6):
    rng = np.random.RandomState(1)
    return [rng.randint(0, 256, (1, 2, 17)) for _ in range(n)]


def _preempt(pkg, res_mod, ds, tree, batches, at=3):
    """Run until a notice delivered before step ``at`` interrupts it."""
    e = _engine(pkg, ds, tree)
    losses = []
    for i, b in enumerate(batches):
        if i == at - 1:
            res_mod.chaos.simulate_preemption(e.resilience)
        try:
            losses.append(float(e.train_batch(jnp.asarray(b) if pkg is deepspeed_tpu else b)))
        except res_mod.PreemptionInterrupt as exc:
            e.close()
            return e, losses, res_mod.exit_code_for_exception(exc)
    raise AssertionError("no preemption")


def test_preemption_gives_the_same_tag_and_exit_code(tmp_path):
    tree, batches = _tree(), _batches()
    seen = []
    for pkg, res_mod in ((deepspeed_tpu, jres), (deepspeed_tpu_torch, tres)):
        d = tmp_path / pkg.__name__
        e, losses, code = _preempt(pkg, res_mod, _ds(d, d / "flight"), tree, batches)
        seen.append((code, list_tags(str(d)), len(losses), e.global_steps))
        notes = [json.loads(line) for p in sorted((d / "flight").glob("*.jsonl"))
                 for line in open(p)]
        assert any(n.get("name") == "preemption_exit" for n in notes)
    assert seen[0] == seen[1] == (75, ["emergency_step3"], 2, 3)


def test_auto_resume_continues_bit_equal_to_the_unbroken_run(tmp_path):
    tree, batches = _tree(), _batches()
    unbroken = _engine(deepspeed_tpu_torch, _ds(tmp_path / "u", auto_resume=False), tree)
    want = [float(unbroken.train_batch(b)) for b in batches]
    d = tmp_path / "p"
    e, losses, code = _preempt(deepspeed_tpu_torch, tres, _ds(d, tmp_path / "f1"), tree,
                               batches)
    assert code == tres.EXIT_RESUMABLE and losses == want[:2]
    restores = tres.metrics.restores_total().total()
    resumed = _engine(deepspeed_tpu_torch, _ds(d, tmp_path / "f2"), tree)
    assert resumed.global_steps == 3
    assert tres.metrics.restores_total().total() == restores + 1
    assert resumed.goodput_summary()["buckets"]["restart"] > 0
    # the numerics sentinel's window came back with the tag (the boundary
    # at step 2), and goes on from there
    assert resumed.numerics_report()["boundaries"] == 1
    got = [float(resumed.train_batch(b)) for b in batches[3:]]
    assert got == want[3:]
    ga = jax.tree_util.tree_leaves(params_to_numpy(resumed.get_params()))
    gb = jax.tree_util.tree_leaves(params_to_numpy(unbroken.get_params()))
    assert all(np.array_equal(x, y) for x, y in zip(ga, gb))
    assert resumed.numerics_report()["boundaries"] == 3
    resumed.close()
    unbroken.close()


def test_keep_n_collects_the_same_tags(tmp_path):
    tree, batches = _tree(), _batches(5)
    tags = []
    for pkg in (deepspeed_tpu, deepspeed_tpu_torch):
        d = tmp_path / pkg.__name__
        e = _engine(pkg, _ds(d, auto_resume=False), tree)
        for b in batches:
            e.train_batch(jnp.asarray(b) if pkg is deepspeed_tpu else b)
            e.save_checkpoint(str(d))
        e.close()
        tags.append(sorted(list_tags(str(d))))
    assert tags[0] == tags[1] == ["global_step4", "global_step5"]


def test_io_retries_outlast_flaky_io(tmp_path):
    e = _engine(deepspeed_tpu_torch, _ds(tmp_path, auto_resume=False, io_retries=3,
                                         io_retry_base_s=0.0), _tree())
    e.train_batch(_batches(1)[0])
    before = tres.metrics.io_retries_total().total()
    flaky = tchaos.FlakyIO(fail_ops=2)
    tchaos.install_io_fault(flaky)
    path = e.save_checkpoint(str(tmp_path), tag="flaky")
    tchaos.install_io_fault(None)
    assert flaky.remaining == 0 and tres.verify_tag(str(tmp_path), "flaky")["ok"]
    assert tres.metrics.io_retries_total().total() == before + 2
    assert path.endswith("flaky")
    e.close()


@pytest.mark.parametrize("saver,loader", [(deepspeed_tpu, deepspeed_tpu_torch),
                                          (deepspeed_tpu_torch, deepspeed_tpu)],
                         ids=["jax_to_port", "port_to_jax"])
def test_emergency_tag_resumes_in_the_other_package(saver, loader, tmp_path):
    tree, batches = _tree(), _batches()
    res_of = {deepspeed_tpu: jres, deepspeed_tpu_torch: tres}
    d = tmp_path / "ckpt"
    e, _, code = _preempt(saver, res_of[saver], _ds(d), tree, batches)
    assert code == 75
    # the saver's own continuation from its tag, and the other package's
    cont = {}
    for pkg in (saver, loader):
        r = _engine(pkg, _ds(d, keep_n=5), tree)
        assert r.global_steps == 3
        cont[pkg] = [float(r.train_batch(jnp.asarray(b) if pkg is deepspeed_tpu else b))
                     for b in batches[3:]]
        r.close()
    for a, b in zip(cont[saver], cont[loader]):
        assert abs(a - b) <= 1e-5 * abs(a), (cont[saver], cont[loader])


def test_gray_failure_injectors_as_in_jax():
    """FlakyStep's deterministic and seeded failures, SlowReplica's seeded
    delays and the kill point's no-op path match the JAX package's;
    PoolSqueeze holds truly free pages of the port's allocator and gives
    them back."""
    from deepspeed_tpu_torch.inference.v2.ragged import BlockAllocator

    seen = []
    for chaos in (jres.chaos, tchaos):
        flaky = chaos.FlakyStep(fail_steps=2, p=0.3, seed=5)
        raised = []
        for _ in range(12):
            try:
                flaky()
                raised.append(False)
            except chaos.ChaosStepError:
                raised.append(True)
        slow = chaos.SlowReplica(delay_s=0.0, jitter_s=1e-4, seed=3)
        for _ in range(3):
            slow()
        chaos.kill_point(3, None)
        chaos.kill_point(3, 4)
        seen.append((raised, flaky.raised, slow.calls, slow._rng.random()))
    assert seen[0] == seen[1] and seen[0][0][:2] == [True, True]
    alloc = BlockAllocator(num_pages=9)
    engine = type("E", (), {"allocator": alloc})()
    free = alloc.uncached_free_pages
    with tchaos.PoolSqueeze(engine, 5) as sq:
        assert sq.pages == 5 and alloc.uncached_free_pages == free - 5
    assert alloc.uncached_free_pages == free


def test_watcher_restores_the_handlers_it_replaced():
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    w = tres.PreemptionWatcher(install_signals=True)
    try:
        installed = signal.getsignal(signal.SIGTERM)
        if installed == w._on_signal:  # only with our handler in place
            signal.raise_signal(signal.SIGTERM)
            assert w.requested == "signal:SIGTERM"
        else:  # not on the main thread: nothing installed, notify() works
            w.notify("test")
            assert w.requested == "test"
    finally:
        w.uninstall()
    assert {s: signal.getsignal(s) for s in before} == before
    w.clear()
    assert w.requested is None
    # the engine's close() uninstalls its watcher too
    e = _engine(deepspeed_tpu_torch, {"train_micro_batch_size_per_gpu": 2,
                                      "resilience": {"enabled": True, "auto_resume": False,
                                                     "emergency_save": False}}, _tree())
    e.close()
    assert {s: signal.getsignal(s) for s in before} == before
    assert jres.EXIT_RESUMABLE == tres.EXIT_RESUMABLE == 75
    for exc in (SystemExit(None), SystemExit("x"), ValueError(), RuntimeError(),
                tres.PreemptionInterrupt()):
        assert tres.exit_code_for_exception(exc) == jres.exit_code_for_exception(exc)
