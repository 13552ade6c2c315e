"""The port's autotuner (``autotuning/autotuner.py``) and experiment
scheduler (``autotuning/scheduler.py``) against the JAX package's, on the
CPU.

* ``_candidates`` (grid, random, model), ``_param_count``,
  ``_estimate_state_bytes`` and ``_pruned_pool`` (the device memory passed
  in; the port's world size set to the JAX test mesh's 8 devices) equal;
* ``_featurize`` and ``_fit_predict`` (float64 numpy: the same operations)
  equal within 1e-9 relative;
* ``ResourceManager`` runs the same experiments to the same records under
  a deterministic runner, and ``SubprocessTrialRunner`` reads the same
  throughput from a small script;
* the port's ``tune`` on a tiny llama on the CPU: a failing candidate is
  recorded as ``None`` and the tuner goes on to pick among the rest."""

import json
import textwrap

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.autotuning import autotuner as jat
from deepspeed_tpu.autotuning import scheduler as jsch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.autotuning import autotuner as tat
from deepspeed_tpu_torch.autotuning import scheduler as tsch
from deepspeed_tpu_torch.models import llama as tllama

torch.set_num_threads(2)

SPACE = {"zero_stage": [0, 1, 2, 3], "micro_batch": [1, 2, 4], "fused_kernel": [False, True]}
BASE = {"optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "zero_optimization": {"stage": 1}, "train_batch_size": 8}


def _tuners(mode="grid", space=SPACE, max_trials=24):
    j = jat.Autotuner(lambda: jllama.llama_model("tiny", max_seq_len=32), BASE, lambda mb: None,
                      tuning_space=space, max_trials=max_trials, mode=mode)
    t = tat.Autotuner(lambda: tllama.llama_model("tiny", max_seq_len=32), BASE, lambda mb: None,
                      tuning_space=space, max_trials=max_trials, mode=mode, device="cpu",
                      world_size=len(jax.devices()))
    return j, t


@pytest.mark.parametrize("mode,max_trials", [("grid", 24), ("grid", 5), ("random", 7),
                                             ("model", 3)])
def test_candidates_and_trial_configs_match_jax(mode, max_trials):
    j, t = _tuners(mode, max_trials=max_trials)
    assert t._candidates() == j._candidates()
    for c in t._candidates():
        assert t._trial_config(c) == j._trial_config(c)


@pytest.mark.parametrize("hbm", [10**9, 500_000, 300_000, 1000])
def test_pruned_pool_matches_jax(hbm):
    j, t = _tuners()
    j._device_memory = lambda: hbm
    t._device_memory = lambda: hbm
    assert t._param_count() == j._param_count() > 0
    for c in t._candidates():
        assert t._estimate_state_bytes(c) == j._estimate_state_bytes(c)
    assert t._pruned_pool() == j._pruned_pool()
    assert t.results == j.results


def test_featurize_and_fit_predict_match_jax():
    j, t = _tuners("model")
    pool = t._candidates()
    rng = np.random.RandomState(0)
    tried = [(c, float(rng.rand() * 1e4)) for c in pool[:6]]
    for c in pool:
        np.testing.assert_array_equal(t._featurize(c), j._featurize(c))
    np.testing.assert_allclose(t._fit_predict(tried, pool[6:]), j._fit_predict(tried, pool[6:]),
                               rtol=1e-9)


def _runner(exp, res):
    cfg = exp["config"]
    if cfg.get("train_micro_batch_size_per_gpu") == 4 and cfg["zero_optimization"]["stage"] == 3:
        raise RuntimeError("out of memory")
    return 100.0 * cfg.get("train_micro_batch_size_per_gpu", 1) + cfg["zero_optimization"][
        "stage"]


@pytest.mark.parametrize("mode", ["grid", "random"])
def test_parallel_tuning_records_as_jax(mode):
    out = []
    for mod, tuner in zip((jsch, tsch), _tuners(mode, space={"zero_stage": [1, 3],
                                                            "micro_batch": [2, 4]})):
        res = tuner.tune_parallel(_runner, nodes=[mod.Node("a", 2), mod.Node("b", 1)],
                                  max_parallel=2)
        trials = sorted((json.dumps(r["config"], sort_keys=True), r["throughput"], r["error"])
                        for r in res["trials"])
        out.append((res["best"], res["throughput"], res["config"], trials))
    assert out[0] == out[1]


_TRIAL = textwrap.dedent("""
    import json, os, sys
    cfg = json.load(open(sys.argv[sys.argv.index("--exp_config") + 1]))
    print("noise")
    print(json.dumps({"throughput": cfg["train_micro_batch_size_per_gpu"] * 10.0 +
                      int(os.environ["DSTPU_TRIAL_SLOTS"])}))
""")


def test_subprocess_trial_runner_reads_what_jax_reads(tmp_path):
    script = tmp_path / "trial.py"
    script.write_text(_TRIAL)
    exp = {"name": "trial_0", "config": {"train_micro_batch_size_per_gpu": 4}}
    got = []
    for mod in (jsch, tsch):
        r = mod.SubprocessTrialRunner(str(script), results_dir=str(tmp_path / mod.__name__))
        got.append(r(exp, mod.Reservation(mod.Node("localhost", 2), 2)))
    assert got[0] == got[1] == 42.0


def test_tune_records_a_failed_trial_as_none_and_goes_on():
    ids = np.random.RandomState(0).randint(0, 256, (1, 4, 17))
    t = tat.Autotuner(lambda: tllama.llama_model("tiny", max_seq_len=32),
                      {"optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}},
                      lambda mb: ids[:, :mb], tuning_space={"zero_stage": [7, 1],
                                                            "micro_batch": [2]},
                      steps_per_trial=1, device="cpu")
    res = t.tune()
    assert [r["throughput"] is None for r in res["trials"]] == [True, False]
    assert res["best"] == {"zero_stage": 1, "micro_batch": 2} and res["throughput"] > 0
    assert t.engines_built == 1  # the bad stage fails in the config, before an engine


def test_all_failed_trials_raise():
    t = tat.Autotuner(lambda: tllama.llama_model("tiny", max_seq_len=32), {},
                      lambda mb: None, tuning_space={"zero_stage": [7]}, device="cpu")
    with pytest.raises(RuntimeError, match="all autotuning trials failed"):
        t.tune()
