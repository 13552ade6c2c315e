"""The port's monitors (``monitor/monitor.py``), the training engine's
monitor hooks and ``InferenceEngineV2.publish_metrics`` against the JAX
package's, on the CPU.

* ``MonitorMaster``'s CSV files are byte-equal to the JAX package's on the
  same events and on the same registry snapshot; wandb and comet, absent
  here, warn and write nothing in both; TensorBoard writes an event file
  where ``torch.utils.tensorboard`` imports;
* a monitored tiny llama (2 layers, fp32, csv_monitor with telemetry on)
  writes the JAX engine's ``Train/Samples`` tags, the loss within 1e-5
  relative (the engines' own fp32 tolerance, ``test_torch_engine.py``)
  and the learning rate within 1e-6 (the schedules' fp32 formulas,
  ``test_torch_runtime.py``), and the same training-registry tags at
  the ``steps_per_print`` boundaries (but the gradient exchange's, which
  the JAX engine publishes on its 8-device test mesh);
* ``publish_metrics`` writes the JAX engine's ``serving/*`` events, values
  equal, on the same traffic."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.monitor import monitor as jmon
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.telemetry import registry as jreg
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.monitor import monitor as tmon
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.telemetry import registry as treg

torch.set_num_threads(2)

EVENTS = [("Train/Samples/train_loss", 2.5, 1), ("Train/Samples/lr", 1e-4, 1),
          ("Train/Samples/train_loss", 2.25, 2), ("weird=tag/x", 3, 2)]


def _read_dir(d):
    return {f: open(os.path.join(d, f)).read() for f in sorted(os.listdir(d))}


def _registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("deepspeed_tpu_demo_total", "a counter", labelnames=("kind",)).inc(3, kind="a")
    reg.gauge("deepspeed_tpu_demo_gauge", "a gauge").set(1.5)
    h = reg.histogram("deepspeed_tpu_demo_seconds", "a histogram")
    for v in (0.1, 0.2, 0.4, 3.0):
        h.observe(v)
    return reg


def test_csv_files_match_jax(tmp_path):
    for tag, cfgmod, mon, reg in (("jax", jconfig, jmon, jreg), ("torch", tconfig, tmon, treg)):
        cfg = cfgmod.DeepSpeedConfig({"csv_monitor": {"enabled": True,
                                                      "output_path": str(tmp_path / tag),
                                                      "job_name": "job"}})
        m = mon.MonitorMaster(cfg)
        assert m.enabled
        m.write_events(EVENTS)
        m.write_registry(_registry(reg), 7)
        m.close()
        m.close()  # twice is safe
    jfiles, tfiles = _read_dir(tmp_path / "jax" / "job"), _read_dir(tmp_path / "torch" / "job")
    assert tfiles == jfiles and len(tfiles) >= 8


def test_missing_writers_warn_and_write_nothing(tmp_path):
    blocks = {"wandb": {"enabled": True}, "comet": {"enabled": True}}
    jm = jmon.MonitorMaster(jconfig.DeepSpeedConfig(dict(blocks)))
    tm = tmon.MonitorMaster(tconfig.DeepSpeedConfig(dict(blocks)))
    assert len(tm.monitors) == len(jm.monitors)
    assert tm.enabled == bool(tm.monitors)
    tm.write_events(EVENTS)


def test_tensorboard_writes_an_event_file(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    cfg = tconfig.DeepSpeedConfig({"tensorboard": {"enabled": True, "output_path": str(tmp_path),
                                                   "job_name": "tb"}})
    m = tmon.MonitorMaster(cfg)
    assert [type(x).__name__ for x in m.monitors] == ["TensorBoardMonitor"]
    m.write_events(EVENTS)
    m.close()
    files = os.listdir(tmp_path / "tb")
    assert files and all(os.path.getsize(tmp_path / "tb" / f) > 0 for f in files)


def test_a_non_zero_rank_holds_no_writer(tmp_path, monkeypatch):
    monkeypatch.setenv("RANK", "1")
    cfg = tconfig.DeepSpeedConfig({"csv_monitor": {"enabled": True,
                                                   "output_path": str(tmp_path)}})
    assert tmon.MonitorMaster(cfg).monitors == []


def _cfg(path):
    return {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 3,
                                                         "warmup_max_lr": 1e-3}},
            "gradient_clipping": 1.0,
            "telemetry": {"enabled": True, "stall_watchdog": {"enabled": False}},
            "csv_monitor": {"enabled": True, "output_path": str(path), "job_name": "run"}}


def _rows(path):
    with open(path) as f:
        return [(int(r[0]), float(r[1])) for r in list(csv.reader(f))[1:]]


def test_monitored_engines_write_the_same_tags_and_values(tmp_path, monkeypatch):
    # each engine publishes to its package's process registry: a fresh one
    # each, so no series an earlier test left in this process is written;
    # the process memory ledgers made under them go with them, so no later
    # test finds a ledger bound to a registry no longer the process's
    from deepspeed_tpu.telemetry import memory as jmem
    from deepspeed_tpu_torch.telemetry import memory as tmem

    for reg, mem in ((jreg, jmem), (treg, tmem)):
        monkeypatch.setattr(reg, "_default_registry", reg.MetricsRegistry())
        monkeypatch.setattr(mem, "_default_ledger", None)
    cfg = jllama.llama_config("tiny", max_seq_len=32)
    tree = jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        cfg, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(3)
    batches = [rng.randint(0, 256, (1, 2, 17)) for _ in range(4)]
    je, *_ = deepspeed_tpu.initialize(model=jllama.llama_model("tiny", max_seq_len=32),
                                      config=_cfg(tmp_path / "jax"),
                                      model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    te, *_ = deepspeed_tpu_torch.initialize(model=tllama.llama_model("tiny", max_seq_len=32),
                                            config=_cfg(tmp_path / "torch"),
                                            model_parameters=tree, device="cpu")
    for b in batches:
        je.train_batch(jnp.asarray(b))
        te.train_batch(b)
    je.close()
    te.close()
    jd, td = tmp_path / "jax" / "run", tmp_path / "torch" / "run"
    jl, tl = _rows(jd / "Train_Samples_train_loss.csv"), _rows(td / "Train_Samples_train_loss.csv")
    assert [s for s, _ in tl] == [s for s, _ in jl] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in tl], [v for _, v in jl], rtol=1e-5)
    jlr, tlr = _rows(jd / "Train_Samples_lr.csv"), _rows(td / "Train_Samples_lr.csv")
    assert [s for s, _ in tlr] == [s for s, _ in jlr]
    # the schedule's fp32 formulas round an ulp apart (test_torch_runtime.py)
    np.testing.assert_allclose([v for _, v in tlr], [v for _, v in jlr], rtol=1e-6)
    train = lambda d: {f for f in os.listdir(d) if f.startswith("deepspeed_tpu_train_")}  # noqa
    # the JAX engine runs on the test mesh's data axis of 8 and publishes its
    # gradient exchange's overlap; the port's one rank has no exchange
    exchange = {f"deepspeed_tpu_train_{n}.csv" for n in (
        "exposed_collective_seconds", "exposed_collective_seconds_estimated",
        "overlapped_fraction")}
    assert train(td) == train(jd) - exchange and train(td)
    steps = {s for s, _ in _rows(td / "deepspeed_tpu_train_loss.csv")}
    assert steps == {2, 4}  # written at the steps_per_print boundaries


def test_publish_metrics_writes_the_jax_serving_events():
    from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
    from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxConfig
    from deepspeed_tpu.inference.v2 import RaggedRequest as JaxRequest
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, RaggedInferenceConfig,
                                                  RaggedRequest)

    kw = dict(dtype="fp32", page_size=8, num_pages=64, max_seqs=2, max_pages_per_seq=10,
              enable_prefix_cache=True)
    jmodel = jllama.llama_model("tiny", max_seq_len=256)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    prompt = list(map(int, np.random.RandomState(0).randint(0, 256, 20)))
    jeng = JaxEngine(jmodel, JaxConfig(**kw), params=params)
    teng = InferenceEngineV2(tllama.llama_model("tiny", max_seq_len=256),
                             RaggedInferenceConfig.from_dict(kw),
                             params=jax.tree_util.tree_map(np.asarray, params), device="cpu")
    got = []

    class Rec:
        def __init__(self):
            self.events = []

        def write_events(self, events):
            self.events.extend(events)

    for eng, req in ((jeng, JaxRequest), (teng, RaggedRequest)):
        for _ in range(2):  # the repeat hits the cache
            eng.generate_all([req(prompt_ids=prompt, max_new_tokens=3)])
        rec = Rec()
        eng.publish_metrics(rec, 5)
        got.append(rec.events)
    assert got[1] == got[0] and any(v > 0 for t, v, _ in got[1] if t == "serving/cache_hits")
