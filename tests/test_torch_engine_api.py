"""The single-card API the port took in with the JAX package's names: the
engine's ``no_sync``, batch-size setters, ``stack_microbatches`` and
profiler trace; ``add_config_arguments``, ``log_dist``,
``DeepSpeedConfig.print_config``, ``get_scalar_param``,
``precision.nonfinite_count``, ``ModelSpec.from_functions``,
``SuperOffloadOptimizer.apply_step`` and ``PinnedBufferPool``, each
against the JAX package where both have it.

Tolerances: the engines' losses 1e-5 relative in fp32 (the engine-parity
tolerance of ``test_torch_engine.py``: the same formulas summed in another
order); counts, texts, arguments and keys exactly."""

import argparse
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime import config_utils as jcu
from deepspeed_tpu.runtime import precision as jprec
from deepspeed_tpu.utils import logging as jlogging
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.ops.cpu.aio import PinnedBufferPool, default_aio_handle
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import config_utils as tcu
from deepspeed_tpu_torch.runtime import precision as tprec
from deepspeed_tpu_torch.runtime.module import ModelSpec
from deepspeed_tpu_torch.utils import logging as tlogging

torch.set_num_threads(2)

MICRO = 2


def _ds(stage=1, **extra):
    ds = {"train_micro_batch_size_per_gpu": MICRO, "gradient_accumulation_steps": 1,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
          "gradient_clipping": 1.0, "zero_optimization": {"stage": stage}}
    ds.update(extra)
    return ds


def _tree():
    cfg = jllama.llama_config("tiny", max_seq_len=32)
    return jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        cfg, jax.random.PRNGKey(0)))


def _port(ds, tree=None, **kw):
    return deepspeed_tpu_torch.initialize(model=tllama.llama_model("tiny", max_seq_len=32),
                                          config=dict(ds), model_parameters=tree,
                                          device="cpu", **kw)[0]


def test_no_sync_and_batch_size_setters():
    """``tests/unit/test_engine.py::test_no_sync_and_batch_size_setters`` on
    the port."""
    engine = _port(_ds(1))
    rng = np.random.RandomState(0)
    with engine.no_sync():
        engine.train_batch(rng.randint(0, 256, (1, MICRO, 17)))
    e2 = _port(_ds(2))
    with pytest.raises(AssertionError):
        e2.no_sync()
    engine.set_train_batch_size(MICRO * 2)
    assert engine.gradient_accumulation_steps() == 2 and engine.train_batch_size() == 2 * MICRO
    engine.train_batch(rng.randint(0, 256, (2, MICRO, 17)))
    with pytest.raises(ValueError):
        engine.set_train_batch_size(MICRO * 2 + 1)


def test_a_step_inside_no_sync_is_the_step_outside_it():
    tree = _tree()
    a, b = _port(_ds(1), tree), _port(_ds(1), tree)
    ids = np.random.RandomState(1).randint(0, 256, (1, MICRO, 17))
    la = a.train_batch(ids)
    with b.no_sync():
        lb = b.train_batch(ids)
    assert torch.equal(la, lb)
    for x, y in zip(a._master, b._master):
        assert torch.equal(x, y)


@pytest.mark.parametrize("setter", ["train_batch_size", "micro_batch_size"])
def test_losses_after_a_batch_size_change_match_jax(setter):
    tree = _tree()
    ds = _ds(1)
    je = deepspeed_tpu.initialize(model=jllama.llama_model("tiny", max_seq_len=32),
                                  config=dict(ds),
                                  model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))[0]
    te = _port(ds, tree)
    rng = np.random.RandomState(2)
    shape = (1, MICRO, 17)
    for step in range(4):
        if step == 2:
            # the JAX engine's batch counts its data-parallel ranks
            # (the CPU mesh's); the port trains on one
            for e, dp in ((je, je.topology.dp_world_size), (te, 1)):
                if setter == "train_batch_size":
                    e.set_train_batch_size(2 * MICRO * dp)
                else:
                    e.set_train_micro_batch_size(2 * MICRO)
            shape = (2, MICRO, 17) if setter == "train_batch_size" else (1, 2 * MICRO, 17)
            assert te.gradient_accumulation_steps() == je.gradient_accumulation_steps()
            assert te.train_micro_batch_size_per_gpu() == je.train_micro_batch_size_per_gpu()
            assert te.train_batch_size() * je.topology.dp_world_size == je.train_batch_size()
        ids = rng.randint(0, 256, shape)
        lj = float(je.train_batch(jnp.asarray(ids, jnp.int32)))
        lt = float(te.train_batch(ids))
        assert abs(lt - lj) <= 1e-5 * abs(lj), (step, lt, lj)


def test_per_step_counts_follow_the_new_sizes():
    """Throughput's samples a step, MFU's FLOPs a step, the memory ledger's
    hints and the training dataloader read the new sizes."""
    data = [np.random.RandomState(i).randint(0, 256, (17,)) for i in range(16)]
    e = _port(_ds(1, telemetry={"enabled": True}), training_data=data)
    try:
        batch = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, MICRO, 17)))
        flops = e._model_flops_per_step(batch)
        assert flops > 0
        e.set_train_batch_size(2 * MICRO)
        assert e.tput_timer.batch_size == 2 * MICRO
        assert e._model_flops_per_step(torch.cat([batch, batch])) == 2 * flops
        assert e.telemetry.ledger.context["gas"] == 2
        e.set_train_micro_batch_size(4)
        assert e.training_dataloader.batch_size == 4 and e.train_batch_size() == 8
        assert e.telemetry.ledger.context["micro_batch"] == 4
        e.train_batch()  # two micro-batches of 4 drawn from the loader
        assert e.global_steps == 1
    finally:
        e.close()


def test_stack_microbatches_method_and_profiler_trace(tmp_path):
    e = _port(_ds(1))
    micro = [np.random.RandomState(i).randint(0, 256, (MICRO, 17)) for i in range(2)]
    stacked = e.stack_microbatches(micro)
    assert stacked.shape == (2, MICRO, 17)
    e.start_profiler_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="already running"):
        e.start_profiler_trace(str(tmp_path / "second"))
    e.train_batch(stacked[:1])
    path = e.stop_profiler_trace()
    assert path.startswith(str(tmp_path)) and (tmp_path / path.split("/")[-1]).stat().st_size
    with pytest.raises(RuntimeError, match="no trace"):
        e.stop_profiler_trace()


def test_add_config_arguments_matches_jax():
    pj = deepspeed_tpu.add_config_arguments(argparse.ArgumentParser())
    pt = deepspeed_tpu_torch.add_config_arguments(argparse.ArgumentParser())
    for argv in ([], ["--deepspeed", "--deepspeed_config", "ds.json", "--local_rank", "3"]):
        assert vars(pt.parse_args(argv)) == vars(pj.parse_args(argv))
    assert [a.dest for a in pt._actions] == [a.dest for a in pj._actions]
    assert deepspeed_tpu_torch.get_accelerator() is not None


@pytest.fixture
def both_logs(caplog):
    for lg in (jlogging.logger, tlogging.logger):
        lg.addHandler(caplog.handler)
    caplog.set_level(logging.INFO)
    yield caplog
    for lg in (jlogging.logger, tlogging.logger):
        lg.removeHandler(caplog.handler)


def _messages(caplog, lg):
    return [(r.levelno, r.getMessage()) for r in caplog.records if r.name == lg.name]


@pytest.mark.parametrize("ranks", [None, [0], [1], [-1], [2, 0]])
def test_log_dist_matches_jax(both_logs, ranks):
    jlogging.log_dist("hello", ranks=ranks, level=logging.WARNING)
    tlogging.log_dist("hello", ranks=ranks, level=logging.WARNING)
    got = _messages(both_logs, tlogging.logger)
    assert got == _messages(both_logs, jlogging.logger)
    assert got == ([] if ranks == [1] else [(logging.WARNING, "[Rank 0] hello")])


def test_print_config_matches_jax(both_logs):
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 3,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "bf16": {"enabled": True}, "zero_optimization": {"stage": 1},
           "steps_per_print": 7}
    jconfig.DeepSpeedConfig(cfg).print_config()
    tconfig.DeepSpeedConfig(cfg).print_config()
    got = _messages(both_logs, tlogging.logger)
    assert got and got == _messages(both_logs, jlogging.logger)


def test_get_scalar_param_matches_jax():
    d = {"a": 1, "b": None}
    for name, default in (("a", 5), ("b", 5), ("c", 5), ("c", None)):
        assert tcu.get_scalar_param(d, name, default) == jcu.get_scalar_param(d, name, default)


def test_nonfinite_count_matches_jax():
    r = np.random.RandomState(0)
    a = r.randn(4, 5).astype(np.float32)
    a[0, 1], a[2, 3], a[3, 0] = np.inf, np.nan, -np.inf
    b = r.randn(7).astype(np.float32)
    b[4] = np.nan
    c = np.ones(3, np.float32)
    tree = {"x": a, "y": [b, {"z": c}]}
    want = jprec.nonfinite_count(jax.tree_util.tree_map(jnp.asarray, tree))
    t = {"x": torch.from_numpy(a), "y": [torch.from_numpy(b), {"z": torch.from_numpy(c)}]}
    got = tprec.nonfinite_count(t)
    assert got.dtype == torch.int32 and got.dim() == 0 and int(got) == int(want) == 4
    bf = {"x": torch.from_numpy(a).bfloat16()}
    assert int(tprec.nonfinite_count(bf)) == 3
    assert int(tprec.nonfinite_count({})) == int(jprec.nonfinite_count({})) == 0


def test_model_spec_from_functions():
    model = tllama.llama_model("tiny", max_seq_len=32)
    spec = ModelSpec.from_functions(model.init_params, model.loss_fn, apply_fn=model.apply_fn,
                                    config=model.config)
    e = deepspeed_tpu_torch.initialize(model=spec, config=_ds(1), device="cpu", seed=0)[0]
    assert np.isfinite(float(e.train_batch(np.zeros((1, MICRO, 17), np.int64))))
    with pytest.raises(NotImplementedError, match="#8"):
        ModelSpec.from_functions(model.init_params, model.loss_fn, partition_rules=[("x", None)])


def test_superoffload_apply_step_is_the_step_path():
    """``apply_step`` scales, clips and updates every leaf through the
    worker pool's ``step_leaves``, as the engine's boundary does."""
    from deepspeed_tpu_torch.runtime.superoffload.superoffload import SuperOffloadOptimizer
    from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadedOptimizer

    shapes = [(8, 4), (16,)]
    init = [np.random.RandomState(i).randn(*s).astype(np.float32) for i, s in enumerate(shapes)]
    grads = [np.random.RandomState(10 + i).randn(*s).astype(np.float32)
             for i, s in enumerate(shapes)]
    cfg = {"type": "AdamW", "params": {"lr": 1e-3}}
    outs = []
    for cls, kw in ((SuperOffloadOptimizer, {"cpu_worker_count": 2}), (HostOffloadedOptimizer, {})):
        opt = cls(None, cfg, grad_clip=1.0, **kw)
        opt.initialize_master([torch.from_numpy(x.copy()) for x in init])
        master, norm = opt.apply_step([g.reshape(-1).copy() for g in grads], 1e-3, 2.0)
        outs.append(([m.copy() for m in master], norm))
        getattr(opt, "shutdown", lambda: None)()
    (ma, na), (mb, nb) = outs
    assert na == nb and all(np.array_equal(x, y) for x, y in zip(ma, mb))
    assert not np.array_equal(ma[0].reshape(shapes[0]), init[0])


def test_pinned_buffer_pool_reuses_buffers():
    pool = PinnedBufferPool()
    try:
        a = pool.get(8192)
        assert a.dtype == np.uint8 and a.shape == (8192,) and a.ctypes.data % 4096 == 0
        ptr = a.ctypes.data
        pool.put(a)
        with pytest.raises(ValueError):
            pool.put(a)
        b = pool.get(8192)
        assert b.ctypes.data == ptr  # recycled
        c = pool.get(4096)
        assert c.ctypes.data != ptr
        pool.put(b)
        pool.put(c)
    finally:
        pool.close()
    assert default_aio_handle() is default_aio_handle()
