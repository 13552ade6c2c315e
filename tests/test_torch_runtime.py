"""The port's training runtime helpers against the JAX package's: the
learning-rate schedules, the config's batch triangle, the dynamic loss
scaler and the gradient-norm helpers, plus the blocks the port leaves
out raising with their ROADMAP item and the blocks and optimizers it has
taken in since (ZeRO stages 2 and 3, offload, ZenFlow, the hybrid engine;
lamb, lion, adagrad, sgd, muon, the 1-bit family) building and stepping.

Tolerances: schedules 1e-6 relative (the same fp32 formulas; XLA and
PyTorch may round exp, log and cos an ulp apart); norms 1e-6 relative
(fp32 sums in another order); the loss scaler exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime import lr_schedules as jsched
from deepspeed_tpu.runtime import precision as jprec
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import lr_schedules as tsched
from deepspeed_tpu_torch.runtime import optimizers as topt
from deepspeed_tpu_torch.runtime import precision as tprec

torch.set_num_threads(2)

SCHEDULES = {
    "none": (None, {}),
    "LRRangeTest": ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 3,
                                    "lr_range_test_staircase": True}),
    "WarmupLR_log": ("WarmupLR", {"warmup_max_lr": 1e-3, "warmup_num_steps": 5}),
    "WarmupLR_linear": ("WarmupLR", {"warmup_max_lr": 1e-3, "warmup_num_steps": 5,
                                     "warmup_type": "linear"}),
    "WarmupDecayLR": ("WarmupDecayLR", {"total_num_steps": 12, "warmup_num_steps": 4,
                                        "warmup_max_lr": 2e-3}),
    "WarmupCosineLR": ("WarmupCosineLR", {"total_num_steps": 12, "warmup_num_steps": 4,
                                          "warmup_max_lr": 2e-3, "warmup_min_ratio": 0.1}),
    "OneCycle": ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                              "cycle_first_step_size": 3, "decay_step_size": 2,
                              "decay_lr_rate": 0.5}),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    kind, params = SCHEDULES[name]
    js = jsched.get_schedule(kind, params, 5e-4)
    ts = tsched.get_schedule(kind, params, 5e-4)
    for step in range(16):
        want = float(js(jnp.asarray(step, jnp.int32)))
        assert float(ts(step)) == pytest.approx(want, rel=1e-6, abs=1e-12), step
        # on a 0-d tensor (the engine's device step) as on an int
        assert float(ts(torch.tensor(step, dtype=torch.int32))) == float(ts(step))
    shim = tsched.LRSchedulerShim(ts)
    shim.step(3)
    assert shim.get_lr() == [float(ts(3))] and shim.state_dict() == {"step": 3}


BATCHES = [
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 4},
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2},
    {"train_batch_size": 8, "gradient_accumulation_steps": 2},
    {"train_micro_batch_size_per_gpu": 3},
    {"train_batch_size": 6},
    {},
]


@pytest.mark.parametrize("i", range(len(BATCHES)))
def test_batch_triangle_matches_jax(i):
    j, t = jconfig.DeepSpeedConfig(dict(BATCHES[i]), 1), tconfig.DeepSpeedConfig(dict(BATCHES[i]), 1)
    assert (t.train_batch_size, t.train_micro_batch_size_per_gpu,
            t.gradient_accumulation_steps) == (j.train_batch_size,
                                               j.train_micro_batch_size_per_gpu,
                                               j.gradient_accumulation_steps)


def test_config_blocks_and_errors():
    cfg = tconfig.DeepSpeedConfig({"bf16": {"enabled": True}, "zero_optimization": {"stage": 1},
                                   "gradient_clipping": 1.0, "seed": 7, "steps_per_print": 3,
                                   "data_types": {"grad_accum_dtype": "bf16"},
                                   "telemetry": {"enabled": False}})
    assert (cfg.compute_dtype, cfg.zero_enabled, cfg.gradient_clipping, cfg.seed,
            cfg.steps_per_print, cfg.gradient_accumulation_dtype) == (
        torch.bfloat16, True, 1.0, 7, 3, "bf16")
    with pytest.raises(ValueError, match="both"):
        tconfig.DeepSpeedConfig({"fp16": {"enabled": True}, "bf16": {"enabled": True}})
    with pytest.raises(ValueError, match="inconsistency"):
        tconfig.DeepSpeedConfig({"train_batch_size": 5, "train_micro_batch_size_per_gpu": 2,
                                 "gradient_accumulation_steps": 2}, 1)


def test_serving_block_parses_into_serving_config():
    """The ``serving`` block parses into ``ServingConfig`` as in the JAX
    package (once refused), its nested blocks coerced, a bad one refused
    with JAX's message."""
    from deepspeed_tpu_torch.serving import ServingConfig

    block = {"serving": {"enabled": True, "load_gap": 2, "prefill_chunk": 256,
                         "speculative": {"mode": "ngram", "k": 3},
                         "autoscale": {"enabled": True, "max_replicas": 3},
                         "transport": {"sender_depth": 4}}}
    t, j = tconfig.DeepSpeedConfig(block), jconfig.DeepSpeedConfig(block)
    assert isinstance(t.serving, ServingConfig)
    assert (t.serving.enabled, t.serving.load_gap, t.serving.prefill_chunk,
            t.serving.speculative.k, t.serving.autoscale.max_replicas,
            t.serving.transport.sender_depth) == (
        j.serving.enabled, j.serving.load_gap, j.serving.prefill_chunk,
        j.serving.speculative.k, j.serving.autoscale.max_replicas,
        j.serving.transport.sender_depth)
    assert tconfig.DeepSpeedConfig({}).serving.enabled is False
    bad = {"serving": {"enabled": True, "prefill_replicas": 0}}
    with pytest.raises(ValueError) as want:
        jconfig.DeepSpeedConfig(bad)
    with pytest.raises(ValueError) as got:
        tconfig.DeepSpeedConfig(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("block", [
    {"zero_optimization": {"stage": 2}},
    {"zero_optimization": {"stage": 3}},
    {"zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu"}}},
    {"zero_optimization": {"offload_param": {"device": "nvme"}}},
    {"zero_optimization": {"zenflow": {"enabled": True}}},
    {"zero_optimization": {"zero_quantized_gradients": True}},
    {"mesh": {"data": 2}},
    {"pipeline": {"hop_compression": "int8"}},
    {"telemetry": {"enabled": True}},
    {"resilience": {"enabled": True}},
    {"hybrid_engine": {"enabled": True}},
    {"tensorboard": {"enabled": True}},
    {"csv_monitor": {"enabled": True}},
    {"wandb": {"enabled": True}},
    {"comet": {"enabled": True}},
    {"flops_profiler": {"enabled": True}},
    {"elasticity": {"enabled": True, "max_train_batch_size": 2, "micro_batch_sizes": [2],
                    "ignore_non_elastic_batch_info": True}},
    {"sanity_checks": True},
])
def test_unported_blocks_raise_with_their_roadmap_item(block, tmp_path):
    """The blocks still unported raise naming their ROADMAP item; the ones
    ported since (stages 2 and 3, offload_optimizer, offload_param,
    zenflow, hybrid_engine, telemetry, resilience, sanity_checks, the
    monitors, flops_profiler, elasticity) build an engine that takes a
    step.  A monitor whose package is missing (wandb, comet here) warns and
    writes nothing."""
    zero = block.get("zero_optimization", {})
    if "resilience" in block:
        block = {"resilience": dict(block["resilience"], save_dir=str(tmp_path))}
    if "tensorboard" in block or "csv_monitor" in block:
        block = {k: dict(v, output_path=str(tmp_path)) for k, v in block.items()}
    if set(block) <= {"zero_optimization", "hybrid_engine", "telemetry", "resilience",
                      "sanity_checks", "tensorboard", "csv_monitor", "wandb", "comet",
                      "flops_profiler", "elasticity"} and \
            set(zero) <= {"stage", "offload_optimizer", "offload_param", "zenflow"}:
        _steps({"train_micro_batch_size_per_gpu": 2, **block}).close()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tconfig.DeepSpeedConfig(block)


def _steps(ds, steps=2):
    """A tiny llama engine on the CPU from ``ds``: ``steps`` train_batch
    calls, each loss finite, the step count advancing."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_model

    engine, *_ = deepspeed_tpu_torch.initialize(model=llama_model("tiny", max_seq_len=32),
                                                config=ds, device="cpu", seed=0)
    ids = np.random.RandomState(0).randint(0, 256, (1, 2, 17))
    losses = [float(engine.train_batch(ids)) for _ in range(steps)]
    assert all(np.isfinite(losses)) and int(engine.state.step) == steps
    return engine


@pytest.mark.parametrize("name", ["lamb", "lion", "adagrad", "sgd", "muon", "onebitadam"])
def test_unported_optimizers_raise(name):
    """Once refused; now each builds and moves the weights (the arithmetic is
    held against the JAX package's in ``test_torch_optimizers.py``)."""
    tx, lr = topt.build_optimizer(name, {}, tsched.get_schedule(None, {}, 1e-3))
    assert lr == 1e-3 and callable(tx.init) and callable(tx.update)
    engine = _steps({"train_micro_batch_size_per_gpu": 2,
                     "optimizer": {"type": name, "params": {"lr": 1e-3}}})
    assert engine.optimizer is not None


@pytest.mark.parametrize("name,fused", [("adam", True), ("adamw", False), ("FusedAdam", True),
                                        ("DeepSpeedCPUAdam", False)])
def test_adam_family_builds(name, fused):
    tx, lr = topt.build_optimizer(name, {"lr": 3e-4, "fused_kernel": fused},
                                  tsched.get_schedule(None, {}, 3e-4))
    assert lr == 3e-4 and hasattr(tx, "direct_update") == fused


FP16 = [dict(), dict(hysteresis=1), dict(loss_scale_window=2), dict(consecutive_hysteresis=True),
        dict(min_loss_scale=2 ** 14), dict(loss_scale=128.0)]


@pytest.mark.parametrize("i", range(len(FP16)))
def test_loss_scaler_matches_jax(i):
    overflows = [True, True, False, True, False, False, False, True, True, True, False]
    jc = jconfig.FP16Config.from_dict({"enabled": True, "initial_scale_power": 16, **FP16[i]})
    tc = tconfig.FP16Config.from_dict({"enabled": True, "initial_scale_power": 16, **FP16[i]})
    js, ts = jprec.LossScaleState.create(jc), tprec.LossScaleState.create(tc, torch.device("cpu"))
    for ov in overflows:
        js = jprec.update_loss_scale(js, jnp.asarray(ov), jc)
        ts = tprec.update_loss_scale(ts, torch.tensor(ov), tc)
        assert (float(ts.cur_scale), int(ts.growth_tracker), int(ts.hysteresis_tracker)) == (
            float(js.cur_scale), int(js.growth_tracker), int(js.hysteresis_tracker))
        assert ts.growth_tracker.dtype == ts.hysteresis_tracker.dtype == torch.int32


def test_norm_clip_overflow_match_jax():
    rng = np.random.RandomState(0)
    leaves = [rng.randn(*s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 5))]
    jl, tl = [jnp.asarray(a) for a in leaves], [torch.from_numpy(a) for a in leaves]
    jn, tn = jprec.global_grad_norm(jl), tprec.global_grad_norm(tl)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for clip in (0.5, 100.0):
        for a, b in zip(tprec.clip_by_global_norm(tl, tn, clip),
                        jprec.clip_by_global_norm(jl, jn, clip)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert not bool(tprec.check_overflow(tl))
    tl[1][3] = float("inf")
    assert bool(tprec.check_overflow(tl)) and bool(jprec.check_overflow(
        [jnp.asarray(t.numpy()) for t in tl]))
