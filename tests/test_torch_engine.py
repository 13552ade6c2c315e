"""The port's training engine against the JAX package's, step for step.

``deepspeed_tpu_torch.initialize`` (on the CPU) and
``deepspeed_tpu.initialize`` start from the same numpy weights (the JAX
initialiser's, through ``model_parameters``) and take the same numpy
batches; after every step the loss, the global grad norm, the loss scale
and the skipped-step count are compared, and at the end the fp32 master
weights.

Tolerances, and why:
  * fp32: loss and grad norm 1e-5 relative, master weights 5e-5 absolute
    (observed 6.4e-6 after 5 steps: the same formulas, summed in another
    order);
  * bf16 / fp16 compute: loss 2e-3 relative, grad norm 2e-2 relative
    (observed 1e-3: each op rounds to 16 bits at other points in XLA's
    fusions than in PyTorch's kernels); master weights within
    2 * lr * steps absolute — Adam's normalised step moves a weight by
    about lr whatever the gradient's size, so a tiny gradient whose sign
    differs moves it 2 lr the other way — and within 2e-4 on average;
  * loss scale and skipped steps: equal (the overflow verdicts must agree).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.convert import params_to_numpy
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_adam

torch.set_num_threads(2)

LR = 1e-3
FP16_OVERFLOW = {"enabled": True, "initial_scale_power": 20, "hysteresis": 1}


def _ds(dtype="fp32", gas=1, clip=1.0, opt_extra=None, **extra):
    params = {"lr": LR, "weight_decay": 0.1, "fused_kernel": True}
    params.update(opt_extra or {})
    ds = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": gas,
          "optimizer": {"type": "AdamW", "params": params}, "gradient_clipping": clip,
          "zero_optimization": {"stage": 1}, "data_types": {"grad_accum_dtype": "fp32"}}
    if dtype == "bf16":
        ds["bf16"] = {"enabled": True}
    ds.update(extra)
    return ds


def _engines(ds, model_kw=None):
    model_kw = model_kw or {}
    jm = jllama.llama_model("tiny", max_seq_len=32, **model_kw)
    tm = tllama.llama_model("tiny", max_seq_len=32, **model_kw)
    tree = jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        jm.config, jax.random.PRNGKey(0)))
    je, *_ = deepspeed_tpu.initialize(model=jm, config=dict(ds),
                                      model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    te, opt, loader, sched = deepspeed_tpu_torch.initialize(model=tm, config=dict(ds),
                                                             model_parameters=tree, device="cpu")
    assert opt is te.optimizer and loader is None and sched is te.lr_scheduler
    return je, te, jm.config.vocab_size


def _compare_step(je, te, lj, lt, low_precision):
    lt = float(lt)
    assert np.isfinite(lt) == np.isfinite(lj)
    rel = 2e-3 if low_precision else 1e-5
    if np.isfinite(lj):
        assert abs(lt - lj) <= rel * abs(lj), (lt, lj)
    nj, nt = je.get_global_grad_norm(), te.get_global_grad_norm()
    if np.isfinite(nj):
        assert abs(nt - nj) <= (2e-2 if low_precision else 1e-5) * nj, (nt, nj)
    else:
        assert not np.isfinite(nt)
    assert te.loss_scale() == je.loss_scale()
    assert te.skipped_steps == je.skipped_steps
    assert te.get_lr() == pytest.approx(je.get_lr(), rel=1e-6)


def _compare_params(je, te, steps, low_precision):
    want = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), je.get_params()))
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(te.get_params())))
    assert len(got) == len(want)
    diffs = []
    for path, w in want:
        d = np.abs(got[path] - w)
        diffs.append(d.ravel())
        assert d.max() <= (2 * LR * steps if low_precision else 5e-5), \
            (jax.tree_util.keystr(path), d.max())
    assert np.concatenate(diffs).mean() <= (2e-4 if low_precision else 5e-6)


def _drive(ds, steps=5, gas=1, api="train_batch", model_kw=None, low_precision=False):
    je, te, vocab = _engines(ds, model_kw)
    rng = np.random.RandomState(1)
    for _ in range(steps):
        ids = rng.randint(0, vocab, (gas, 2, 17))
        if api == "train_batch":
            lj = float(je.train_batch(jnp.asarray(ids, jnp.int32)))
            lt = te.train_batch(ids)
            assert isinstance(lt, torch.Tensor) and lt.dtype == torch.float32
        else:  # the DeepSpeed-compat loop: forward / backward per micro-batch, then step
            lj, lt = [], []
            for i in range(gas):
                lj.append(float(je.forward(jnp.asarray(ids[i], jnp.int32))))
                je.backward()
                lt.append(te.forward(ids[i]))
                te.backward()
                assert te.is_gradient_accumulation_boundary() == (i == gas - 1)
            je.step()
            te.step()
            lj, lt = float(np.mean(lj)), float(torch.stack(lt).mean())
        _compare_step(je, te, lj, lt, low_precision)
    assert te.global_steps == je.global_steps == steps
    _compare_params(je, te, steps, low_precision)
    return je, te


def test_fp32():
    _drive(_ds())


def test_bf16():
    _, te = _drive(_ds("bf16"), low_precision=True)
    assert all(p.dtype == torch.float32 for p in te.get_params().parameters())  # fp32 master
    assert all(p.dtype == torch.bfloat16 for p in te._compute.parameters())


def test_fp16_with_overflow_steps():
    """2^20 overflows the fp16 backward twice; each skipped step leaves
    params and moments untouched, halves the scale, and the schedule waits."""
    je, te = _drive(_ds(fp16=FP16_OVERFLOW), steps=6, low_precision=True)
    assert te.skipped_steps == 2 and int(te.state.step) == 4
    assert int(te.state.opt_state["step"]) == 4


def test_fp16_hysteresis_and_growth():
    """Default hysteresis 2 and a 2-step growth window: the scale holds on
    the first overflow, halves on the second, and doubles after clean
    steps."""
    _drive(_ds(fp16={"enabled": True, "initial_scale_power": 20, "loss_scale_window": 2}),
           steps=6, low_precision=True)


@pytest.mark.parametrize("api", ["train_batch", "forward_backward_step"])
def test_gas2(api):
    _drive(_ds(gas=2), gas=2, api=api)


@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_clipping(clip):
    """No clipping, and a clip far below the norm (~2.4), which rescales
    every step; the norm is reported before clipping on both sides."""
    _drive(_ds(clip=clip))


def test_unfused_adamw():
    _drive(_ds(opt_extra={"fused_kernel": False}))


@pytest.mark.parametrize("fused", [True, False])
def test_adam_l2_mode(fused):
    """type "Adam" with adam_w_mode False: the decay is added to the grad."""
    ds = _ds(opt_extra={"fused_kernel": fused, "adam_w_mode": False})
    ds["optimizer"]["type"] = "Adam"
    _drive(ds)


@pytest.mark.parametrize("fused", [True, False])
def test_mu_dtype_bf16(fused):
    _, te = _drive(_ds(opt_extra={"fused_kernel": fused, "mu_dtype": "bf16"}))
    assert all(m.dtype == torch.bfloat16 for m in te.state.opt_state["m"])


def test_warmup_decay_schedule():
    _, te = _drive(_ds(scheduler={"type": "WarmupDecayLR", "params": {
        "total_num_steps": 8, "warmup_num_steps": 3, "warmup_max_lr": LR}}))
    assert te.get_lr()[0] == pytest.approx(LR * 3 / 5, rel=1e-6)


def test_flash_attention_both_sides():
    """attn_impl="flash" on both engines (the JAX Pallas kernels in
    interpret mode; the port's flash path on the CPU), with GQA."""
    _drive(_ds(), model_kw={"attn_impl": "flash", "n_kv_heads": 2})


def test_cpu_engine_launches_no_kernel():
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                fused_adam.fused_adam_update)
    before = [c.launches for c in counters]
    _drive(_ds(), steps=1, model_kw={"attn_impl": "flash"})
    assert [c.launches for c in counters] == before


def test_eval_batch_and_accessors():
    je, te, vocab = _engines(_ds(gas=2))
    ids = np.random.RandomState(2).randint(0, vocab, (2, 9))
    np.testing.assert_allclose(te.eval_batch(ids).numpy(), np.asarray(je.eval_batch(
        jnp.asarray(ids, jnp.int32))), atol=1e-5, rtol=1e-5)
    assert (te.train_micro_batch_size_per_gpu(), te.gradient_accumulation_steps(),
            te.train_batch_size(), te.zero_optimization_stage()) == (2, 2, 4, 1)
    assert te.loss_scale() == 1.0 and te.skipped_steps == 0
    with pytest.raises(ValueError, match="batch or a data iterator"):
        te.train_batch()
    it = iter([ids[:, :5], ids[:, 4:]])
    assert torch.isfinite(te.train_batch(data_iter=it))


def test_abandoned_forward_is_dropped_by_train_batch():
    """A forward() without its step() does not leak into the next
    train_batch: the result equals a fresh engine's."""
    ds = _ds(gas=2)
    _, a, vocab = _engines(ds)
    _, b, _ = _engines(ds)
    ids = np.random.RandomState(3).randint(0, vocab, (2, 2, 17))
    a.forward(ids[0])
    a.backward()
    la, lb = a.train_batch(ids), b.train_batch(ids)
    assert float(la) == float(lb)
    for (_, x), (_, y) in zip(a.get_params().named_parameters(),
                              b.get_params().named_parameters()):
        assert torch.equal(x, y)


def test_model_parameters_param_tree_is_adopted_as_a_copy():
    """A port ParamTree given as model_parameters is the starting master,
    copied: training never writes into the caller's tensors."""
    model = tllama.llama_model("tiny", max_seq_len=32)
    given = model.init_params(torch.Generator().manual_seed(11), "cpu")
    before = {n: p.clone() for n, p in given.named_parameters()}
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=_ds(),
                                                model_parameters=given, device="cpu")
    for n, p in engine.get_params().named_parameters():
        assert torch.equal(p, before[n]) and p.data_ptr() != dict(given.named_parameters())[n].data_ptr()
    engine.train_batch(np.random.RandomState(0).randint(0, 256, (1, 2, 9)))
    for n, p in given.named_parameters():
        assert torch.equal(p, before[n])
    with pytest.raises(TypeError, match="model_parameters"):
        deepspeed_tpu_torch.initialize(model=model, config=_ds(),
                                       model_parameters=iter(given.parameters()), device="cpu")


def test_client_optimizer_and_schedule_match_the_config_built_ones():
    """``initialize(optimizer=..., lr_scheduler=...)``: a client
    (init, update) transformation and a step -> lr callable drive the same
    trajectory as the config's AdamW and constant lr; get_params(dtype)
    returns a cast copy."""
    from deepspeed_tpu_torch.runtime import lr_schedules, optimizers

    ds = _ds(opt_extra={"fused_kernel": False})
    model = tllama.llama_model("tiny", max_seq_len=32)
    given = model.init_params(torch.Generator().manual_seed(3), "cpu")
    a, *_ = deepspeed_tpu_torch.initialize(model=model, config=dict(ds),
                                           model_parameters=given, device="cpu")
    sched = lr_schedules.get_schedule(None, {}, LR)
    tx, _ = optimizers.build_optimizer("adamw", {"lr": LR, "weight_decay": 0.1}, sched)
    b, opt, _, shim = deepspeed_tpu_torch.initialize(
        model=model, config=dict(ds), model_parameters=given, optimizer=tx,
        lr_scheduler=sched, device="cpu")
    assert opt is tx and shim.schedule is sched
    ids = np.random.RandomState(4).randint(0, 256, (3, 1, 2, 9))
    for step in ids:
        assert float(a.train_batch(step)) == float(b.train_batch(step))
    for (_, x), (_, y) in zip(a.get_params().named_parameters(),
                              b.get_params(torch.bfloat16).named_parameters()):
        assert y.dtype == torch.bfloat16 and torch.equal(x.bfloat16(), y)
    with pytest.raises(TypeError, match="GradientTransformation"):
        deepspeed_tpu_torch.initialize(model=model, config=dict(ds), optimizer=object(),
                                       device="cpu")
