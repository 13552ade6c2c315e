"""ZeRO-Offload in the port (``ops/cpu``, ``runtime/zero/offload.py``,
``runtime/zero/boundary.py``, the engine's offload paths) against the JAX
package's, on the CPU.

* The host ops compile the same C++ sources with the same flag candidates
  as the JAX package's builder, so their steps are bit-equal to the JAX
  wrappers' on the same arrays; ``HostOffloadedOptimizer.apply_step``
  likewise gives the JAX module's masters bit for bit.
* The NVMe spill, SuperOffload, ``offload_param``, ZeRO stages 2 and 3,
  and an ``offload_states``/``reload_states`` round trip change no number:
  bit-equal to the path each stands in for, in the port.
* The offload engine against the JAX offload engine from the same weights
  and batches: the limits of ``test_torch_engine.py`` (fp32: loss and norm
  1e-5 relative, masters 5e-5; bf16: loss 2e-3, norm 2e-2, masters
  2 * lr * steps).  The port takes the global norm on the device, the JAX
  engine in numpy on the host: the same fp32 sums in another order.
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
from deepspeed_tpu.ops.cpu import adagrad as jadagrad
from deepspeed_tpu.ops.cpu import adam as jadam
from deepspeed_tpu.ops.cpu import lion as jlion
from deepspeed_tpu.runtime.zero import offload as joffload
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.convert import params_to_numpy
from deepspeed_tpu_torch.ops.cpu import adagrad as tadagrad
from deepspeed_tpu_torch.ops.cpu import adam as tadam
from deepspeed_tpu_torch.ops.cpu import lion as tlion
from deepspeed_tpu_torch.ops.cpu.aio import AsyncIOHandle
from deepspeed_tpu_torch.runtime.zero import offload as toffload
from test_torch_engine import _compare_params, _compare_step

torch.set_num_threads(2)

LR = 1e-3
SHAPES = [(64, 48), (48,), (300,), (7, 5, 3)]


def _arrays(seed, shapes=SHAPES, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32).ravel() for s in shapes]


@pytest.mark.parametrize("op", ["adam", "adam_l2", "adam_bf16g", "lion", "adagrad"])
def test_host_ops_match_jax_bit_for_bit(op):
    kw = dict(lr=1e-2, weight_decay=0.1)
    if op.startswith("adam"):
        kw["adamw_mode"] = op != "adam_l2"
        j, t = jadam.DeepSpeedCPUAdam(**kw), tadam.DeepSpeedCPUAdam(**kw)
    elif op == "lion":
        j, t = jlion.DeepSpeedCPULion(**kw), tlion.DeepSpeedCPULion(**kw)
    else:
        j, t = jadagrad.DeepSpeedCPUAdagrad(**kw), tadagrad.DeepSpeedCPUAdagrad(**kw)
    pj, pt = _arrays(0), _arrays(0)
    for step in range(3):
        for key, g in enumerate(_arrays(10 + step)):
            if op == "adam_bf16g":
                gb = (g.view(np.uint32) >> 16).astype(np.uint16)  # bf16 bits, truncated
                assert np.array_equal(j.step_bf16_grads(pj[key], gb, key=key),
                                      t.step_bf16_grads(pt[key], gb, key=key))
            else:
                j.step(pj[key], g, key=key)
                t.step(pt[key], g, key=key)
    assert all(np.array_equal(a, b) for a, b in zip(pj, pt))
    sj, st = j.state_dict(), t.state_dict()
    for name in st:
        for k in st[name]:
            assert np.array_equal(np.asarray(sj[name][k]), np.asarray(st[name][k]))


def _host_opts(otype, nvme_path=None, clip=1.0):
    cfg = {"type": otype, "params": {"lr": LR, "weight_decay": 0.1}}
    leaves = _arrays(0)
    tree = {f"l{i}": a for i, a in enumerate(leaves)}  # tree_leaves order: l0, l1, ...
    j = joffload.HostOffloadedOptimizer(tree, cfg, grad_clip=clip)
    j.initialize_master(tree)
    t = toffload.HostOffloadedOptimizer([torch.from_numpy(a) for a in leaves], cfg,
                                        grad_clip=clip, nvme_path=nvme_path)
    t.initialize_master(leaves)
    return j, t


@pytest.mark.parametrize("otype", ["adamw", "adam", "lion", "adagrad"])
def test_apply_step_matches_jax_module(otype):
    """Three boundaries with gas 2 and clipping on: masters and norms
    bit-equal."""
    j, t = _host_opts(otype)
    for step in range(3):
        grads = _arrays(20 + step, scale=3.0)
        mj, nj = j.apply_step([g.copy() for g in grads], LR, 2.0)
        mt, nt = t.apply_step([g.copy() for g in grads], LR, 2.0)
        assert nj == nt
        assert all(np.array_equal(a, b) for a, b in zip(mj, mt))
    assert t.master_bytes() == j.master_bytes() and t.moment_bytes() == j.moment_bytes()


def test_nvme_pipeline_is_bit_equal_to_cpu_offload(tmp_path):
    _, cpu = _host_opts("adamw")
    _, nvme = _host_opts("adamw", nvme_path=str(tmp_path))
    nvme.spill_window = 2
    for step in range(4):
        grads = _arrays(30 + step)
        cpu.apply_step([g.copy() for g in grads], LR, 1.0)
        nvme.apply_step([g.copy() for g in grads], LR, 1.0)
        assert all(np.array_equal(a, b) for a, b in zip(cpu.master, nvme.master))
        assert nvme.moment_bytes() == 0  # every leaf's moments are on disk
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"{m}_{i}.bin" for m in "mv" for i in range(len(SHAPES)))
    nvme.close()


def test_aio_round_trip(tmp_path):
    h = AsyncIOHandle(thread_count=2)
    a = np.arange(1 << 16, dtype=np.float32)
    b = np.empty_like(a)
    h.async_pwrite(a, tmp_path / "x.bin")
    h.drain()
    op = h.async_pread(b, tmp_path / "x.bin")
    h.wait_op(op)
    assert np.array_equal(a, b) and h.pending() == 0 and h.backend in ("uring", "threads")
    h.close()


# --------------------------------------------------------------- the engine
def _ds(dtype="fp32", stage=2, clip=1.0, opt="AdamW", fused=True, **zero):
    ds = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
          "optimizer": {"type": opt, "params": {"lr": LR, "weight_decay": 0.1,
                                                "fused_kernel": fused}},
          "gradient_clipping": clip, "zero_optimization": {"stage": stage, **zero},
          "data_types": {"grad_accum_dtype": "fp32"}}
    if dtype == "bf16":
        ds["bf16"] = {"enabled": True}
    elif dtype == "fp16":
        ds["fp16"] = {"enabled": True, "initial_scale_power": 20, "hysteresis": 1}
    return ds


def _tree():
    jm = jllama.llama_model("tiny", max_seq_len=32)
    return jm, jax.tree_util.tree_map(np.asarray, jt.init_transformer_params(
        jm.config, jax.random.PRNGKey(0)))


def _port(ds, tree, **kw):
    te, *_ = deepspeed_tpu_torch.initialize(model=tllama.llama_model("tiny", max_seq_len=32),
                                            config=dict(ds), model_parameters=tree,
                                            device="cpu", **kw)
    return te


def _batches(steps, vocab=256, gas=1):
    rng = np.random.RandomState(1)
    return [rng.randint(0, vocab, (gas, 2, 17)) for _ in range(steps)]


class _JaxMaster:
    """The JAX offload engine seen through ``_compare_params``: its master
    is the host optimizer's."""

    def __init__(self, je):
        self.je = je

    def get_params(self):
        return self.je.offload_optimizer.master_as_tree(self.je.state.params)


@pytest.mark.parametrize("dtype,steps", [("fp32", 5), ("bf16", 5), ("fp16", 6)])
def test_offload_engine_matches_jax_offload_engine(dtype, steps):
    """fp16 at 2^20 overflows its first backwards: skipped steps, the scale
    and the skip count must agree."""
    ds = _ds(dtype, offload_optimizer={"device": "cpu"})
    jm, tree = _tree()
    je, *_ = deepspeed_tpu.initialize(model=jm, config=dict(ds),
                                      model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    te = _port(ds, tree)
    assert te.offload_optimizer is not None and te.state.opt_state == ()
    low = dtype != "fp32"
    for ids in _batches(steps):
        lj = float(je.train_batch(jnp.asarray(ids, jnp.int32)))
        lt = te.train_batch(ids)
        _compare_step(je, te, lj, lt, low)
    if dtype == "fp16":
        assert te.skipped_steps == je.skipped_steps > 0
    _compare_params(_JaxMaster(je), te, steps, low)
    assert all(p.dtype == te.compute_dtype for p in te.state.params.parameters())


def _losses(te, steps=4, gas=1):
    return [te.train_batch(ids) for ids in _batches(steps, gas=gas)]


def _masters(te):
    return [p.detach().clone() for p in te.get_params().parameters()]


def _same(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("zero", [
    {"offload_optimizer": {"device": "nvme"}},
    {"offload_optimizer": {"device": "cpu", "super_offload": True, "cpu_worker_count": 3}},
    {"offload_optimizer": {"device": "nvme", "super_offload": True}},
])
def test_nvme_and_superoffload_bit_equal_to_cpu_offload(zero, tmp_path):
    _, tree = _tree()
    ref = _port(_ds("bf16", offload_optimizer={"device": "cpu"}), tree)
    if zero["offload_optimizer"]["device"] == "nvme":
        zero["offload_optimizer"]["nvme_path"] = str(tmp_path)
    te = _port(_ds("bf16", **zero), tree)
    _same(_losses(ref), _losses(te))
    _same(_masters(ref), _masters(te))
    te.offload_optimizer.close()


@pytest.mark.parametrize("dtype,fused,opt", [("bf16", True, "AdamW"), ("fp32", True, "AdamW"),
                                             ("bf16", False, "lamb")])
def test_offload_param_bit_equal_to_device_path(dtype, fused, opt):
    _, tree = _tree()
    ref = _port(_ds(dtype, opt=opt, fused=fused), tree)
    te = _port(_ds(dtype, opt=opt, fused=fused, offload_param={"device": "cpu"}), tree)
    assert all(p.device.type == "cpu" for p in te.state.params.parameters())
    _same(_losses(ref), _losses(te))
    _same(_masters(ref), _masters(te))


@pytest.mark.parametrize("offload", [False, True])
def test_offload_states_round_trip(offload):
    _, tree = _tree()
    zero = {"offload_optimizer": {"device": "cpu"}} if offload else {}
    ref, te = _port(_ds("bf16", **zero), tree), _port(_ds("bf16", **zero), tree)
    want = _losses(ref)
    got = [te.train_batch(ids) for ids in _batches(2)]
    te.offload_states()
    with pytest.raises(RuntimeError, match="reload_states"):
        te.train_batch(_batches(1)[0])
    te.reload_states()
    got += [te.train_batch(ids) for ids in _batches(4)[2:]]
    _same(want, got)
    _same(_masters(ref), _masters(te))


@pytest.mark.parametrize("stage", [2, 3])
def test_stage_2_and_3_bit_equal_to_stage_0(stage):
    _, tree = _tree()
    ref, te = _port(_ds("bf16", stage=0), tree), _port(_ds("bf16", stage=stage), tree)
    assert te.zero_optimization_stage() == stage
    _same(_losses(ref, gas=2), _losses(te, gas=2))
    _same(_masters(ref), _masters(te))


def test_host_memory_accounting_and_no_device_master():
    _, tree = _tree()
    te = _port(_ds("bf16", offload_optimizer={"device": "cpu"}), tree)
    n = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(tree))
    assert te.offload_optimizer.master_bytes() == 4 * n
    _losses(te, steps=1)
    assert te.offload_optimizer.moment_bytes() == 8 * n
    assert te._master == [] and sum(p.numel() for p in te._compute.parameters()) == n
