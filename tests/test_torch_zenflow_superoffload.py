"""SuperOffload and ZenFlow in the port (``runtime/superoffload``,
``runtime/zenflow``) on the CPU.

* SuperOffload (per-leaf host updates on a thread pool, also spilling to
  NVMe from each worker's own handle) is bit-equal to plain offload, and
  to the JAX package's SuperOffload.
* ZenFlow against the JAX module on the same leaves and gradients over
  seven boundaries with ``update_interval`` 3, so two slow passes launch
  (steps 3 and 6) and one is merged: numpy on both sides, the same
  operations, so the masters are bit-equal after every step, with the
  slow pass in a background thread and inline.
* Through the engine: ZenFlow with ``topk_ratio`` 1.0 is Adam on every
  column every step: within 1e-5 of the AdamW engine (numpy's Adam against
  the C++ op's: the same formula rounded at other points).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.config import ZenFlowConfig as JZenFlowConfig
from deepspeed_tpu.runtime.superoffload import superoffload as jsuper
from deepspeed_tpu.runtime.zenflow import zenflow as jzen
from deepspeed_tpu_torch.runtime.config import ZenFlowConfig
from deepspeed_tpu_torch.runtime.superoffload.superoffload import SuperOffloadOptimizer
from deepspeed_tpu_torch.runtime.zenflow.zenflow import ZenFlowOptimizer
from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadedOptimizer
from test_torch_offload import _ds, _losses, _masters, _port, _tree

torch.set_num_threads(2)

LR = 1e-3
CFG = {"type": "adamw", "params": {"lr": LR, "weight_decay": 0.1}}
SHAPES = [(32, 40), (40,), (4, 8, 16), (16, 8)]


def _leaves(seed, scale=1.0, flat=True):
    rng = np.random.RandomState(seed)
    out = [(rng.randn(*s) * scale).astype(np.float32) for s in SHAPES]
    return [a.ravel() for a in out] if flat else out


@pytest.mark.parametrize("nvme", [False, True])
def test_superoffload_bit_equal_to_plain_offload_and_jax(nvme, tmp_path):
    init = _leaves(0)
    plain = HostOffloadedOptimizer(None, CFG, grad_clip=1.0)
    sup = SuperOffloadOptimizer(None, CFG, grad_clip=1.0, cpu_worker_count=3,
                                nvme_path=str(tmp_path) if nvme else None)
    jsup = jsuper.SuperOffloadOptimizer({f"l{i}": a for i, a in enumerate(init)}, CFG,
                                        grad_clip=1.0, cpu_worker_count=3)
    for o in (plain, sup):
        o.initialize_master(init)
    jsup.initialize_master({f"l{i}": a for i, a in enumerate(init)})
    for step in range(4):
        g = _leaves(10 + step, scale=2.0)
        m0, n0 = plain.apply_step([x.copy() for x in g], LR, 2.0)
        m1, n1 = sup.apply_step([x.copy() for x in g], LR, 2.0)
        m2, n2 = jsup.apply_step([x.copy() for x in g], LR, 2.0)
        assert n0 == n1 == n2
        assert all(np.array_equal(a, b) and np.array_equal(a, c) for a, b, c in zip(m0, m1, m2))
    if nvme:
        assert sup.moment_bytes() == 0
    sup.shutdown()
    jsup.shutdown()


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("topk", [0.25, 1.0])
def test_zenflow_matches_jax_module(overlap, topk):
    zc = dict(enabled=True, topk_ratio=topk, update_interval=3, full_warm_up_rounds=1,
              overlap_step=overlap)
    init = _leaves(0, flat=False)
    j = jzen.ZenFlowOptimizer(None, CFG, zenflow_config=JZenFlowConfig(**zc), grad_clip=1.0)
    t = ZenFlowOptimizer(None, CFG, zenflow_config=ZenFlowConfig(**zc), grad_clip=1.0)
    j.initialize_master({f"l{i}": a for i, a in enumerate(init)})
    t.initialize_master(init)
    for step in range(7):
        g = _leaves(40 + step, scale=2.0, flat=False)
        mj, nj = j.apply_step([x.copy() for x in g], LR, 1.0)
        mt, nt = t.apply_step([x.copy() for x in g], LR, 1.0)
        assert nj == nt
        j._join_slow()
        t._join_slow()
        assert all(np.array_equal(a, b) for a, b in zip(mj, t.master)), step
    sj, st = j.state_dict(), t.state_dict()
    for k in ("m", "v", "accum"):
        assert all(np.array_equal(a, b) for a, b in zip(sj[k], st[k]))
    assert t.moment_bytes() == j.moment_bytes()


def test_zenflow_engine_topk_one_tracks_adamw():
    _, tree = _tree()
    ref = _port(_ds("fp32", offload_optimizer={"device": "cpu"}), tree)
    te = _port(_ds("fp32", zenflow={"enabled": True, "topk_ratio": 1.0}), tree)
    for a, b in zip(_losses(ref), _losses(te)):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(a))
    for a, b in zip(_masters(ref), _masters(te)):
        assert float((a - b).abs().max()) <= 1e-5


@pytest.mark.parametrize("overlap", [True, False])
def test_zenflow_engine_loss_falls_with_partial_columns(overlap):
    """The loss falls, and after every step the card's compute leaves are
    the host master rounded to bf16 (also where an inline slow pass moved
    leaves after their push)."""
    _, tree = _tree()
    te = _port(_ds("bf16", zenflow={"enabled": True, "topk_ratio": 0.25, "update_interval": 2,
                                    "overlap_step": overlap}), tree)
    ids = np.random.RandomState(3).randint(0, 256, (1, 2, 17))
    losses = []
    for _ in range(6):
        losses.append(float(te.train_batch(ids)))
        for c, m in zip(te._compute.parameters(), te.offload_optimizer.master):
            assert torch.equal(c, torch.from_numpy(m).reshape(c.shape).to(torch.bfloat16))
    assert losses[-1] < losses[0]


def test_superoffload_stress_many_workers_many_leaves():
    """More workers than cores over 64 small leaves with a short switch
    interval: every leaf's update lands once (bit-equal to plain offload),
    the per-key step counts all reach the step count."""
    import sys
    import time

    rng = np.random.RandomState(4)
    init = [rng.randn(n).astype(np.float32) for n in rng.randint(1, 300, 64)]
    plain = HostOffloadedOptimizer(None, CFG)
    sup = SuperOffloadOptimizer(None, CFG, cpu_worker_count=32)
    plain.initialize_master(init)
    sup.initialize_master(init)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t0 = time.monotonic()
    try:
        for step in range(3):
            g = [rng.randn(a.size).astype(np.float32) for a in init]
            plain.apply_step([x.copy() for x in g], LR, 1.0)
            sup.apply_step([x.copy() for x in g], LR, 1.0)
    finally:
        sys.setswitchinterval(old)
        sup.shutdown()
    assert time.monotonic() - t0 < 60
    assert all(np.array_equal(a, b) for a, b in zip(plain.master, sup.master))
    assert set(sup.cpu_adam._t.values()) == {3} and len(sup.cpu_adam._t) == 64
