"""The port's FLOPs profiler (``profiling/flops_profiler.py``) against the
JAX package's, on the CPU.

* ``per_module_breakdown``: the same rows (modules, parameter counts) as
  the JAX function, whose FLOPs are XLA's cost analysis of each part
  lowered on the CPU through the JAX tests' own path (the XLA attention).
  FlopCounterMode counts matrix products only, XLA also the elementwise
  work (norms, rope, softmax), so the band per row is stated: at the tiny
  llama's head dim 16 the attention row is 0.93 of XLA's, the MLP 0.98,
  the LM head 1.0 — held within [0.9, 1.0]; the embedding and final norm
  have no product (0 here) and are under 1 % of XLA's total there.
* each flash kernel's reported FLOPs (``FLOPS_PER_PAIR`` x D x the pairs
  ``attention_pairs`` counts) equal FlopCounterMode's count of its plain
  version on the same shapes: forward non-causal exactly; causal, the
  kernel counts the visible pairs only (PERF.md §6's bound) where the plain
  version prices the whole score matrix, so it is the plain count times
  the visible share (checked against the mask itself); dQ + dK/dV equal
  the plain backward's count plus the 4 D a pair the two kernels
  each spend recomputing S and dP;
* the other kernels' reported FLOPs (each module's ``kernel_flops``, the
  count its wrapper reports at a launch) against FlopCounterMode's count
  of their plain versions: grouped G, G', G'' and weight-quantized W
  exactly; evoformer E exactly and E' + E'' the plain backward plus the
  4 D a pair of their recompute, as flash; block-sparse S the plain
  (dense, masked) count times the layout's visible share, a causal
  diagonal block counting half (``block / 2`` pairs a row under the
  exact count);
* pricing a micro-step apart leaves the step's bits alone: FlopCounterMode
  runs every op without a FLOP formula through its decomposition
  (``aten.silu_backward`` of the SwiGLU MLP among them), which rounds
  otherwise, so a profiled engine takes the unprofiled one's steps;
* the engine's profile: FLOPs per micro-step = FlopCounterMode's part +
  the kernels' part (none on the CPU), and 3x the per-module forward sum
  (each product's backward is two products of its size); the published
  gauges are the JAX package's names."""

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.profiling import flops_profiler as jprof
from deepspeed_tpu.telemetry import registry as jreg
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops import evoformer_attn as ev
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import grouped_matmul as gm
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops import wq_matmul as wq
from deepspeed_tpu_torch.profiling import flops_profiler as tprof
from deepspeed_tpu_torch.telemetry import registry as treg

torch.set_num_threads(2)

BAND = (0.9, 1.0)


@pytest.mark.parametrize("batch,seq", [(2, 128), (1, 64)])
def test_per_module_breakdown_within_the_band_of_xla(batch, seq):
    cfg = jllama.llama_config("tiny", max_seq_len=seq)
    params = jt.init_transformer_params(cfg, jax.random.PRNGKey(0))
    jrows = jprof.per_module_breakdown(cfg, params, batch_size=batch, seq_len=seq)
    tcfg = tllama.llama_config("tiny", max_seq_len=seq)
    trows = tprof.per_module_breakdown(
        tcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu"),
        batch_size=batch, seq_len=seq)
    total = sum(r["flops"] for r in jrows)
    assert [r["module"] for r in trows] == [r["module"] for r in jrows]
    for j, t in zip(jrows, trows):
        assert t["params"] == j["params"], t["module"]
        assert t["macs"] == t["flops"] / 2
        if t["module"] in ("embed", "final_norm"):
            assert t["flops"] == 0 and j["flops"] < 0.01 * total
        else:
            assert BAND[0] <= t["flops"] / j["flops"] <= BAND[1], (t["module"], t, j)
    assert abs(sum(r["pct"] for r in trows) - 100.0) < 1e-9
    assert "layers.1.mlp" in tprof.format_module_table(trows)


def _flops(fn):
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return mode.get_total_flops()


def _qkv(B, Sq, Sk, NH, KVH, D, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, Sq, NH, D, generator=g), torch.randn(B, Sk, KVH, D, generator=g),
            torch.randn(B, Sk, KVH, D, generator=g))


SHAPES = [(2, 16, 16, 4, 2, 8), (1, 40, 77, 2, 2, 40), (1, 24, 24, 6, 1, 16)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_reports_the_plain_versions_flops(shape):
    B, Sq, Sk, NH, KVH, D = shape
    q, k, v = _qkv(*shape)
    plain = _flops(lambda: fa.flash_attention_fwd_plain(q, k, v, causal=False))
    assert fa.FLOPS_PER_PAIR["fwd"] * D * tprof.attention_pairs(B, NH, Sq, Sk, False) == plain
    for q_offset, valid_k in ((0, None), (Sk - Sq if Sk > Sq else 0, None), (0, Sk - 3)):
        rows = q_offset + torch.arange(Sq)
        vis = (rows[:, None] >= torch.arange(Sk)[None, :]) & (torch.arange(Sk) < (
            Sk if valid_k is None else valid_k))[None, :]
        pairs = tprof.attention_pairs(B, NH, Sq, Sk, True, q_offset, valid_k)
        assert pairs == int(vis.sum()) * B * NH
        causal = _flops(lambda: fa.flash_attention_fwd_plain(q, k, v, causal=True,
                                                             q_offset=q_offset, valid_k=valid_k))
        assert fa.FLOPS_PER_PAIR["fwd"] * D * pairs == causal * pairs / (B * NH * Sq * Sk)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[1] == s[2]],
                         ids=lambda s: "x".join(map(str, s)))
def test_backward_reports_the_plain_versions_flops_plus_the_recompute(shape):
    B, S, _, NH, KVH, D = shape
    q, k, v = _qkv(*shape)
    for causal in (False, True):
        o, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        plain = _flops(lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, torch.ones_like(o),
                                                            causal=causal))
        full = B * NH * S * S
        pairs = fa._bwd_pairs(q, k, causal)
        reported = (fa.FLOPS_PER_PAIR["dq"] + fa.FLOPS_PER_PAIR["dkv"]) * D * pairs
        assert reported == (plain + 4 * D * full) * pairs / full


@pytest.mark.parametrize("which", ["fwd", "dx", "dw"])
def test_grouped_kernels_report_the_plain_versions_flops(which):
    P, H, F, E, rows = 12, 6, 10, 3, 4
    g = torch.Generator().manual_seed(1)
    x, dy = torch.randn(P, H, generator=g), torch.randn(P, F, generator=g)
    w, be = torch.randn(E, H, F, generator=g), torch.tensor([2, 0, 2], dtype=torch.int32)
    run = {"fwd": lambda: gm.grouped_matmul_plain(x, w, be, rows),
           "dx": lambda: gm.grouped_matmul_dx_plain(dy, w, be, rows),
           "dw": lambda: gm.grouped_matmul_dw_plain(x, dy, be, E, rows)}[which]
    assert gm.kernel_flops(P, H, F) == _flops(run)


@pytest.mark.parametrize("bits", [8, 4])
def test_wq_reports_the_plain_versions_flops(bits):
    M, K, N = 5, 256, 12
    g = torch.Generator().manual_seed(2)
    codes, scale = wq.quantize_weight(torch.randn(K, N, generator=g), bits=bits, group=128)
    x = torch.randn(M, K, generator=g)
    assert wq.kernel_flops(M, K, N) == _flops(
        lambda: wq.wq_matmul_plain(x, codes, scale, bits=bits, group=128))


SPARSE = {"fixed": lambda: sa.FixedSparsityConfig(num_heads=2, block=8, num_local_blocks=2,
                                                  num_global_blocks=1),
          "bigbird": lambda: sa.BigBirdSparsityConfig(num_heads=2, block=8)}


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("name", sorted(SPARSE))
def test_sparse_reports_the_plain_versions_flops_over_its_blocks(name, causal):
    B, S, H, D = 2, 64, 2, 16
    cfg = SPARSE[name]()
    q, k, v = (torch.randn(B, S, H, D, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    plain = _flops(lambda: sa.sparse_attention_plain(q, k, v, cfg, causal))
    layout = sa._layout(cfg, S, H)
    lay = torch.as_tensor(layout).expand(H, *layout.shape[1:])
    mask = torch.kron(lay, torch.ones(cfg.block, cfg.block, dtype=torch.int32)) > 0
    n_diag = 0
    if causal:
        mask = mask & torch.ones(S, S, dtype=torch.bool).tril()
        n_diag = int(torch.diagonal(lay, dim1=1, dim2=2).gt(0).sum())
    exact = plain * int(mask.sum()) / (H * S * S)
    assert sa.kernel_flops(layout, B, H, D, cfg.block, causal) == \
        exact - 4 * D * B * n_diag * cfg.block / 2


def test_evoformer_reports_the_plain_versions_flops_plus_the_recompute():
    B, S, Q, K, H, D = 1, 2, 10, 12, 2, 16
    g = torch.Generator().manual_seed(3)
    q = torch.randn(B, S, Q, H, D, generator=g)
    k, v = (torch.randn(B, S, K, H, D, generator=g) for _ in range(2))
    b1, b2 = torch.randn(B, S, K, generator=g), torch.randn(B, H, Q, K, generator=g)
    assert ev.kernel_flops(q, k, "fwd") == _flops(lambda: ev.evoformer_attn_fwd_plain(
        q, k, v, b1, b2))
    o, lse = ev.evoformer_attn_fwd_plain(q, k, v, b1, b2)
    do = torch.randn(o.shape, generator=g)
    plain = _flops(lambda: ev.evoformer_attn_bwd_plain(q, k, v, do, lse, ev._delta(o, do), b1,
                                                       b2))
    assert ev.kernel_flops(q, k, "dq") + ev.kernel_flops(q, k, "dkv") == \
        plain + 4 * D * B * S * H * Q * K


def test_count_flops_adds_reported_kernel_flops():
    with tprof.count_flops() as c:
        torch.ones(4, 8) @ torch.ones(8, 2)
        tprof.report_kernel_flops("k", 10.0)
        tprof.report_kernel_flops("k", 5.0)
    tprof.report_kernel_flops("k", 1e9)  # outside any count: dropped
    tprof.report_kernel_flops("k", lambda: 1 / 0)  # a deferred count is not even computed
    assert c.torch == 2 * 4 * 8 * 2 and c.kernels == {"k": 15.0} and c.total == 143.0
    with tprof.count_flops() as c:
        tprof.report_kernel_flops("k", lambda: 7.0)
    assert c.kernels == {"k": 7.0}


def test_profiling_leaves_the_steps_bit_equal():
    ds = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "gradient_clipping": 1.0, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    ids = np.random.RandomState(1).randint(0, 256, (2, 2, 33))
    runs = []
    for prof in (None, {"enabled": True, "profile_step": 1}):
        cfg = dict(ds, **({"flops_profiler": prof} if prof else {}))
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=tllama.llama_model("tiny", max_seq_len=32), config=cfg, device="cpu", seed=0)
        runs.append([float(eng.train_batch(ids)) for _ in range(4)])
        if prof:
            assert eng.flops_profiler.last_profile["step"] == 1
    assert runs[0] == runs[1]


def test_engine_profile_and_gauges():
    ds = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
          "flops_profiler": {"enabled": True, "profile_step": 1},
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    eng, *_ = deepspeed_tpu_torch.initialize(model=tllama.llama_model("tiny", max_seq_len=32),
                                            config=ds, device="cpu", seed=0)
    ids = np.random.RandomState(0).randint(0, 256, (2, 2, 17))
    for _ in range(3):
        eng.train_batch(ids)
    prof = eng.flops_profiler.last_profile
    assert prof["step"] == 1 and prof["micro_steps"] == 2
    assert prof["flops_per_micro_step"] == prof["torch_flops_per_micro_step"] > 0
    assert prof["kernel_flops_per_micro_step"] == {}  # the CPU runs the plain versions
    assert {r["module"] for r in prof["modules"]} >= {"embed", "lm_head"}
    # the blocks run all 17 tokens; the LM head only the 16 that predict one
    body = sum(r["flops"] for r in prof["modules"] if r["module"] != "lm_head")
    head = [r["flops"] for r in tprof.per_module_breakdown(
        eng.model.config, eng._compute, batch_size=2, seq_len=16) if r["module"] == "lm_head"]
    assert prof["flops_per_micro_step"] == 3 * (body + head[0])
    jprof.FlopsProfiler._publish(None, 1, 2.0, 3.0)
    jnames = {n for n in jreg.get_registry()._metrics if n.startswith("deepspeed_tpu_profile_")}
    tnames = {n for n in treg.get_registry()._metrics if n.startswith("deepspeed_tpu_profile_")}
    assert tnames == jnames == set(tprof.PROFILE_GAUGES)
    assert treg.get_registry().get("deepspeed_tpu_profile_flops_per_micro_step").value() == \
        prof["flops_per_micro_step"]
