"""The port's telemetry modules against the JAX package's, on the CPU.

The same inputs, made from a numpy seed, go through both packages:

* registry and exporter: a seeded sequence of ``inc`` / ``set`` /
  ``observe`` gives byte-equal Prometheus text, equal ``snapshot_events``,
  equal parse round trips and equal histogram quantiles (exact); the JSONL
  records have the same keys; the HTTP exporter serves on port 0;
* spans: one begin / end / event sequence under a fixed clock gives equal
  Chrome-trace JSON; a flight dump after a serving step raises has the JAX
  dump's records and keys, and the exception propagates;
* timeline: ``categorize_op`` files the JAX package's op names as JAX does
  and the card's kernel names by the port's table; ``decompose_events``
  over 20 seeded random event lists equals JAX's within 1e-12; on the CPU
  a capture is host-only and says so;
* request traces: the same transitions under a fixed clock give equal
  ``summary()`` and ``phase_seconds()``; either package's wire snapshot is
  the other's byte for byte and is adopted by it, the phases still
  partitioning submit to now;
* the recompile sentinel: the JAX sentinel without ``jax.monitoring`` and
  the port's without its compile stream give equal counters on one
  signature stream with announced rebuilds; the port's stream counts one
  event per ``note_compile``; a tiny CPU engine compiles nothing;
* the memory ledger: equal tree bytes for the JAX params and the port's,
  equal attribution, residual, gauges, watermarks and OOM hints on a
  stubbed ``memory_stats``; an engine's ``close()`` detaches its
  components, and a dropped engine is collected without it;
* admission control: the same requests against the same fake fleets get
  the same admits, sheds, hints and shed counter."""

import gc
import json
import urllib.request
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.telemetry.compile_sentinel as jcs
import deepspeed_tpu.telemetry.exporter as jexp
import deepspeed_tpu.telemetry.flight as jflight
import deepspeed_tpu.telemetry.memory as jmem
import deepspeed_tpu.telemetry.registry as jreg
import deepspeed_tpu.telemetry.reqtrace as jrt
import deepspeed_tpu.telemetry.spans as jspans
import deepspeed_tpu.telemetry.timeline as jtl
import deepspeed_tpu_torch.telemetry.compile_sentinel as tcs
import deepspeed_tpu_torch.telemetry.exporter as texp
import deepspeed_tpu_torch.telemetry.flight as tflight
import deepspeed_tpu_torch.telemetry.memory as tmem
import deepspeed_tpu_torch.telemetry.registry as treg
import deepspeed_tpu_torch.telemetry.reqtrace as trt
import deepspeed_tpu_torch.telemetry.spans as tspans
import deepspeed_tpu_torch.telemetry.timeline as ttl
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import RaggedRequest as JaxRequest
from deepspeed_tpu.models.llama import llama_model as jax_llama
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, RaggedInferenceConfig,
                                              RaggedRequest)
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.models.llama import llama_model

torch.set_num_threads(2)

ENGINE = dict(dtype="fp32", page_size=8, num_pages=32, max_seqs=2, max_pages_per_seq=8)


@pytest.fixture(scope="module")
def weights():
    jmodel = jax_llama("tiny", max_seq_len=128)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    return jmodel, params, jax.tree_util.tree_map(np.asarray, params)


# ----------------------------- registry and exporter --------------------------
def _exercise(reg_mod, seed):
    """One seeded sequence of registrations and updates on a fresh registry."""
    rng = np.random.RandomState(seed)
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("deepspeed_tpu_test_requests_total", "requests", labelnames=("route",))
    g = reg.gauge("deepspeed_tpu_test_queue_depth", 'depth "now" per replica')
    h = reg.histogram("deepspeed_tpu_test_latency_seconds", "latency",
                      labelnames=("phase",))
    hb = reg.histogram("deepspeed_tpu_test_tokens", "tokens per step",
                       buckets=(1, 2, 4, 8, 16))
    reg.counter("deepspeed_tpu_test_idle_total", "never incremented")
    for _ in range(200):
        op = rng.randint(4)
        if op == 0:
            c.inc(float(rng.randint(1, 5)), route=["a", "b,c", 'q"x'][rng.randint(3)])
        elif op == 1:
            g.set(float(rng.randn() * 100.0))
        elif op == 2:
            h.observe(float(rng.exponential(0.05)), phase=["prefill", "decode"][rng.randint(2)])
        else:
            hb.observe(float(rng.randint(0, 40)))
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_and_exposition_equal_jax(seed):
    jr, tr = _exercise(jreg, seed), _exercise(treg, seed)
    jtext, ttext = jexp.to_prometheus_text(jr), texp.to_prometheus_text(tr)
    assert ttext.encode() == jtext.encode()
    assert tr.snapshot_events(7) == jr.snapshot_events(7)
    assert texp.parse_prometheus_text(ttext) == jexp.parse_prometheus_text(jtext)
    assert texp.parse_prometheus_text(jtext) == jexp.parse_prometheus_text(ttext)
    assert texp.snapshot_metrics(tr) == jexp.snapshot_metrics(jr)
    th, jh = tr.get("deepspeed_tpu_test_latency_seconds"), jr.get(
        "deepspeed_tpu_test_latency_seconds")
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
        for phase in ("prefill", "decode"):
            assert th.quantile(q, phase=phase) == jh.quantile(q, phase=phase)


def test_registry_refusals_equal_jax():
    for mod in (jreg, treg):
        reg = mod.MetricsRegistry()
        reg.counter("deepspeed_tpu_x_total")
        with pytest.raises(ValueError):
            reg.gauge("deepspeed_tpu_x_total")
        with pytest.raises(ValueError):
            reg.counter("not_namespaced")
        with pytest.raises(ValueError):
            reg.counter("deepspeed_tpu_x_total").inc(-1)


def test_jsonl_records_have_the_jax_keys(tmp_path):
    recs = {}
    for name, exp, reg_mod in (("jax", jexp, jreg), ("port", texp, treg)):
        w = exp.JSONLWriter(str(tmp_path / f"{name}.jsonl"))
        w.emit("admit", uid=3, slot=1)
        w.emit_snapshot(_exercise(reg_mod, 5), step=4)
        w.close()
        recs[name] = [json.loads(x) for x in open(tmp_path / f"{name}.jsonl")]
    assert [sorted(r) for r in recs["port"]] == [sorted(r) for r in recs["jax"]]
    assert recs["port"][1]["metrics"] == recs["jax"][1]["metrics"]


def test_http_exporter_serves_on_port_zero():
    reg = _exercise(treg, 3)
    ex = texp.PrometheusHTTPExporter(port=0, addr="127.0.0.1", registry=reg).start()
    try:
        assert ex.port > 0
        with urllib.request.urlopen(f"http://127.0.0.1:{ex.port}/metrics", timeout=10) as r:
            body = r.read().decode()
    finally:
        ex.close()
    assert body == texp.to_prometheus_text(reg)


# ----------------------------- spans and flight -------------------------------
def _clocked(monkeypatch, mod):
    ticks = iter(range(0, 10 ** 6, 7))
    monkeypatch.setattr(mod, "_now_us", lambda: float(next(ticks)))
    monkeypatch.setattr(mod, "_tid", lambda: 11)


def _span_script(mod):
    rec = mod.SpanRecorder()
    mod.set_span_recorder(rec)
    h = mod.begin_span("request", cat="serve", uid=1, prompt_tokens=9)
    with mod.span("prefill", uid=1, tokens=9):
        mod.record_event("admit", cat="serve", uid=1, slot=0)
    mod.record_event("preempt", cat="serve", uid=1, pages_used=3)
    with mod.span("decode", batch=2):
        pass
    mod.end_span(h, generated=4)
    mod.end_span(None)
    return mod.trace_dump(recorder=rec)


def test_span_trace_equals_jax_under_a_fixed_clock(monkeypatch):
    saved = (jspans._default_recorder, tspans._default_recorder)
    for mod in (jspans, tspans):
        _clocked(monkeypatch, mod)
    try:
        want, got = _span_script(jspans), _span_script(tspans)
    finally:
        jspans.set_span_recorder(saved[0])
        tspans.set_span_recorder(saved[1])
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert [e["name"] for e in got["traceEvents"]] == ["admit", "prefill", "preempt",
                                                       "decode", "request"]


def _flight_dump(eng, flight_mod, spans_mod, tmp_path, name):
    fr = flight_mod.FlightRecorder(path=str(tmp_path / name))
    flight_mod.install_flight_recorder(fr)

    def boom():
        raise RuntimeError("step failed on purpose")

    eng._step_impl = boom
    try:
        with pytest.raises(RuntimeError, match="on purpose"):
            eng.step()
    finally:
        flight_mod.install_flight_recorder(None)
    files = list((tmp_path / name).iterdir())
    assert len(files) == 1
    return [json.loads(x) for x in open(files[0])]


def test_flight_dump_after_a_failed_step_has_the_jax_records(weights, tmp_path, monkeypatch):
    jmodel, jparams, npparams = weights
    monkeypatch.setattr(jtl, "_last_record", None)
    monkeypatch.setattr(ttl, "_last_record", None)
    import deepspeed_tpu.telemetry.goodput as jgp
    import deepspeed_tpu.telemetry.numerics as jnum
    monkeypatch.setattr(jgp, "last_goodput_summary", lambda: None)
    monkeypatch.setattr(jnum, "last_numerics_summary", lambda: None)
    monkeypatch.setattr(jrt, "_default", jrt.ReqTraceLedger(jreg.MetricsRegistry()))
    monkeypatch.setattr(trt, "_default", trt.ReqTraceLedger(treg.MetricsRegistry()))
    jeng = JaxEngine(jmodel, JaxConfig(**ENGINE), params=jparams)
    jeng.generate_all([JaxRequest(prompt_ids=[1, 2, 3, 4], max_new_tokens=3)])
    teng = InferenceEngineV2(llama_model("tiny", max_seq_len=128),
                             RaggedInferenceConfig(**ENGINE), params=npparams, device="cpu")
    teng.generate_all([RaggedRequest(prompt_ids=[1, 2, 3, 4], max_new_tokens=3)])
    want = _flight_dump(jeng, jflight, jspans, tmp_path, "jax")
    got = _flight_dump(teng, tflight, tspans, tmp_path, "port")

    def shape(records):
        kinds = {}
        for r in records:
            kinds.setdefault(r["kind"], set()).update(r)
        return kinds

    assert shape(got) == shape(want)
    assert got[0]["reason"] == want[0]["reason"] == "exception:engine_v2.step"
    assert got[-1]["kind"] == "snapshot"
    teng.close()


# ----------------------------- timeline ---------------------------------------
JAX_OP_NAMES = ["all-reduce.17", "fusion.all_reduce.3", "all-gather-start", "reduce-scatter.2",
                "all-to-all.1", "collective-permute.9", "ppermute", "dot_general.5",
                "fusion.matmul", "custom-call.flash_attention", "softmax.12", "copy.4",
                "transpose.8", "dynamic-update-slice.2", "some_op_nobody_has_heard_of",
                "fusion.dot.all-reduce.1"]

CARD_KERNELS = {
    "void flash_fwd_wgmma_kernel<__nv_bfloat16, 64, true>(FlashParams)": "attention",
    "void paged_decode_kernel<__nv_bfloat16, 64, 8>(PagedParams)": "attention",
    "paged_merge_wide_kernel": "attention",
    "void sparse_attn_wgmma_kernel<64>(SparseParams)": "attention",
    "evo_fwd_wgmma_kernel": "attention",
    "flash_bwd_dkv_wgmma_kernel<__nv_bfloat16, 64, false, true>": "attention",
    "void gmm_wgmma_kernel<__nv_bfloat16>(GmmParams)": "gemm",
    "gmm_dw_wgmma_kernel": "gemm",
    "void wq_wgmma_kernel<8>(WqParams)": "gemm",
    "nvjet_tst_128x64_64x8_1x1_v_bz_TNT": "gemm",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "gemm",
    "cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_32x6_tn_align8": "gemm",
    "Memcpy DtoD (Device -> Device)": "copy",
    "Memcpy HtoD (Pinned -> Device)": "copy",
    "Memset (Device)": "copy",
    "ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage<4096ul>)": "all_reduce",
    "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL": "reduce_scatter",
    "ncclDevKernel_AllGather_RING_LL": "all_gather",
    "ncclDevKernel_SendRecv": "collective_permute",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>":
        "other_compute",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, MeanOps>>":
        "other_compute",
}


@pytest.mark.parametrize("name", JAX_OP_NAMES)
def test_categorize_op_files_jax_names_as_jax(name):
    assert ttl.categorize_op(name) == jtl.categorize_op(name)


@pytest.mark.parametrize("name", sorted(CARD_KERNELS))
def test_categorize_op_files_the_cards_kernels(name):
    assert ttl.categorize_op(name) == CARD_KERNELS[name]


NAMES = ["dot.1", "fusion.matmul.2", "flash_attention.3", "copy.4", "all-reduce.5",
         "all-gather.6", "reduce-scatter.7", "all-to-all.8", "collective-permute.9",
         "misc.10"]


@pytest.mark.parametrize("seed", range(20))
def test_decompose_events_equals_jax(seed):
    """Random event lists: overlapping compute and collectives, zero and
    negative durations, walls shorter than the busy time (clock skew), a
    pipe-bubble fraction."""
    rng = np.random.RandomState(seed)
    events = [{"name": NAMES[rng.randint(len(NAMES))], "ts": float(rng.uniform(0, 1.0)),
               "dur": float(rng.choice([0.0, -0.01, rng.exponential(0.05)]))}
              for _ in range(rng.randint(1, 60))]
    wall = float(rng.choice([rng.uniform(0.2, 0.6), rng.uniform(1.0, 2.0)]))
    bubble = float(rng.choice([0.0, rng.uniform(0.0, 0.5)]))
    want = jtl.decompose_events(events, wall, pipe_bubble_fraction=bubble)
    got = ttl.decompose_events(events, wall, pipe_bubble_fraction=bubble)
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            assert set(got[key]) == set(want[key])
            for c in want[key]:
                assert got[key][c] == pytest.approx(want[key][c], abs=1e-12, rel=0)
        else:
            assert got[key] == pytest.approx(want[key], abs=1e-12, rel=0)
    assert sum(got["categories"].values()) == pytest.approx(wall, abs=1e-9)


def test_capture_thunk_on_the_cpu_is_host_only_and_says_so(tmp_path):
    tl = ttl.StepTimeline(every_n_steps=0, artifact_dir=str(tmp_path / "art"),
                          registry=treg.MetricsRegistry(), device="cpu")

    def work():
        with tspans.span("timeline_test_work"):
            return float((torch.ones(64, 64) @ torch.ones(64, 64)).sum())

    out, rec = ttl.capture_thunk(work, step=5, timeline=tl)
    assert out == 64.0 ** 3 and rec["step"] == 5
    assert rec["measured"] is False and "kernels" not in rec
    cats = rec["categories"]
    assert sum(cats.values()) == pytest.approx(rec["wall_seconds"], abs=1e-9)
    assert cats["host_compute"] > 0  # the span covers the work
    trace = json.load(open(rec["artifact"]))
    assert any(e.get("name") == "timeline_test_work" for e in trace["traceEvents"])


def test_capture_skips_while_another_profiler_runs(tmp_path):
    tl = ttl.StepTimeline(every_n_steps=0, registry=treg.MetricsRegistry(), device="cpu")
    tl.force_next()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with tl.capture(1):
            pass
    assert tl.last_record() is None and tl.should_capture(2)  # still armed
    with tl.capture(2):
        pass
    assert tl.last_record()["step"] == 2


def _chrome_trace(tmp_path, with_window=True):
    """A Chrome trace in ``torch.profiler``'s layout: the step's
    ``record_function`` window (1000..1100 us), B and A kernels, a cuBLAS
    GEMM, a memset, an elementwise kernel, a CPU op, and a kernel of an
    earlier step straddling the window's start."""
    ev = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 7, "tid": 7, "ts": 1001,
           "dur": 5}]
    if with_window:
        ev.append({"ph": "X", "cat": "user_annotation", "name": ttl.TIMELINE_RANGE, "pid": 7,
                   "tid": 7, "ts": 1000.0, "dur": 100.0})
    for i in range(16):
        ev.append({"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 1010.0 + i,
                   "dur": 0.5, "name": "void paged_decode_kernel<__nv_bfloat16, 64, 8>"})
    ev += [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 1040.0, "dur": 10.0,
            "name": "nvjet_tst_64x8_64x16_4x1_v_bz_NNT"},
           {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 7, "ts": 1052.0, "dur": 2.0,
            "name": "Memset (Device)"},
           {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 1060.0, "dur": 4.0,
            "name": "void at::native::vectorized_elementwise_kernel<4, silu>"},
           {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 990.0, "dur": 20.0,
            "name": "void flash_fwd_wgmma_kernel<__nv_bfloat16, 64, true>"},
           {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7, "ts": 1000.0,
            "dur": 90.0, "name": "decode"}]
    (tmp_path / "trace").mkdir()
    (tmp_path / "trace" / "torch_trace.json").write_text(json.dumps({"traceEvents": ev}))
    return str(tmp_path / "trace")


def test_a_cuda_record_reads_the_profilers_trace(tmp_path):
    """The record a capture on the card publishes, from a trace in
    ``torch.profiler``'s layout: the window's wall, kernels clipped to it,
    categories summing to it, the kernel table; annotations and CPU ops
    are not device work."""
    reg = treg.MetricsRegistry()
    tl = ttl.StepTimeline(registry=reg, artifact_dir=str(tmp_path / "art"), device="cuda")
    tl._finish(3, 0.5, 0.0, 100.0, _chrome_trace(tmp_path), None, 0.0)
    rec = tl.last_record()
    assert rec["measured"] is True and rec["wall_seconds"] == pytest.approx(100e-6)
    cats = rec["categories"]
    assert sum(cats.values()) == pytest.approx(rec["wall_seconds"], rel=1e-9)
    assert cats["attention"] == pytest.approx(18e-6)  # 16 x 0.5 us B + 10 us of A
    assert cats["gemm"] == pytest.approx(10e-6) and cats["copy"] == pytest.approx(2e-6)
    assert cats["other_compute"] == pytest.approx(4e-6)
    k = rec["kernels"]
    paged = k["void paged_decode_kernel<__nv_bfloat16, 64, 8>"]
    assert paged["launches"] == 16 and paged["category"] == "attention"
    assert k["void flash_fwd_wgmma_kernel<__nv_bfloat16, 64, true>"]["seconds"] == \
        pytest.approx(10e-6)
    assert "decode" not in k and "aten::mm" not in k
    assert reg.get("deepspeed_tpu_timeline_captures_total").value(measured="true") == 1
    art = json.load(open(rec["artifact"]))
    assert any(e.get("name") == "nvjet_tst_64x8_64x16_4x1_v_bz_NNT" for e in art["traceEvents"])


def test_a_kernel_launched_in_the_window_is_the_steps_wherever_its_clock_puts_it(tmp_path):
    """Kernels carry their launch call's correlation id: one launched in
    the window counts whole even when the device clock's conversion put
    it outside the window (here 1.8 ms early and 3 ms late, as seen on an
    H100), while one launched before the window counts only for its part
    inside it."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": ttl.TIMELINE_RANGE, "pid": 7,
           "tid": 7, "ts": 10000.0, "dur": 100.0}]
    kernels = [(1, 10005.0, 8200.0, "early"),   # launched in window, shifted early
               (2, 10020.0, 10030.0, "inside"),
               (3, 10090.0, 13100.0, "late"),   # launched in window, shifted late
               (4, 9950.0, 9990.0, "earlier_step")]  # launched before, straddles
    for corr, launch, ts, name in kernels:
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 7,
                   "tid": 7, "ts": launch, "dur": 2.0, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": ts, "dur": 20.0,
                   "name": f"void paged_decode_{name}", "args": {"correlation": corr}})
    (tmp_path / "trace").mkdir()
    (tmp_path / "trace" / "torch_trace.json").write_text(json.dumps({"traceEvents": ev}))
    tl = ttl.StepTimeline(registry=treg.MetricsRegistry(), device="cuda")
    tl._finish(5, 0.5, 0.0, 100.0, str(tmp_path / "trace"), None, 0.0)
    rec = tl.last_record()
    k = rec["kernels"]
    assert {n: r["launches"] for n, r in k.items()} == {
        "void paged_decode_early": 1, "void paged_decode_inside": 1,
        "void paged_decode_late": 1, "void paged_decode_earlier_step": 1}
    for name in ("early", "inside", "late"):
        assert k[f"void paged_decode_{name}"]["seconds"] == pytest.approx(20e-6)
    assert rec["events_outside_window"] == 2
    assert k["void paged_decode_earlier_step"]["seconds"] == pytest.approx(10e-6)
    # 70 us of device work in a 100 us wall: the categories still sum to it
    assert sum(rec["categories"].values()) == pytest.approx(100e-6, rel=1e-9)
    assert rec["categories"]["attention"] == pytest.approx(70e-6)


def test_a_cuda_capture_without_device_events_raises(tmp_path):
    tl = ttl.StepTimeline(registry=treg.MetricsRegistry(), device="cuda")
    with pytest.raises(ttl.DeviceTraceMissing):
        tl._finish(1, 0.5, 0.0, 100.0, _chrome_trace(tmp_path, with_window=False), None, 0.0)
    assert tl.last_record() is None


# ----------------------------- request traces ---------------------------------
def _trace_script(mod):
    led = mod.ReqTraceLedger(registry=(jreg if mod is jrt else treg).MetricsRegistry())
    t = 100.0
    a = led.begin("req-a", uid=1, priority=0)
    b = led.begin("req-b", uid=2, priority=1)
    for tr in (a, b):
        tr.submit_t = t
        tr._open = ("queue_wait", "router", t)
    a.transition("prefill", "r0", now=t + 0.5)
    a.note_first_token(now=t + 0.75)
    a.transition("decode", "r0", now=t + 0.75)
    b.transition("prefill", "r1", now=t + 0.25)
    b.note_preempt("r1", now=t + 1.0)
    b.transition("prefill", "r1", now=t + 1.5)
    b.transition("kv_transfer", "r1", now=t + 2.0)
    b.transition("decode", "r2", now=t + 2.125)
    a.finish("complete", now=t + 3.0)
    led._open.pop("req-a")
    led._done.append(a)
    led.record_exemplar("deepspeed_tpu_serving_slo_ttft_violations_total", "req-a", uid=1)
    return led, a, b


def test_reqtrace_summaries_equal_jax():
    (jl, ja, jb), (tl, ta, tb) = _trace_script(jrt), _trace_script(trt)
    assert ta.phase_seconds() == ja.phase_seconds()
    assert ta.summary() == ja.summary()
    assert tl.summary() == jl.summary()
    assert tl.exemplars() == jl.exemplars()
    assert sum(ta.phase_seconds().values()) == pytest.approx(ta.elapsed_s(), abs=1e-12)


@pytest.mark.parametrize("sender,receiver", [(jrt, trt), (trt, jrt)],
                         ids=["jax_to_port", "port_to_jax"])
def test_reqtrace_wire_snapshot_crosses_packages(sender, receiver):
    (_, _, jb), (_, _, tb) = _trace_script(jrt), _trace_script(trt)
    tb._open = jb._open = ("decode", "r2", 102.125)
    wj, wt = jb.wire_snapshot(), tb.wire_snapshot()
    wj["elapsed_s"] = wt["elapsed_s"] = 2.5  # the clocks' "now" differ
    assert json.dumps(wt, sort_keys=True).encode() == json.dumps(wj, sort_keys=True).encode()
    snap = (wj if sender is jrt else wt)
    led = receiver.ReqTraceLedger(registry=(jreg if receiver is jrt else treg).MetricsRegistry())
    tr = led.adopt(json.loads(json.dumps(snap)), transit_s=0.25)
    assert tr.trace_id == "req-b" and tr.preempted and led.get("req-b") is tr
    tr.transition("decode", "r3")  # the importing engine takes the request on
    tr.finish("complete")
    phases = tr.phase_seconds()
    # the intervals tile submit..finish but for the instant between the
    # adoption and the importing engine's transition
    assert sum(phases.values()) == pytest.approx(tr.elapsed_s(), abs=1e-3)
    assert phases["kv_transfer"] >= 0.25 + 0.125 - 1e-9
    assert phases["recompute"] == pytest.approx(0.5, abs=1e-9)


# ----------------------------- recompile sentinel -----------------------------
def _sentinel_stream(mod, seed):
    s = mod.RecompileSentinel(loop="serve", registry=(jreg if mod is jcs else treg)
                              .MetricsRegistry(), steady_after=2)
    s.monitoring = False
    rng = np.random.RandomState(seed)
    parts = [("prefill", 16), ("prefill", 32), "decode", ("multi_decode", 4), "copy_page",
             ("kv_spill", 2)]
    seen = []
    for step in range(60):
        if rng.rand() < 0.1:
            s.expect_recompile("announced")
        sig = frozenset(parts[i] for i in rng.choice(len(parts), rng.randint(1, 4)))
        seen.append(s.observe_step(sig, step=step))
    return seen, s.recompiles, s.steady_recompiles


@pytest.mark.parametrize("seed", [0, 1])
def test_sentinel_fallback_counters_equal_jax(seed):
    assert _sentinel_stream(tcs, seed) == _sentinel_stream(jcs, seed)


def test_sentinel_counts_note_compile_events(monkeypatch):
    saved = treg.get_registry()
    reg = treg.MetricsRegistry()
    treg.set_registry(reg)
    try:
        s = tcs.RecompileSentinel(loop="t", registry=reg, steady_after=1)
        s.observe_step(["decode"], step=0)  # claims whatever came before
        n0, _ = tcs.compile_counts()
        for _ in range(3):
            tcs.note_compile("cuda_graph", 0.125)
        assert tcs.compile_counts()[0] == n0 + 3
        assert s.observe_step(["decode", ("multi", 4)], step=1)  # new part: expected
        assert s.recompiles == 1 and s.steady_recompiles == 0
        assert not s.observe_step(["decode"], step=2)
        assert not s.observe_step(["decode"], step=3)
        tcs.note_compile("nvcc", 2.0)  # on unchanged parts, past steady_after
        assert s.observe_step(["decode"], step=4)
        assert s.recompiles == 2 and s.steady_recompiles == 1
        assert reg.get("deepspeed_tpu_compiles_total").value() == 4
        assert reg.get("deepspeed_tpu_compile_seconds").count() == 4
    finally:
        treg.set_registry(saved)


def test_a_cpu_engine_compiles_nothing(weights):
    n0 = tcs.compile_counts()[0]
    eng = InferenceEngineV2(llama_model("tiny", max_seq_len=128),
                            RaggedInferenceConfig(**dict(ENGINE, decode_horizon=4)),
                            params=weights[2], device="cpu")
    eng.generate_all([RaggedRequest(prompt_ids=[5, 6, 7, 8, 9], max_new_tokens=9)
                      for _ in range(3)])
    assert tcs.compile_counts()[0] == n0
    assert eng._sentinel.recompiles == 0 and eng._sentinel.steady_recompiles == 0
    eng.close()


# ----------------------------- memory ledger ----------------------------------
def test_tree_bytes_of_the_params_equal_jax(weights):
    jmodel, jparams, npparams = weights
    tparams = params_from_numpy(npparams, llama_model("tiny", max_seq_len=128).config,
                                "cpu", torch.float32)
    want = jmem.tree_bytes(jparams)
    assert tmem.tree_bytes(tparams) == want and want[0] > 0
    assert tmem.tree_bytes({"device": 5, "host": 7}) == jmem.tree_bytes({"device": 5,
                                                                        "host": 7})
    assert tmem.tree_bytes([np.zeros(10, np.float32), None, 3]) == (0, 40)


class _Stats:
    """A stubbed accelerator: occupancy climbs by 1 MiB a reading."""

    def __init__(self):
        self.n = 0

    def memory_stats(self):
        self.n += 1
        return {"bytes_in_use": (40 + self.n) << 20, "peak_bytes_in_use": (60 + 2 * self.n) << 20,
                "bytes_limit": 80 << 30}


def _ledger_script(mem, reg_mod, spans_mod, arrays):
    reg = reg_mod.MetricsRegistry()
    led = mem.MemoryLedger(registry=reg, accelerator=_Stats())
    saved = spans_mod.get_phase_listener()
    led.install_phase_watch()
    try:
        led.attach("serving_params", lambda: arrays["params"])
        led.attach("kv_pool", lambda: arrays["pool"])
        led.attach("kv_prefix_pinned", lambda: {"device": 3 << 20}, informational=True)
        led.attach("kv_host_tier", lambda: {"host": 5 << 20})
        led.update_context(kv_quant=False, kv_num_pages=64)
        with spans_mod.span("prefill"):
            pass
        with spans_mod.span("decode"):
            pass
        spans_mod.record_event("decode")
        report = led.publish()
        led.detach("kv_host_tier")
        after = led.collect()
    finally:
        spans_mod.set_phase_listener(saved)
    report.pop("ts")
    after.pop("ts")
    return reg, report, after, mem.oom_hints(led.context, report)


def test_ledger_attribution_and_watermarks_equal_jax():
    rng = np.random.RandomState(0)
    params = [rng.randn(64, 32).astype(np.float32), rng.randn(32).astype(np.float32)]
    pool = {"k": np.zeros((2, 9, 8, 2, 16), np.float32), "v": np.zeros((2, 9, 8, 2, 16),
                                                                      np.float32)}
    jreg_, jrep, jafter, jhints = _ledger_script(jmem, jreg, jspans, {
        "params": [jnp.asarray(p) for p in params],
        "pool": {k: jnp.asarray(v) for k, v in pool.items()}})
    treg_, trep, tafter, thints = _ledger_script(tmem, treg, tspans, {
        "params": [torch.from_numpy(p) for p in params],
        "pool": {k: torch.from_numpy(v) for k, v in pool.items()}})
    assert trep == jrep and tafter == jafter and thints == jhints
    assert trep["unattributed_bytes"] == trep["bytes_in_use"] - trep["attributed_device_bytes"]
    assert set(trep["watermarks"]) == {"prefill", "decode"}
    assert texp.to_prometheus_text(treg_) == jexp.to_prometheus_text(jreg_)


def test_engine_close_detaches_and_a_dropped_engine_is_collected(weights, monkeypatch):
    monkeypatch.setattr(tmem, "_default_ledger", tmem.MemoryLedger(treg.MetricsRegistry()))
    monkeypatch.setattr(tspans, "_phase_listener", None)
    led = tmem.get_memory_ledger()
    cfg = dict(ENGINE, enable_prefix_cache=True, kv_tier={"enabled": True})
    eng = InferenceEngineV2(llama_model("tiny", max_seq_len=128),
                            RaggedInferenceConfig.from_dict(cfg), params=weights[2],
                            device="cpu")
    eng.generate_all([RaggedRequest(prompt_ids=list(range(1, 20)), max_new_tokens=4)])
    rep = led.collect()
    params_b = sum(p.numel() * p.element_size() for p in eng.params.parameters())
    pool_b = sum(t.numel() * t.element_size() for t in eng._pools.values())
    assert rep["components"]["serving_params"]["device"] == params_b == eng.param_bytes
    assert rep["components"]["kv_pool"]["device"] == pool_b
    assert rep["components"]["kv_prefix_pinned"]["informational"]
    assert sorted(led.collect()["components"]) == ["kv_host_tier", "kv_pool",
                                                   "kv_prefix_pinned", "serving_params"]
    assert {"prefill", "decode"} <= set(led.watermarks())
    eng.close()
    assert led.collect()["components"] == {}
    # a newer engine's components survive an older engine's close()
    old = InferenceEngineV2(llama_model("tiny", max_seq_len=128),
                            RaggedInferenceConfig(**ENGINE), params=weights[2], device="cpu")
    new = InferenceEngineV2(llama_model("tiny", max_seq_len=128),
                            RaggedInferenceConfig(**ENGINE), params=weights[2], device="cpu")
    old.close()
    assert sorted(led.collect()["components"]) == ["kv_pool", "kv_prefix_pinned", "serving_params"]
    assert led.collect()["components"]["kv_pool"]["device"] == pool_b
    # dropped without close(): the ledger does not keep it alive
    ref = weakref.ref(new)
    del new
    gc.collect()
    assert ref() is None
    assert led.collect()["components"]["serving_params"]["device"] == 0


def test_oom_is_recognised_as_in_jax():
    for exc in (MemoryError("kv pool"), RuntimeError("CUDA out of memory. Tried"),
                RuntimeError("RESOURCE_EXHAUSTED: hbm")):
        assert tmem.is_resource_exhausted(exc) and jmem.is_resource_exhausted(exc)
    assert tmem.is_resource_exhausted(torch.cuda.OutOfMemoryError("card"))
    assert not tmem.is_resource_exhausted(ValueError("shape"))


# ----------------------------- admission --------------------------------------
def _fleet(queued, free, num=64, ps=16):
    from types import SimpleNamespace as NS

    return [NS(engine=NS(queue_depth=q, block=NS(page_size=ps),
                         allocator=NS(free_pages=f, num_pages=num)))
            for q, f in zip(queued, free)]


@pytest.mark.parametrize("seed", range(4))
def test_admission_decisions_and_sheds_equal_jax(seed, monkeypatch):
    """The same seeded requests against the same fake fleets: the same
    admits, the same sheds with the same reasons and hints, and the same
    shed counter in each package's registry."""
    from types import SimpleNamespace as NS

    import deepspeed_tpu.serving.admission as jadm
    from deepspeed_tpu.inference.v2.ragged import RejectedError as JRejected

    import deepspeed_tpu_torch.serving.admission as tadm
    from deepspeed_tpu_torch.inference.v2.ragged import RejectedError as TRejected

    monkeypatch.setattr(jreg, "_default_registry", jreg.MetricsRegistry())
    monkeypatch.setattr(treg, "_default_registry", treg.MetricsRegistry())
    rng = np.random.RandomState(seed)
    cfg = NS(protect_priority=0, max_queue_depth=int(rng.randint(4, 12)),
             shed_occupancy=float(rng.uniform(0.6, 1.0)))
    outcomes = {}
    for name, adm, rejected in (("jax", jadm, JRejected), ("port", tadm, TRejected)):
        ctl = adm.AdmissionController(cfg)
        r = np.random.RandomState(seed + 100)
        got = []
        for i in range(40):
            fleet = _fleet(r.randint(0, 6, 3), r.randint(0, 64, 3))
            req = NS(prompt_ids=[0] * int(r.randint(1, 600)), max_new_tokens=int(r.randint(1, 256)),
                     priority=int(r.randint(0, 3)), uid=i, trace_id=f"t{i}")
            try:
                got.append(("admit", ctl.check(req, fleet)))
            except rejected as e:
                got.append(("shed", e.reason, e.retry_after_s, e.priority))
        outcomes[name] = got
    assert outcomes["port"] == outcomes["jax"]
    assert any(o[0] == "shed" for o in outcomes["port"])
    assert texp.to_prometheus_text(treg.get_registry()) == jexp.to_prometheus_text(
        jreg.get_registry())
    for q, pages in ((0, 0), (10, 5), (10 ** 6, 10 ** 6)):
        assert tadm.retry_after_hint(q, pages) == jadm.retry_after_hint(q, pages)
    assert tadm.estimate_pages(33, 16, 16) == jadm.estimate_pages(33, 16, 16) == 4
