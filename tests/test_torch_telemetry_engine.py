"""The serving engine's telemetry against the JAX engine's, end to end on
the CPU: a tiny llama (2 layers, fp32) served by the JAX package's
``InferenceEngineV2`` and by the port's with the same weights
(``params_from_numpy``) and the same requests, each into a fresh
registry, span ring, memory ledger and request-trace ledger.

Every counter, every gauge and every histogram count of the
``deepspeed_tpu_serving_*`` families (the KV-tier and request-trace ones
included) must be equal in the two registries, and the two registries
must hold the same set of family names; sums of seconds (and counters of
seconds) are timings and are not compared.  The mix: a pool small enough
to preempt, the prefix cache on with a repeated prefix, a bounded queue
that sheds, tiny ``slo_ttft_s`` / ``slo_tpot_s``, every request traced; one
case at ``decode_horizon`` 4, one with the n-gram proposer, one with a
host tier capped small."""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu.telemetry.memory as jmem
import deepspeed_tpu.telemetry.registry as jreg
import deepspeed_tpu.telemetry.reqtrace as jrt
import deepspeed_tpu.telemetry.spans as jspans
import deepspeed_tpu_torch.telemetry.memory as tmem
import deepspeed_tpu_torch.telemetry.registry as treg
import deepspeed_tpu_torch.telemetry.reqtrace as trt
import deepspeed_tpu_torch.telemetry.spans as tspans
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceConfig as JaxConfig
from deepspeed_tpu.inference.v2 import RaggedRequest as JaxRequest
from deepspeed_tpu.inference.v2.ragged import RejectedError as JaxRejected
from deepspeed_tpu.models.llama import llama_model as jax_llama
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, RaggedInferenceConfig,
                                              RaggedRequest, RejectedError)
from deepspeed_tpu_torch.models.llama import llama_model

torch.set_num_threads(2)

PS = 8
BASE = dict(dtype="fp32", page_size=PS, num_pages=14, max_seqs=3, max_pages_per_seq=10,
            enable_prefix_cache=True, max_queue_depth=4, slo_ttft_s=1e-9, slo_tpot_s=1e-9)
CASES = {
    "preempt_prefix": {},
    "horizon_4": {"decode_horizon": 4},
    "ngram": {"speculative": {"mode": "ngram", "k": 3}},
    "kv_tier": {"num_pages": 40, "prefix_cache_pages": 3,
                "kv_tier": {"enabled": True, "host_bytes": 6 * 2 * 2 * PS * 2 * 64 * 4}},
}


@pytest.fixture(scope="module")
def weights():
    jmodel = jax_llama("tiny", max_seq_len=128)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    return jmodel, params, jax.tree_util.tree_map(np.asarray, params)


_DEFAULTS = [(m, a) for pair in (
    (jreg, treg, "_default_registry"), (jspans, tspans, "_default_recorder"),
    (jmem, tmem, "_default_ledger"), (jrt, trt, "_default"),
    (jspans, tspans, "_phase_listener")) for m, a in ((pair[0], pair[2]), (pair[1], pair[2]))]


@pytest.fixture
def fresh():
    """Fresh process defaults in both packages, restored afterwards."""
    saved = [(m, a, getattr(m, a)) for m, a in _DEFAULTS]
    jreg.set_registry(jreg.MetricsRegistry())
    treg.set_registry(treg.MetricsRegistry())
    jspans.set_span_recorder(jspans.SpanRecorder())
    tspans.set_span_recorder(tspans.SpanRecorder())
    jmem.set_memory_ledger(None)
    tmem.set_memory_ledger(None)
    jrt.set_reqtrace_ledger(jrt.ReqTraceLedger())
    trt.set_reqtrace_ledger(trt.ReqTraceLedger())
    yield
    for m, a, v in saved:
        setattr(m, a, v)


def _waves(seed=5):
    """Three waves: a shared 2-page prefix in every prompt of the first
    two (the second repeats the first's prompts: full hits), five
    requests a wave against a queue bounded at four (one shed a wave),
    the third a wave of long generations that preempts."""
    rng = np.random.RandomState(seed)
    prefix = list(map(int, rng.randint(0, 256, 2 * PS)))
    first = [prefix + list(map(int, rng.randint(0, 256, n))) for n in (3, 9, 5, 12, 7)]
    third = [list(map(int, rng.randint(0, 256, n))) for n in (20, 6, 14, 11, 4)]
    return [(first, 6), (first, 6), (third, 24)]


def _drive(eng, request_cls, rejected_cls, ledger, waves, tag):
    streams = []
    for w, (prompts, gen) in enumerate(waves):
        got = {}
        for i, p in enumerate(prompts):
            tid = f"{tag}-{w}-{i}"
            ledger.begin(tid)
            try:
                uid = eng.put(request_cls(prompt_ids=p, max_new_tokens=gen, trace_id=tid))
                got[uid] = []
            except rejected_cls:
                ledger.finish(tid, "shed")
        while eng.has_work():
            for uid, rec in eng.step().items():
                got[uid] += rec["tokens"]
        streams.append([got[u] for u in sorted(got)])
    eng.cache_stats()  # forwards the cache counters' last deltas
    return streams


def _serving(reg):
    """{(sample name, labels): value} of the serving families: counters and
    gauges by value, histograms by count; seconds left out."""
    out = {}
    for m in reg.collect():
        if not m.name.startswith("deepspeed_tpu_serving_"):
            continue
        for sample, labels, value in m.samples():
            if m.type == "histogram" and not sample.endswith("_count"):
                continue
            if m.type != "histogram" and "seconds" in m.name:
                continue
            out[(sample, tuple(sorted(labels.items())))] = value
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_serving_registry_equals_the_jax_engines(weights, fresh, case):
    jmodel, jparams, npparams = weights
    cfg = dict(BASE, **CASES[case])
    waves = _waves()
    jeng = JaxEngine(jmodel, JaxConfig(**cfg), params=jparams)
    jstreams = _drive(jeng, JaxRequest, JaxRejected, jrt.get_reqtrace_ledger(), waves, "t")
    teng = InferenceEngineV2(llama_model("tiny", max_seq_len=128),
                             RaggedInferenceConfig.from_dict(dict(cfg)), params=npparams,
                             device="cpu")
    tstreams = _drive(teng, RaggedRequest, RejectedError, trt.get_reqtrace_ledger(), waves,
                      "t")
    assert tstreams == jstreams
    jreg_, treg_ = jreg.get_registry(), treg.get_registry()
    assert {m.name for m in treg_.collect()} == {m.name for m in jreg_.collect()}
    want, got = _serving(jreg_), _serving(treg_)
    assert got == want
    # the mix reached what it was built for
    assert got[("deepspeed_tpu_serving_slo_shed_total", (("priority", "1"),))] == 3
    n_req = got[("deepspeed_tpu_serving_requests_total", ())]
    assert got[("deepspeed_tpu_serving_slo_ttft_violations_total", ())] == n_req == 12
    assert got[("deepspeed_tpu_serving_prefix_hit_tokens_total", ())] > 0
    if case == "preempt_prefix":
        assert got[("deepspeed_tpu_serving_preemptions_total", ())] > 0
    if case == "kv_tier":
        assert got[("deepspeed_tpu_serving_kv_tier_restored_pages_total", ())] > 0
    teng.close()
