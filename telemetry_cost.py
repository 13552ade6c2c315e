#!/usr/bin/env python3
"""Where the serving telemetry's host time goes, on one NVIDIA GPU.

    python3 telemetry_cost.py

llama-1b at full width and depth (bf16, seeded random weights, pages of
16, 576 pages, 8 slots) served by two engines on the same weights: one
with every instrument on (the recompile sentinel, the memory ledger and
its phase watch, the span ring, SLO limits of 1 us), one with them off.
With every slot decoding (64-token prompts), the median wall time of a
decode step is taken over ``STEPS`` steps for each variant below, in
``ROUNDS`` rounds of turns: ``off``; ``on``; ``on`` without the phase
watch; ``on`` without the span ring.  Before that, the per-call cost of
the reads the instruments make on a decode step's path.  One JSON line
per measurement, then the card's name and power limit.  Needs CUDA and
``nvcc``; builds the two kernels of the serving path at first use.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import torch

STEPS = 120
ROUNDS = 3
CALLS = 2000


def per_call_us(fn, calls: int = CALLS) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def decode_medians(eng, prompts, steps: int = STEPS) -> float:
    """Median wall ms of ``steps`` engine steps with every slot decoding."""
    from deepspeed_tpu_torch.inference.v2 import RaggedRequest

    for p in prompts:
        eng.put(RaggedRequest(prompt_ids=p, max_new_tokens=steps + 4))
    for _ in range(2):  # the prefills, the first decode
        eng.step()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        eng.step()
        walls.append(time.perf_counter() - t0)
    while eng.has_work():
        eng.step()
    return statistics.median(walls) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("telemetry_cost: no CUDA device", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch import accelerator
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedInferenceConfig
    from deepspeed_tpu_torch.models.llama import llama_model
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.telemetry import (MetricsRegistry, PhaseTimer, RecompileSentinel,
                                               configure_spans, get_memory_ledger)

    op_builder.build(["flash_attention_fwd", "paged_attention"])
    dev = accelerator.default_device()
    x = torch.ones(1, device=dev)
    del x
    sentinel = RecompileSentinel(loop="cost", registry=MetricsRegistry())
    parts = frozenset(["decode"])
    reads = {
        "threading_get_native_id": per_call_us(threading.get_native_id),
        "accelerator_memory_counters": per_call_us(lambda: accelerator.memory_counters(dev)),
        "torch_cuda_memory_allocated": per_call_us(torch.cuda.memory_allocated),
        "accelerator_memory_stats": per_call_us(lambda: accelerator.memory_stats(dev)),
        "sentinel_observe_step": per_call_us(lambda: sentinel.observe_step(parts)),
    }
    for spans_on in (False, True):
        configure_spans(enabled=spans_on)

        def phase():
            with PhaseTimer("cost_probe"):
                pass
        reads[f"phase_timer_spans_{'on' if spans_on else 'off'}"] = per_call_us(phase)
    print(json.dumps({"per_call_us": reads}))

    model = llama_model("1b", max_seq_len=2048)
    base = dict(dtype="bf16", page_size=16, max_seqs=8, max_pages_per_seq=64, num_pages=576)
    off = InferenceEngineV2(model, RaggedInferenceConfig.from_dict(dict(
        base, recompile_sentinel=False, memory_ledger=False)), seed=0)
    on = InferenceEngineV2(model, RaggedInferenceConfig.from_dict(dict(
        base, slo_ttft_s=1e-6, slo_tpot_s=1e-6)), params=off.params, seed=0)
    led = get_memory_ledger()
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, model.config.vocab_size, (64,), generator=g).tolist()
               for _ in range(base["max_seqs"])]
    variants = {"off": (off, False, False), "on": (on, True, True),
                "on_no_phase_watch": (on, True, False), "on_no_spans": (on, False, True)}
    medians = {name: [] for name in variants}
    for r in range(ROUNDS):
        order = list(variants) if r % 2 == 0 else list(reversed(variants))
        for name in order:
            eng, spans_on, watch_on = variants[name]
            configure_spans(enabled=spans_on)
            if watch_on:
                led.install_phase_watch()
            else:
                led.uninstall_phase_watch()
            medians[name].append(decode_medians(eng, prompts))
    configure_spans(enabled=True)
    out = {name: {"rounds_ms": m, "median_ms": statistics.median(m)}
           for name, m in medians.items()}
    off_ms = out["off"]["median_ms"]
    for name in out:
        out[name]["ratio_to_off"] = out[name]["median_ms"] / off_ms
    print(json.dumps({"decode_step_wall": out, "steps": STEPS, "rounds": ROUNDS,
                      "slots": base["max_seqs"]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
