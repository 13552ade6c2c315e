#!/usr/bin/env python3
"""Whether the serving step timeline counts every kernel of a captured step,
on one NVIDIA GPU.

    python3 timeline_clock_check.py [WAVES]

llama-1b at full width and depth (bf16, seeded random weights, pages of
16, 576 pages, 8 slots) served with the step timeline on every step, in
WAVES waves (default 6) of 12 requests (lengths 16, 900 and ten drawn
from 17..899, 24 new tokens each).  For every capture the engine's own
counts give what the record's kernel table must hold: kernel A (flash
forward) 16 times per prefill call and kernel B (paged decode) 16 times
per decode body.  One JSON line per wave: the captures; the records whose
table disagrees (``bad``); how many records a clip on the device clock
alone (each event's part inside the step window) would have got wrong
(``bad_by_device_clock``); the captures and events that the device clock
placed outside the window although their launch lay inside it; the least
time from a launch call to its kernel's start (negative when the clocks
disagree); and the profiler's own records of kernels A and B that are
not a multiple of 16 (events it dropped).  Then the card's name and power
limit.  Needs CUDA and ``nvcc``; builds the serving path's two kernels at
first use.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time

import torch

WAVES = 6


def main() -> int:
    if not torch.cuda.is_available():
        print("timeline_clock_check: no CUDA device", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, RaggedInferenceConfig,
                                                  RaggedRequest)
    from deepspeed_tpu_torch.models.llama import llama_model
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.telemetry import timeline as ttl

    waves = int(sys.argv[1]) if len(sys.argv) > 1 else WAVES
    op_builder.build(["flash_attention_fwd", "paged_attention"])
    model = llama_model("1b", max_seq_len=2048)
    L = model.config.n_layers
    traces = []  # per capture: the parsed events, the window, the least launch lag
    parse = ttl._device_trace_events

    def traced(log_dir):
        events, artifact, window = parse(log_dir)
        path = sorted(glob.glob(os.path.join(log_dir, "**", "*.json"), recursive=True))[-1]
        with open(path) as f:
            chrome = json.load(f)["traceEvents"]
        launched = {ev["args"]["correlation"]: float(ev["ts"]) for ev in chrome
                    if ev.get("ph") == "X" and ev.get("cat") in ttl._LAUNCH_CATS
                    and "correlation" in (ev.get("args") or {})}
        lags = [float(ev["ts"]) - launched[ev["args"]["correlation"]] for ev in chrome
                if ev.get("ph") == "X" and ev.get("cat") == "kernel"
                and (ev.get("args") or {}).get("correlation") in launched]
        traces.append((events, window, min(lags) if lags else None))
        return events, artifact, window

    ttl._device_trace_events = traced
    base = dict(dtype="bf16", page_size=16, max_seqs=8, max_pages_per_seq=64, num_pages=576)
    eng = InferenceEngineV2(model, RaggedInferenceConfig.from_dict(dict(
        base, timeline_every_n_steps=1)), seed=0)
    rng = torch.Generator().manual_seed(1234)
    for wave in range(waves):
        traces.clear()
        lengths = [16, 900] + torch.randint(17, 900, (10,), generator=rng).tolist()
        for n in lengths:
            eng.put(RaggedRequest(prompt_ids=torch.randint(
                0, model.config.vocab_size, (n,), generator=rng).tolist(), max_new_tokens=24))
        t0 = time.perf_counter()
        bad, bad_device_clock, shifted, dropped, lags = [], 0, [], [], []
        last = eng.timeline_record()
        while eng.has_work():
            before = eng.stats()
            eng.step()
            after = eng.stats()
            rec = eng.timeline_record()
            if rec is None or (last is not None and rec["ts"] == last["ts"]):
                continue
            last = rec
            want = {"flash_fwd": L * (after["prefill_calls"] + after["prefill_chunk_calls"]
                                      - before["prefill_calls"] - before["prefill_chunk_calls"]),
                    "paged_decode": L * (after["decode_device_steps"]
                                         - before["decode_device_steps"])}
            got = {f: sum(r["launches"] for n, r in rec["kernels"].items() if f in n)
                   for f in want}
            if got != want:
                bad.append({"step": rec["step"], "got": got, "want": want})
            events, window, lag = traces[-1]
            w0, w1 = window[0], window[0] + window[1]
            on_device_clock = [e for e in events if min(e["ts"] + e["dur"], w1) > max(e["ts"], w0)]
            if {f: sum(f in e["name"] for e in on_device_clock) for f in want} != want:
                bad_device_clock += 1
            if rec["events_outside_window"]:
                shifted.append(rec["events_outside_window"])
            raw = {f: sum(f in e["name"] for e in events) for f in want}
            if any(v % L for v in raw.values()):
                dropped.append({"step": rec["step"], "raw": raw})
            if lag is not None:
                lags.append(lag)
        print(json.dumps({"wave": wave, "captures": len(traces),
                          "seconds": time.perf_counter() - t0, "bad": bad,
                          "bad_by_device_clock": bad_device_clock,
                          "captures_with_events_outside_window": len(shifted),
                          "events_outside_window": sum(shifted),
                          "least_launch_to_start_us": min(lags) if lags else None,
                          "profiler_dropped": dropped}), flush=True)
    eng.close()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
