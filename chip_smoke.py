#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught and passed):

0. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
1. build every CUDA kernel of the path from ``deepspeed_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. kernel A, flash-attention forward, against its plain PyTorch version
   computed in fp32 on the same inputs (limits in ``FLASH_TOL``/``LSE_TOL``) on
   the card at llama-1b prefill shapes (+ a chunked-prefill window,
   ALiBi, fp32 and fp16 cases), timed beside its bound, its plain version
   and ``F.scaled_dot_product_attention`` as a yardstick;
3. kernel B, paged decode attention, the same way at the llama-1b decode
   shape (+ int8 pages, a NaN-poisoned trash page, ALiBi; ``PAGED_TOL``);
4. the engine: ``InferenceEngineV2`` serving llama-1b at full width and
   depth in bf16 with random seeded weights, 12 greedy requests through
   8 slots, once with whole-prompt prefill and once with 256-token
   chunks.  The launch counters are zeroed just before each drive and
   read just after: every prefill layer must have gone through kernel A
   and every decode layer through kernel B;
5. parity: a 2-layer llama-1b-width model in fp32, the card's engine
   against the port's CPU engine on the same weights: identical greedy
   streams and prefill logits within 2e-3.

Prints a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and
as its last line ``{"ok": true, "device": {...}}``.  Needs one CUDA card,
``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and the repository beside
this file; without either it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,  # dense tensor core
            torch.float32: 67e12}                            # fp32 outside the tensor cores
#: A kernel is held against its plain version computed in fp32 from the
#: same inputs: |out - ref| <= atol + rtol * |ref| everywhere.  rtol is the
#: rounding of the output to its dtype (half an ulp: 2^-8 bf16, 2^-11 fp16,
#: 2^-24 fp32).  atol covers the rounding inside the kernel and is about
#: twice the maximum observed on an H100 (PERF.md): flash rounds the
#: probabilities to the input dtype as the PV operand (3.5e-3 bf16, 9.1e-5
#: fp16, 4.4e-7 fp32); paged decode keeps them fp32 and needs none beyond
#: the output's rounding (0 bf16, 1.6e-7 fp16, 3.5e-7 fp32), so it gets a
#: small floor.  LSE is fp32 (observed 9.5e-7, two ulps near 7): 1e-5;
#: dropping one 64-key tile of 1024 keys moves it by ~6e-2.
FLASH_TOL = {torch.bfloat16: (7e-3, 2.0 ** -8), torch.float16: (2e-4, 2.0 ** -11),
             torch.float32: (1e-6, 2.0 ** -24)}
PAGED_TOL = {torch.bfloat16: (1e-5, 2.0 ** -8), torch.float16: (1e-5, 2.0 ** -11),
             torch.float32: (1e-6, 2.0 ** -24)}
LSE_TOL = 1e-5
PARITY_LOGITS_TOL = 2e-3
DEV = "cuda"


class SmokeFailure(SystemExit):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(f"chip_smoke: FAILED: {what}")


def device_ms(fn, iters: int = 20, warmup: int = 5) -> float:
    """Mean device time of the kernels ``fn`` launches, per call: the
    self device time torch.profiler records, summed over every kernel and
    divided by ``iters``.  Host launch gaps between calls are left out (at
    these sizes the Python wrapper can take longer to launch a kernel than
    the kernel takes to run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    check(us > 0, "the profiler recorded no device time")
    return us / iters / 1e3


def max_err(out, ref, tol):
    """(max |out - ref|, the least atol that the elementwise limit
    ``atol + rtol * |ref|`` would need at ``tol``'s rtol, whether the limit
    holds everywhere)."""
    atol, rtol = tol
    d = (out.float() - ref.float()).abs()
    excess = (d - rtol * ref.float().abs()).clamp_min(0).max().item()
    return d.max().item(), excess, excess <= atol


def bound(bytes_moved: float, ops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa(q, k, v, mask, g, is_causal=False):
    """F.scaled_dot_product_attention on [B, H, S, D] views (yardstick)."""
    try:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=is_causal,
                                              enable_gqa=g > 1)
    except TypeError:  # a PyTorch without enable_gqa
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), attn_mask=mask,
            is_causal=is_causal)


def warm_clocks(seconds: float = 1.0) -> None:
    """Keep the card busy for about ``seconds`` so the first timings do not
    run at idle clocks."""
    a = torch.randn((4096, 4096), device=DEV, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()


# -- phase 2: flash-attention forward ---------------------------------------

def flash_case(fa, name, B, Sq, Sk, NH, KVH, D, dtype, causal=True, q_offset=0,
               alibi=False, valid_k=None, timed=False, seed=0):
    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((B, Sq, NH, D), generator=g, device=DEV).to(dtype)
    k = torch.randn((B, Sk, KVH, D), generator=g, device=DEV).to(dtype)
    v = torch.randn((B, Sk, KVH, D), generator=g, device=DEV).to(dtype)
    slopes = alibi_slopes(NH, device=DEV) if alibi else None
    kw = dict(causal=causal, q_offset=q_offset, alibi_slopes=slopes, valid_k=valid_k)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    err, atol_used, ok = max_err(o, o_ref, FLASH_TOL[dtype])
    lse_err = (lse - lse_ref).abs().max().item()
    rec = {"case": name, "shape": [B, Sq, Sk, NH, KVH, D], "dtype": str(dtype)[6:],
           "causal": causal, "q_offset": q_offset, "alibi": alibi, "valid_k": valid_k,
           "max_abs_err": err, "atol_used": atol_used, "lse_max_abs_err": lse_err,
           "tol": FLASH_TOL[dtype], "lse_tol": LSE_TOL}
    print(json.dumps({"flash_check": rec}))
    check(bool(torch.isfinite(o).all()), f"flash {name}: non-finite output")
    check(ok, f"flash {name}: kernel vs fp32 plain beyond {FLASH_TOL[dtype]} "
          f"(max abs {err:.3g}, atol used {atol_used:.3g})")
    check(lse_err <= LSE_TOL, f"flash {name}: lse beyond {LSE_TOL} (max abs {lse_err:.3g})")
    if timed:
        rows = q_offset + torch.arange(Sq, device=DEV)
        vis = (rows[:, None] >= torch.arange(Sk, device=DEV)[None, :]) if causal \
            else torch.ones((Sq, Sk), dtype=torch.bool, device=DEV)
        pairs = int(vis.sum().item()) * B * NH
        item = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * item + lse.numel() * 4
        b_ms, b_by = bound(nbytes, 4.0 * D * pairs, dtype)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        # plain causal (q_offset 0, square) takes SDPA's own causal path;
        # offsets and ALiBi need an explicit mask
        top_left = causal and q_offset == 0 and Sq == Sk and not alibi
        mask = None if top_left else vis
        if alibi:
            rel = (rows[:, None] - torch.arange(Sk, device=DEV)[None, :]).float()
            mask = torch.where(vis, -slopes[:, None, None] * rel, float("-inf")).to(dtype)
        rec.update(
            ms=device_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw)),
            plain_ms=device_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, **kw)),
            library_ms=device_ms(lambda: sdpa(qh, kh, vh, mask, NH // KVH, top_left)),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=4.0 * D * pairs)
    print(json.dumps({"flash": rec}))
    return rec


# -- phase 3: paged decode attention ----------------------------------------

def paged_case(pa, name, B, NH, KVH, D, ps, MP, dtype, quant=False, poison=False,
               alibi=False, timed=False, seed=0):
    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    g = torch.Generator(device=DEV).manual_seed(seed)
    P = B * MP + 1  # + the trash page
    trash = P - 1
    q = torch.randn((B, NH, D), generator=g, device=DEV).to(dtype)
    if quant:
        k_pool = torch.randint(-127, 128, (P, ps, KVH, D), generator=g,
                               device=DEV).to(torch.int8)
        v_pool = torch.randint(-127, 128, (P, ps, KVH, D), generator=g,
                               device=DEV).to(torch.int8)
        k_scale = torch.rand((P, ps, KVH), generator=g, device=DEV) * 0.02 + 0.002
        v_scale = torch.rand((P, ps, KVH), generator=g, device=DEV) * 0.02 + 0.002
    else:
        k_pool = torch.randn((P, ps, KVH, D), generator=g, device=DEV).to(dtype)
        v_pool = torch.randn((P, ps, KVH, D), generator=g, device=DEV).to(dtype)
        k_scale = v_scale = None
    # ragged positions up to the last slot of the table, one at the end
    pos = torch.randint(1, MP * ps, (B,), generator=g, device=DEV, dtype=torch.int32)
    pos[0] = MP * ps - 1
    perm = torch.randperm(P - 1, generator=g, device=DEV)
    table = torch.full((B, MP), trash, dtype=torch.int32, device=DEV)
    n = 0
    for b in range(B):
        used = int(pos[b].item()) // ps + 1
        table[b, :used] = perm[n:n + used].to(torch.int32)
        n += used
    slopes = alibi_slopes(NH, device=DEV) if alibi else None
    args = (q, k_pool, v_pool, table, pos)
    kw = dict(k_scale=k_scale, v_scale=v_scale, alibi_slopes=slopes)
    out = pa.paged_decode_attention(*args, **kw)
    pools32 = (k_pool, v_pool) if quant else (k_pool.float(), v_pool.float())
    ref = pa.paged_decode_attention_plain(q.float(), *pools32, table, pos, **kw)
    torch.cuda.synchronize()
    err, atol_used, ok = max_err(out, ref, PAGED_TOL[dtype])
    rec = {"case": name, "shape": [B, NH, KVH, D, ps, MP], "dtype": str(dtype)[6:],
           "quant": quant, "alibi": alibi, "positions": pos.tolist(),
           "max_abs_err": err, "atol_used": atol_used, "tol": PAGED_TOL[dtype]}
    print(json.dumps({"paged_check": rec}))
    check(bool(torch.isfinite(out).all()), f"paged {name}: non-finite output")
    check(ok, f"paged {name}: kernel vs fp32 plain beyond {PAGED_TOL[dtype]} "
          f"(max abs {err:.3g}, atol used {atol_used:.3g})")
    if poison:
        # NaN in the trash page: the kernel never loads it, so its output
        # is bit-identical to the clean run
        k_pool[trash] = float("nan") if not quant else 0
        v_pool[trash] = float("nan") if not quant else 0
        if quant:
            k_scale[trash] = float("nan")
            v_scale[trash] = float("nan")
        poisoned = pa.paged_decode_attention(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(poisoned, out), f"paged {name}: trash-page NaN reached the output")
        rec["poisoned_trash_bit_identical"] = True
    if timed:
        slots = int((pos.long() + 1).sum().item())
        kv_item = k_pool.element_size()
        nbytes = (2 * slots * KVH * D * kv_item + (2 * slots * KVH * 4 if quant else 0)
                  + 2 * q.numel() * q.element_size()
                  + sum(-(-int(p) // ps) for p in (pos + 1).tolist()) * 4 + B * 4)
        ops = 4.0 * D * slots * NH
        b_ms, b_by = bound(nbytes, ops, dtype)
        S = MP * ps
        vis = (torch.arange(S, device=DEV)[None, :] <= pos.long()[:, None])[:, None, None]
        G = NH // KVH

        def library():  # the gather + SDPA yardstick (bf16 pools only)
            kk = k_pool[table.long()].reshape(B, S, KVH, D).transpose(1, 2)
            vv = v_pool[table.long()].reshape(B, S, KVH, D).transpose(1, 2)
            return sdpa(q[:, :, None], kk, vv, vis, G)

        rec.update(
            ms=device_ms(lambda: pa.paged_decode_attention(*args, **kw)),
            plain_ms=device_ms(lambda: pa.paged_decode_attention_plain(*args, **kw)),
            library_ms=None if quant else device_ms(library),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=ops)
    print(json.dumps({"paged": rec}))
    return rec


def flash_phase(fa):
    """Kernel A at the llama-1b prefill shapes (timed) and the corners."""
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    return [
        flash_case(fa, "prefill_s512", 1, 512, 512, 32, 8, 64, bf16, timed=True),
        flash_case(fa, "prefill_s1024", 1, 1024, 1024, 32, 8, 64, bf16, timed=True),
        flash_case(fa, "chunk_256_at_512_window_1024", 1, 256, 1024, 32, 8, 64, bf16,
                   q_offset=512, timed=True),
        flash_case(fa, "alibi_d128", 2, 192, 192, 8, 8, 128, bf16, alibi=True),
        flash_case(fa, "fp32_uneven_gqa", 1, 200, 200, 8, 2, 32, fp32),
        flash_case(fa, "fp16_full_d16", 2, 96, 130, 4, 1, 16, fp16, causal=False),
        flash_case(fa, "bf16_d32_valid_k", 2, 100, 160, 4, 2, 32, bf16, causal=False,
                   valid_k=131),
        flash_case(fa, "fp16_chunk_d64", 1, 48, 192, 8, 2, 64, fp16, q_offset=100),
    ]


def paged_phase(pa):
    """Kernel B at the llama-1b decode shape (timed) and the corners."""
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    return [
        paged_case(pa, "decode_b8_ctx1024", 8, 32, 8, 64, 16, 64, bf16, poison=True,
                   timed=True),
        paged_case(pa, "int8_pages", 8, 32, 8, 64, 16, 64, bf16, quant=True, poison=True,
                   timed=True),
        paged_case(pa, "alibi_fp32_21_pages", 4, 8, 2, 32, 16, 21, fp32, alibi=True),
        paged_case(pa, "mha_d128_fp16_one_run", 3, 8, 8, 128, 8, 6, fp16),
    ]


# -- phase 4: the engine -----------------------------------------------------

def profile_steps(eng, requests, warm_steps: int, steps: int):
    """Queue ``requests``, run ``warm_steps`` engine steps, then profile the
    next ``steps`` with torch.profiler: wall and device-busy time per step,
    the device's idle share, and the top kernels by device time.  The
    engine is run dry afterwards."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for r in requests:
        eng.put(r)
    for _ in range(warm_steps):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    while eng.has_work():
        eng.step()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "top_kernels_ms_per_step": {e.key[:60]: e.self_device_time_total / steps / 1e3
                                        for e in top}}


def drive(eng, requests, fa, pa):
    """Zero the launch counters, serve ``requests`` to completion through
    put/step, read the counters.  Returns the phase record."""
    fa.flash_attention_fwd.launches = 0
    pa.paged_decode_attention.launches = 0
    before = eng.stats()
    t_put, first, streams, reasons, step_ms = {}, {}, {}, {}, []
    for r in requests:
        uid = eng.put(r)
        t_put[uid] = time.perf_counter()
        streams[uid] = []
    t0 = time.perf_counter()
    while eng.has_work():
        ts = time.perf_counter()
        out = eng.step()
        now = time.perf_counter()
        step_ms.append((now - ts) * 1e3)
        for uid, rec in out.items():
            if rec["tokens"] and uid not in first:
                first[uid] = now - t_put[uid]
            streams[uid] += rec["tokens"]
            if rec["done"]:
                reasons[uid] = rec["finish_reason"]
    wall = time.perf_counter() - t0
    launches = {"flash": fa.flash_attention_fwd.launches,
                "paged": pa.paged_decode_attention.launches}
    st = {k: v - before[k] for k, v in eng.stats().items()}
    ttft = sorted(first.values())
    return {"streams": streams, "reasons": reasons, "launches": launches, "stats": st,
            "ttft_mean_s": sum(ttft) / len(ttft), "ttft_p50_s": ttft[len(ttft) // 2],
            "ttft_max_s": ttft[-1], "wall_s": wall, "steps": len(step_ms),
            "mean_step_ms": sum(step_ms) / len(step_ms),
            "prefill_tok_per_s": st["prefill_computed_tokens"] / st["prefill_seconds"],
            "decode_tok_per_s": st["decode_tokens"] / st["decode_seconds"]}


def engine_phase(fa, pa):
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig, RaggedRequest)
    from deepspeed_tpu_torch.models.llama import llama_model

    model = llama_model("1b", max_seq_len=2048)
    L = model.config.n_layers
    rng = torch.Generator().manual_seed(1234)
    lengths = [16, 900] + torch.randint(17, 900, (10,), generator=rng).tolist()
    prompts = [torch.randint(0, model.config.vocab_size, (n,), generator=rng).tolist()
               for n in lengths]
    results, params = {}, None
    for mode, chunk in (("whole_prompt", 0), ("chunked_256", 256)):
        cfg = RaggedInferenceConfig(dtype="bf16", page_size=16, max_seqs=8,
                                    max_pages_per_seq=64, num_pages=576,
                                    prefill_chunk=chunk)
        t0 = time.perf_counter()
        eng = InferenceEngineV2(model, cfg, params=params, seed=0)
        init_s = time.perf_counter() - t0
        params = eng.params
        check(eng.device.type == "cuda", "engine device is not cuda")
        check(all(p.is_cuda and p.dtype == torch.bfloat16 for p in eng.params.parameters()),
              "params are not bf16 on cuda")
        check(all(t.is_cuda for t in eng._pools.values()), "KV pools are not on cuda")
        # warm-up (cuBLAS handles, allocator): one short request, not counted
        eng.generate_all([RaggedRequest(prompt_ids=prompts[0][:32], max_new_tokens=2)])
        reqs = [RaggedRequest(prompt_ids=p, max_new_tokens=32) for p in prompts]
        rec = drive(eng, reqs, fa, pa)
        st = rec["stats"]
        check(len(rec["reasons"]) == len(prompts), f"{mode}: {len(rec['reasons'])} of "
              f"{len(prompts)} requests finished")
        check(all(r == "length" for r in rec["reasons"].values()), f"{mode}: {rec['reasons']}")
        check(all(len(s) == 32 for s in rec["streams"].values()), f"{mode}: stream lengths")
        calls = st["prefill_calls"] + st["prefill_chunk_calls"]
        check(calls > 0 and rec["launches"]["flash"] == L * calls,
              f"{mode}: flash launches {rec['launches']['flash']} != {L} x {calls} prefill calls")
        check(rec["launches"]["paged"] == L * st["decode_model_invocations"],
              f"{mode}: paged launches {rec['launches']['paged']} != {L} x "
              f"{st['decode_model_invocations']} decode steps")
        rec["init_s"] = init_s
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        if not chunk:
            # 8 slots decoding short prompts; then one step that prefills
            # the 900-token prompt alone (max_new_tokens=1: no decode)
            rec["decode_profile"] = profile_steps(
                eng, [RaggedRequest(prompt_ids=p[:64], max_new_tokens=8)
                      for p in prompts[:cfg.max_seqs]], warm_steps=2, steps=4)
            rec["prefill_profile"] = profile_steps(
                eng, [RaggedRequest(prompt_ids=prompts[1], max_new_tokens=1)],
                warm_steps=0, steps=1)
        results[mode] = rec
        print(json.dumps({"engine": mode, **{k: v for k, v in rec.items()
                                             if k not in ("streams", "reasons")}}))
        eng.close()
        del eng
    for mode in results:
        results[mode].pop("streams")
    return results


# -- phase 5: card vs CPU parity ---------------------------------------------

def parity_phase():
    import copy

    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceConfig, RaggedRequest)
    from deepspeed_tpu_torch.inference.v2.model_runner import paged_prefill
    from deepspeed_tpu_torch.models.llama import llama_model

    model = llama_model("1b", max_seq_len=2048, n_layers=2)
    params = model.init_params(torch.Generator().manual_seed(7), "cpu")
    cfg = dict(dtype="fp32", page_size=16, max_seqs=4, max_pages_per_seq=16, num_pages=64)
    rng = torch.Generator().manual_seed(8)
    prompts = [torch.randint(0, model.config.vocab_size, (n,), generator=rng).tolist()
               for n in (7, 40, 100, 23)]
    engines = {dev: InferenceEngineV2(model, RaggedInferenceConfig(**cfg),
                                      params=copy.deepcopy(params), device=dev)
               for dev in ("cuda", "cpu")}
    streams = {dev: e.generate_all([RaggedRequest(prompt_ids=p, max_new_tokens=8)
                                    for p in prompts]) for dev, e in engines.items()}
    check(streams["cuda"] == streams["cpu"],
          f"parity: greedy streams differ: {streams['cuda']} vs {streams['cpu']}")
    # prefill logits of the 100-token prompt through the same program
    ids = torch.zeros(128, dtype=torch.long)
    ids[:100] = torch.tensor(prompts[2])
    rows = torch.arange(8, dtype=torch.int32)
    logits = {}
    for dev, e in engines.items():
        logits[dev], _ = paged_prefill(e.cfg, e.params, e._pools, ids.to(e.device),
                                       rows.to(e.device), 100)
    err = (logits["cuda"].cpu() - logits["cpu"]).abs().max().item()
    scale = logits["cpu"].abs().max().item()
    check(err <= PARITY_LOGITS_TOL, f"parity: prefill logits max err {err:.3g}")
    rec = {"streams_identical": True, "requests": len(prompts), "tokens_each": 8,
           "prefill_logits_max_abs_err": err, "logits_max_abs": scale,
           "tol": PARITY_LOGITS_TOL}
    print(json.dumps({"parity": rec}))
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from deepspeed_tpu_torch.ops import flash_attention as fa
        from deepspeed_tpu_torch.ops import op_builder
        from deepspeed_tpu_torch.ops import paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    t0 = time.perf_counter()
    secs = op_builder.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall, per kernel "
          + json.dumps({k: round(v, 1) for k, v in secs.items()}))
    for name, log in op_builder.build_log.items():
        for line in log["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {name}: {line.strip()}")

    warm_clocks()
    flash = flash_phase(fa)
    paged = paged_phase(pa)

    eng = engine_phase(fa, pa)
    par = parity_phase()

    main_flash = next(r for r in flash if r["case"] == "prefill_s1024")
    main_paged = paged[0]
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:38",
         "launches": sum(r["launches"]["flash"] for r in eng.values()),
         "max_abs_err": max(r["max_abs_err"] for r in flash), "checked": True,
         "ms": main_flash["ms"], "kernel_ms": main_flash["ms"],
         "plain_ms": main_flash["plain_ms"], "bound_ms": main_flash["bound_ms"],
         "bound_by": main_flash["bound_by"], "library_ms": main_flash["library_ms"],
         "shape": "B=1 S=1024 NH=32 KVH=8 D=64 bf16 causal",
         "timed_cases": {r["case"]: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                                       "bound_by", "library_ms")}
                         for r in flash if "ms" in r}},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/paged_attention.cu",
         "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:35",
         "launches": sum(r["launches"]["paged"] for r in eng.values()),
         "max_abs_err": max(r["max_abs_err"] for r in paged), "checked": True,
         "ms": main_paged["ms"], "kernel_ms": main_paged["ms"],
         "plain_ms": main_paged["plain_ms"], "bound_ms": main_paged["bound_ms"],
         "bound_by": main_paged["bound_by"], "library_ms": main_paged["library_ms"],
         "shape": "B=8 NH=32 KVH=8 D=64 ps=16 MP=64 bf16",
         "timed_cases": {r["case"]: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                                       "bound_by", "library_ms")}
                         for r in paged if "ms" in r}},
    ]
    check(all(k["launches"] > 0 for k in kernels), "a kernel of the path never launched")
    print(json.dumps({"engine_summary": {m: {k: r[k] for k in (
        "ttft_mean_s", "ttft_p50_s", "ttft_max_s", "prefill_tok_per_s", "decode_tok_per_s",
        "mean_step_ms", "steps", "wall_s", "launches")} for m, r in eng.items()},
        "decode_profile": eng["whole_prompt"]["decode_profile"],
        "prefill_profile": eng["whole_prompt"]["prefill_profile"],
        "parity": par}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
