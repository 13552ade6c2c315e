#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

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
   streams and prefill logits within 2e-3;
6. kernels A' (dQ) and A'' (dK, dV), flash-attention backward, against
   their plain version computed in fp32 from the same inputs, lse and delta
   (``FLASH_BWD_TOL``) at the llama-1b training shape (B=4 S=1024 NH=32
   KVH=8 D=64 bf16 causal; timed beside their bounds, the plain version and
   SDPA's backward) and GQA, ALiBi, uneven-S, fp16 and fp32 corners;
7. kernel C, fused Adam, against its plain version (``ADAM_TOL``) on the
   65.5M-element embedding leaf of llama-1b (timed beside its bound and
   ``torch._fused_adamw_``) and odd-sized, unaligned and bf16-moment leaves;
8. training: ``deepspeed_tpu_torch.initialize`` -> ``train_batch`` on
   llama-1b at full width and depth (bf16, seq 1024, micro-batch 4, AdamW
   with the fused kernel, clipping 1.0), 8 steps at gas 1 on one seeded
   batch (the loss must fall) and 2 at gas 2.  Counters zeroed before and
   read after each drive: every attention layer of every micro-step
   launched kernels A, A' and A'' and every leaf of every optimizer step
   kernel C, and PyTorch's sync debug mode saw no host sync inside any
   train_batch call.  Step time, tokens/s, MFU, a profiled step's device
   idle share and top kernels, peak memory;
9. training parity: a 2-layer llama-1b-width model on the card and on the
   CPU from the same weights and batches, fp32 for 3 steps and fp16 through
   an overflow step (``TRAIN_PARITY_TOL``; loss scale and skipped steps
   equal).

Prints a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and
as its last line ``{"ok": true, "device": {...}}``.  Needs one CUDA card,
``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and the repository beside
this file; without either it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import warnings

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
#: The backward kernels keep every sum in fp32.  In bf16/fp16 they round P
#: and dS to the input type as tensor-core operands, which their plain
#: version, run in fp32 on the fp32 copies of the same inputs with the same
#: lse and delta, does not; in fp32 they differ from it by summation order
#: only.  rtol is the gradients' own rounding, as above; atol about twice the
#: largest need observed on an H100 (PERF.md): 1.05e-2 bf16 (dV, |dV| up to
#: 9), 3.2e-4 fp16, 5.5e-6 fp32 (dK/dV of GQA heads summed in another order).
FLASH_BWD_TOL = {torch.bfloat16: (2.2e-2, 2.0 ** -8), torch.float16: (7e-4, 2.0 ** -11),
                 torch.float32: (1e-5, 2.0 ** -24)}
#: Adam: both versions are fp32 in the same order of operations; the
#: compiler's fused multiply-adds round an intermediate an ulp apart (rtol
#: 2^-20, a few ulps).  A bf16 first moment may then round to the
#: neighbouring bf16 value (rtol 2^-7).  atol: twice the observed 1.5e-10.
ADAM_TOL = {torch.float32: (3e-10, 2.0 ** -20), torch.bfloat16: (3e-10, 2.0 ** -7)}
PARITY_LOGITS_TOL = 2e-3
DEV = "cuda"


class SmokeFailure(SystemExit):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(f"chip_smoke: FAILED: {what}")


#: profiled windows per measurement.  The profiler can record none or only
#: part of a window's kernels without an error; a window that recorded
#: fewer kernel launches than the fullest one is dropped, and the median of
#: the rest is kept.
PROFILER_WINDOWS = 3


def _profiled_us(fn, iters: int, activities) -> tuple:
    """(device µs summed over every kernel, wall µs, the kernels' key
    averages) of ``iters`` calls of ``fn`` under torch.profiler: the median
    over the fullest of ``PROFILER_WINDOWS`` windows; (0, wall, []) when no
    window recorded any device time."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    windows = []
    for _ in range(PROFILER_WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in dev)
        windows.append((busy_us, sum(e.count for e in dev), wall_us, dev))
    fullest = max(w[1] for w in windows)
    if fullest == 0:
        return 0.0, windows[-1][2], []
    kept = sorted((w for w in windows if w[1] == fullest), key=lambda w: w[0])
    busy_us, _, wall_us, dev = kept[len(kept) // 2]
    return busy_us, wall_us, dev


def device_ms(fn, iters: int = 20, warmup: int = 5) -> float:
    """Mean device time of the kernels ``fn`` launches, per call: the
    self device time torch.profiler records, summed over every kernel and
    divided by ``iters``.  Host launch gaps between calls are left out (at
    these sizes the Python wrapper can take longer to launch a kernel than
    the kernel takes to run).  If the profiler records nothing in any of
    its windows, CUDA events around the same calls give the time instead
    (host gaps included), and a ``timing_fallback`` line says so."""
    from torch.profiler import ProfilerActivity

    for _ in range(warmup):
        fn()
    us, _, _ = _profiled_us(fn, iters, [ProfilerActivity.CUDA])
    if us > 0:
        return us / iters / 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    print(json.dumps({"timing_fallback": "cuda_events", "ms": ms}))
    return ms


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
    run at idle clocks, and start the profiler's tracing once."""
    a = torch.randn((4096, 4096), device=DEV, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()
    device_ms(lambda: a @ a, iters=2, warmup=0)


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


# -- phase 6: flash-attention backward ---------------------------------------

def flash_bwd_case(fa, name, B, S, NH, KVH, D, dtype, causal=True, alibi=False, timed=False,
                   seed=0):
    """Kernels A' (dq) and A'' (dk, dv) against the plain backward computed
    in fp32 from the same inputs, the same lse and the same delta."""
    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((B, S, NH, D), generator=g, device=DEV).to(dtype)
    k = torch.randn((B, S, KVH, D), generator=g, device=DEV).to(dtype)
    v = torch.randn((B, S, KVH, D), generator=g, device=DEV).to(dtype)
    do = torch.randn((B, S, NH, D), generator=g, device=DEV).to(dtype)
    slopes = alibi_slopes(NH, device=DEV) if alibi else None
    kw = dict(causal=causal, alibi_slopes=slopes)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = fa._delta(o, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                       do.float(), **kw)
    torch.cuda.synchronize()
    tol = FLASH_BWD_TOL[dtype]
    rec = {"case": name, "shape": [B, S, NH, KVH, D], "dtype": str(dtype)[6:],
           "causal": causal, "alibi": alibi, "tol": tol}
    for nm, out, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        err, atol_used, ok = max_err(out, want, tol)
        rec[f"{nm}_max_abs_err"], rec[f"{nm}_atol_used"] = err, atol_used
        rec[f"{nm}_ref_max_abs"] = want.abs().max().item()
        check(bool(torch.isfinite(out).all()), f"flash bwd {name}: non-finite {nm}")
        check(ok, f"flash bwd {name}: {nm} vs fp32 plain beyond {tol} "
              f"(max abs {err:.3g}, atol used {atol_used:.3g})")
    rec["max_abs_err"] = max(rec[f"{nm}_max_abs_err"] for nm in ("dq", "dk", "dv"))
    print(json.dumps({"flash_bwd_check": rec}))
    if timed:
        rows = torch.arange(S, device=DEV)
        vis = (rows[:, None] >= rows[None, :]) if causal else \
            torch.ones((S, S), dtype=torch.bool, device=DEV)
        pairs = int(vis.sum().item()) * B * NH
        item = q.element_size()
        io = (2 * q.numel() + k.numel() + v.numel()) * item + 2 * lse.numel() * 4  # q dO k v lse delta
        dq_b, dq_by = bound(io + q.numel() * item, 6.0 * D * pairs, dtype)
        dkv_b, dkv_by = bound(io + 2 * k.numel() * item, 8.0 * D * pairs, dtype)
        all_b, all_by = bound(io + o.numel() * item + (q.numel() + 2 * k.numel()) * item,
                              10.0 * D * pairs, dtype)
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        doh = do.transpose(1, 2)
        G = NH // KVH
        mask = None
        if alibi:
            rel = (rows[:, None] - rows[None, :]).float()
            mask = torch.where(vis, -slopes[:, None, None] * rel, float("-inf")).to(dtype)
        sdpa_causal = causal and not alibi

        def lib_fwd():
            return sdpa(qh, kh, vh, mask, G, sdpa_causal)

        def lib_fwd_bwd():
            torch.autograd.grad(lib_fwd(), (qh, kh, vh), doh)

        with torch.no_grad():
            lib_f = device_ms(lib_fwd)
        lib_fb = device_ms(lib_fwd_bwd)
        rec.update(
            dq_ms=device_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)),
            dkv_ms=device_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)),
            plain_ms=device_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw),
                               iters=5, warmup=2),
            library_ms=lib_fb - lib_f, library_fwd_bwd_ms=lib_fb, library_fwd_ms=lib_f,
            dq_bound_ms=dq_b, dq_bound_by=dq_by, dkv_bound_ms=dkv_b, dkv_bound_by=dkv_by,
            bwd_bound_ms=all_b, bwd_bound_by=all_by, pairs=pairs)
    print(json.dumps({"flash_bwd": rec}))
    return rec


def flash_bwd_phase(fa):
    """Kernels A' and A'' at the llama-1b training shape (timed) and corners."""
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    return [
        flash_bwd_case(fa, "train_b4_s1024", 4, 1024, 32, 8, 64, bf16, timed=True),
        flash_bwd_case(fa, "gqa4_uneven_s200", 2, 200, 8, 2, 64, bf16),
        flash_bwd_case(fa, "alibi_d128", 1, 192, 8, 8, 128, bf16, alibi=True),
        flash_bwd_case(fa, "fp16_full_d32_s130", 2, 130, 4, 1, 32, fp16, causal=False),
        flash_bwd_case(fa, "fp32_gqa_s200_d16", 1, 200, 8, 2, 16, fp32),
        flash_bwd_case(fa, "fp32_alibi_full_s100", 2, 100, 4, 4, 64, fp32, causal=False,
                       alibi=True),
    ]


# -- phase 7: fused Adam -----------------------------------------------------

def fused_adamw_library(p, g, m, v, step_t, lr, wd):
    """torch._fused_adamw_ on one leaf (yardstick; fp32 moments only)."""
    torch._fused_adamw_([p], [g], [m], [v], [], [step_t], lr=lr, beta1=0.9, beta2=0.999,
                        weight_decay=wd, eps=1e-8, amsgrad=False, maximize=False)


def adam_case(fadam, name, n, mu_dtype=torch.float32, offset=0, adam_w_mode=True, wd=0.1,
              timed=False, seed=0):
    """Kernel C against its plain version on the same inputs; ``offset``
    starts the leaf one element into a buffer (unaligned: the scalar loop)."""
    g_ = torch.Generator(device=DEV).manual_seed(seed)

    def rnd(scale=1.0, dt=torch.float32):
        return (torch.randn((n + offset,), generator=g_, device=DEV) * scale)[offset:].to(dt)

    p, g = rnd(), rnd(1e-2)
    m, v = rnd(1e-3, mu_dtype), rnd(1e-4).abs()
    scalars = torch.tensor([3.0, 1e-4], device=DEV)
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd, adam_w_mode=adam_w_mode)
    ref = [t.clone() for t in (p, g, m, v)]
    fadam.fused_adam_update(p, g, m, v, scalars, **hyper)
    fadam.fused_adam_plain(*ref, scalars, **hyper)
    torch.cuda.synchronize()
    rec = {"case": name, "n": n, "mu_dtype": str(mu_dtype)[6:], "offset": offset,
           "adam_w_mode": adam_w_mode, "weight_decay": wd}
    for nm, out, want in (("p", p, ref[0]), ("m", m, ref[2]), ("v", v, ref[3])):
        tol = ADAM_TOL[out.dtype]
        err, atol_used, ok = max_err(out, want, tol)
        rec[f"{nm}_max_abs_err"], rec[f"{nm}_atol_used"], rec[f"{nm}_tol"] = err, atol_used, tol
        check(bool(torch.isfinite(out).all()), f"adam {name}: non-finite {nm}")
        check(ok, f"adam {name}: {nm} vs plain beyond {tol} (max abs {err:.3g})")
    rec["max_abs_err"] = max(rec[f"{nm}_max_abs_err"] for nm in "pmv")
    print(json.dumps({"adam_check": rec}))
    if timed:
        nbytes = n * (20 + 2 * m.element_size())  # p, v read and written; g read; m both
        b_ms, b_by = bound(nbytes, 20.0 * n, torch.float32)
        lib = None
        if mu_dtype == torch.float32:
            lp, lg, lm, lv = (t.clone() for t in (p, g, m, v))
            step_t = torch.tensor(3.0, device=DEV)
            lib = device_ms(lambda: fused_adamw_library(lp, lg, lm, lv, step_t, 1e-4, wd))
        rec.update(ms=device_ms(lambda: fadam.fused_adam_update(p, g, m, v, scalars, **hyper)),
                   plain_ms=device_ms(lambda: fadam.fused_adam_plain(*ref, scalars, **hyper)),
                   library_ms=lib, bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
    print(json.dumps({"adam": rec}))
    return rec


def adam_phase(fadam):
    """Kernel C on llama-1b's embedding leaf (timed) and odd corners."""
    return [
        adam_case(fadam, "embed_tok_65.5M", 32000 * 2048, timed=True),
        adam_case(fadam, "embed_tok_65.5M_mu_bf16", 32000 * 2048, mu_dtype=torch.bfloat16,
                  timed=True),
        adam_case(fadam, "odd_1000003", 1_000_003),
        adam_case(fadam, "odd_unaligned_adam_l2", 5503, offset=1, adam_w_mode=False),
        adam_case(fadam, "norm_2048_mu_bf16_unaligned", 2048, mu_dtype=torch.bfloat16,
                  offset=2, wd=0.0),
    ]


# -- phase 8: training ---------------------------------------------------------

TRAIN_SEQ, TRAIN_MICRO = 1024, 4


def train_config(gas=1, **extra):
    """The ds-config of a llama rung of the JAX bench (bench.py:265-280):
    bf16, ZeRO stage 1, AdamW with the fused kernel, clipping 1.0, fp32
    gradient accumulation."""
    cfg = {"train_micro_batch_size_per_gpu": TRAIN_MICRO, "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-4, "weight_decay": 0.1, "fused_kernel": True}},
           "bf16": {"enabled": True}, "zero_optimization": {"stage": 1},
           "gradient_clipping": 1.0, "data_types": {"grad_accum_dtype": "fp32"}}
    cfg.update(extra)
    return cfg


def zero_train_counters(fa, fadam):
    for c in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
              fadam.fused_adam_update):
        c.launches = 0


def read_train_counters(fa, fadam):
    return {"flash_fwd": fa.flash_attention_fwd.launches,
            "flash_bwd_dq": fa.flash_attention_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_attention_bwd_dkv.launches,
            "fused_adam": fadam.fused_adam_update.launches}


def timed_steps(engine, batch, steps):
    """``steps`` train_batch calls, each timed between synchronisations:
    (losses as device tensors, ms per step, the host syncs PyTorch's sync
    debug mode saw inside the calls — a prototype that, in PyTorch's own
    words, does not yet detect every synchronizing operation)."""
    losses, step_ms, syncs = [], [], 0
    for _ in range(steps):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                losses.append(engine.train_batch(batch))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs += sum("called a synchronizing CUDA operation" in str(w.message)
                     for w in caught)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
    return losses, step_ms, syncs


def train_phase(fa, fadam, steps=8, gas2_steps=2):
    """llama-1b at full width and depth through initialize -> train_batch:
    ``steps`` steps at gas 1 on one seeded batch (the loss must fall and
    stay finite), then ``gas2_steps`` at gas 2.  Counters are zeroed just
    before each drive and read just after."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_model
    from deepspeed_tpu_torch.models.transformer import flops_per_token

    model = llama_model("1b", max_seq_len=TRAIN_SEQ)
    cfg = model.config
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=train_config(), seed=0)
    init_s = time.perf_counter() - t0
    n_leaves = len(engine._master)
    n_params = sum(p.numel() for p in engine._master)
    check(engine.device.type == "cuda", "training engine device is not cuda")
    check(all(p.is_cuda and p.dtype == torch.float32 for p in engine._master),
          "master params are not fp32 on cuda")
    check(all(p.dtype == torch.bfloat16 for p in engine._compute_leaves),
          "compute copy is not bf16")
    g = torch.Generator(device=DEV).manual_seed(123)
    batch = torch.randint(0, cfg.vocab_size, (1, TRAIN_MICRO, TRAIN_SEQ), generator=g,
                          device=DEV)
    zero_train_counters(fa, fadam)
    losses, step_ms, syncs = timed_steps(engine, batch, steps)
    launches = read_train_counters(fa, fadam)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    check(all(map(math.isfinite, losses)), f"train: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall over {steps} steps: {losses}")
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[k] == L * steps,
              f"train: {k} launches {launches[k]} != {L} layers x {steps} micro-steps")
    check(launches["fused_adam"] == n_leaves * steps,
          f"train: fused_adam launches {launches['fused_adam']} != {n_leaves} x {steps}")
    check(syncs == 0, f"train: {syncs} host syncs inside bf16 train_batch calls")
    med = sorted(step_ms)[len(step_ms) // 2]
    tokens = TRAIN_MICRO * TRAIN_SEQ
    fpt = flops_per_token(cfg, TRAIN_SEQ)
    prof = profile_window(lambda: engine.train_batch(batch), 1, top_n=10)
    rec = {"model": "llama-1b", "layers": L, "params": n_params, "leaves": n_leaves,
           "seq": TRAIN_SEQ, "micro_batch": TRAIN_MICRO, "dtype": "bf16", "init_s": init_s,
           "losses": losses, "step_ms": step_ms, "median_step_ms": med,
           "tokens_per_s": tokens / (med / 1e3), "flops_per_token": fpt,
           "mfu": fpt * tokens / (med / 1e3) / PEAK_OPS[torch.bfloat16],
           "peak_mem_gb": peak_gb, "launches": launches, "host_syncs": syncs, "profile": prof,
           "grad_norm": engine.get_global_grad_norm(), "lr": engine.get_lr()[0]}
    del engine, losses
    torch.cuda.empty_cache()

    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=train_config(gas=2), seed=0)
    batch2 = torch.randint(0, cfg.vocab_size, (2, TRAIN_MICRO, TRAIN_SEQ), generator=g,
                           device=DEV)
    zero_train_counters(fa, fadam)
    gl, gms, syncs2 = timed_steps(engine, batch2, gas2_steps)
    l2 = read_train_counters(fa, fadam)
    gl = [float(x) for x in gl]
    check(all(map(math.isfinite, gl)), f"train gas 2: non-finite loss {gl}")
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(l2[k] == L * 2 * gas2_steps, f"train gas 2: {k} launches {l2[k]} != "
              f"{L} x 2 micro-steps x {gas2_steps}")
    check(l2["fused_adam"] == n_leaves * gas2_steps,
          f"train gas 2: fused_adam launches {l2['fused_adam']}")
    check(syncs2 == 0, f"train gas 2: {syncs2} host syncs inside train_batch calls")
    rec["gas2"] = {"losses": gl, "step_ms": gms, "launches": l2, "host_syncs": syncs2}
    del engine
    torch.cuda.empty_cache()
    print(json.dumps({"train": rec}))
    return rec


# -- phase 9: card vs CPU training parity --------------------------------------

#: Card vs CPU at llama-1b width.  fp32: both sides fp32 end to end (no
#: TF32), summed in other orders by cuBLAS and the CPU GEMMs and by the
#: kernels and the plain attention.  A weight whose gradient is near Adam's
#: eps (1e-8) takes a step that depends on the gradient's last digits, up
#: to lr per step: observed 3.4e-5 after 3 steps at lr 1e-4, limit 1e-4.
#: fp16: every op rounds to 11 bits, and Adam's near-sign step can move a
#: weight by up to 2 lr per applied step (observed 3.7e-4 after 2 steps).
TRAIN_PARITY_TOL = {"fp32": {"loss": 1e-5, "grad_norm": 1e-4, "params": 1e-4},
                    "fp16": {"loss": 2e-3, "grad_norm": 2e-2, "params": 1e-3}}


def train_parity_phase():
    """A 2-layer llama-1b-width model on the card and on the CPU from the
    same weights and batches: 3 fp32 steps; then fp16 from an initial scale
    of 2^20 with hysteresis 1, until one overflow step has been skipped and
    two steps applied (at most 12)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import llama_model

    model = llama_model("1b", max_seq_len=256, n_layers=2)
    params = model.init_params(torch.Generator().manual_seed(7), "cpu")
    rng = torch.Generator().manual_seed(8)
    out = {}
    for name, extra, max_steps, B, S in (
            ("fp32", {}, 3, 2, 128),
            ("fp16", {"fp16": {"enabled": True, "initial_scale_power": 20, "hysteresis": 1}},
             12, 1, 64)):
        ds = train_config(**extra)
        ds.pop("bf16")
        ds["train_micro_batch_size_per_gpu"] = B
        engines = {dev: deepspeed_tpu_torch.initialize(model=model, config=dict(ds),
                                                       model_parameters=params, device=dev)[0]
                   for dev in ("cuda", "cpu")}
        tol = TRAIN_PARITY_TOL[name]
        rec = {"batch": [B, S], "tol": tol, "per_step": []}
        for _ in range(max_steps):
            ids = torch.randint(0, model.config.vocab_size, (1, B, S), generator=rng)
            row = {}
            for dev, e in engines.items():
                loss = float(e.train_batch(ids))
                row[dev] = {"loss": loss, "grad_norm": e.get_global_grad_norm(),
                            "loss_scale": e.loss_scale(), "skipped": e.skipped_steps,
                            "applied": int(e.state.step)}
            c, h = row["cuda"], row["cpu"]
            check(c["loss_scale"] == h["loss_scale"] and c["skipped"] == h["skipped"],
                  f"train parity {name}: loss scale / skipped differ: {row}")
            check(abs(c["loss"] - h["loss"]) <= tol["loss"] * abs(h["loss"]),
                  f"train parity {name}: loss {c['loss']} vs {h['loss']}")
            if math.isfinite(h["grad_norm"]):
                check(abs(c["grad_norm"] - h["grad_norm"]) <= tol["grad_norm"] * h["grad_norm"],
                      f"train parity {name}: grad norm {c['grad_norm']} vs {h['grad_norm']}")
            else:
                check(not math.isfinite(c["grad_norm"]), f"train parity {name}: {row}")
            rec["per_step"].append(row)
            if name == "fp16" and c["skipped"] >= 1 and c["applied"] >= 2:
                break
        diff = max((a.cpu() - b).abs().max().item() for a, b in zip(
            engines["cuda"]._master, engines["cpu"]._master))
        check(diff <= tol["params"], f"train parity {name}: master params differ by {diff}")
        rec["params_max_abs_diff"] = diff
        rec["steps"] = len(rec["per_step"])
        if name == "fp16":
            check(engines["cuda"].skipped_steps >= 1 and int(engines["cuda"].state.step) >= 2,
                  f"train parity fp16: wanted an overflow step and two applied: {rec}")
        out[name] = rec
        del engines
        torch.cuda.empty_cache()
    print(json.dumps({"train_parity": out}))
    return out


# -- phase 4: the engine -----------------------------------------------------

def profile_window(fn, steps: int, top_n: int = 8):
    """Run ``fn`` ``steps`` times under torch.profiler: wall and device-busy
    ms per step, the device's idle share, and the top kernels by device
    time (None where the profiler recorded no device time)."""
    from torch.profiler import ProfilerActivity

    busy_us, wall_us, dev = _profiled_us(
        fn, steps, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:top_n]
    return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": busy_us / steps / 1e3 if dev else None,
            "device_idle_share": 1.0 - busy_us / wall_us if dev else None,
            "top_kernels_ms_per_step": {e.key[:70]: e.self_device_time_total / steps / 1e3
                                        for e in top}}


def profile_steps(eng, requests, warm_steps: int, steps: int):
    """Queue ``requests``, run ``warm_steps`` engine steps, then profile the
    next ``steps``; the engine is run dry afterwards."""
    for r in requests:
        eng.put(r)
    for _ in range(warm_steps):
        eng.step()
    rec = profile_window(eng.step, steps)
    while eng.has_work():
        eng.step()
    return rec


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
        from deepspeed_tpu_torch.ops import fused_adam as fadam
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
    bwd = flash_bwd_phase(fa)
    adam = adam_phase(fadam)

    eng = engine_phase(fa, pa)
    par = parity_phase()
    train = train_phase(fa, fadam)
    tpar = train_parity_phase()

    def timed(recs, keys):
        return {r["case"]: {k: r[k] for k in keys} for r in recs if keys[0] in r}

    main_flash = next(r for r in flash if r["case"] == "prefill_s1024")
    main_paged = paged[0]
    main_bwd = bwd[0]
    main_adam = adam[0]
    serve_fwd = sum(r["launches"]["flash"] for r in eng.values())
    train_l = {k: train["launches"][k] + train["gas2"]["launches"][k]
               for k in train["launches"]}
    bwd_shape = "B=4 S=1024 NH=32 KVH=8 D=64 bf16 causal"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:38",
         "launches": serve_fwd + train_l["flash_fwd"],
         "launches_by_path": {"serving": serve_fwd, "training": train_l["flash_fwd"]},
         "max_abs_err": max(r["max_abs_err"] for r in flash), "checked": True,
         "ms": main_flash["ms"], "kernel_ms": main_flash["ms"],
         "plain_ms": main_flash["plain_ms"], "bound_ms": main_flash["bound_ms"],
         "bound_by": main_flash["bound_by"], "library_ms": main_flash["library_ms"],
         "shape": "B=1 S=1024 NH=32 KVH=8 D=64 bf16 causal",
         "timed_cases": timed(flash, ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"))},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:132",
         "launches": train_l["flash_bwd_dq"],
         "max_abs_err": max(r["dq_max_abs_err"] for r in bwd), "checked": True,
         "ms": main_bwd["dq_ms"], "plain_ms": main_bwd["plain_ms"],
         "bound_ms": main_bwd["dq_bound_ms"], "bound_by": main_bwd["dq_bound_by"],
         "library_ms": main_bwd["library_ms"], "shape": bwd_shape,
         "note": "plain_ms and library_ms compute dq, dk and dv together"},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:165",
         "launches": train_l["flash_bwd_dkv"],
         "max_abs_err": max(max(r["dk_max_abs_err"], r["dv_max_abs_err"]) for r in bwd),
         "checked": True, "ms": main_bwd["dkv_ms"], "plain_ms": main_bwd["plain_ms"],
         "bound_ms": main_bwd["dkv_bound_ms"], "bound_by": main_bwd["dkv_bound_by"],
         "library_ms": main_bwd["library_ms"], "shape": bwd_shape,
         "note": "plain_ms and library_ms compute dq, dk and dv together"},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/paged_attention.cu",
         "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:35",
         "launches": sum(r["launches"]["paged"] for r in eng.values()),
         "max_abs_err": max(r["max_abs_err"] for r in paged), "checked": True,
         "ms": main_paged["ms"], "kernel_ms": main_paged["ms"],
         "plain_ms": main_paged["plain_ms"], "bound_ms": main_paged["bound_ms"],
         "bound_by": main_paged["bound_by"], "library_ms": main_paged["library_ms"],
         "shape": "B=8 NH=32 KVH=8 D=64 ps=16 MP=64 bf16",
         "timed_cases": timed(paged, ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"))},
        {"name": "fused_adam", "route": "cuda",
         "source": "deepspeed_tpu_torch/csrc/fused_adam.cu",
         "replaces": "deepspeed_tpu/ops/pallas/fused_adam.py:23",
         "launches": train_l["fused_adam"],
         "max_abs_err": max(r["max_abs_err"] for r in adam), "checked": True,
         "ms": main_adam["ms"], "plain_ms": main_adam["plain_ms"],
         "bound_ms": main_adam["bound_ms"], "bound_by": main_adam["bound_by"],
         "library_ms": main_adam["library_ms"], "shape": "n=65,536,000 fp32 p/g/m/v",
         "timed_cases": timed(adam, ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"))},
    ]
    check(all(k["launches"] > 0 for k in kernels), "a kernel of the path never launched")
    print(json.dumps({"engine_summary": {m: {k: r[k] for k in (
        "ttft_mean_s", "ttft_p50_s", "ttft_max_s", "prefill_tok_per_s", "decode_tok_per_s",
        "mean_step_ms", "steps", "wall_s", "launches")} for m, r in eng.items()},
        "decode_profile": eng["whole_prompt"]["decode_profile"],
        "prefill_profile": eng["whole_prompt"]["prefill_profile"],
        "parity": par}))
    print(json.dumps({"train_summary": {k: train[k] for k in (
        "median_step_ms", "tokens_per_s", "mfu", "peak_mem_gb", "losses", "launches")},
        "train_profile": train["profile"], "gas2": train["gas2"],
        "train_parity": {n: {"steps": r["steps"], "params_max_abs_diff": r["params_max_abs_diff"]}
                         for n, r in tpar.items()}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
