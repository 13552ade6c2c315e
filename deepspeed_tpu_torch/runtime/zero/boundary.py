"""The ZeRO-Offload boundary between the card and the host optimizer: the
counterpart of the JAX engine's bucketed gradient pull and parameter push
(``deepspeed_tpu/runtime/engine.py`` ``_apply_step_offload``).

The gradients cross to the host and the updated compute-dtype parameters
come back in buckets of consecutive leaves, two of each in flight:

* on a side stream, each bucket's gradients are widened to fp32, divided
  by the step's denominator and multiplied by the clip factor on the card
  (the fp32 operations ``scale_and_clip`` takes on the host, rounded the
  same way), then copied into a host buffer;
* the host optimizer updates those leaves as soon as their bucket lands,
  while the card copies the next bucket;
* each updated leaf's master is rounded to the compute dtype into a second
  host buffer, which a second side stream copies into the live parameter
  leaves; the caller's stream waits on the last copy, so the next forward
  reads the new weights.

Only the four staging buffers are pinned (``pin_memory``), so pinned
host memory stays bounded by the bucket size whatever the model's.  The
device buffers are two fp32 buckets.  A bucket holds ``BUCKET_BYTES`` of
compute-dtype leaves, the JAX engine's push bucket, and at least the
largest leaf (at llama-1b and llama-7b the embedding sets the bucket).

``timings()`` reads the last boundary's parts: the device-to-host and
host-to-device copy times from CUDA events on the side streams, and the
host's update and cast times from its clock.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

#: bucket size in bytes of the compute-dtype leaves, as the JAX engine's
#: push counts it (a bucket never splits a leaf)
BUCKET_BYTES = 64 << 20


class OffloadBoundary:
    def __init__(self, leaves: Sequence[torch.Tensor], pin_memory: bool):
        self.leaves = list(leaves)
        self.device = self.leaves[0].device
        self.cuda = self.device.type == "cuda"
        self.sizes = [p.numel() for p in self.leaves]
        self.cap = max(max(self.sizes), BUCKET_BYTES // self.leaves[0].element_size())
        self.buckets: List[Tuple[int, int]] = []
        start, total = 0, 0
        for i, n in enumerate(self.sizes):
            if i > start and total + n > self.cap:
                self.buckets.append((start, i))
                start, total = i, 0
            total += n
        self.buckets.append((start, len(self.sizes)))
        self.pin = pin_memory and self.cuda
        self.dtype = self.leaves[0].dtype
        self._bufs: Optional[Dict[str, list]] = None
        self._events: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self._host: Dict[str, float] = {}

    def _buffers(self) -> Dict[str, list]:
        if self._bufs is None:
            host = dict(dtype=torch.float32, pin_memory=self.pin)
            self._bufs = {
                "grad": [torch.empty(self.cap, **host) for _ in range(2)],
                "param": [torch.empty(self.cap, dtype=self.dtype, pin_memory=self.pin)
                          for _ in range(2)],
                "stage": ([torch.empty(self.cap, dtype=torch.float32, device=self.device)
                           for _ in range(2)] if self.cuda else None),
            }
            if self.cuda:
                self._streams = (torch.cuda.Stream(self.device), torch.cuda.Stream(self.device))
        return self._bufs

    def pinned_bytes(self) -> int:
        if not self.pin or self._bufs is None:
            return 0
        return sum(t.numel() * t.element_size() for k in ("grad", "param")
                   for t in self._bufs[k])

    def _stream(self, k: int):
        return torch.cuda.stream(self._streams[k]) if self.cuda else contextlib.nullcontext()

    def _timed(self, name: str, stream_k: int):
        """CUDA events around work on side stream ``stream_k``."""
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(self._streams[stream_k])
        self._events.append((name, a, b))
        return b

    def run(self, grads: Sequence[torch.Tensor], denom: float, clip: Optional[float],
            optimizer, lr: float) -> None:
        """One boundary: ``grads`` (on the device, the accumulation dtype)
        -> ``optimizer.step_leaves`` -> the live leaves."""
        bufs = self._buffers()
        self._events, self._host = [], {"host_opt_ms": 0.0, "host_cast_ms": 0.0,
                                        "host_wait_ms": 0.0}
        denom_t = torch.tensor(denom, dtype=torch.float32, device=self.device)
        landed: List[Optional[torch.cuda.Event]] = [None, None]
        pushed: List[Optional[torch.cuda.Event]] = [None, None]
        if self.cuda:
            ready = torch.cuda.current_stream(self.device).record_event()
            for s in self._streams:
                s.wait_event(ready)

        def pull(b: int) -> None:
            slot = b % 2
            s, e = self.buckets[b]
            stage = bufs["stage"][slot] if self.cuda else bufs["grad"][slot]
            with self._stream(0):
                end = self._timed("d2h_ms", 0) if self.cuda else None
                off = 0
                for i in range(s, e):
                    dst = stage[off:off + self.sizes[i]]
                    dst.copy_(grads[i].reshape(-1))
                    dst.div_(denom_t)
                    if clip is not None:
                        dst.mul_(clip)
                    off += self.sizes[i]
                if self.cuda:
                    bufs["grad"][slot][:off].copy_(stage[:off], non_blocking=True)
                    end.record(self._streams[0])
                    landed[slot] = end

        optimizer.begin_step(lr)
        pull(0)
        if len(self.buckets) > 1:
            pull(1)
        for b, (s, e) in enumerate(self.buckets):
            slot = b % 2
            t0 = time.perf_counter()
            if landed[slot] is not None:
                landed[slot].synchronize()
            t1 = time.perf_counter()
            views, off = [], 0
            for i in range(s, e):
                views.append(bufs["grad"][slot][off:off + self.sizes[i]].numpy())
                off += self.sizes[i]
            optimizer.step_leaves(s, views, lr)
            t2 = time.perf_counter()
            if b + 2 < len(self.buckets):
                pull(b + 2)  # this slot's gradients are consumed
            if pushed[slot] is not None:
                pushed[slot].synchronize()
            t3 = time.perf_counter()
            self._push(range(s, e), optimizer, bufs["param"][slot], pushed, slot)
            self._host["host_wait_ms"] += 1e3 * (t1 - t0 + time.perf_counter() - t3)
            self._host["host_opt_ms"] += 1e3 * (t2 - t1)
        for i in optimizer.finish_step(lr):  # leaves changed after their push
            self._push([i], optimizer, bufs["param"][0], pushed, 0, wait=True)
        if self.cuda:
            main = torch.cuda.current_stream(self.device)
            for ev in pushed:
                if ev is not None:
                    main.wait_event(ev)

    def _push(self, idx, optimizer, buf: torch.Tensor, pushed: list, slot: int,
              wait: bool = False) -> None:
        """Round leaves ``idx``'s masters to the compute dtype in ``buf`` and
        copy them into the live leaves."""
        if wait and pushed[slot] is not None:
            pushed[slot].synchronize()
        t0 = time.perf_counter()
        spans, off = [], 0
        for i in idx:
            n = self.sizes[i]
            buf[off:off + n].copy_(torch.from_numpy(optimizer.master[i].reshape(-1)))
            spans.append((i, off, n))
            off += n
        self._host["host_cast_ms"] += 1e3 * (time.perf_counter() - t0)
        with torch.no_grad(), self._stream(1):
            end = self._timed("h2d_ms", 1) if self.cuda else None
            for i, o, n in spans:
                self.leaves[i].view(-1).copy_(buf[o:o + n], non_blocking=self.cuda)
            if self.cuda:
                end.record(self._streams[1])
                pushed[slot] = end

    def timings(self) -> Dict[str, float]:
        """The last boundary's parts in ms (call after the device work is
        done: the copy times read CUDA events)."""
        out = dict(self._host)
        for name, a, b in self._events:
            b.synchronize()
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out
