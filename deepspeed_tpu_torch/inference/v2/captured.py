"""The serving engine's decode programs, captured as CUDA graphs (the port's
counterpart of the ``jax.jit`` programs of ``deepspeed_tpu/inference/v2/
engine_v2.py``: decode :345-361, multi-step decode :413-426, verify
:382-397).

Three kinds of program, each over every decode slot (``max_seqs`` rows):

* ``"decode"``: :func:`model_runner.paged_decode` and
  :func:`model_runner.sample_tokens`; returns ``[B]`` tokens;
* ``("multi", k)``: :func:`model_runner.paged_multi_decode` at horizon
  ``k``, one per value of the engine's halving chain; returns ``[B, k]``
  tokens and ``[B]`` produced counts;
* ``"verify"``: :func:`model_runner.paged_verify` at width ``W = k + 1``
  and the greedy argmax per position; returns ``[B, W]`` tokens.

Every program reads its inputs from one int32 buffer on the device
(``staging`` is its host twin, pinned on CUDA): the engine writes the
numpy views, one ``non_blocking`` copy moves the whole buffer, the graph
replays, and the result comes back in one device-to-host read.  On CUDA
each program is captured once, at construction: an eager warm step on a
side stream (it loads the kernel libraries and cuBLAS's workspace), then
``torch.cuda.CUDAGraph`` capture, every graph in one memory pool.  Both
run with every row inactive, so their KV writes land in the trash page.
A capture that fails raises; there is no eager fallback on CUDA.  On the
CPU the same bodies run eagerly on the same buffer.

The graphs freeze every address they touch: the KV pools are written in
place and never replaced (model_runner.py), the parameters stay put, and
the inputs are views of the one buffer.  Kernel wrappers count their
launches in Python, which a replay does not run: the counts a capture
added are taken back and added again at each replay, so
``paged_decode_attention.launches`` and the others go on counting the
kernels that ran (``launch_counters``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

import numpy as np
import torch

from .model_runner import paged_decode, paged_multi_decode, paged_verify, sample_tokens


def launch_counters() -> List[Any]:
    """The kernel wrappers whose ``launches`` a replay must advance: those
    a decode or verify program can reach."""
    from ...ops.flash_attention import flash_attention_fwd
    from ...ops.grouped_matmul import grouped_matmul
    from ...ops.paged_attention import paged_decode_attention
    from ...ops.wq_matmul import wq_matmul

    return [flash_attention_fwd, paged_decode_attention, wq_matmul, grouped_matmul]


class DecodePrograms:
    """The decode, multi-step and verify programs of one engine.

    ``horizons``: the multi-step horizons to build (each > 1);
    ``verify_width``: the verify program's width (0: none).  Write the
    inputs into ``staging`` (:meth:`stage`), then :meth:`run` a program."""

    def __init__(self, cfg: Any, params: Any, pools: Dict[str, torch.Tensor], max_seqs: int,
                 max_pages_per_seq: int, seed: int, horizons: Iterable[int] = (),
                 verify_width: int = 0):
        self.cfg, self.params, self.pools, self.seed = cfg, params, pools, int(seed)
        self.B, self.MP, self.W = max_seqs, max_pages_per_seq, verify_width
        self.device = pools["k"].device
        B = self.B
        fields = (("last", B), ("pos", B), ("table", B * self.MP), ("act", B), ("temps", B),
                  ("sids", B), ("eos", B), ("budgets", B), ("ids", B * max(self.W, 1)),
                  ("n_valid", B))
        self._off: Dict[str, Tuple[int, int]] = {}
        n = 0
        for name, size in fields:
            self._off[name] = (n, size)
            n += size
        cuda = self.device.type == "cuda"
        self._host = torch.zeros((n,), dtype=torch.int32, pin_memory=cuda)
        #: the host twin of the input buffer (numpy, int32)
        self.staging = self._host.numpy()
        self._dev = self._host.to(self.device) if cuda else self._host
        self.keys: List[Any] = ["decode"] + [("multi", int(k)) for k in horizons]
        if self.W:
            self.keys.append("verify")
        #: replays (CUDA) or eager runs (CPU) of each program
        self.runs: Dict[Any, int] = {key: 0 for key in self.keys}
        self._graphs: Dict[Any, Tuple[Any, torch.Tensor, list]] = {}
        if cuda:
            self._pool = torch.cuda.graph_pool_handle()
            for key in self.keys:
                self._capture(key)

    # -- inputs ----------------------------------------------------------------
    def stage(self, **arrays: np.ndarray) -> None:
        """Write host arrays into the staging buffer by field name
        (``temps`` as float32 bits, the rest as int32)."""
        for name, arr in arrays.items():
            o, n = self._off[name]
            view = self.staging[o:o + n]
            if name == "temps":
                view = view.view(np.float32)
            view[:] = np.asarray(arr).reshape(-1)

    def _field(self, name: str) -> torch.Tensor:
        o, n = self._off[name]
        return self._dev[o:o + n]

    # -- program bodies --------------------------------------------------------
    def _decode_inputs(self):
        f = self._field
        return (f("last").long(), f("pos"), f("table").view(self.B, self.MP), f("act") != 0,
                f("temps").view(torch.float32), f("sids"))

    def _body(self, key):
        cfg, params, pools = self.cfg, self.params, self.pools
        if key == "decode":
            def decode():
                last, pos, table, act, temps, sids = self._decode_inputs()
                logits, _ = paged_decode(cfg, params, pools, last, pos, table, act)
                return sample_tokens(logits, temps, self.seed, sids, pos + 1)
            return decode
        if key == "verify":
            def verify():
                f = self._field
                logits, _ = paged_verify(cfg, params, pools, f("ids").view(self.B, self.W),
                                         f("pos"), f("table").view(self.B, self.MP),
                                         f("act") != 0, f("n_valid"))
                return torch.argmax(logits.float(), dim=-1).to(torch.int32).reshape(-1)
            return verify
        k = key[1]

        def multi():
            last, pos, table, act, temps, sids = self._decode_inputs()
            toks, produced, _ = paged_multi_decode(
                cfg, params, pools, last, pos, table, act, temps, self._field("eos"),
                self._field("budgets"), self.seed, sids, k)
            return torch.cat([toks.reshape(-1), produced])
        return multi

    def _capture(self, key) -> None:
        """Warm step, then capture, with every row inactive (the staging
        buffer zeroed: budgets 0, ``act`` 0)."""
        body = self._body(key)
        self.staging[:] = 0
        self._dev.copy_(self._host)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        counters = launch_counters()
        before = [fn.launches for fn in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            out = body()
        # the capture recorded these launches without running them
        deltas = [(fn, fn.launches - b) for fn, b in zip(counters, before) if fn.launches != b]
        for fn, d in deltas:
            fn.launches -= d
        self._graphs[key] = (graph, out, deltas)

    # -- dispatch --------------------------------------------------------------
    def run(self, key) -> np.ndarray:
        """Run program ``key`` on the staged inputs; its int32 result as
        numpy (``"decode"``: [B]; ``("multi", k)``: [B * k + B], the tokens
        row-major then the produced counts; ``"verify"``: [B * W])."""
        if self.device.type == "cuda":
            graph, out, deltas = self._graphs[key]
            self._dev.copy_(self._host, non_blocking=True)
            graph.replay()
            for fn, d in deltas:
                fn.launches += d
        else:
            out = self._body(key)()
        self.runs[key] += 1
        return out.cpu().numpy()
