"""ZenFlow: optimizer offload with importance-aware updates — the
counterpart of ``deepspeed_tpu/runtime/zenflow/zenflow.py``.

* fast path: at every boundary the top-k "important" columns (by the
  gradient's squared sum over the other axes) of each >= 2-D leaf get an
  immediate numpy Adam update; 1-D leaves always take it;
* slow path: the other columns' gradients accumulate in a host buffer and
  every ``update_interval`` boundaries a background thread applies them,
  on snapshots, while the next interval's fast boundaries proceed;
* merge: at the next interval boundary the slow result is taken column by
  column, except the columns the fast path wrote meanwhile (those belong to
  the fast path; their slow residual is queued again).

The host arrays keep their leaves' shapes (the port's per-layer leaves;
the JAX package's leaves stack the layers on a leading axis, so the two
pick columns over different blocks).  The engine drives a step as
``begin_step`` -> ``step_leaves`` -> ``finish_step``; ``apply_step`` is
the whole-list call of the JAX module.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...utils.logging import logger
from ..config import ZenFlowConfig  # noqa: F401  (re-exported)
from ..zero.offload import _leaves, scale_and_clip


def _adam_update(master, g, m, v, step, lr, b1, b2, eps, wd, adamw):
    """Vectorised numpy Adam(W) on (views of) master/m/v, in place."""
    m *= b1
    m += (1 - b1) * g
    v *= b2
    v += (1 - b2) * g * g
    mh = m / (1 - b1 ** step)
    vh = v / (1 - b2 ** step)
    if adamw and wd:
        master *= (1 - lr * wd)
    master -= lr * mh / (np.sqrt(vh) + eps)


class ZenFlowOptimizer:
    """Host optimizer with the ZenFlow fast/slow split."""

    def __init__(self, abstract_params: Any, optimizer_config: Dict[str, Any],
                 zenflow_config: Optional[ZenFlowConfig] = None, grad_clip: float = 0.0):
        p = dict(optimizer_config.get("params") or {})
        betas = p.get("betas", (0.9, 0.999))
        self.lr = float(p.get("lr", 1e-3))
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(p.get("eps", 1e-8))
        self.wd = float(p.get("weight_decay", 0.0))
        self.adamw = bool(p.get("adam_w_mode", True)) or \
            str(optimizer_config.get("type", "adamw")).lower().endswith("w")
        self.zf = zenflow_config or ZenFlowConfig(enabled=True)
        self.grad_clip = grad_clip
        self.master: List[np.ndarray] = []
        self._m: List[np.ndarray] = []
        self._v: List[np.ndarray] = []
        self._accum: List[np.ndarray] = []
        # columns the fast path wrote since the running slow pass launched
        self._fast_mask: List[Optional[np.ndarray]] = []
        # columns that received slow residual this interval (the slow pass
        # updates whole touched columns: zero-grad elements in them still get
        # Adam's moment decay)
        self._slow_touched: List[Optional[np.ndarray]] = []
        self.step_count = 0
        self._slow_thread: Optional[threading.Thread] = None
        self._slow_result: Optional[Tuple[List, List, List, List, List]] = None
        self._will_launch = False

    # -- lifecycle ---------------------------------------------------------------
    def initialize_master(self, init_params: Any) -> None:
        self.master = []
        for i, x in enumerate(_leaves(init_params)):
            self.adopt_master(i, x)

    def adopt_master(self, i: int, leaf: Any) -> None:
        if i != len(self.master):
            raise ValueError(f"adopt_master: leaf {i} out of order ({len(self.master)} held)")
        x = (leaf.detach().to("cpu", torch.float32).numpy().copy()
             if isinstance(leaf, torch.Tensor) else np.asarray(leaf, np.float32).copy())
        self.master.append(x)
        self._m.append(np.zeros_like(x))
        self._v.append(np.zeros_like(x))
        self._accum.append(np.zeros_like(x))
        self._fast_mask.append(None)
        self._slow_touched.append(np.zeros(x.shape[-1], bool) if x.ndim >= 2 else None)
        if i == 0:
            logger.info(f"zenflow: topk_ratio={self.zf.topk_ratio} "
                        f"interval={self.zf.update_interval}")

    def master_bytes(self) -> int:
        return int(sum(m.nbytes for m in self.master if m is not None))

    def moment_bytes(self) -> int:
        """Host RAM of the Adam moments and the accumulation buffers."""
        return int(sum(b.nbytes for bufs in (self._m, self._v, self._accum)
                       for b in bufs if b is not None))

    # -- slow path -----------------------------------------------------------------
    def _slow_pass(self, snap_master, snap_m, snap_v, snap_accum, snap_touched, step, lr):
        denom = float(self.zf.update_interval)
        for i in range(len(snap_master)):
            tm = snap_touched[i]
            if tm is None or not tm.any():
                continue
            if tm.all():  # the common case: update in place
                _adam_update(snap_master[i], snap_accum[i] / denom, snap_m[i], snap_v[i], step,
                             lr, self.b1, self.b2, self.eps, self.wd, self.adamw)
                continue
            sel = np.nonzero(tm)[0]
            g = snap_accum[i][..., sel] / denom
            xs, ms, vs = snap_master[i][..., sel], snap_m[i][..., sel], snap_v[i][..., sel]
            _adam_update(xs, g, ms, vs, step, lr, self.b1, self.b2, self.eps, self.wd,
                         self.adamw)
            snap_master[i][..., sel] = xs
            snap_m[i][..., sel] = ms
            snap_v[i][..., sel] = vs
        self._slow_result = (snap_master, snap_m, snap_v, snap_touched, snap_accum)

    def _wait_slow(self) -> None:
        """Let the running slow pass finish; its result stays pending."""
        if self._slow_thread is not None:
            self._slow_thread.join()
            self._slow_thread = None

    def _join_slow(self) -> None:
        """Merge the pending slow pass (after it finishes)."""
        self._wait_slow()
        if self._slow_result is None:
            return
        new_master, new_m, new_v, snap_touched, snap_accum = self._slow_result
        self._slow_result = None
        for i in range(len(self.master)):
            tm = snap_touched[i]
            if tm is None or not tm.any():
                continue
            take = tm.copy()
            fm = self._fast_mask[i]
            if fm is not None:
                take &= ~fm  # the fast path's columns keep its values ...
                dropped = tm & fm
                if dropped.any():  # ... and their residual goes round again
                    cols = np.nonzero(dropped)[0]
                    self._accum[i][..., cols] += snap_accum[i][..., cols]
                    self._slow_touched[i][cols] = True
            if take.any():
                cols = np.nonzero(take)[0]
                self.master[i][..., cols] = new_master[i][..., cols]
                self._m[i][..., cols] = new_m[i][..., cols]
                self._v[i][..., cols] = new_v[i][..., cols]
        self._fast_mask = [None] * len(self.master)

    def _launch_slow(self, lr: float) -> bool:
        """Start the slow pass; True when it already ran and replaced every
        leaf (``overlap_step`` off)."""
        snap = ([x.copy() for x in self.master], [x.copy() for x in self._m],
                [x.copy() for x in self._v], [x.copy() for x in self._accum],
                [t.copy() if t is not None else None for t in self._slow_touched])
        for a in self._accum:
            a[...] = 0.0
        for t in self._slow_touched:
            if t is not None:
                t[:] = False
        for i, x in enumerate(self.master):
            self._fast_mask[i] = np.zeros(x.shape[-1], bool) if x.ndim >= 2 else None
        if self.zf.overlap_step:
            self._slow_thread = threading.Thread(target=self._slow_pass,
                                                 args=(*snap, self.step_count, lr), daemon=True)
            self._slow_thread.start()
            return False
        self._slow_pass(*snap, self.step_count, lr)
        new_master, new_m, new_v, _, _ = self._slow_result
        self._slow_result = None
        # in place: the caller's views of the master stay valid
        for dst, src in zip((self.master, self._m, self._v), (new_master, new_m, new_v)):
            for d, s in zip(dst, src):
                d[...] = s
        self._fast_mask = [None] * len(self.master)
        return True

    # -- the boundary step -----------------------------------------------------------
    def begin_step(self, lr: float) -> None:
        self.step_count += 1
        self.lr = lr
        warm_now = self.step_count <= self.zf.full_warm_up_rounds
        self._warm = warm_now
        self._will_launch = (not warm_now) and self.step_count % self.zf.update_interval == 0
        if self._will_launch:
            # merge the slow pass launched at the previous interval boundary
            # before snapshotting the next one
            self._join_slow()

    def step_leaves(self, start: int, grads: Sequence[np.ndarray], lr: float) -> None:
        step = self.step_count
        for k, g in enumerate(grads):
            i = start + k
            x = self.master[i]
            g = np.asarray(g, np.float32).reshape(x.shape)
            if self._warm or x.ndim < 2 or self.zf.topk_ratio >= 1.0:
                _adam_update(x, g, self._m[i], self._v[i], step, lr, self.b1, self.b2,
                             self.eps, self.wd, self.adamw)
                continue
            ncols = x.shape[-1]
            k_cols = max(1, int(round(self.zf.topk_ratio * ncols)))
            col_imp = np.sum(g * g, axis=tuple(range(g.ndim - 1)))
            sel = np.argpartition(col_imp, ncols - k_cols)[ncols - k_cols:]
            # fast path: gather, update, scatter back (fancy indexing copies)
            xs, gsel = x[..., sel], g[..., sel]
            ms, vs = self._m[i][..., sel], self._v[i][..., sel]
            _adam_update(xs, gsel, ms, vs, step, lr, self.b1, self.b2, self.eps, self.wd,
                         self.adamw)
            x[..., sel] = xs
            self._m[i][..., sel] = ms
            self._v[i][..., sel] = vs
            if self._fast_mask[i] is not None:
                self._fast_mask[i][sel] = True
            # slow path: this step's other columns accumulate; residual queued
            # from earlier steps at the selected columns stays queued
            g_slow = g.copy()
            g_slow[..., sel] = 0.0
            self._accum[i] += g_slow
            if self._slow_touched[i] is not None:
                unsel = np.ones(ncols, bool)
                unsel[sel] = False
                self._slow_touched[i] |= unsel

    def finish_step(self, lr: float) -> Iterable[int]:
        """Launch the slow pass at an interval boundary; returns the leaves
        it changed after their ``step_leaves`` (all of them when it ran
        inline)."""
        if self._will_launch and self._launch_slow(lr):
            return range(len(self.master))
        return ()

    def apply_step(self, grads_flat: List[np.ndarray], lr: float,
                   denom: float) -> Tuple[List[np.ndarray], float]:
        self.begin_step(lr)
        gs, norm = scale_and_clip(grads_flat, denom, self.grad_clip,
                                  shapes=[x.shape for x in self.master])
        self.step_leaves(0, gs, lr)
        self.finish_step(lr)
        return self.master, norm

    def master_as_tree(self, like: torch.nn.Module) -> torch.nn.Module:
        self._join_slow()
        it = iter(self.master)
        return like.map(lambda t: torch.from_numpy(next(it).reshape(t.shape)))

    def state_dict(self) -> Dict[str, Any]:
        self._join_slow()
        return {"step": self.step_count, "master": [x.copy() for x in self.master],
                "m": [x.copy() for x in self._m], "v": [x.copy() for x in self._v],
                "accum": [x.copy() for x in self._accum],
                "touched": [t.copy() if t is not None else None for t in self._slow_touched]}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self._join_slow()
        self.step_count = int(sd["step"])
        self.master = [np.asarray(x, np.float32) for x in sd["master"]]
        self._m = [np.asarray(x, np.float32) for x in sd["m"]]
        self._v = [np.asarray(x, np.float32) for x in sd["v"]]
        self._accum = [np.asarray(x, np.float32) for x in sd["accum"]]
        self._fast_mask = [None] * len(self.master)
        self._slow_touched = [np.asarray(t, bool) if t is not None else None
                              for t in sd["touched"]]

    # -- checkpoints: the live arrays, read and refilled in place ---------------
    _PENDING = ("pending_master", "pending_m", "pending_v", "pending_touched",
                "pending_accum")

    def checkpoint_scalars(self) -> Dict[str, np.ndarray]:
        """The step count and whether a slow pass is pending (its result and
        the fast path's columns since its launch are then saved as they
        are, unmerged, so a resumed run merges them where this one would)."""
        self._wait_slow()
        return {"step": np.asarray(self.step_count, np.int64),
                "pending": np.asarray(self._slow_result is not None)}

    def load_checkpoint_scalars(self, scalars: Dict[str, np.ndarray]) -> None:
        self._wait_slow()
        self.step_count = int(scalars["step"])
        pending = bool(scalars.get("pending", False))
        self._slow_result = None
        self._fast_mask = [None] * len(self.master)
        if pending:
            self._slow_result = (
                [np.empty_like(x) for x in self.master], [np.empty_like(x) for x in self._m],
                [np.empty_like(x) for x in self._v],
                [None if t is None else np.empty_like(t) for t in self._slow_touched],
                [np.empty_like(x) for x in self._accum])
            self._fast_mask = [np.zeros(x.shape[-1], bool) if x.ndim >= 2 else None
                               for x in self.master]

    def checkpoint_state(self) -> Dict[str, List[Any]]:
        """The host arrays by name, one entry per leaf (None where a leaf
        has none: the column masks of 1-D leaves)."""
        self._wait_slow()
        out: Dict[str, List[Any]] = {"master": self.master, "m": self._m, "v": self._v,
                                     "accum": self._accum, "touched": self._slow_touched}
        if self._slow_result is not None:
            out.update(zip(self._PENDING, self._slow_result))
            out["fast_mask"] = self._fast_mask
        return {k: list(v) for k, v in out.items()}

    def close(self) -> None:
        self._join_slow()
