"""Autotuner (``deepspeed_tpu/autotuning/autotuner.py``).

Mutates the ds-config over a search space (ZeRO stage, micro batch, the
fused Adam kernel), runs a short experiment for each candidate in this
process (an engine, one warm-up step and ``steps_per_trial`` timed steps,
the card drained before and after the timed ones) and picks the fastest.
A candidate whose analytical state floor exceeds the card's memory is
pruned before any engine is built.  Modes: ``grid`` (the space in order,
up to ``max_trials``), ``random`` (shuffled by a fixed seed) and ``model``
(a ridge-regression cost model fit on the trials so far proposes the next
candidate).  A failed trial (out of memory, an invalid combination) is
recorded as ``None``, its exception logged, and its engine and memory are
freed before the next trial.
"""

from __future__ import annotations

import gc
import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.logging import logger

DEFAULT_TUNING_SPACE = {
    "zero_stage": [0, 1, 2, 3],
    "micro_batch": [1, 2, 4, 8],
}


def _world_size() -> int:
    from ..launcher.multinode_runner import rank_env

    return int(rank_env()["WORLD_SIZE"])


class Autotuner:
    def __init__(self, model_factory: Callable[[], Any], base_config: Dict[str, Any],
                 batch_factory: Callable[[int], Any],
                 tuning_space: Optional[Dict[str, List]] = None,
                 steps_per_trial: int = 3, max_trials: int = 24, mode: str = "grid",
                 device: Any = None, world_size: Optional[int] = None):
        """``model_factory()`` -> a fresh model spec; ``batch_factory(micro_bs)``
        -> a ``train_batch`` input (gas leading dim).  ``device`` None means
        ``cuda``; ``world_size`` None is the launcher's ``WORLD_SIZE``
        (1 for a process started alone)."""
        self.model_factory = model_factory
        self.base_config = dict(base_config)
        self.batch_factory = batch_factory
        self.space = tuning_space or dict(DEFAULT_TUNING_SPACE)
        self.steps_per_trial = steps_per_trial
        self.max_trials = max_trials
        self.mode = mode
        self.device = device
        self.world_size = _world_size() if world_size is None else int(world_size)
        self.results: List[Dict[str, Any]] = []
        self.engines_built = 0

    def _candidates(self) -> List[Dict[str, Any]]:
        keys = list(self.space)
        combos = [dict(zip(keys, vals)) for vals in itertools.product(*self.space.values())]
        if self.mode in ("random", "model"):
            # model mode keeps the whole grid as the proposal pool (the budget
            # limits runs, not the searchable space), shuffled so the seed
            # trials span it
            np.random.RandomState(0).shuffle(combos)
        if self.mode == "model":
            return combos
        return combos[:self.max_trials]

    # -- the cost model: fit the observed trials, propose the best predicted
    def _featurize(self, cand: Dict[str, Any]) -> np.ndarray:
        feats = []
        for key, values in self.space.items():
            feats.extend(1.0 if cand.get(key) == v else 0.0 for v in values)
            if isinstance(cand.get(key), (int, float)):
                feats.append(float(np.log2(max(cand[key], 1))))
            else:
                feats.append(0.0)
        return np.asarray(feats + [1.0])

    def _fit_predict(self, tried: List[Tuple[Dict[str, Any], float]],
                     pool: List[Dict[str, Any]]) -> List[float]:
        """Ridge regression over one-hot and log features."""
        X = np.stack([self._featurize(c) for c, _ in tried])
        y = np.asarray([t for _, t in tried])
        w = np.linalg.solve(X.T @ X + 1e-3 * np.eye(X.shape[1]), X.T @ y)
        return [float(self._featurize(c) @ w) for c in pool]

    def _param_count(self) -> Optional[int]:
        """The model's parameter count, from its initialiser run on ``meta``
        tensors (shapes only: nothing is allocated or drawn)."""
        if not hasattr(self, "_n_params"):
            try:
                spec = self.model_factory()
                tree = spec._init_params(torch.Generator(), torch.device("meta"))
                self._n_params = sum(p.numel() for p in tree.parameters())
            except (AttributeError, RuntimeError, TypeError, ValueError) as e:
                logger.warning(f"autotuning: parameter count unavailable: {e}")
                self._n_params = None
        return self._n_params

    def _estimate_state_bytes(self, cand: Dict[str, Any]) -> Optional[int]:
        """Analytical ZeRO memory floor: live params (2 B), grads (4 B) and the
        fp32 master and two moments (12 B) a parameter, each divided by the
        world size from the stage that partitions it.  Activations are left
        out (a lower bound)."""
        n = self._param_count()
        if n is None:
            return None
        stage = cand.get("zero_stage",
                         self.base_config.get("zero_optimization", {}).get("stage", 0))
        shards = max(1, self.world_size)
        live = 2 * n / (shards if stage >= 3 else 1)
        grads = 4 * n / (shards if stage >= 2 else 1)
        state = 12 * n / (shards if stage >= 1 else 1)
        return int(live + grads + state)

    def _device_memory(self) -> Optional[int]:
        """The card's total memory (None without a card, or tuning on the
        CPU)."""
        if str(self.device) == "cpu" or not torch.cuda.is_available():
            return None
        return int(torch.cuda.mem_get_info()[1])

    def _trial_config(self, cand: Dict[str, Any]) -> Dict[str, Any]:
        cfg = dict(self.base_config)
        cfg["zero_optimization"] = dict(cfg.get("zero_optimization", {}))
        if "zero_stage" in cand:
            cfg["zero_optimization"]["stage"] = cand["zero_stage"]
        if "micro_batch" in cand:
            cfg["train_micro_batch_size_per_gpu"] = cand["micro_batch"]
            cfg.pop("train_batch_size", None)
        if "fused_kernel" in cand:
            # the hand-written Adam kernel against the plain PyTorch update
            opt = dict(cfg.get("optimizer", {"type": "FusedAdam", "params": {}}))
            if str(opt.get("type", "adamw")).lower() not in (
                    "adam", "adamw", "fusedadam", "deepspeedcpuadam"):
                # other optimizers ignore the knob: injecting it would double
                # the grid with identical trials
                logger.warning(f"autotuner: fused_kernel is not tunable for optimizer "
                               f"type {opt.get('type')!r}; dropping the knob")
            else:
                opt["params"] = {**opt.get("params", {}),
                                 "fused_kernel": bool(cand["fused_kernel"])}
                cfg["optimizer"] = opt
        return cfg

    def _sync(self) -> None:
        if str(self.device) != "cpu" and torch.cuda.is_available():
            torch.cuda.synchronize()

    def _run_trial(self, cand: Dict[str, Any]) -> Optional[float]:
        """Tokens a second of one candidate, or None when it fails."""
        import deepspeed_tpu_torch

        cfg = self._trial_config(cand)
        engine = None
        try:
            engine, *_ = deepspeed_tpu_torch.initialize(model=self.model_factory(), config=cfg,
                                                       device=self.device)
            self.engines_built += 1
            batch = self.batch_factory(cfg["train_micro_batch_size_per_gpu"])
            engine.train_batch(batch)  # warm-up
            self._sync()
            t0 = time.perf_counter()
            for _ in range(self.steps_per_trial):
                engine.train_batch(batch)
            self._sync()
            dt = (time.perf_counter() - t0) / self.steps_per_trial
            leaf = batch[0] if isinstance(batch, (list, tuple)) else batch
            if isinstance(leaf, dict):
                leaf = next(iter(leaf.values()))
            return float(np.prod(tuple(leaf.shape))) / dt
        except (RuntimeError, ValueError, NotImplementedError, TypeError) as e:
            # out of memory or an invalid combination: recorded as None
            logger.warning(f"autotuning trial {cand} failed: {type(e).__name__}: {e}")
            return None
        finally:
            if engine is not None:
                engine.close()
            del engine
            gc.collect()
            if str(self.device) != "cpu" and torch.cuda.is_available():
                torch.cuda.empty_cache()

    def _pruned_pool(self) -> List[Dict[str, Any]]:
        """The candidates minus those whose analytical memory floor exceeds
        the card's memory, each pruned one recorded."""
        pool = self._candidates()
        hbm = self._device_memory()
        if hbm:
            kept = []
            for cand in pool:
                est = self._estimate_state_bytes(cand)
                if est is not None and est > hbm:
                    logger.info(f"autotuning: {cand} pruned (state floor {est / 1e9:.1f}GB > "
                                f"device memory {hbm / 1e9:.1f}GB)")
                    self.results.append({"config": cand, "throughput": None, "pruned": True})
                else:
                    kept.append(cand)
            pool = kept
        return pool

    def tune_parallel(self, runner, nodes=None, slots_per_exp: int = 1,
                      max_parallel: Optional[int] = None,
                      early_stop_patience: Optional[int] = None) -> Dict[str, Any]:
        """Dispatch grid or random candidates concurrently over host slots
        (``scheduler.ResourceManager``); ``runner(exp, reservation)`` runs
        one trial (``scheduler.SubprocessTrialRunner`` out of process).
        Model mode proposes from earlier results and is sequential: use
        :meth:`tune`."""
        from .scheduler import Node, ResourceManager

        if self.mode == "model":
            raise ValueError("model-based tuning is sequential; use tune()")
        pool = self._pruned_pool()[:self.max_trials]
        rm = ResourceManager(nodes or [Node("localhost", 1)], runner,
                             slots_per_exp=slots_per_exp, max_parallel=max_parallel)
        rm.schedule_experiments([{"name": f"trial_{i}", "config": self._trial_config(c),
                                  "cand": c} for i, c in enumerate(pool)])
        finished = rm.run(early_stop_patience=early_stop_patience)
        best, best_tput = None, -1.0
        by_name = {f"trial_{i}": c for i, c in enumerate(pool)}
        for rec in finished:
            cand = by_name.get(rec["name"])
            self.results.append({"config": cand, "throughput": rec["throughput"],
                                 "host": rec.get("host"), "error": rec.get("error")})
            if rec["throughput"] is not None and rec["throughput"] > best_tput:
                best, best_tput = cand, rec["throughput"]
        if best is None:
            raise RuntimeError("all autotuning trials failed")
        return {"best": best, "throughput": best_tput, "config": self._trial_config(best),
                "trials": self.results}

    def tune(self) -> Dict[str, Any]:
        """The best candidate, every trial recorded in ``results``.  Model
        mode runs up to three seed trials, then lets the cost model fit on
        the throughputs so far propose each next candidate; grid and random
        run the pool in order."""
        pool = self._pruned_pool()
        best, best_tput = None, -1.0
        tried: List[Tuple[Dict[str, Any], float]] = []

        def run_one(cand):
            nonlocal best, best_tput
            tput = self._run_trial(cand)
            self.results.append({"config": cand, "throughput": tput})
            logger.info(f"autotuning: {cand} -> "
                        f"{'FAIL' if tput is None else f'{tput:.0f} tok/s'}")
            if tput is not None:
                tried.append((cand, tput))
                if tput > best_tput:
                    best, best_tput = cand, tput

        if self.mode == "model":
            seeds = min(3, len(pool))
            for cand in pool[:seeds]:
                run_one(cand)
            remaining = pool[seeds:]
            budget = self.max_trials - seeds
            while remaining and budget > 0:
                if tried:
                    nxt = remaining.pop(int(np.argmax(self._fit_predict(tried, remaining))))
                else:
                    # every seed failed: probe in pool order until one works
                    nxt = remaining.pop(0)
                run_one(nxt)
                budget -= 1
        else:
            for cand in pool:
                run_one(cand)

        if best is None:
            raise RuntimeError("all autotuning trials failed")
        return {"best": best, "throughput": best_tput, "config": self._trial_config(best),
                "trials": self.results}
