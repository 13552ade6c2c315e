"""Offline data analysis for curriculum learning — the port's copy of
``deepspeed_tpu/runtime/data_pipeline/data_analyzer.py`` (plain numpy; the
same files on disk).

Reference parity: ``runtime/data_pipeline/data_sampling/data_analyzer.py``
— maps metric functions over a dataset (optionally splitting the work
across workers), writes per-sample metric values plus a
sample-index-sorted-by-metric file, which the curriculum sampler then
consumes (``DeepSpeedDataSampler`` reads index_to_sample /
index_to_metric).

Host-side numpy throughout: analysis runs once, offline, before training.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from ...utils.logging import logger

MetricFn = Callable[[Any], float]


# built-in metrics (reference: seqlen / vocab rarity metrics)
def metric_seqlen(sample: Any) -> float:
    ids = sample["input_ids"] if isinstance(sample, dict) else sample
    arr = np.asarray(ids)
    return float(arr.shape[-1] if arr.ndim else 0)


def metric_total_vocab_freq(vocab_freq: np.ndarray) -> MetricFn:
    """Rarity: -sum(log freq) of the sample's tokens (rarer = harder)."""
    logf = np.log(np.maximum(vocab_freq, 1)) - np.log(max(vocab_freq.sum(), 1))

    def fn(sample: Any) -> float:
        ids = np.asarray(sample["input_ids"] if isinstance(sample, dict)
                         else sample).ravel()
        return float(-logf[ids].sum())

    return fn


def metric_vocab_histogram(vocab_size: int) -> MetricFn:
    """ACCUMULATE-type metric: per-sample token histogram, summed over the
    corpus by map-reduce (reference vocab_rarity two-pass: accumulate the
    corpus frequency first, then score samples against it)."""

    def fn(sample: Any) -> np.ndarray:
        ids = np.asarray(sample["input_ids"] if isinstance(sample, dict)
                         else sample).ravel()
        return np.bincount(ids, minlength=vocab_size).astype(np.float64)

    return fn


class DataAnalyzer:
    """Run metrics over a dataset and persist curriculum index files
    (reference DataAnalyzer.run_map / run_reduce)."""

    def __init__(self, dataset: Sequence[Any],
                 metric_names: Optional[List[str]] = None,
                 metric_functions: Optional[List[MetricFn]] = None,
                 metric_types: Optional[List[str]] = None,
                 save_path: str = "./data_analysis",
                 num_workers: int = 1, worker_id: int = 0):
        self.dataset = dataset
        self.metric_names = metric_names or ["seqlen"]
        self.metric_functions = metric_functions or [metric_seqlen]
        if len(self.metric_names) != len(self.metric_functions):
            raise ValueError("metric_names and metric_functions must pair up")
        # reference metric types (data_analyzer.py:22): per-sample values
        # feed the curriculum index; accumulate-type metrics sum an array
        # over the whole corpus (e.g. vocab frequency) for a later pass
        self.metric_types = (metric_types
                             or ["single_value_per_sample"] * len(self.metric_names))
        for t in self.metric_types:
            if t not in ("single_value_per_sample",
                         "accumulate_value_over_samples"):
                raise ValueError(f"unknown metric_type {t}")
        self.save_path = save_path
        self.num_workers = max(1, num_workers)
        self.worker_id = worker_id

    def _my_indices(self) -> np.ndarray:
        n = len(self.dataset)
        return np.arange(self.worker_id, n, self.num_workers)

    def run_map(self) -> Dict[str, np.ndarray]:
        """Compute this worker's metric shard and write it to disk."""
        os.makedirs(self.save_path, exist_ok=True)
        idx = self._my_indices()
        out: Dict[str, np.ndarray] = {}
        for name, fn, mtype in zip(self.metric_names, self.metric_functions,
                                   self.metric_types):
            if mtype == "accumulate_value_over_samples":
                acc = None
                for i in idx:
                    v = np.asarray(fn(self.dataset[int(i)]), np.float64)
                    acc = v if acc is None else acc + v
                if acc is None:
                    acc = np.zeros(0, np.float64)
                np.save(self._shard_file(name, self.worker_id), acc)
                out[name] = acc
            else:
                vals = np.asarray([fn(self.dataset[int(i)]) for i in idx],
                                  np.float64)
                np.save(self._shard_file(name, self.worker_id),
                        np.stack([idx.astype(np.float64), vals]))
                out[name] = vals
        logger.info(f"DataAnalyzer: worker {self.worker_id} mapped "
                    f"{idx.size} samples x {len(self.metric_names)} metrics")
        return out

    def run_reduce(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Merge all worker shards; write index_to_metric /
        index_to_sample_percentile_merged files (reference naming).
        Accumulate-type metrics reduce by summation instead."""
        result: Dict[str, Dict[str, np.ndarray]] = {}
        for name, mtype in zip(self.metric_names, self.metric_types):
            shards = []
            for w in range(self.num_workers):
                f = self._shard_file(name, w)
                if not os.path.exists(f):
                    raise FileNotFoundError(
                        f"missing shard {f}: did worker {w} run run_map()?")
                shards.append(np.load(f))
            if mtype == "accumulate_value_over_samples":
                width = max(s.size for s in shards)
                total = np.zeros(width, np.float64)
                for s in shards:
                    total[:s.size] += s
                result[name] = {"accumulated": total}
                np.save(os.path.join(self.save_path,
                                     f"{name}_accumulated.npy"), total)
                continue
            merged = np.concatenate(shards, axis=1)
            order = np.argsort(merged[0])
            sample_idx = merged[0][order].astype(np.int64)
            values = merged[1][order]
            by_metric = np.argsort(values, kind="stable")
            result[name] = {
                "index_to_metric": values,
                "metric_to_sample": sample_idx[by_metric],
            }
            np.save(os.path.join(self.save_path, f"{name}_index_to_metric.npy"),
                    values)
            np.save(os.path.join(self.save_path, f"{name}_metric_to_sample.npy"),
                    sample_idx[by_metric])
        with open(os.path.join(self.save_path, "analysis_summary.json"), "w") as f:
            json.dump({"num_samples": len(self.dataset),
                       "metrics": self.metric_names}, f)
        return result

    def _shard_file(self, metric: str, worker: int) -> str:
        return os.path.join(self.save_path, f"{metric}_worker{worker}.npy")

    @classmethod
    def run_map_reduce(cls, dataset: Sequence[Any], save_path: str,
                       num_workers: int = 1,
                       max_parallel: Optional[int] = None,
                       **kw) -> Dict[str, Dict[str, np.ndarray]]:
        """Concurrent map-reduce driver (reference run_map_reduce,
        data_analyzer.py:22 — there over torch.distributed workers; here a
        thread pool runs the per-worker maps concurrently, then one reduce
        merges the shards).  Metric fns are numpy-bound, so threads give
        real parallelism for IO-heavy corpora; each worker touches only its
        own shard files."""
        from concurrent.futures import ThreadPoolExecutor

        workers = [cls(dataset, save_path=save_path, num_workers=num_workers,
                       worker_id=w, **kw) for w in range(num_workers)]
        with ThreadPoolExecutor(max_workers=max_parallel or num_workers) as pool:
            futures = [pool.submit(w.run_map) for w in workers]
            for f in futures:
                f.result()
        return workers[0].run_reduce()


def load_difficulties(save_path: str, metric: str) -> np.ndarray:
    """Per-sample difficulty values for DeepSpeedDataSampler."""
    return np.load(os.path.join(save_path, f"{metric}_index_to_metric.npy"))
