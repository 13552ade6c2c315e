"""The training dataloader — the port's counterpart of
``deepspeed_tpu/runtime/dataloader.py``.

:class:`DeepSpeedDataLoader` draws micro-batches from an indexable dataset
(numpy arrays, an ``MMapIndexedDataset``, a list of samples) in the JAX
loader's order (``RandomState(seed + epoch)`` shuffle, ``drop_last``, wrap
padding) and yields them as tensors on the engine's device.  Samples are
collated straight into a pinned host tensor (for a CUDA device), which is
copied with ``non_blocking``: no numpy staging of the whole batch.  One
process holds the data-parallel group, so the global batch is the
micro-batch.

Unsigned token arrays (an indexed dataset's ``uint16``/``uint32`` codes)
are widened to ``int32``/``int64`` as they are collated: torch indexes an
embedding with signed integers only.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from ..accelerator import DeviceLike, resolve_device

#: numpy unsigned token types -> the signed type they are collated into
_WIDEN = {np.dtype(np.uint16): np.int32, np.dtype(np.uint32): np.int64,
          np.dtype(np.uint64): np.int64}


def _collate_leaf(rows, pin: bool) -> torch.Tensor:
    first = np.asarray(rows[0])
    dtype = np.dtype(_WIDEN.get(first.dtype, first.dtype))
    out = torch.empty((len(rows),) + first.shape, dtype=torch.from_numpy(
        np.empty(0, dtype)).dtype, pin_memory=pin)
    host = out.numpy()
    for i, r in enumerate(rows):
        host[i] = r
    return out


def default_collate(samples, pin: bool = False):
    """Stack samples (arrays, or tuples / dicts of arrays) on a new leading
    dim into host tensors, pinned when ``pin``."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return tuple(_collate_leaf([s[i] for s in samples], pin) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _collate_leaf([s[k] for s in samples], pin) for k in first}
    return _collate_leaf(samples, pin)


def to_device(batch: Any, device: torch.device) -> Any:
    """A batch's arrays and tensors (in dicts, lists, tuples) on ``device``,
    copied with ``non_blocking`` (asynchronous from pinned host memory)."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_device(v, device) for v in batch)
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(batch)
    if isinstance(batch, torch.Tensor):
        return batch.to(device, non_blocking=True)
    return batch


class RepeatingLoader:
    """Wraps an iterable to repeat forever (the reference's
    ``RepeatingLoader``)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DeepSpeedDataLoader:
    def __init__(self, dataset: Any, batch_size: int, device: DeviceLike = None,
                 collate_fn: Optional[Callable] = None, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size  # the micro-batch
        self.device = resolve_device(device)
        self.collate_fn = collate_fn
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        n = len(dataset)
        self.num_batches = n // batch_size if drop_last else -(-n // batch_size)

    def __len__(self) -> int:
        return self.num_batches

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        usable = self.num_batches * self.batch_size
        if usable > n:  # pad by wrapping (drop_last=False)
            idx = np.concatenate([idx, idx[:usable - n]])
        return idx[:usable]

    def __iter__(self) -> Iterator:
        pin = self.device.type == "cuda"
        idx = self._indices()
        for b in range(self.num_batches):
            samples = [self.dataset[int(i)] for i in idx[b * self.batch_size:
                                                         (b + 1) * self.batch_size]]
            host = (self.collate_fn(samples) if self.collate_fn is not None
                    else default_collate(samples, pin))
            yield to_device(host, self.device)
        self.epoch += 1
