"""Memory-mapped indexed dataset (Megatron ``.bin``/``.idx`` format) — the
port's copy of ``deepspeed_tpu/runtime/data_pipeline/indexed_dataset.py``
(plain numpy): a pair of files either package writes reads in the other.

Reference parity: ``runtime/data_pipeline/data_sampling/indexed_dataset.py``
(the Megatron-LM mmap format DeepSpeed's data sampler reads).  The on-disk
layout is byte-compatible so corpora tokenized by Megatron/DeepSpeed
tooling load directly:

  .idx: magic ``MMIDIDX\\x00\\x00`` | version u64 | dtype code u8 |
        n_sequences u64 | n_docs u64 | sizes i32[n] | pointers i64[n] |
        doc_idx i64[n_docs]
  .bin: the token arrays, back to back.

Reads are zero-copy numpy views over one mmap; the dataloader
(``runtime/dataloader.py``) collates them into pinned host batches.
"""

from __future__ import annotations

import os
import struct
from typing import List, Union

import numpy as np

_MAGIC = b"MMIDIDX\x00\x00"
_VERSION = 1

#: dtype codes — the reference's `dtypes` table (its indexed_dataset.py
#: line ~102).  NOTE: codes 6-8 differ from CLASSIC Megatron/fairseq
#: (which used 6=float32, 7=float64, 8=uint16); we match the reference
#: this framework tracks.  Corpora from old-Megatron tooling with codes
#: 6-8 would need re-encoding (4/5, the int tokens, are identical).
_CODE_TO_DTYPE = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32,
                  5: np.int64, 6: np.uint16, 7: np.uint32, 8: np.uint64}
_DTYPE_TO_CODE = {np.dtype(v): k for k, v in _CODE_TO_DTYPE.items()}


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


class MMapIndexedDataset:
    """Random-access reader; ``ds[i]`` returns sequence i as a numpy view."""

    def __init__(self, path_prefix: str):
        self.path_prefix = path_prefix
        with open(index_file_path(path_prefix), "rb") as f:
            magic = f.read(9)
            if magic != _MAGIC:
                raise ValueError(f"{index_file_path(path_prefix)}: not an "
                                 "MMIDIDX indexed dataset")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != _VERSION:
                raise ValueError(f"unsupported index version {version}")
            (code,) = struct.unpack("<B", f.read(1))
            if code not in _CODE_TO_DTYPE:
                raise ValueError(
                    f"{index_file_path(path_prefix)}: unknown dtype code "
                    f"{code} (corrupt index, or a foreign format?)")
            self.dtype = np.dtype(_CODE_TO_DTYPE[code])
            (n_seq,) = struct.unpack("<Q", f.read(8))
            (n_doc,) = struct.unpack("<Q", f.read(8))
            offset = f.tell()
        idx_buf = np.memmap(index_file_path(path_prefix), mode="r", order="C")
        self.sizes = np.frombuffer(idx_buf, np.int32, count=n_seq,
                                   offset=offset)
        offset += n_seq * 4
        self.pointers = np.frombuffer(idx_buf, np.int64, count=n_seq,
                                      offset=offset)
        offset += n_seq * 8
        self.doc_idx = np.frombuffer(idx_buf, np.int64, count=n_doc,
                                     offset=offset)
        bin_path = data_file_path(path_prefix)
        if os.path.getsize(bin_path) == 0:  # valid empty shard
            self._bin = np.zeros(0, np.uint8)
        else:
            self._bin = np.memmap(bin_path, mode="r", order="C")

    def __len__(self) -> int:
        return len(self.sizes)

    def __getitem__(self, i: Union[int, slice]):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        ptr, size = int(self.pointers[i]), int(self.sizes[i])
        return np.frombuffer(self._bin, self.dtype, count=size, offset=ptr)

    def get(self, i: int, offset: int = 0, length: int = None):
        """Sub-range of sequence i (reference ``MMapIndexedDataset.get``)."""
        seq = self[i]
        end = len(seq) if length is None else offset + length
        return seq[offset:end]


class MMapIndexedDatasetBuilder:
    """Streaming writer producing the byte-compatible pair of files."""

    def __init__(self, out_prefix: str, dtype=np.int32):
        self.prefix = out_prefix
        self.dtype = np.dtype(dtype)
        if self.dtype not in _DTYPE_TO_CODE:
            raise ValueError(f"unsupported dtype {dtype}")
        self._bin = open(data_file_path(out_prefix), "wb")
        self.sizes: List[int] = []
        self.doc_idx: List[int] = [0]

    def add_item(self, tokens) -> None:
        arr = np.asarray(tokens)
        if arr.size and arr.dtype != self.dtype:
            if not np.issubdtype(arr.dtype, np.integer):
                # float/NaN token arrays would truncate or be undefined
                raise ValueError(
                    f"token array dtype {arr.dtype} is not integral; "
                    "tokenize to ints before building")
            info = np.iinfo(self.dtype)
            lo, hi = int(arr.min()), int(arr.max())
            if lo < info.min or hi > info.max:
                raise ValueError(
                    f"token ids [{lo}, {hi}] do not fit dtype "
                    f"{self.dtype} — silent casting would wrap them")
        arr = arr.astype(self.dtype, copy=False)
        self._bin.write(arr.tobytes(order="C"))
        self.sizes.append(arr.size)

    def end_document(self) -> None:
        self.doc_idx.append(len(self.sizes))

    def finalize(self) -> str:
        self._bin.close()
        _write_index(self.prefix, self.dtype, self.sizes, self.doc_idx)
        return self.prefix


def _write_index(prefix: str, dtype: np.dtype, sizes: List[int],
                 doc_idx: List[int]) -> None:
    pointers = np.zeros(len(sizes), np.int64)
    if len(sizes) > 1:  # exclusive scan of byte sizes
        np.cumsum(np.asarray(sizes[:-1], np.int64) * dtype.itemsize,
                  out=pointers[1:])
    with open(index_file_path(prefix), "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", _VERSION))
        f.write(struct.pack("<B", _DTYPE_TO_CODE[dtype]))
        f.write(struct.pack("<Q", len(sizes)))
        f.write(struct.pack("<Q", len(doc_idx)))
        f.write(np.asarray(sizes, np.int32).tobytes(order="C"))
        f.write(pointers.tobytes(order="C"))
        f.write(np.asarray(doc_idx, np.int64).tobytes(order="C"))


def merge_datasets(prefixes: List[str], out_prefix: str) -> str:
    """Concatenate datasets (reference ``merge_file_``): bulk-copies each
    ``.bin`` and rebases the index arrays — no per-sequence re-encode.
    Doc-boundary semantics match the reference exactly (doc_idx rebased by
    ``(offset + doc_idx)[1:]``): a shard's trailing OPEN document — items
    after its last ``end_document`` — fuses into the next shard's first
    document, so close documents before finalizing shards you merge."""
    import shutil

    datasets = [MMapIndexedDataset(p) for p in prefixes]
    dtype = datasets[0].dtype
    for p, ds in zip(prefixes, datasets):
        if ds.dtype != dtype:
            raise ValueError(
                f"merge_datasets: dtype mismatch — {prefixes[0]} is {dtype}, "
                f"{p} is {ds.dtype}; re-encode before merging (silent "
                "casting would wrap out-of-range token ids)")

    sizes, doc_idx = [], [0]
    seq_base = 0
    with open(data_file_path(out_prefix), "wb") as out_bin:
        for p, ds in zip(prefixes, datasets):
            with open(data_file_path(p), "rb") as f:
                shutil.copyfileobj(f, out_bin)
            sizes.extend(int(s) for s in ds.sizes)
            doc_idx.extend(int(d) + seq_base for d in ds.doc_idx[1:])
            seq_base += len(ds)

    _write_index(out_prefix, dtype, sizes, doc_idx)
    return out_prefix


def make_dataset(path_prefix: str, impl: str = "mmap") -> MMapIndexedDataset:
    """Reference ``make_dataset`` entry (only the mmap impl exists here —
    the cached/lazy fairseq variants predate mmap and were superseded)."""
    if impl not in ("mmap", "infer"):
        raise ValueError(f"unsupported indexed dataset impl {impl!r}; "
                         "only 'mmap' is provided")
    if not os.path.exists(index_file_path(path_prefix)):
        raise FileNotFoundError(index_file_path(path_prefix))
    return MMapIndexedDataset(path_prefix)
