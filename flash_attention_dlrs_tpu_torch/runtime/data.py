"""Token data pipeline, PyTorch port's copy of ``flash_attention_dlrs_tpu/runtime/data.py``.

A flat token array (or a memory-mapped file) is windowed into
[seq_len + 1] samples, shuffled by a seeded permutation per epoch, sharded
by process (each process reads only its strided shard) and yielded as numpy
batches with a resumable cursor.  numpy only: the same seed gives the same
batches as the JAX package's loader.  The default shard is the whole data
set (process 0 of 1); a multi-process caller passes its own index and count.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class LoaderState:
    """Deterministic-resume cursor (epoch + position within the epoch)."""

    epoch: int = 0
    index: int = 0


class TokenDataset:
    """Flat int array of tokens, windowed into [seq_len+1] samples."""

    def __init__(self, tokens: np.ndarray, seq_len: int):
        self.tokens = np.asarray(tokens)
        self.seq_len = seq_len
        self.num_windows = (len(self.tokens) - 1) // seq_len

    @classmethod
    def from_file(cls, path: str, seq_len: int, dtype=np.uint16) -> "TokenDataset":
        return cls(np.memmap(path, dtype=dtype, mode="r"), seq_len)

    def window(self, idx: int) -> np.ndarray:
        lo = idx * self.seq_len
        return np.asarray(self.tokens[lo : lo + self.seq_len + 1], np.int32)


def batches(
    dataset: TokenDataset,
    *,
    batch_size: int,
    seed: int = 0,
    state: Optional[LoaderState] = None,
    process_index: int = 0,
    process_count: int = 1,
    drop_remainder: bool = True,
) -> Iterator[tuple]:
    """Yields (tokens [batch, seq_len+1] int32, LoaderState).  Each process
    sees a disjoint strided shard of every epoch's permutation."""
    state = state or LoaderState()
    while True:
        rng = np.random.default_rng(seed + state.epoch)
        order = rng.permutation(dataset.num_windows)
        shard = order[process_index::process_count]
        usable = (len(shard) // batch_size) * batch_size if drop_remainder else len(shard)
        while state.index + batch_size <= usable:
            idxs = shard[state.index : state.index + batch_size]
            batch = np.stack([dataset.window(i) for i in idxs])
            state.index += batch_size
            yield batch, dataclasses.replace(state)
        state = LoaderState(epoch=state.epoch + 1, index=0)
