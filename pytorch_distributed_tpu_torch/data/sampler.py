"""The global-batch sampler: the port's copy of ``GlobalBatchSampler`` in
``pytorch_distributed_tpu/data/sampler.py``, without the resume cursor
(checkpointed resume waits for ROADMAP A5).

A permutation seeded by ``seed + epoch`` chunked into whole global
batches, the tail dropped or padded by cyclic wrapping, so the same
(seed, epoch) gives the same batches in both packages.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np


class GlobalBatchSampler:
    """Yields whole global batches of indices."""

    def __init__(
        self,
        dataset_len: int,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.dataset_len = dataset_len
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            idx = g.permutation(self.dataset_len)
        else:
            idx = np.arange(self.dataset_len)
        return _iter_global_batches(idx, self.batch_size, self.drop_last)

    def __len__(self) -> int:
        if self.drop_last:
            return self.dataset_len // self.batch_size
        return math.ceil(self.dataset_len / self.batch_size)


def _iter_global_batches(
    idx: np.ndarray, batch_size: int, drop_last: bool
) -> Iterator[np.ndarray]:
    """Chunk an epoch's index vector into fixed-size global batches; the
    tail batch is padded by cyclic wrapping so every batch has one shape."""
    n_full = len(idx) // batch_size
    for i in range(n_full):
        yield idx[i * batch_size : (i + 1) * batch_size]
    rem = len(idx) - n_full * batch_size
    if rem and not drop_last:
        tail = idx[n_full * batch_size :]
        pad = np.resize(idx, batch_size - rem)
        yield np.concatenate([tail, pad])
