"""Batched loader: the single-process core of
``pytorch_distributed_tpu/data/loader.py``.

Iterates global batches from a :class:`GlobalBatchSampler` (seeded
shuffle, drop-last by default), so at world size 1 the batch order is the
JAX loader's, index for index. Batches are dicts of CPU tensors; the
trainer moves them to the model's device. The JAX loader's prefetch
thread, mesh placement, rank slicing and native pipeline are not needed
by the single-device training slice and are not ported.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data.datasets import (
    ArrayDataset,
    stack_items,
)
from pytorch_distributed_tpu_torch.data.sampler import GlobalBatchSampler


def _fetch(dataset, indices: np.ndarray):
    """Batch-fetch: one fancy index into an ``ArrayDataset``, else item
    by item."""
    if isinstance(dataset, ArrayDataset):
        return dataset[indices]
    return stack_items([dataset[int(i)] for i in indices])


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


class DataLoader:
    """Iterate global batches (dicts of tensors) of a map-style dataset
    of dict items. One iteration is one epoch; call ``set_epoch`` between
    epochs to advance the shuffle seed."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.sampler = GlobalBatchSampler(
            len(dataset), batch_size, shuffle=shuffle, seed=seed,
            drop_last=drop_last,
        )

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self) -> Iterator:
        for indices in self.sampler:
            yield _to_torch(_fetch(self.dataset, indices))
