"""Samplers: the port's copy of ``pytorch_distributed_tpu/data/sampler.py``
(``DistributedSampler`` and ``GlobalBatchSampler``, with their cursors).

Both draw a permutation seeded by ``seed + epoch``, so the same (seed,
epoch, world) gives the same indices in both packages.
``DistributedSampler`` pads (or, with ``drop_last``, truncates) the
permutation so every replica gets the same count, then strides it across
the replicas; ``GlobalBatchSampler`` chunks it into whole global batches,
the tail dropped or padded by cyclic wrapping.

Each carries a cursor (``state_dict()`` / ``load_state_dict()``: epoch
and the items yielded so far this epoch), so a resumed run replays from
the exact item rather than the epoch boundary. ``load_state_dict`` arms
a one-shot skip for the next ``__iter__``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Optional

import numpy as np

from pytorch_distributed_tpu_torch.runtime import distributed as dist


class _CursorMixin:
    """epoch + intra-epoch offset cursor, shared by every sampler here.
    ``_cursor_offset`` counts what the current epoch's newest iterator has
    yielded; ``_cursor_skip`` is the skip :meth:`load_state_dict` arms."""

    epoch: int
    _cursor_offset: int = 0
    _cursor_skip: int = 0

    def state_dict(self) -> Dict[str, int]:
        """Cursor reproducing the NEXT item this sampler would yield."""
        return {"epoch": int(self.epoch), "offset": int(self._cursor_offset)}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        """The next ``__iter__`` yields epoch ``state['epoch']``'s
        sequence from item ``state['offset']`` on."""
        offset = int(state["offset"])
        if offset < 0:
            raise ValueError(f"cursor offset must be >= 0, got {offset}")
        self.set_epoch(int(state["epoch"]))
        self._cursor_skip = offset
        self._cursor_offset = offset

    def _reset_cursor(self) -> None:
        self._cursor_offset = 0
        self._cursor_skip = 0

    def _cursored(self, items) -> Iterator:
        """Take the armed skip now (so ``state_dict()`` between ``iter()``
        and the first ``next()`` reads the new position), then count."""
        skip, self._cursor_skip = self._cursor_skip, 0
        self._cursor_offset = skip
        return self._cursor_iter(items, skip)

    def _cursor_iter(self, items, skip: int) -> Iterator:
        for i, item in enumerate(items):
            if i < skip:
                continue
            self._cursor_offset += 1
            yield item
        # a finished epoch rewinds: the next fresh __iter__ starts at 0
        self._cursor_offset = 0


class DistributedSampler(_CursorMixin):
    """Per-replica index iterator, torch-shaped. ``num_replicas`` and
    ``rank`` default to the process group's. The cursor counts this
    replica's samples."""

    def __init__(
        self,
        dataset_len: int,
        num_replicas: Optional[int] = None,
        rank: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if num_replicas is None:
            num_replicas = dist.get_world_size()
        if rank is None:
            rank = dist.get_rank()
        if not 0 <= rank < num_replicas:
            raise ValueError(
                f"rank {rank} out of range for {num_replicas} replicas")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            # equal counts on every replica keep lockstep feeding
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = math.ceil(dataset_len / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._reset_cursor()

    def _global_indices(self) -> np.ndarray:
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            idx = g.permutation(self.dataset_len)
        else:
            idx = np.arange(self.dataset_len)
        if self.drop_last:
            idx = idx[: self.total_size]
        else:
            pad = self.total_size - len(idx)
            if pad > 0:
                reps = math.ceil(pad / max(len(idx), 1))
                idx = np.concatenate([idx] + [idx] * reps)[: self.total_size]
        return idx

    def __iter__(self) -> Iterator[int]:
        return self._cursored(
            self._global_indices()[self.rank :: self.num_replicas].tolist()
        )

    def __len__(self) -> int:
        return self.num_samples


class GlobalBatchSampler(_CursorMixin):
    """Yields whole global batches of indices; the loader rank-slices
    each one. The cursor counts batches."""

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
        self._reset_cursor()

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            idx = g.permutation(self.dataset_len)
        else:
            idx = np.arange(self.dataset_len)
        return self._cursored(
            _iter_global_batches(idx, self.batch_size, self.drop_last)
        )

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
