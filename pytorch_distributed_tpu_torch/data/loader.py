"""Batched loader with a background prefetch thread: the port of
``pytorch_distributed_tpu/data/loader.py``.

A producer thread walks the sampler, keeps this rank's share of each
global batch (``_rank_slice``: a strided share per rank, as the JAX
loader's multi-process path takes it, shedding a remainder that does not
divide by the world size so every rank stays in lockstep), gathers it
from the dataset, applies the host ``transform``, and copies it into
pinned host memory when batches go to a CUDA card. ``prefetch`` batches
wait in a queue ahead of the consumer. The consumer's thread copies
each batch to the card with ``non_blocking=True``: it returns at once,
and the copy runs on the compute stream ahead of the step that reads it.
Without prefetch, a step of ResNet-50 at batch 128 would wait on about
19 MB of numpy per batch.

Not ported: the JAX loader's ``fetch``/``collate_fn`` hooks, iterable
datasets and the native image pipeline (ROADMAP A2).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data.datasets import (
    ArrayDataset,
    stack_items,
)
from pytorch_distributed_tpu_torch.data.sampler import GlobalBatchSampler
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime import tracing

logger = logging.getLogger(__name__)

_SENTINEL = object()


def _fetch(dataset, indices: np.ndarray):
    """Batch-fetch: one fancy index into an ``ArrayDataset``, else item
    by item."""
    if isinstance(dataset, ArrayDataset):
        return dataset[indices]
    return stack_items([dataset[int(i)] for i in indices])


def rank_slice(indices, rank: int, world: int):
    """Rank ``rank``'s strided share of one global batch: rows
    ``rank, rank + world, ...`` of its largest prefix that divides by
    ``world``."""
    n = (len(indices) // world) * world
    if n == 0:
        raise ValueError(
            f"batch of {len(indices)} cannot be split across world_size "
            f"{world} ranks; use a batch size >= the rank count"
        )
    return indices[rank:n:world]


class DataLoader:
    """Iterate batches (dicts of tensors) of a map-style dataset of dict
    items. One iteration is one epoch; call ``set_epoch`` between epochs
    to advance the shuffle seed.

    ``sampler``: a :class:`GlobalBatchSampler` by default (seeded shuffle,
    ``drop_last``). ``sharding``: the device batches are placed on
    (``strategy.batch_sharding()``); ``None`` yields CPU tensors.
    ``shard``: whether to keep only this rank's share of each batch;
    by default yes, unless the sampler is already per rank (it has
    ``num_replicas``, as :class:`DistributedSampler` does), which would
    shard twice."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        sampler=None,
        sharding: Optional[torch.device] = None,
        prefetch: int = 2,
        transform: Optional[Callable[[Any], Any]] = None,
        shard: Optional[bool] = None,
    ):
        self.dataset = dataset
        self.sampler = sampler or GlobalBatchSampler(
            len(dataset), batch_size, shuffle=shuffle, seed=seed,
            drop_last=drop_last,
        )
        if shard is None:
            shard = not hasattr(self.sampler, "num_replicas")
        self.shard = shard
        self.device = None if sharding is None else torch.device(sharding)
        self.prefetch = max(1, prefetch)
        self.transform = transform
        self._warned_remainder = False

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler)

    def _rank_slice(self, indices):
        world = dist.get_world_size()
        if not self.shard or world == 1:
            return indices
        if len(indices) % world and not self._warned_remainder:
            self._warned_remainder = True
            logger.warning(
                "batch of %d not divisible by world_size %d — dropping %d "
                "sample(s) per such batch to keep ranks in lockstep",
                len(indices), world, len(indices) % world,
            )
        return rank_slice(indices, dist.get_rank(), world)

    def _host_batch(self, indices):
        with tracing.span("ingest.fetch"):
            batch = _fetch(self.dataset, np.asarray(self._rank_slice(indices)))
            if self.transform is not None:
                batch = self.transform(batch)
            out = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in batch.items()}
            if self.device is not None and self.device.type == "cuda":
                out = {k: v.pin_memory() for k, v in out.items()}
            return out

    def _produce(self, out_q: queue.Queue, stop: threading.Event) -> None:
        try:
            for indices in self.sampler:
                if stop.is_set():
                    return
                out_q.put(self._host_batch(indices))
            out_q.put(_SENTINEL)
        except BaseException as e:  # surfaced to the consumer, re-raised
            out_q.put(e)

    def __iter__(self) -> Iterator[Any]:
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        worker = threading.Thread(target=self._produce, args=(out_q, stop),
                                  daemon=True)
        worker.start()
        try:
            while True:
                item = out_q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                if self.device is not None:
                    item = {k: v.to(self.device, non_blocking=True)
                            for k, v in item.items()}
                yield item
        finally:
            stop.set()
            # drain so a producer blocked in put() wakes and sees stop
            while worker.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    worker.join(timeout=0.1)
