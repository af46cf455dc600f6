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

``fetch(dataset, indices) -> batch`` replaces the default gather (the
native ``ImageBatchPipeline``, the PIL ``FolderImagePipeline``);
``collate_fn(samples) -> batch`` replaces only the stacking of the
per-sample gather; the two are exclusive. ``set_epoch`` reaches a fetch
that has one (its augmentation stream). A fetch with a staging ring,
feeding a CUDA card, is marked device-fed with ``prefetch + 2`` buffers
(one assembling, ``prefetch`` queued, one being copied): the consumer
copies a ring buffer to the card, records a CUDA event behind the copy
and registers it, and the ring hands that buffer out again only after
the event. Iterable datasets are not ported (ROADMAP A2).
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
from pytorch_distributed_tpu_torch.runtime.mesh import data_rank

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
        fetch: Optional[Callable[[Any, np.ndarray], Any]] = None,
        collate_fn: Optional[Callable[[list], Any]] = None,
        shard: Optional[bool] = None,
    ):
        if collate_fn is not None and fetch is not None:
            raise ValueError(
                "collate_fn and fetch both own batch assembly: pass one")
        if collate_fn is not None:
            def fetch(ds, idx):
                return collate_fn([ds[int(i)] for i in idx])
        self.fetch = fetch
        self.collate_fn = collate_fn
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
        if (self.device is not None and self.device.type == "cuda"
                and hasattr(fetch, "mark_device_fed")):
            fetch.mark_device_fed(depth=self.prefetch + 2)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)
        if hasattr(self.fetch, "set_epoch"):
            self.fetch.set_epoch(epoch)   # e.g. the augmentation stream

    def __len__(self) -> int:
        return len(self.sampler)

    def _rank_slice(self, indices):
        if not self.shard or dist.get_world_size() == 1:
            return indices
        # the share of this rank's (dp, fsdp) coordinate: ranks that
        # differ only in sp or tp read the same rows
        rank, world = data_rank()
        if len(indices) % world and not self._warned_remainder:
            self._warned_remainder = True
            logger.warning(
                "batch of %d not divisible by world_size %d — dropping %d "
                "sample(s) per such batch to keep ranks in lockstep",
                len(indices), world, len(indices) % world,
            )
        return rank_slice(indices, rank, world)

    def _host_batch(self, indices):
        with tracing.span("ingest.fetch"):
            batch = (self.fetch or _fetch)(
                self.dataset, np.asarray(self._rank_slice(indices)))
            if self.transform is not None:
                batch = self.transform(batch)
            cuda = self.device is not None and self.device.type == "cuda"
            ring = getattr(self.fetch, "staging_ring", None)
            out = {}
            for k, v in batch.items():
                staged = (ring.tensor_for(v) if ring is not None
                          and isinstance(v, np.ndarray) else None)
                if staged is not None:   # a ring buffer: pinned already
                    out[k] = staged
                    continue
                t = torch.from_numpy(np.ascontiguousarray(v))
                out[k] = t.pin_memory() if cuda else t
            return out

    def _place(self, item):
        """The batch on the device; the copies out of staging-ring
        buffers are registered with the ring behind a CUDA event."""
        placed = {k: v.to(self.device, non_blocking=True)
                  for k, v in item.items()}
        ring = getattr(self.fetch, "staging_ring", None)
        if ring is not None:
            event = None
            for k, v in item.items():
                if not ring.holds(v):
                    continue
                if event is None and self.device.type == "cuda":
                    event = torch.cuda.Event()
                    event.record()
                ring.register_transfer(v, placed[k], event)
        return placed

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
                    item = self._place(item)
                yield item
        finally:
            stop.set()
            # drain so a producer blocked in put() wakes and sees stop
            while worker.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    worker.join(timeout=0.1)
