"""Compressed gradient sync: the port of ``sync_grads`` and ``no_sync`` in
``pytorch_distributed_tpu/parallel/ddp.py``.

:func:`sync_grads` averages a list (or dict) of gradient leaves over the
process group through ``parallel/overlap.py``: the leaves are grouped by
:class:`~pytorch_distributed_tpu_torch.parallel.overlap.ShipPlan` (for
``bf16``/``fp16`` after f32 and f64 leaves are cast to the half type,
and cast back after), and each item is averaged by ``ring_all_reduce``;
under ``int8`` a q8 item first takes its error feedback
(``feedback.apply``, keyed by the leaf's index). Without compression
every item is averaged exactly, in the JAX ring's summation order.

:func:`compress_hook` is the same sync as a DDP communication hook,
which ``DataParallel.wrap(grad_compress=...)`` registers: for each
bucket it walks ``bucket.gradients()`` (the per-parameter views of the
bucket's flat buffer), ships those leaves as the plan says (block
quantization starts at each leaf's element 0, never at the bucket's),
keys the residuals by parameter (DDP rebuilds its buckets after the
first iteration), and writes the averages back into the views. In a
world of one both leave the gradients as they are, as the JAX
``sync_grads`` does.
"""

from __future__ import annotations

import contextlib
from typing import Hashable, List, Optional, Sequence

import torch

from pytorch_distributed_tpu_torch.parallel.overlap import (
    COALESCE_MAX_ELEMS,
    ErrorFeedback,
    ShipPlan,
    SyncStats,
    ring_all_reduce,
)
from pytorch_distributed_tpu_torch.runtime import distributed as dist

__all__ = ["COALESCE_MAX_ELEMS", "CompressHook", "compress_hook",
           "no_sync", "sync_grads"]

_COMPRESS_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                    "fp16": torch.float16, "float16": torch.float16}
#: the ``--grad-compress`` forms
COMPRESS_KINDS = ("bf16", "fp16", "int8")


@contextlib.contextmanager
def no_sync():
    """The JAX package's ``no_sync()``: a no-op kept for ported scripts.
    The port's train step suppresses DDP's per-microbatch sync itself
    (``DistributedDataParallel.no_sync`` on every microbatch but the
    last)."""
    yield


def _check_kind(compress: Optional[str]) -> None:
    if compress not in (None, "int8") and compress not in _COMPRESS_DTYPES:
        raise ValueError(
            f"unknown grad compression {compress!r}; one of "
            f"{sorted(set(_COMPRESS_DTYPES)) + ['int8']}")


def _sync_leaves(leaves: List[torch.Tensor], keys: Sequence[Hashable],
                 compress: Optional[str], feedback: Optional[ErrorFeedback],
                 stats: Optional[SyncStats]) -> List[torch.Tensor]:
    """The averaged ``leaves`` (new tensors, each of its leaf's dtype)."""
    wire = list(leaves)
    if compress in _COMPRESS_DTYPES:
        half = _COMPRESS_DTYPES[compress]
        wire = [g.to(half) if g.dtype in (torch.float32, torch.float64)
                else g for g in wire]
    plan = ShipPlan([(tuple(g.shape), g.dtype) for g in wire],
                    quantize=compress == "int8")
    out: List[Optional[torch.Tensor]] = [None] * len(wire)
    for item in plan.items:
        if item.kind == "flat":
            flat = torch.cat([wire[i].reshape(-1) for i in item.leaf_ids])
        else:
            flat = wire[item.leaf_ids[0]].reshape(-1)
            if item.q8 and feedback is not None:
                flat = feedback.apply(keys[item.leaf_ids[0]], flat)
        avg = ring_all_reduce(flat, q8=item.q8, stats=stats)
        offsets = item.offsets or (0,)
        for i, off in zip(item.leaf_ids, offsets):
            out[i] = avg[off:off + plan.sizes[i]].reshape(wire[i].shape)
    return [o.to(g.dtype) for o, g in zip(out, leaves)]


def sync_grads(grads, compress: Optional[str] = None, *,
               feedback: Optional[ErrorFeedback] = None,
               stats: Optional[SyncStats] = None):
    """Average ``grads`` (a list, tuple or dict of tensors) over the
    process group; returns the same structure of new tensors (``grads``
    itself in a world of one). ``compress``: None, ``"bf16"``,
    ``"fp16"`` or ``"int8"``. ``feedback``: the q8 residual store that
    persists across steps (none: q8 without error feedback, the JAX
    package's legacy path). ``stats`` counts the wire bytes."""
    _check_kind(compress)
    if dist.get_world_size() == 1:
        return grads
    if isinstance(grads, dict):
        keys = list(grads)
        synced = _sync_leaves([grads[k] for k in keys], range(len(keys)),
                              compress, feedback, stats)
        return dict(zip(keys, synced))
    leaves = list(grads)
    synced = _sync_leaves(leaves, range(len(leaves)), compress, feedback,
                          stats)
    return type(grads)(synced) if isinstance(grads, tuple) else synced


class CompressHook:
    """The state of a DDP communication hook that averages each bucket's
    gradients as :func:`sync_grads` with ``compress=kind`` does: its own
    :class:`ErrorFeedback` keyed by parameter, and its wire bytes in
    ``stats``. :meth:`register` installs it on a DDP model."""

    def __init__(self, kind: str):
        if kind not in COMPRESS_KINDS:
            raise ValueError(f"grad_compress must be one of {COMPRESS_KINDS},"
                             f" got {kind!r}")
        self.kind = kind
        self.feedback = ErrorFeedback()
        self.stats = SyncStats()

    def register(self, ddp) -> "CompressHook":
        ddp.register_comm_hook(self, _run_hook)
        return self

    def run(self, bucket) -> torch.futures.Future:
        buffer = bucket.buffer()
        if dist.get_world_size() > 1:
            views = bucket.gradients()
            synced = _sync_leaves(views, bucket.parameters(), self.kind,
                                  self.feedback, self.stats)
            with torch.no_grad():
                for view, avg in zip(views, synced):
                    view.copy_(avg)
        fut: torch.futures.Future = torch.futures.Future()
        fut.set_result(buffer)
        return fut


def _run_hook(state: CompressHook, bucket):
    return state.run(bucket)


def compress_hook(kind: str) -> CompressHook:
    """The hook for ``--grad-compress kind``: install it with
    ``compress_hook(kind).register(ddp)``, or let
    ``DataParallel.wrap(model, grad_compress=kind)`` do so."""
    return CompressHook(kind)
