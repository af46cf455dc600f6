"""Data parallelism: the port of ``DataParallel`` and ``ZeRO1`` in
``pytorch_distributed_tpu/parallel/strategies.py``.

The JAX strategy is a choice of shardings on one mesh: replicated
parameters, the batch split over ``dp``, and the gradient sum over the
batch axis becomes one allreduce that XLA schedules. The port is one
process per rank: :meth:`DataParallel.wrap` puts the model in
``DistributedDataParallel`` (bucketed gradient allreduce overlapped with
the backward), and the rank's share of each global batch is the loader's
rank slice (:meth:`DataParallel.batch_sharding`) or
:meth:`DataParallel.shard_batch`.

BatchNorm statistics are over the global batch in the JAX model (the
batch-axis mean lowers to a psum under SPMD); the port's
``models.resnet.BatchNorm`` takes them over the process group itself,
so DDP does not broadcast buffers (``broadcast_buffers=False``): every
rank's running statistics are already the global ones.

:class:`ZeRO1` is DDP for the gradients plus the optimizer state sharded
over the ranks: :meth:`ZeRO1.optimizer` builds
``torch.distributed.optim.ZeroRedundancyOptimizer`` over the port's
optimizer (the reference's own ZeRO-1, BASELINE.json:10). Each rank
keeps the moments of whole parameters, about ``1/world`` of them, steps
those, and broadcasts its updated parameters to the others. ``FSDP`` is
not ported (ROADMAP A6).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from pytorch_distributed_tpu_torch.data.loader import rank_slice
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime.device import (
    DeviceLike,
    resolve_device,
)


class DataParallel:
    """DDP over the process group (which must exist), on this rank's
    ``device`` (the card unless given)."""

    def __init__(self, device: DeviceLike = None):
        if not dist.is_initialized():
            raise RuntimeError(
                "DataParallel needs a process group: call "
                "runtime.distributed.init_process_group() first"
            )
        self.device = resolve_device(device)

    def wrap(self, model: torch.nn.Module) -> DistributedDataParallel:
        """``model`` in DDP over the process group."""
        ids = [self.device.index] if self.device.type == "cuda" else None
        return DistributedDataParallel(
            model, device_ids=ids, broadcast_buffers=False,
        )

    def batch_sharding(self) -> torch.device:
        """The loader's ``sharding``: batches go to this device; the
        loader keeps this rank's share."""
        return self.device

    def shard_batch(self, batch: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
        """This rank's share of a global host batch (the loader's rank
        slice), on the device."""
        world, rank = dist.get_world_size(), dist.get_rank()
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            if world > 1:
                v = np.ascontiguousarray(rank_slice(v, rank, world))
            out[k] = torch.from_numpy(v).to(self.device)
        return out


class ZeRO1(DataParallel):
    """DDP (:meth:`wrap`) with the optimizer state sharded over the
    ranks (:meth:`optimizer`)."""

    def optimizer(self, params, optimizer_class=None, **defaults):
        """``ZeroRedundancyOptimizer`` over ``params`` (a module or its
        parameters), each rank's shard an ``optimizer_class`` (the port's
        ``AdamW`` unless given) built with ``defaults``. Clip by the
        global norm around it (``optim.clip_grad_norm(zero, max_norm)``),
        never around its shard."""
        from torch.distributed.optim import ZeroRedundancyOptimizer

        from pytorch_distributed_tpu_torch.optim import AdamW

        if isinstance(params, torch.nn.Module):
            params = params.parameters()
        return ZeroRedundancyOptimizer(
            list(params), optimizer_class=optimizer_class or AdamW,
            **defaults)


class FSDP(DataParallel):
    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "FSDP (parameters sharded) is not ported (ROADMAP A6)"
        )
