"""Data parallelism: the port of ``DataParallel``, ``ZeRO1`` and ``FSDP``
in ``pytorch_distributed_tpu/parallel/strategies.py``.

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
those, and broadcasts its updated parameters to the others.

:class:`FSDP` shards the parameters, their gradients and the optimizer
state over the mesh's ``fsdp`` axis, as the JAX strategy does, on FSDP2:
:meth:`FSDP.wrap` calls ``torch.distributed.fsdp.fully_shard`` on each
transformer block and then on the root, with
``reshard_after_forward=True`` (full shard: a block's weights are
gathered for its forward and again for its backward, and freed between).
Each parameter becomes a ``DTensor`` holding this rank's rows of dim 0
(``torch.chunk``'s cut; FSDP2 pads the last rank's storage, never the
rows it exposes). With ``dp > 1`` the mesh is 2-D (``make_mesh``) and
FSDP2 replicates the shards over ``dp`` (HSDP; at ``fsdp == 1`` every
rank holds every row, as under the JAX strategy on that mesh). No mixed-precision policy:
the ranks gather f32 parameters and the model casts each to bf16 at its
use, as the unsharded model does, so RMSNorm multiplies by its f32 scale
as in the JAX model (twice the all-gather bytes of a bf16 gather). The
batch is split over dp x fsdp, every rank its own share.
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
from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec, make_mesh


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
    """Full-shard FSDP over the ``fsdp`` axis of ``mesh_spec`` (every rank
    unless given), replicated over its ``dp`` axis; see the module
    docstring."""

    def __init__(self, device: DeviceLike = None,
                 mesh_spec: MeshSpec = MeshSpec(dp=1, fsdp=-1)):
        super().__init__(device)
        self.spec = mesh_spec.resolve(dist.get_world_size())
        self.mesh = make_mesh(self.spec, self.device.type)

    def wrap(self, model: torch.nn.Module) -> torch.nn.Module:
        """Shard ``model`` (a ``LlamaForCausalLM``) in place: each of its
        ``layers``, then the root; returns it. Build the model on the
        meta device, wrap it, then ``to_empty(device=...)`` and
        ``init_weights``: no rank ever holds the whole model."""
        from torch.distributed.fsdp import fully_shard

        for block in model.layers:
            fully_shard(block, mesh=self.mesh, reshard_after_forward=True)
        fully_shard(model, mesh=self.mesh, reshard_after_forward=True)
        return model

    def optimizer(self, params, optimizer_class=None, **defaults):
        """``optimizer_class`` (the port's ``AdamW`` unless given) over the
        sharded ``params`` (a wrapped module or its parameters): its
        state is sharded as they are. Clip by the global norm around it
        (``optim.clip_grad_norm``), which sums every shard once."""
        from pytorch_distributed_tpu_torch.optim import AdamW

        return (optimizer_class or AdamW)(params, **defaults)
