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

``wrap(model, grad_compress=kind)`` registers ``parallel.ddp``'s
compression hook (``bf16``, ``fp16`` or ``int8`` with error feedback:
the JAX recipes' ``--grad-compress``) in place of DDP's f32 all-reduce;
the hook is ``ddp.grad_compress_hook``.

:class:`ZeRO1` is DDP for the gradients plus the optimizer state sharded
over the ranks: :meth:`ZeRO1.optimizer` builds
``torch.distributed.optim.ZeroRedundancyOptimizer`` over the port's
optimizer (the reference's own ZeRO-1, BASELINE.json:10). Each rank
keeps the moments of whole parameters, about ``1/world`` of them, steps
those, and broadcasts its updated parameters to the others. For ResNet
the per-rank optimizer is the port's ``SGD`` (``optimizer_class=SGD``:
its momentum traces sharded) and the BatchNorm statistics stay the
global batch's, as under :class:`DataParallel`.

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

With ``ep``, ``sp`` or ``tp`` above 1 the mesh is 5-D ``(dp, fsdp, ep,
sp, tp)`` (``runtime/mesh.py``). :meth:`FSDP.wrap` first applies the TP
plan on ``mesh["tp"]`` (:func:`tp_plan`: each module whose weight the
partition rules shard, ``extra_rules`` as in the JAX strategy, becomes
column-parallel (``Shard(0)`` of the port's ``[out, in]`` weight) or
row-parallel (``Shard(1)``) through ``parallelize_module``; the
embedding sharded on hidden and the vocab-sharded head return their
outputs whole), then ``fully_shard`` on ``mesh["fsdp"]`` (with ``dp``,
when above 1, as HSDP's replica dim): FSDP2 shards each TP shard's rows
over ``fsdp``. Over ``sp`` the parameters are replicated, each rank's
loss is its share of the rows' mean (``train/losses.py``), and the
train step sums the gradients over ``sp``
(``model.sequence_grad_group``). Over ``ep`` each rank holds its
experts of every mixture-of-experts layer (:func:`place_experts`, a
``DTensor`` FSDP2 shards further over ``fsdp``), the tokens replicated.
:class:`DataParallel` on a mesh with ``ep`` or ``tp`` above 1 is this
at ``fsdp == 1``: the JAX ``DataParallel(extra_rules=...)``.
:class:`ZeRO1` on such a mesh wraps the model as :class:`DataParallel`
does (the parameters TP-sharded and replicated over ``dp``, never
dp-sharded, their gradients averaged over ``dp``) and splits the
optimizer state over ``dp`` (:class:`ZeroShards`): each ``dp`` rank
keeps the moments of about ``1 / dp`` of its TP shards, steps those and
broadcasts them over its ``dp`` group, as the JAX ``ZeRO1`` with
``extra_rules`` splits each TP shard's moments over ``dp``. A GPT-2's
fused qkv rows are grouped by rank first (``GPT2LMHead.set_qkv_ways``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from pytorch_distributed_tpu_torch.data.loader import rank_slice
from pytorch_distributed_tpu_torch.optim import _local
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime.device import (
    DeviceLike,
    resolve_device,
)
from pytorch_distributed_tpu_torch.runtime.mesh import (
    MeshSpec,
    data_rank,
    make_mesh,
)


def tp_plan(model: torch.nn.Module, rules, spec: MeshSpec) -> Dict[str,
                                                                   object]:
    """``parallelize_module``'s plan for ``model`` from the partition
    ``rules`` on the mesh ``spec``: ``{module name: ParallelStyle}`` for
    every module whose weight the rules shard over ``tp``. A bias the
    rules leave whole under a column-parallel weight (Qwen2's q/k/v)
    raises: the style would cut it."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
    )

    from pytorch_distributed_tpu_torch.parallel.sharding import (
        infer_placements,
    )

    placed = infer_placements(model, rules, spec)
    modules = dict(model.named_modules())
    plan = {}
    for name, axes in placed.items():
        if "tp" not in axes:
            continue
        mod_name, _, leaf = name.rpartition(".")
        mod, dim = modules[mod_name], axes["tp"]
        if leaf != "weight" or getattr(mod, "tp_table", False):
            continue   # a table place_tables shards
        bias = getattr(mod, "bias", None)
        if (dim == 0 and bias is not None
                and placed.get(f"{mod_name}.bias") != {"tp": 0}):
            raise NotImplementedError(
                f"{mod_name}: a tensor-parallel weight with a bias the "
                "rules replicate (ROADMAP A10.1)")
        if isinstance(mod, torch.nn.Embedding):
            if dim != 1:
                raise NotImplementedError(
                    f"{mod_name}: a vocab-parallel embedding (ROADMAP "
                    "A10.1)")
            # sharded on hidden, its lookups gathered whole
            plan[mod_name] = ColwiseParallel(output_layouts=Replicate())
        elif dim == 0:
            # the head's logits leave whole; a block's outputs stay cut
            plan[mod_name] = ColwiseParallel(
                output_layouts=Replicate()) if mod_name == "lm_head" \
                else ColwiseParallel()
        else:
            plan[mod_name] = RowwiseParallel()
    return plan


def place_tables(model: torch.nn.Module, rules, spec: MeshSpec,
                 tp_mesh) -> None:
    """Shard over ``tp`` the weight of each module marked ``tp_table``
    (T5's relative-bias tables, read by head, which no parallel style
    takes) as the rules place its JAX leaf: a ``DTensor`` whose local
    part is this rank's slice, which the module reads itself."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from pytorch_distributed_tpu_torch.parallel.sharding import (
        infer_placements,
    )

    placed = infer_placements(model, rules, spec)
    for name, mod in model.named_modules():
        dims = placed.get(f"{name}.weight", {})
        if getattr(mod, "tp_table", False) and "tp" in dims:
            mod.weight = torch.nn.Parameter(
                distribute_tensor(mod.weight.data, tp_mesh,
                                  [Shard(dims["tp"])]),
                requires_grad=mod.weight.requires_grad)


def _axes_group(mesh, axes):
    """The process group of this rank's slice of the mesh dims ``axes``
    (the ranks that differ from it only there). Every rank builds every
    slice's group, as ``new_group`` requires."""
    if len(axes) == 1:
        return mesh[axes[0]].get_group()
    names = list(mesh.mesh_dim_names)
    order = [i for i, n in enumerate(names) if n not in axes] + [
        names.index(a) for a in axes]
    n = 1
    for a in axes:
        n *= mesh.shape[names.index(a)]
    rows = mesh.mesh.permute(order).reshape(-1, n).tolist()
    mine = None
    me = dist.get_rank()
    for ranks in rows:
        group = torch.distributed.new_group(ranks)
        if me in ranks:
            mine = group
    return mine


def place_experts(model: torch.nn.Module, rules, spec: MeshSpec,
                  mesh) -> None:
    """Shard every mixture-of-experts layer's stacked experts of ``model``
    (``ops.moe.MoEMLP``) as ``rules`` place their JAX leaves: a
    ``DTensor`` over the mesh's ``ep`` and ``tp`` dims (experts over
    ``ep``, their hidden dim over ``tp``), and set the layer's ``group``
    to this rank's ``(ep, tp)`` slice, over which its outputs sum. Run
    before FSDP, which then shards each rank's box over ``fsdp`` and
    reduces its gradient over the data axes only."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from pytorch_distributed_tpu_torch.ops.moe import EXPERT_LEAVES, MoEMLP
    from pytorch_distributed_tpu_torch.parallel.sharding import (
        infer_placements,
    )

    axes = tuple(a for a in ("ep", "tp") if getattr(spec, a) > 1)
    layers = [(name, mod) for name, mod in model.named_modules()
              if isinstance(mod, MoEMLP)]
    if not axes or not layers:
        return
    placed = infer_placements(model, rules, spec)
    sub = mesh[axes] if len(axes) > 1 else mesh[axes[0]]
    group = _axes_group(mesh, axes)
    for name, mod in layers:
        for leaf in EXPERT_LEAVES:
            p = getattr(mod, leaf, None)
            if p is None:
                continue
            dims = placed.get(f"{name}.{leaf}", {})
            shards = [Shard(dims[a]) if a in dims else Replicate()
                      for a in axes]
            setattr(mod, leaf, torch.nn.Parameter(
                distribute_tensor(p.data, sub, shards),
                requires_grad=p.requires_grad))
        mod.group = group


def set_moe_data_group(model: torch.nn.Module, group) -> None:
    """Route every mixture-of-experts layer of ``model`` over the whole
    batch of ``group``'s ranks (``ops.moe.route``)."""
    from pytorch_distributed_tpu_torch.ops.moe import MoEMLP

    for mod in model.modules():
        if isinstance(mod, MoEMLP):
            mod.data_group = group


def apply_tp(model: torch.nn.Module, blocks, rules, spec: MeshSpec,
             tp_mesh) -> None:
    """The TP plan over ``tp_mesh`` (and the tables of
    :func:`place_tables`), a GPT-2's fused qkv rows grouped by rank
    first, and each of ``blocks`` told its ``(rank, ways, group)``."""
    from torch.distributed.tensor.parallel import parallelize_module

    if hasattr(model, "set_qkv_ways"):
        model.set_qkv_ways(spec.tp)
    parallelize_module(model, tp_mesh, tp_plan(model, rules, spec))
    place_tables(model, rules, spec, tp_mesh)
    for block in blocks:
        block.tp = (tp_mesh.get_local_rank(), spec.tp, tp_mesh.get_group())


def _shard_model(model: torch.nn.Module, spec: MeshSpec, mesh, shard_mesh,
                 rules) -> torch.nn.Module:
    """:meth:`FSDP.wrap`'s body: the TP plan over ``tp`` (and the
    tables of :func:`place_tables`), the experts over ``ep`` and ``tp``,
    then FSDP2 on each of ``model.layers`` (``blocks``, or a model's
    ``shard_blocks()``: both of T5's stacks) and on the root over
    ``shard_mesh``."""
    from torch.distributed.fsdp import fully_shard

    if hasattr(model, "shard_blocks"):
        blocks = model.shard_blocks()
    else:
        blocks = getattr(model, "layers", None)
        if blocks is None:
            blocks = model.blocks
    if spec.tp > 1:
        apply_tp(model, blocks, rules, spec, mesh["tp"])
    place_experts(model, rules, spec, mesh)
    data = tuple(a for a in ("dp", "fsdp") if getattr(spec, a) > 1)
    if data:
        set_moe_data_group(model, _axes_group(mesh, data))
    for block in blocks:
        fully_shard(block, mesh=shard_mesh, reshard_after_forward=True)
    fully_shard(model, mesh=shard_mesh, reshard_after_forward=True)
    if spec.sp > 1:
        model.sequence_grad_group = mesh["sp"].get_group()
    return model


def _refuse_pp(spec: Optional[MeshSpec]) -> None:
    if spec is not None and spec.pp > 1:
        raise ValueError(
            f"{spec}: a pp axis holds different layers on each stage; "
            "pipelines train under parallel.pipeline_lm.PipelineParallel")


class DataParallel:
    """DDP over the process group (which must exist), on this rank's
    ``device`` (the card unless given).

    With a ``mesh_spec`` whose model axes (``ep``, ``tp``) are above 1,
    the JAX strategy's ``extra_rules`` (a model's ``*_partition_rules()``,
    say ``mixtral_partition_rules()``) place the leaves they name on the
    mesh and the rest stay replicated: :meth:`wrap` shards the model as
    :class:`FSDP` does at ``fsdp == 1`` (experts over ``ep``, Megatron TP
    over ``tp``) and reduces the gradients over ``dp`` only, each rank's
    share of the batch the rows of its ``dp`` coordinate. Build the model
    on the meta device then, wrap it, ``to_empty`` and ``init_weights``
    (each rank draws its own box). ``sp`` needs :class:`FSDP`."""

    def __init__(self, device: DeviceLike = None, *,
                 mesh_spec: Optional[MeshSpec] = None, extra_rules=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "DataParallel needs a process group: call "
                "runtime.distributed.init_process_group() first"
            )
        self.device = resolve_device(device)
        self.rules = extra_rules
        self.spec = (None if mesh_spec is None
                     else mesh_spec.resolve(dist.get_world_size()))
        _refuse_pp(self.spec)
        self.mesh = None
        if self.model_parallel:
            if self.spec.fsdp != 1 or self.spec.sp != 1:
                raise ValueError(
                    f"DataParallel replicates over dp and shards over ep "
                    f"and tp only; {self.spec} needs FSDP")
            if extra_rules is None:
                raise ValueError(
                    "ep/tp above 1 need the model's partition rules "
                    "(extra_rules=mixtral_partition_rules(), say)")
            self.mesh = make_mesh(self.spec, self.device.type)

    @property
    def model_parallel(self) -> bool:
        """Whether the mesh has a model axis (the model is sharded)."""
        return self.spec is not None and self.spec.model_parallel()

    def wrap(self, model: torch.nn.Module, *,
             grad_compress: Optional[str] = None) -> torch.nn.Module:
        """``model`` in DDP over the process group; with ``grad_compress``
        its gradients cross the ranks through ``ddp.compress_hook``. On a
        model-parallel mesh: ``model`` sharded in place (see the class
        docstring), returned."""
        if self.model_parallel:
            if grad_compress is not None:
                raise NotImplementedError(
                    "--grad-compress on a model-parallel mesh (ROADMAP "
                    "A10.1)")
            return _shard_model(model, self.spec, self.mesh,
                                self.mesh[self.spec.shard_dims()],
                                self.rules)
        if dist.get_world_size() > 1:
            set_moe_data_group(model, torch.distributed.group.WORLD)
        ids = [self.device.index] if self.device.type == "cuda" else None
        ddp = DistributedDataParallel(
            model, device_ids=ids, broadcast_buffers=False,
        )
        ddp.grad_compress_hook = None
        if grad_compress is not None:
            from pytorch_distributed_tpu_torch.parallel.ddp import (
                compress_hook,
            )

            ddp.grad_compress_hook = compress_hook(grad_compress).register(
                ddp)
        return ddp

    def batch_sharding(self) -> torch.device:
        """The loader's ``sharding``: batches go to this device; the
        loader keeps this rank's share."""
        return self.device

    def shard_batch(self, batch: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
        """This rank's share of a global host batch (the loader's rank
        slice of this rank's ``(dp, fsdp)`` coordinate), on the device."""
        rank, world = data_rank()
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            if world > 1:
                v = np.ascontiguousarray(rank_slice(v, rank, world))
            out[k] = torch.from_numpy(v).to(self.device)
        return out


class ZeRO1(DataParallel):
    """DDP (:meth:`wrap`) with the optimizer state sharded over the
    ranks (:meth:`optimizer`); on a mesh with a model axis, the model
    sharded as :class:`DataParallel` shards it and the state split over
    ``dp`` (the module docstring)."""

    def optimizer(self, params, optimizer_class=None, **defaults):
        """``ZeroRedundancyOptimizer`` over ``params`` (a module or its
        parameters), each rank's shard an ``optimizer_class`` (the port's
        ``AdamW`` unless given) built with ``defaults``; on a model-
        parallel mesh a :class:`ZeroShards` over the ``dp`` group, built
        after :meth:`wrap` on the sharded parameters. Clip by the global
        norm around it (``optim.clip_grad_norm(zero, max_norm)``), never
        around its shard."""
        from torch.distributed.optim import ZeroRedundancyOptimizer

        from pytorch_distributed_tpu_torch.optim import AdamW

        if isinstance(params, torch.nn.Module):
            params = params.parameters()
        params = list(params)
        if self.model_parallel:
            from torch.distributed.tensor import DTensor

            if not any(isinstance(p, DTensor) for p in params):
                raise ValueError(
                    "ZeRO1 on a model-parallel mesh: build the optimizer "
                    "after wrap(model), on its sharded parameters")
            return ZeroShards(params, optimizer_class or AdamW,
                              self.mesh["dp"].get_group(), **defaults)
        return ZeroRedundancyOptimizer(
            params, optimizer_class=optimizer_class or AdamW, **defaults)


class ZeroShards:
    """ZeRO-1 over a data group for parameters a model axis shards (TP
    ``DTensor``s, or plain ones): every parameter belongs to one rank of
    ``group`` (the largest first, each to the rank with the fewest
    elements so far, as ``ZeroRedundancyOptimizer`` partitions), which
    keeps its optimizer state in ``optim`` (an ``optimizer_class`` over
    its own parameters), steps it, and broadcasts this rank's shard of
    it to the group. The gradients must already be the group's mean
    (the strategy's wrap averages them over ``dp``). ``param_groups``
    holds every parameter, so a clip around it takes the global norm."""

    def __init__(self, params, optimizer_class, group, **defaults):
        self.group = group
        self.params = [p for p in params if p.requires_grad]
        n = torch.distributed.get_world_size(group)
        me = torch.distributed.get_rank(group)
        loads = [0] * n
        self.owner: Dict[int, int] = {}
        for p in sorted(self.params, key=lambda p: _local(p).numel(),
                        reverse=True):
            r = loads.index(min(loads))
            self.owner[id(p)] = r
            loads[r] += _local(p).numel()
        owned = [p for p in self.params if self.owner[id(p)] == me]
        if not owned:
            raise ValueError(
                f"{len(self.params)} parameters over {n} data ranks: rank "
                f"{me} would own none")
        self.optim = optimizer_class(owned, **defaults)
        self._src = [torch.distributed.get_global_rank(group, r)
                     for r in range(n)]
        self.param_groups = [{"params": self.params}]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def step(self, closure=None):
        """Step this rank's parameters, then every rank's shard of each
        parameter from its owner over ``group``."""
        loss = self.optim.step(closure)
        works = [torch.distributed.broadcast(
            _local(p), src=self._src[self.owner[id(p)]], group=self.group,
            async_op=True) for p in self.params]
        for w in works:
            w.wait()
        return loss


class FSDP(DataParallel):
    """Full-shard FSDP over the ``fsdp`` axis of ``mesh_spec`` (every rank
    unless given), replicated over its ``dp`` axis, composed with tensor
    parallelism over ``tp`` (by ``extra_rules``, a model's
    ``*_partition_rules()``) and sequence parallelism over ``sp``; see
    the module docstring."""

    def __init__(self, device: DeviceLike = None,
                 mesh_spec: MeshSpec = MeshSpec(dp=1, fsdp=-1),
                 extra_rules=None):
        super().__init__(device)
        self.spec = mesh_spec.resolve(dist.get_world_size())
        _refuse_pp(self.spec)
        self.mesh = make_mesh(self.spec, self.device.type)
        self.rules = extra_rules
        if (self.spec.tp > 1 or self.spec.ep > 1) and extra_rules is None:
            raise ValueError(
                f"tp={self.spec.tp}, ep={self.spec.ep} need the model's "
                "partition rules (extra_rules=llama_partition_rules(), say)")
        self.shard_mesh = (self.mesh[self.spec.shard_dims()]
                           if self.spec.model_parallel() else self.mesh)

    def wrap(self, model: torch.nn.Module) -> torch.nn.Module:
        """Shard ``model`` (a ``LlamaForCausalLM``, ``MixtralForCausalLM``
        or ``T5ForConditionalGeneration``) in place: the TP plan over
        ``tp``, the experts over ``ep`` and ``tp``, then FSDP on each of
        its blocks and on the root; returns it. Build the model on the
        meta device, wrap it, then ``to_empty(device=...)`` and
        ``init_weights``: no rank ever holds the whole model."""
        return _shard_model(model, self.spec, self.mesh, self.shard_mesh,
                            self.rules)

    def optimizer(self, params, optimizer_class=None, **defaults):
        """``optimizer_class`` (the port's ``AdamW`` unless given) over the
        sharded ``params`` (a wrapped module or its parameters): its
        state is sharded as they are. Clip by the global norm around it
        (``optim.clip_grad_norm``), which sums every shard once."""
        from pytorch_distributed_tpu_torch.optim import AdamW

        return (optimizer_class or AdamW)(params, **defaults)
