"""The device mesh: the port of ``pytorch_distributed_tpu/runtime/mesh.py``.

The JAX package builds one mesh over named axes (``dp``, ``fsdp``,
``pp``, ``ep``, ``sp``, ``tp``) and expresses every strategy against it.
The port has them all: the two data axes, ``dp`` (replicas) and ``fsdp``
(parameters and optimizer state sharded), the pipeline axis ``pp`` (the
layers split into stages over ranks, ``parallel/pipeline_lm.py``), and
the three model axes, ``ep`` (the experts of a mixture-of-experts FFN
split over ranks, ``ops/moe.py``), ``sp`` (the sequence split over
ranks, ``parallel/sequence.py``) and ``tp`` (heads and hidden units
split over ranks, ``parallel/sharding.py``), one card a rank.
:func:`make_mesh` builds the ``DeviceMesh`` every strategy uses:

* data axes only: 2-D ``("dp", "fsdp")`` whenever ``dp > 1`` (FSDP
  replicates its shards over ``dp``, as the JAX mesh does, ``fsdp == 1``
  included), 1-D ``fsdp`` when only ``fsdp`` is above 1, and 1-D ``dp``
  of one rank otherwise;
* ``ep``, ``sp`` or ``tp`` above 1: 5-D ``("dp", "fsdp", "ep", "sp",
  "tp")``, in the JAX axis order (``tp`` innermost), so that rank ``r``
  holds the mesh coordinate of JAX device ``r`` (``pp`` is 1);
* ``pp`` above 1: the 6-D mesh of every axis, ``("dp", "fsdp", "pp",
  "ep", "sp", "tp")``, the JAX one.

The tokens are replicated over ``pp``, ``ep``, ``sp`` and ``tp`` (the
batch splits over the data axes only), so the stages of one pipeline,
and the ranks of one ``ep`` group, read the same rows. The last mesh
:func:`make_mesh`
built is the current one (:func:`current_mesh`, or one set by
:func:`set_current_mesh`): the loader takes a rank's rows from its data
coordinate (:func:`data_rank`), sequence-parallel attention its ring
from the ``sp`` dim, and a checkpoint's writers from the coordinates a
tensor is replicated over (:func:`shard_box`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from pytorch_distributed_tpu_torch.runtime import distributed as dist

AXES: Tuple[str, ...] = ("dp", "fsdp", "pp", "ep", "sp", "tp")
#: the axes of the model-parallel mesh without ``pp``, in the JAX order
MODEL_MESH_AXES: Tuple[str, ...] = ("dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named axis sizes; ``-1`` on at most one axis takes the ranks the
    others leave (a reshape wildcard), as in the JAX ``MeshSpec``."""

    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXES)

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as ``jax.sharding.Mesh.shape`` (the rule
        engine reads it)."""
        return dict(zip(AXES, self.sizes()))

    def resolve(self, world_size: int) -> "MeshSpec":
        """Fill in the ``-1`` wildcard so the product equals
        ``world_size`` (the JAX ``MeshSpec.resolve``)."""
        sizes = list(self.sizes())
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got spec {self}")
        fixed = math.prod(s for s in sizes if s != -1)
        if wild:
            if world_size % fixed != 0:
                raise ValueError(
                    f"{world_size} ranks not divisible by the fixed axes' "
                    f"product {fixed} (spec {self})")
            sizes[wild[0]] = world_size // fixed
        elif fixed != world_size:
            raise ValueError(
                f"MeshSpec {self} wants {fixed} ranks, the world has "
                f"{world_size}")
        return MeshSpec(**dict(zip(AXES, sizes)))

    def model_parallel(self) -> bool:
        """Whether ``ep``, ``sp`` or ``tp`` is above 1 (the 5-D mesh)."""
        return self.ep > 1 or self.sp > 1 or self.tp > 1

    def mesh_shape(self) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
        """``(shape, dim names)`` of the ``DeviceMesh`` of a resolved
        spec (see the module docstring)."""
        if self.pp > 1:
            return self.sizes(), AXES
        if self.model_parallel():
            return (tuple(getattr(self, a) for a in MODEL_MESH_AXES),
                    MODEL_MESH_AXES)
        if self.dp > 1:
            return (self.dp, self.fsdp), ("dp", "fsdp")
        if self.fsdp > 1:
            return (self.fsdp,), ("fsdp",)
        return (1,), ("dp",)

    def shard_dims(self) -> Tuple[str, ...]:
        """The dims of the mesh FSDP shards over (``fsdp``) and
        replicates over (``dp``, when above 1)."""
        _, names = self.mesh_shape()
        if not self.model_parallel() and self.pp == 1:
            return names
        return ("dp", "fsdp") if self.dp > 1 else ("fsdp",)


_CURRENT: Optional[tuple] = None   # (DeviceMesh, resolved MeshSpec)


def make_mesh(spec: MeshSpec = MeshSpec(), device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``spec`` over every rank of the process group
    (which must exist): see :meth:`MeshSpec.mesh_shape`. It becomes the
    current mesh."""
    global _CURRENT
    from torch.distributed.device_mesh import init_device_mesh

    resolved = spec.resolve(dist.get_world_size())
    shape, names = resolved.mesh_shape()
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=names)
    _CURRENT = (mesh, resolved)
    return mesh


def current_mesh():
    """``(mesh, spec)`` of the last :func:`make_mesh` (or
    :func:`set_current_mesh`) in this process group, or None."""
    if _CURRENT is None or not dist.is_initialized():
        return None
    mesh, spec = _CURRENT
    if mesh.size() != dist.get_world_size():
        return None   # a mesh of an earlier process group
    return _CURRENT


def set_current_mesh(mesh, spec: Optional[MeshSpec] = None) -> None:
    """Make ``mesh`` (a ``DeviceMesh`` over the process group) the current
    one, with its resolved ``spec`` (read off the mesh's dim names and
    sizes unless given); None clears it."""
    global _CURRENT
    if mesh is None:
        _CURRENT = None
        return
    if spec is None:
        sizes = {a: 1 for a in AXES}
        sizes.update(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))
        spec = MeshSpec(**sizes)
    _CURRENT = (mesh, spec)


def clear_current_mesh() -> None:
    set_current_mesh(None)


def mesh_axis_size(axis: str) -> int:
    """The size of ``axis`` on the current mesh; without one, the default
    pure-``dp`` mesh of the JAX package: ``dp`` is the world (1 without a
    process group), every other axis 1."""
    if axis not in AXES:
        raise KeyError(f"unknown mesh axis {axis!r}; axes are {AXES}")
    cur = current_mesh()
    if cur is not None:
        return getattr(cur[1], axis)
    if axis == "dp" and dist.is_initialized():
        return dist.get_world_size()
    return 1


def data_axes() -> Tuple[str, ...]:
    """Axes over which the global batch is split (dp and fsdp)."""
    return ("dp", "fsdp")


def data_rank() -> Tuple[int, int]:
    """``(index, count)`` of this rank's share of the global batch: its
    ``(dp, fsdp)`` coordinate flattened, over ``dp * fsdp`` shares, so
    ranks that differ only in ``pp``, ``ep``, ``sp`` or ``tp`` read the
    same rows (the JAX batch splits over the data axes only). Without a
    current mesh, the process rank and world."""
    cur = current_mesh()
    if cur is None or not (cur[1].model_parallel() or cur[1].pp > 1):
        return dist.get_rank(), dist.get_world_size()
    mesh, spec = cur
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return coord["dp"] * spec.fsdp + coord["fsdp"], spec.dp * spec.fsdp


def is_shard(placement) -> bool:
    """Whether a ``DTensor`` placement cuts its dim: ``Shard`` and FSDP2's
    ``_StridedShard`` of a TP shard (which is no ``Shard`` subclass, and
    whose ``is_shard()`` is False in some torch releases)."""
    return not (placement.is_replicate() or placement.is_partial())


def shard_box(t, free: Tuple[str, ...] = ()
              ) -> Tuple[object, Tuple[int, ...], bool]:
    """``(local, offsets, writer)`` of a tensor: a plain one is its own
    local part at offset 0 of every dim; a ``DTensor`` (FSDP's and TP's
    parameters, gradients and moments) holds the box of the global
    tensor that starts at ``offsets`` and has ``local``'s shape, cut as
    ``torch.chunk`` cuts each sharded dim (FSDP2's strided shards of a
    TP shard included). ``writer`` is True on one rank per box: the one
    at coordinate 0 of every mesh dim the tensor is replicated over,
    and of every dim of the current mesh that its own mesh leaves out
    (a norm's scale, sharded over ``fsdp`` alone, is held alike by every
    ``tp`` and ``sp`` rank), the mesh dims named in ``free`` aside (a
    ZeRO-1 owner's ``dp``, a pipeline stage's ``pp``)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    if not isinstance(t, DTensor):
        return t, (0,) * t.dim(), True
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    names = mesh.mesh_dim_names or (None,) * len(coord)
    writer = all(c == 0 for c, pl, name in zip(coord, t.placements, names)
                 if not is_shard(pl) and name not in free)
    cur = current_mesh()
    if cur is not None:
        own = set(mesh.mesh_dim_names or ())
        root = cur[0]
        writer = writer and all(
            c == 0 for name, c in zip(root.mesh_dim_names,
                                      root.get_coordinate())
            if name not in own and name not in free)
    local = t.to_local()
    shape, offsets = compute_local_shape_and_global_offset(
        tuple(t.shape), mesh, t.placements)
    if tuple(shape) != tuple(local.shape):
        raise ValueError(f"local part {tuple(local.shape)} of a "
                         f"{tuple(t.shape)} tensor; expected {shape}")
    return local, tuple(int(o) for o in offsets), writer


def row_shard(t) -> Tuple[object, int, bool]:
    """``(local, first_row, writer)`` of a tensor sharded along dim 0 at
    most (:func:`shard_box`'s box as a row range). A tensor cut along
    another dim (a row-parallel TP weight) raises: its callers read
    whole rows."""
    local, offsets, writer = shard_box(t)
    if any(offsets[1:]) or tuple(local.shape[1:]) != tuple(t.shape[1:]):
        raise NotImplementedError(
            f"a {tuple(t.shape)} tensor cut along a dim other than 0 "
            f"(local {tuple(local.shape)} at {offsets}): this caller reads "
            "whole rows (ROADMAP A10.1)")
    return local, (offsets[0] if offsets else 0), writer


def whole_tensor(t):
    """A ``DTensor`` gathered whole (differentiably: the backward keeps
    this rank's part of the gradient); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def sharded_over(t, axis: str) -> bool:
    """Whether ``t`` is a ``DTensor`` cut over the mesh dim ``axis``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return False
    names = t.device_mesh.mesh_dim_names or ()
    return axis in names and is_shard(t.placements[names.index(axis)])
