"""The device mesh: the port of the data-parallel and fully-sharded part
of ``pytorch_distributed_tpu/runtime/mesh.py``.

The JAX package builds one mesh over named axes (``dp``, ``fsdp``,
``pp``, ``ep``, ``sp``, ``tp``) and expresses every strategy against it.
The port has the two data axes: ``dp`` (replicas) and ``fsdp``
(parameters and optimizer state sharded), one card a rank, ``dp``
outermost as in the JAX mesh. :func:`make_mesh` builds the
``DeviceMesh`` every strategy uses: 2-D ``("dp", "fsdp")`` whenever
``dp > 1`` (FSDP replicates its shards over ``dp``, as the JAX mesh
does, ``fsdp == 1`` included), 1-D ``fsdp`` when only ``fsdp`` is above
1, and 1-D ``dp`` of one rank otherwise. Any other axis above 1 raises,
naming ROADMAP A10.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from pytorch_distributed_tpu_torch.runtime import distributed as dist

AXES: Tuple[str, ...] = ("dp", "fsdp", "pp", "ep", "sp", "tp")
PORTED_AXES: Tuple[str, ...] = ("dp", "fsdp")


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

    def __post_init__(self):
        other = {a: getattr(self, a) for a in AXES
                 if a not in PORTED_AXES and getattr(self, a) != 1}
        if other:
            raise NotImplementedError(
                f"mesh axes {other}: only the data axes (dp, fsdp) are "
                "ported (ROADMAP A10)"
            )

    def sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXES)

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

    def mesh_shape(self) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
        """``(shape, dim names)`` of the ``DeviceMesh`` of a resolved
        spec (see the module docstring)."""
        if self.dp > 1:
            return (self.dp, self.fsdp), ("dp", "fsdp")
        if self.fsdp > 1:
            return (self.fsdp,), ("fsdp",)
        return (1,), ("dp",)


def make_mesh(spec: MeshSpec = MeshSpec(), device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``spec`` over every rank of the process group
    (which must exist): see :meth:`MeshSpec.mesh_shape`."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = spec.resolve(dist.get_world_size()).mesh_shape()
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def data_axes() -> Tuple[str, ...]:
    """Axes over which the global batch is split (dp and fsdp)."""
    return ("dp", "fsdp")


def row_shard(t) -> Tuple[object, int, bool]:
    """``(local, first_row, writer)`` of a tensor: a plain one is its own
    local part from row 0; a ``DTensor`` (FSDP's parameters, gradients
    and moments) is sharded along dim 0 over one mesh dim, rows cut as
    ``torch.chunk`` cuts them, and replicated over the others (HSDP's
    ``dp``). ``writer`` is True on one rank per shard: the one at
    coordinate 0 of every replicated dim."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t, 0, True
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    start, writer = 0, True
    for dim, pl in enumerate(t.placements):
        if isinstance(pl, Replicate):
            writer = writer and coord[dim] == 0
        elif isinstance(pl, Shard) and pl.dim == 0:
            chunk = -(-t.shape[0] // mesh.size(dim))
            start = min(coord[dim] * chunk, t.shape[0])
        else:
            raise NotImplementedError(
                f"placement {pl} of a {tuple(t.shape)} tensor: the port "
                "shards along dim 0 only (ROADMAP A10)")
    local = t.to_local()
    if start + local.shape[0] > t.shape[0]:
        raise ValueError(f"local rows [{start}, {start + local.shape[0]}) "
                         f"of a {tuple(t.shape)} tensor")
    return local, start, writer
