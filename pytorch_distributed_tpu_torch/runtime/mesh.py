"""The device mesh: the port of the data-parallel part of
``pytorch_distributed_tpu/runtime/mesh.py``.

The JAX package builds one mesh over named axes (``dp``, ``fsdp``,
``pp``, ``ep``, ``sp``, ``tp``) and expresses every strategy against it.
The port has data parallelism only: ``MeshSpec(dp=...)`` is a 1-D
``DeviceMesh`` over the ranks of the process group, one card a rank.
Any other axis above 1 raises, naming ROADMAP A10.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from pytorch_distributed_tpu_torch.runtime import distributed as dist

AXES: Tuple[str, ...] = ("dp", "fsdp", "pp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named axis sizes; ``dp=-1`` takes every rank of the world."""

    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def __post_init__(self):
        other = {a: getattr(self, a) for a in AXES[1:]
                 if getattr(self, a) != 1}
        if other:
            raise NotImplementedError(
                f"mesh axes {other}: only data parallelism (dp) is ported "
                "(ROADMAP A10)"
            )

    def sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXES)

    def resolve(self, world_size: int) -> "MeshSpec":
        """``dp=-1`` becomes the world size; any other dp must equal it."""
        if self.dp not in (-1, world_size):
            raise ValueError(
                f"MeshSpec(dp={self.dp}) over a world of {world_size} ranks"
            )
        return MeshSpec(dp=world_size)


def make_mesh(spec: MeshSpec = MeshSpec(), device_type: str = "cuda"):
    """A 1-D ``DeviceMesh`` named ``dp`` over every rank of the process
    group (which must exist)."""
    from torch.distributed.device_mesh import init_device_mesh

    spec = spec.resolve(dist.get_world_size())
    return init_device_mesh(device_type, (spec.dp,), mesh_dim_names=("dp",))


def data_axes() -> Tuple[str, ...]:
    """Axes over which the global batch is split (dp and fsdp)."""
    return ("dp", "fsdp")
