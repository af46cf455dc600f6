"""The shape-aware partition-rule engine: the port's copy of
``pytorch_distributed_tpu/autoplan/rules.py`` (the planner itself is
ROADMAP A10.6).

A :class:`TensorRule` is one declarative row: a path pattern and the
mesh axes that each trailing dim of the JAX leaf shards over. The engine
(:func:`compile_rule`) turns it into a ``(shape, mesh) -> PartitionSpec``
callable with the two behaviours every family's rules rely on:

* ``spec`` names the TRAILING dims: with ``stacked=True`` a leaf with
  exactly one extra leading dim (the scan-stacked layer axis) keeps that
  dim unsharded;
* an entry whose axes' total size is 1 is kept, and one whose dim does
  not divide the axes' size is dropped, replicating that dim, with a
  warning once per (pattern, entry, dim size, axes size): MQA's single
  kv head and Qwen2-7B's 4 kv heads at tp 8 replicate k/v instead of
  failing.

A rank mismatch other than the stacked +1 applies the spec as it is
(for parameters a bad rule, which fails where the spec is used).
``mesh`` needs only a ``.shape`` mapping of axis sizes: a
``runtime.mesh.MeshSpec``, a ``DeviceMesh`` (read through
:func:`axis_sizes`) or a plain dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

from pytorch_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

#: one spec entry: unsharded, one mesh axis, or several mesh axes
Entry = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s shape: one entry per dim of a
    leaf (``None``, an axis name or a tuple of them); fewer entries than
    dims leave the trailing dims unsharded."""

    def __new__(cls, *entries: Entry):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class TensorRule:
    """One declarative partition rule: path pattern -> trailing-dim spec."""

    pattern: str  # path regex (PartitionRules semantics: search, first wins)
    spec: Tuple[Entry, ...]  # entries for the trailing dims
    stacked: bool = True  # tolerate one extra leading (scan layer) dim
    note: str = ""  # appended to the replication warning for context


def _axes_of(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a mesh-like: a mapping, anything with a
    ``.shape`` mapping (``MeshSpec``, a JAX mesh), or a ``DeviceMesh``
    (its dim names and sizes)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axes_size(entry: Entry, sizes) -> int:
    """Total ways an entry shards over, given mesh axis sizes."""
    return math.prod(sizes.get(a, 1) for a in _axes_of(entry)) if entry else 1


# once per (pattern, entry, dim size, axes size): a 32-layer model would
# otherwise repeat the same warning for every leaf
_warned: set = set()


def reset_warned() -> None:
    """Clear the warning dedup set (tests asserting the warning fires)."""
    _warned.clear()


def compile_rule(rule: TensorRule) -> Callable[[Tuple[int, ...], object],
                                               PartitionSpec]:
    """A ``(shape, mesh) -> PartitionSpec`` callable for
    ``parallel.sharding.PartitionRules``."""

    def spec_fn(shape: Tuple[int, ...], mesh) -> PartitionSpec:
        entries: List[Entry] = list(rule.spec)
        if rule.stacked and len(shape) == len(entries) + 1:
            entries = [None] + entries
        sizes = axis_sizes(mesh)
        out: List[Entry] = []
        for i, entry in enumerate(entries):
            size = axes_size(entry, sizes)
            if (
                entry is not None
                and size > 1
                and i < len(shape)
                and shape[i] % size != 0
            ):
                key = (rule.pattern, entry, shape[i], size)
                if key not in _warned:
                    _warned.add(key)
                    logger.warning(
                        "partition rule %r: dim %d (size %d) does not "
                        "divide mesh axes %r (%d ways) — replicating "
                        "that dim (tensor shape %s)%s",
                        rule.pattern, i, shape[i], _axes_of(entry), size,
                        tuple(shape),
                        f"; {rule.note}" if rule.note else "",
                    )
                out.append(None)
            else:
                out.append(entry)
        return PartitionSpec(*out)

    return spec_fn


def engine_rules(
    rules: Sequence[TensorRule],
) -> List[Tuple[str, Callable[[Tuple[int, ...], object], PartitionSpec]]]:
    """Compile TensorRules into ``(pattern, spec)`` pairs."""
    return [(r.pattern, compile_rule(r)) for r in rules]


def replicated_rule(pattern: str, ndim: int, *, stacked: bool = True,
                    note: str = "") -> TensorRule:
    """A rule that pins ``pattern`` replicated (the forced-MQA form)."""
    return TensorRule(pattern, (None,) * ndim, stacked=stacked, note=note)


def max_divisible_tp(dims: Sequence[int], n_devices: int) -> List[int]:
    """Candidate tp widths: divisors of ``n_devices`` that also divide
    every dim in ``dims`` (a model's head count, say)."""
    out = []
    for t in range(1, n_devices + 1):
        if n_devices % t:
            continue
        if all(d % t == 0 for d in dims if d):
            out.append(t)
    return out


def spec_entries(spec: Optional[PartitionSpec], ndim: int) -> List[Entry]:
    """``spec``'s entries padded with None to ``ndim`` (None: all)."""
    entries = list(spec or ())
    if len(entries) > ndim:
        raise ValueError(f"spec {spec} has more entries than the leaf's "
                         f"{ndim} dims")
    return entries + [None] * (ndim - len(entries))
