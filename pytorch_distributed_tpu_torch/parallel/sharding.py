"""Sharding inference: the port of ``pytorch_distributed_tpu/parallel/
sharding.py``.

The JAX package decides at trace time which mesh axes each leaf's dims
map onto: rules are ``(path regex, spec)`` pairs, first match wins, a
spec a ``PartitionSpec``, None (replicate) or a ``(shape, mesh) ->
PartitionSpec`` callable (``shard_along``, ``stacked``, the rule
engine's compiled rules). The port keeps the rules and the inference
over JAX leaf paths and shapes as they are (:class:`PartitionRules`,
:func:`infer_sharding`, :func:`infer_tree_shardings`,
:func:`infer_opt_tree_shardings`), so one rule table places a leaf alike
in both packages.

:func:`infer_placements` carries a JAX leaf's spec over to the port
tensor that stands for it (``interop.model_slots``): the tensor is the
leaf's array of one layer, transposed and reshaped, so a JAX axis that
leads the axes folded into one port dim shards that dim in contiguous
chunks, ``Shard(dim)`` over the spec's mesh axes. The result is what the
TP plan (``parallel.strategies.tp_plan``) applies with
``parallelize_module``.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from pytorch_distributed_tpu_torch.parallel.rules import (
    PartitionSpec as P,
    axis_sizes,
    spec_entries,
)

SpecLike = Union[P, Callable[[Tuple[int, ...], object], P], None]


def path_str(path) -> str:
    """A leaf path as ``'a/b/0/c'``: a string as it is, or a sequence of
    keys (strings, ints, or JAX-style key objects with ``key``, ``idx``
    or ``name``)."""
    if isinstance(path, str):
        return path
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                k = getattr(k, attr)
                break
        parts.append(str(k))
    return "/".join(parts)


class PartitionRules:
    """Ordered (regex, spec) rules; first match wins."""

    def __init__(self, rules: Sequence[Tuple[str, SpecLike]] = ()):
        self._rules = [(re.compile(pat), spec) for pat, spec in rules]

    def extended(self, rules: Sequence[Tuple[str, SpecLike]]
                 ) -> "PartitionRules":
        """New rule set with ``rules`` taking priority over existing ones."""
        out = PartitionRules()
        out._rules = [(re.compile(p), s) for p, s in rules] + list(
            self._rules)
        return out

    def spec_for(self, path: str, shape: Tuple[int, ...],
                 mesh) -> Optional[P]:
        for pat, spec in self._rules:
            if pat.search(path):
                if callable(spec):
                    return spec(tuple(shape), mesh)
                return spec
        return None


def as_rules(rules) -> PartitionRules:
    """``rules`` as :class:`PartitionRules` (a list of pairs, or one)."""
    return rules if isinstance(rules, PartitionRules) else PartitionRules(
        rules or ())


def shard_along(axis: Union[str, Tuple[str, ...]], *, min_size: int = 2
                ) -> Callable[[Tuple[int, ...], object], P]:
    """Spec factory: shard the largest dim that divides the axes' size
    over ``axis``; replicate (``P()``) when none does."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)

    def spec(shape: Tuple[int, ...], mesh) -> P:
        sizes = axis_sizes(mesh)
        size = int(np.prod([sizes[a] for a in axes]))
        if size == 1:
            return P()
        candidates = [i for i, d in enumerate(shape)
                      if d % size == 0 and d >= max(min_size, size)]
        if not candidates:
            return P()
        best = max(candidates, key=lambda i: shape[i])
        entries: list = [None] * len(shape)
        entries[best] = axes if len(axes) > 1 else axes[0]
        return P(*entries)

    return spec


def stacked(spec: P) -> Callable[[Tuple[int, ...], object], P]:
    """A per-layer spec for scan-stacked leaves: with exactly one more
    dim than the spec, the leading layer dim is left unsharded."""

    def f(shape: Tuple[int, ...], mesh) -> P:
        if len(shape) == len(spec) + 1:
            return P(*([None] + list(spec)))
        return spec

    return f


def infer_sharding(rules, path: str, shape: Tuple[int, ...], mesh) -> P:
    """The spec of one leaf (``P()``, replicated, when no rule matches)."""
    spec = as_rules(rules).spec_for(path, shape, mesh)
    return spec if spec is not None else P()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, tuple) else tuple(
        getattr(leaf, "shape", ()) or ())


def infer_tree_shardings(tree, rules, mesh) -> dict:
    """``{path: spec}`` of a nested dict whose leaves are arrays, tensors
    or shape tuples."""
    return {path_str(p): infer_sharding(rules, path_str(p), _shape(leaf),
                                        mesh)
            for p, leaf in _leaves(tree)}


def best_param_suffix(param_paths, path: str) -> Optional[str]:
    """Segment-aligned suffix match, the LONGEST parameter path wins (an
    optimizer-state leaf carries its parameter's path as a suffix:
    ``mu/embed/embedding``)."""
    best = None
    for param_path in param_paths:
        if path == param_path or path.endswith("/" + param_path):
            if best is None or len(param_path) > len(best):
                best = param_path
    return best


def infer_opt_tree_shardings(opt_state, params, rules, mesh, *,
                             mismatch_rules=None) -> dict:
    """``{path: spec}`` of optimizer state, validated against the
    parameter shapes: a state leaf of its parameter's shape (Adam's
    moments) takes the parameter's rules; one of another shape
    (Adafactor's factored ``v_row``/``v_col``) takes ``mismatch_rules``,
    or replicates."""
    param_shapes = {path_str(p): _shape(leaf) for p, leaf in _leaves(params)}
    out = {}
    for p, leaf in _leaves(opt_state):
        path, shape = path_str(p), _shape(leaf)
        best = best_param_suffix(param_shapes, path)
        if best is not None and shape != param_shapes[best]:
            out[path] = (P() if mismatch_rules is None else
                         infer_sharding(mismatch_rules, path, shape, mesh))
        else:
            out[path] = infer_sharding(rules, path, shape, mesh)
    return out


REPLICATED = PartitionRules([(".*", None)])


# --------------------------------------------------------------------------
# JAX specs -> placements of the port's tensors
# --------------------------------------------------------------------------


def leaf_path(slot) -> str:
    """The JAX ``TrainState`` path of a slot's leaf (``params/...``), the
    string the rules match."""
    return "/".join((slot.tree,) + tuple(slot.path))


def _port_dim_of_axis(slot, jshape: Tuple[int, ...], axis: int, ways: int,
                      name: str) -> int:
    """The port dim whose contiguous chunks are the ``ways`` chunks of
    JAX axis ``axis`` of one layer's array (``jshape``); raises when
    there is none (the axis is not the outermost non-trivial axis folded
    into one port dim)."""
    if slot.perm is not None and slot.leaf is None:
        for dim, group in enumerate(slot.groups()):
            if axis in group:
                lead = group[:list(group).index(axis)]
                if all(jshape[a] == 1 for a in lead):
                    return dim
    else:   # send an index array through the slot's map and compare
        # (a slot whose ``jshape`` splits the leaf's axes: GPT-2's qkv)
        idx = np.arange(math.prod(jshape)).reshape(jshape)
        port = slot.from_jax(idx)
        want = np.sort(np.take(idx, range(jshape[axis] // ways),
                               axis=axis), axis=None)
        for dim in range(port.ndim):
            if port.shape[dim] % ways:
                continue
            got = np.take(port, range(port.shape[dim] // ways), axis=dim)
            if np.array_equal(np.sort(got, axis=None), want):
                return dim
    raise NotImplementedError(
        f"{name}: JAX axis {axis} of {jshape} is not a contiguous chunk of "
        "one dim of the port tensor (ROADMAP A10.1)")


def infer_placements(model, rules, mesh) -> Dict[str, Dict[str, int]]:
    """``{port tensor name: {mesh axis: port dim}}`` of every tensor of
    ``model`` that the rules shard, from its JAX leaf's spec (the
    leaf's path and shape as ``interop.model_slots`` place it). A
    scan-stacked leaf's layer axis must stay unsharded."""
    from pytorch_distributed_tpu_torch import interop

    shapes = interop.logical_shapes(model)
    out: Dict[str, Dict[str, int]] = {}
    for name, slot in interop.model_slots(model).items():
        lshape = slot.leaf_shape(shapes[name])
        spec = spec_entries(infer_sharding(rules, leaf_path(slot), lshape,
                                           mesh), len(lshape))
        if slot.layer is not None:
            if spec[0] is not None:
                raise NotImplementedError(
                    f"{name}: the layer axis of {leaf_path(slot)} is "
                    f"sharded ({spec[0]!r}); the port's layers are modules")
            spec, jshape = spec[1:], lshape[1:]
        else:
            jshape = lshape
        sizes = axis_sizes(mesh)
        placed = {}
        for axis, entry in enumerate(spec):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
            if not axes:
                continue
            dim = _port_dim_of_axis(slot, jshape, axis,
                                    math.prod(sizes[a] for a in axes), name)
            for a in axes:
                placed[a] = dim
        if placed:
            out[name] = placed
    return out
