"""Pipeline parallelism in its GPipe form: the port of
``pytorch_distributed_tpu/parallel/pipeline.py``.

The JAX package runs a pipeline as one SPMD program: the stage-stacked
parameters are sharded over the ``pp`` mesh axis, a ``lax.scan`` over
``M + S - 1`` ticks hands each stage's output to the next stage with a
``ppermute``, and autodiff of the scan is the reverse pipeline. The port
is one process per stage, and the tick loop is this rank's part of that
program: at tick ``t`` stage 0 takes microbatch ``t``, every other stage
the activation its predecessor handed it at tick ``t - 1``
(``runtime.distributed.permute_grad``, whose backward hands the
gradient back the other way), and the last stage collects microbatch
``t - (S-1)``. The masked outputs are summed over ``pp``
(``sum_outputs``: the gradient goes back to each rank once), so every
stage gets the outputs, as the JAX ``psum`` replicates them. A stage is
busy on ticks ``s .. s+M-1``; on its other ticks it hands its input on
unchanged (the JAX scan computes there on garbage that never reaches an
output: the same values and gradients, without the work). The bubble is
``(S-1)/(M+S-1)`` of the ticks; keep ``M >= 4 S``.

Every stage runs the same sequence of collectives, forward and backward:
the selections between a microbatch and the hand-off keep both in the
autograd graph on every rank (a zero gradient where not selected), so
each tick's hand-off is differentiated on every rank, in the same order.

Layout: stage-stacked parameters have leading dim ``S``, and stage ``s``
uses row ``s`` (:func:`stage_box`, the counterpart of
``stage_sharding``: the box of the stacked leaves a stage holds);
microbatched inputs and outputs have leading dim ``M``, the same on
every stage.
"""

from __future__ import annotations

from typing import Callable

import torch

from pytorch_distributed_tpu_torch.runtime import distributed as dist


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def group_coordinate(group) -> tuple:
    """``(stage, stages)`` of this rank in ``group`` (a ``Subgroup``,
    torch's process group, or None: a world of one stage when there is
    no process group, else the world)."""
    if group is None:
        return dist.get_rank(), dist.get_world_size()
    if isinstance(group, dist.Subgroup):
        return group.ranks.index(dist.get_rank()), group.size
    import torch.distributed as tdist

    return tdist.get_rank(group), tdist.get_world_size(group)


def stage_box(stacked, group=None):
    """This stage's row of stage-stacked leaves (leading dim ``S``, the
    stage count of ``group``): the box of them a stage holds, the
    counterpart of ``stage_sharding``'s ``P("pp")``. A leaf whose leading
    dim is not ``S`` raises ``ValueError``."""
    stage, n = group_coordinate(group)
    for leaf in _leaves(stacked):
        if leaf.shape[0] != n:
            raise ValueError(
                f"stacked param leading dim {leaf.shape[0]} != pipeline "
                f"stages {n}")
    return _tree_map(lambda p: p[stage], stacked)


def _select(first: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` if ``first`` else ``b``, both kept in the autograd graph (the
    other gets a zero gradient), as ``jnp.where`` on a traced stage."""
    return torch.where(torch.tensor(first, device=a.device), a, b)


def pipeline_ticks(stage_fn: Callable, microbatches: torch.Tensor, *,
                   group=None) -> torch.Tensor:
    """The GPipe tick loop on this rank's stage: ``stage_fn(x) -> y``
    applies the stage (``x`` and ``y`` of one shape and dtype, the
    activation handed between stages) to each of ``microbatches`` [M,
    ...] in turn; returns the last stage's outputs [M, ...] on every
    stage (module docstring). ``group`` holds the stages in order."""
    stage, n = group_coordinate(group)
    M = microbatches.shape[0]
    first, last = stage == 0, stage == n - 1
    if n == 1:
        return torch.stack([stage_fn(microbatches[i]) for i in range(M)])
    shift = [(i, i + 1) for i in range(n - 1)]   # stage i -> i + 1
    # requiring a gradient, so every hand-off needs one on every stage
    # (on an idle tick too), and each stage differentiates each hand-off
    cur = torch.zeros_like(microbatches[0]).requires_grad_(
        torch.is_grad_enabled())
    outs = [None] * M
    for t in range(M + n - 1):
        inp = _select(first, microbatches[min(t, M - 1)], cur)
        # busy on ticks stage .. stage+M-1; else the input is handed on
        y = stage_fn(inp) if stage <= t < stage + M else inp
        m = t - (n - 1)
        if m >= 0:
            outs[m] = y
        if t < M + n - 2:   # nothing takes the last tick's hand-off
            cur = dist.permute_grad(y, shift, group=group)
    out = torch.stack(outs)
    # only the last stage's outputs are real; the sum replicates them
    out = _select(last, out, torch.zeros_like(out))
    return dist.sum_outputs(out, group)


def pipeline_forward(stage_fn: Callable, stage_params, microbatches, *,
                     group=None):
    """Run stage-stacked params over microbatches with a GPipe schedule
    over the stages of ``group`` (the ``pp`` axis group:
    ``parallel.sequence.axis_group("pp")``'s first element).

    ``stage_fn(params_one_stage, x) -> y`` applies ONE stage (``x`` and
    ``y`` of one shape and dtype). ``stage_params``: a tree (dicts,
    lists, tensors) whose leaves have leading dim ``S`` = the stage
    count, of which this stage uses row ``s`` (:func:`stage_box`); a
    leaf of another leading dim raises ``ValueError``. ``microbatches``:
    [M, ...], M >= 1, the same on every stage. Returns [M, ...] outputs,
    the same on every stage.

    Differentiable end to end: the gradient of the stacked params is
    this stage's row (the other rows zero), the JAX gradient's shard."""
    params = stage_box(stage_params, group)
    return pipeline_ticks(lambda x: stage_fn(params, x), microbatches,
                          group=group)


def split_microbatches(batch, num_microbatches: int):
    """[B, ...] -> [M, B/M, ...] for a tensor, or every value of a dict
    of them."""

    def split(x):
        B = x.shape[0]
        if B % num_microbatches != 0:
            raise ValueError(
                f"batch dim {B} not divisible by {num_microbatches} "
                "microbatches")
        return x.reshape((num_microbatches, B // num_microbatches)
                         + tuple(x.shape[1:]))

    return _tree_map(split, batch)


def merge_microbatches(batch):
    """Inverse of :func:`split_microbatches`."""
    return _tree_map(
        lambda x: x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:])),
        batch)
