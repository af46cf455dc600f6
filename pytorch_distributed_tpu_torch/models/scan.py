"""Rematerialization per transformer block: the port of ``remat`` in
``pytorch_distributed_tpu/models/scan.py``.

The JAX package scans one block over the depth and, with
``cfg.remat``, wraps it in ``nn.remat``, so the backward recomputes each
block's activations instead of keeping them. The port keeps its layers
in an ``nn.ModuleList`` and wraps each block's call in non-reentrant
``torch.utils.checkpoint``. :func:`remat_policy` maps the JAX policy
names: ``"full"`` saves nothing inside a block; ``"dots"`` saves every
matmul's result (``mm``, ``addmm``, ``bmm``, ``baddbmm``), as
``jax.checkpoint_policies.checkpoint_dots``; ``"dots_no_batch"`` saves
only the weight matmuls (``mm``, ``addmm``) and recomputes the batched
attention products, as ``checkpoint_dots_with_no_batch_dims``. The
flash kernels are no matmul op in either package: their forward runs
again in every policy's recompute.

Dropout draws its masks from an explicit ``torch.Generator``, and
``torch.utils.checkpoint`` saves and restores only the default
generators. :func:`remat_call` therefore snapshots the block's
generator state before the block runs and replays the recompute from
that snapshot, so the recompute draws the forward's masks, then puts the
generator back where it was: the live generator ends where a run without
remat leaves it.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils import checkpoint as tcheckpoint

_aten = torch.ops.aten
_SAVED = {
    "dots": (_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm),
    "dots_no_batch": (_aten.mm, _aten.addmm),
}


def _policy_fn(saved, ctx, op, *args, **kwargs):
    packet = getattr(op, "overloadpacket", op)
    if packet in saved:
        return tcheckpoint.CheckpointPolicy.MUST_SAVE
    return tcheckpoint.CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(name: Optional[str]) -> Optional[Callable]:
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a policy name:
    None for ``"full"`` (recompute everything), a selective-checkpoint
    context for ``"dots"`` and ``"dots_no_batch"``."""
    if name in (None, "full"):
        return None
    if name not in _SAVED:
        raise ValueError(
            f"unknown remat_policy {name!r}; expected full | dots | "
            "dots_no_batch")
    return functools.partial(
        tcheckpoint.create_selective_checkpoint_contexts,
        functools.partial(_policy_fn, _SAVED[name]))


def remat_call(fn: Callable, *args, generator: Optional[torch.Generator],
               policy: Optional[str] = None, **kwargs):
    """``fn(*args, generator=generator, **kwargs)`` under non-reentrant
    ``torch.utils.checkpoint`` with :func:`remat_policy`'s policy; the
    recompute replays ``generator`` from its state before the call."""
    snapshot = None if generator is None else generator.get_state()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1 or generator is None:   # the forward
            return fn(*a, generator=generator, **kwargs)
        live = generator.get_state()
        generator.set_state(snapshot)
        try:
            return fn(*a, generator=generator, **kwargs)
        finally:
            generator.set_state(live)

    context_fn = remat_policy(policy)
    extra = {} if context_fn is None else {"context_fn": context_fn}
    return tcheckpoint.checkpoint(run, *args, use_reentrant=False,
                                  preserve_rng_state=False, **extra)
