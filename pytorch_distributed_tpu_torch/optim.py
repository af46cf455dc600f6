"""Optimizers with optax's semantics on ``torch.optim``: the port of the
part of ``pytorch_distributed_tpu/optim.py`` the training slice uses.

* :func:`SGD` is ``torch.optim.SGD`` without dampening, whose update is
  optax's ``sgd``: the trace is ``g + m * trace`` (torch's first step
  sets the buffer to ``g``, which is the same thing from a zero trace),
  Nesterov steps along ``g + m * trace_new``, and the parameter moves by
  ``-lr * update``.
* :func:`AdamW` and :func:`Adam` are ``torch.optim.AdamW``/``Adam``,
  whose update is optax's (``m_hat / (sqrt(v_hat) + eps)``; AdamW decays
  decoupled, ``lr * wd * p``; Adam folds ``wd * p`` into the gradient).
  ``lr`` may be a schedule ``count -> lr``, read before each update with
  the number of updates taken so far, as optax counts.
* :func:`clip_grad_norm` wraps an optimizer so every ``step()`` first
  scales the gradients by ``max_norm / norm`` when their global norm
  exceeds ``max_norm`` (``optax.clip_by_global_norm``: no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``). Under ZeRO-1 it wraps the
  ``ZeroRedundancyOptimizer``, whose ``param_groups`` hold every
  parameter, never the per-rank optimizer inside it: a norm over one
  rank's shard would clip by the wrong factor without an error. Under
  FSDP the gradients are ``DTensor`` shards: :func:`global_norm` sums
  each shard's squares on its rank, once per shard (HSDP's replicas
  skipped), over the shard's process group, so the norm is the whole
  gradient's, and the clip scales each rank's shard in place.
* :func:`AdamW` and :func:`SGD` also take a list of param-group dicts,
  which is how ``ZeroRedundancyOptimizer`` builds its per-rank optimizer
  (``optimizer_class(groups, **defaults)``).
* :func:`no_decay_mask` is the "no decay for biases and norms" split over
  the port's parameter names: every ``bias`` and every norm's weight,
  the JAX package's ``bias`` and ``scale`` leaves. BERT's free
  ``mlm_bias`` is a leaf of its own name there and decays, so it does
  here. Given a module, the optimizers take its trainable parameters
  only: under LoRA the adapters (which decay, as their JAX leaves
  ``.../kernel/a`` and ``/b`` do), never the frozen base.

The JAX recipe's ``optax.adamw(lr)`` decays every parameter by its
default 1e-4; this module's :func:`AdamW`, like the JAX package's
``optim.AdamW``, defaults to 0.01. Pass the one the caller mirrors.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, Optional, Sequence, Union

import torch

Schedule = Callable[[int], float]
LrOrSchedule = Union[float, Schedule]

#: parameter-name patterns exempt from weight decay: biases and the
#: LayerNorm/RMSNorm scales (the port's names: ``blocks.3.ln1.weight``,
#: ``ln_f.weight``, ``layers.0.attn_norm.weight``, BERT's
#: ``bert.layers.0.attn_ln.weight`` and ``mlm_ln.weight``)
DEFAULT_NO_DECAY = (r"(^|\.)bias$", r"(^|[._])(ln\w*|\w*norm)\.weight$")


def no_decay_mask(patterns: Sequence[str] = DEFAULT_NO_DECAY):
    """``mask(module) -> {name: decay?}``: True for every parameter whose
    name matches none of ``patterns`` (re.search)."""
    regs = [re.compile(p) for p in (
        (patterns,) if isinstance(patterns, str) else patterns
    )]

    def mask(module: torch.nn.Module) -> Dict[str, bool]:
        return {
            name: not any(r.search(name) for r in regs)
            for name, _ in module.named_parameters()
        }

    return mask


def _param_groups(params, weight_decay: float,
                  no_decay: Optional[Sequence[str]]):
    """Parameters -> torch param groups; with ``no_decay`` (which needs a
    module, for the names) the matching ones get weight decay 0. Param
    groups given as dicts (as ``ZeroRedundancyOptimizer`` builds its
    per-rank optimizer) pass through."""
    if not isinstance(params, torch.nn.Module):
        params = list(params)
        if params and isinstance(params[0], dict):
            if no_decay is not None:
                raise ValueError("no_decay needs the module, not groups")
            return [dict(g) for g in params]
    if no_decay is None:
        if isinstance(params, torch.nn.Module):
            params = [p for p in params.parameters() if p.requires_grad]
        return [{"params": list(params), "weight_decay": weight_decay}]
    if not isinstance(params, torch.nn.Module):
        raise ValueError("no_decay needs the module, to read parameter names")
    decay = no_decay_mask(no_decay)(params)
    # a module's frozen parameters (a LoRA base) are no optimizer's
    named = {n: p for n, p in params.named_parameters() if p.requires_grad}
    return [
        {"params": [p for n, p in named.items() if decay[n]],
         "weight_decay": weight_decay},
        {"params": [p for n, p in named.items() if not decay[n]],
         "weight_decay": 0.0},
    ]


class _Scheduled:
    """Sets every group's lr from ``schedule(count)`` before each step."""

    def _init_schedule(self, lr: LrOrSchedule) -> float:
        self.schedule = lr if callable(lr) else None
        self.count = 0
        return float(lr(0)) if callable(lr) else float(lr)

    def step(self, closure=None):
        if self.schedule is not None:
            lr = float(self.schedule(self.count))
            for group in self.param_groups:
                group["lr"] = lr
        self.count += 1
        return super().step(closure)


class SGD(_Scheduled, torch.optim.SGD):
    """``optax.sgd(lr, momentum, nesterov)``: with a schedule, step ``t``
    reads ``lr(t)`` before counting it, so a warmup from 0 makes the
    first update zero (the momentum trace still takes that step's
    gradient)."""

    def __init__(
        self,
        params: Union[torch.nn.Module, Iterable[torch.Tensor]],
        lr: LrOrSchedule = 0.1,
        momentum: float = 0.0,
        nesterov: bool = False,
    ):
        if isinstance(params, torch.nn.Module):
            params = params.parameters()
        super().__init__(
            list(params), lr=self._init_schedule(lr), momentum=momentum,
            nesterov=nesterov, dampening=0.0,
        )


class AdamW(_Scheduled, torch.optim.AdamW):
    """``optax.adamw``: decoupled weight decay, scaled by lr. ``params``
    is a module or an iterable of tensors (a module when ``no_decay`` is
    given)."""

    def __init__(
        self,
        params: Union[torch.nn.Module, Iterable[torch.Tensor]],
        lr: LrOrSchedule = 1e-3,
        betas: Sequence[float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.01,
        no_decay: Optional[Sequence[str]] = None,
    ):
        super().__init__(
            _param_groups(params, weight_decay, no_decay),
            lr=self._init_schedule(lr), betas=tuple(betas), eps=eps,
            weight_decay=weight_decay,
        )


class Adam(_Scheduled, torch.optim.Adam):
    """``torch.optim.Adam``: L2 folded into the gradients (not AdamW's
    decoupling), as the JAX package's ``optim.Adam``."""

    def __init__(
        self,
        params: Union[torch.nn.Module, Iterable[torch.Tensor]],
        lr: LrOrSchedule = 1e-3,
        betas: Sequence[float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        no_decay: Optional[Sequence[str]] = None,
    ):
        super().__init__(
            _param_groups(params, weight_decay, no_decay),
            lr=self._init_schedule(lr), betas=tuple(betas), eps=eps,
            weight_decay=weight_decay,
        )


def _local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local shard (FSDP's gradients), else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32 at least (f64 stays f64, as optax sums in its dtype)."""
    return t if t.dtype == torch.float64 else t.float()


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element, in f32 (f64 for f64
    tensors), on the device.
    ``DTensor`` shards (FSDP) count every element of the whole tensor
    once: each rank's squares are summed over the mesh dims it is
    sharded on (never the replicated ones)."""
    from torch.distributed.tensor import DTensor, Shard

    plain = [t for t in tensors if not isinstance(t, DTensor)]
    sharded: Dict[tuple, list] = {}
    for t in tensors:
        if isinstance(t, DTensor):
            dims = tuple(i for i, pl in enumerate(t.placements)
                         if isinstance(pl, Shard))
            sharded.setdefault((t.device_mesh, dims), []).append(
                t.to_local())
    if not sharded:
        norms = torch._foreach_norm([_wide(t) for t in tensors])
        return torch.linalg.vector_norm(torch.stack(norms))
    squares = []
    if plain:
        norms = torch._foreach_norm([_wide(t) for t in plain])
        squares.append(torch.stack(norms).square().sum())
    for (mesh, dims), local in sharded.items():
        norms = torch._foreach_norm([_wide(t) for t in local])
        sq = torch.stack(norms).square().sum()
        for d in dims:
            torch.distributed.all_reduce(sq, group=mesh.get_group(d))
        squares.append(sq)
    return torch.stack(squares).sum().sqrt()


class _ClippedOptimizer:
    """An optimizer whose ``step`` first clips the gradients by their
    global norm. Everything else goes to the wrapped optimizer."""

    def __init__(self, optimizer: torch.optim.Optimizer, max_norm: float):
        self.optimizer = optimizer
        self.max_norm = float(max_norm)

    def clip_(self) -> torch.Tensor:
        """Scale the gradients in place; returns their norm before."""
        grads = [p.grad for g in self.optimizer.param_groups
                 for p in g["params"] if p.grad is not None]
        norm = global_norm(grads)
        # optax: g when norm < max, else g / norm * max (no epsilon); a
        # device-side select, so the step never waits for the host
        factor = torch.where(norm < self.max_norm, torch.ones_like(norm),
                             self.max_norm / norm)
        torch._foreach_mul_([_local(g) for g in grads], factor)
        return norm

    def step(self, closure=None):
        self.clip_()
        return self.optimizer.step(closure)

    def __getattr__(self, name):
        return getattr(self.optimizer, name)


def clip_grad_norm(optimizer: torch.optim.Optimizer,
                   max_norm: float) -> _ClippedOptimizer:
    """``optax.chain(optax.clip_by_global_norm(max_norm), tx)``."""
    return _ClippedOptimizer(optimizer, max_norm)


def WarmupCosine(
    lr: float,
    warmup_steps: int,
    total_steps: int,
    eta_min: float = 0.0,
    init_lr: float = 0.0,
) -> Schedule:
    """Linear warmup then cosine decay:
    ``optax.warmup_cosine_decay_schedule(init_lr, lr, warmup_steps,
    max(total_steps, 1), eta_min)``."""
    decay_steps = max(total_steps, 1) - warmup_steps
    if decay_steps <= 0:
        raise ValueError(
            "WarmupCosine needs total_steps > warmup_steps, got "
            f"{total_steps} and {warmup_steps}"
        )
    alpha = 0.0 if lr == 0.0 else eta_min / lr

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = count / warmup_steps
            return init_lr + (lr - init_lr) * frac
        t = min(count - warmup_steps, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
        return lr * ((1 - alpha) * cosine + alpha)

    return schedule
