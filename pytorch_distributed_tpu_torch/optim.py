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
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
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
    per-rank optimizer) pass through. A group that mixes ``DTensor``
    parameters with plain ones (a tensor-parallel pipeline stage: its
    norms and positions stay plain) is split in two, since torch's
    multi-tensor step takes one kind a call."""
    return _split_dtensor_groups(_groups(params, weight_decay, no_decay))


def _split_dtensor_groups(groups):
    from torch.distributed.tensor import DTensor

    out = []
    for g in groups:
        kinds = [[p for p in g["params"] if isinstance(p, DTensor) == k]
                 for k in (True, False)]
        if all(kinds):
            out += [dict(g, params=k) for k in kinds]
        else:
            out.append(g)
    return out


def _groups(params, weight_decay: float, no_decay: Optional[Sequence[str]]):
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
    """Sets every group's lr from ``schedule(count)`` before each step,
    times ``lr_scale`` (1.0 unless :class:`ReduceLROnPlateau` moves
    it)."""

    lr_scale = 1.0

    def _init_schedule(self, lr: LrOrSchedule) -> float:
        self.schedule = lr if callable(lr) else None
        self.count = 0
        return float(lr(0)) if callable(lr) else float(lr)

    def step(self, closure=None):
        if self.schedule is not None:
            lr = float(self.schedule(self.count))
            for group in self.param_groups:
                group["lr"] = lr * self.lr_scale
        elif self.lr_scale != 1.0 or any("base_lr" in g
                                         for g in self.param_groups):
            for group in self.param_groups:
                group["lr"] = group.setdefault("base_lr",
                                               group["lr"]) * self.lr_scale
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


def global_norm(tensors: Sequence[torch.Tensor],
                groups: Optional[Sequence[object]] = None) -> torch.Tensor:
    """sqrt(sum of squares) over every element, in f32 (f64 for f64
    tensors), on the device.
    ``DTensor`` shards (FSDP) count every element of the whole tensor
    once: each rank's squares are summed over the mesh dims it is
    sharded on (never the replicated ones). ``groups`` (one entry per
    tensor, None for most) names a process group over which a tensor's
    squares are summed too: a pipeline stage's layers
    (``parallel.pipeline_lm``), each of which one stage holds."""
    from torch.distributed.tensor import DTensor

    from pytorch_distributed_tpu_torch.runtime.mesh import is_shard

    if groups is not None and any(g is not None for g in groups):
        by_group: Dict[object, list] = {}
        for t, g in zip(tensors, groups):
            by_group.setdefault(g, []).append(t)
        squares = []
        for g, ts in by_group.items():
            sq = global_norm(ts).square()
            if g is not None:
                torch.distributed.all_reduce(sq, group=g)
            squares.append(sq)
        return torch.stack(squares).sum().sqrt()

    plain = [t for t in tensors if not isinstance(t, DTensor)]
    sharded: Dict[tuple, list] = {}
    for t in tensors:
        if isinstance(t, DTensor):
            dims = tuple(i for i, pl in enumerate(t.placements)
                         if is_shard(pl))
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
        params = [p for g in self.optimizer.param_groups
                  for p in g["params"] if p.grad is not None]
        grads = [p.grad for p in params]
        norm = global_norm(grads, [getattr(p, "grad_norm_group", None)
                                   for p in params])
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


# --------------------------------------------------------------------------
# The rest of the JAX package's optim.py, in its order.
# --------------------------------------------------------------------------


class MultiOptimizer:
    """Several optimizers stepped as one: what :func:`param_groups`
    returns. ``param_groups`` and ``state`` are the union of theirs."""

    def __init__(self, optimizers: Sequence[torch.optim.Optimizer]):
        self.optimizers = list(optimizers)

    @property
    def param_groups(self):
        return [g for o in self.optimizers for g in o.param_groups]

    @property
    def state(self):
        out = {}
        for o in self.optimizers:
            out.update(o.state)
        return out

    def zero_grad(self, set_to_none: bool = True) -> None:
        for o in self.optimizers:
            o.zero_grad(set_to_none=set_to_none)

    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for o in self.optimizers:
            o.step()
        return loss


def param_groups(model: torch.nn.Module, groups, default=None
                 ) -> MultiOptimizer:
    """torch's param groups with a different optimizer per group, as the
    JAX ``param_groups`` (``optax.multi_transform``) labels leaves:
    ``groups`` is ``[(patterns, make), ...]`` where ``make(params)``
    builds the group's optimizer (e.g. ``lambda ps: AdamW(ps, lr=1e-3,
    weight_decay=0.0)``); a trainable parameter joins the first group
    one of whose patterns matches its name (``re.search``; write the
    catch-all last). Parameters no group matches are frozen (never
    updated), as the JAX default ``optax.set_to_zero``, unless
    ``default`` (another ``make``) is given."""
    regs = [([re.compile(p) for p in ((pats,) if isinstance(pats, str)
                                      else pats)], make)
            for pats, make in groups]
    buckets = [[] for _ in regs]
    rest = []
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        for i, (rs, _) in enumerate(regs):
            if any(r.search(name) for r in rs):
                buckets[i].append(p)
                break
        else:
            rest.append(p)
    opts = [make(ps) for (_, make), ps in zip(regs, buckets) if ps]
    if default is not None and rest:
        opts.append(default(rest))
    return MultiOptimizer(opts)


class _Leaf:
    """The port tensors that make up one JAX leaf, in layer order, each
    with its layout map to one layer of the leaf (``None``: the tensor
    is the leaf as it is), and the leaf's whole shape."""

    def __init__(self, path: str, params, geoms, shape, decay: bool):
        self.path, self.params, self.geoms = path, params, geoms
        self.shape = tuple(int(d) for d in shape)
        self.stacked = geoms[0] is not None and geoms[0].layer is not None
        self.numel = math.prod(self.shape)
        self.decay = decay


def _leaves(params, decay_of: Dict[int, bool],
            layouts: bool) -> List[_Leaf]:
    """The JAX leaves of ``params`` (a module, or tensors). A module's
    tensors group by their JAX leaf (``interop.geometries``: one leaf is
    every layer of a scan-stacked kernel); given tensors, each tensor is
    its own leaf in its own layout.
    ``layouts`` False groups by ``interop.model_slots`` alone (norms do
    not depend on the layout), so models with convolutions group too. A
    module the JAX package has no layout for is taken tensor by
    tensor."""
    slots = None
    if isinstance(params, torch.nn.Module):
        from pytorch_distributed_tpu_torch import interop

        base = getattr(params, "module", params)
        try:
            slots = interop.model_slots(base)
        except NotImplementedError:   # no JAX layout: tensor by tensor
            params = [p for p in params.parameters() if p.requires_grad]
    if slots is not None:
        named = {n: p for n, p in base.named_parameters() if p.requires_grad}
        if layouts:
            geoms = interop.geometries(base)
            where = {n: ("/".join(g.path), g.layer or 0, g) for n, g in
                     geoms.items() if n in named}
        else:
            where = {n: ("/".join(s.path), s.layer or 0, None)
                     for n, s in slots.items() if n in named}
        missing = set(named) - set(where)
        if missing:
            raise NotImplementedError(
                f"no JAX leaf for {sorted(missing)}: leafwise optimizers "
                "need the model's layout (ROADMAP A5)")
        by_path: Dict[str, list] = {}
        for n, (path, layer, g) in where.items():
            by_path.setdefault(path, []).append((layer, named[n], g))
        out = []
        for path in sorted(by_path):
            items = sorted(by_path[path], key=lambda x: x[0])
            ps = [p for _, p, _ in items]
            gs = [g for _, _, g in items]
            g = gs[0]
            shape = (g.stacked_shape if g is not None
                     else (len(ps),) * (len(ps) > 1) + tuple(ps[0].shape))
            decays = {decay_of.get(id(p), True) for p in ps}
            if len(decays) > 1:
                raise ValueError(f"leaf {path}: some layers decay, some not")
            out.append(_Leaf(path, ps, gs, shape, decays.pop()))
        return out
    return [_Leaf(str(i), [p], [None], tuple(p.shape),
                  decay_of.get(id(p), True)) for i, p in enumerate(params)]


def _shard_groups(t: torch.Tensor):
    """The process groups a ``DTensor``'s sum must be all-reduced over:
    its sharded mesh dims (never the replicated ones), as
    :func:`global_norm` sums them. None for a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return None
    mesh = t.device_mesh
    return [mesh.get_group(i) for i, pl in enumerate(t.placements)
            if isinstance(pl, Shard)]


def _leaf_reduce(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` (this rank's partial sum) summed over the shards of the
    leaf whose tensor ``like`` is, in place."""
    for group in _shard_groups(like) or ():
        torch.distributed.all_reduce(x, group=group)
    return x


def _leaf_sumsq(tensors: Sequence[torch.Tensor], like: torch.Tensor,
                dtype) -> torch.Tensor:
    """Sum of squares over every element of a leaf, each counted once
    (the local rows of each ``DTensor`` shard, all-reduced)."""
    total = torch.zeros((), dtype=dtype, device=tensors[0].device)
    for t in tensors:
        total = total + t.to(dtype).square().sum()
    return _leaf_reduce(total, like)


def _wide_dtype(t: torch.Tensor):
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _group_options(optimizer) -> Dict[int, dict]:
    return {id(p): g for g in optimizer.param_groups for p in g["params"]}


def _decay_flags(groups) -> Dict[int, bool]:
    return {id(p): g["weight_decay"] != 0.0 for g in groups
            for p in g["params"]}


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's ``_factored_dims``: the second largest and the largest
    axis, when both are at least ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    order = [int(i) for i in np.argsort(shape)]
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


class _RowBox:
    """A tensor's local rows (all of it unsharded, this rank's rows under
    FSDP) as a box of one layer of its JAX leaf: the JAX axis ``ax``
    that the port's row dim leads with, cut to ``[lo, hi)``, the other
    axes whole. ``ok`` is False when a rank's rows would cut an inner
    row axis (a row range that splits a head), decided from the global
    shapes, so every rank takes the same path."""

    def __init__(self, p: torch.Tensor, g):
        from pytorch_distributed_tpu_torch.runtime.mesh import row_shard
        from torch.distributed.tensor import DTensor, Shard

        pshape = tuple(p.shape)
        jshape = tuple(g.jshape) if g is not None else pshape
        self.transposed = g is not None and g.transposed
        # the port's rows are JAX axes [k, ...) of a transposed kernel
        # (its columns the axes before), else the leading axes [0, k)
        lead = pshape[1] if self.transposed else pshape[0]
        k = next(i for i in range(len(jshape) + 1)
                 if math.prod(jshape[:i]) == lead) if self.transposed \
            else next(i for i in range(1, len(jshape) + 1)
                      if math.prod(jshape[:i]) == lead)
        self.ax = k if self.transposed else 0
        self.jshape, self.pshape = jshape, pshape
        inner = math.prod(jshape[self.ax + 1:k] if not self.transposed
                          else jshape[k + 1:])
        local, first, _ = row_shard(p)
        self.n = local.shape[0]
        self.ok = True
        if isinstance(p, DTensor):
            for i, pl in enumerate(p.placements):
                if isinstance(pl, Shard):
                    chunk = -(-pshape[0] // p.device_mesh.size(i))
                    self.ok = chunk % inner == 0
        self.lo, self.hi = first // inner, (first + self.n) // inner

    def to_box(self, x: torch.Tensor) -> torch.Tensor:
        j, a = self.jshape, self.ax
        if self.transposed:
            return x.t().reshape(j[:a] + (self.hi - self.lo,) + j[a + 1:])
        return x.reshape((self.hi - self.lo,) + j[1:])

    def from_box(self, b: torch.Tensor) -> torch.Tensor:
        if self.transposed:
            return b.reshape(self.pshape[1], self.n).t()
        return b.reshape((self.n,) + self.pshape[1:])

    def cut(self, t: torch.Tensor, removed: int) -> torch.Tensor:
        """``t`` (one layer's statistic, axis ``removed`` reduced away)
        cut to this box's range of ``ax``."""
        if removed == self.ax:
            return t
        a = self.ax if self.ax < removed else self.ax - 1
        return t.narrow(a, self.lo, self.hi - self.lo)


class _Stepper(torch.optim.Optimizer):
    """An optimizer whose update is ``_update()``, run without autograd
    after :class:`_Scheduled` has set the lr."""

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        with torch.no_grad():
            self._update()
        return loss


class Adafactor(_Scheduled, _Stepper):
    """``optax.adafactor(lr, min_dim_size_to_factor=...)`` with its other
    defaults, on the JAX leaves of a model:
    ``scale_by_factored_rms`` (decay ``1 - (t + 1)^-0.8``, eps 1e-30,
    the second moment factored into row and column means over the leaf's
    two largest axes when the smaller of them is at least
    ``min_dim_size_to_factor``, else kept whole), ``clip_by_block_rms(1)``,
    ``scale_by_learning_rate``, ``scale_by_param_block_rms`` (min 1e-3),
    the masked ``add_decayed_weights`` and ``scale(-1)``.

    A "block" and a "factored axis" are those of the JAX leaf. Given a
    GPT-2, Llama or BERT, the optimizer groups the port tensors by their
    JAX leaf (``interop.geometries``: the JAX Llama's ``q`` kernel is one
    ``[L, D, H, hd]`` leaf over every layer, the port's ``L`` tensors
    ``[H * hd, D]``), views each in the leaf's layout to factor it, and
    takes each RMS over the whole leaf. Given tensors (the model's
    ``parameters()``), every tensor is its own leaf in its own layout:
    another optimizer, whose trajectory departs from optax's on a
    stacked model.

    Under FSDP a tensor is a ``DTensor`` sharded on dim 0: the factored
    means and the RMS sums are taken over this rank's rows and summed
    over the shard group (as :func:`global_norm`), so every element of
    the leaf counts once and a world of two steps as a world of one. The
    factored statistics are computed layer by layer on each rank's own
    rows viewed as a box of the JAX layer (no leaf is ever whole on a
    rank); only where a rank's rows cut an inner axis (half a head), or
    the layer axis is one of the two factored, is the leaf assembled
    whole, zeros in the other ranks' rows.

    State: a factored leaf keeps ``v_row`` and ``v_col`` in the JAX
    leaf's layout, stacked over layers (on the leaf's first tensor's
    state, replicated on every rank); an unfactored one keeps ``v``
    shaped (and sharded) like each tensor. Every tensor's ``step`` is
    optax's count. ZeRO-1 (a ``ZeroRedundancyOptimizer`` splitting the
    leaves over the ranks) is not supported."""

    #: optax.adafactor's defaults: the second moment's decay exponent,
    #: the squared gradient's epsilon, the block-RMS clip, the floor of
    #: the parameter scale
    decay_rate, eps, clipping_threshold, min_scale = 0.8, 1e-30, 1.0, 1e-3

    def __init__(
        self,
        params: Union[torch.nn.Module, Iterable[torch.Tensor]],
        lr: LrOrSchedule,
        weight_decay: float = 0.0,
        *,
        min_dim_size_to_factor: int = 128,
        no_decay: Optional[Sequence[str]] = None,
    ):
        if lr is None:
            raise ValueError("Adafactor needs an explicit lr (optax would "
                             "otherwise skip lr scaling)")
        if not isinstance(params, torch.nn.Module):
            params = list(params)
            if params and isinstance(params[0], dict):
                raise NotImplementedError(
                    "Adafactor over param-group dicts (ZeRO-1's per-rank "
                    "split) would cut its JAX leaves: use FSDP or DDP")
        groups = _param_groups(params, weight_decay, no_decay)
        super().__init__(groups, dict(lr=self._init_schedule(lr),
                                      weight_decay=weight_decay))
        self.min_dim_size_to_factor = int(min_dim_size_to_factor)
        self.leaves = _leaves(params, _decay_flags(groups), layouts=True)

    def factored(self, leaf: _Leaf):
        return _factored_dims(leaf.shape, self.min_dim_size_to_factor)

    # the checkpoint's view: which state a leaf keeps where
    def keeps_per_tensor(self, p: torch.Tensor) -> bool:
        """Whether ``p`` keeps a ``v`` of its own (an unfactored leaf)."""
        for leaf in self.leaves:
            if any(q is p for q in leaf.params):
                return self.factored(leaf) is None
        return False

    def leaf_state(self, leaf: _Leaf) -> Dict[str, torch.Tensor]:
        """The leaf-wide state (on its first tensor): ``v_row`` and
        ``v_col`` (``[1]`` zeros for an unfactored leaf, as optax keeps
        them), and for a factored leaf the ``[1]`` placeholder ``v``."""
        p0 = leaf.params[0]
        st = self.state[p0]
        if "v_row" not in st:
            dims = self.factored(leaf)
            kw = dict(dtype=p0.dtype, device=p0.device)
            if dims is None:
                st["v_row"] = torch.zeros(1, **kw)
                st["v_col"] = torch.zeros(1, **kw)
            else:
                d1, d0 = dims
                shape = list(leaf.shape)
                st["v_row"] = torch.zeros(
                    [s for i, s in enumerate(shape) if i != d0], **kw)
                st["v_col"] = torch.zeros(
                    [s for i, s in enumerate(shape) if i != d1], **kw)
                st["v_leaf"] = torch.zeros(1, **kw)
        return st

    def _full(self, leaf: _Leaf, locals_, dtype) -> torch.Tensor:
        """The whole leaf in its JAX layout from each tensor's local rows,
        zeros in the rows other ranks hold."""
        from pytorch_distributed_tpu_torch.runtime.mesh import row_shard

        layers = []
        for p, g, t in zip(leaf.params, leaf.geoms, locals_):
            _, first, _ = row_shard(p)
            if t.shape[0] != p.shape[0]:
                full = torch.zeros(tuple(p.shape), dtype=dtype,
                                   device=t.device)
                full[first:first + t.shape[0]] = t
            else:
                full = t.to(dtype)
            layers.append(full if g is None else g.to_jax(full))
        return torch.stack(layers) if len(layers) > 1 or leaf.stacked \
            else layers[0]

    def _local_rows(self, leaf: _Leaf, stacked: torch.Tensor):
        """The inverse of :meth:`_full`: each tensor's local rows."""
        from pytorch_distributed_tpu_torch.runtime.mesh import row_shard

        out = []
        many = len(leaf.params) > 1 or leaf.stacked
        for i, (p, g) in enumerate(zip(leaf.params, leaf.geoms)):
            one = stacked[i] if many else stacked
            port = one if g is None else g.from_jax(one)
            local, first, _ = row_shard(p)
            out.append(port[first:first + local.shape[0]])
        return out

    def per_layer(self, leaf: _Leaf, boxes=None) -> bool:
        """Whether the factored ``leaf`` is updated layer by layer on each
        rank's own rows, not assembled whole (see :meth:`_factored_update`)."""
        dims = self.factored(leaf)
        boxes = boxes or [_RowBox(p, g)
                          for p, g in zip(leaf.params, leaf.geoms)]
        return (dims is not None and all(b.ok for b in boxes)
                and not (leaf.stacked and 0 in dims))

    def _factored_update(self, leaf, dims, grads, st0, decay, dtype):
        """``scale_by_factored_rms`` on a factored leaf: its row and
        column means, the new ``v_row``/``v_col``, and each tensor's
        update (its local rows). Layer by layer on each rank's own rows
        (``_RowBox``), the partial means summed over the shard group;
        when the layer axis is itself factored or a rank's rows cut a
        head, on the whole leaf (:meth:`_full`, zeros where other ranks
        hold the rows)."""
        d1, d0 = dims
        p0 = leaf.params[0]
        boxes = [_RowBox(p, g) for p, g in zip(leaf.params, leaf.geoms)]
        per_layer = self.per_layer(leaf, boxes)
        if per_layer:
            e1, e0 = (d1 - 1, d0 - 1) if leaf.stacked else (d1, d0)
            row = torch.zeros(st0["v_row"].shape, dtype=dtype,
                              device=grads[0].device)
            col = torch.zeros(st0["v_col"].shape, dtype=dtype,
                              device=grads[0].device)
            xs = []
            for i, (b, g) in enumerate(zip(boxes, grads)):
                x = b.to_box(g)
                sq = x.square() + self.eps
                for acc, e in ((row, e0), (col, e1)):
                    part = sq.sum(e) / b.jshape[e]
                    b.cut(acc[i] if leaf.stacked else acc, e).add_(part)
                del sq
                xs.append(x)
            _leaf_reduce(row, p0)
            _leaf_reduce(col, p0)
        else:
            sq = [g.square() + self.eps for g in grads]
            full_sq = self._full(leaf, sq, dtype)
            row = _leaf_reduce(full_sq.mean(d0), p0)
            col = _leaf_reduce(full_sq.mean(d1), p0)
            del full_sq, sq
        v_row = (decay * st0["v_row"].to(dtype)
                 + (1.0 - decay) * row).to(p0.dtype)
        v_col = (decay * st0["v_col"].to(dtype)
                 + (1.0 - decay) * col).to(p0.dtype)
        st0["v_row"], st0["v_col"] = v_row, v_col
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        vr = v_row.to(dtype)
        row_factor = (vr / vr.mean(reduced_d1, keepdim=True)).pow(-0.5)
        col_factor = v_col.to(dtype).pow(-0.5)
        if not per_layer:
            full_g = self._full(leaf, grads, dtype)
            upd = (full_g * row_factor.unsqueeze(d0)
                   * col_factor.unsqueeze(d1))
            del full_g
            return self._local_rows(leaf, upd)
        updates = []
        for i, (b, x) in enumerate(zip(boxes, xs)):
            rf = b.cut(row_factor[i] if leaf.stacked else row_factor, e0)
            cf = b.cut(col_factor[i] if leaf.stacked else col_factor, e1)
            updates.append(b.from_box(x * rf.unsqueeze(e0)
                                      * cf.unsqueeze(e1)))
        return updates

    def _update(self):
        opts = _group_options(self)
        for leaf in self.leaves:
            live = [p for p in leaf.params if p.grad is not None]
            if not live:
                continue
            if len(live) != len(leaf.params):
                raise ValueError(f"leaf {leaf.path}: some layers have no "
                                 "gradient")
            p0 = leaf.params[0]
            st0 = self.leaf_state(leaf)
            count = int(st0.get("step", 0))
            dtype = _wide_dtype(p0)
            decay = 1.0 - float(np.float32(count + 1) ** np.float32(
                -self.decay_rate))
            grads = [_local(p.grad).to(dtype) for p in leaf.params]
            dims = self.factored(leaf)
            if dims is not None:
                updates = self._factored_update(leaf, dims, grads, st0,
                                                decay, dtype)
            else:
                updates = []
                for p, g in zip(leaf.params, grads):
                    st = self.state[p]
                    if "v" not in st:
                        st["v"] = torch.zeros_like(p)
                    v_loc = _local(st["v"])
                    new_v = (decay * v_loc.to(dtype)
                             + (1.0 - decay) * (g.square() + self.eps))
                    v_loc.copy_(new_v.to(v_loc.dtype))
                    updates.append(g * v_loc.to(dtype).pow(-0.5))
            # clip_by_block_rms, over the whole leaf
            rms = (_leaf_sumsq(updates, p0, dtype) / leaf.numel).sqrt()
            denom = torch.clamp(rms / self.clipping_threshold, min=1.0)
            group = opts[id(p0)]
            lr = float(group["lr"])
            # scale_by_param_block_rms: max(rms(p), min_scale)
            locs = [_local(p) for p in leaf.params]
            p_rms = (_leaf_sumsq(locs, p0, dtype) / leaf.numel).sqrt()
            p_scale = torch.where(p_rms <= self.min_scale,
                                  torch.full_like(p_rms, self.min_scale),
                                  p_rms)
            wd = float(group["weight_decay"]) if leaf.decay else 0.0
            for p, loc, u in zip(leaf.params, locs, updates):
                u = u / denom * lr * p_scale
                if wd:
                    u = u + wd * loc.to(dtype)
                loc.copy_((loc.to(dtype) + (-u)).to(loc.dtype))
                self.state[p]["step"] = torch.tensor(float(count + 1))



class RMSprop(_Scheduled, torch.optim.RMSprop):
    """``torch.optim.RMSprop`` (eps outside the sqrt, ``v`` from zero, L2
    folded into the gradient), as the JAX ``optim.RMSprop`` builds it on
    ``optax.rmsprop(..., eps_in_sqrt=False, initial_scale=0)``."""

    def __init__(self, params, lr: LrOrSchedule = 1e-2, alpha: float = 0.99,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 momentum: float = 0.0, centered: bool = False,
                 no_decay: Optional[Sequence[str]] = None):
        super().__init__(_param_groups(params, weight_decay, no_decay),
                         lr=self._init_schedule(lr), alpha=alpha, eps=eps,
                         weight_decay=weight_decay, momentum=momentum,
                         centered=centered)


class Adagrad(_Scheduled, torch.optim.Adagrad):
    """``torch.optim.Adagrad``: ``lr / (1 + t * lr_decay)``, eps outside
    the sqrt, L2 folded into the gradient (the JAX ``optim.Adagrad``'s
    hand-rolled update)."""

    def __init__(self, params, lr: LrOrSchedule = 1e-2, lr_decay: float = 0.0,
                 weight_decay: float = 0.0,
                 initial_accumulator_value: float = 0.0, eps: float = 1e-10,
                 no_decay: Optional[Sequence[str]] = None):
        if lr_decay and callable(lr):
            raise ValueError("lr_decay requires a scalar lr")
        super().__init__(_param_groups(params, weight_decay, no_decay),
                         lr=self._init_schedule(lr), lr_decay=lr_decay,
                         weight_decay=weight_decay, eps=eps,
                         initial_accumulator_value=initial_accumulator_value)


class Adadelta(_Scheduled, torch.optim.Adadelta):
    """``torch.optim.Adadelta``, whose recurrences are ``optax.adadelta``'s
    (the JAX ``optim.Adadelta``); L2 folded into the gradient."""

    def __init__(self, params, lr: LrOrSchedule = 1.0, rho: float = 0.9,
                 eps: float = 1e-6, weight_decay: float = 0.0,
                 no_decay: Optional[Sequence[str]] = None):
        super().__init__(_param_groups(params, weight_decay, no_decay),
                         lr=self._init_schedule(lr), rho=rho, eps=eps,
                         weight_decay=weight_decay)


class RAdam(_Scheduled, torch.optim.RAdam):
    """``torch.optim.RAdam`` (the rectification threshold 5, as
    ``optax.radam``, the JAX ``optim.RAdam``); L2 folded in."""

    def __init__(self, params, lr: LrOrSchedule = 1e-3,
                 betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 no_decay: Optional[Sequence[str]] = None):
        super().__init__(_param_groups(params, weight_decay, no_decay),
                         lr=self._init_schedule(lr), betas=tuple(betas),
                         eps=eps, weight_decay=weight_decay)


class NAdam(_Scheduled, torch.optim.NAdam):
    """``torch.optim.NAdam``, the ``momentum_decay`` schedule of the
    Nesterov momentum included (the JAX ``optim.NAdam``'s hand-rolled
    update); L2 folded in."""

    def __init__(self, params, lr: LrOrSchedule = 2e-3,
                 betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, momentum_decay: float = 4e-3,
                 no_decay: Optional[Sequence[str]] = None):
        super().__init__(_param_groups(params, weight_decay, no_decay),
                         lr=self._init_schedule(lr), betas=tuple(betas),
                         eps=eps, weight_decay=weight_decay,
                         momentum_decay=momentum_decay)


def _skip_flags(params, no_decay) -> Dict[int, bool]:
    """``{id(param): True}`` for the parameters ``no_decay`` exempts."""
    if no_decay is None:
        return {}
    if not isinstance(params, torch.nn.Module):
        raise ValueError("no_decay needs the module, to read parameter names")
    mask = no_decay_mask(no_decay)(params)
    return {id(p): not mask[n] for n, p in params.named_parameters()}


class LARS(_Scheduled, _Stepper):
    """LARS as the JAX ``optim.LARS`` computes it, per JAX leaf:

        local_lr = trust * ||w|| / (||g|| + wd * ||w|| + eps)
        v        = momentum * v + lr * local_lr * (g + wd * w)
        w       -= v

    (``local_lr`` 1 where ``||w||`` or the denominator is 0). The norms
    are over the whole JAX leaf (every layer of a stacked one; under FSDP
    every shard, summed over the shard group). ``no_decay`` exempts the
    matching parameters from both the decay and the trust ratio. State:
    ``v`` shaped like each parameter (optax's ``v``), ``step`` the
    count."""

    def __init__(self, params, lr: LrOrSchedule, momentum: float = 0.9,
                 weight_decay: float = 0.0, trust_coefficient: float = 0.001,
                 eps: float = 0.0, no_decay: Optional[Sequence[str]] = None):
        skip = _skip_flags(params, no_decay)
        groups = _param_groups(params, weight_decay, None)
        super().__init__(groups, dict(lr=self._init_schedule(lr),
                                      weight_decay=weight_decay))
        self.momentum, self.weight_decay = float(momentum), float(weight_decay)
        self.trust, self.eps = float(trust_coefficient), float(eps)
        self.leaves = _leaves(params, skip, layouts=False)
        for leaf in self.leaves:
            leaf.decay = not skip.get(id(leaf.params[0]), False)

    def _update(self):
        opts = _group_options(self)
        for leaf in self.leaves:
            if any(p.grad is None for p in leaf.params):
                continue
            p0 = leaf.params[0]
            lr = float(opts[id(p0)]["lr"])
            grads = [_local(p.grad).float() for p in leaf.params]
            ws = [_local(p).float() for p in leaf.params]
            wd = self.weight_decay
            if leaf.decay:
                wn = _leaf_sumsq(ws, p0, torch.float32).sqrt()
                gn = _leaf_sumsq(grads, p0, torch.float32).sqrt()
                denom = gn + wd * wn + self.eps
                local = torch.where((wn > 0) & (denom > 0),
                                    self.trust * wn / denom,
                                    torch.ones_like(wn))
            for p, g, w in zip(leaf.params, grads, ws):
                st = self.state[p]
                if "v" not in st:
                    st["v"] = torch.zeros_like(p, dtype=torch.float32)
                v = _local(st["v"])
                adj = g + wd * w if leaf.decay else g
                scale = lr * local if leaf.decay else lr
                v.copy_(self.momentum * v + scale * adj)
                _local(p).copy_((_local(p) + (-v).to(p.dtype)).to(p.dtype))
                st["step"] = torch.tensor(float(st.get("step", 0)) + 1.0)


class LAMB(_Scheduled, _Stepper):
    """``optax.lamb`` (the JAX ``optim.LAMB``): Adam moments, then
    ``r = m_hat / (sqrt(v_hat) + eps) + wd * w`` (masked), scaled by the
    trust ratio ``||w|| / ||r||`` of the whole JAX leaf (1 where either
    norm is 0) and by ``-lr``. State: ``exp_avg``/``exp_avg_sq`` (optax's
    ``mu``/``nu``) shaped like each parameter, ``step`` the count."""

    def __init__(self, params, lr: LrOrSchedule = 1e-3,
                 betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0,
                 no_decay: Optional[Sequence[str]] = None):
        groups = _param_groups(params, weight_decay, no_decay)
        super().__init__(groups, dict(lr=self._init_schedule(lr),
                                      weight_decay=weight_decay))
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = float(eps)
        self.leaves = _leaves(params, _decay_flags(groups), layouts=False)

    def _update(self):
        opts = _group_options(self)
        for leaf in self.leaves:
            if any(p.grad is None for p in leaf.params):
                continue
            p0 = leaf.params[0]
            group = opts[id(p0)]
            lr, wd = float(group["lr"]), float(group["weight_decay"])
            dtype = _wide_dtype(p0)
            rs, ws = [], []
            for p in leaf.params:
                st = self.state[p]
                if "exp_avg" not in st:
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                t = float(st.get("step", 0)) + 1.0
                st["step"] = torch.tensor(t)
                g = _local(p.grad).to(dtype)
                m, v = _local(st["exp_avg"]), _local(st["exp_avg_sq"])
                m.copy_(self.b1 * m + (1 - self.b1) * g)
                v.copy_(self.b2 * v + (1 - self.b2) * g.square())
                m_hat = m.to(dtype) / (1 - self.b1 ** t)
                v_hat = v.to(dtype) / (1 - self.b2 ** t)
                r = m_hat / (v_hat.sqrt() + self.eps)
                w = _local(p).to(dtype)
                if wd:
                    r = r + wd * w
                rs.append(r)
                ws.append(w)
            wn = _leaf_sumsq(ws, p0, dtype).sqrt()
            rn = _leaf_sumsq(rs, p0, dtype).sqrt()
            trust = torch.where((wn == 0) | (rn == 0), torch.ones_like(wn),
                                wn / rn)
            for p, r, w in zip(leaf.params, rs, ws):
                _local(p).copy_((w + (-lr) * (r * trust)).to(p.dtype))


class ReduceLROnPlateau:
    """``optax.contrib.reduce_on_plateau`` around a port optimizer (the
    JAX ``optim.ReduceLROnPlateau``): ``step(value=metric)`` folds the
    metric into a running mean; every ``accumulation_size`` values the
    mean is compared with the best (``mode="min"``: better below ``(1 -
    threshold) * best``; ``"max"``: above by ``threshold``, absolute), and
    after ``patience`` windows without improvement the scale of every
    update drops by ``factor`` (not below ``min_scale``), then
    ``cooldown`` windows pass unjudged. The scale multiplies the
    optimizer's lr for the step (its update is linear in lr). The state
    is kept in f32, as optax keeps it."""

    def __init__(self, optimizer, *, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 cooldown: int = 0, min_scale: float = 0.0,
                 accumulation_size: int = 1):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min'/'max', got {mode!r}")
        self.optimizer = optimizer
        self.sign = -1.0 if mode == "max" else 1.0
        self.rtol = threshold if mode == "min" else 0.0
        self.atol = 0.0 if mode == "min" else threshold
        self.factor, self.patience = factor, int(patience)
        self.cooldown, self.min_scale = int(cooldown), min_scale
        self.accumulation_size = int(accumulation_size)
        f32 = np.float32
        self.scale, self.best_value = f32(1.0), f32(np.inf)
        self.plateau_count = self.cooldown_count = self.count = 0
        self.avg_value = f32(0.0)

    def _inner(self):
        inner = self.optimizer
        while not isinstance(inner, _Scheduled):
            inner = inner.optimizer
        return inner

    def observe(self, value: float) -> float:
        """Fold one metric value in; returns the scale for this step."""
        f32 = np.float32
        new_count = self.count + 1
        self.avg_value = f32((f32(self.count) * self.avg_value
                              + f32(self.sign * float(value)))
                             / f32(new_count))
        self.count = new_count
        if new_count == self.accumulation_size:
            avg = self.avg_value
            improved = avg < f32(1 - self.rtol) * self.best_value - f32(
                self.atol)
            if improved:
                self.best_value = avg
            plateau = 0 if improved else self.plateau_count + 1
            if self.cooldown_count > 0:
                self.plateau_count = 0
                self.cooldown_count -= 1
            else:
                hit = plateau == self.patience
                self.plateau_count = 0 if hit else plateau
                self.scale = f32(max(self.scale * f32(self.factor)
                                     if hit else self.scale,
                                     f32(self.min_scale)))
                self.cooldown_count = self.cooldown if hit else 0
            self.count, self.avg_value = 0, f32(0.0)
        return float(self.scale)

    def step(self, closure=None, *, value):
        self._inner().lr_scale = self.observe(float(value))
        return self.optimizer.step(closure)

    def __getattr__(self, name):
        return getattr(self.optimizer, name)


class _ValueClippedOptimizer(_ClippedOptimizer):
    """An optimizer whose ``step`` first clamps every gradient element to
    ``[-clip_value, clip_value]`` (``optax.clip``)."""

    def __init__(self, optimizer, clip_value: float):
        super().__init__(optimizer, clip_value)

    def clip_(self):
        for g in self.optimizer.param_groups:
            for p in g["params"]:
                if p.grad is not None:
                    _local(p.grad).clamp_(-self.max_norm, self.max_norm)


def clip_grad_value(optimizer: torch.optim.Optimizer,
                    clip_value: float) -> _ClippedOptimizer:
    """``optax.chain(optax.clip(clip_value), tx)``: ``torch.nn.utils.
    clip_grad_value_`` before every step."""
    return _ValueClippedOptimizer(optimizer, clip_value)


# -- schedules: plain functions of the update count, passed as the lr -----


def StepLR(lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    """Decay by ``gamma`` every ``step_size`` updates."""
    return lambda count: lr * gamma ** (count // step_size)


def MultiStepLR(lr: float, milestones: Sequence[int],
                gamma: float = 0.1) -> Schedule:
    """``lr`` times ``gamma`` for each (distinct) milestone reached
    (``optax.piecewise_constant_schedule``)."""
    marks = sorted({int(m) for m in milestones})
    return lambda count: lr * gamma ** sum(count >= m for m in marks)


def _cosine(lr: float, steps: int, alpha: float) -> Schedule:
    """``optax.cosine_decay_schedule(lr, steps, alpha)``."""
    def schedule(count):
        c = min(count, steps)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / steps))
                     + alpha)
    return schedule


def CosineAnnealingLR(lr: float, T_max: int, eta_min: float = 0.0) -> Schedule:
    return _cosine(lr, max(T_max, 1), eta_min / lr if lr else 0.0)


def CosineAnnealingWarmRestarts(lr: float, T_0: int, T_mult: int = 1,
                                eta_min: float = 0.0) -> Schedule:
    """torch's SGDR: a cosine over ``T_0`` updates, then restarts at
    ``lr`` with the period times ``T_mult``."""
    if T_0 < 1 or T_mult < 1:
        raise ValueError(f"T_0 and T_mult must be >= 1, got {T_0}, {T_mult}")

    def schedule(count):
        if T_mult == 1:
            t_cur, t_i = count % T_0, float(T_0)
        else:
            n = math.floor(math.log(count * (T_mult - 1) / T_0 + 1.0)
                           / math.log(T_mult))
            t_cur = count - T_0 * (T_mult ** n - 1.0) / (T_mult - 1.0)
            t_i = T_0 * T_mult ** n
        return eta_min + (lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * t_cur / t_i))

    return schedule


def LinearLR(lr: float, start_factor: float = 1.0 / 3,
             end_factor: float = 1.0, total_iters: int = 5) -> Schedule:
    """``optax.linear_schedule(lr * start, lr * end, total_iters)``."""
    steps = max(total_iters, 1)
    a, b = lr * start_factor, lr * end_factor

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (a - b) * frac + b

    return schedule


def ExponentialLR(lr: float, gamma: float) -> Schedule:
    """Decay by ``gamma`` every update."""
    return lambda count: lr * gamma ** count


def LambdaLR(lr: float, lr_lambda) -> Schedule:
    """``lr * lr_lambda(count)``."""
    return lambda count: lr * lr_lambda(count)


def OneCycleLR(max_lr: float, total_steps: int, pct_start: float = 0.3,
               div_factor: float = 25.0,
               final_div_factor: float = 1e4) -> Schedule:
    """torch's one-cycle policy: a linear ramp from ``max_lr /
    div_factor`` to ``max_lr`` over ``pct_start`` of the run, then a
    cosine down to ``max_lr / div_factor / final_div_factor``."""
    warmup = max(int(total_steps * pct_start), 1)
    return WarmupCosine(max_lr, warmup, max(total_steps, warmup + 1),
                        eta_min=max_lr / div_factor / final_div_factor,
                        init_lr=max_lr / div_factor)


def ConstantLR(lr: float, factor: float = 1.0 / 3,
               total_iters: int = 5) -> Schedule:
    """``lr * factor`` for the first ``total_iters`` updates, then ``lr``."""
    return lambda count: lr * factor if count < total_iters else lr


def MultiplicativeLR(lr: float, lr_lambda) -> Schedule:
    """``lr_t = lr_{t-1} * lr_lambda(t)`` for ``t >= 1``: ``lr`` times the
    product of the factors up to ``count``."""
    def schedule(count):
        out = 1.0
        for i in range(1, int(count) + 1):
            out *= lr_lambda(i)
        return lr * out
    return schedule


def PolynomialLR(lr: float, total_iters: int = 5,
                 power: float = 1.0) -> Schedule:
    """``lr * (1 - min(t, total) / total) ** power``."""
    return lambda count: lr * (1.0 - min(count, total_iters)
                               / total_iters) ** power


def CyclicLR(base_lr: float, max_lr: float, step_size_up: int = 2000,
             step_size_down: Optional[int] = None, mode: str = "triangular",
             gamma: float = 1.0) -> Schedule:
    """``lr_scheduler.CyclicLR``: triangular between ``base_lr`` and
    ``max_lr``; ``triangular2`` halves the height every cycle,
    ``exp_range`` scales it by ``gamma ** count``."""
    if mode not in ("triangular", "triangular2", "exp_range"):
        raise ValueError(f"unknown CyclicLR mode {mode!r}")
    up = float(step_size_up)
    down = float(step_size_down if step_size_down is not None
                 else step_size_up)
    total = up + down
    ratio = up / total

    def schedule(count):
        cycle = math.floor(1.0 + count / total)
        x = 1.0 + count / total - cycle
        scale = x / ratio if x <= ratio else (x - 1.0) / (ratio - 1.0)
        height = (max_lr - base_lr) * scale
        if mode == "triangular2":
            height = height / (2.0 ** (cycle - 1.0))
        elif mode == "exp_range":
            height = height * gamma ** count
        return base_lr + height

    return schedule


def SequentialLR(schedules: Sequence[Schedule],
                 milestones: Sequence[int]) -> Schedule:
    """Switch schedules at the milestones, each counting from its own
    start (``optax.join_schedules``)."""
    if len(milestones) != len(schedules) - 1:
        raise ValueError(
            f"need len(schedules)-1 milestones, got {len(milestones)} for "
            f"{len(schedules)} schedules")
    schedules, marks = list(schedules), list(milestones)

    def schedule(count):
        out = schedules[0](count)
        for mark, s in zip(marks, schedules[1:]):
            if count >= mark:
                out = s(count - mark)
        return out

    return schedule


def ChainedScheduler(schedules: Sequence[Schedule]) -> Schedule:
    """The product of the schedules (the first with the real lr, the rest
    built with ``lr=1.0`` as pure factors)."""
    schedules = list(schedules)
    if not schedules:
        raise ValueError("ChainedScheduler needs at least one schedule")

    def schedule(count):
        out = schedules[0](count)
        for s in schedules[1:]:
            out = out * s(count)
        return out

    return schedule
