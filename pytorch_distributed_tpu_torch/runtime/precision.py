"""Dtype policy and loss scaling: the port of
``pytorch_distributed_tpu/runtime/precision.py``.

The JAX package's default :class:`Policy` keeps f32 parameters and casts
them to bf16 for every matmul, with f32 logits. The port's default is
the serving one instead: serving only ever computes in bf16, so it
stores the weights in bf16 to begin with (half the memory of f32 master
weights, the same products) and keeps the KV page pool in bf16 too.
Training needs the f32 master weights, since an optimizer step on bf16
weights loses every update below half a bf16 ulp: ``Policy.train()`` is
the JAX default (f32 parameters and optimizer state, bf16 products, f32
output), ``Policy.fp16()`` the same with fp16 products. ``Policy.full()``
is f32 everywhere, for the CPU tests that hold the port against the JAX
reference.

The models take their policy as an argument; one built without it takes
:func:`current_policy`, which :func:`use_policy` and :func:`autocast`
(the JAX pair) set for the block they open. Neither intercepts an op, as
``torch.autocast`` would: each model casts every weight to
``compute_dtype`` where it uses it, so its products round where the JAX
model's do.

bf16 keeps f32's exponent range, so it needs no loss scaling; fp16 does.
:class:`GradScaler` is dynamic loss scaling with the JAX update rule,
enabled only for fp16 (in bf16 it is an exact no-op: ``init_state()``
returns None). Its state (:class:`ScalerState`) is two device tensors,
an f32 scale and an int32 growth tracker, updated by the functional
triple ``scale_value`` / ``unscale_grads`` / ``functional_update`` that
``train.build_train_step(scaler=...)`` runs in the step. The eager
torch-shaped methods (``scale``, ``unscale_``, ``step``, ``update``,
``get_scale``) are exact only in bf16 mode and refuse in fp16 mode, as
the JAX ones do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtypes a model is built and run with."""

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    @classmethod
    def train(cls) -> "Policy":
        """f32 parameters, bf16 compute, f32 output: the JAX default."""
        return cls(torch.float32, torch.bfloat16, torch.float32)

    @classmethod
    def fp16(cls) -> "Policy":
        """f32 parameters, fp16 compute, f32 output: the JAX package's
        ``autocast(dtype=float16)``, trained with a :class:`GradScaler`."""
        return cls(torch.float32, torch.float16, torch.float32)

    @classmethod
    def full(cls) -> "Policy":
        """f32 parameters, compute and outputs."""
        return cls(torch.float32, torch.float32, torch.float32)


_STATE = threading.local()


def current_policy() -> Policy:
    """The policy :func:`use_policy` installed on this thread, else the
    JAX default (``Policy.train()``)."""
    return getattr(_STATE, "policy", None) or Policy.train()


@contextlib.contextmanager
def use_policy(policy: Policy):
    """Install ``policy`` for the block: models built inside it without
    a policy of their own take it."""
    prev = getattr(_STATE, "policy", None)
    _STATE.policy = policy
    try:
        yield policy
    finally:
        _STATE.policy = prev


def autocast(enabled: bool = True, dtype: torch.dtype = torch.bfloat16):
    """The AMP-shaped form of :func:`use_policy`: f32 parameters and
    outputs with ``dtype`` products, or f32 everywhere when not
    ``enabled``."""
    if not enabled:
        return use_policy(Policy.full())
    return use_policy(Policy(torch.float32, dtype, torch.float32))


@dataclasses.dataclass
class ScalerState:
    """Dynamic loss-scale state (fp16 only): ``scale`` an f32 scalar and
    ``growth_tracker`` an int32 scalar, both on the model's device."""

    scale: torch.Tensor
    growth_tracker: torch.Tensor


class GradScaler:
    """``torch.cuda.amp.GradScaler``'s surface over the JAX package's
    functional dynamic scaling.

    bf16 (the default ``dtype``): the identity, and ``functional_update``
    never skips. fp16: the loss is multiplied by the scale before the
    backward, the gradients by its inverse after the gradient sync, then
    ``functional_update`` reads whether every gradient is finite (one
    reduction over all of them) and moves the scale: a non-finite step
    multiplies it by ``backoff_factor`` and resets the tracker (the
    caller skips the optimizer step); a finite one counts, and at
    ``growth_interval`` counted steps the scale grows by
    ``growth_factor`` and the tracker resets.
    """

    def __init__(
        self,
        init_scale: float = 2.0 ** 15,
        growth_factor: float = 2.0,
        backoff_factor: float = 0.5,
        growth_interval: int = 2000,
        enabled: bool = True,
        dtype: torch.dtype = torch.bfloat16,
    ):
        self.enabled = enabled and dtype == torch.float16
        self.init_scale = init_scale
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval

    def init_state(self, device=None) -> Optional[ScalerState]:
        """The starting state on ``device`` (the CPU unless given), or
        None when scaling is off."""
        if not self.enabled:
            return None
        return ScalerState(
            scale=torch.tensor(self.init_scale, dtype=torch.float32,
                               device=device),
            growth_tracker=torch.tensor(0, dtype=torch.int32, device=device),
        )

    # -- functional API (the train step's) ----------------------------------
    def scale_value(self, loss: torch.Tensor,
                    state: Optional[ScalerState]) -> torch.Tensor:
        if not self.enabled or state is None:
            return loss
        return loss * state.scale

    def unscale_grads(self, grads: List[torch.Tensor],
                      state: Optional[ScalerState]) -> List[torch.Tensor]:
        """Multiply ``grads`` by ``1 / scale`` in place (an exact scaling
        while the scale is a power of two) and return them."""
        from pytorch_distributed_tpu_torch.optim import _local

        if not self.enabled or state is None or not grads:
            return grads
        torch._foreach_mul_([_local(g) for g in grads],
                            torch.reciprocal(state.scale))
        return grads

    def functional_update(
        self, grads: List[torch.Tensor], state: Optional[ScalerState]
    ) -> Tuple[Optional[ScalerState], torch.Tensor]:
        """``(new_state, grads_finite)``: a bool tensor on the device that
        says whether the optimizer may step. The check is the largest
        magnitude of each gradient (NaN propagates), one reduction over
        all of them; nothing here waits for the device."""
        from torch.distributed.tensor import DTensor

        from pytorch_distributed_tpu_torch.optim import _local

        if not self.enabled or state is None:
            return state, torch.tensor(True)
        if grads:
            peaks = torch._foreach_norm([_local(g) for g in grads],
                                        float("inf"))
            finite = torch.isfinite(torch.stack(
                [p.to(torch.float32) for p in peaks])).all()
        else:
            finite = torch.ones((), dtype=torch.bool,
                                device=state.scale.device)
        if any(isinstance(g, DTensor) for g in grads):
            # each rank holds its own shards (FSDP): every rank must take
            # the same decision
            flag = finite.to(torch.float32)
            torch.distributed.all_reduce(flag, torch.distributed.ReduceOp.MIN)
            finite = flag > 0
        zero = torch.zeros_like(state.growth_tracker)
        tracker = torch.where(finite, state.growth_tracker + 1, zero)
        grow = tracker >= self.growth_interval
        scale = torch.where(
            finite,
            torch.where(grow, state.scale * self.growth_factor, state.scale),
            state.scale * self.backoff_factor,
        )
        tracker = torch.where(grow, zero, tracker)
        return ScalerState(scale=scale, growth_tracker=tracker), finite

    # -- torch-shaped eager conveniences (exact in bf16 mode only) ----------
    def _eager_ok(self):
        if self.enabled:
            raise RuntimeError(
                "fp16 GradScaler state is functional: use scale_value/"
                "unscale_grads/functional_update inside the train step "
                "(the eager torch-shaped methods are only exact in bf16 mode)"
            )

    def scale(self, loss):
        self._eager_ok()
        return loss

    def unscale_(self, grads):
        self._eager_ok()
        return grads

    def step(self, apply_fn, *args, **kwargs):
        self._eager_ok()
        return apply_fn(*args, **kwargs)

    def update(self):
        self._eager_ok()
        return None

    def get_scale(self) -> float:
        self._eager_ok()
        return 1.0
