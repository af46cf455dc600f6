"""The train state: the port of ``pytorch_distributed_tpu/train/train_state.py``.

The JAX package keeps everything a step changes in one immutable pytree.
PyTorch keeps parameters in the module and moments in the optimizer, both
updated in place, so the port's state is the handle on those two plus
the step counter (which seeds the step's random streams), the dtype
policy the model was built with, the fp16 loss-scale state
(``runtime.precision.ScalerState``: None unless fp16 dynamic scaling),
and the EMA shadow parameters.

``TrainState(model, optimizer, ema=True)`` (the JAX
``TrainState.create(..., ema=True)``) seeds ``ema_params``: an f32 copy
of every trainable parameter, by the unwrapped model's parameter name,
which ``build_train_step(ema_decay=d)`` moves as ``d * ema + (1 - d) *
p`` after every update. It is held in f32 so that a small ``(1 - d) *
p`` step is not lost below a half-precision ulp. The shadow covers the
parameters only: BatchNorm's running statistics are the model's own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from pytorch_distributed_tpu_torch.runtime.precision import (
    Policy,
    ScalerState,
)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    policy: Policy = Policy.train()
    scaler_state: Optional[ScalerState] = None
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ema: dataclasses.InitVar[bool] = False

    def __post_init__(self, ema: bool) -> None:
        if ema and self.ema_params is None:
            self.ema_params = shadow_params(self.model)


def trainable_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``{name: parameter}`` of the unwrapped model's trainable
    parameters (a DDP wrapper's ``module``)."""
    model = getattr(model, "module", model)
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def shadow_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """An f32 copy of every trainable parameter of ``model``."""
    return {n: p.detach().to(torch.float32, copy=True)
            for n, p in trainable_params(model).items()}
