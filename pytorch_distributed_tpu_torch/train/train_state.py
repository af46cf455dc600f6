"""The train state: the port of ``pytorch_distributed_tpu/train/train_state.py``.

The JAX package keeps everything a step changes in one immutable pytree.
PyTorch keeps parameters in the module and moments in the optimizer, both
updated in place, so the port's state is the handle on those two plus
the step counter (which seeds the step's random streams), the dtype
policy the model was built with, and the fp16 loss-scale state
(``runtime.precision.ScalerState``: None unless fp16 dynamic scaling).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
