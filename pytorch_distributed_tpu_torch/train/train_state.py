"""The train state: the port of ``pytorch_distributed_tpu/train/train_state.py``.

The JAX package keeps everything a step changes in one immutable pytree.
PyTorch keeps parameters in the module and moments in the optimizer, both
updated in place, so the port's state is the handle on those two plus
the step counter (which seeds the step's random streams) and the dtype
policy the model was built with.
"""

from __future__ import annotations

import dataclasses

import torch

from pytorch_distributed_tpu_torch.runtime.precision import Policy


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    policy: Policy = Policy.train()
