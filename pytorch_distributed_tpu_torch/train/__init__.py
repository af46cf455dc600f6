"""The single-device training slice: state, the causal-LM loss, the step
builder and the fit loop."""

from pytorch_distributed_tpu_torch.train.losses import causal_lm_loss_fn
from pytorch_distributed_tpu_torch.train.train_state import TrainState
from pytorch_distributed_tpu_torch.train.trainer import (
    Trainer,
    TrainerConfig,
    TrainingDiverged,
    build_train_step,
)

__all__ = [
    "causal_lm_loss_fn", "TrainState", "Trainer", "TrainerConfig",
    "TrainingDiverged", "build_train_step",
]
