"""The training slices: state, the causal-LM and classifier losses, the
step builder and the fit loop."""

from pytorch_distributed_tpu_torch.train.losses import (
    accuracy,
    causal_lm_loss_fn,
    classification_eval_step,
    classification_loss_fn,
    cross_entropy,
    topk_accuracy,
)
from pytorch_distributed_tpu_torch.train.train_state import TrainState
from pytorch_distributed_tpu_torch.train.trainer import (
    Trainer,
    TrainerConfig,
    TrainingDiverged,
    build_train_step,
)

__all__ = [
    "accuracy", "causal_lm_loss_fn", "classification_eval_step",
    "classification_loss_fn", "cross_entropy", "topk_accuracy", "TrainState", "Trainer", "TrainerConfig",
    "TrainingDiverged", "build_train_step",
]
