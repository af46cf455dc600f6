"""The training slices: state, the causal-LM, classifier, text-classifier
and masked-LM losses, the step builder (with fp16 loss scaling), the fit
loop, checkpoints and preemption."""

from pytorch_distributed_tpu_torch.train.checkpoint import (
    CheckpointCorrupted,
    load_sampler_cursor,
    restore_checkpoint,
    save_checkpoint,
    save_sampler_cursor,
    verify_checkpoint,
)
from pytorch_distributed_tpu_torch.train.elastic import (
    EX_TEMPFAIL,
    Preempted,
    PreemptionHandler,
    fit_elastic,
)
from pytorch_distributed_tpu_torch.train.losses import (
    accuracy,
    causal_lm_eval_step,
    causal_lm_loss_fn,
    classification_eval_step,
    classification_loss_fn,
    cross_entropy,
    masked_lm_loss_fn,
    text_classification_loss_fn,
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
    "CheckpointCorrupted", "load_sampler_cursor", "restore_checkpoint",
    "save_checkpoint", "save_sampler_cursor", "verify_checkpoint",
    "EX_TEMPFAIL", "Preempted", "PreemptionHandler", "fit_elastic",
    "accuracy", "causal_lm_eval_step", "causal_lm_loss_fn",
    "classification_eval_step", "classification_loss_fn", "cross_entropy",
    "masked_lm_loss_fn", "text_classification_loss_fn", "topk_accuracy",
    "TrainState", "Trainer", "TrainerConfig", "TrainingDiverged",
    "build_train_step",
]
