"""The train step and the fit loop: the port of ``build_train_step`` and
the core of ``Trainer.fit`` in ``pytorch_distributed_tpu/train/trainer.py``.

``build_train_step(loss_fn, accum_steps=A)`` returns
``step(state, batch) -> (state, metrics)``: the batch splits into A
contiguous microbatches, each runs forward and backward with its own
dropout generator (``generator_for(step, DROPOUT_TAG + i)``, the
counterpart of ``fold_in(key_for(step), i)``), the gradients are summed
and multiplied by 1/A, the metrics averaged, and the optimizer steps
once. The step emits the tracing spans ``train.step`` (all of it),
``train.fwd_bwd`` (the microbatch loop) and ``train.optim`` (the
update). Its metrics stay on the device: nothing in the step waits for
the card.

``Trainer.fit`` runs epochs of the loader, ``max_steps_per_epoch`` steps
at most, logs (and so synchronizes) every ``log_every`` steps, and raises
:class:`TrainingDiverged` after ``halt_on_nonfinite`` consecutive
non-finite logged losses. Checkpoints, evaluation, goodput accounting
and the watchdog wait for ROADMAP A5.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

import torch

from pytorch_distributed_tpu_torch.runtime import tracing
from pytorch_distributed_tpu_torch.runtime.prng import generator_for
from pytorch_distributed_tpu_torch.train.train_state import TrainState
from pytorch_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

#: the dropout stream's tag ("drop"); microbatch i draws from tag + i
DROPOUT_TAG = 0x64726F70


def _split_microbatches(batch: Dict[str, torch.Tensor], accum_steps: int):
    """Row blocks of every leaf: microbatch i holds rows
    ``[i * B/A, (i + 1) * B/A)`` (the JAX reshape to ``[A, B/A, ...]``)."""
    out = [{} for _ in range(accum_steps)]
    for key, x in batch.items():
        if x.shape[0] % accum_steps != 0:
            raise ValueError(
                f"batch dim {x.shape[0]} not divisible by "
                f"accum_steps={accum_steps}"
            )
        for i, part in enumerate(x.chunk(accum_steps, dim=0)):
            out[i][key] = part
    return out


def build_train_step(
    loss_fn: Callable,
    *,
    accum_steps: int = 1,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], tuple]:
    """``step(state, batch) -> (state, metrics)``; see the module
    docstring. The batch must already be on the model's device."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def step(state: TrainState, batch):
        model, opt = state.model, state.optimizer
        device = next(model.parameters()).device
        with tracing.span("train.step"):
            opt.zero_grad(set_to_none=True)
            sums: Dict[str, torch.Tensor] = {}
            with tracing.span("train.fwd_bwd"):
                for i, mb in enumerate(_split_microbatches(batch, accum_steps)):
                    gen = generator_for(state.step, DROPOUT_TAG + i, device)
                    loss, aux = loss_fn(mb, gen)
                    loss.backward()
                    for k, v in aux.get("metrics", {}).items():
                        sums[k] = v if k not in sums else sums[k] + v
            if accum_steps > 1:
                inv = 1.0 / accum_steps
                grads = [p.grad for p in model.parameters()
                         if p.grad is not None]
                torch._foreach_mul_(grads, inv)
                sums = {k: v * inv for k, v in sums.items()}
            with tracing.span("train.optim"):
                opt.step()
            state.step += 1
        return state, sums

    return step


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 1
    log_every: int = 50
    max_steps_per_epoch: Optional[int] = None
    halt_on_nonfinite: int = 3  # consecutive non-finite logged losses
    # before raising TrainingDiverged (0 disables)


class TrainingDiverged(RuntimeError):
    """The logged training loss stayed non-finite: restart from the last
    finite checkpoint with a lower LR or another seed."""


class Trainer:
    """Epoch loop: feed, step, log. ``history`` keeps every logged
    record (step, epoch, metrics, step time)."""

    def __init__(self, state: TrainState, train_step: Callable, train_loader,
                 *, config: TrainerConfig = TrainerConfig()):
        self.state = state
        self.train_step = train_step
        self.train_loader = train_loader
        self.config = config
        self.host_step = 0
        self.history: List[dict] = []
        self._nonfinite_logs = 0

    def fit(self) -> TrainState:
        for epoch in range(self.config.epochs):
            self.train_loader.set_epoch(epoch)
            self._train_epoch(epoch)
        return self.state

    def _train_epoch(self, epoch: int) -> None:
        cfg = self.config
        device = next(self.state.model.parameters()).device
        t_last = time.perf_counter()
        since_log = 0
        for taken, batch in enumerate(self.train_loader):
            if cfg.max_steps_per_epoch and taken >= cfg.max_steps_per_epoch:
                break
            with tracing.span("train.data_wait"):
                batch = {k: v.to(device, non_blocking=True)
                         for k, v in batch.items()}
            self.state, metrics = self.train_step(self.state, batch)
            self.host_step += 1
            since_log += 1
            if cfg.log_every and self.host_step % cfg.log_every == 0:
                # the sync point: pull the metrics off the card
                values = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                dt = (now - t_last) / since_log
                t_last, since_log = now, 0
                self._check_finite(values, self.host_step)
                self.history.append(dict(
                    step=self.host_step, epoch=epoch, step_time_s=dt,
                    **values,
                ))
                logger.info(
                    "epoch %d step %d %s (%.1f ms/step)", epoch,
                    self.host_step,
                    " ".join(f"{k}={v:.4f}" for k, v in values.items()),
                    dt * 1e3,
                )

    def _check_finite(self, metrics: Dict[str, float], step: int) -> None:
        n = self.config.halt_on_nonfinite
        if not n or "loss" not in metrics:
            return
        if math.isfinite(metrics["loss"]):
            self._nonfinite_logs = 0
            return
        self._nonfinite_logs += 1
        logger.warning(
            "non-finite loss %s at step %d (%d/%d consecutive logs)",
            metrics["loss"], step, self._nonfinite_logs, n,
        )
        if self._nonfinite_logs >= n:
            raise TrainingDiverged(
                f"loss has been non-finite for {self._nonfinite_logs} "
                f"consecutive logging windows (last step {step}) — restart "
                "from the last finite checkpoint with a lower LR (set "
                "TrainerConfig(halt_on_nonfinite=0) to disable)"
            )
