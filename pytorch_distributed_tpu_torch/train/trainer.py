"""The train step and the fit loop: the port of ``build_train_step`` and
the core of ``Trainer.fit`` in ``pytorch_distributed_tpu/train/trainer.py``.

``build_train_step(loss_fn, accum_steps=A, batch_transform=T)`` returns
``step(state, batch) -> (state, metrics)``. ``T`` runs on the device
batch first (e.g. the uint8 normalizer); a transform marked
``_ptd_takes_rng`` is called as ``T(batch, generator)`` with a generator
derived from the step (``generator_for(step, AUG_TAG)``, the counterpart
of the JAX step's ``fold_in(rng, 0x617567)``), so a resumed run replays
its augmentation. Then the batch splits into A contiguous microbatches,
each runs forward and backward with its own dropout generator
(``generator_for(step, DROPOUT_TAG + i)``, the counterpart of
``fold_in(key_for(step), i)``), the gradients are summed and multiplied
by 1/A (a model in ``DistributedDataParallel`` runs every microbatch but
the last under ``no_sync()``, so its gradients cross the ranks once a
step), the metrics averaged, and the optimizer steps once. BatchNorm
running statistics, which the JAX step carries in ``state.batch_stats``,
are module buffers that each train-mode forward updates in place, one
microbatch after another as the JAX scan threads them. The step emits
the tracing spans ``train.step`` (all of it), ``train.fwd_bwd`` (the
microbatch loop) and ``train.optim`` (the update). Its metrics stay on
the device: nothing in the step waits for the card.

``Trainer.fit`` runs epochs of the loader, ``max_steps_per_epoch`` steps
at most, times each wait for the next batch (``train.data_wait``), logs
(and so synchronizes) every ``log_every`` steps, with the metrics
averaged over the ranks of a process group, raises
:class:`TrainingDiverged` after ``halt_on_nonfinite`` consecutive
non-finite logged losses, and with an ``eval_step`` and ``eval_loader``
evaluates after every epoch (``last_eval_metrics``: sample-weighted
means over the whole eval set, summed over the ranks). Checkpoints,
goodput accounting and the watchdog wait for ROADMAP A5.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.nn.parallel import DistributedDataParallel

from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime import tracing
from pytorch_distributed_tpu_torch.runtime.prng import generator_for
from pytorch_distributed_tpu_torch.train.train_state import TrainState
from pytorch_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

#: the dropout stream's tag ("drop"); microbatch i draws from tag + i
DROPOUT_TAG = 0x64726F70
#: the batch transform's augmentation stream ("aug")
AUG_TAG = 0x617567


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


def _sync_unless(model, accumulating: bool):
    """DDP's ``no_sync()`` while gradients still accumulate locally."""
    if accumulating and isinstance(model, DistributedDataParallel):
        return model.no_sync()
    return contextlib.nullcontext()


def build_train_step(
    loss_fn: Callable,
    *,
    accum_steps: int = 1,
    batch_transform: Optional[Callable] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], tuple]:
    """``step(state, batch) -> (state, metrics)``; see the module
    docstring. The batch must already be on the model's device."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    takes_rng = getattr(batch_transform, "_ptd_takes_rng", False)

    def step(state: TrainState, batch):
        model, opt = state.model, state.optimizer
        device = next(model.parameters()).device
        with tracing.span("train.step"):
            if batch_transform is not None:
                if takes_rng:
                    batch = batch_transform(
                        batch, generator_for(state.step, AUG_TAG, device))
                else:
                    batch = batch_transform(batch)
            opt.zero_grad(set_to_none=True)
            sums: Dict[str, torch.Tensor] = {}
            with tracing.span("train.fwd_bwd"):
                for i, mb in enumerate(_split_microbatches(batch, accum_steps)):
                    gen = generator_for(state.step, DROPOUT_TAG + i, device)
                    with _sync_unless(model, i < accum_steps - 1):
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
                 *, eval_step: Optional[Callable] = None, eval_loader=None,
                 config: TrainerConfig = TrainerConfig()):
        self.state = state
        self.train_step = train_step
        self.train_loader = train_loader
        self.eval_step = eval_step
        self.eval_loader = eval_loader
        self.config = config
        self.host_step = 0
        self.history: List[dict] = []
        self.last_eval_metrics: Dict[str, float] = {}
        self._nonfinite_logs = 0

    def fit(self) -> TrainState:
        for epoch in range(self.config.epochs):
            self.train_loader.set_epoch(epoch)
            self._train_epoch(epoch)
            if self.eval_step is not None:
                self.evaluate(epoch)
        return self.state

    def _train_epoch(self, epoch: int) -> None:
        cfg = self.config
        device = next(self.state.model.parameters()).device
        t_last = time.perf_counter()
        since_log = 0
        batches = iter(self.train_loader)
        for taken in itertools.count():
            if cfg.max_steps_per_epoch and taken >= cfg.max_steps_per_epoch:
                break
            with tracing.span("train.data_wait"):
                batch = next(batches, None)
                if batch is None:
                    break
                batch = {k: v.to(device, non_blocking=True)
                         for k, v in batch.items()}
            self.state, metrics = self.train_step(self.state, batch)
            self.host_step += 1
            since_log += 1
            if cfg.log_every and self.host_step % cfg.log_every == 0:
                # the sync point: pull the metrics off the card
                values = _rank_mean(metrics)
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

    def evaluate(self, epoch: int) -> Dict[str, float]:
        """One pass of ``eval_step`` over ``eval_loader``: sample-weighted
        means of its metrics, summed over the ranks' shares."""
        device = next(self.state.model.parameters()).device
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        with tracing.span("train.eval"):
            for batch in self.eval_loader:
                batch = {k: v.to(device, non_blocking=True)
                         for k, v in batch.items()}
                n = next(iter(batch.values())).shape[0]
                for k, v in self.eval_step(self.state, batch).items():
                    sums[k] = sums.get(k, 0.0) + v.double() * n
                count += n
            keys = sorted(sums)
            vec = torch.stack([sums[k] for k in keys]
                              + [torch.tensor(float(count), device=device,
                                              dtype=torch.float64)])
            vec = dist.all_reduce(vec).tolist()
        means = {k: v / max(vec[-1], 1.0) for k, v in zip(keys, vec)}
        self.last_eval_metrics = means
        logger.info("eval epoch %d: %s", epoch,
                    " ".join(f"{k}={v:.4f}" for k, v in means.items()))
        return means

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


def _rank_mean(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Host floats of the step's metrics, averaged over the ranks of the
    process group (each rank's are of its share of the batch)."""
    if not metrics:
        return {}
    keys = sorted(metrics)
    vec = torch.stack([metrics[k].detach().double().reshape(())
                       for k in keys])
    vec = dist.all_reduce(vec, dist.ReduceOp.AVG).tolist()
    return dict(zip(keys, vec))
