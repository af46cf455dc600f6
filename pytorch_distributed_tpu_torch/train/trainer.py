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
the last under ``no_sync()``, one sharded by FSDP with
``set_requires_gradient_sync(False)``, so its gradients cross the ranks
once a step), the metrics averaged, and the optimizer steps once. BatchNorm
running statistics, which the JAX step carries in ``state.batch_stats``,
are module buffers that each train-mode forward updates in place, one
microbatch after another as the JAX scan threads them. The step emits
the tracing spans ``train.step`` (all of it), ``train.fwd_bwd`` (the
microbatch loop) and ``train.optim`` (the update). Its metrics stay on
the device: nothing in the step waits for the card, unless it scales.

``build_train_step(..., scaler=S)`` with an fp16 ``GradScaler`` (the
JAX ``build_train_step(scaler=...)``) multiplies each microbatch's loss
by ``state.scaler_state.scale`` before its backward, and the summed
gradients (after DDP's all-reduce) by the inverse; then
``S.functional_update`` reads whether they are finite and moves the
scale. On a non-finite step the optimizer does not step: parameters,
moments, torch's per-parameter ``step`` (optax's count) and a
schedule's count stay as they were, while ``state.step`` advances, as
in the JAX step's skipped branch. That choice is one host read of the
device's finite flag a step, as ``torch.cuda.amp.GradScaler.step``
makes it. The metrics gain ``loss_scale`` (the new scale) and
``grads_finite`` (1.0 or 0.0).

``Trainer.fit`` runs epochs of the loader, ``max_steps_per_epoch`` steps
at most, times each wait for the next batch (``train.data_wait``), logs
(and so synchronizes) every ``log_every`` steps, with the metrics
averaged over the ranks of a process group and the samples a second
over the logging window (``samples_per_s``: the leading dim of the
batch's ``samples_axis`` leaf, times the ranks), raises
:class:`TrainingDiverged` after ``halt_on_nonfinite`` consecutive
non-finite logged losses, and with an ``eval_step`` and ``eval_loader``
evaluates after every epoch (``last_eval_metrics``: sample-weighted
means over the whole eval set, summed over the ranks).

With ``ckpt_dir`` it checkpoints (``train/checkpoint.py``, span
``train.checkpoint``, left out of the logged ``step_time_s``) every
``ckpt_every_steps`` steps and after every epoch, with the sampler
cursor beside it (epoch and batches taken, under the step it belongs
to); :meth:`Trainer.restore_checkpoint` (span
``train.restore``) first finishes a save a kill interrupted, then
restores the newest candidate that passes verification, and the next
``fit`` starts at the cursor's batch (the sampler skips the batches
already taken, unfetched). With ``handle_preemption`` a SIGTERM makes
the loop checkpoint at the next step boundary and raise
``elastic.Preempted``. Goodput accounting and the watchdog wait for
ROADMAP A5.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.nn.parallel import DistributedDataParallel

from pytorch_distributed_tpu_torch.optim import _local
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime import tracing
from pytorch_distributed_tpu_torch.runtime.precision import GradScaler
from pytorch_distributed_tpu_torch.runtime.prng import generator_for
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_tpu_torch.train import elastic
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


@contextlib.contextmanager
def _fsdp_no_sync(model):
    model.set_requires_gradient_sync(False)
    try:
        yield
    finally:
        model.set_requires_gradient_sync(True)


def _sync_unless(model, accumulating: bool):
    """No gradient sync while gradients still accumulate locally: DDP's
    ``no_sync()``; for a model FSDP sharded, its unsharded gradients
    accumulate on each rank and are reduce-scattered after the last
    microbatch."""
    from torch.distributed.fsdp import FSDPModule

    if accumulating and isinstance(model, DistributedDataParallel):
        return model.no_sync()
    if accumulating and isinstance(model, FSDPModule):
        return _fsdp_no_sync(model)
    return contextlib.nullcontext()


def build_train_step(
    loss_fn: Callable,
    *,
    accum_steps: int = 1,
    batch_transform: Optional[Callable] = None,
    scaler: Optional[GradScaler] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], tuple]:
    """``step(state, batch) -> (state, metrics)``; see the module
    docstring. The batch must already be on the model's device."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    takes_rng = getattr(batch_transform, "_ptd_takes_rng", False)
    scaling = scaler is not None and scaler.enabled

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
            if scaling and state.scaler_state is None:
                raise ValueError(
                    "an fp16 GradScaler needs state.scaler_state (TrainState("
                    "..., scaler_state=scaler.init_state(device)))")
            opt.zero_grad(set_to_none=True)
            sums: Dict[str, torch.Tensor] = {}
            with tracing.span("train.fwd_bwd"):
                for i, mb in enumerate(_split_microbatches(batch, accum_steps)):
                    gen = generator_for(state.step, DROPOUT_TAG + i, device)
                    with _sync_unless(model, i < accum_steps - 1):
                        loss, aux = loss_fn(mb, gen)
                        if scaling:
                            loss = scaler.scale_value(loss,
                                                      state.scaler_state)
                        loss.backward()
                    for k, v in aux.get("metrics", {}).items():
                        sums[k] = v if k not in sums else sums[k] + v
            grads = [p.grad for p in model.parameters()
                     if p.grad is not None]
            if accum_steps > 1:
                inv = 1.0 / accum_steps
                torch._foreach_mul_([_local(g) for g in grads], inv)
                sums = {k: v * inv for k, v in sums.items()}
            apply = True
            if scaling:
                scaler.unscale_grads(grads, state.scaler_state)
                state.scaler_state, finite = scaler.functional_update(
                    grads, state.scaler_state)
                sums["loss_scale"] = state.scaler_state.scale
                sums["grads_finite"] = finite.to(torch.float32)
                apply = bool(finite)   # the one host read of a scaled step
            with tracing.span("train.optim"):
                if apply:
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
    ckpt_dir: Optional[str] = None
    ckpt_every_steps: Optional[int] = None  # None: after each epoch only
    handle_preemption: bool = True  # SIGTERM -> checkpoint -> Preempted
    samples_axis: str = "image"  # batch leaf whose dim 0 counts samples


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
        # where fit() starts (restore_checkpoint moves it) and the cursor
        # a checkpoint records: the epoch and the batches it has taken
        self._first_epoch = 0
        self._resume_skip_batches = 0
        self._cursor_epoch = 0
        self._cursor_offset = 0
        self._preemption: Optional[elastic.PreemptionHandler] = None

    # -- checkpoints --------------------------------------------------------
    def save_checkpoint(self, tag: str = "latest") -> Optional[str]:
        """Checkpoint the state under ``ckpt_dir/tag`` (every rank takes
        part) and the sampler cursor beside it (rank 0)."""
        cfg = self.config
        if cfg.ckpt_dir is None:
            return None
        with tracing.span("train.checkpoint", tag=tag):
            path = ckpt.save_checkpoint(cfg.ckpt_dir, self.state, tag=tag)
            if dist.get_rank() == 0:
                ckpt.save_sampler_cursor(
                    cfg.ckpt_dir, step=self.host_step,
                    epoch=self._cursor_epoch, offset=self._cursor_offset)
        logger.info("checkpoint saved: %s (step %d)", path, self.host_step)
        return path

    def restore_checkpoint(self, tag: str = "latest") -> bool:
        """Restore the newest intact checkpoint for ``tag``: rank 0 first
        finishes any swing a kill interrupted, then the candidates are
        tried newest first, each verified by rank 0 (the verdict is
        shared, so every rank skips the same ones). False when there is
        nothing to restore; ``CheckpointCorrupted`` when checkpoints
        exist and none is restorable."""
        with tracing.span("train.restore", tag=tag):
            return self._restore(tag)

    def _restore(self, tag: str) -> bool:
        ckpt_dir = self.config.ckpt_dir
        if ckpt_dir is None:
            return False
        if dist.get_rank() == 0:
            recovered = ckpt.recover_stranded_checkpoints(ckpt_dir)
            if recovered:
                logger.warning("recovered interrupted checkpoint commit(s): "
                               "%s", recovered)
        dist.barrier()
        candidates = ckpt.restore_candidates(ckpt_dir, tag)
        device = next(self.state.model.parameters()).device
        load_errors = []
        for cand in candidates:
            ok = 1.0
            if dist.get_rank() == 0:
                problems = ckpt.verify_checkpoint(ckpt_dir, cand)
                if problems:
                    logger.warning(
                        "checkpoint %r failed verification (%s): falling "
                        "back to the next candidate", cand,
                        "; ".join(problems[:3]))
                    ok = 0.0
            if not dist.broadcast(torch.tensor([ok], device=device)).item():
                continue
            try:
                ckpt.restore_checkpoint(ckpt_dir, self.state, tag=cand)
            except Exception as e:
                if dist.get_world_size() > 1:
                    raise   # falling back alone would split the world
                logger.warning("restoring checkpoint %r failed (%s: %s): "
                               "falling back to the next candidate", cand,
                               type(e).__name__, e)
                load_errors.append(e)
                continue
            self._resume_bookkeeping(cand)
            return True
        if load_errors:
            # verified candidates that do not fit this state: a template
            # mismatch, not damage; surface it
            raise load_errors[0]
        if candidates or (tag == "latest" and _damaged(ckpt_dir)):
            raise ckpt.CheckpointCorrupted(
                f"checkpoints exist under {ckpt_dir!r} but none is "
                "restorable: refusing to train from scratch over them")
        return False

    def _epoch_len(self) -> Optional[int]:
        """Batches an epoch takes; None when the loader has no length."""
        try:
            n = max(len(self.train_loader), 1)
        except TypeError:
            return self.config.max_steps_per_epoch
        if self.config.max_steps_per_epoch:
            n = min(n, self.config.max_steps_per_epoch)
        return n

    def _resume_bookkeeping(self, tag: str) -> None:
        step = int(self.state.step)
        self.host_step = step
        epoch_len = self._epoch_len()
        cursor = ckpt.load_sampler_cursor(self.config.ckpt_dir)
        if cursor is not None and cursor["step"] == step:
            epoch, offset = cursor["epoch"], cursor["offset"]
            if epoch_len is not None and offset >= epoch_len:
                epoch, offset = epoch + 1, 0   # saved on the boundary
        else:
            if cursor is not None:
                logger.warning(
                    "sampler cursor is for step %d but the checkpoint is "
                    "step %d: resuming by the steps-per-epoch count",
                    cursor["step"], step)
            epoch, offset = divmod(step, epoch_len) if epoch_len else (0, 0)
        self._first_epoch = self._cursor_epoch = epoch
        self._resume_skip_batches = self._cursor_offset = offset
        logger.info("resumed %r at step %d (epoch %d, skipping %d batches)",
                    tag, step, epoch, offset)

    def _check_preemption(self) -> None:
        if self._preemption is not None and self._preemption.requested:
            self.save_checkpoint()
            logger.warning("preemption checkpoint written at step %d: "
                           "exiting for a restart", self.host_step)
            raise elastic.Preempted(self.host_step)

    # -- loops --------------------------------------------------------------
    def fit(self) -> TrainState:
        cfg = self.config
        self._preemption = (elastic.PreemptionHandler().install()
                            if cfg.handle_preemption else None)
        try:
            for epoch in range(self._first_epoch, cfg.epochs):
                self.train_loader.set_epoch(epoch)
                self._train_epoch(epoch)
                # the epoch is taken: a checkpoint from here on resumes at
                # the next epoch's first batch
                self._cursor_epoch, self._cursor_offset = epoch + 1, 0
                if self.eval_step is not None:
                    self.evaluate(epoch)
                self.save_checkpoint()
        finally:
            if self._preemption is not None:
                self._preemption.uninstall()
                self._preemption = None
        return self.state

    def _train_epoch(self, epoch: int) -> None:
        cfg = self.config
        device = next(self.state.model.parameters()).device
        t_last = time.perf_counter()
        since_log = samples = 0
        taken, self._resume_skip_batches = self._resume_skip_batches, 0
        if taken:   # resume: the sampler starts past the batches taken
            self.train_loader.sampler.load_state_dict(
                {"epoch": epoch, "offset": taken})
        self._cursor_epoch, self._cursor_offset = epoch, taken
        batches = iter(self.train_loader)
        while True:
            if cfg.max_steps_per_epoch and taken >= cfg.max_steps_per_epoch:
                break
            with tracing.span("train.data_wait"):
                batch = next(batches, None)
                if batch is None:
                    break
                batch = {k: v.to(device, non_blocking=True)
                         for k, v in batch.items()}
            taken += 1
            self._cursor_offset = taken
            samples += self._batch_samples(batch)
            self.state, metrics = self.train_step(self.state, batch)
            self.host_step += 1
            self._check_preemption()
            since_log += 1
            if cfg.log_every and self.host_step % cfg.log_every == 0:
                # the sync point: pull the metrics off the card
                values = _rank_mean(metrics)
                now = time.perf_counter()
                rate = samples * dist.get_world_size() / (now - t_last)
                dt = (now - t_last) / since_log
                t_last, since_log, samples = now, 0, 0
                self._check_finite(values, self.host_step)
                self.history.append(dict(
                    step=self.host_step, epoch=epoch, step_time_s=dt,
                    samples_per_s=rate, **values,
                ))
                logger.info(
                    "epoch %d step %d %s (%.1f ms/step)", epoch,
                    self.host_step,
                    " ".join(f"{k}={v:.4f}" for k, v in values.items()),
                    dt * 1e3,
                )
            if cfg.ckpt_every_steps and (
                    self.host_step % cfg.ckpt_every_steps == 0):
                t_save = time.perf_counter()
                self.save_checkpoint()
                t_last += time.perf_counter() - t_save   # no step's time

    def _batch_samples(self, batch) -> int:
        """This rank's samples in ``batch``: the leading dim of its
        ``samples_axis`` leaf, else of its first leaf."""
        x = batch.get(self.config.samples_axis)
        if x is None:
            x = next(iter(batch.values()), None)
        return 0 if x is None else int(x.shape[0])

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


def _damaged(ckpt_dir: str) -> bool:
    """A ``latest``/``step-<N>`` directory (or its ``.old``) exists, even
    with an unreadable manifest: 'everything saved is damaged', not
    'nothing saved yet'. A ``.tmp`` (an aborted first save) does not
    count."""
    if not os.path.isdir(ckpt_dir):
        return False
    for name in os.listdir(ckpt_dir):
        base = name[:-len(".old")] if name.endswith(".old") else name
        if name.endswith(".tmp"):
            continue
        if (base == "latest" or base.startswith("step-")) and os.path.isdir(
                os.path.join(ckpt_dir, name)):
            return True
    return False


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
