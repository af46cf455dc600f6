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

``build_train_step(..., grad_compression=k)`` (``bf16``, ``fp16`` or
``int8``) compresses the gradient sync on the wire: a model in
``DistributedDataParallel`` must carry the matching hook
(``DataParallel.wrap(model, grad_compress=k)``), which runs inside its
backward; a plain model in a process group of more than one rank has its
summed gradients averaged by ``parallel.ddp.sync_grads`` after the
microbatch loop (span ``train.grad_sync``), with the step's own q8
error feedback. A pipeline stage (``parallel.pipeline_lm.PipelineParallel``)
carries ``data_grad_group``: its gradients are averaged over that group
(its data replicas, one flat all-reduce) after the microbatch loop.
``build_train_step(..., ema_decay=d)`` (``0 <= d < 1``) moves
``state.ema_params`` (``TrainState(..., ema=True)``) to ``d * ema +
(1 - d) * p`` in f32 after every step, a skipped fp16 step included, as
the JAX step does.

``Trainer.fit`` runs epochs of the loader, ``max_steps_per_epoch`` steps
at most, times each wait for the next batch (``train.data_wait``), logs
(and so synchronizes) every ``log_every`` steps, with the metrics
averaged over the ranks of a process group and the samples a second
over the logging window (``samples_per_s``: the leading dim of the
batch's ``samples_axis`` leaf, times the data shares,
``runtime.mesh.data_rank``), raises
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
``elastic.Preempted``. ``async_checkpoint`` writes the files on a
background thread (``checkpoint.AsyncCheckpointer``; the fit waits for
the last one); ``keep_checkpoints`` N (with ``ckpt_every_steps``) saves
``step-<N>`` tags and prunes all but the newest N before each save;
``keep_best`` (an eval metric, ``best_mode`` ``max`` or ``min``) saves
the tag ``best`` whenever it improves, with ``best_metric.json`` beside
it so a resumed run keeps its best; ``early_stop_patience`` stops the
fit after that many evaluations without improvement of the same
metric. ``eval_every_epochs`` spaces the evaluations and
``eval_finalize`` transforms their means (``losses.f1_finalize``).

The JAX trainer's lifecycle around the step: a goodput account
(``tracing.GoodputAccount``: ``productive`` steps, evaluations and
metric reads, ``checkpoint`` saves, ``recovering`` restores,
``stalled`` what the watchdog saw, the rest ``other``), written at the
end of ``fit`` as a ``split="goodput"`` record of the JSONL stream and
read as ``goodput_pct`` in every logged record; ``stall_timeout_s`` arms the
``elastic.Watchdog``, whose stall is goodput's ``stalled`` and a
``watchdog.stall`` marker on the span timeline; ``trace_dir`` with
``trace_steps`` ``(start, stop)`` runs ``torch.profiler`` over those
host steps and writes its Chrome trace there; ``log_mfu`` counts the
step's FLOPs while the first step runs (``utils.profiler.aten_flops``
for ATen ops, plus the flash kernels' own count, ``ops.flash_attention
.count_flops``) and logs TFLOP/s and, where the card's peak is known
(``runtime.device.peak_flops``), MFU per card. The JAX trainer's
``donate_batch`` (XLA's buffer donation) has no counterpart.

With ``metrics_path`` (a JSONL ``train/metrics.MetricsWriter``) and
``tensorboard_dir`` (``utils/tensorboard.TensorBoardWriter``) rank 0
writes every logged step (its metrics, ``samples_per_sec``,
``step_time_ms`` and ``epoch``) and every evaluation (split ``eval``),
the JAX trainer's records. ``eval_with_ema`` evaluates the EMA shadow
(the parameters swapped in for the pass, the running statistics the
model's own). ``trace`` arms the span tracer when the trainer is made;
at the end of ``fit`` the span rollups go to the metrics writer (split
``trace``) and the timeline to ``<trace>/trace.json`` (rank 0;
``trace-rank<r>.json`` otherwise).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.nn.parallel import DistributedDataParallel

from pytorch_distributed_tpu_torch.optim import _local
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime import tracing
from pytorch_distributed_tpu_torch.runtime.mesh import data_rank
from pytorch_distributed_tpu_torch.runtime.precision import GradScaler
from pytorch_distributed_tpu_torch.runtime.prng import generator_for
from pytorch_distributed_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_tpu_torch.train import elastic
from pytorch_distributed_tpu_torch.train.metrics import (
    MetricsWriter,
    TeeWriter,
)
from pytorch_distributed_tpu_torch.train.train_state import TrainState
from pytorch_distributed_tpu_torch.utils.logging import get_logger
from pytorch_distributed_tpu_torch.utils.tensorboard import TensorBoardWriter

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


def _grad_sync(model, grad_compression: Optional[str]):
    """What the step does about a compressed sync: None (DDP's own
    all-reduce or its hook runs it, or there is nothing to sync), else
    ``sync(grads)`` averaging the summed gradients over the ranks."""
    from pytorch_distributed_tpu_torch.parallel.ddp import sync_grads
    from pytorch_distributed_tpu_torch.parallel.overlap import ErrorFeedback

    if grad_compression is None:
        return None
    if isinstance(model, DistributedDataParallel):
        hook = getattr(model, "grad_compress_hook", None)
        if hook is None or hook.kind != grad_compression:
            raise ValueError(
                f"grad_compression={grad_compression!r} needs the DDP model "
                "wrapped with DataParallel.wrap(model, grad_compress="
                f"{grad_compression!r}); its hook is "
                f"{getattr(hook, 'kind', None)!r}")
        return None
    feedback = ErrorFeedback()

    def sync(grads):
        return sync_grads(grads, grad_compression, feedback=feedback)

    return sync


def _average(grads, group) -> None:
    """Average ``grads`` in place over ``group``, in one flat
    all-reduce (a ``DTensor`` gradient's local part)."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    grads = [_local(g) for g in grads]
    flat = _flatten_dense_tensors(grads)
    torch.distributed.all_reduce(flat, group=group)
    flat.div_(torch.distributed.get_world_size(group))
    for g, a in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(a)


def _update_ema(state: TrainState, decay: float) -> None:
    from pytorch_distributed_tpu_torch.train.train_state import (
        trainable_params,
    )

    if state.ema_params is None:
        raise ValueError("ema_decay set but the state has no shadow params: "
                         "make it with TrainState(..., ema=True)")
    params = trainable_params(state.model)
    ema = [state.ema_params[n] for n in params]
    with torch.no_grad():
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(
            [_local(p).to(torch.float32) for p in params.values()],
            1.0 - decay))


def build_train_step(
    loss_fn: Callable,
    *,
    accum_steps: int = 1,
    batch_transform: Optional[Callable] = None,
    scaler: Optional[GradScaler] = None,
    grad_compression: Optional[str] = None,
    ema_decay: Optional[float] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], tuple]:
    """``step(state, batch) -> (state, metrics)``; see the module
    docstring. The batch must already be on the model's device."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if ema_decay is not None and not 0.0 <= ema_decay < 1.0:
        # d = 1 freezes the shadow at its seed; d > 1 diverges
        raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
    if grad_compression is not None:
        from pytorch_distributed_tpu_torch.parallel.ddp import _check_kind

        _check_kind(grad_compression)
    takes_rng = getattr(batch_transform, "_ptd_takes_rng", False)
    scaling = scaler is not None and scaler.enabled
    syncs = {}   # model -> its sync (None: DDP or its hook runs it)

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
            if scaling:
                scaler.unscale_grads(grads, state.scaler_state)
            data_group = getattr(model, "data_grad_group", None)
            if data_group is not None:
                # a pipeline stage (parallel.PipelineParallel): the mean
                # over its data replicas, never over the other stages
                with tracing.span("train.grad_sync"):
                    _average(grads, data_group)
            sp_group = getattr(model, "sequence_grad_group", None)
            if sp_group is not None:
                # sequence shards: each sp rank's loss is its share of the
                # rows' mean, so the gradients sum over sp (parallel.FSDP)
                with tracing.span("train.grad_sync"):
                    for g in grads:
                        torch.distributed.all_reduce(_local(g),
                                                     group=sp_group)
            if id(model) not in syncs:
                syncs[id(model)] = _grad_sync(model, grad_compression)
            sync = syncs[id(model)]
            if sync is not None and dist.get_world_size() > 1:
                # after the 1/A scale and the unscale, as the JAX step
                # syncs its averaged, unscaled gradients
                with tracing.span("train.grad_sync"):
                    live = [p for p in model.parameters()
                            if p.grad is not None]
                    for p, g in zip(live, sync([p.grad for p in live])):
                        p.grad = g
                grads = [p.grad for p in live]
            apply = True
            if scaling:
                state.scaler_state, finite = scaler.functional_update(
                    grads, state.scaler_state)
                sums["loss_scale"] = state.scaler_state.scale
                sums["grads_finite"] = finite.to(torch.float32)
                apply = bool(finite)   # the one host read of a scaled step
            with tracing.span("train.optim"):
                if apply:
                    opt.step()
                if ema_decay is not None:
                    _update_ema(state, ema_decay)
            state.step += 1
        return state, sums

    step._ptd_ema_decay = ema_decay
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
    eval_with_ema: bool = False  # evaluate the EMA shadow parameters
    metrics_path: Optional[str] = None  # JSONL scalar log (rank 0)
    tensorboard_dir: Optional[str] = None  # TensorBoard event files (rank 0)
    trace: Optional[str] = None  # span-tracer output dir (trace.json)
    eval_every_epochs: int = 1
    async_checkpoint: bool = False  # file writes on a background thread
    stall_timeout_s: Optional[float] = None  # the watchdog's limit
    log_mfu: bool = False  # TFLOP/s and MFU in the logged records
    keep_checkpoints: Optional[int] = None  # with ckpt_every_steps:
    # step-<N> tags, the newest N kept (latest and best untouched)
    keep_best: Optional[str] = None  # eval metric: tag 'best' on improvement
    best_mode: str = "max"  # 'max' (accuracy-like) or 'min' (loss-like)
    early_stop_patience: Optional[int] = None  # evals without improvement
    # of keep_best before fit() stops; needs keep_best and an eval_step
    eval_finalize: Optional[Callable] = None  # means -> means after eval
    trace_dir: Optional[str] = None  # with trace_steps: torch.profiler out
    trace_steps: Optional[tuple] = None  # (start, stop) host steps profiled


class TrainingDiverged(RuntimeError):
    """The logged training loss stayed non-finite: restart from the last
    finite checkpoint with a lower LR or another seed."""


class Trainer:
    """Epoch loop: feed, step, log. ``history`` keeps every logged
    record (step, epoch, metrics, step time)."""

    def __init__(self, state: TrainState, train_step: Callable, train_loader,
                 *, eval_step: Optional[Callable] = None, eval_loader=None,
                 config: TrainerConfig = TrainerConfig()):
        if config.eval_with_ema and getattr(
                train_step, "_ptd_ema_decay", "custom") is None:
            # a shadow the step never moves would score its seed weights
            raise ValueError("eval_with_ema=True but the train step was built "
                             "without ema_decay: pass build_train_step(..., "
                             "ema_decay=...)")
        self.state = state
        self.train_step = train_step
        self.train_loader = train_loader
        self.eval_step = eval_step
        self.eval_loader = eval_loader
        self.config = config
        self.metrics_writer = None
        if dist.get_rank() == 0:
            writers = []
            if config.metrics_path:
                writers.append(MetricsWriter(config.metrics_path))
            if config.tensorboard_dir:
                writers.append(TensorBoardWriter(config.tensorboard_dir))
            if len(writers) == 1:
                self.metrics_writer = writers[0]
            elif writers:
                self.metrics_writer = TeeWriter(writers)
        # armed here, not in fit(): restore_checkpoint's span counts too
        self._own_tracer = (tracing.configure(config.trace)
                            if config.trace else None)
        self.host_step = 0
        self.history: List[dict] = []
        self.last_eval_metrics: Dict[str, float] = {}
        self.last_goodput: Dict[str, float] = {}
        self._nonfinite_logs = 0
        # where fit() starts (restore_checkpoint moves it) and the cursor
        # a checkpoint records: the epoch and the batches it has taken
        self._first_epoch = 0
        self._resume_skip_batches = 0
        self._cursor_epoch = 0
        self._cursor_offset = 0
        self._preemption: Optional[elastic.PreemptionHandler] = None
        self._watchdog: Optional[elastic.Watchdog] = None
        # the goodput clock starts here: set-up before the first step is
        # honestly "other", not productive time
        self._goodput = tracing.GoodputAccount()
        self._step_flops: Optional[float] = None   # log_mfu, set lazily
        self._step_flash_flops = 0.0               # its flash kernels' part
        self._best_value: Optional[float] = None   # keep_best
        self._es_best: Optional[float] = None      # early stopping
        self._es_stale = 0
        self._profiler = None                      # the trace_steps window
        self._check_config(eval_step)
        self._async_ckpt = (ckpt.AsyncCheckpointer()
                            if config.async_checkpoint else None)

    def _check_config(self, eval_step) -> None:
        cfg = self.config
        if cfg.best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be 'max' or 'min', got "
                             f"{cfg.best_mode!r}")
        if cfg.keep_checkpoints is not None:
            if cfg.keep_checkpoints < 1:
                raise ValueError(f"keep_checkpoints must be >= 1, got "
                                 f"{cfg.keep_checkpoints}")
            if not cfg.ckpt_every_steps:
                raise ValueError(
                    "keep_checkpoints requires ckpt_every_steps: retention "
                    "prunes step-tagged checkpoints, which only the "
                    "ckpt_every_steps cadence writes")
        if cfg.early_stop_patience is not None:
            if cfg.early_stop_patience < 1:
                raise ValueError(f"early_stop_patience must be >= 1, got "
                                 f"{cfg.early_stop_patience}")
            if cfg.keep_best is None or eval_step is None:
                raise ValueError("early_stop_patience requires keep_best (the "
                                 "watched metric name) and an eval_step")
        if (cfg.trace_steps is None) != (cfg.trace_dir is None):
            raise ValueError("trace_dir and trace_steps come together: "
                             "profile host steps [start, stop) into the dir")
        if cfg.trace_steps is not None:
            a, b = cfg.trace_steps
            if not 0 <= a < b:
                raise ValueError(f"trace_steps must be (start, stop) with 0 "
                                 f"<= start < stop, got {cfg.trace_steps}")
        if cfg.halt_on_nonfinite < 0:
            raise ValueError(f"halt_on_nonfinite must be >= 0 (0 disables),"
                             f" got {cfg.halt_on_nonfinite}")
        if cfg.eval_every_epochs < 1:
            raise ValueError(f"eval_every_epochs must be >= 1, got "
                             f"{cfg.eval_every_epochs}")

    @contextlib.contextmanager
    def _accounted(self, span_name: Optional[str], bucket: str, **span_args):
        """A trace span (none for ``None``: the train step emits its own)
        and a goodput bucket around one section. A watchdog stall that
        ends inside it was a slow section, not a hang: its seconds leave
        ``stalled`` (the section has them)."""
        t0 = time.perf_counter()
        stalled0 = self._goodput.buckets.get("stalled", 0.0)
        try:
            with (tracing.span(span_name, **span_args) if span_name
                  else contextlib.nullcontext()):
                yield
        finally:
            self._goodput.add(bucket, time.perf_counter() - t0)
            self._goodput.retract(
                "stalled", self._goodput.buckets.get("stalled", 0.0)
                - stalled0)

    # -- checkpoints --------------------------------------------------------
    def save_checkpoint(self, tag: str = "latest") -> Optional[str]:
        """Checkpoint the state under ``ckpt_dir/tag`` (every rank takes
        part; with ``async_checkpoint`` the files land on a background
        thread) and the sampler cursor beside it (rank 0)."""
        cfg = self.config
        if cfg.ckpt_dir is None:
            return None
        with self._accounted("train.checkpoint", "checkpoint", tag=tag):
            if self._async_ckpt is not None:
                path = self._async_ckpt.save(cfg.ckpt_dir, self.state,
                                             tag=tag)
            else:
                path = ckpt.save_checkpoint(cfg.ckpt_dir, self.state,
                                            tag=tag)
            if dist.get_rank() == 0:
                ckpt.save_sampler_cursor(
                    cfg.ckpt_dir, step=self.host_step,
                    epoch=self._cursor_epoch, offset=self._cursor_offset)
        logger.info("checkpoint saved: %s (step %d)", path, self.host_step)
        if self._watchdog is not None:
            self._watchdog.tick()   # a slow save is not a hang
        return path

    def wait_for_checkpoint(self) -> None:
        """Block until an async save in flight has landed."""
        if self._async_ckpt is not None:
            self._async_ckpt.wait()

    def _prune_checkpoints(self) -> None:
        """Before a ``step-<N>`` save: keep the newest ``keep - 1`` step
        tags (the save supplies the newest survivor; never below one),
        on rank 0, once the previous async save has landed."""
        cfg = self.config
        if not (cfg.keep_checkpoints and cfg.ckpt_dir):
            return
        if dist.get_rank() != 0:
            return
        self.wait_for_checkpoint()
        for path in ckpt.prune_checkpoints(
                cfg.ckpt_dir, keep=max(cfg.keep_checkpoints - 1, 1)):
            logger.info("pruned checkpoint: %s", path)

    def restore_checkpoint(self, tag: str = "latest") -> bool:
        """Restore the newest intact checkpoint for ``tag``: rank 0 first
        finishes any swing a kill interrupted, then the candidates are
        tried newest first, each verified by rank 0 (the verdict is
        shared, so every rank skips the same ones). False when there is
        nothing to restore; ``CheckpointCorrupted`` when checkpoints
        exist and none is restorable."""
        with self._accounted("train.restore", "recovering", tag=tag):
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
        self._load_best_record()   # the best before the restart stands
        logger.info("resumed %r at step %d (epoch %d, skipping %d batches)",
                    tag, step, epoch, offset)

    def _check_preemption(self) -> None:
        if self._preemption is not None and self._preemption.requested:
            self.save_checkpoint()
            self.wait_for_checkpoint()   # the restart reads it next
            logger.warning("preemption checkpoint written at step %d: "
                           "exiting for a restart", self.host_step)
            raise elastic.Preempted(self.host_step)

    # -- loops --------------------------------------------------------------
    def fit(self) -> TrainState:
        cfg = self.config
        self._preemption = (elastic.PreemptionHandler().install()
                            if cfg.handle_preemption else None)
        self._watchdog = (elastic.Watchdog(
            cfg.stall_timeout_s, on_stall=self._note_stall).start()
            if cfg.stall_timeout_s else None)
        if cfg.trace and self._own_tracer is None:
            self._own_tracer = tracing.configure(cfg.trace)   # a second fit
        try:
            for epoch in range(self._first_epoch, cfg.epochs):
                self.train_loader.set_epoch(epoch)
                self._train_epoch(epoch)
                # the epoch is taken: a checkpoint from here on resumes at
                # the next epoch's first batch
                self._cursor_epoch, self._cursor_offset = epoch + 1, 0
                if self.eval_step is not None and (
                        (epoch + 1) % cfg.eval_every_epochs == 0):
                    means = self.evaluate(epoch)
                    if self._early_stop_triggered(means):
                        self.save_checkpoint()
                        logger.info(
                            "early stop at epoch %d: %s has not improved for "
                            "%d evals (best %s)", epoch, cfg.keep_best,
                            self._es_stale, self._es_best)
                        break
                self.save_checkpoint()
        finally:
            if self._profiler is not None:
                self._stop_profiler(early=True)
            try:
                self.wait_for_checkpoint()   # the last save lands first
            finally:
                if self._preemption is not None:
                    self._preemption.uninstall()
                    self._preemption = None
                if self._watchdog is not None:
                    self._watchdog.stop()
                    self._watchdog = None
                self._finish_observability()
                if self.metrics_writer is not None:
                    self.metrics_writer.close()
        return self.state

    def _note_stall(self, idle_s: float) -> None:
        """The watchdog's stall: goodput's ``stalled`` and a marker."""
        self._goodput.add("stalled", idle_s)
        tracing.instant("watchdog.stall", idle_s=idle_s,
                        step=self.host_step)

    def _finish_observability(self) -> None:
        """The goodput record and the span rollups to the metrics writer,
        the timeline to ``<trace>/trace.json``; then the tracer is
        disarmed. A failed export is logged, never raised over the run's
        own exception."""
        self.last_goodput = self._goodput.summary()
        writers = getattr(self.metrics_writer, "writers",
                          [self.metrics_writer])
        # the JSONL stream, which summarize_goodput reads (a TensorBoard
        # file keeps its per-step scalars)
        for w in writers:
            if isinstance(w, MetricsWriter):
                try:
                    w.write(self.host_step,
                            {"event": "goodput", **self.last_goodput},
                            split="goodput")
                except Exception:
                    logger.exception("goodput record failed (ignored)")
        tracer, self._own_tracer = self._own_tracer, None
        if tracer is None:
            return
        try:
            if self.metrics_writer is not None:
                for name, roll in tracer.rollups().items():
                    self.metrics_writer.write(
                        self.host_step,
                        {"event": "span_rollup", "span": name, **roll},
                        split="trace")
            rank = dist.get_rank()
            name = "trace.json" if rank == 0 else f"trace-rank{rank}.json"
            path = tracer.export(os.path.join(self.config.trace, name))
            logger.info("span trace written to %s", path)
        except Exception:
            logger.exception("trace export failed (ignored)")
        finally:
            if tracing._tracer is tracer:
                tracing.clear()

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
            self._trace_tick()
            counting = (cfg.log_mfu and cfg.log_every
                        and self._step_flops is None)
            with self._accounted(None, "productive"), (
                    _counting_flops(self) if counting
                    else contextlib.nullcontext()):
                self.state, metrics = self.train_step(self.state, batch)
            self.host_step += 1
            if self._watchdog is not None:
                self._watchdog.tick(self.host_step)
            self._check_preemption()
            since_log += 1
            if cfg.log_every and self.host_step % cfg.log_every == 0:
                # the sync point: pull the metrics off the card
                with self._accounted("train.metric_fetch", "productive"):
                    values = _rank_mean(metrics)
                now = time.perf_counter()
                # each data share's rows once (a pipeline's stages, and
                # the tp/sp/ep ranks of one share, read the same rows)
                rate = samples * data_rank()[1] / (now - t_last)
                dt = (now - t_last) / since_log
                t_last, since_log, samples = now, 0, 0
                self._check_finite(values, self.host_step)
                extra = self._mfu_fields(dt)
                self.history.append(dict(
                    step=self.host_step, epoch=epoch, step_time_s=dt,
                    samples_per_s=rate, **values, **extra,
                ))
                if self.metrics_writer is not None:
                    self.metrics_writer.write(self.host_step, {
                        **values, "samples_per_sec": rate,
                        "step_time_ms": dt * 1e3, "epoch": epoch, **extra,
                        "goodput_pct": round(self._goodput.goodput_pct(), 2)})
                logger.info(
                    "epoch %d step %d %s (%.1f ms/step)%s", epoch,
                    self.host_step,
                    " ".join(f"{k}={v:.4f}" for k, v in values.items()),
                    dt * 1e3, "".join(
                        f" {k}={v:.4g}" for k, v in extra.items()),
                )
            if cfg.ckpt_every_steps and (
                    self.host_step % cfg.ckpt_every_steps == 0):
                t_save = time.perf_counter()
                if cfg.keep_checkpoints:
                    self._prune_checkpoints()   # before the save: overlap
                    self.save_checkpoint(tag=f"step-{self.host_step}")
                else:
                    self.save_checkpoint()
                t_last += time.perf_counter() - t_save   # no step's time

    def _mfu_fields(self, dt: float) -> Dict[str, float]:
        """``tflops`` (this rank's) and, with the card's peak, ``mfu``."""
        if not self._step_flops:
            return {}
        from pytorch_distributed_tpu_torch.runtime.device import peak_flops

        achieved = self._step_flops / dt
        out = {"tflops": achieved / 1e12}
        peak = peak_flops(next(self.state.model.parameters()).device)
        if peak:
            out["mfu"] = achieved / peak
        return out

    # -- the torch.profiler window -------------------------------------------
    def _trace_tick(self) -> None:
        """Start the profiler before the first step of ``trace_steps``
        (a resumed run inside the window captures its remainder) and stop
        it before the step at ``stop``, after the card has finished the
        traced steps."""
        cfg = self.config
        if cfg.trace_steps is None:
            return
        start, stop = cfg.trace_steps
        if self._profiler is None and start <= self.host_step < stop:
            from pytorch_distributed_tpu_torch.utils.profiler import (
                trace_activities,
            )

            device = next(self.state.model.parameters()).device
            self._profiler = torch.profiler.profile(
                activities=trace_activities(device))
            self._profiler.__enter__()
        elif self._profiler is not None and self.host_step >= stop:
            self._stop_profiler()

    def _stop_profiler(self, early: bool = False) -> None:
        from pytorch_distributed_tpu_torch.utils.profiler import export_trace

        prof, self._profiler = self._profiler, None
        device = next(self.state.model.parameters()).device
        try:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            prof.__exit__(None, None, None)
            path = export_trace(prof, self.config.trace_dir)
            logger.info("profiler trace of steps %s written to %s",
                        self.config.trace_steps, path)
            if early:
                logger.warning(
                    "trace window %s outlived training (last step %d): the "
                    "trace holds end-of-epoch work", self.config.trace_steps,
                    self.host_step)
        except Exception:
            if not early:
                raise
            logger.exception("profiler export failed (ignored)")

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
        shadow = contextlib.nullcontext()
        if self.config.eval_with_ema:
            if self.state.ema_params is None:
                raise ValueError("eval_with_ema needs shadow params: make the "
                                 "state with TrainState(..., ema=True)")
            shadow = _swapped_params(self.state.model, self.state.ema_params)
        # evaluation is useful work: goodput's productive
        with self._accounted("train.eval", "productive"), shadow:
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
        if self.config.eval_finalize is not None:
            means = self.config.eval_finalize(means)
        self.last_eval_metrics = means
        logger.info("eval epoch %d: %s", epoch,
                    " ".join(f"{k}={v:.4f}" for k, v in means.items()))
        if self.metrics_writer is not None:
            self.metrics_writer.write(self.host_step, {**means, "epoch": epoch},
                                      split="eval")
        self._maybe_save_best(means)
        return means

    # -- best checkpoint and early stopping ----------------------------------
    def _improved(self, value: float, best: Optional[float]) -> bool:
        """The one comparator best-saving and early stopping share."""
        return (best is None
                or (self.config.best_mode == "max" and value > best)
                or (self.config.best_mode == "min" and value < best))

    def _early_stop_triggered(self, means: Dict[str, float]) -> bool:
        cfg = self.config
        if cfg.early_stop_patience is None:
            return False
        value = means.get(cfg.keep_best)
        if value is None:
            raise ValueError(f"early-stop metric {cfg.keep_best!r} not in "
                             f"eval metrics {sorted(means)}")
        if not math.isfinite(value):   # NaN shows no improvement
            self._es_stale += 1
        elif self._improved(value, self._es_best):
            self._es_best, self._es_stale = value, 0
            return False
        else:
            self._es_stale += 1
        return self._es_stale >= cfg.early_stop_patience

    def _maybe_save_best(self, means: Dict[str, float]) -> None:
        """Save tag ``best`` whenever the watched metric improves."""
        cfg = self.config
        if cfg.keep_best is None or cfg.ckpt_dir is None:
            return
        if cfg.keep_best not in means:
            logger.warning("keep_best metric %r not in eval metrics %s: "
                           "skipping", cfg.keep_best, sorted(means))
            return
        value = means[cfg.keep_best]
        if not math.isfinite(value):   # a NaN best would never be beaten
            return
        if self._improved(value, self._best_value):
            self._best_value = value
            self.save_checkpoint(tag="best")
            self._write_best_record(value)
            logger.info("new best %s=%.4f (step %d)", cfg.keep_best, value,
                        self.host_step)

    def _best_record_path(self) -> str:
        return os.path.join(self.config.ckpt_dir, "best_metric.json")

    def _write_best_record(self, value: float) -> None:
        """The best value on disk (the JAX trainer's ``best_metric.json``),
        so a resumed run cannot demote ``best``."""
        if dist.get_rank() != 0:
            return
        tmp = self._best_record_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"metric": self.config.keep_best,
                       "mode": self.config.best_mode, "value": value,
                       "step": self.host_step}, f)
        os.replace(tmp, self._best_record_path())

    def _load_best_record(self) -> None:
        cfg = self.config
        if cfg.keep_best is None or cfg.ckpt_dir is None:
            return
        try:
            with open(self._best_record_path()) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return
        if rec.get("metric") == cfg.keep_best and \
                rec.get("mode") == cfg.best_mode:
            self._best_value = rec.get("value")
            logger.info("resumed best %s=%.4f (step %s)", cfg.keep_best,
                        self._best_value, rec.get("step"))

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


@contextlib.contextmanager
def _counting_flops(trainer: Trainer):
    """Count the FLOPs of the step run inside (``log_mfu``): the ATen ops
    (``utils.profiler.aten_flops``, which leaves every result as it is)
    and the flash kernels' own ledger. The count is this rank's, remat's
    recompute included (the JAX count of the compiled step's HLO counts
    it too); its host work falls in the first logging window's time."""
    from pytorch_distributed_tpu_torch.ops.flash_attention import count_flops
    from pytorch_distributed_tpu_torch.runtime.device import peak_flops
    from pytorch_distributed_tpu_torch.utils.profiler import aten_flops

    with aten_flops() as counter, count_flops() as ledger:
        yield
    trainer._step_flops = float(counter.flops + ledger.flops)
    trainer._step_flash_flops = float(ledger.flops)
    device = next(trainer.state.model.parameters()).device
    peak = peak_flops(device)
    logger.info(
        "log_mfu: %.4g FLOPs a step on this rank (%.4g of them the flash "
        "kernels'); %s", trainer._step_flops, float(ledger.flops),
        f"MFU against {peak / 1e12:.0f} TFLOP/s" if peak else
        f"MFU off: no peak for {device} (runtime.device.peak_flops)")


@contextlib.contextmanager
def _swapped_params(model, values: Dict[str, torch.Tensor]):
    """The model's trainable parameters replaced by ``values`` (cast to
    each parameter's dtype) inside the block, restored bitwise after."""
    from pytorch_distributed_tpu_torch.train.train_state import (
        trainable_params,
    )

    params = trainable_params(model)
    saved = {n: p.detach().clone() for n, p in params.items()}
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(values[n].to(p.dtype))
    try:
        yield
    finally:
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(saved[n])


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
