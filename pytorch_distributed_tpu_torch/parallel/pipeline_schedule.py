"""Host-dispatched pipeline schedules: the port of
``pytorch_distributed_tpu/parallel/pipeline_schedule.py``.

The GPipe form (``parallel/pipeline.py``) runs every stage in one
differentiable tick loop, which computes nothing on a stage's idle ticks
but holds every microbatch's activations until the backward. This module
is the host-dispatched alternative: each rank owns one stage, a host
loop issues the ops of a precomputed schedule, and neighbouring stages
hand activations and gradients over the stage link
(``runtime.distributed.StageLink``, tags ``act.m{mb}.s{stage}`` and
``grad.m{mb}.s{stage}``).

Two schedule shapes, both pure functions of ``(stage, S, M)``:

* ``schedule_gpipe``: all ``M`` forwards, then all ``M`` backwards; the
  stage holds all ``M`` microbatch inputs at the turn
  (``peak_live_microbatches == M``).
* ``schedule_1f1b``: ``min(S-1-stage, M)`` warm-up forwards, then one
  forward and one backward in turn, then the cool-down backwards: at
  most ``min(S - stage, M)`` microbatches live on a stage, bounded by
  ``S`` whatever ``M``. Both pay the analytic bubble
  ``(S-1)/(M+S-1)`` (``bubble_fraction``).

The issue order is a pure function of ``(stage, S, M)``, so the stages
stay in lockstep by construction. ``schedule_interleaved`` (virtual
stages, bubble ``(S-1)/(V*M + S-1)``) is the schedule and mapping math
the JAX package ships; the executor runs ``V == 1``, as the JAX one does.
``simulate_links`` replays a schedule set against the link's channel
model, one message in flight per ordered pair of stages.

The schedule functions return what the JAX ones return, integer for
integer (``tests/test_torch_pipeline_schedule.py``). This module imports
nothing of the JAX package: the apportionment of ``stage_depths`` is its
own copy of the JAX ``train/balance.py`` arithmetic.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# -- op kinds (strings, not an enum: they appear in fault paths and traces) --
RECV_ACT = "recv_act"
FWD = "fwd"
SEND_ACT = "send_act"
RECV_GRAD = "recv_grad"
BWD = "bwd"
SEND_GRAD = "send_grad"

COMPUTE_KINDS = (FWD, BWD)
COMM_KINDS = (RECV_ACT, SEND_ACT, RECV_GRAD, SEND_GRAD)


@dataclass(frozen=True)
class StageOp:
    """One schedule slot: ``kind`` over microbatch ``mb`` (chunk = the
    virtual-stage index on this rank; 0 unless interleaved)."""

    kind: str
    mb: int
    chunk: int = 0


def _check_args(stage: int, num_stages: int, num_microbatches: int) -> None:
    if num_stages < 1:
        raise ValueError(f"num_stages must be >= 1, got {num_stages}")
    if not 0 <= stage < num_stages:
        raise ValueError(f"stage {stage} outside [0, {num_stages})")
    if num_microbatches < 1:
        raise ValueError(
            f"num_microbatches must be >= 1, got {num_microbatches}"
        )


def _attach_comms(
    skeleton: Sequence[Tuple[str, int]], stage: int, num_stages: int
) -> Tuple[StageOp, ...]:
    """Wrap a (kind, mb) compute skeleton with the neighbor handoffs: a
    non-first stage receives its input activation just-in-time before each
    forward; a non-last stage sends the activation right after, receives the
    output grad just-in-time before each backward; a non-first stage sends
    the input grad right after."""
    first = stage == 0
    last = stage == num_stages - 1
    ops: List[StageOp] = []
    for kind, mb in skeleton:
        if kind == FWD:
            if not first:
                ops.append(StageOp(RECV_ACT, mb))
            ops.append(StageOp(FWD, mb))
            if not last:
                ops.append(StageOp(SEND_ACT, mb))
        else:
            if not last:
                ops.append(StageOp(RECV_GRAD, mb))
            ops.append(StageOp(BWD, mb))
            if not first:
                ops.append(StageOp(SEND_GRAD, mb))
    return tuple(ops)


def schedule_1f1b(
    stage: int, num_stages: int, num_microbatches: int
) -> Tuple[StageOp, ...]:
    """The 1F1B op list for ``stage``: warm-up ``min(S-1-stage, M)``
    forwards, steady-state (fwd, bwd) pairs, cool-down backwards.

    Pure function of ``(stage, num_stages, num_microbatches)`` — the
    lockstep-by-construction property every caller leans on. Backwards
    complete in increasing microbatch order, so a left fold over them is
    the same association as a running sum over the microbatches.
    """
    _check_args(stage, num_stages, num_microbatches)
    warmup = min(num_stages - 1 - stage, num_microbatches)
    skeleton: List[Tuple[str, int]] = []
    f = b = 0
    for _ in range(warmup):
        skeleton.append((FWD, f))
        f += 1
    for _ in range(num_microbatches - warmup):
        skeleton.append((FWD, f))
        f += 1
        skeleton.append((BWD, b))
        b += 1
    for _ in range(warmup):
        skeleton.append((BWD, b))
        b += 1
    return _attach_comms(skeleton, stage, num_stages)


def schedule_gpipe(
    stage: int, num_stages: int, num_microbatches: int
) -> Tuple[StageOp, ...]:
    """The host GPipe op list: all forwards, then all backwards. Same
    ``(M + S - 1)``-tick critical path as 1F1B, but the stage must hold all
    ``M`` microbatch inputs at the fwd/bwd boundary — the memory cost
    ``schedule_1f1b`` exists to avoid."""
    _check_args(stage, num_stages, num_microbatches)
    skeleton = [(FWD, i) for i in range(num_microbatches)]
    skeleton += [(BWD, i) for i in range(num_microbatches)]
    return _attach_comms(skeleton, stage, num_stages)


def virtual_stage(rank: int, chunk: int, world: int) -> int:
    """Global stage id of ``chunk`` on ``rank`` under interleaving: chunk
    ``v`` of rank ``r`` runs global stage ``v * world + r`` — consecutive
    global stages land on consecutive ranks, so every chunk boundary is a
    one-hop neighbor handoff."""
    return chunk * world + rank


def schedule_interleaved(
    rank: int, world: int, num_chunks: int, num_microbatches: int
) -> Tuple[StageOp, ...]:
    """Interleaved-virtual-stage 1F1B (Megatron-style): each rank runs
    ``num_chunks`` layer chunks, microbatches advance in groups of
    ``world``, and the warm-up is deep enough to keep every chunk fed.

    Compute ops only (``chunk`` = local chunk index; the global stage is
    ``virtual_stage(rank, chunk, world)``) — this is the schedule/mapping
    math the planner prices and the tests pin; the executor runs V == 1.
    Requires ``num_microbatches % world == 0`` (the grouping invariant).
    """
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside [0, {world})")
    if num_chunks < 2:
        raise ValueError(
            "interleaving needs num_chunks >= 2 — V == 1 is plain 1F1B "
            "(schedule_1f1b)"
        )
    if num_microbatches % world:
        raise ValueError(
            f"interleaved schedule needs num_microbatches divisible by "
            f"world, got M={num_microbatches} world={world}"
        )
    total = num_microbatches * num_chunks
    warmup = min((world - rank - 1) * 2 + (num_chunks - 1) * world, total)

    def fwd_op(k: int) -> StageOp:
        chunk = (k // world) % num_chunks
        mb = (k // (world * num_chunks)) * world + k % world
        return StageOp(FWD, mb, chunk)

    def bwd_op(k: int) -> StageOp:
        chunk = num_chunks - 1 - (k // world) % num_chunks
        mb = (k // (world * num_chunks)) * world + k % world
        return StageOp(BWD, mb, chunk)

    ops = [fwd_op(k) for k in range(warmup)]
    for k in range(warmup, total):
        ops.append(fwd_op(k))
        ops.append(bwd_op(k - warmup))
    for k in range(total - warmup, total):
        ops.append(bwd_op(k))
    return tuple(ops)


def bubble_fraction(
    num_stages: int, num_microbatches: int, num_chunks: int = 1
) -> float:
    """The analytic pipeline bubble: the fraction of the steady-state
    critical path spent waiting for the pipe to fill and drain —
    ``(S-1) / (V*M + S-1)``. (The JAX package's planner
    multiplies it into a pp candidate's compute seconds.)"""
    if num_stages < 1 or num_microbatches < 1 or num_chunks < 1:
        raise ValueError(
            f"need S, M, V >= 1, got ({num_stages}, {num_microbatches}, "
            f"{num_chunks})"
        )
    return (num_stages - 1) / (
        num_chunks * num_microbatches + num_stages - 1
    )


def peak_live_microbatches(program: Sequence[StageOp]) -> int:
    """Max concurrently-live microbatches implied by a schedule: a forward
    stashes its input until the matching backward retires it. For 1F1B
    stage ``s`` this is ``min(S - s, M)`` (<= S everywhere); for GPipe it
    is ``M`` at every stage — the accounting behind the memory claim."""
    live = peak = 0
    for op in program:
        if op.kind == FWD:
            live += 1
            peak = max(peak, live)
        elif op.kind == BWD:
            live -= 1
    return peak


def stage_depths(
    num_layers: int,
    num_stages: int,
    rank_rates: Optional[Sequence[float]] = None,
) -> Tuple[int, ...]:
    """Layers per stage. Even split when ``rank_rates`` is None (requires
    divisibility — refusing beats silently unbalancing a homogeneous
    fleet); with per-rank rates, a largest-remainder apportionment
    gives a slow rank a proportionally shallower stage (floor 1 layer)."""
    if num_stages < 1:
        raise ValueError(f"num_stages must be >= 1, got {num_stages}")
    if num_layers < num_stages:
        raise ValueError(
            f"{num_layers} layers cannot fill {num_stages} stages"
        )
    if rank_rates is None:
        if num_layers % num_stages:
            raise ValueError(
                f"{num_layers} layers not divisible by {num_stages} "
                "stages — pass rank_rates to apportion unevenly"
            )
        return (num_layers // num_stages,) * num_stages
    if len(rank_rates) != num_stages:
        raise ValueError(
            f"{len(rank_rates)} rates for {num_stages} stages"
        )
    return tuple(_apportion(num_layers, _quantize_rates(rank_rates)))


def stage_layer_slices(
    depths: Sequence[int],
) -> Tuple[Tuple[int, int], ...]:
    """(start, stop) layer ranges per stage for a depth list."""
    out, start = [], 0
    for d in depths:
        out.append((start, start + d))
        start += d
    return tuple(out)


class ScheduleDeadlock(RuntimeError):
    """Raised by :func:`simulate_links` when no stage can advance."""


def simulate_links(
    programs: Sequence[Sequence[StageOp]], capacity: int = 1
) -> int:
    """Replay per-stage op lists against the stage link's channel model
    (one mailbox per ordered rank pair, ``capacity`` messages in flight:
    ``runtime.distributed.StageLink`` holds exactly one) and return the number of
    round-robin passes to drain. Raises :class:`ScheduleDeadlock` if every
    stage blocks, and ValueError if a receive would consume a message out
    of tag order — the static form of the stage link's debug fingerprint mismatch."""
    num_stages = len(programs)
    pcs = [0] * num_stages
    chans: Dict[Tuple[int, int], List[Tuple[str, int]]] = {}
    passes = 0
    while any(pc < len(programs[s]) for s, pc in enumerate(pcs)):
        progressed = False
        passes += 1
        for s in range(num_stages):
            if pcs[s] >= len(programs[s]):
                continue
            op = programs[s][pcs[s]]
            if op.kind in COMPUTE_KINDS:
                pcs[s] += 1
                progressed = True
                continue
            direction = "act" if op.kind in (RECV_ACT, SEND_ACT) else "grad"
            if op.kind == SEND_ACT:
                pair = (s, s + 1)
            elif op.kind == SEND_GRAD:
                pair = (s, s - 1)
            elif op.kind == RECV_ACT:
                pair = (s - 1, s)
            else:
                pair = (s + 1, s)
            chan = chans.setdefault(pair, [])
            if op.kind in (SEND_ACT, SEND_GRAD):
                if len(chan) < capacity:
                    chan.append((direction, op.mb))
                    pcs[s] += 1
                    progressed = True
            else:
                if chan:
                    if chan[0] != (direction, op.mb):
                        raise ValueError(
                            f"stage {s} expects {direction}.m{op.mb} but "
                            f"channel {pair} holds {chan[0]} — schedule "
                            "would trip the fingerprint handshake"
                        )
                    chan.pop(0)
                    pcs[s] += 1
                    progressed = True
        if not progressed:
            stuck = {
                s: str(programs[s][pc])
                for s, pc in enumerate(pcs) if pc < len(programs[s])
            }
            raise ScheduleDeadlock(
                f"no stage can advance after {passes} passes: {stuck}"
            )
    return passes


def _rank_events(trace) -> List[dict]:
    """The events of one trace: a list of events (``pid`` is the rank, as
    a merged trace has it) or the port's own export
    (``tracing.Tracer.export``: ``traceEvents`` and the rank in
    ``otherData.meta``, whose events get that rank as their ``pid``)."""
    if isinstance(trace, dict):
        rank = trace.get("otherData", {}).get("meta", {}).get("rank", 0)
        return [dict(ev, pid=rank) for ev in trace.get("traceEvents", ())]
    return list(trace)


def pipeline_trace_stats(events) -> Dict[int, Dict[str, float]]:
    """Per-rank busy/bubble/link accounting of a pipeline run's trace:
    ``events`` is a list of chrome-trace events (``pid`` = rank, us), or
    a list of the ranks' own exports (``tracing.Tracer.export`` read back
    with ``json.load``; each export's ``otherData.meta.rank`` is its
    rank).

    For each rank with ``pipeline.fwd``/``pipeline.bwd`` spans:
    ``busy_s`` is their summed duration, ``window_s`` the first-start to
    last-end extent, ``bubble`` the idle fraction ``1 - busy/window``,
    and ``link_s`` the summed ``comm.send``/``comm.recv`` span time (all
    on the serial host loop, so ``link_s/window_s`` is the exposed-link
    ratio)."""
    if events and isinstance(events[0], dict) and "traceEvents" in events[0]:
        events = [ev for doc in events for ev in _rank_events(doc)]
    by_rank: Dict[int, Dict[str, float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = str(ev.get("name", ""))
        if name in ("pipeline.fwd", "pipeline.bwd"):
            key = "busy"
        elif name in ("comm.send", "comm.recv"):
            key = "link"
        else:
            continue
        rank = int(ev.get("pid", 0))
        rec = by_rank.setdefault(
            rank, {"busy": 0.0, "link": 0.0, "t0": float("inf"), "t1": 0.0}
        )
        rec[key] += float(ev.get("dur", 0.0))
        if key == "busy":
            rec["t0"] = min(rec["t0"], float(ev["ts"]))
            rec["t1"] = max(rec["t1"], float(ev["ts"]) + float(ev["dur"]))
    out: Dict[int, Dict[str, float]] = {}
    for rank, rec in sorted(by_rank.items()):
        window = max(rec["t1"] - rec["t0"], 1e-9)
        out[rank] = {
            "busy_s": rec["busy"] / 1e6,
            "link_s": rec["link"] / 1e6,
            "window_s": window / 1e6,
            "bubble": max(0.0, 1.0 - rec["busy"] / window),
        }
    return out


# the JAX train/balance.py's apportionment, for stage_depths' rates
_RATE_RESOLUTION = 1 << 16


def _quantize_rates(rates: Sequence[float]) -> List[int]:
    """Rates -> integers in [1, 2**16], scaled by the max, so that every
    comparison of the apportionment is exact integer arithmetic."""
    rs = [float(r) for r in rates]
    if not rs or any(r <= 0 or not math.isfinite(r) for r in rs):
        raise ValueError(f"rates must be positive finite, got {rates}")
    top = max(rs)
    return [max(1, round(r / top * _RATE_RESOLUTION)) for r in rs]


def _apportion(units: int, weights: Sequence[int],
               floor: int = 1) -> List[int]:
    """Largest-remainder apportionment of ``units`` over integer
    ``weights`` with a per-slot ``floor``; ties by lowest index."""
    n = len(weights)
    if units < n * floor:
        raise ValueError(
            f"{units} unit(s) cannot give {n} rank(s) {floor} each")
    total_w = sum(weights)
    counts = [units * w // total_w for w in weights]
    rem = [units * w % total_w for w in weights]
    left = units - sum(counts)
    for i in sorted(range(n), key=lambda i: (-rem[i], i)):
        if left <= 0:
            break
        counts[i] += 1
        left -= 1
    while True:
        starved = [i for i in range(n) if counts[i] < floor]
        if not starved:
            return counts
        donor = sorted(range(n), key=lambda j: (-counts[j], j))[0]
        if counts[donor] <= floor:
            raise ValueError(f"cannot satisfy floor={floor} for {units} "
                             f"units over {n} ranks")
        counts[donor] -= 1
        counts[starved[0]] += 1


def _check_elementwise(optimizer) -> None:
    """The executor steps each stage's optimizer on that stage's
    parameters alone, so a statistic over the whole model's gradients
    would be this stage's only: refuse the optimizers that take one."""
    from pytorch_distributed_tpu_torch import optim

    if (isinstance(optimizer, optim._ClippedOptimizer)
            and not isinstance(optimizer, optim._ValueClippedOptimizer)):
        raise ValueError(
            "a clip by the global norm spans every stage's gradients; the "
            "host pipeline executor takes elementwise optimizers only")
    if isinstance(optimizer, (optim.Adafactor, optim.LARS, optim.LAMB)):
        raise ValueError(
            f"{type(optimizer).__name__} takes statistics over whole JAX "
            "leaves, whose layers span the stages; the host pipeline "
            "executor takes elementwise optimizers only")


class HostPipelineStep:
    """Host-dispatched pipeline stage executor: one rank, one stage, its
    forward and backward programs, activations and gradients linked over
    a :class:`~pytorch_distributed_tpu_torch.runtime.distributed.StageLink`
    with ``(microbatch, stage, direction)`` tags.

    ``programs`` supplies the stage's math (``parallel/pipeline_lm.py``
    builds GPT-2's) and its ``params``, the tensors ``optimizer`` holds:

    * a non-last stage: ``fwd(xin) -> y`` and ``bwd(xin, dy)``, which
      returns the parameter gradients (the first stage, whose input is
      token ids) or ``(grads, dx)``. The backward recomputes the stage's
      forward, so only the stage input is stashed per live microbatch:
      ``peak_live_microbatches`` is exactly the stash's size.
    * the last stage (``S > 1``): ``loss_grad(head_wte, x, ids) -> (loss,
      grads, head_grad, dx)``, loss and backward in one program; at
      ``S == 1``, ``loss_grad_solo(ids) -> (loss, grads)``.
    * optional ``exchange_grads(link, stage, num_stages, grads,
      aux_grad) -> grads`` and ``exchange_params(link, stage,
      num_stages, buffers)`` hooks for tied weights (GPT-2 pairs the
      first and last stages' ``wte`` over the link); a hook set to None
      is skipped.

    The gradients are left-folded in microbatch order in f32 (the
    backwards retire in increasing microbatch order) and scaled by
    ``1/M`` before the optimizer steps. The optimizer must be elementwise
    (a clip by the global norm, Adafactor, LARS and LAMB raise), as in the
    JAX package. Each compute op runs in a span ``pipeline.fwd`` or
    ``pipeline.bwd`` (``mb``, ``stage``) that waits for the card before
    it ends, after ``pipeline.stage_stall`` is polled and ``delay_s``
    slept (outside the math: a host that overlaps the stages' sleeps
    then behaves as an S-deep pipeline). A step ends with the link
    flushed, so no message is in flight between steps. The JAX executor's
    ``compile_counts`` has no counterpart: the port compiles no
    programs."""

    def __init__(
        self,
        programs,
        *,
        stage: int,
        num_stages: int,
        num_microbatches: int,
        optimizer,
        group=None,
        schedule: str = "1f1b",
        act_template: Optional[torch.Tensor] = None,
        delay_s: float = 0.0,
        ids_key: str = "input_ids",
    ):
        if schedule == "1f1b":
            self.program = schedule_1f1b(stage, num_stages, num_microbatches)
        elif schedule == "gpipe":
            self.program = schedule_gpipe(
                stage, num_stages, num_microbatches)
        else:
            raise ValueError(
                f"schedule must be '1f1b' or 'gpipe', got {schedule!r}")
        if num_stages > 1 and group is None:
            raise ValueError("num_stages > 1 needs a stage link (group=)")
        if num_stages > 1 and act_template is None:
            raise ValueError("num_stages > 1 needs an act_template buffer")
        _check_elementwise(optimizer)
        from torch.distributed.tensor import DTensor

        if any(isinstance(p, DTensor) for p in getattr(programs, "params",
                                                       ())):
            raise NotImplementedError(
                "the host pipeline executor runs whole (tp 1) stages: "
                "tensor parallelism composes with pp in the GPipe form "
                "(parallel.pipeline_lm.PipelineParallel), as the JAX "
                "executor has no tp either")
        self.stage = stage
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.link = group
        self.delay_s = float(delay_s)
        self.ids_key = ids_key
        self.programs = programs
        self.optimizer = optimizer
        self._first = stage == 0
        self._last = stage == num_stages - 1
        self._act = act_template
        # fault paths precomputed, as the JAX executor's
        self._paths = tuple(
            f"s{stage}.{op.kind}.m{op.mb}" for op in self.program)

    # -- internals ----------------------------------------------------------
    def _pause(self, path):
        from pytorch_distributed_tpu_torch.runtime import faults

        faults.check("pipeline.stage_stall", path)
        act = faults.hang_action("pipeline.stage_stall", path)
        if act is not None:
            time.sleep(act[1])
        if self.delay_s > 0.0:
            time.sleep(self.delay_s)

    def _recv(self, src, tag):
        got = self.link.recv(self._act, src, tag=tag)
        return got.to(self.programs.device, non_blocking=True)

    def _split(self, batch) -> List[dict]:
        device = self.programs.device
        out = [{} for _ in range(self.num_microbatches)]
        for k, v in batch.items():
            v = torch.as_tensor(v)
            n = v.shape[0]
            if n % self.num_microbatches:
                raise ValueError(f"batch dim {n} not divisible by "
                                 f"{self.num_microbatches} microbatches")
            for i, part in enumerate(v.chunk(self.num_microbatches)):
                out[i][k] = part.to(device)
        return out

    @staticmethod
    def _fold(acc, grads):
        """Left fold in f32, in the order the backwards retire."""
        if acc is None:
            return [g.detach().to(torch.float32, copy=True) for g in grads]
        for a, g in zip(acc, grads):
            a.add_(g)
        return acc

    def _block(self):
        if self.programs.device.type == "cuda":
            torch.cuda.synchronize(self.programs.device)

    def step(self, batch, buffers=None) -> Dict[str, float]:
        """One optimizer step over ``batch`` (a dict of ``[B, ...]``
        tensors or arrays, split into ``M`` row blocks); returns the
        metrics (``loss``, the mean of the last stage's microbatch losses,
        on the last stage). ``buffers`` carries the tensors the optimizer
        does not step (the last stage's ``head_wte``), refreshed through
        ``exchange_params``."""
        from pytorch_distributed_tpu_torch.runtime import tracing

        progs = self.programs
        mbs = self._split(batch)
        stash: Dict[object, torch.Tensor] = {}
        dys: Dict[int, torch.Tensor] = {}
        dxs: Dict[int, torch.Tensor] = {}
        acc = aux = None
        losses: List[torch.Tensor] = []
        st = self.stage
        for op, path in zip(self.program, self._paths):
            mb = op.mb
            if op.kind == RECV_ACT:
                stash[mb] = self._recv(st - 1, tag=f"act.m{mb}.s{st}")
            elif op.kind == SEND_ACT:
                self.link.send(stash.pop((SEND_ACT, mb)), st + 1,
                               tag=f"act.m{mb}.s{st + 1}")
            elif op.kind == RECV_GRAD:
                dys[mb] = self._recv(st + 1, tag=f"grad.m{mb}.s{st}")
            elif op.kind == SEND_GRAD:
                self.link.send(dxs.pop(mb), st - 1,
                               tag=f"grad.m{mb}.s{st - 1}")
            elif op.kind == FWD:
                with tracing.span("pipeline.fwd", mb=mb, stage=st):
                    self._pause(path)
                    if self._last:
                        # the forward runs inside the last stage's
                        # loss_grad; this slot admits the microbatch
                        if self._first:
                            stash[mb] = mbs[mb][self.ids_key]
                        continue
                    xin = (mbs[mb][self.ids_key] if self._first
                           else stash.pop(mb))
                    stash[mb] = xin   # retired by the matching BWD
                    stash[(SEND_ACT, mb)] = progs.fwd(xin).cpu()
            else:  # BWD
                with tracing.span("pipeline.bwd", mb=mb, stage=st):
                    self._pause(path)
                    if self.num_stages == 1:
                        loss, grads = progs.loss_grad_solo(stash.pop(mb))
                    elif self._last:
                        loss, grads, head_grad, dx = progs.loss_grad(
                            buffers["head_wte"], stash.pop(mb),
                            mbs[mb][self.ids_key])
                        aux = self._fold(aux, [head_grad])
                        dxs[mb] = dx.cpu()
                    elif self._first:
                        grads = progs.bwd(stash.pop(mb), dys.pop(mb))
                    else:
                        grads, dx = progs.bwd(stash.pop(mb), dys.pop(mb))
                        dxs[mb] = dx.cpu()
                    acc = self._fold(acc, grads)
                    if self._last:
                        losses.append(loss.detach())
                    self._block()
        if stash or dys or dxs:
            raise AssertionError(
                f"stage {st} retired the schedule with live state: "
                f"{list(stash)} {list(dys)} {list(dxs)}")
        if (self.link is not None
                and getattr(progs, "exchange_grads", None) is not None):
            acc = progs.exchange_grads(self.link, st, self.num_stages, acc,
                                       aux[0] if aux else None)
        inv = 1.0 / self.num_microbatches
        for p, g in zip(progs.params, acc):
            p.grad = g.mul_(inv).to(p.dtype)
        self.optimizer.step()
        for p in progs.params:
            p.grad = None
        if (self.link is not None
                and getattr(progs, "exchange_params", None) is not None):
            progs.exchange_params(self.link, st, self.num_stages, buffers)
        if self.link is not None:
            # a step leaves nothing in flight: a send whose work were
            # dropped before its peer posted the receive would never land
            self.link.flush()
        metrics = {}
        if losses:
            metrics["loss"] = float(np.mean([float(x) for x in losses]))
        return metrics
