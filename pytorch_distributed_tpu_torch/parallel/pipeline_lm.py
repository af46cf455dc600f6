"""Pipeline-parallel GPT-2: the port of
``pytorch_distributed_tpu/parallel/pipeline_lm.py``.

Two forms, as in the JAX package:

* **GPipe** (:func:`gpt2_pipeline_logits`, :func:`pipelined_causal_lm_loss_fn`,
  :class:`PipelineParallel`): each rank of the ``pp`` axis holds one
  stage, ``L / pp`` consecutive layers (``pipeline_stage`` on the model;
  the JAX package shards the stacked layer dim ``P("pp")``), and the
  block stack runs through the tick loop of ``parallel/pipeline.py``.
  The embeddings, ``ln_f`` and the tied head are replicated and run on
  every stage. The embedding output enters the pipeline through
  ``sum_grad`` over ``pp``, so every stage's ``wte``/``wpe`` receive stage
  0's cotangent (the transpose of the JAX replicated ``in_specs``) and
  the replicas never drift apart; the head's gradient each stage computes
  whole from the replicated outputs. The Trainer trains it as any model:
  the loss follows the port's ``loss_fn(batch, generator)`` contract, and
  the step averages a stage's gradients over its data replicas only
  (``model.data_grad_group``: a world-wide mean would add different
  stages' layers together).
* **Host-dispatched 1F1B** (:class:`GPT2HostStagePrograms` and the
  ``host_*`` helpers, driven by ``pipeline_schedule.HostPipelineStep``):
  stage 0 owns ``wte`` and ``wpe``, the last stage ``ln_f`` and a
  ``head_wte`` replica of ``wte`` for the tied head, whose gradient
  travels to stage 0 and whose value comes back after every step over
  the stage link (``tied.wte.grad``, ``tied.wte.param``).

Blocks run with dropout off inside the pipeline, as in the JAX package.
The embed/``ln_f``/tied-head math mirrors ``GPT2LMHead.forward``
(``models/gpt2.py``). With ``tp > 1`` (the JAX ``_PipelineRules``: the
stage dim and the TP spec both kept) each stage's layers, and the
replicated embeddings, are TP-sharded by ``extra_rules`` over the mesh's
``tp`` dim: the blocks' all-reduces run over ``tp`` inside each tick
while the hand-offs run over ``pp`` in the same order on every stage.
The host executor stays at tp 1 (``HostPipelineStep`` refuses sharded
stages).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.parallel.pipeline import (
    group_coordinate,
    merge_microbatches,
    pipeline_ticks,
    split_microbatches,
)
from pytorch_distributed_tpu_torch.parallel.pipeline_schedule import (
    stage_depths,
)
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime.device import (
    DeviceLike,
    resolve_device,
)
from pytorch_distributed_tpu_torch.runtime.mesh import (
    MeshSpec,
    data_rank,
    make_mesh,
)


@dataclasses.dataclass(frozen=True)
class StageLayout:
    """Where a pipeline stage sits: stage ``stage`` of ``num_stages`` over
    ``group`` (the ``pp`` group; None at one stage), holding layers
    ``[start, stop)`` of ``num_layers``. ``writer``: this rank writes the
    stage's layers in a checkpoint (the first of its data replicas)."""

    stage: int
    num_stages: int
    start: int
    stop: int
    num_layers: int
    group: object = None
    writer: bool = True

    @property
    def layers(self) -> Tuple[int, int]:
        return self.start, self.stop


def _block_stage_fn(blocks) -> Callable:
    """``stage_fn(x) -> y`` for the tick loop: this stage's blocks, in
    order, with dropout off."""

    def stage_fn(x):
        for block in blocks:
            x = block(x, None, train=False, generator=None)
        return x

    return stage_fn


def _stage_blocks(model, pp: int, stage: int):
    """The blocks stage ``stage`` of ``pp`` runs: a stage model's own
    (``pipeline_stage``), or its share of a whole model's."""
    layout = getattr(model, "pipeline_stage", None)
    L = model.config.num_layers
    if L % pp:
        raise ValueError(f"{L} layers not divisible by {pp} pipeline stages")
    if layout is not None:
        if layout.num_stages != pp:
            raise ValueError(f"a stage of {layout.num_stages} stages run "
                             f"over {pp}")
        return model.blocks
    per = L // pp
    return model.blocks[stage * per:(stage + 1) * per]


def _embed(model, ids):
    """Token plus position embeddings in the compute dtype (no dropout:
    the pipeline runs deterministic)."""
    pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
    x = model.wte(ids) + model.wpe(pos)
    return x.to(model.policy.compute_dtype)


def _head(model, x, head_wte=None):
    """``ln_f`` then the tied head, f32 logits (``GPT2LMHead.forward``'s
    tail)."""
    from pytorch_distributed_tpu_torch.models.gpt2 import tied_logits

    w = model.wte.weight if head_wte is None else head_wte
    return tied_logits(model.ln_f(x), w, model.policy.compute_dtype)


def _shift_ce(logits, ids):
    """Mean next-token cross-entropy in f32."""
    shift = logits[:, :-1].float()
    return F.cross_entropy(shift.reshape(-1, shift.shape[-1]),
                           ids[:, 1:].reshape(-1).long())


def _pp_group(model, group):
    layout = getattr(model, "pipeline_stage", None)
    if group is None and layout is not None:
        return layout.group
    return group


def gpt2_pipeline_logits(model, input_ids: torch.Tensor, *,
                         num_microbatches: int, group=None) -> torch.Tensor:
    """[B, S] ids -> [B, S, vocab] logits in the policy's output dtype,
    the block stack pipelined over ``group`` (the stage's own
    ``pipeline_stage.group`` unless given; None with no stage: one stage).
    ``model`` is a ``GPT2LMHead``: a stage (``PipelineParallel.wrap``) or
    a whole model, of which each stage runs its ``L / pp`` layers; ``L``
    not divisible by the stage count raises ``ValueError``."""
    group = _pp_group(model, group)
    stage, pp = group_coordinate(group) if group is not None else (0, 1)
    blocks = _stage_blocks(model, pp, stage)
    x = _embed(model, input_ids)
    if pp > 1:
        # every stage embeds; stage 0's cotangent is the one, summed to all
        x = dist.sum_grad(x, group)
    y = pipeline_ticks(_block_stage_fn(blocks),
                       split_microbatches(x, num_microbatches), group=group)
    logits = _head(model, merge_microbatches(y))
    return logits.to(model.policy.output_dtype)


def pipelined_causal_lm_loss_fn(model, *, num_microbatches: int,
                                group=None,
                                ids_key: str = "input_ids") -> Callable:
    """The Trainer's ``loss_fn(batch, generator) -> (loss, aux)``:
    next-token cross-entropy (f32, the mean over every target) through
    :func:`gpt2_pipeline_logits`, in place of ``causal_lm_loss_fn``.
    Packed batches (``segment_ids``) raise ``NotImplementedError``:
    ignoring them would attend across documents. The generator is unused
    (the pipeline runs dropout-free)."""

    def loss_fn(batch, generator):
        if "segment_ids" in batch:
            raise NotImplementedError(
                "packed batches (segment_ids) are not supported through "
                "the pipelined loss: ignoring them would attend across "
                "document boundaries")
        ids = batch[ids_key]
        logits = gpt2_pipeline_logits(model, ids,
                                      num_microbatches=num_microbatches,
                                      group=group)
        loss = _shift_ce(logits, ids)
        return loss, {"metrics": {"loss": loss.detach()}}

    return loss_fn


def pipelined_causal_lm_eval_step(model, *, num_microbatches: int,
                                  group=None,
                                  ids_key: str = "input_ids") -> Callable:
    """``eval_step(state, batch) -> metrics`` through the pipelined
    forward, without gradients: the mean next-token loss and its
    ``perplexity``."""

    @torch.no_grad()
    def eval_step(state, batch) -> Dict[str, torch.Tensor]:
        ids = batch[ids_key]
        logits = gpt2_pipeline_logits(model, ids,
                                      num_microbatches=num_microbatches,
                                      group=group)
        loss = _shift_ce(logits, ids)
        return {"loss": loss, "perplexity": torch.exp(loss)}

    return eval_step


class PipelineParallel:
    """GPT-2's GPipe strategy over the mesh ``mesh_spec`` (every rank a
    stage unless given): each rank of the ``pp`` axis holds its stage's
    ``L / pp`` layers, the embeddings and ``ln_f`` replicated, the batch
    split over the data axes (``dp`` and ``fsdp``: every stage of one
    pipeline reads the same rows).

    :meth:`wrap` takes a ``GPT2LMHead`` built on the meta device, keeps
    this stage's layers and allocates only them: no rank holds another
    stage's layers. Then ``init_weights`` draws the whole model's weights
    (``models/gpt2.py``), or a checkpoint restores them. Its gradients
    are averaged over the data axes only. At ``tp > 1`` the
    ``extra_rules`` (``gpt2_partition_rules()``) shard the stage over
    the mesh's ``tp`` dim as ``parallel.DataParallel`` shards a whole
    model."""

    def __init__(self, device: DeviceLike = None, *,
                 mesh_spec: MeshSpec = MeshSpec(dp=1, pp=-1),
                 extra_rules=None):
        from pytorch_distributed_tpu_torch.parallel.sequence import axis_group
        from pytorch_distributed_tpu_torch.parallel.strategies import (
            _axes_group,
        )

        if not dist.is_initialized():
            raise RuntimeError(
                "PipelineParallel needs a process group: call "
                "runtime.distributed.init_process_group() first")
        self.device = resolve_device(device)
        self.spec = mesh_spec.resolve(dist.get_world_size())
        if self.spec.tp > 1 and extra_rules is None:
            raise ValueError(
                f"tp={self.spec.tp} needs the model's partition rules "
                "(extra_rules=gpt2_partition_rules())")
        self.rules = extra_rules
        if self.spec.ep > 1 or self.spec.sp > 1:
            raise ValueError(
                f"{self.spec}: the pipelined GPT-2 runs dense blocks on "
                "whole rows; pp composes with dp and fsdp only")
        self.mesh = make_mesh(self.spec, self.device.type)
        self.group, self.num_stages, self.stage = axis_group("pp", self.mesh)
        data = tuple(a for a in ("dp", "fsdp") if getattr(self.spec, a) > 1)
        self.data_group = _axes_group(self.mesh, data) if data else None

    def wrap(self, model: torch.nn.Module) -> torch.nn.Module:
        """Make ``model`` (a ``GPT2LMHead``, on the meta device or this
        rank's) this rank's stage, in place, on the strategy's device;
        returns it. ``L`` not divisible by the stage count raises."""
        from torch import nn

        L = model.config.num_layers
        if L % self.num_stages:
            raise ValueError(f"{L} layers not divisible by "
                             f"{self.num_stages} pipeline stages")
        per = L // self.num_stages
        start = self.stage * per
        model.blocks = nn.ModuleList(list(model.blocks)[start:start + per])
        model.pipeline_stage = StageLayout(
            self.stage, self.num_stages, start, start + per, L,
            self.group if self.num_stages > 1 else None,
            writer=data_rank()[0] == 0)
        if self.spec.tp > 1:
            from pytorch_distributed_tpu_torch.parallel.strategies import (
                apply_tp,
            )

            apply_tp(model, model.blocks, self.rules, self.spec,
                     self.mesh["tp"])
        if any(p.is_meta for p in model.parameters()):
            model.to_empty(device=self.device)
        else:
            model.to(self.device)
        if self.num_stages > 1:
            # the global norm counts each stage's layers once
            for p in model.blocks.parameters():
                p.grad_norm_group = self.group
        model.data_grad_group = self.data_group
        return model

    def batch_sharding(self) -> torch.device:
        """The loader's ``sharding``: batches go to this device; the
        loader keeps this rank's data share."""
        return self.device

    def shard_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's share of a global host batch (its ``(dp, fsdp)``
        coordinate's rows), on the device."""
        import numpy as np

        from pytorch_distributed_tpu_torch.data.loader import rank_slice

        rank, world = data_rank()
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            if world > 1:
                v = np.ascontiguousarray(rank_slice(v, rank, world))
            out[k] = torch.from_numpy(v).to(self.device)
        return out


@torch.no_grad()
def gather_stages(model) -> torch.nn.Module:
    """A whole ``GPT2LMHead`` on every stage from the stages' layers,
    gathered over the ``pp`` group (and each TP-sharded tensor over
    ``tp`` first, its rows back in the whole model's order): the
    recipe's closing ``--sample``."""
    from pytorch_distributed_tpu_torch.models.gpt2 import GPT2LMHead
    from pytorch_distributed_tpu_torch.runtime.mesh import whole_tensor

    layout = getattr(model, "pipeline_stage", None)
    if layout is None:
        return model
    whole = GPT2LMHead(model.config, device=model.device,
                       policy=model.policy)
    own = {n: model.whole_rows(n, whole_tensor(p))
           for n, p in model.named_parameters()}
    for name, p in whole.named_parameters():
        if not name.startswith("blocks."):
            p.copy_(own[name])
    per = layout.stop - layout.start
    for name, _ in model.blocks.named_parameters():
        p = own[f"blocks.{name}"]
        i, sub = name.split(".", 1)
        parts = [torch.empty_like(p) for _ in range(layout.num_stages)]
        if layout.num_stages > 1:
            torch.distributed.all_gather(parts, p.contiguous(),
                                         group=layout.group)
        else:
            parts = [p]
        for s, part in enumerate(parts):
            whole.get_parameter(f"blocks.{s * per + int(i)}.{sub}").copy_(
                part)
    return whole


# -- host-dispatched stages --------------------------------------------------
# The 1F1B executor's GPT-2 bridge: a stage of a whole model, and the
# stage's programs pipeline_schedule.HostPipelineStep runs.


def host_stage_depths(num_layers: int, num_stages: int,
                      rank_rates: Optional[Sequence[float]] = None
                      ) -> Tuple[int, ...]:
    """Layers per stage: even, or apportioned by rate (a slow rank gets a
    shallower stage; ``pipeline_schedule.stage_depths``)."""
    return stage_depths(num_layers, num_stages, rank_rates)


class GPT2Stage(torch.nn.Module):
    """One host stage of a ``GPT2LMHead``: its ``blocks`` (layers
    ``[start, stop)``), ``wte``/``wpe`` on the first stage, ``ln_f`` on the
    last. It holds the model's own tensors (no copy)."""

    def __init__(self, model, start: int, stop: int, first: bool,
                 last: bool):
        super().__init__()
        self.config = model.config
        self.policy = model.policy
        self.start, self.stop = start, stop
        if first:
            self.wte, self.wpe = model.wte, model.wpe
        self.blocks = torch.nn.ModuleList(list(model.blocks)[start:stop])
        if last:
            self.ln_f = model.ln_f

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def host_stage_params(model, *, stage: int, num_stages: int,
                      depths: Optional[Sequence[int]] = None):
    """``(stage_module, buffers)``: stage ``stage``'s :class:`GPT2Stage` of
    ``model`` (a ``GPT2LMHead``) and its tensors the optimizer does not
    step. Stage 0 owns ``wte``/``wpe`` (and the tied ``wte``'s optimizer
    state); the last owns ``ln_f`` and carries ``buffers["head_wte"]``, a
    replica of ``wte`` for the tied head, refreshed after every step by
    ``exchange_params`` (at one stage the head ties directly, as in the
    plain model)."""
    L = model.config.num_layers
    if depths is None:
        depths = host_stage_depths(L, num_stages)
    if sum(depths) != L:
        raise ValueError(f"depths {tuple(depths)} do not cover {L} layers")
    start = sum(depths[:stage])
    first, last = stage == 0, stage == num_stages - 1
    module = GPT2Stage(model, start, start + depths[stage], first, last)
    buffers = {}
    if last and not first:
        buffers["head_wte"] = model.wte.weight.detach().clone()
    return module, buffers


def host_merge_stage_params(stage_dicts: Sequence[Dict[str, torch.Tensor]],
                            depths: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`host_stage_params`: the whole ``GPT2LMHead``
    state_dict from every stage's ``GPT2Stage`` state_dict (the parity
    checks' gather)."""
    if len(stage_dicts) != len(depths):
        raise ValueError(f"{len(stage_dicts)} stages vs {len(depths)} depths")
    out = {}
    for s, sd in enumerate(stage_dicts):
        start = sum(depths[:s])
        for name, t in sd.items():
            if name.startswith("blocks."):
                i, sub = name[len("blocks."):].split(".", 1)
                out[f"blocks.{start + int(i)}.{sub}"] = t
            elif name.startswith(("wte.", "wpe.")) and s == 0:
                out[name] = t
            elif name.startswith("ln_f.") and s == len(depths) - 1:
                out[name] = t
    return out


def host_act_template(cfg, microbatch_size: int, seq_len: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """The receive prototype of the stage-boundary activations and their
    gradients: ``[mb, seq, hidden]`` host zeros in the compute dtype."""
    return torch.zeros(microbatch_size, seq_len, cfg.hidden_size,
                       dtype=dtype)


class GPT2HostStagePrograms:
    """Per-stage forward and backward programs for ``HostPipelineStep``
    over a :class:`GPT2Stage`.

    The backward recomputes the stage forward with autograd on and
    backpropagates (only the stage input is stashed per live
    microbatch); the last stage runs loss and backward as one program.
    Blocks run with dropout off; the loss is the pipelined loss's. The
    tied head: the last stage projects with its ``head_wte`` replica, its
    gradient goes to stage 0 over the link (``exchange_grads``), where it
    joins the embedding gradient (the two tied contributions a whole
    model sums in one backward, here added across stages: last-ulp
    differences), and stage 0's stepped ``wte`` comes back
    (``exchange_params``)."""

    def __init__(self, module: GPT2Stage, *, stage: int, num_stages: int):
        self.module = module
        self.params: List[torch.nn.Parameter] = list(module.parameters())
        self.device = module.device
        self.first = stage == 0
        self.last = stage == num_stages - 1
        self._stage_fn = _block_stage_fn(module.blocks)
        if self.first:
            self._wte_index = next(i for i, p in enumerate(self.params)
                                   if p is module.wte.weight)

    def _body(self, xin):
        m = self.module
        x = (_embed(m, xin) if self.first
             else xin.to(m.policy.compute_dtype))
        return self._stage_fn(x)

    def loss_grad_solo(self, ids):
        """One stage: loss and every parameter's gradient."""
        with torch.enable_grad():
            loss = _shift_ce(_head(self.module, self._body(ids)), ids)
            grads = torch.autograd.grad(loss, self.params)
        return loss.detach(), grads

    def loss_grad(self, head_wte, x, ids):
        """The last stage: ``(loss, grads, head_grad, dx)``."""
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            hw = head_wte.detach().requires_grad_(True)
            loss = _shift_ce(_head(self.module, self._body(x), hw), ids)
            *grads, ghw, dx = torch.autograd.grad(loss,
                                                  self.params + [hw, x])
        return loss.detach(), grads, ghw, dx

    @torch.no_grad()
    def fwd(self, xin):
        return self._body(xin)

    def bwd(self, xin, dy):
        """The stage's gradients (and ``dx`` after the first stage), the
        forward recomputed."""
        with torch.enable_grad():
            if not self.first:
                xin = xin.detach().requires_grad_(True)
            y = self._body(xin)
            wrt = self.params if self.first else self.params + [xin]
            out = torch.autograd.grad(y, wrt, dy.to(y.dtype))
        if self.first:
            return out
        return out[:-1], out[-1]

    # -- tied-wte pairing (first <-> last stage, over the link) -------------
    def exchange_grads(self, link, stage, num_stages, grads, aux_grad):
        if num_stages == 1:
            return grads
        last = num_stages - 1
        if stage == last:
            link.send(aux_grad.cpu(), 0, tag="tied.wte.grad")
        elif stage == 0:
            emb = grads[self._wte_index]
            got = link.recv(torch.empty(emb.shape, dtype=emb.dtype), last,
                            tag="tied.wte.grad")
            emb.add_(got.to(emb.device))
        return grads

    def exchange_params(self, link, stage, num_stages, buffers):
        if num_stages == 1:
            return
        last = num_stages - 1
        if stage == 0:
            link.send(self.module.wte.weight.detach().cpu(), last,
                      tag="tied.wte.param")
        elif stage == last:
            hw = buffers["head_wte"]
            hw.copy_(link.recv(torch.empty(hw.shape, dtype=hw.dtype), 0,
                               tag="tied.wte.param"))
