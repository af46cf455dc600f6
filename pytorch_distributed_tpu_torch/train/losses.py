"""Losses and metrics: the port of ``causal_lm_loss_fn`` (full logits
or the chunked-vocab loss of ``ops/lm_loss.py``), ``causal_lm_eval_step``,
the classifier losses, ``text_classification_loss_fn``,
``masked_lm_loss_fn``, and the encoder-decoder ``seq2seq_lm_loss_fn``
and ``seq2seq_eval_step`` in ``pytorch_distributed_tpu/train/losses.py``,
and of its MixUp/CutMix (``mixup_cutmix``, split into its draws and its
mixing, and ``mixup_classification_loss_fn``), ``distillation_loss_fn``,
``text_classification_eval_step`` and ``f1_finalize``.

A loss function here is ``loss_fn(batch, generator) -> (loss, aux)``
with ``aux = {"metrics": {...}}``. It closes over the module, whose
parameters are the leaves the JAX loss takes as ``params`` (PyTorch
updates them in place), and ``generator`` feeds the dropout masks. A
classifier's BatchNorm running statistics, which the JAX loss returns
as ``aux["batch_stats"]``, are buffers of the module that its train-mode
forward updates in place.

Under sequence parallelism (``parallel.sequence_parallel``) the
causal-LM losses take this rank's positions of each whole row
(``parallel.sequence.sequence_shard``: the labels shifted on the whole
row before the split), and the loss is this rank's sum of token losses
over the token count summed over ``sp``: the ``sp`` ranks' losses add up
to the whole rows' mean, and so do their gradients, which the train step
sums over ``sp`` (``parallel.FSDP``). The ``loss`` metric is that sum.
Under tensor parallelism the chunked loss gathers the vocab-sharded head
whole for its products (one ``[V, D]`` copy a rank, 2.1 GB in f32 at
Llama-3-8B's 128256 x 4096).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.data.packing import packed_loss_mask
from pytorch_distributed_tpu_torch.ops.moe import collect_aux_loss
from pytorch_distributed_tpu_torch.ops.lm_loss import (
    causal_lm_chunked_loss,
    chunked_softmax_cross_entropy,
)
from pytorch_distributed_tpu_torch.parallel.sequence import sequence_shard


def masked_token_mean(tok_loss: torch.Tensor, segment_ids) -> torch.Tensor:
    """Mean of per-token losses; packed batches average over valid
    targets only (document boundaries and padding excluded by
    ``packed_loss_mask``)."""
    if segment_ids is None:
        return tok_loss.mean()
    valid = packed_loss_mask(segment_ids).to(tok_loss.dtype)
    return (tok_loss * valid).sum() / torch.clamp(valid.sum(), min=1.0)


#: attributes that look like an untied head under a name
#: :func:`_lm_projection_weight` does not know: with one present the tied
#: ``embed`` fallback would project through the wrong weight
_HEAD_LIKE = ("head", "lm_out", "output_projection", "embed_out")


def _lm_projection_weight(model, tied: Optional[bool] = None):
    """``(projection, vocab_axis)`` of an LM's head in the weight's own
    layout: GPT-2's tied ``wte`` ``[V, D]``, an untied ``lm_head`` or
    NeoX's ``embed_out`` (``nn.Linear``, ``[V, D]`` too: ``vocab_axis`` 0
    in the port, where the JAX kernel is ``[D, V]``), or a tied Llama
    body's ``embed`` ``[V, D]``. The tied ``embed`` fallback refuses
    when ``tied`` says untied or a head-like attribute exists, as the
    JAX resolver does: the loss would train against the wrong logits
    without an error."""
    model = getattr(model, "module", model)
    if hasattr(model, "wte"):
        return model.wte.weight, 0
    if getattr(model, "lm_head", None) is not None:
        return model.lm_head.weight, 0
    if hasattr(model, "embed_out"):   # NeoX/Pythia: untied, [V, D]
        return model.embed_out.weight, 0
    if hasattr(model, "embed"):   # a tied Llama body: lm_head is None
        head_like = [k for k in _HEAD_LIKE if hasattr(model, k)]
        if tied is False or (tied is None and head_like):
            reason = (f"head-like attributes {head_like} exist" if head_like
                      else "the model reports tie_word_embeddings=False")
            raise ValueError(
                f"refusing the tied 'embed' projection: {reason}; the "
                "chunked-vocab loss would use tied-embedding logits for an "
                "untied model (pass vocab_chunk_size=None)")
        return model.embed.weight, 0
    raise ValueError(
        "model has neither a tied 'wte'/'embed' embedding nor an 'lm_head'; "
        "pass vocab_chunk_size=None")


def _packed_extra(batch) -> dict:
    seg = batch.get("segment_ids")
    if seg is None:
        return {}
    extra = {"segment_ids": seg}
    if "positions" in batch:
        extra["positions"] = batch["positions"]
    return extra


def _lm_head_for_loss(core):
    """``(head weight, vocab axis)`` of an LM whose root FSDP has
    unsharded: a head still cut over ``tp`` alone is gathered whole
    (differentiably); one cut over any other axis raises."""
    from torch.distributed.tensor import DTensor

    weight, axis = _lm_projection_weight(
        core, tied=getattr(getattr(core, "config", None),
                           "tie_word_embeddings", None))
    if isinstance(weight, DTensor):
        if tuple(weight.device_mesh.mesh_dim_names or ()) != ("tp",):
            raise RuntimeError(
                "the LM head is still sharded after unshard(): the chunked "
                "loss would multiply by this rank's rows only")
        weight = weight.full_tensor()
    return weight, axis


def _sp_mean(tok_sum, count, group):
    """This rank's share of the whole rows' mean: its token-loss sum over
    the token count summed over the ``sp`` group; and that mean (the sum
    of the shares), detached, for the metric."""
    total = count.detach().clone()
    torch.distributed.all_reduce(total, group=group)
    loss = tok_sum / total
    whole = loss.detach().clone()
    torch.distributed.all_reduce(whole, group=group)
    return loss, whole


def _apply_with_moe_aux(model, ids, kw, moe_aux_weight: float):
    """``model(ids, **kw)`` and, with ``moe_aux_weight > 0``, the weighted
    sum of its layers' mixture-of-experts load losses (returned through
    its outputs; zero for a model without experts), else None: the one
    definition the full-logits and chunked losses share."""
    if moe_aux_weight <= 0.0:
        return model(ids, **kw), None
    if sequence_shard(ids) is not None:
        raise NotImplementedError(
            "mixture-of-experts load losses under sequence parallelism "
            "(each sp rank routes its own positions; ROADMAP A10.2)")
    out, aux = model(ids, return_aux=True, **kw)
    return out, collect_aux_loss([aux], moe_aux_weight).to(out.device)


def _chunked_lm_loss(model, ids, chunk_size, batch, *, train: bool,
                     generator=None, attn_impl=None,
                     moe_aux_weight: float = 0.0):
    """The chunked loss's shared train/eval body: the model's hidden
    states in the compute dtype, projected chunk by chunk through the
    head in its own layout; ``(loss, metric)``.

    Under FSDP the head is read after the model's forward, outside any
    FSDP-managed call: the root is unsharded explicitly first
    (``FSDPModule.unshard``, a no-op when FSDP2 kept the root gathered
    after its forward), so the chunks multiply by the whole gathered
    head, and its gradient lands on the unsharded parameter, which the
    root's post-backward reduce-scatters with the others. With
    ``moe_aux_weight`` returns ``(loss, metric, aux)``."""
    from torch.distributed.fsdp import FSDPModule

    core = getattr(model, "module", model)
    kw = dict(train=train, return_hidden=True, attn_impl=attn_impl,
              **_packed_extra(batch))
    if train:
        kw["generator"] = generator
    shard = sequence_shard(ids)
    if shard is not None:
        _refuse_packed_sequence_shards(batch)
        ids, labels, kw["positions"], group = shard
    hidden, aux = _apply_with_moe_aux(model, ids, kw, moe_aux_weight)
    if isinstance(core, FSDPModule):
        core.unshard()
    weight, axis = _lm_head_for_loss(core)
    hidden = hidden.to(core.policy.compute_dtype)
    if shard is None:
        loss = causal_lm_chunked_loss(
            hidden, weight, ids, chunk_size=chunk_size, vocab_axis=axis,
            segment_ids=batch.get("segment_ids"))
        return loss, loss.detach(), aux
    n = labels.shape[1]
    h = hidden[:, :n].reshape(-1, hidden.shape[-1])
    count = torch.tensor(float(labels.numel()), device=hidden.device)
    tok_sum = chunked_softmax_cross_entropy(
        h, weight, labels.reshape(-1), chunk_size=chunk_size,
        vocab_axis=axis) * count
    return (*_sp_mean(tok_sum, count, group), aux)


def _refuse_packed_sequence_shards(batch) -> None:
    if batch.get("segment_ids") is not None:
        raise NotImplementedError(
            "packed (segment_ids) rows are not supported inside "
            "sequence-parallel mode")


def _full_lm_loss(model, ids, batch, *, train: bool, generator=None,
                  attn_impl=None, moe_aux_weight: float = 0.0):
    """The full-logits loss's shared train/eval body; ``(loss, metric,
    aux)``, ``aux`` the weighted MoE load loss or None."""

    kw = dict(train=train, attn_impl=attn_impl, **_packed_extra(batch))
    if train:
        kw["generator"] = generator
    shard = sequence_shard(ids)
    if shard is None:
        labels = ids[:, 1:].long()
    else:
        _refuse_packed_sequence_shards(batch)
        ids, labels, kw["positions"], group = shard
        labels = labels.long()
    logits, aux = _apply_with_moe_aux(model, ids, kw, moe_aux_weight)
    shift_logits = logits[:, :labels.shape[1]].float()
    tok_loss = F.cross_entropy(
        shift_logits.reshape(-1, shift_logits.shape[-1]),
        labels.reshape(-1), reduction="none",
    ).reshape(labels.shape)
    if shard is None:
        loss = masked_token_mean(tok_loss, batch.get("segment_ids"))
        return loss, loss.detach(), aux
    count = torch.tensor(float(labels.numel()), device=logits.device)
    return (*_sp_mean(tok_loss.sum(), count, group), aux)


def causal_lm_loss_fn(
    model,
    *,
    ids_key: str = "input_ids",
    moe_aux_weight: float = 0.0,
    vocab_chunk_size: Optional[int] = None,
    attn_impl: Optional[str] = None,
) -> Callable:
    """Next-token cross-entropy (shift by one, f32), averaged over every
    target or, for packed batches (``segment_ids`` and ``positions`` from
    ``data.pack_documents``), over the targets inside one document.
    ``vocab_chunk_size`` runs the model with ``return_hidden=True`` and
    takes the chunked-vocab loss (``ops/lm_loss.py``), which never forms
    the ``[B, S, V]`` logits. ``attn_impl`` is passed to the model
    (``None``: flash on the card). ``model`` may be the module or its
    ``DistributedDataParallel`` wrapper. ``moe_aux_weight > 0`` adds that
    weight times the sum of the model's mixture-of-experts load losses
    (metric ``moe_aux_loss``): set it whenever the model has experts."""

    def loss_fn(batch, generator):
        ids = batch[ids_key]
        kw = dict(train=True, generator=generator, attn_impl=attn_impl,
                  moe_aux_weight=moe_aux_weight)
        if vocab_chunk_size is not None:
            loss, metric, aux = _chunked_lm_loss(
                model, ids, vocab_chunk_size, batch, **kw)
        else:
            loss, metric, aux = _full_lm_loss(model, ids, batch, **kw)
        metrics = {"loss": metric}
        if aux is not None:
            metrics["moe_aux_loss"] = aux.detach()
            loss = loss + aux
        return loss, {"metrics": metrics}

    return loss_fn


def causal_lm_eval_step(
    model,
    *,
    ids_key: str = "input_ids",
    vocab_chunk_size: Optional[int] = None,
    attn_impl: Optional[str] = None,
) -> Callable:
    """``eval_step(state, batch) -> metrics`` for decoder LMs: the mean
    next-token loss and its ``perplexity``, through the chunked loss
    when ``vocab_chunk_size`` is given (the eval pass then never forms
    the logits the chunked train step avoids)."""

    @torch.no_grad()
    def eval_step(state, batch) -> Dict[str, torch.Tensor]:
        ids = batch[ids_key]
        if vocab_chunk_size is not None:
            _, loss, _ = _chunked_lm_loss(model, ids, vocab_chunk_size,
                                          batch, train=False,
                                          attn_impl=attn_impl)
        else:
            _, loss, _ = _full_lm_loss(model, ids, batch, train=False,
                                       attn_impl=attn_impl)
        return {"loss": loss, "perplexity": torch.exp(loss)}

    return eval_step


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy in f32 (f64 logits stay f64); with
    ``label_smoothing`` the target is ``one_hot * (1 - ls) + ls / n``, as
    the JAX loss's."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    return F.cross_entropy(logits, labels.long(),
                           label_smoothing=label_smoothing)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  k: int = 5) -> torch.Tensor:
    """Share of rows whose label is among the ``k`` largest logits (``k``
    clamps to the class count)."""
    k = min(k, logits.shape[-1])
    idx = logits.topk(k, dim=-1).indices
    return (idx == labels[..., None]).any(-1).float().mean()


def l2_penalty(model, weight_decay: float) -> torch.Tensor:
    """``0.5 * wd * sum p^2`` over the kernels (``ndim > 1``), not the
    biases or the norms' scales: the JAX recipes' SGD-style decay."""
    kernels = [p for p in model.parameters() if p.ndim > 1]
    return 0.5 * weight_decay * sum(p.float().square().sum()
                                    for p in kernels)


def classification_loss_fn(
    model,
    *,
    image_key: str = "image",
    label_key: str = "label",
    label_smoothing: float = 0.0,
    weight_decay: float = 0.0,
    dropout_rng: bool = False,
) -> Callable:
    """Loss for image classifiers with BatchNorm: a train-mode forward
    (which updates the running statistics), cross-entropy with
    ``label_smoothing``, plus the L2 penalty when ``weight_decay``;
    metrics ``loss`` and ``accuracy``. ``model`` may be the module or
    its ``DistributedDataParallel`` wrapper. ``dropout_rng``: the model
    draws dropout masks (ViT), from the step's generator."""

    def loss_fn(batch, generator):
        kw = {"generator": generator} if dropout_rng else {}
        logits = model(batch[image_key], train=True, **kw)
        labels = batch[label_key]
        loss = cross_entropy(logits, labels, label_smoothing)
        if weight_decay:
            loss = loss + l2_penalty(model, weight_decay)
        return loss, {"metrics": {
            "loss": loss.detach(),
            "accuracy": accuracy(logits.detach(), labels),
        }}

    return loss_fn


def classification_eval_step(
    model,
    *,
    image_key: str = "image",
    label_key: str = "label",
    batch_transform: Optional[Callable] = None,
) -> Callable:
    """``eval_step(state, batch) -> metrics`` on the running BatchNorm
    statistics: ``loss``, ``accuracy`` and, past 5 classes,
    ``top5_accuracy``. ``batch_transform`` is the train step's (e.g. the
    uint8 device normalizer, without the flip)."""

    @torch.no_grad()
    def eval_step(state, batch) -> Dict[str, torch.Tensor]:
        if batch_transform is not None:
            batch = batch_transform(batch)
        logits = model(batch[image_key], train=False)
        labels = batch[label_key]
        out = {
            "loss": cross_entropy(logits, labels),
            "accuracy": accuracy(logits, labels),
        }
        if logits.shape[-1] > 5:
            out["top5_accuracy"] = topk_accuracy(logits, labels, k=5)
        return out

    return eval_step


def text_classification_loss_fn(
    model, *, label_smoothing: float = 0.0, attn_impl: Optional[str] = None,
) -> Callable:
    """Loss for BERT-style sequence classification: a train-mode forward
    of ``input_ids`` (with the batch's ``attention_mask`` when it has
    one), cross-entropy against ``label`` with ``label_smoothing``;
    metrics ``loss`` and ``accuracy``. ``attn_impl`` is passed to the
    model (``None``: flash on the card)."""

    def loss_fn(batch, generator):
        logits = model(batch["input_ids"], batch.get("attention_mask"),
                       train=True, generator=generator, attn_impl=attn_impl)
        labels = batch["label"]
        loss = cross_entropy(logits, labels, label_smoothing)
        return loss, {"metrics": {
            "loss": loss.detach(),
            "accuracy": accuracy(logits.detach(), labels),
        }}

    return loss_fn


def masked_lm_loss_fn(
    model,
    *,
    mask_token_id: int,
    vocab_size: int,
    mask_prob: float = 0.15,
    ids_key: str = "input_ids",
    attention_mask_key: str = "attention_mask",
    attn_impl: Optional[str] = None,
) -> Callable:
    """BERT's masked-LM loss with dynamic masking: every step draws a
    fresh 80/10/10 masking (``models.bert.mask_tokens``) from the step's
    generator, before the dropout masks, and scores cross-entropy over
    the selected positions only. The batch's optional ``special_mask``
    (``[B, S]`` bool, True = never mask) and its padding (``attention_mask``
    False) are never selected. Metrics ``loss``, ``accuracy`` over the
    selected positions and the realized ``mask_frac``."""
    from pytorch_distributed_tpu_torch.models.bert import mask_tokens

    def loss_fn(batch, generator):
        ids = batch[ids_key]
        attn = batch.get(attention_mask_key)
        protect = batch.get("special_mask")
        if protect is not None:
            protect = protect.to(torch.bool)
        if attn is not None:
            pad = ~attn.to(torch.bool)
            protect = pad if protect is None else (protect | pad)
        masked_ids, labels = mask_tokens(
            generator, ids, mask_token_id=mask_token_id,
            vocab_size=vocab_size, mask_prob=mask_prob, special_mask=protect)
        logits = model(masked_ids, attn, batch.get("token_type_ids"),
                       train=True, generator=generator, attn_impl=attn_impl)
        sel = labels != -100
        w = sel.to(torch.float32)
        denom = torch.clamp(w.sum(), min=1.0)
        per_tok = F.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            labels.clamp(min=0).long().reshape(-1), reduction="none",
        ).reshape(labels.shape)
        loss = (per_tok * w).sum() / denom
        hits = (logits.detach().argmax(-1) == labels).to(torch.float32)
        return loss, {"metrics": {
            "loss": loss.detach(),
            "accuracy": (hits * w).sum() / denom,
            "mask_frac": w.mean(),
        }}

    return loss_fn


# -- MixUp / CutMix --------------------------------------------------------


def _beta(generator, alpha: torch.Tensor) -> torch.Tensor:
    """One Beta(alpha, alpha) draw from two Gamma(alpha) draws, on the
    generator's device (no host sync)."""
    g = torch._standard_gamma(alpha.expand(2).contiguous(),
                              generator=generator)
    return g[0] / (g[0] + g[1])


def mixup_cutmix_draw(generator, batch_size: int, *,
                      mixup_alpha: float = 0.2, cutmix_alpha: float = 0.0,
                      switch_prob: float = 0.5) -> Dict[str, torch.Tensor]:
    """The random part of :func:`mixup_cutmix`, from ``generator`` on its
    device: the partner permutation ``perm``, ``use_cutmix`` (with both
    alphas > 0, CutMix with probability ``switch_prob``), ``lam`` ~
    Beta(alpha, alpha) of the chosen branch, and the CutMix box's centre
    as fractions of the height and width (``cy``, ``cx`` in [0, 1))."""
    if mixup_alpha <= 0.0 and cutmix_alpha <= 0.0:
        raise ValueError(
            "mixup_cutmix needs mixup_alpha > 0 or cutmix_alpha > 0 "
            "(both zero would still mix with an implicit Beta(1,1) lam)")
    dev = generator.device
    perm = torch.randperm(batch_size, generator=generator, device=dev)
    if mixup_alpha > 0.0 and cutmix_alpha > 0.0:
        use_cutmix = torch.rand((), generator=generator,
                                device=dev) < switch_prob
    else:
        use_cutmix = torch.tensor(cutmix_alpha > 0.0, device=dev)
    alpha = torch.where(use_cutmix,
                        torch.tensor(cutmix_alpha or 1.0, device=dev),
                        torch.tensor(mixup_alpha or 1.0, device=dev))
    lam = _beta(generator, alpha.float())
    centre = torch.rand(2, generator=generator, device=dev)
    return {"perm": perm, "use_cutmix": use_cutmix, "lam": lam,
            "cy": centre[0], "cx": centre[1]}


def mixup_cutmix_apply(imgs: torch.Tensor, draw: Dict[str, torch.Tensor]):
    """The mixing of :func:`mixup_cutmix` given its draws, on NHWC images:
    ``(mixed, perm, lam)``. MixUp is ``lam * imgs + (1 - lam) *
    imgs[perm]``; CutMix pastes the partner's pixels inside a box of
    ratio ``sqrt(1 - lam)`` around the drawn centre, clamped to the
    image, and ``lam`` becomes the share of pixels kept. Static shapes
    (masks from index ramps), as the JAX version's."""
    b, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    perm, lam = draw["perm"], draw["lam"].float()
    partner = imgs[perm]
    mixed_up = lam * imgs + (1.0 - lam) * partner
    cut = torch.sqrt(1.0 - lam)
    bh, bw = cut * h, cut * w
    cy, cx = draw["cy"].float() * h, draw["cx"].float() * w
    y0, y1 = (cy - bh / 2).clamp(0, h), (cy + bh / 2).clamp(0, h)
    x0, x1 = (cx - bw / 2).clamp(0, w), (cx + bw / 2).clamp(0, w)
    rows = torch.arange(h, dtype=torch.float32, device=imgs.device)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=imgs.device)[None, :]
    in_box = (rows >= y0) & (rows < y1) & (cols >= x0) & (cols < x1)
    cut_mixed = torch.where(in_box[None, :, :, None], partner, imgs)
    lam_cut = 1.0 - in_box.float().mean()
    use = draw["use_cutmix"]
    mixed = torch.where(use, cut_mixed.to(imgs.dtype),
                        mixed_up.to(imgs.dtype))
    return mixed, perm, torch.where(use, lam_cut, lam)


def mixup_cutmix(generator, imgs: torch.Tensor, *, mixup_alpha: float = 0.2,
                 cutmix_alpha: float = 0.0, switch_prob: float = 0.5):
    """Batch-level MixUp/CutMix (timm's ``mode='batch'``): one ``lam`` and
    one partner permutation per call; ``(mixed, perm, lam)``. The draws
    (:func:`mixup_cutmix_draw`) come from ``generator``, the mixing is
    :func:`mixup_cutmix_apply`."""
    draw = mixup_cutmix_draw(generator, imgs.shape[0],
                             mixup_alpha=mixup_alpha,
                             cutmix_alpha=cutmix_alpha,
                             switch_prob=switch_prob)
    return mixup_cutmix_apply(imgs, draw)


#: the mixing stream's tag inside a step's generator ("mix")
MIX_TAG = 0x6D6978


def mixup_classification_loss_fn(
    model,
    *,
    mixup_alpha: float = 0.2,
    cutmix_alpha: float = 0.0,
    switch_prob: float = 0.5,
    image_key: str = "image",
    label_key: str = "label",
    label_smoothing: float = 0.0,
    weight_decay: float = 0.0,
) -> Callable:
    """:func:`classification_loss_fn` with MixUp/CutMix on the card: the
    images mixed with their partners (:func:`mixup_cutmix`, drawn from a
    generator seeded from the step's), the loss ``lam * CE(labels) +
    (1 - lam) * CE(labels[perm])`` plus the L2 penalty; metrics
    ``loss``, ``accuracy`` on the primary labels and ``lam``."""
    if mixup_alpha <= 0.0 and cutmix_alpha <= 0.0:
        raise ValueError(
            "mixup_classification_loss_fn needs mixup_alpha > 0 or "
            "cutmix_alpha > 0; for neither, use classification_loss_fn")

    def loss_fn(batch, generator):
        imgs, labels = batch[image_key], batch[label_key]
        if generator is None:
            raise ValueError("mixup needs the step's generator")
        mixed, perm, lam = mixup_cutmix(
            generator, imgs, mixup_alpha=mixup_alpha,
            cutmix_alpha=cutmix_alpha, switch_prob=switch_prob)
        logits = model(mixed, train=True)
        loss = lam * cross_entropy(logits, labels, label_smoothing) + (
            1.0 - lam) * cross_entropy(logits, labels[perm], label_smoothing)
        if weight_decay:
            loss = loss + l2_penalty(model, weight_decay)
        return loss, {"metrics": {
            "loss": loss.detach(),
            "accuracy": accuracy(logits.detach(), labels),
            "lam": lam.detach(),
        }}

    return loss_fn


# -- distillation ----------------------------------------------------------


def distillation_loss_fn(
    student,
    teacher,
    *,
    temperature: float = 2.0,
    alpha: float = 0.5,
    ids_key: str = "input_ids",
    moe_aux_weight: float = 0.0,
) -> Callable:
    """Knowledge distillation for causal LMs: ``alpha * CE(student,
    labels) + (1 - alpha) * T^2 * KL(teacher_T || student_T)`` over the
    shifted next-token positions, both masked at document boundaries and
    padding of packed batches. The teacher (a frozen module) runs in
    eval mode without gradients. Metrics ``loss``, ``ce``, ``kl``; with
    ``moe_aux_weight`` the student's weighted load loss is added
    (``moe_aux_loss``: the teacher's routing is its own)."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    if temperature <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")

    def loss_fn(batch, generator):
        ids = batch[ids_key]
        seg = batch.get("segment_ids")
        extra = _packed_extra(batch)
        s_logits, moe_aux = _apply_with_moe_aux(
            student, ids, dict(train=True, generator=generator, **extra),
            moe_aux_weight)
        with torch.no_grad():
            t_logits = teacher(ids, train=False, **extra)
        s = s_logits[:, :-1].float()
        t = t_logits[:, :-1].float()
        labels = ids[:, 1:].long()
        tok_ce = F.cross_entropy(s.reshape(-1, s.shape[-1]),
                                 labels.reshape(-1), reduction="none"
                                 ).reshape(labels.shape)
        t_logp = F.log_softmax(t / temperature, -1)
        s_logp = F.log_softmax(s / temperature, -1)
        tok_kl = (t_logp.exp() * (t_logp - s_logp)).sum(-1)
        ce = masked_token_mean(tok_ce, seg)
        kl = masked_token_mean(tok_kl, seg)
        loss = alpha * ce + (1.0 - alpha) * (temperature ** 2) * kl
        metrics = {"loss": loss.detach(), "ce": ce.detach(),
                   "kl": kl.detach()}
        if moe_aux is not None:
            metrics["moe_aux_loss"] = moe_aux.detach()
            loss = loss + moe_aux
        return loss, {"metrics": metrics}

    return loss_fn


# -- sequence-classification evaluation and its F1 --------------------------


def text_classification_eval_step(
    model,
    *,
    binary_metrics: bool = False,
    ids_key: str = "input_ids",
    label_key: str = "label",
    attn_impl: Optional[str] = None,
) -> Callable:
    """``eval_step(state, batch) -> metrics`` for sequence classification:
    ``accuracy``, and with ``binary_metrics`` the confusion rates
    ``tp_rate``/``fp_rate``/``fn_rate``/``tn_rate`` (shares of the batch;
    positive = label 1), which average linearly under the Trainer's
    sample-weighted mean, so :func:`f1_finalize` derives the dataset's
    F1 and MCC from them."""

    @torch.no_grad()
    def eval_step(state, batch) -> Dict[str, torch.Tensor]:
        logits = model(batch[ids_key], batch.get("attention_mask"),
                       batch.get("token_type_ids"), train=False,
                       attn_impl=attn_impl)
        labels = batch[label_key]
        pred = logits.argmax(-1)
        out = {"accuracy": accuracy(logits, labels)}
        if binary_metrics:
            p, y = pred == 1, labels == 1
            out["tp_rate"] = (p & y).float().mean()
            out["fp_rate"] = (p & ~y).float().mean()
            out["fn_rate"] = (~p & y).float().mean()
            out["tn_rate"] = (~p & ~y).float().mean()
        return out

    return eval_step


def f1_finalize(means: Dict[str, float]) -> Dict[str, float]:
    """Precision, recall, F1 and MCC from aggregated confusion rates (the
    ratios are scale-free, so the mean rates give the dataset's values);
    0.0 where a denominator is 0, as sklearn. A plain accuracy eval
    passes through."""
    out = dict(means)
    try:
        tp, fp = means["tp_rate"], means["fp_rate"]
        fn, tn = means["fn_rate"], means["tn_rate"]
    except KeyError:
        return out
    prec = tp / (tp + fp) if tp + fp > 0 else 0.0
    rec = tp / (tp + fn) if tp + fn > 0 else 0.0
    out["precision"] = prec
    out["recall"] = rec
    out["f1"] = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
    denom = ((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)) ** 0.5
    out["mcc"] = (tp * tn - fp * fn) / denom if denom > 0 else 0.0
    return out


# -- encoder-decoder (T5) ---------------------------------------------------


def _token_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-position softmax cross-entropy in f32 (the JAX
    ``_token_cross_entropy``): with ``label_smoothing`` the target is
    ``one_hot * (1 - ls) + ls / n``."""
    V = logits.shape[-1]
    return F.cross_entropy(
        logits.float().reshape(-1, V), labels.reshape(-1).long(),
        reduction="none", label_smoothing=label_smoothing,
    ).reshape(labels.shape)


def _masked_mean(tok: torch.Tensor, mask) -> torch.Tensor:
    """Mean over the positions where ``mask`` is True (all when None)."""
    if mask is None:
        return tok.mean()
    valid = mask.to(tok.dtype)
    return (tok * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def _seq2seq_logits(model, batch, start_id, **kw):
    """Teacher-forced logits: the decoder reads ``shift_right(labels)``
    (the start token the config's pad id unless given)."""
    from pytorch_distributed_tpu_torch.models.t5 import shift_right

    core = getattr(model, "module", model)
    sid = start_id if start_id is not None else getattr(
        core.config, "pad_token_id", 0)
    return model(batch["input_ids"], shift_right(batch["labels"], sid),
                 input_mask=batch.get("input_mask"), **kw)


def seq2seq_lm_loss_fn(model, *, start_id: Optional[int] = None,
                       label_smoothing: float = 0.0,
                       attn_impl: Optional[str] = None) -> Callable:
    """Loss for encoder-decoder LMs (``models/t5.py``): teacher forcing
    on ``shift_right(labels)`` (HF ``T5ForConditionalGeneration(labels=
    ...)``), cross-entropy against the unshifted ``labels`` with
    ``label_smoothing``, averaged over the batch's optional
    ``label_mask``; ``input_mask`` is the encoder's key mask. Metric
    ``loss``."""

    def loss_fn(batch, generator):
        logits = _seq2seq_logits(model, batch, start_id, train=True,
                                 generator=generator, attn_impl=attn_impl)
        tok = _token_cross_entropy(logits, batch["labels"], label_smoothing)
        loss = _masked_mean(tok, batch.get("label_mask"))
        return loss, {"metrics": {"loss": loss.detach()}}

    return loss_fn


def seq2seq_eval_step(model, *, start_id: Optional[int] = None,
                      attn_impl: Optional[str] = None) -> Callable:
    """``eval_step(state, batch) -> metrics`` for encoder-decoder LMs:
    the teacher-forced masked ``loss``, its ``perplexity`` and the
    masked ``token_accuracy`` (the batch contract of
    :func:`seq2seq_lm_loss_fn`)."""

    @torch.no_grad()
    def eval_step(state, batch) -> Dict[str, torch.Tensor]:
        logits = _seq2seq_logits(model, batch, start_id, train=False,
                                 attn_impl=attn_impl)
        labels, mask = batch["labels"], batch.get("label_mask")
        loss = _masked_mean(_token_cross_entropy(logits, labels), mask)
        correct = (logits.argmax(-1) == labels).to(torch.float32)
        return {"loss": loss, "perplexity": torch.exp(loss),
                "token_accuracy": _masked_mean(correct, mask)}

    return eval_step
