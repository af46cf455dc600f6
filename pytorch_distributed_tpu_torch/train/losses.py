"""Losses and metrics: the port of ``causal_lm_loss_fn`` (full logits
or the chunked-vocab loss of ``ops/lm_loss.py``), ``causal_lm_eval_step``,
the classifier losses, ``text_classification_loss_fn`` and
``masked_lm_loss_fn`` in ``pytorch_distributed_tpu/train/losses.py``.

A loss function here is ``loss_fn(batch, generator) -> (loss, aux)``
with ``aux = {"metrics": {...}}``. It closes over the module, whose
parameters are the leaves the JAX loss takes as ``params`` (PyTorch
updates them in place), and ``generator`` feeds the dropout masks. A
classifier's BatchNorm running statistics, which the JAX loss returns
as ``aux["batch_stats"]``, are buffers of the module that its train-mode
forward updates in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.data.packing import packed_loss_mask
from pytorch_distributed_tpu_torch.ops.lm_loss import causal_lm_chunked_loss


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
    layout: GPT-2's tied ``wte`` ``[V, D]``, or an untied ``lm_head``
    (``nn.Linear``, ``[V, D]`` too: ``vocab_axis`` 0 in the port, where
    the JAX kernel is ``[D, V]``). The tied ``embed`` fallback refuses
    when ``tied`` says untied or a head-like attribute exists, as the
    JAX resolver does: the loss would train against the wrong logits
    without an error."""
    model = getattr(model, "module", model)
    if hasattr(model, "wte"):
        return model.wte.weight, 0
    if hasattr(model, "lm_head"):
        return model.lm_head.weight, 0
    if hasattr(model, "embed"):
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


def _chunked_lm_loss(model, ids, chunk_size, batch, *, train: bool,
                     generator=None, attn_impl=None):
    """The chunked loss's shared train/eval body: the model's hidden
    states in the compute dtype, projected chunk by chunk through the
    head in its own layout.

    Under FSDP the head is read after the model's forward, outside any
    FSDP-managed call: the root is unsharded explicitly first
    (``FSDPModule.unshard``, a no-op when FSDP2 kept the root gathered
    after its forward), so the chunks multiply by the whole gathered
    head, and its gradient lands on the unsharded parameter, which the
    root's post-backward reduce-scatters with the others."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    core = getattr(model, "module", model)
    kw = dict(train=train, return_hidden=True, attn_impl=attn_impl,
              **_packed_extra(batch))
    if train:
        kw["generator"] = generator
    hidden = model(ids, **kw)
    if isinstance(core, FSDPModule):
        core.unshard()
    weight, axis = _lm_projection_weight(
        core, tied=getattr(getattr(core, "config", None),
                           "tie_word_embeddings", None))
    if isinstance(weight, DTensor):
        raise RuntimeError(
            "the LM head is still sharded after unshard(): the chunked "
            "loss would multiply by this rank's rows only")
    return causal_lm_chunked_loss(
        hidden.to(core.policy.compute_dtype), weight, ids,
        chunk_size=chunk_size, vocab_axis=axis,
        segment_ids=batch.get("segment_ids"))


def _full_lm_loss(model, ids, batch, *, train: bool, generator=None,
                  attn_impl=None):
    kw = dict(train=train, attn_impl=attn_impl, **_packed_extra(batch))
    if train:
        kw["generator"] = generator
    logits = model(ids, **kw)
    shift_logits = logits[:, :-1].float()
    labels = ids[:, 1:].long()
    tok_loss = F.cross_entropy(
        shift_logits.reshape(-1, shift_logits.shape[-1]),
        labels.reshape(-1), reduction="none",
    ).reshape(labels.shape)
    return masked_token_mean(tok_loss, batch.get("segment_ids"))


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
    ``DistributedDataParallel`` wrapper."""
    if moe_aux_weight > 0.0:
        raise NotImplementedError(
            "mixture-of-experts aux losses are not ported (ROADMAP A10)"
        )

    def loss_fn(batch, generator):
        ids = batch[ids_key]
        if vocab_chunk_size is not None:
            loss = _chunked_lm_loss(model, ids, vocab_chunk_size, batch,
                                    train=True, generator=generator,
                                    attn_impl=attn_impl)
        else:
            loss = _full_lm_loss(model, ids, batch, train=True,
                                 generator=generator, attn_impl=attn_impl)
        return loss, {"metrics": {"loss": loss.detach()}}

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
            loss = _chunked_lm_loss(model, ids, vocab_chunk_size, batch,
                                    train=False, attn_impl=attn_impl)
        else:
            loss = _full_lm_loss(model, ids, batch, train=False,
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
) -> Callable:
    """Loss for image classifiers with BatchNorm: a train-mode forward
    (which updates the running statistics), cross-entropy with
    ``label_smoothing``, plus the L2 penalty when ``weight_decay``;
    metrics ``loss`` and ``accuracy``. ``model`` may be the module or
    its ``DistributedDataParallel`` wrapper."""

    def loss_fn(batch, generator):
        logits = model(batch[image_key], train=True)
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
