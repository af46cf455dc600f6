"""Losses and metrics: the port of the full-logits path of
``causal_lm_loss_fn`` and of the classifier losses in
``pytorch_distributed_tpu/train/losses.py``.

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


def masked_token_mean(tok_loss: torch.Tensor, segment_ids) -> torch.Tensor:
    """Mean of per-token losses; packed batches average over valid
    targets only (document boundaries and padding excluded by
    ``packed_loss_mask``)."""
    if segment_ids is None:
        return tok_loss.mean()
    valid = packed_loss_mask(segment_ids).to(tok_loss.dtype)
    return (tok_loss * valid).sum() / torch.clamp(valid.sum(), min=1.0)


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
    ``attn_impl`` is passed to the model (``None``: flash on the card)."""
    if vocab_chunk_size is not None:
        raise NotImplementedError(
            "the chunked-vocab loss (ops/lm_loss.py) is not ported "
            "(ROADMAP A7)"
        )
    if moe_aux_weight > 0.0:
        raise NotImplementedError(
            "mixture-of-experts aux losses are not ported (ROADMAP A10)"
        )

    def loss_fn(batch, generator):
        ids = batch[ids_key]
        seg = batch.get("segment_ids")
        extra = {}
        if seg is not None:
            extra["segment_ids"] = seg
            if "positions" in batch:
                extra["positions"] = batch["positions"]
        logits = model(ids, train=True, generator=generator,
                        attn_impl=attn_impl, **extra)
        shift_logits = logits[:, :-1].float()
        labels = ids[:, 1:].long()
        tok_loss = F.cross_entropy(
            shift_logits.reshape(-1, shift_logits.shape[-1]),
            labels.reshape(-1), reduction="none",
        ).reshape(labels.shape)
        loss = masked_token_mean(tok_loss, seg)
        return loss, {"metrics": {"loss": loss.detach()}}

    return loss_fn


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
