"""The causal-LM loss: the port of the full-logits path of
``causal_lm_loss_fn`` in ``pytorch_distributed_tpu/train/losses.py``.

A loss function here is ``loss_fn(batch, generator) -> (loss, aux)``
with ``aux = {"metrics": {...}}``. It closes over the module, whose
parameters are the leaves the JAX loss takes as ``params`` (PyTorch
updates them in place), and ``generator`` feeds the dropout masks.
"""

from __future__ import annotations

from typing import Callable, Optional

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
