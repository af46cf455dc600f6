"""Chunked-vocab softmax cross-entropy: the port of
``pytorch_distributed_tpu/ops/lm_loss.py``.

The full-logits loss holds ``[N, V]`` f32 logits and, in the backward,
their gradient: at GPT-2-medium's batch (N = 8 x 1023, V = 50257) about
1.6 GB each. This loss never forms them. It walks the vocabulary in
chunks of ``C`` columns, keeping per row an online logsumexp (running
maximum and rescaled sum, the flash-attention carry on the classifier
axis), the label's logit and, for label smoothing, the sum of the
logits. The last chunk, when ``V`` is not a multiple of ``C``, is
clamped back to end at ``V`` and its columns already seen are masked.

It is one ``torch.autograd.Function``: the forward keeps only the
hidden states, the projection (in its own layout, never transposed or
cast whole) and the per-row logsumexp, and the backward recomputes each
chunk's logits, as ``jax.checkpoint`` on the chunk body does in the JAX
package, so at most one ``[N, C]`` chunk of logits (and its gradient) is
live at a time. The chunk products are ``torch.mm`` in the hidden
states' dtype with f32 results, as the JAX op's ``dot_general`` with
``preferred_element_type=f32``.
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_distributed_tpu_torch.data.packing import packed_loss_mask


def _mm32(a, b):
    """``a @ b`` with f32 results: on the card in the operands' dtype
    with f32 accumulation, elsewhere in f32."""
    if a.dtype == torch.float32 or not a.is_cuda:
        return torch.mm(a.float(), b.float())
    return torch.mm(a, b, out_dtype=torch.float32)


def _chunk_logits(hidden, embedding, start: int, size: int,
                  vocab_axis: int):
    """``[N, size]`` f32 logits of columns ``[start, start + size)``; the
    projection's slice is cast to the hidden states' dtype alone."""
    if vocab_axis == 0:
        w = embedding[start:start + size].to(hidden.dtype).t()  # [D, C]
    else:
        w = embedding[:, start:start + size].to(hidden.dtype)  # [D, C]
    return _mm32(hidden, w)


def _chunks(v: int, size: int):
    """``(start, fresh_from)`` per chunk: the ragged last chunk starts at
    ``v - size``, and its columns before ``fresh_from`` were seen."""
    for base in range(0, v, size):
        start = min(base, v - size)
        yield start, base - start


class _ChunkedCE(torch.autograd.Function):
    """Per-token CE over the vocabulary in chunks; see the module
    docstring."""

    @staticmethod
    def forward(ctx, hidden, embedding, labels, chunk_size, vocab_axis,
                label_smoothing):
        n = hidden.shape[0]
        v = embedding.shape[vocab_axis]
        dev = hidden.device
        m = torch.full((n,), -float("inf"), device=dev)
        s = torch.zeros(n, device=dev)
        lab = torch.zeros(n, device=dev)
        tot = torch.zeros(n, device=dev)
        for start, fresh in _chunks(v, chunk_size):
            logits = _chunk_logits(hidden, embedding, start, chunk_size,
                                   vocab_axis)
            if fresh:
                logits[:, :fresh] = -float("inf")
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(torch.clamp(m - m_new, max=0.0)) + torch.exp(
                logits - m_new[:, None]).sum(-1)
            m = m_new
            # each label falls in exactly one chunk's fresh columns
            col = labels - start
            hit = (col >= fresh) & (col < chunk_size)
            lab = lab + torch.where(
                hit, logits.gather(1, col.clamp(0, chunk_size - 1)[:, None])
                [:, 0], torch.zeros_like(lab))
            if label_smoothing:
                tot = tot + logits[:, fresh:].sum(-1)
            del logits
        lse = m + torch.log(s)
        if label_smoothing:
            eps = label_smoothing
            per_token = lse - (1.0 - eps) * lab - eps * tot / v
        else:
            per_token = lse - lab
        ctx.save_for_backward(hidden, embedding, labels, lse)
        ctx.cfg = (chunk_size, vocab_axis, label_smoothing)
        return per_token

    @staticmethod
    def backward(ctx, g):
        hidden, embedding, labels, lse = ctx.saved_tensors
        chunk_size, vocab_axis, eps = ctx.cfg
        v = embedding.shape[vocab_axis]
        g = g.float()
        need_h, need_w = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        dh = torch.zeros(hidden.shape, device=hidden.device,
                         dtype=torch.float32) if need_h else None
        dw = torch.zeros(embedding.shape, device=embedding.device,
                         dtype=torch.float32) if need_w else None
        for start, fresh in _chunks(v, chunk_size):
            logits = _chunk_logits(hidden, embedding, start, chunk_size,
                                   vocab_axis)
            # d per_token / d logit_j = softmax_j - (1 - eps) [j = label]
            #                            - eps / v, on fresh columns only
            dz = torch.exp(logits - lse[:, None])
            del logits
            col = labels - start
            hit = (col >= fresh) & (col < chunk_size)
            dz.scatter_add_(1, col.clamp(0, chunk_size - 1)[:, None],
                            -(1.0 - eps) * hit.float()[:, None])
            if eps:
                dz -= eps / v
            if fresh:
                dz[:, :fresh] = 0.0
            dz *= g[:, None]
            dz = dz.to(hidden.dtype)
            if vocab_axis == 0:
                w = embedding[start:start + chunk_size].to(hidden.dtype)
                if need_h:
                    dh += _mm32(dz, w)                         # [N, D]
                if need_w:
                    dw[start + fresh:start + chunk_size] += _mm32(
                        dz.t(), hidden)[fresh:]                # [C, D]
            else:
                w = embedding[:, start:start + chunk_size].to(hidden.dtype)
                if need_h:
                    dh += _mm32(dz, w.t())
                if need_w:
                    dw[:, start + fresh:start + chunk_size] += _mm32(
                        hidden.t(), dz)[:, fresh:]             # [D, C]
            del dz
        return (None if dh is None else dh.to(hidden.dtype),
                None if dw is None else dw.to(embedding.dtype),
                None, None, None, None)


def chunked_softmax_cross_entropy(
    hidden: torch.Tensor,
    embedding: torch.Tensor,
    labels: torch.Tensor,
    *,
    chunk_size: int = 8192,
    label_smoothing: float = 0.0,
    vocab_axis: int = 0,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean CE of the logits ``hidden @ E`` against integer ``labels``,
    never forming them whole.

    ``hidden``: ``[N, D]`` (the products run in its dtype with f32
    results). ``embedding``: the projection in its own layout, ``[V, D]``
    (``vocab_axis=0``: GPT-2's tied ``wte``) or ``[D, V]``
    (``vocab_axis=1``: an untied head). ``labels``: ``[N]`` in
    ``[0, V)``. ``weights``: optional ``[N]`` per-token weights; the
    result is then ``sum(w * ce) / max(sum(w), 1)``. With
    ``label_smoothing`` the target is ``(1 - eps) one_hot + eps / V``.
    """
    if hidden.ndim != 2:
        raise ValueError(f"hidden must be [N, D], got {tuple(hidden.shape)}")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    if vocab_axis not in (0, 1):
        raise ValueError(f"vocab_axis must be 0 or 1, got {vocab_axis}")
    v = embedding.shape[vocab_axis]
    per_token = _ChunkedCE.apply(hidden, embedding, labels.long(),
                                 min(chunk_size, v), vocab_axis,
                                 float(label_smoothing))
    if weights is not None:
        w = weights.to(per_token.dtype)
        return (per_token * w).sum() / torch.clamp(w.sum(), min=1.0)
    return per_token.mean()


def causal_lm_chunked_loss(
    hidden: torch.Tensor,
    embedding: torch.Tensor,
    input_ids: torch.Tensor,
    *,
    chunk_size: int = 8192,
    label_smoothing: float = 0.0,
    vocab_axis: int = 0,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Next-token chunked CE on ``[B, S, D]`` hidden states. With
    ``segment_ids`` (packed rows) targets across a document boundary or
    on padding are masked and the mean is over the valid ones."""
    b, s, d = hidden.shape
    h = hidden[:, :-1].reshape(b * (s - 1), d)
    labels = input_ids[:, 1:].reshape(b * (s - 1))
    weights = None
    if segment_ids is not None:
        weights = packed_loss_mask(segment_ids).reshape(b * (s - 1))
    return chunked_softmax_cross_entropy(
        h, embedding, labels, chunk_size=chunk_size,
        label_smoothing=label_smoothing, vocab_axis=vocab_axis,
        weights=weights)
