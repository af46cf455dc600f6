"""Autoregressive generation over a static KV cache: the port of
``pytorch_distributed_tpu/generation.py`` (greedy and sampled decoding).

The prompt runs through the model once, filling a ``[B, P + new]``
cache per layer; then one token per step, each written at its row's own
position (``write_pos``). Sampling is Gumbel-max over noise drawn from
one explicit ``torch.Generator``: the serving engine draws each request's
noise from a generator seeded the same way, so an engine stream equals
the solo ``generate`` call with that seed. Beam search, ragged prompts,
repetition penalties and speculative decoding are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_distributed_tpu_torch.runtime.device import (
    DeviceLike,
    resolve_device,
)


def _validate_filters(top_k, top_p) -> None:
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")


def filter_logits(
    logits: torch.Tensor,
    *,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """Temperature-scaled, k/p-filtered f32 logits ([..., vocab]): the
    exact distribution :func:`sample_logits` draws from."""
    if temperature <= 0.0:
        raise ValueError(
            f"filter_logits needs temperature > 0, got {temperature}"
        )
    _validate_filters(top_k, top_p)
    V = logits.shape[-1]
    if top_k is not None:
        top_k = min(top_k, V)
    neg_inf = torch.finfo(torch.float32).min
    logits = logits.float() / temperature
    if top_k is not None or top_p is not None:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    if top_k is not None:
        kth = sorted_desc[..., top_k - 1:top_k]
        logits = torch.where(logits < kth, neg_inf, logits)
        ranks = torch.arange(V, device=logits.device)
        sorted_desc = torch.where(ranks < top_k, sorted_desc, neg_inf)
    if top_p is not None:
        # a token survives if the cumulative probability BEFORE it is
        # still < top_p (so the top token always survives)
        probs = torch.softmax(sorted_desc, dim=-1)
        cum_before = torch.cumsum(probs, dim=-1) - probs
        thresh = torch.where(
            cum_before < top_p, sorted_desc, float("inf")
        ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, neg_inf, logits)
    return logits


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gumbel(0, 1) noise drawn from ``generator``: ``argmax(logits +
    noise)`` is a draw from ``softmax(logits)``."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u))


def sample_logits(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    *,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """[B, vocab] logits -> [B] token ids (greedy at temperature 0)."""
    _validate_filters(top_k, top_p)
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("sampling with temperature > 0 needs a generator")
    filtered = filter_logits(
        logits, temperature=temperature, top_k=top_k, top_p=top_p
    )
    noise = gumbel_noise(filtered.shape, generator, filtered.device)
    return torch.argmax(filtered + noise, dim=-1)


def model_max_len(model):
    """The model's position/cache capacity, or None when untyped."""
    return getattr(getattr(model, "config", None), "max_seq_len", None)


def decode_step_body(model, cache, tok, *, cache_len, positions, write_pos,
                     paged=None):
    """One KV-cache decode tick: ``[B]`` tokens -> ``([B, V] logits,
    cache)``. Shared by :func:`generate` and the serving engine's tick,
    so the two stay one code path."""
    logits, cache = model(
        tok[:, None], positions, cache=cache, write_pos=write_pos,
        decode=True, cache_len=cache_len, paged=paged,
    )
    return logits[:, -1], cache


def _generation_limits(model, P, max_new_tokens):
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    limit = model_max_len(model)
    if limit is not None and P + max_new_tokens > limit:
        raise ValueError(
            f"prompt ({P}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"model's maximum sequence length {limit}"
        )
    return P + max_new_tokens


@torch.no_grad()
def generate(
    model,
    prompt_ids,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt_ids`` [B, P].

    Returns [B, P + max_new_tokens] on ``device``; rows that hit
    ``eos_id`` are padded with ``pad_id`` after it. ``generator`` (on
    ``device``) drives sampling; it defaults to one seeded with 0.
    ``device`` defaults to the CUDA card and must hold the model.
    """
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(
            f"the model lives on {model.device}, generate was asked for "
            f"{device}"
        )
    prompt = torch.as_tensor(prompt_ids, device=device).long()
    B, P = prompt.shape
    cache_len = _generation_limits(model, P, max_new_tokens)
    if generator is None and temperature > 0:
        generator = torch.Generator(device=device).manual_seed(0)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    positions = torch.arange(P, device=device)[None].expand(B, P)
    logits, cache = model(
        prompt, positions, write_pos=torch.zeros(B, dtype=torch.int32,
                                                 device=device),
        decode=True, cache_len=cache_len,
    )
    tok = sample_logits(logits[:, -1], generator, **kw)
    done = (
        tok == eos_id if eos_id is not None
        else torch.zeros(B, dtype=torch.bool, device=device)
    )
    out = [tok]
    for t in range(max_new_tokens - 1):
        pos = torch.full((B,), P + t, dtype=torch.int32, device=device)
        last, cache = decode_step_body(
            model, cache, tok, cache_len=cache_len,
            positions=pos[:, None], write_pos=pos,
        )
        nxt = sample_logits(last, generator, **kw)
        nxt = torch.where(done, pad_id, nxt)
        if eos_id is not None:
            done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
