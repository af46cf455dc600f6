"""Autoregressive generation over a static KV cache: the port of
``pytorch_distributed_tpu/generation.py``.

The prompt runs through the model once, filling a ``[B, P + new]``
cache per layer; then one token per step, each written at its row's own
slot (``write_pos``). The JAX package scans the steps with ``lax.scan``;
the port's loop is a Python loop over :func:`decode_step_body`, the one
decode body it shares with the serving engine. Sampling is Gumbel-max
over noise drawn from one explicit ``torch.Generator``: the serving
engine draws each request's noise from a generator seeded the same way,
so an engine stream equals the solo ``generate`` call with that seed.

:func:`generate` takes ragged, LEFT-padded batches (``prompt_mask``, the
HF ``attention_mask`` idiom; :func:`ragged_prompt_state`), HF's
``repetition_penalty`` and ``no_repeat_ngram_size`` (with the JAX
package's deliberate divergence: PAD slots are not "seen", so a ragged
batch equals its unpadded rows run alone). :func:`generate_beam` keeps
beams as a batch dimension and reorders the cache with one gather a
step. Speculative decoding is ``speculative.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_distributed_tpu_torch.ops.attention import (  # noqa: F401
    cache_batch_axis,
    map_cache,
)
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
    cfg = getattr(model, "config", None)
    return getattr(cfg, "n_positions", None) or getattr(
        cfg, "max_seq_len", None)


def ragged_prompt_state(prompt_mask, B: int, P: int, cache_len: int):
    """Validated per-row state for a LEFT-padded prompt batch:
    ``(prompt_mask, positions, prompt_lens, kv_mask)``. A RIGHT-padded
    mask, or a row without a real token, is refused: both would decode
    from a query attending to nothing. Positions count real tokens only
    (pads share position 0; their K/V are masked out); ``kv_mask`` is
    the cache-slot validity for the whole generation (future slots
    valid: the causal offset hides the unwritten tail)."""
    prompt_mask = torch.as_tensor(prompt_mask)
    if tuple(prompt_mask.shape) != (B, P):
        raise ValueError(
            f"prompt_mask must be {(B, P)}, got {tuple(prompt_mask.shape)}")
    prompt_mask = prompt_mask.to(torch.bool)
    m = prompt_mask.to(torch.int8)
    if not bool((m[:, 1:] >= m[:, :-1]).all()):
        raise ValueError(
            "prompt_mask must be LEFT-padded: each row one contiguous run "
            "of real tokens ending at the last slot (HF left-padding for "
            "decoder-only generation)")
    if not bool(prompt_mask[:, -1].all()):
        raise ValueError(
            "prompt_mask has a row with no real tokens — every row must "
            "contain at least one real (last-slot) token")
    positions = (torch.cumsum(prompt_mask.to(torch.int64), dim=1)
                 - 1).clamp(min=0)
    prompt_lens = positions[:, -1] + 1
    kv_mask = torch.cat(
        [prompt_mask, torch.ones(B, cache_len - P, dtype=torch.bool,
                                 device=prompt_mask.device)], dim=1)
    return prompt_mask, positions, prompt_lens, kv_mask


def decode_step_body(model, cache, tok, *, cache_len, positions, write_pos,
                     kv_mask=None, paged=None):
    """One KV-cache decode tick: ``[B]`` tokens -> ``([B, V] logits,
    cache)``. Shared by :func:`generate`, :func:`generate_beam` and the
    serving engine's tick, so they stay one code path."""
    extra = {}
    if kv_mask is not None:
        extra["kv_mask"] = kv_mask
    if paged is not None:
        extra["paged"] = paged
    logits, cache = model(
        tok[:, None], positions, cache=cache, write_pos=write_pos,
        decode=True, cache_len=cache_len, **extra,
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


def _on_device(model, prompt_ids, device):
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(
            f"the model lives on {model.device}, generation was asked for "
            f"{device}"
        )
    return device, torch.as_tensor(prompt_ids, device=device).long()


def prefill(model, prompt, cache_len: int, positions=None, kv_mask=None):
    """The prompt's one full-width pass: ``(logits [B, P, V], cache)``
    with the prompt's K/V in slots ``[0, P)``."""
    B, P = prompt.shape
    if positions is None:
        positions = torch.arange(P, device=prompt.device)[None].expand(B, P)
    extra = {} if kv_mask is None else {"kv_mask": kv_mask}
    return model(
        prompt, positions,
        write_pos=torch.zeros(B, dtype=torch.int32, device=prompt.device),
        decode=True, cache_len=cache_len, **extra,
    )


class _Penalties:
    """``repetition_penalty`` and ``no_repeat_ngram_size`` over a fixed
    ``[B, cache_len]`` token history (HF's logits processors; PAD slots
    of a ragged prompt never count as seen)."""

    def __init__(self, prompt, prompt_mask, cache_len, V,
                 repetition_penalty: float, no_repeat_ngram_size: int):
        if repetition_penalty <= 0.0:
            raise ValueError(
                f"repetition_penalty must be > 0, got {repetition_penalty}")
        if no_repeat_ngram_size < 0:
            raise ValueError(
                f"no_repeat_ngram_size must be >= 0, got "
                f"{no_repeat_ngram_size}")
        B, P = prompt.shape
        dev = prompt.device
        self.B, self.V, self.P = B, V, P
        self.rp = repetition_penalty
        self.presence = None
        if repetition_penalty != 1.0:
            ids = prompt if prompt_mask is None else torch.where(
                prompt_mask, prompt, V)
            self.presence = torch.zeros(B, V + 1, dtype=torch.bool,
                                        device=dev)
            self.presence.scatter_(1, ids, True)
            self.presence = self.presence[:, :V].contiguous()
        n = no_repeat_ngram_size
        self.n = 0 if n > cache_len else n
        self.history = None
        if self.n > 0:
            self.history = torch.zeros(B, cache_len, dtype=torch.long,
                                       device=dev)
            self.history[:, :P] = prompt
            valid = torch.ones(B, cache_len, dtype=torch.bool, device=dev)
            if prompt_mask is not None:
                valid[:, :P] = prompt_mask
            self.valid = valid
            if self.n >= 2:
                W = cache_len - self.n + 1
                self.win = (torch.arange(W, device=dev)[:, None]
                            + torch.arange(self.n - 1, device=dev))
                self.follower_idx = torch.arange(W, device=dev) + self.n - 1
                self.gram_valid = (valid[:, self.win].all(-1)
                                   & valid[:, self.follower_idx])

    def apply(self, logits, cur_len: int):
        """Penalized, n-gram-banned f32 logits for the token at sequence
        index ``cur_len`` (``cur_len`` tokens written so far)."""
        if self.presence is not None:
            l32 = logits.float()
            pen = torch.where(l32 > 0, l32 / self.rp, l32 * self.rp)
            logits = torch.where(self.presence, pen, l32)
        if self.history is None:
            return logits
        l32 = logits.float()
        B, V, n = self.B, self.V, self.n
        if n == 1:
            slots = torch.arange(self.history.shape[1], device=l32.device)
            seen = (slots[None] < cur_len) & self.valid
            banned = torch.where(seen, self.history, V)
        else:
            grams = self.history[:, self.win]                 # [B, W, n-1]
            suffix = self.history[:, cur_len - (n - 1):cur_len]
            match = (grams == suffix[:, None, :]).all(-1)     # [B, W]
            ends = torch.arange(match.shape[1], device=l32.device) + n
            match = match & (ends[None] <= cur_len) & self.gram_valid
            banned = torch.where(match, self.history[:, self.follower_idx],
                                 V)
        out = torch.cat([l32, torch.zeros(B, 1, device=l32.device)], dim=1)
        out = out.scatter(1, banned, float("-inf"))
        return out[:, :V]

    def record(self, tok, index: int):
        """Token ``tok`` [B] was emitted at sequence index ``index``."""
        if self.presence is not None:
            self.presence[torch.arange(self.B, device=tok.device), tok] = True
        if self.history is not None:
            self.history[:, index] = tok


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
    prompt_mask=None,
    repetition_penalty: float = 1.0,
    no_repeat_ngram_size: int = 0,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt_ids`` [B, P].

    Returns [B, P + max_new_tokens] on ``device``; rows that hit
    ``eos_id`` are padded with ``pad_id`` after it. ``generator`` (on
    ``device``) drives sampling; it defaults to one seeded with 0.
    ``device`` defaults to the CUDA card and must hold the model.

    ``prompt_mask`` [B, P] (True = real token) takes ragged batches by
    LEFT padding: positions count real tokens, cache slots holding pads
    are masked out of every step, and each row equals its unpadded run.
    ``repetition_penalty`` (> 1 discourages) divides positive and
    multiplies negative logits of every token already in the row;
    ``no_repeat_ngram_size`` bans every token that would complete an
    n-gram already in the row (n=1 bans every seen token; n larger than
    the sequence is a no-op). Both match HF's processors, except that
    PAD slots are not seen.
    """
    device, prompt = _on_device(model, prompt_ids, device)
    B, P = prompt.shape
    cache_len = _generation_limits(model, P, max_new_tokens)
    if generator is None and temperature > 0:
        generator = torch.Generator(device=device).manual_seed(0)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    positions = kv_mask = prompt_lens = None
    if prompt_mask is not None:
        prompt_mask, positions, prompt_lens, kv_mask = ragged_prompt_state(
            torch.as_tensor(prompt_mask, device=device), B, P, cache_len)
    logits, cache = prefill(model, prompt, cache_len, positions, kv_mask)
    pen = _Penalties(prompt, prompt_mask, cache_len, logits.shape[-1],
                     repetition_penalty, no_repeat_ngram_size)
    tok = sample_logits(pen.apply(logits[:, -1], P), generator, **kw)
    pen.record(tok, P)
    done = (
        tok == eos_id if eos_id is not None
        else torch.zeros(B, dtype=torch.bool, device=device)
    )
    out = [tok]
    for t in range(max_new_tokens - 1):
        slot = torch.full((B,), P + t, dtype=torch.int32, device=device)
        pos = slot if prompt_lens is None else prompt_lens + t
        last, cache = decode_step_body(
            model, cache, tok, cache_len=cache_len,
            positions=pos[:, None], write_pos=slot, kv_mask=kv_mask,
        )
        nxt = sample_logits(pen.apply(last, P + t + 1), generator, **kw)
        nxt = torch.where(done, pad_id, nxt)
        if eos_id is not None:
            done = done | (nxt == eos_id)
        pen.record(nxt, P + t + 1)
        out.append(nxt)
        tok = nxt
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


@torch.no_grad()
def generate_beam(
    model,
    prompt_ids,
    *,
    max_new_tokens: int,
    num_beams: int,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
    length_penalty: float = 1.0,
    return_scores: bool = False,
    device: DeviceLike = None,
):
    """Beam search over the same static-cache decode loop as
    :func:`generate`: keeps the ``num_beams`` highest log-probability
    continuations per row, finished beams extend with ``pad_id`` at an
    unchanged score, and the best is ranked by ``sum(logp) /
    len**length_penalty`` (len = tokens up to and including ``eos_id``,
    else ``max_new_tokens``; HF's convention). Returns [B, P +
    max_new_tokens], or ``(sequences, scores)`` with ``return_scores``.

    Beams are a batch dimension: the cache is replicated to ``[B *
    num_beams, ...]`` once after the prefill and reordered with one
    gather a step (:func:`~pytorch_distributed_tpu_torch.ops.attention.
    map_cache`: the int8 cache's scales move with their payloads)."""
    device, prompt = _on_device(model, prompt_ids, device)
    B, P = prompt.shape
    K = num_beams
    if K < 2:
        raise ValueError("num_beams must be >= 2 (use generate for greedy)")
    cache_len = _generation_limits(model, P, max_new_tokens)
    NEG = -1e30
    logits, cache = prefill(model, prompt, cache_len)
    logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)
    V = logp0.shape[-1]
    scores, tok = torch.topk(logp0, K, dim=-1)                 # [B, K]
    cache = map_cache(lambda x, ax: x.repeat_interleave(K, dim=ax), cache)
    tokens = torch.full((B, K, max_new_tokens), pad_id, dtype=torch.long,
                        device=device)
    tokens[:, :, 0] = tok
    finished = (tok == eos_id if eos_id is not None
                else torch.zeros(B, K, dtype=torch.bool, device=device))
    pad_only = torch.full((V,), NEG, device=device)
    pad_only[pad_id] = 0.0
    rows = torch.arange(B, device=device)[:, None] * K
    for t in range(1, max_new_tokens):
        pos = torch.full((B * K,), P + t - 1, dtype=torch.int32,
                         device=device)
        last, cache = decode_step_body(
            model, cache, tok.reshape(B * K), cache_len=cache_len,
            positions=pos[:, None], write_pos=pos,
        )
        logp = torch.log_softmax(last.float(), dim=-1).reshape(B, K, V)
        logp = torch.where(finished[:, :, None], pad_only, logp)
        total = scores[:, :, None] + logp
        scores, idx = torch.topk(total.reshape(B, K * V), K, dim=-1)
        beam_idx = idx // V
        tok = idx % V
        tokens = torch.gather(
            tokens, 1, beam_idx[:, :, None].expand(B, K, max_new_tokens))
        tokens[:, :, t] = tok
        finished = torch.gather(finished, 1, beam_idx)
        if eos_id is not None:
            finished = finished | (tok == eos_id)
        gather = (rows + beam_idx).reshape(B * K)
        cache = map_cache(lambda x, ax: x.index_select(ax, gather), cache)
    if eos_id is not None:
        is_eos = tokens == eos_id
        has_eos = is_eos.any(-1)
        eos_pos = is_eos.int().argmax(-1)
        lengths = torch.where(has_eos, eos_pos + 1, max_new_tokens)
    else:
        lengths = torch.full((B, K), max_new_tokens, device=device)
    final = scores / (lengths.float() ** length_penalty)
    best = final.argmax(dim=1)
    seq = tokens[torch.arange(B, device=device), best]
    out = torch.cat([prompt, seq], dim=1)
    if return_scores:
        return out, final[torch.arange(B, device=device), best]
    return out
