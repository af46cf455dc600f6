"""Speculative decoding: the port of
``pytorch_distributed_tpu/speculative.py``.

A small DRAFT model proposes ``num_draft_tokens`` (k) tokens one at a
time; the TARGET scores the whole proposal in one ``[B, k + 1]`` pass;
the longest agreeing prefix is accepted, plus the target's own next
token, so each target pass emits 1 to k + 1 tokens (Leviathan et al.
2023).

* ``temperature=0``: accept while the target's argmax agrees. The output
  is exactly the target's greedy decode (:func:`generation.generate`),
  whatever the draft does.
* ``temperature>0``: :func:`speculative_accept` (Algorithm 1): accept a
  proposal ``x ~ q`` with probability ``min(1, p(x)/q(x))``, else draw
  from ``norm(max(0, p - q))``; after a fully accepted round the bonus
  token comes from ``p``. The output is distributed as the target's own
  sampling (``filter_logits``' distribution), not token-equal to any
  one ``generate`` run.

The cache is append-only, as in the JAX package: rejected drafts are
never erased, their slots are masked out through a per-row ``kv_mask``,
and each round appends ``k + 1`` slots to both caches, so a cache holds
``P + (max_new - 1) * (k + 1)`` slots in the worst case. Positions are
per-row REAL token counts (the learned ``wpe`` and RoPE stay exact), the
slot offset orders the queries inside a round. The rounds are a Python
loop (one host read a round, of whether every row is done), where the
JAX package runs ``lax.while_loop``. All draws come from one explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_distributed_tpu_torch.generation import (
    _on_device,
    filter_logits,
    gumbel_noise,
    model_max_len,
    prefill,
    ragged_prompt_state,
    sample_logits,
)
from pytorch_distributed_tpu_torch.runtime.device import DeviceLike


def speculative_accept(
    p_probs: torch.Tensor,    # [B, k+1, V] target probs per chunk slot
    q_probs: torch.Tensor,    # [B, k, V] draft probs per proposal
    proposals: torch.Tensor,  # [B, k] draft-sampled tokens
    generator: Optional[torch.Generator] = None,
    *,
    coins: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
):
    """Rejection-sampling acceptance: ``(a, corr)``, each row's accepted
    prefix length in ``[0, k]`` and the round's last token, drawn from
    the residual ``norm(max(0, p_a - q_a))`` after a rejection or from
    the bonus ``p_k`` after full acceptance. The draws are ``coins``
    ``[B, k]`` uniform in [0, 1) and ``gumbel`` ``[B, V]`` Gumbel(0, 1)
    noise for the residual's categorical draw; each one not supplied is
    drawn from ``generator`` (the coins first)."""
    B, k, V = q_probs.shape
    dev = q_probs.device
    if coins is None:
        coins = torch.rand((B, k), generator=generator, device=dev)
    if gumbel is None:
        gumbel = gumbel_noise((B, V), generator, dev)
    prop = proposals.long()[..., None]
    px = torch.gather(p_probs[:, :k], 2, prop)[..., 0]
    qx = torch.gather(q_probs, 2, prop)[..., 0]
    # q sampled the proposal, so qx > 0; coins < 1 so p == q accepts
    accept = coins < px / torch.clamp(qx, min=1e-30)
    a = torch.cumprod(accept.to(torch.int64), dim=1).sum(dim=1)
    at = a[:, None, None].expand(B, 1, V)
    p_a = torch.gather(p_probs, 1, at)[:, 0]
    q_ext = torch.cat([q_probs, q_probs.new_zeros(B, 1, V)], dim=1)
    q_a = torch.gather(q_ext, 1, at)[:, 0]
    res = torch.clamp(p_a - q_a, min=0.0)
    res = res / torch.clamp(res.sum(-1, keepdim=True), min=1e-30)
    corr = torch.argmax(torch.log(torch.clamp(res, min=1e-38)) + gumbel,
                        dim=-1)
    return a, corr


@torch.no_grad()
def generate_speculative(
    target_model,
    draft_model,
    prompt_ids,
    *,
    max_new_tokens: int,
    num_draft_tokens: int = 4,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
    prompt_mask=None,
    return_stats: bool = False,
    device: DeviceLike = None,
):
    """Decode ``max_new_tokens`` from ``target_model`` with
    ``draft_model``'s proposals. Returns [B, P + max_new_tokens] (rows
    that hit ``eos_id`` padded with ``pad_id`` after it), and with
    ``return_stats`` also ``{"rounds", "drafted", "accepted"}`` (host
    ints: target passes after the prefill, proposals a row could
    consume, ``min(k, tokens left)``, and accepted drafts that landed in
    the output).

    ``temperature=0`` equals greedy :func:`generation.generate` token for
    token; ``temperature>0`` is distributed as ``generate`` with the same
    ``temperature``/``top_k``/``top_p``. ``prompt_mask`` takes ragged,
    LEFT-padded batches as ``generate`` does. Both models share one
    vocabulary and the decode contract (``positions``, ``write_pos``,
    ``cache_len``, ``kv_mask``)."""
    sampling = temperature != 0.0
    if sampling and temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if not sampling and (top_k is not None or top_p is not None):
        raise ValueError(
            "top_k/top_p filter a sampling distribution; greedy "
            "(temperature=0) has none — set temperature > 0")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    k = num_draft_tokens
    if k < 1:
        raise ValueError(f"num_draft_tokens must be >= 1, got {k}")
    for name, model in (("target", target_model), ("draft", draft_model)):
        if getattr(getattr(model, "config", None), "sliding_window", None):
            raise NotImplementedError(
                f"speculative decoding over a sliding-window {name} model: "
                "the band mask measures cache slots, and this cache holds "
                "rejected-draft bubbles (decode non-speculatively)")
    device, prompt = _on_device(target_model, prompt_ids, device)
    if draft_model.device != device:
        raise ValueError(
            f"the draft lives on {draft_model.device}, the target on "
            f"{device}")
    B, P = prompt.shape
    cache_len = P + (max_new_tokens - 1) * (k + 1)
    for name, model in (("target", target_model), ("draft", draft_model)):
        limit = model_max_len(model)
        if limit is not None and cache_len > limit:
            raise ValueError(
                f"{name} model needs {cache_len} cache slots in the worst "
                f"case (prompt {P} + {max_new_tokens - 1} rounds x {k + 1} "
                f"append-only slots) but its maximum length is {limit}; "
                "shrink max_new_tokens or num_draft_tokens")
    if generator is None and sampling:
        generator = torch.Generator(device=device).manual_seed(0)
    filt_kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    N = P + max_new_tokens
    idx = torch.arange(k + 1, device=device)[None, :]

    prompt_lens = torch.full((B,), P, dtype=torch.long, device=device)
    prompt_valid = torch.ones(B, P, dtype=torch.bool, device=device)
    positions = None
    if prompt_mask is not None:
        prompt_valid, positions, prompt_lens, _ = ragged_prompt_state(
            torch.as_tensor(prompt_mask, device=device), B, P, cache_len)
    mask_t = torch.ones(B, cache_len, dtype=torch.bool, device=device)
    mask_t[:, :P] = prompt_valid
    mask_d = mask_t.clone()

    t_logits, cache_t = prefill(target_model, prompt, cache_len, positions,
                                mask_t)
    _, cache_d = prefill(draft_model, prompt, cache_len, positions, mask_d)
    tok0 = sample_logits(t_logits[:, -1], generator, **filt_kw)

    out = torch.full((B, N + 1), pad_id, dtype=torch.long, device=device)
    out[:, :P] = prompt
    out[:, P] = tok0
    emitted = torch.ones(B, dtype=torch.long, device=device)
    done = emitted >= max_new_tokens
    if eos_id is not None:
        done = done | (tok0 == eos_id)
    x_last = tok0
    c = P                          # the next cache slot, both caches
    rounds, drafted, accepted = 0, 0, 0
    rows = torch.arange(B, device=device)[:, None].expand(B, k + 1)

    def slots(s):
        return torch.full((B,), s, dtype=torch.int32, device=device)

    while not bool(done.all()):
        base_pos = prompt_lens + emitted - 1       # x_last's position
        # ---- draft: k single-token steps, then one cache fill ----------
        tok, drafts, q_steps = x_last, [], []
        for j in range(k):
            logits, cache_d = draft_model(
                tok[:, None], (base_pos + j)[:, None], cache=cache_d,
                write_pos=slots(c + j), decode=True, cache_len=cache_len,
                kv_mask=mask_d)
            last = logits[:, -1]
            if sampling:
                filt = filter_logits(last, **filt_kw)
                tok = torch.argmax(
                    filt + gumbel_noise(filt.shape, generator, device), -1)
                q_steps.append(torch.softmax(filt, dim=-1))
            else:
                tok = torch.argmax(last, dim=-1)
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)                      # [B, k]
        # the last proposal's K/V, so a fully accepted round leaves no
        # hole in the draft's cache
        _, cache_d = draft_model(
            drafts[:, -1:], (base_pos + k)[:, None], cache=cache_d,
            write_pos=slots(c + k), decode=True, cache_len=cache_len,
            kv_mask=mask_d)
        # ---- target: one pass over [x_last, drafts] ---------------------
        chunk = torch.cat([x_last[:, None], drafts], dim=1)
        logits, cache_t = target_model(
            chunk, base_pos[:, None] + idx, cache=cache_t,
            write_pos=slots(c), decode=True, cache_len=cache_len,
            kv_mask=mask_t)
        if sampling:
            p_probs = torch.softmax(filter_logits(logits, **filt_kw), -1)
            a, corr = speculative_accept(
                p_probs, torch.stack(q_steps, dim=1), drafts, generator)
            corr = corr[:, None]
        else:
            preds = torch.argmax(logits, dim=-1)                # [B, k+1]
            match = drafts == preds[:, :k]
            a = torch.cumprod(match.to(torch.int64), dim=1).sum(dim=1)
            corr = torch.gather(preds, 1, a[:, None])
        drafts_ext = torch.cat([drafts, drafts.new_zeros(B, 1)], dim=1)
        emit_tok = torch.where(idx < a[:, None], drafts_ext, corr)

        n_emit = a + 1
        if eos_id is not None:
            is_eos = (emit_tok == eos_id) & (idx < n_emit[:, None])
            first = torch.argmax(is_eos.to(torch.int64), dim=1)
            n_emit = torch.where(is_eos.any(1), first + 1, n_emit)
        remaining = max_new_tokens - emitted
        n_emit = torch.minimum(n_emit, remaining)
        n_emit = torch.where(done, 0, n_emit)
        live = idx < n_emit[:, None]
        cols = torch.where(live, P + emitted[:, None] + idx, N)
        out[rows, cols] = emit_tok          # dead slots land in column N

        # valid K/V of this round: x_last (slot 0) and the accepted drafts
        ok = (idx == 0) | (idx - 1 < a[:, None])
        mask_t[:, c:c + k + 1] = ok
        mask_d[:, c:c + k + 1] = ok

        active = ~done
        consumable = torch.clamp(remaining, max=k)
        landed = torch.minimum(a, n_emit)
        drafted += int((consumable * active).sum())
        accepted += int((landed * active).sum())
        emitted = emitted + n_emit
        new_done = done | (emitted >= max_new_tokens)
        if eos_id is not None:
            new_done = new_done | ((emit_tok == eos_id) & live).any(1)
        last = torch.gather(emit_tok, 1,
                            torch.clamp(n_emit - 1, min=0)[:, None])[:, 0]
        x_last = torch.where(done, x_last, last)
        done = new_done
        c += k + 1
        rounds += 1
    out = out[:, :N]
    if return_stats:
        return out, {"rounds": rounds, "drafted": drafted,
                     "accepted": accepted}
    return out
