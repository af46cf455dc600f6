"""Per-row sampling for heterogeneous slot batches: the port of
``pytorch_distributed_tpu/serve/sampling.py``.

Parameters arrive as ``[B]`` tensors and every row follows the math of
``generation.filter_logits``/``sample_logits`` with that row's values.
Exactness rules (why the always-on filter is a no-op for "off" rows, bit
for bit):

* ``top_k`` off is encoded as ``k = V``: the k-th sorted logit is the row
  minimum, and ``logits < min`` masks nothing.
* ``top_p`` off is encoded as ``inf``: every sorted entry survives
  ``cum_before < inf``, and ``logits < min`` again masks nothing.
  (Encoding "off" as 1.0 would be almost right, but an f32 cumsum can
  overshoot 1.0 and drop a tail token an unfiltered row would keep.)
* Filters only mask (set to the f32 minimum); kept logits are never
  rewritten.
* Greedy rows (``temperature == 0``) take ``argmax`` of the RAW logits;
  their lane through the sampling path divides by a substituted 1.0 and
  is discarded by the final select.

Randomness is Gumbel-max over noise the caller draws from each row's own
``torch.Generator`` (``generation.gumbel_noise``), so a row's stream
depends only on its own seed, whatever shares the batch.
"""

from __future__ import annotations

import math

import torch

#: per-row encodings of "filter off" (see module docstring)
TOP_K_OFF = 0
TOP_P_OFF = math.inf


def filter_logits_rows(
    logits: torch.Tensor,   # [B, V]
    temps: torch.Tensor,    # [B] f32; rows with 0 are greedy (caller selects)
    top_ks: torch.Tensor,   # [B] int; TOP_K_OFF (0) = no k filter
    top_ps: torch.Tensor,   # [B] f32; TOP_P_OFF (inf) = no p filter
) -> torch.Tensor:
    """Row-wise ``generation.filter_logits``: scale, k-filter, p-filter."""
    V = logits.shape[-1]
    neg_inf = torch.finfo(torch.float32).min
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps)).float()
    l32 = logits.float() / safe_t[:, None]
    # one descending sort serves both filters
    sorted_desc = torch.sort(l32, dim=-1, descending=True).values
    k = torch.where(top_ks > 0, top_ks.clamp(max=V), V).long()
    kth = torch.gather(sorted_desc, -1, (k - 1)[:, None])
    l32 = torch.where(l32 < kth, neg_inf, l32)
    ranks = torch.arange(V, device=logits.device)
    sorted_desc = torch.where(ranks[None, :] < k[:, None], sorted_desc, neg_inf)
    # a token survives if the cumulative probability BEFORE it is still
    # < top_p (the top token always survives)
    probs = torch.softmax(sorted_desc, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    keep = cum_before < top_ps.float()[:, None]
    thresh = torch.where(keep, sorted_desc, math.inf).amin(
        dim=-1, keepdim=True
    )
    return torch.where(l32 < thresh, neg_inf, l32)


def sample_logits_rows(
    logits: torch.Tensor,   # [B, V]
    noise: torch.Tensor,    # [B, V] Gumbel noise (ignored on greedy rows)
    temps: torch.Tensor,
    top_ks: torch.Tensor,
    top_ps: torch.Tensor,
) -> torch.Tensor:
    """[B, V] logits -> [B] token ids, each row by its own params/noise.

    Greedy rows (``temps == 0``) are ``argmax`` of the raw logits;
    sampling rows take the Gumbel-max draw from their filtered
    distribution, the per-row transcript of ``generation.sample_logits``.
    """
    filtered = filter_logits_rows(logits, temps, top_ks, top_ps)
    sampled = torch.argmax(filtered + noise, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temps <= 0, greedy, sampled)
