"""Attention and rotary embeddings: the port of
``pytorch_distributed_tpu/ops/attention.py``.

* Grouped-query attention keeps the KV-head group as an einsum
  dimension: K/V are never repeated to the query heads.
* Logits and softmax are f32 while inputs stay in the compute dtype.
* The KV cache is an explicit argument: ``decode_cache`` writes into the
  tensors it is given (in place) and returns them, where the JAX version
  threads flax's ``cache`` collection.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from pytorch_distributed_tpu_torch.ops.paged_attention import (
    PagedView,
    paged_attention,
    paged_write,
)


def rope_frequencies(
    head_dim: int, max_seq_len: int, theta: float = 10_000.0,
    scaling=None, device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [max_seq_len, head_dim // 2], f32.

    ``scaling`` (a ``models.llama.RopeScaling`` or None) extends the
    context window: ``"linear"`` divides positions by ``factor``;
    ``"llama3"`` is HF's Llama-3.1 frequency-dependent scheme (long
    wavelengths slowed by ``factor``, short ones kept, the band between
    interpolated).
    """
    inv = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                  / head_dim)
    )
    t = torch.arange(max_seq_len, dtype=torch.float32)
    if scaling is not None:
        kind = scaling.type
        if kind == "linear":
            t = t / scaling.factor
        elif kind == "llama3":
            orig = scaling.original_max_position_embeddings
            lo_w = orig / scaling.low_freq_factor
            hi_w = orig / scaling.high_freq_factor
            wavelen = 2.0 * math.pi / inv
            smooth = (
                orig / wavelen - scaling.low_freq_factor
            ) / (scaling.high_freq_factor - scaling.low_freq_factor)
            smoothed = (1.0 - smooth) * inv / scaling.factor + smooth * inv
            inv = torch.where(
                wavelen > lo_w,
                inv / scaling.factor,
                torch.where(wavelen < hi_w, inv, smoothed),
            )
        else:
            raise NotImplementedError(
                f"rope scaling type {kind!r} (supported: linear, llama3)"
            )
    freqs = torch.outer(t, inv)
    return freqs.cos().to(device), freqs.sin().to(device)


def apply_rope(x, cos, sin, positions=None):
    """Rotate [B, S, H, D] by position (split-halves layout). Tables are
    gathered at ``positions`` [B, S] (default arange)."""
    if positions is None:
        c = cos[: x.shape[1]][None, :, None, :]
        s = sin[: x.shape[1]][None, :, None, :]
    else:
        c = cos[positions.long()][:, :, None, :]
        s = sin[positions.long()][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def dot_product_attention(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,  # [B, T, Hkv, D]
    *,
    causal: bool = False,
    q_offset=0,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Grouped attention with f32 logits; returns [B, S, Hq, D] in
    q.dtype.

    ``q_offset`` shifts query positions for the causal mask; a ``[B]``
    tensor gives every row its own offset (the serving engine's slots,
    each at its own length). ``window`` is sliding-window attention:
    position ``i`` sees keys in ``(i - window, i]``.
    """
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv != 0:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    if causal or window is not None:
        if window is not None and window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        dev = q.device
        if isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1:
            qpos = q_offset.long()[:, None] + torch.arange(S, device=dev)
        else:
            qpos = torch.arange(S, device=dev) + q_offset      # [S]
        kpos = torch.arange(T, device=dev)
        keep = qpos[..., :, None] >= kpos                     # [(B,) S, T]
        if window is not None:
            keep = keep & (qpos[..., :, None] - kpos < window)
        keep = keep[:, None, None] if keep.dim() == 3 else keep
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", weights.to(q.dtype), v)
    return out.reshape(B, S, Hq, D)


def validate_write_pos(write_pos, decode: bool, positions) -> None:
    """Per-row KV writes (``write_pos``) come with ``decode=True`` and
    explicit per-row positions, or not at all."""
    if write_pos is not None and (not decode or positions is None):
        raise ValueError(
            "write_pos (slot-pool decode) requires decode=True AND "
            "explicit per-row positions"
        )


def decode_cache(layer_cache, k, v, *, write_pos, paged: Optional[PagedView]):
    """Write this block's new K/V into its cache and return
    ``(k_all, v_all, offset)``; attend with ``q_offset=offset``.

    ``layer_cache`` is ``(k_buf, v_buf)``. Without ``paged`` these are
    dense ``[B, T, H, D]`` buffers: row ``b``'s ``S`` new entries land at
    ``write_pos[b] .. write_pos[b] + S - 1`` (the start clamped so the
    write fits, as ``dynamic_update_slice`` clamps), and the returned
    offset is ``write_pos``. With ``paged`` the buffers are the page pool
    ``[num_pages + 1, page_size, H, D]``: the write is a per-page write
    of only the W new positions (:func:`paged_write`; rows with
    ``keep=False`` write nothing) and the pool itself is returned for
    :func:`attention` to stream in place. Both forms write IN PLACE.
    """
    k_buf, v_buf = layer_cache
    if write_pos is None:
        raise ValueError(
            "decode_cache needs per-row write_pos: the port has no "
            "lockstep cache_index form"
        )
    if paged is not None:
        if k_buf.shape[1] != paged.page_size:
            raise ValueError(
                f"paged decode needs a page-pool cache ([num_pages + 1, "
                f"page_size={paged.page_size}, H, D], from "
                f"serve.kv_slots.init_page_cache); found "
                f"{tuple(k_buf.shape)}"
            )
        for buf, new in ((k_buf, k), (v_buf, v)):
            paged_write(buf, new, paged.page_tables, write_pos, paged.keep)
        return k_buf, v_buf, write_pos
    B, S = k.shape[0], k.shape[1]
    T = k_buf.shape[1]
    start = write_pos.long().clamp(0, T - S)
    rows = torch.arange(B, device=k.device)[:, None]
    cols = start[:, None] + torch.arange(S, device=k.device)
    k_buf[rows, cols] = k.to(k_buf.dtype)
    v_buf[rows, cols] = v.to(v_buf.dtype)
    return k_buf, v_buf, write_pos


def attention(q, k, v, *, causal=False, q_offset=0, scale=None,
              window=None, paged: Optional[PagedView] = None,
              impl: Optional[str] = None):
    """Dispatching attention: models call this instead of an impl.

    With ``paged`` (the serving engine's decode tick), ``k``/``v`` are
    the page pool buffers ``decode_cache`` just wrote, and the call goes
    to :func:`~pytorch_distributed_tpu_torch.ops.paged_attention.
    paged_attention` with ``lengths = q_offset``. Otherwise the plain
    ``dot_product_attention`` runs. ``impl="flash"`` (the blocked
    flash-attention kernel) is not ported yet.
    """
    if impl == "flash":
        raise NotImplementedError(
            "flash attention is not ported yet (ROADMAP item B1)"
        )
    if impl is not None:
        raise ValueError(f"unknown attention impl {impl!r}")
    if paged is not None:
        if not (isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1):
            raise ValueError(
                "paged decode requires the per-row q_offset form "
                "(decode_cache's write_pos return)"
            )
        return paged_attention(
            q, k, v, page_tables=paged.page_tables,
            lengths=q_offset.to(torch.int32), scale=scale, window=window,
        )
    return dot_product_attention(
        q, k, v, causal=causal, q_offset=q_offset, scale=scale,
        window=window,
    )
