"""Attention and rotary embeddings: the port of
``pytorch_distributed_tpu/ops/attention.py``.

* Grouped-query attention keeps the KV-head group as an einsum
  dimension: K/V are never repeated to the query heads.
* Logits and softmax are f32 while inputs stay in the compute dtype.
* ``attention`` sends every call the flash kernels take to
  ``ops/flash_attention.py`` on the card: the JAX package keeps its
  Pallas kernel opt-in for a TPU compile-time reason that does not carry
  over. The choice is per call (``impl=``); there is no global switch.
* The KV cache is an explicit argument: ``decode_cache`` writes into the
  tensors it is given (in place) and returns them, where the JAX version
  threads flax's ``cache`` collection.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from pytorch_distributed_tpu_torch.ops.flash_attention import flash_attention
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
    mask: Optional[torch.Tensor] = None,         # [B, T] key padding
    segment_ids: Optional[torch.Tensor] = None,  # [B, S] packing ids
    q_offset=0,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Grouped attention with f32 logits; returns [B, S, Hq, D] in
    q.dtype.

    ``mask`` is a ``[B, T]`` boolean keep-mask over the keys (padding).
    ``segment_ids`` restricts attention to pairs within one packed
    document (self-attention only). ``q_offset`` shifts
    query positions for the causal mask; a ``[B]`` tensor gives every row
    its own offset (the serving engine's slots, each at its own length).
    ``window`` is sliding-window attention: position ``i`` sees keys in
    ``(i - window, i]``.
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
    neg = torch.finfo(torch.float32).min
    if segment_ids is not None:
        if S != T:
            raise ValueError("segment_ids requires self-attention (S == T)")
        same = segment_ids[:, :, None] == segment_ids[:, None, :]  # [B, S, T]
        logits = logits.masked_fill(~same[:, None, None], neg)
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
        logits = logits.masked_fill(~keep, neg)
    if mask is not None:
        if tuple(mask.shape) != (B, T):
            raise ValueError(
                f"mask must be [B, T] = {(B, T)}, got {tuple(mask.shape)}"
            )
        keep = mask.to(torch.bool)[:, None, None, None, :]
        logits = logits.masked_fill(~keep, neg)
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

    ``layer_cache`` is ``(k_buf, v_buf)``, or the int8 cache's
    ``(k_q8, v_q8, k_scale, v_scale)`` (:func:`_decode_cache_int8`; dense
    only: int8 paged pools are ROADMAP A9.1). Without ``paged`` these are
    dense ``[B, T, H, D]`` buffers: row ``b``'s ``S`` new entries land at
    ``write_pos[b] .. write_pos[b] + S - 1`` (the start clamped so the
    write fits, as ``dynamic_update_slice`` clamps), and the returned
    offset is ``write_pos``. With ``paged`` the buffers are the page pool
    ``[num_pages + 1, page_size, H, D]``: the write is a per-page write
    of only the W new positions (:func:`paged_write`; rows with
    ``keep=False`` write nothing) and the pool itself is returned for
    :func:`attention` to stream in place. Both forms write IN PLACE.
    """
    if write_pos is None:
        raise ValueError(
            "decode_cache needs per-row write_pos: the port has no "
            "lockstep cache_index form"
        )
    if len(layer_cache) == 4:
        if paged is not None:
            raise NotImplementedError(
                "int8 paged KV pools are not ported (ROADMAP A9.1)")
        return _decode_cache_int8(layer_cache, k, v, write_pos)
    k_buf, v_buf = layer_cache
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
    rows, cols = _write_index(k, k_buf.shape[1], write_pos)
    k_buf[rows, cols] = k.to(k_buf.dtype)
    v_buf[rows, cols] = v.to(v_buf.dtype)
    return k_buf, v_buf, write_pos


def _write_index(k, T: int, write_pos):
    """(rows, cols) of row ``b``'s ``S`` new entries: ``write_pos[b] ..
    write_pos[b] + S - 1``, the start clamped so the write fits."""
    B, S = k.shape[0], k.shape[1]
    start = write_pos.long().clamp(0, T - S)
    rows = torch.arange(B, device=k.device)[:, None]
    cols = start[:, None] + torch.arange(S, device=k.device)
    return rows, cols


def _decode_cache_int8(layer_cache, k, v, write_pos):
    """The int8 dense cache: ``(k_q8, v_q8, k_scale, v_scale)`` buffers
    ``[B, T, H, D]`` int8 and ``[B, T, H, 1]`` f32. New entries quantize
    per token (the scale reduces head_dim only: ``ops.quant.
    symmetric_int8``, the weights' own core) at the write; the read
    dequantizes the whole cache to ``k.dtype`` (f32 product, then the
    cast, as the JAX package does). Lossy: about 1e-2 relative a
    value."""
    from pytorch_distributed_tpu_torch.ops.quant import symmetric_int8

    kq, vq, ks, vs = layer_cache
    rows, cols = _write_index(k, kq.shape[1], write_pos)
    for buf, sbuf, new in ((kq, ks, k), (vq, vs, v)):
        q, s = symmetric_int8(new, -1)
        buf[rows, cols] = q
        sbuf[rows, cols] = s
    k_all = (kq.float() * ks).to(k.dtype)
    v_all = (vq.float() * vs).to(v.dtype)
    return k_all, v_all, write_pos


#: the names of a layer's cache buffers, in the port's tuple order (the
#: JAX package's ``cache`` collection names)
CACHE_NAMES = {
    2: ("cached_key", "cached_value"),
    4: ("cached_key", "cached_value", "cached_key_scale",
        "cached_value_scale"),
}


def init_layer_cache(batch: int, length: int, heads: int, head_dim: int, *,
                     dtype, device, quantize: Optional[str] = None):
    """One layer's zeroed dense cache: ``(k, v)`` in ``dtype``, or with
    ``quantize="int8"`` int8 payloads and f32 per-token scales (ones, as
    the JAX package initializes them)."""
    shape = (batch, length, heads, head_dim)
    if quantize is None:
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))
    if quantize != "int8":
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    sshape = shape[:-1] + (1,)
    return (torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.ones(sshape, dtype=torch.float32, device=device),
            torch.ones(sshape, dtype=torch.float32, device=device))


def cache_batch_axis(name: str, leaf: torch.Tensor) -> Optional[int]:
    """Batch axis of a decode-cache buffer, or None for a shared one. KV
    payloads are ``[B, T, H, D]`` and the int8 cache's per-token scales
    ``[B, T, H, 1]``: the scales move with their payloads. Shared by
    ``generate_beam`` (beam replicate and reorder) and anything that
    moves rows of a cache."""
    if name in CACHE_NAMES[4]:
        return leaf.dim() - 4
    return None


def map_cache(fn, cache):
    """``fn(buffer, batch_axis)`` applied to every per-row buffer of a
    dense cache (a list of per-layer tuples), buffers without a batch
    axis passed through."""
    out = []
    for layer in cache:
        names = CACHE_NAMES[len(layer)]
        out.append(tuple(
            buf if (ax := cache_batch_axis(n, buf)) is None else fn(buf, ax)
            for n, buf in zip(names, layer)))
    return out


def cache_bytes(cache) -> int:
    """Resident bytes of a dense cache, scales included."""
    return sum(b.numel() * b.element_size() for layer in cache for b in layer)


def attention(q, k, v, *, causal=False, mask=None, segment_ids=None,
              q_offset=0, scale=None, window=None,
              paged: Optional[PagedView] = None, impl: Optional[str] = None):
    """Dispatching attention: models call this instead of an impl.

    With ``paged`` (the serving engine's decode tick), ``k``/``v`` are
    the page pool buffers ``decode_cache`` just wrote, and the call goes
    to :func:`~pytorch_distributed_tpu_torch.ops.paged_attention.
    paged_attention` with ``lengths = q_offset``.

    Otherwise a call the flash kernels take goes to
    :func:`~pytorch_distributed_tpu_torch.ops.flash_attention.
    flash_attention`: a plain ``0`` offset, no window, more than one
    query (the gate of the JAX
    package's dispatcher). ``impl`` picks per call: ``None`` takes flash
    for every such call on a CUDA card and the plain einsum path
    (:func:`dot_product_attention`) everywhere else; ``"flash"`` forces
    flash (its plain blocked version on the CPU) and raises for a call
    it cannot take; ``"xla"`` forces the einsum path.
    """
    if impl not in (None, "flash", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if paged is not None:
        if mask is not None or segment_ids is not None:
            raise NotImplementedError(
                "paged decode supports plain causal attention only (no "
                "mask or segment_ids: the serving engine's decode contract)"
            )
        if not (isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1):
            raise ValueError(
                "paged decode requires the per-row q_offset form "
                "(decode_cache's write_pos return)"
            )
        return paged_attention(
            q, k, v, page_tables=paged.page_tables,
            lengths=q_offset.to(torch.int32), scale=scale, window=window,
        )
    if mask is not None and mask.dim() != 2:
        raise ValueError(
            f"mask must be a [B, T] key mask, got {tuple(mask.shape)}"
        )
    flash_ok = (
        isinstance(q_offset, int) and q_offset == 0
        and window is None
        and q.shape[1] > 1
    )
    if impl == "flash" and not flash_ok:
        raise ValueError(
            "impl='flash' takes no offset, window or single-query call; "
            "use impl=None or 'xla'"
        )
    if impl == "flash" or (impl is None and flash_ok and q.is_cuda):
        return flash_attention(
            q, k, v, causal=causal, kv_mask=mask, segment_ids=segment_ids,
            sm_scale=scale,
        )
    return dot_product_attention(
        q, k, v, causal=causal, mask=mask, segment_ids=segment_ids,
        q_offset=q_offset, scale=scale, window=window,
    )
