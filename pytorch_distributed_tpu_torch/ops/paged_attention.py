"""Paged decode attention: attention that reads K/V straight from the
page pool (serve/kv_slots), the port of
``pytorch_distributed_tpu/ops/paged_attention.py``.

The decode-attention primitive takes the pooled KV frames
``[num_pages + 1, page_size, Hkv, D]`` (frame 0 the reserved null page),
per-row page tables ``[B, n_pages]`` and per-row lengths, and computes
``[B, W, Hq, D]`` attention for W queries per row with the ragged
lengths masked inside the op.

The serving engine hands the model a :class:`PagedView` for its decode
tick. ``ops.attention.decode_cache`` then writes the new K/V through
:func:`paged_write` and ``ops.attention.attention`` dispatches here.
Where the JAX package installs the view as a trace-scoped global, the
port passes it down the model's ``forward`` as an argument.

Three implementations:

* the kernel (``csrc/paged_attention.cu``, CUDA C++ for ``sm_90a``,
  built with ``nvcc`` at first use and loaded with ``ctypes``): what a
  CUDA tensor gets. It launches the kernel or raises; there is no
  fallback. The kernel splits each row's keys over several CTAs
  (:func:`pages_per_split`) and merges their partial softmax carries in
  a second launch; :func:`paged_attention_split_reference` is that split
  and merge in plain PyTorch, for the tests.
* ``"stream"``: the plain PyTorch page loop with an online-softmax
  carry, the documented semantics of the kernel. A CPU tensor gets it.
* ``"gather"``: materialize the pages into a per-row dense slab and run
  the unchanged ``dot_product_attention``.

``impl="gather"|"stream"`` select a plain version explicitly; on the
card they serve the tests and ``chip_smoke.py``'s comparison only.

int8 KV pools (``kv_cache_quantize="int8"``): payload and per-token scale
pools ride together as :class:`PagedKVQuant`; ``gather`` and ``stream``
dequantize per page with the dense cache's formula (int8 -> f32 x scale
-> the compute dtype). The kernel takes fp pools only, so the dispatch
sends a quantized pool to ``gather`` on every device, by design and not
on failure, as the JAX dispatch does; an int8 form of the kernel is
speed work (ROADMAP B item 4).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from pytorch_distributed_tpu_torch.ops import kernel_build

_NEG_INF = -1e30  # finite, like the Pallas kernel: no (-inf) - (-inf) NaN
#: CTAs the kernel's split over the key axis aims for: about four per SM
#: of an H100 (132 SMs), so that two per SM still have keys to read when
#: the rows fill half of their table
_TARGET_CTAS = 512
#: pages one CTA may walk (csrc/paged_attention.cu's kMaxPagesPerSplit:
#: its page-table entries sit in shared memory)
_MAX_PAGES_PER_SPLIT = 1024


@dataclasses.dataclass(frozen=True)
class PagedView:
    """What the attention layers need to decode in place over the pool.

    ``page_tables`` is sliced by the engine to a length bucket's width
    (and made contiguous for the kernel); ``keep`` gates writes per row:
    False rows (free / mid-prefill slots) write nothing to the pool.
    """

    page_tables: torch.Tensor  # [B, n_pages] int32
    keep: torch.Tensor         # [B] bool
    page_size: int


class PagedKVQuant(NamedTuple):
    """An int8 page pool and its per-token scale pool, moving as one.

    ``decode_cache`` returns this pair in paged mode; the model passes it
    to ``attention`` untouched, and the dispatch dequantizes per page."""

    pages: torch.Tensor   # [P1, ps, H, D] int8
    scale: torch.Tensor   # [P1, ps, H, 1] f32
    dtype: torch.dtype    # the compute dtype attention sees


def _unpack(kv):
    if isinstance(kv, PagedKVQuant):
        return kv.pages, kv.scale, kv.dtype
    return kv, None, None


# --------------------------------------------------------------------------
# per-page writes
# --------------------------------------------------------------------------


def write_positions(pool, page_tables, positions, new, keep):
    """Write ``new[b, w]`` to position ``positions[b, w]`` of row ``b``
    through its page table, IN PLACE; ``keep[b, w]`` False writes
    nothing. The shared core of :func:`paged_write` and
    ``serve.kv_slots.scatter_kv``.

    Each position maps to entry
    ``page_tables[b, pos // page_size] * page_size + pos % page_size``
    of the flattened pool. Dropped entries are redirected onto the null
    page's first entry with that entry's own contents, so the pool is
    unchanged and no host sync is needed to drop them. Returns ``pool``.
    """
    P1, ps = pool.shape[0], pool.shape[1]
    B, W = positions.shape
    pos = positions.long()
    # positions beyond the (bucket-sliced) table clamp; such entries are
    # always keep=False, so the clamped index is dropped below anyway
    idx = (pos // ps).clamp(max=page_tables.shape[1] - 1)
    page = torch.gather(page_tables.long(), 1, idx)
    dst = (page * ps + pos % ps).reshape(-1)
    flat = pool.view((P1 * ps,) + tuple(pool.shape[2:]))
    upd = new.to(pool.dtype).reshape((B * W,) + tuple(pool.shape[2:]))
    kept = keep.reshape(-1)
    dst = torch.where(kept, dst, torch.zeros_like(dst))
    upd = torch.where(
        kept.view((-1,) + (1,) * (upd.dim() - 1)), upd, flat[0]
    )
    flat.index_copy_(0, dst, upd)
    return pool


def paged_write(pool, new, page_tables, write_pos, keep):
    """Write ``new`` rows into the page pool through the page table, IN
    PLACE (the JAX version rebinds a donated buffer).

    ``pool`` is ``[num_pages + 1, page_size, ...]``; ``new`` is
    ``[B, W, ...]``: row ``b``'s W entries land at positions
    ``write_pos[b] .. write_pos[b] + W - 1``; rows with ``keep[b]``
    False write nothing. Returns ``pool``.
    """
    B, W = new.shape[0], new.shape[1]
    pos = write_pos.long()[:, None] + torch.arange(W, device=pool.device)
    return write_positions(
        pool, page_tables, pos, new, keep[:, None].expand(B, W)
    )


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------


def _validate(q, k_pages, v_pages, page_tables, lengths, window):
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(
            f"q must be [B, W, Hq, D] and the pools [P1, ps, Hkv, D]; got "
            f"{tuple(q.shape)} and {tuple(k_pages.shape)}"
        )
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages must match in shape and dtype")
    B, W, Hq, D = q.shape
    Hkv, Dk = k_pages.shape[2], k_pages.shape[3]
    if D != Dk:
        raise ValueError(f"head_dim mismatch: q {D} vs pool {Dk}")
    if Hq % Hkv:
        raise ValueError(
            f"query heads {Hq} not a multiple of kv heads {Hkv}"
        )
    if page_tables.dim() != 2 or page_tables.shape[0] != B:
        raise ValueError(
            f"page_tables must be [batch, n_pages] = [{B}, *], got "
            f"{tuple(page_tables.shape)}"
        )
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(lengths.shape)}")
    if page_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page_tables and lengths must be int32")
    devices = {t.device for t in (q, k_pages, v_pages, page_tables, lengths)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def paged_attention(
    q: torch.Tensor,  # [B, W, Hq, D]
    k_pages,          # [P1, ps, Hkv, D], or a PagedKVQuant
    v_pages,          # [P1, ps, Hkv, D], or a PagedKVQuant
    *,
    page_tables: torch.Tensor,  # [B, n_pages] int32 (bucket-sliced)
    lengths: torch.Tensor,      # [B] int32: tokens cached BEFORE this call
    scale: Optional[float] = None,
    window: Optional[int] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Decode attention over the page pool; returns [B, W, Hq, D].

    Query ``j`` of row ``b`` sits at absolute position
    ``lengths[b] + j`` and attends positions ``<= lengths[b] + j``
    (``window`` further restricts to the sliding band; a key exactly
    ``window`` back is masked), with the new tokens' own K/V already
    written into the pool. Unused table entries hold null page 0; they
    back positions ``>= lengths[b] + W`` and are masked, so the null
    page's contents are unobservable.

    ``impl=None`` launches the CUDA kernel for CUDA tensors (counted in
    ``paged_attention.launches``) and runs the plain ``"stream"`` version
    for CPU tensors; ``"gather"`` and ``"stream"`` select a plain version
    on any device. The kernel takes float32 or bfloat16, head_dim 64, 128
    or 256, and at most 64 query rows (G * W) per kv head; it raises on
    anything else. An int8 pool (:class:`PagedKVQuant`) goes to
    ``"gather"`` with ``impl=None``: the kernel takes fp pools only.
    """
    k_pages, k_scale, kdt = _unpack(k_pages)
    v_pages, v_scale, _ = _unpack(v_pages)
    _validate(q, k_pages, v_pages, page_tables, lengths, window)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl is None and k_scale is not None:
        impl = "gather"
    if impl == "gather":
        return _paged_gather(
            q, k_pages, v_pages, page_tables, lengths, scale, window,
            k_scale, v_scale, kdt,
        )
    if impl == "stream":
        return paged_attention_reference(
            q, k_pages, v_pages, page_tables=page_tables, lengths=lengths,
            scale=scale, window=window, k_scale=k_scale, v_scale=v_scale,
            out_dtype=kdt,
        )
    if impl is not None:
        raise ValueError(
            f"impl must be None, 'gather' or 'stream', got {impl!r}"
        )
    if q.is_cuda:
        return _kernel_call(
            q, k_pages, v_pages, page_tables, lengths, scale, window
        )
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, page_tables=page_tables, lengths=lengths,
            scale=scale, window=window,
        )
    raise ValueError(f"paged_attention has no path for {q.device}")


#: calls that launched the kernel since the count was last set to 0 (its
#: split and merge launches count once; plain versions and CPU calls never
#: count)
paged_attention.launches = 0


# --------------------------------------------------------------------------
# "gather": bucket-wide dense slab + the unchanged dense attention math
# --------------------------------------------------------------------------


def gather_dense(pages, tables, scale_pages=None, dtype=None):
    """[P1, ps, H, D] + [B, n] tables -> [B, n*ps, H, D] dense slab,
    dequantized with the dense int8 cache's formula (int8 -> f32 x scale
    -> ``dtype``) when ``scale_pages`` ride."""
    B, n = tables.shape
    ps = pages.shape[1]
    flat = tables.reshape(-1).long()
    out = pages.index_select(0, flat)
    if scale_pages is not None:
        out = (out.float() * scale_pages.index_select(0, flat)).to(dtype)
    return out.reshape((B, n * ps) + tuple(pages.shape[2:]))


def _paged_gather(q, k_pages, v_pages, tables, lengths, scale, window,
                  k_scale=None, v_scale=None, kdt=None):
    from pytorch_distributed_tpu_torch.ops.attention import (
        dot_product_attention,
    )

    dt = kdt or q.dtype
    return dot_product_attention(
        q, gather_dense(k_pages, tables, k_scale, dt),
        gather_dense(v_pages, tables, v_scale, dt),
        causal=True, q_offset=lengths, scale=scale, window=window,
    )


# --------------------------------------------------------------------------
# "stream": the plain page loop with an online-softmax carry
# --------------------------------------------------------------------------


def _carry_over_pages(qg, k_pages, v_pages, tables, qpos, scale, window,
                      pages, lo=None, hi=None, k_scale=None, v_scale=None,
                      kdt=None):
    """The online-softmax carry (m, l, acc) in f32 over ``pages`` of every
    row's table, one page per step: logits in f32, keys a query cannot see
    at ``-1e30``, keys outside ``[lo, hi)`` (per row, when given) at
    ``-inf``, probabilities rounded to the pool's dtype before P.V (an
    int8 pool's pages dequantized to ``kdt`` first)."""
    B, W, Hkv, G, D = qg.shape
    ps = k_pages.shape[1]
    dev = qg.device
    m = torch.full((B, W, Hkv, G), _NEG_INF, device=dev)
    l = torch.zeros((B, W, Hkv, G), device=dev)
    acc = torch.zeros((B, W, Hkv, G, D), device=dev)
    for i in pages:
        frames = tables[:, i]
        k = k_pages.index_select(0, frames)           # [B, ps, Hkv, D]
        v = v_pages.index_select(0, frames)
        if k_scale is not None:
            k = (k.float() * k_scale.index_select(0, frames)).to(kdt)
            v = (v.float() * v_scale.index_select(0, frames)).to(kdt)
        k = k.float()
        s = torch.einsum("bwkgd,bpkd->bwkgp", qg, k) * scale
        kpos = i * ps + torch.arange(ps, device=dev)
        keep = qpos[:, :, None] >= kpos                # [B, W, ps]
        if window is not None:
            keep = keep & (qpos[:, :, None] - kpos < window)
        s = torch.where(keep[:, :, None, None, :], s, _NEG_INF)
        if lo is not None:
            inside = (kpos >= lo[:, None]) & (kpos < hi[:, None])
            s = torch.where(inside[:, None, None, None, :], s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bwkgp,bpkd->bwkgd", p.to(v.dtype).float(), v.float()
        )
        m = m_new
    return m, l, acc


def _grouped(q, k_pages, lengths):
    """q as ``[B, W, Hkv, G, D]`` f32 and the queries' positions
    ``[B, W]``."""
    B, W, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    qpos = lengths.long()[:, None] + torch.arange(W, device=q.device)
    return q.reshape(B, W, Hkv, Hq // Hkv, D).float(), qpos


def paged_attention_reference(
    q, k_pages, v_pages, *, page_tables, lengths,
    scale: Optional[float] = None, window: Optional[int] = None,
    k_scale=None, v_scale=None, out_dtype=None,
):
    """One page of K/V per step, online-softmax carry (m, l, acc) in f32.

    The semantics the kernel implements, step for step as the JAX
    ``"stream"`` reference: logits in f32, masked logits ``-1e30``,
    probabilities rounded to the pool's dtype before the P.V product.
    ``k_scale``/``v_scale`` dequantize an int8 pool per page to
    ``out_dtype`` (default q's dtype).
    """
    B, W, Hq, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg, qpos = _grouped(q, k_pages, lengths)
    m, l, acc = _carry_over_pages(
        qg, k_pages, v_pages, page_tables.long(), qpos, scale, window,
        range(page_tables.shape[1]), k_scale=k_scale, v_scale=v_scale,
        kdt=out_dtype or q.dtype,
    )
    safe = torch.where(l > 0, l, torch.ones_like(l))
    out = (acc / safe[..., None]).to(q.dtype)
    return out.reshape(B, W, Hq, D)


# --------------------------------------------------------------------------
# the kernel's split over the key axis and its merge, in plain PyTorch
# --------------------------------------------------------------------------


def pages_per_split(batch: int, kv_heads: int, n_pages: int) -> int:
    """Pages of the table each CTA of the kernel walks: enough splits of
    every row that ``batch * kv_heads * splits`` reaches about
    ``_TARGET_CTAS``, from the shapes alone. Never from the lengths:
    reading them would sync with the card and break graph capture."""
    splits = max(1, -(-_TARGET_CTAS // (batch * kv_heads)),
                 -(-n_pages // _MAX_PAGES_PER_SPLIT))
    return -(-n_pages // min(splits, n_pages))


def split_key_ranges(lengths, W, n, ps, window, pps):
    """``(lo, hi)``, each ``[B, splits]``: the keys split ``s`` of row
    ``b`` walks, its pages ``[s * pps, (s + 1) * pps)`` cut to what the
    row's queries can see, ``[window start, min(lengths + W, n * ps))``
    (the clamp to the table keeps stale lengths of inactive rows in
    bounds). A split with ``lo >= hi`` reads nothing."""
    splits = -(-n // pps)
    length = lengths.long()[:, None]
    end = (length + W).clamp(max=n * ps)
    start = ((length - window + 1).clamp(min=0) if window
             else torch.zeros_like(length))
    s = torch.arange(splits, device=lengths.device)
    first = s * pps * ps
    last = ((s + 1) * pps).clamp(max=n) * ps
    return torch.maximum(first, start), torch.minimum(last, end)


def paged_split_partials(q, k_pages, v_pages, *, page_tables, lengths,
                         scale, window, pps):
    """Each split's online-softmax carry over the keys it walks (``pps``
    pages a split), in f32: ``m``, ``l`` ``[B, W, Hkv, G, splits]``,
    ``acc`` ``[..., splits, D]`` and ``live`` ``[B, splits]`` (False: the
    split reads nothing). Keys the row cannot see take the finite
    ``-1e30``, keys outside the split's range ``-inf`` (they weigh exactly
    0), as in the kernel; a split in which a query row sees no key so ends
    with m = -1e30 and l > 0."""
    n, ps = page_tables.shape[1], k_pages.shape[1]
    lo, hi = split_key_ranges(lengths, q.shape[1], n, ps, window, pps)
    qg, qpos = _grouped(q, k_pages, lengths)
    tables = page_tables.long()
    parts = [
        _carry_over_pages(qg, k_pages, v_pages, tables, qpos, scale, window,
                          range(sp * pps, min((sp + 1) * pps, n)),
                          lo[:, sp], hi[:, sp])
        for sp in range(lo.shape[1])
    ]
    ms, ls, accs = zip(*parts)
    return (torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2),
            lo < hi)


def paged_combine(m, l, acc, live):
    """The kernel's merge of :func:`paged_split_partials`: over the live
    splits, ``sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s`` with
    ``M = max_s m_s``; a row with no live split reads 0. The weight, not
    ``l > 0``, is what wipes a split in which a row saw no key."""
    live = live[:, None, None, None, :]
    M = torch.where(live, m, -math.inf).amax(dim=-1, keepdim=True)
    some = M > -math.inf
    w = torch.where(live & some,
                    torch.exp(m - torch.where(some, M, 0.0)), 0.0)
    L = (w * l).sum(dim=-1)
    out = (w[..., None] * acc).sum(dim=-2)
    return out / torch.where(L > 0, L, 1.0)[..., None]


def paged_attention_split_reference(
    q, k_pages, v_pages, *, page_tables, lengths,
    scale: Optional[float] = None, window: Optional[int] = None,
    pps: Optional[int] = None,
):
    """The kernel's algorithm in plain PyTorch: the split over the key
    axis (``pps`` pages per split, :func:`pages_per_split`'s choice by
    default) and the merge of the splits' carries. f32 partials, so it
    checks the split and the merge, not the kernel's bf16 rounding."""
    B, W, Hq, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if pps is None:
        pps = pages_per_split(B, k_pages.shape[2], page_tables.shape[1])
    parts = paged_split_partials(
        q, k_pages, v_pages, page_tables=page_tables, lengths=lengths,
        scale=scale, window=window, pps=pps,
    )
    return paged_combine(*parts).to(q.dtype).reshape(B, W, Hq, D)


# --------------------------------------------------------------------------
# the kernel: csrc/paged_attention.cu, built with nvcc, loaded with ctypes
# --------------------------------------------------------------------------

_LIB = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build_kernel():
    """Compile ``csrc/paged_attention.cu`` unless it is built; returns the
    library's path (see :mod:`.kernel_build`)."""
    return kernel_build.build(["paged_attention"])["paged_attention"]


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_kernel()))
        fn = lib.paged_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        ws = lib.paged_attention_workspace_floats
        ws.argtypes = [ctypes.c_int] * 7
        ws.restype = ctypes.c_int64
        lib.paged_attention_max_rows.restype = ctypes.c_int
        lib.paged_attention_supports_head_dim.argtypes = [ctypes.c_int]
        lib.paged_attention_supports_head_dim.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _kernel_call(q, k_pages, v_pages, tables, lengths, scale, window):
    B, W, Hq, D = q.shape
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype:
        raise ValueError(
            f"the paged-attention kernel takes float32 or bfloat16 q and "
            f"pools of q's dtype; got {q.dtype} and {k_pages.dtype}"
        )
    tensors = (q, k_pages, v_pages, tables, lengths)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the paged-attention kernel needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q and the pools must be 16-byte aligned")
    lib = _library()
    if not lib.paged_attention_supports_head_dim(D):
        raise ValueError(f"the paged-attention kernel has no head_dim {D}")
    if (Hq // Hkv) * W > lib.paged_attention_max_rows():
        raise ValueError(
            f"G * W = {(Hq // Hkv) * W} query rows per kv head exceed the "
            f"kernel's {lib.paged_attention_max_rows()}"
        )
    n = tables.shape[1]
    pps = pages_per_split(B, Hkv, n)
    out = torch.empty_like(q)
    # the splits' partial carries, merged by the second launch
    workspace = torch.empty(
        lib.paged_attention_workspace_floats(B, W, Hq, Hkv, D, n, pps),
        dtype=torch.float32, device=q.device,
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            workspace.data_ptr(), B, W, Hq, Hkv, D, ps, n, pps,
            float(scale), 0 if window is None else int(window),
            _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"paged-attention kernel launch failed with cudaError {err}"
        )
    paged_attention.launches += 1
    return out
