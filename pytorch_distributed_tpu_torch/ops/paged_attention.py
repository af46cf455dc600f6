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
  fallback.
* ``"stream"``: the plain PyTorch page loop with an online-softmax
  carry, the documented semantics of the kernel. A CPU tensor gets it.
* ``"gather"``: materialize the pages into a per-row dense slab and run
  the unchanged ``dot_product_attention``.

``impl="gather"|"stream"`` select a plain version explicitly; on the
card they serve the tests and ``chip_smoke.py``'s comparison only.

int8 KV pools are not taken: the JAX kernel refuses them too, and
routing them to a plain version on the card would be a fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_NEG_INF = -1e30  # finite, like the Pallas kernel: no (-inf) - (-inf) NaN

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "paged_attention.cu"
#: where the kernel library is built (listed in .gitignore)
BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


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
    q: torch.Tensor,        # [B, W, Hq, D]
    k_pages: torch.Tensor,  # [P1, ps, Hkv, D]
    v_pages: torch.Tensor,  # [P1, ps, Hkv, D]
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
    anything else.
    """
    _validate(q, k_pages, v_pages, page_tables, lengths, window)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "gather":
        return _paged_gather(
            q, k_pages, v_pages, page_tables, lengths, scale, window
        )
    if impl == "stream":
        return paged_attention_reference(
            q, k_pages, v_pages, page_tables=page_tables, lengths=lengths,
            scale=scale, window=window,
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


#: kernel launches since the count was last set to 0 (plain versions and
#: CPU calls never count)
paged_attention.launches = 0


# --------------------------------------------------------------------------
# "gather": bucket-wide dense slab + the unchanged dense attention math
# --------------------------------------------------------------------------


def gather_dense(pages, tables):
    """[P1, ps, H, D] + [B, n] tables -> [B, n*ps, H, D] dense slab."""
    B, n = tables.shape
    ps = pages.shape[1]
    out = pages.index_select(0, tables.reshape(-1).long())
    return out.reshape((B, n * ps) + tuple(pages.shape[2:]))


def _paged_gather(q, k_pages, v_pages, tables, lengths, scale, window):
    from pytorch_distributed_tpu_torch.ops.attention import (
        dot_product_attention,
    )

    return dot_product_attention(
        q, gather_dense(k_pages, tables), gather_dense(v_pages, tables),
        causal=True, q_offset=lengths, scale=scale, window=window,
    )


# --------------------------------------------------------------------------
# "stream": the plain page loop with an online-softmax carry
# --------------------------------------------------------------------------


def paged_attention_reference(
    q, k_pages, v_pages, *, page_tables, lengths,
    scale: Optional[float] = None, window: Optional[int] = None,
):
    """One page of K/V per step, online-softmax carry (m, l, acc) in f32.

    The semantics the kernel implements, step for step as the JAX
    ``"stream"`` reference: logits in f32, masked logits ``-1e30``,
    probabilities rounded to the pool's dtype before the P.V product.
    """
    B, W, Hq, D = q.shape
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    G = Hq // Hkv
    n = page_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q.device
    qg = q.reshape(B, W, Hkv, G, D).float()
    qpos = lengths.long()[:, None] + torch.arange(W, device=dev)  # [B, W]
    tables = page_tables.long()
    m = torch.full((B, W, Hkv, G), _NEG_INF, device=dev)
    l = torch.zeros((B, W, Hkv, G), device=dev)
    acc = torch.zeros((B, W, Hkv, G, D), device=dev)
    for i in range(n):
        frames = tables[:, i]
        k = k_pages.index_select(0, frames).float()   # [B, ps, Hkv, D]
        v = v_pages.index_select(0, frames)
        s = torch.einsum("bwkgd,bpkd->bwkgp", qg, k) * scale
        kpos = i * ps + torch.arange(ps, device=dev)
        keep = qpos[:, :, None] >= kpos                # [B, W, ps]
        if window is not None:
            keep = keep & (qpos[:, :, None] - kpos < window)
        s = torch.where(keep[:, :, None, None, :], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bwkgp,bpkd->bwkgd", p.to(v.dtype).float(), v.float()
        )
        m = m_new
    safe = torch.where(l > 0, l, torch.ones_like(l))
    out = (acc / safe[..., None]).to(q.dtype)
    return out.reshape(B, W, Hq, D)


# --------------------------------------------------------------------------
# the kernel: csrc/paged_attention.cu, built with nvcc, loaded with ctypes
# --------------------------------------------------------------------------

_LIB = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the paged-attention kernel is built from source at first use"
        )
    return path


def kernel_library_path() -> Path:
    """Where the built library lives; its name carries a hash of the
    source and the flags, so an edited source is rebuilt."""
    digest = hashlib.sha256(
        _SOURCE.read_bytes() + " ".join(_NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libpaged_attention-{digest}.so"


def build_kernel() -> Path:
    """Compile ``csrc/paged_attention.cu`` into :data:`BUILD_DIR` unless
    an up-to-date library is there; returns its path. The compiler's
    register and shared-memory report goes to ``paged_attention.log``
    beside it."""
    lib = kernel_library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "paged_attention.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr
    )
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) building {_SOURCE}:\n"
            f"{res.stderr[-4000:]}"
        )
    os.replace(tmp, lib)
    return lib


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_kernel()))
        fn = lib.paged_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
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
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, W, Hq, Hkv, D, ps, tables.shape[1], float(scale),
            0 if window is None else int(window), _DTYPE_CODES[q.dtype],
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"paged-attention kernel launch failed with cudaError {err}"
        )
    paged_attention.launches += 1
    return out
