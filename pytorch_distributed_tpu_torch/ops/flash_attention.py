"""Flash attention, forward and backward: the port of
``pytorch_distributed_tpu/ops/flash_attention.py``.

Blocked online-softmax attention that never materializes the ``[S, T]``
score matrix, with the JAX signature and layout: q ``[B, S, Hq, D]``, k
and v ``[B, T, Hkv, D]``, output ``[B, S, Hq, D]`` in q's dtype. It
covers full, causal (top-left aligned), key-padding-masked (``kv_mask``,
a ``[B, T]`` bool) and packed (``segment_ids``) attention, grouped-query
heads in any integer ratio, and a custom ``sm_scale``.

Two implementations of each of the three steps sit side by side:

* the kernels (``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``,
  built with ``nvcc`` at first use and loaded with ``ctypes``):
  :func:`flash_fwd`, :func:`flash_dq` and :func:`flash_dkv`, the ports of
  the Pallas ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel``. CUDA
  tensors get them; each counts its launches in ``<fn>.launches`` and
  raises on anything it does not take. There is no fallback. The dtype
  picks the kernel inside the library: bf16 and fp16 run all three on
  the tensor cores, f32 all three on the CUDA cores.
* the plain versions :func:`_flash_fwd_plain`, :func:`_flash_dq_plain`
  and :func:`_flash_dkv_plain`: the same blocked algorithm in PyTorch,
  recomputing from the saved logsumexp exactly as the kernels do. CPU
  tensors get them, and ``impl="plain"`` names them on any device (the
  tests and ``chip_smoke.py`` hold the kernels against them).

One ``torch.autograd.Function`` runs the forward, then dq and dkv in
backward. ``delta = rowsum(dO * O)`` stays a PyTorch op in the backward,
as it is outside the kernels in the JAX package. dK and dV come out of
the dkv kernel in the kv-head shape already (one CTA per kv head loops
over its query-head group), where the JAX package sums per-query-head
outputs over the group.

Rows whose keys are all masked get finite but undefined outputs, as in
the JAX package.

:func:`count_flops` arms a :class:`FlopLedger` to which every kernel
launch of the autograd Function adds its FLOPs (``torch.utils.
flop_counter`` cannot see a ctypes launch): the trainer's ``log_mfu``
adds it to the ATen count.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from pytorch_distributed_tpu_torch.ops import kernel_build

_NEG_INF = -1e30  # finite, like the Pallas kernels: no (-inf) - (-inf) NaN


def flash_attention(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,  # [B, T, Hkv, D]
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,       # [B, T] bool, True = attend
    segment_ids: Optional[torch.Tensor] = None,   # [B, S] int, packing
    sm_scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Blocked flash attention; a drop-in for
    :func:`~pytorch_distributed_tpu_torch.ops.attention.dot_product_attention`
    for full, causal, ``kv_mask``-padded and packed (``segment_ids``,
    self-attention only) attention. Differentiable in q, k and v.

    ``impl=None`` launches the kernels for CUDA tensors and runs the
    plain versions for CPU tensors; ``impl="plain"`` runs the plain
    versions on any device. ``block_q``/``block_k`` are the plain
    versions' block sizes; the kernels work in tiles of 64 and mask a
    ragged last tile, so any S and T are taken.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"q must be [B, S, Hq, D] and k, v [B, T, Hkv, D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, S, Hq, D = q.shape
    _, T, Hkv, _ = k.shape
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(
            f"k and v must be [{B}, T, Hkv, {D}] alike; got "
            f"{tuple(k.shape)} and {tuple(v.shape)}"
        )
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be positive: {block_q}, {block_k}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    bias = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (B, T):
            raise ValueError(
                f"kv_mask must be [batch, kv_len] = {(B, T)}, got "
                f"{tuple(kv_mask.shape)}"
            )
        bias = torch.zeros((B, T), dtype=torch.float32, device=q.device)
        bias = bias.masked_fill(~kv_mask.to(q.device, torch.bool), _NEG_INF)
    if segment_ids is not None:
        if S != T:
            raise ValueError("segment_ids requires self-attention (S == T)")
        if tuple(segment_ids.shape) != (B, S):
            raise ValueError(
                f"segment_ids must be [batch, seq] = {(B, S)}, got "
                f"{tuple(segment_ids.shape)}"
            )
        segment_ids = segment_ids.to(q.device, torch.int32).contiguous()
    return _FlashAttention.apply(
        q, k, v, bias, segment_ids, float(sm_scale), bool(causal),
        int(block_q), int(block_k), _use_kernel(q, impl),
    )


def _use_kernel(q: torch.Tensor, impl: Optional[str]) -> bool:
    if impl == "plain":
        return False
    if impl is not None:
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if q.is_cuda:
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"flash_attention has no path for {q.device}")


def _delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32, [B, Hq, S]: the softmax-gradient correction
    the backward steps take as an input."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class FlopLedger:
    """FLOPs the flash kernels ran while :func:`count_flops` was armed:
    ``torch.utils.flop_counter`` sees ATen ops only, and a kernel launch
    through ctypes is none. Each launch adds what its shapes and masks
    need: the live (query, key) pairs over every query head times
    ``head_dim``, times 4 for the forward (two products) and 10 for the
    backward (dq's two and dkv's three)."""

    def __init__(self):
        self.flops = 0


_ledger: Optional[FlopLedger] = None


@contextlib.contextmanager
def count_flops():
    """Arm a :class:`FlopLedger` for the block (the kernels' launches add
    to it; the plain versions are ATen ops, which a ``FlopCounterMode``
    counts itself)."""
    global _ledger
    prev, _ledger = _ledger, FlopLedger()
    try:
        yield _ledger
    finally:
        _ledger = prev


def live_pairs(B, S, T, Hq, causal, bias, seg) -> int:
    """(query, key) pairs the masks leave live, over every query head:
    the work this call's data needs (a host read of the masks)."""
    if bias is None and seg is None:
        per = S * T if not causal else sum(min(i + 1, T) for i in range(S))
        return B * Hq * per
    dev = bias.device if bias is not None else seg.device
    keep = torch.ones(B, S, T, dtype=torch.bool, device=dev)
    if causal:
        keep &= (torch.arange(S, device=dev)[:, None]
                 >= torch.arange(T, device=dev)[None, :])
    if bias is not None:
        keep &= (bias == 0)[:, None, :]
    if seg is not None:
        keep &= seg[:, :, None] == seg[:, None, :]
    return int(keep.sum().item()) * Hq


def _ledger_add(q, k, bias, seg, causal, per_pair: int) -> None:
    ledger = _ledger
    if ledger is not None:
        B, S, Hq, D = q.shape
        ledger.flops += per_pair * D * live_pairs(B, S, k.shape[1], Hq,
                                                  causal, bias, seg)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seg, sm_scale, causal, block_q, block_k,
                kernel):
        if kernel:
            out, lse = flash_fwd(q, k, v, bias, seg, sm_scale=sm_scale,
                                 causal=causal)
            _ledger_add(q, k, bias, seg, causal, 4)
        else:
            out, lse = _flash_fwd_plain(q, k, v, bias, seg, sm_scale=sm_scale,
                                        causal=causal, block_k=block_k)
        ctx.save_for_backward(q, k, v, bias, seg, out, lse)
        ctx.args = (sm_scale, causal, block_q, block_k, kernel)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, bias, seg, out, lse = ctx.saved_tensors
        sm_scale, causal, block_q, block_k, kernel = ctx.args
        delta = _delta(dout, out)
        kw = dict(sm_scale=sm_scale, causal=causal)
        args = (q, k, v, dout, lse, delta, bias, seg)
        if kernel:
            dq = flash_dq(*args, **kw)
            dk, dv = flash_dkv(*args, **kw)
            _ledger_add(q, k, bias, seg, causal, 10)
        else:
            dq = _flash_dq_plain(*args, block_k=block_k, **kw)
            dk, dv = _flash_dkv_plain(*args, block_q=block_q, **kw)
        # the bias comes from a boolean mask and the segments are ids:
        # neither has a gradient
        return dq, dk, dv, None, None, None, None, None, None, None


# --------------------------------------------------------------------------
# the plain versions: blocked online softmax in PyTorch
# --------------------------------------------------------------------------


def _grouped(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, S, Hq, D] -> [B, Hkv, G, S, D] in f32 (query head hq = kv head
    hq // G, member hq % G)."""
    B, S, H, D = x.shape
    return x.reshape(B, S, hkv, H // hkv, D).permute(0, 2, 3, 1, 4).float()


def _ungrouped(x: torch.Tensor) -> torch.Tensor:
    """[B, Hkv, G, S, D] -> [B, S, Hq, D]."""
    B, Hkv, G, S, D = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, S, Hkv * G, D)


def _scores(qg, kb, bias, seg, sm_scale, causal, q0, k0):
    """Masked, scaled scores [B, Hkv, G, sq, tk] of queries q0.. (``qg``
    [B, Hkv, G, sq, D]) against keys k0.. (``kb`` [B, Hkv, tk, D]), in the
    kernels' order: scale, bias, segment mask, causal mask."""
    sq, tk = qg.shape[3], kb.shape[2]
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, kb) * sm_scale
    if bias is not None:
        s = s + bias[:, None, None, None, k0:k0 + tk]
    if seg is not None:
        same = seg[:, q0:q0 + sq, None] == seg[:, None, k0:k0 + tk]
        s = s.masked_fill(~same[:, None, None], _NEG_INF)
    if causal:
        qpos = torch.arange(q0, q0 + sq, device=s.device)
        kpos = torch.arange(k0, k0 + tk, device=s.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], _NEG_INF)
    return s


def _key_end(S: int, T: int, causal: bool) -> int:
    """Keys any row can see: all T, or with causal those up to the last
    row's diagonal (top-left aligned)."""
    return min(T, S) if causal else T


def _flash_fwd_plain(q, k, v, bias, seg, *, sm_scale, causal, block_k=128):
    """The forward in PyTorch, ``block_k`` keys at a time: an online
    softmax with an f32 carry (m, l, acc), probabilities rounded to v's
    dtype before P.V. Returns (out [B, S, Hq, D] in q.dtype,
    lse [B, Hq, S] f32)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = _grouped(q, Hkv)
    kf = k.permute(0, 2, 1, 3).float()
    vt = v.permute(0, 2, 1, 3)
    m = torch.full((B, Hkv, G, S), _NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, S), device=q.device)
    acc = torch.zeros((B, Hkv, G, S, D), device=q.device)
    for k0 in range(0, _key_end(S, T, causal), block_k):
        kb = kf[:, :, k0:k0 + block_k]
        s = _scores(qg, kb, bias, seg, sm_scale, causal, 0, k0)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgst,bhtd->bhgsd", p.to(v.dtype).float(),
            vt[:, :, k0:k0 + block_k].float(),
        )
        m = m_new
    safe = torch.where(l > 0, l, torch.ones_like(l))
    out = _ungrouped(acc / safe[..., None]).to(q.dtype)
    lse = (m + torch.log(safe)).reshape(B, Hq, S)
    return out, lse


def _flash_dq_plain(q, k, v, dout, lse, delta, bias, seg, *, sm_scale,
                    causal, block_k=128):
    """dQ in PyTorch, ``block_k`` keys at a time: P = exp(s - lse),
    dP = dO.V^T, dS = P (dP - delta) scale rounded to k's dtype,
    dQ = sum dS.K. Returns [B, S, Hq, D] in q.dtype."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = _grouped(q, Hkv)
    dog = _grouped(dout, Hkv)
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    lse_g = lse.reshape(B, Hkv, G, S, 1)
    delta_g = delta.reshape(B, Hkv, G, S, 1)
    acc = torch.zeros((B, Hkv, G, S, D), device=q.device)
    for k0 in range(0, _key_end(S, T, causal), block_k):
        kb = kf[:, :, k0:k0 + block_k]
        p = torch.exp(
            _scores(qg, kb, bias, seg, sm_scale, causal, 0, k0) - lse_g
        )
        dp = torch.einsum("bhgsd,bhtd->bhgst", dog, vf[:, :, k0:k0 + block_k])
        ds = p * (dp - delta_g) * sm_scale
        acc = acc + torch.einsum(
            "bhgst,bhtd->bhgsd", ds.to(k.dtype).float(), kb
        )
    return _ungrouped(acc).to(q.dtype)


def _flash_dkv_plain(q, k, v, dout, lse, delta, bias, seg, *, sm_scale,
                     causal, block_q=128):
    """dK and dV in PyTorch, ``block_q`` queries at a time, summed over
    each kv head's query-head group in f32: dV = sum P^T.dO (P in f32),
    dK = sum dS^T.Q (dS rounded to q's dtype). Returns (dk, dv), each
    [B, T, Hkv, D] in k's and v's dtype."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = _grouped(q, Hkv)
    dog = _grouped(dout, Hkv)
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    lse_g = lse.reshape(B, Hkv, G, S, 1)
    delta_g = delta.reshape(B, Hkv, G, S, 1)
    dk = torch.zeros((B, Hkv, T, D), device=q.device)
    dv = torch.zeros((B, Hkv, T, D), device=q.device)
    for q0 in range(0, S, block_q):
        rows = slice(q0, q0 + block_q)
        qb, dob = qg[:, :, :, rows], dog[:, :, :, rows]
        p = torch.exp(
            _scores(qb, kf, bias, seg, sm_scale, causal, q0, 0)
            - lse_g[:, :, :, rows]
        )
        dv = dv + torch.einsum("bhgst,bhgsd->bhtd", p, dob)
        dp = torch.einsum("bhgsd,bhtd->bhgst", dob, vf)
        ds = p * (dp - delta_g[:, :, :, rows]) * sm_scale
        dk = dk + torch.einsum(
            "bhgst,bhgsd->bhtd", ds.to(q.dtype).float(), qb
        )
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


# --------------------------------------------------------------------------
# the kernels: csrc/flash_attention.cu, built with nvcc, loaded with ctypes
# --------------------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LIB = None


class _Params(ctypes.Structure):
    """``FlashParams`` of csrc/flash_attention.cu, field for field."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "q", "k", "v", "dout", "out", "lse", "delta", "dq", "dk", "dv",
            "bias", "seg",
        )]
        + [(name, ctypes.c_int64 * 3) for name in (
            "q_stride", "k_stride", "v_stride", "do_stride",
        )]
        + [(name, ctypes.c_int32) for name in (
            "B", "S", "T", "Hq", "Hkv", "D", "causal", "dtype",
        )]
        + [("scale", ctypes.c_float)]
    )


def build_kernel():
    """Compile ``csrc/flash_attention.cu`` unless it is built; returns the
    library's path (see :mod:`.kernel_build`)."""
    return kernel_build.build(["flash_attention"])["flash_attention"]


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_kernel()))
        for fn in (lib.flash_fwd, lib.flash_dq, lib.flash_dkv):
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.flash_params_size.restype = ctypes.c_int
        lib.flash_supports_head_dim.argtypes = [ctypes.c_int]
        lib.flash_supports_head_dim.restype = ctypes.c_int
        if lib.flash_params_size() != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"FlashParams is {lib.flash_params_size()} bytes in the "
                f"library but {ctypes.sizeof(_Params)} in Python"
            )
        _LIB = lib
    return _LIB


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it in place (contiguous head
    dim, 16-byte aligned rows: GPT-2's q/k/v slices of its fused qkv
    projection are), else a contiguous copy (one extra read and write of
    the tensor)."""
    vec = 16 // t.element_size()
    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:3])):
        return t
    return t.contiguous()


def _kernel_params(q, k, v, bias, seg, sm_scale, causal) -> _Params:
    """Check what the kernels take and fill the shared fields."""
    tensors = [t for t in (q, k, v, bias, seg) if t is not None]
    if not all(t.is_cuda for t in tensors) or len(
        {t.device for t in tensors}
    ) != 1:
        raise ValueError("the flash kernels need all inputs on one CUDA card")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or (
        v.dtype != q.dtype
    ):
        raise ValueError(
            f"the flash kernels take float32, bfloat16 or float16 q, k and "
            f"v of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    lib = _library()
    if not lib.flash_supports_head_dim(D):
        raise ValueError(f"the flash kernels have no head_dim {D}")
    if bias is not None and (
        bias.dtype != torch.float32 or tuple(bias.shape) != (B, T)
        or not bias.is_contiguous()
    ):
        raise ValueError("bias must be a contiguous [B, T] float32 tensor")
    if seg is not None and (
        seg.dtype != torch.int32 or tuple(seg.shape) != (B, S)
        or not seg.is_contiguous()
    ):
        raise ValueError("segment ids must be a contiguous [B, S] int32 tensor")
    p = _Params()
    p.q, p.k, p.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    p.bias = None if bias is None else bias.data_ptr()
    p.seg = None if seg is None else seg.data_ptr()
    p.q_stride[:] = q.stride()[:3]
    p.k_stride[:] = k.stride()[:3]
    p.v_stride[:] = v.stride()[:3]
    p.B, p.S, p.T, p.Hq, p.Hkv, p.D = B, S, T, Hq, Hkv, D
    p.causal = int(bool(causal))
    p.dtype = _DTYPE_CODES[q.dtype]
    p.scale = float(sm_scale)
    return p


def _launch(fn, params: _Params, device, what: str) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.byref(params), stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with cudaError {err}")


def flash_fwd(q, k, v, bias=None, seg=None, *, sm_scale, causal):
    """The forward kernel: (out [B, S, Hq, D] in q.dtype, lse [B, Hq, S]
    f32). Counted in ``flash_fwd.launches``."""
    q, k, v = _operand(q), _operand(k), _operand(v)
    p = _kernel_params(q, k, v, bias, seg, sm_scale, causal)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((p.B, p.Hq, p.S), dtype=torch.float32, device=q.device)
    p.out, p.lse = out.data_ptr(), lse.data_ptr()
    _launch(_library().flash_fwd, p, q.device, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def _backward_params(q, k, v, dout, lse, delta, bias, seg, sm_scale, causal):
    q, k, v, dout = (_operand(t) for t in (q, k, v, dout))
    p = _kernel_params(q, k, v, bias, seg, sm_scale, causal)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("dout must match q in shape and dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (p.B, p.Hq, p.S)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                f"{name} must be a contiguous [B, Hq, S] float32 tensor on "
                f"q's device"
            )
    p.dout = dout.data_ptr()
    p.do_stride[:] = dout.stride()[:3]
    p.lse, p.delta = lse.data_ptr(), delta.data_ptr()
    # the caller holds the operands (any copies among them) until launch
    return (q, k, v, dout), p


def flash_dq(q, k, v, dout, lse, delta, bias=None, seg=None, *, sm_scale,
             causal):
    """The dq kernel: dQ [B, S, Hq, D] in q.dtype. Counted in
    ``flash_dq.launches``."""
    held, p = _backward_params(q, k, v, dout, lse, delta, bias, seg,
                               sm_scale, causal)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    p.dq = dq.data_ptr()
    _launch(_library().flash_dq, p, q.device, "flash_dq")
    del held
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, dout, lse, delta, bias=None, seg=None, *, sm_scale,
              causal):
    """The dkv kernel: (dK, dV), each [B, T, Hkv, D] in k's dtype, summed
    over every kv head's query-head group. Counted in
    ``flash_dkv.launches``."""
    held, p = _backward_params(q, k, v, dout, lse, delta, bias, seg,
                               sm_scale, causal)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    p.dk, p.dv = dk.data_ptr(), dv.data_ptr()
    _launch(_library().flash_dkv, p, q.device, "flash_dkv")
    del held
    flash_dkv.launches += 1
    return dk, dv


#: kernel launches since each count was last set to 0 (the plain versions
#: and CPU calls never count)
flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0
