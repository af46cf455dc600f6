"""Sequence parallelism, ring and Ulysses: the port of
``pytorch_distributed_tpu/parallel/sequence.py``.

Long-context training splits the sequence over the ``sp`` mesh axis:
each rank holds ``S / sp`` consecutive positions of the same rows.
Everything in a transformer is pointwise over the sequence except
attention, so only attention needs the other ranks' keys. The two
standard forms, as in the JAX package (which runs them in ``shard_map``
over ``sp``; here each rank calls them on its own shards):

* **Ring attention** (Liu et al. 2023): Q stays local and K/V travel
  around the ``sp`` ring (``runtime.distributed.permute_grad``), each
  step's partial attention combined with the online-softmax rule in f32
  over the true global positions of both sides (``q_pos = my * S +
  arange(S)``), so the causal mask and Mistral's window are exact across
  shard boundaries. ``n - 1`` rotations and a last compute; a row that
  saw no key (``l == 0``) is zero, not NaN. The block products are
  ``torch.matmul`` in f32 (the JAX computes them in plain ``jnp``); the
  gradient is autograd's through the differentiable rotation, which
  sends each K/V gradient back along the ring. A ``bias_fn(q_pos,
  k_pos)`` (T5's relative bias) is evaluated per block from the same
  global positions, so no rank holds the whole ``[S, T]`` bias; it
  gives this rank's heads (under tensor parallelism, those of the
  model's head-sharded table).
* **Ulysses** (DeepSpeed-Ulysses): an all-to-all
  (``runtime.distributed.all_to_all_grad``) turns ``[B, S/sp, H, D]``
  into ``[B, S, H/sp, D]``, full-sequence attention runs on the head
  subset, and the inverse all-to-all turns it back. Its inner attention
  is the flash kernel (``ops/flash_attention.py``) on the card whenever
  the JAX's would be (no window, no custom scale), else the einsum
  path. Under tensor parallelism the heads are the rank's ``H / tp``,
  and ``sp`` must divide them.

``enable_sequence_parallel`` / ``sequence_parallel`` (a context) switch
every model's ``ops.attention.attention`` call to
:func:`sequence_parallel_attention`; the causal-LM losses then take this
rank's positions of each row (``train/losses.py``). Ulysses refuses
``bias_fn`` and points at ring, as the JAX does.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime.mesh import current_mesh

_NEG_INF = -1e30


def axis_group(axis: str = "sp", mesh=None):
    """``(process group, ways, this rank's index)`` of ``axis`` of
    ``mesh`` (a ``DeviceMesh``; the current mesh unless given). An axis
    the mesh does not cut, or a world of one without a mesh, is one way
    (no group)."""
    if mesh is None:
        cur = current_mesh()
        if cur is None:
            if dist.get_world_size() > 1:
                raise RuntimeError(
                    f"sequence parallelism over {axis!r} needs a mesh: "
                    "build one with runtime.mesh.make_mesh (or pass mesh=)")
            return None, 1, 0
        mesh = cur[0]
    if axis not in (mesh.mesh_dim_names or ()):
        return None, 1, 0
    sub = mesh[axis]
    return sub.get_group(), sub.size(), sub.get_local_rank()


def _block_attn_parts(q, k, v, q_pos, k_pos, causal: bool, scale: float,
                      window=None, bias=None):
    """Unnormalized block attention: ``(o [B,S,Hkv,G,D] f32, m, l
    [B,Hkv,G,S,1])``; ``q_pos``/``k_pos`` are global positions and
    ``bias`` (``[Hq, S, T]`` or None) is added to the logits. Autograd
    keeps one ``[B, Hkv, G, S, T]`` f32 tensor (p) of the block."""
    B, S, Hq, D = q.shape
    _, T, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if bias is not None:
        logits = logits + bias.reshape(Hkv, G, S, T)[None].float()
    if causal or window is not None:
        mask = q_pos[:, None] >= k_pos[None, :]   # [S, T]
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        logits = torch.where(mask, logits, _NEG_INF)
    # the running max is a constant of the softmax (its gradient cancels
    # exactly), as in flash attention: detached, autograd keeps only p
    m = logits.detach().amax(dim=-1, keepdim=True)
    # a fully masked row has m == -1e30: subtract 0 there instead, so that
    # its masked logits give exp(-1e30) == 0 (not exp(0) == 1)
    p = torch.exp(logits - torch.where(m > 0.5 * _NEG_INF, m, 0.0))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o, m, l


def _bskg(f):
    """``[B, Hkv, G, S, 1]`` factors as ``[B, S, Hkv, G, 1]``."""
    return f[..., 0].permute(0, 3, 1, 2)[..., None]


def ring_attention(q, k, v, *, causal: bool = False, axis: str = "sp",
                   mesh=None, scale: Optional[float] = None,
                   window: Optional[int] = None, bias_fn=None):
    """Exact attention over the whole sequence from this rank's shards:
    q ``[B, S, Hq, D]`` and k/v ``[B, T, Hkv, D]`` hold positions
    ``[r * S, (r + 1) * S)`` of rank ``r`` of ``axis``; returns this
    rank's ``[B, S, Hq, D]`` rows of the output in q's dtype.
    ``bias_fn(q_pos, k_pos)`` gives each block's additive bias
    ``[Hq, S, T]`` of this rank's heads from its global positions."""
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    group, n, my = axis_group(axis, mesh)
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    q_pos = my * S + torch.arange(S, device=dev)
    perm = [(i, (i + 1) % n) for i in range(n)]
    o = torch.zeros((B, S, Hkv, G, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Hkv, G, S, 1), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Hkv, G, S, 1), dtype=torch.float32, device=dev)
    k_t, v_t = k, v
    for t in range(n):
        src = (my - t) % n   # whose K/V shard this rank holds at step t
        k_pos = src * T + torch.arange(T, device=dev)
        bias = None if bias_fn is None else bias_fn(q_pos, k_pos)
        o_t, m_t, l_t = _block_attn_parts(q, k_t, v_t, q_pos, k_pos, causal,
                                          scale, window, bias)
        m_new = torch.maximum(m, m_t)
        alpha, beta = torch.exp(m - m_new), torch.exp(m_t - m_new)
        l = l * alpha + l_t * beta
        o = o * _bskg(alpha) + o_t * _bskg(beta)
        m = m_new
        if t < n - 1:   # n - 1 rotations: none whose result nobody reads
            k_t = dist.permute_grad(k_t, perm, group=group)
            v_t = dist.permute_grad(v_t, perm, group=group)
    l = _bskg(l)
    out = o / torch.where(l > 0, l, 1.0)
    return out.reshape(B, S, Hq, D).to(q.dtype)


def _seq_to_heads(x, group, n: int):
    """``[B, S, H, D]`` (this rank's positions, every head) to ``[B, n *
    S, H / n, D]`` (every position, this rank's heads)."""
    if n == 1:
        return x
    B, S, H, D = x.shape
    y = x.reshape(B, S, n, H // n, D).permute(2, 0, 1, 3, 4).contiguous()
    y = dist.all_to_all_grad(y, group=group)
    return y.permute(1, 0, 2, 3, 4).reshape(B, n * S, H // n, D)


def _heads_to_seq(x, group, n: int):
    """The inverse of :func:`_seq_to_heads`."""
    if n == 1:
        return x
    B, Sn, h, D = x.shape
    S = Sn // n
    y = x.reshape(B, n, S, h, D).permute(1, 0, 2, 3, 4).contiguous()
    y = dist.all_to_all_grad(y, group=group)
    return y.permute(1, 2, 0, 3, 4).reshape(B, S, n * h, D)


def ulysses_attention(q, k, v, *, causal: bool = False, axis: str = "sp",
                      mesh=None, window: Optional[int] = None,
                      scale: Optional[float] = None, bias_fn=None,
                      impl: Optional[str] = None):
    """DeepSpeed-Ulysses: two all-to-alls around full-sequence attention
    on a head subset. This rank's q/k/v heads (``H / tp`` under tensor
    parallelism) must divide by the ``axis`` size. ``impl`` as
    ``ops.attention.attention``'s: ``None`` takes the flash kernels on
    the card when the JAX would (no window, no custom scale)."""
    if bias_fn is not None:
        raise NotImplementedError(
            "bias_fn under ulysses would materialize the full "
            "global-head [S, S] bias on every chip before head-slicing "
            "— use sequence_parallel(impl='ring'), which evaluates the "
            "bias per block from global positions")
    group, sp, _ = axis_group(axis, mesh)
    Hq, Hkv = q.shape[2], k.shape[2]
    if sp > 1 and (Hq == 0 or Hkv == 0 or Hq % sp or Hkv % sp):
        raise ValueError(
            f"ulysses needs per-tp-shard heads divisible by sp={sp}; got "
            f"q={Hq}, kv={Hkv} on this rank (use ring_attention for "
            "head-indivisible configs)")
    from pytorch_distributed_tpu_torch.ops.attention import (
        dot_product_attention,
    )
    from pytorch_distributed_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    qh, kh, vh = (_seq_to_heads(t, group, sp) for t in (q, k, v))
    flash = window is None and scale is None and (
        impl == "flash" or (impl is None and q.is_cuda))
    if flash:
        out = flash_attention(qh, kh, vh, causal=causal)
    else:
        out = dot_product_attention(qh, kh, vh, causal=causal, window=window,
                                    scale=scale)
    return _heads_to_seq(out, group, sp)


# --------------------------------------------------------------------------
# model-transparent activation: ops.attention.attention() consults this
# --------------------------------------------------------------------------

_SEQ_MODE: Tuple[Optional[str], str] = (None, "ring")   # (axis or None, impl)


def enable_sequence_parallel(axis: str = "sp", impl: str = "ring") -> None:
    """Route every model attention through sequence-parallel attention
    over ``axis`` of the current mesh."""
    global _SEQ_MODE
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown sequence-parallel impl {impl!r}")
    _SEQ_MODE = (axis, impl)


def disable_sequence_parallel() -> None:
    global _SEQ_MODE
    _SEQ_MODE = (None, "ring")


@contextlib.contextmanager
def sequence_parallel(axis: str = "sp", impl: str = "ring"):
    """Context manager form of enable/disable_sequence_parallel."""
    prev = _SEQ_MODE
    enable_sequence_parallel(axis, impl)
    try:
        yield
    finally:
        if prev[0] is None:
            disable_sequence_parallel()
        else:
            enable_sequence_parallel(*prev)


def sequence_parallel_mode() -> Tuple[Optional[str], str]:
    return _SEQ_MODE


def sequence_parallel_attention(q, k, v, *, causal: bool, window=None,
                                scale=None, bias_fn=None,
                                impl: Optional[str] = None):
    """The attention of the active mode on this rank's shards."""
    axis, mode = _SEQ_MODE
    if axis is None:
        raise RuntimeError("sequence parallelism is not enabled")
    if mode == "ring":
        return ring_attention(q, k, v, causal=causal, axis=axis,
                              window=window, scale=scale, bias_fn=bias_fn)
    return ulysses_attention(q, k, v, causal=causal, axis=axis,
                             window=window, scale=scale, bias_fn=bias_fn,
                             impl=impl)


def sequence_shard(ids: torch.Tensor) -> Optional[tuple]:
    """Under sequence parallelism, ``(ids, labels, positions, group)`` of
    this rank's positions of the whole rows ``ids`` ``[B, S]``: its ``S /
    sp`` tokens, their next-token labels shifted on the whole row before
    the split (a shard's last label is the next shard's first token; the
    last shard has one label fewer), their global positions, and the
    ``sp`` process group; None when the mode is off or ``sp`` is 1 (the
    rows are then whole on every rank)."""
    axis, _ = _SEQ_MODE
    if axis is None:
        return None
    group, n, r = axis_group(axis)
    if n == 1:
        return None
    B, S = ids.shape
    if S % n:
        raise ValueError(f"sequence length {S} does not divide over "
                         f"{axis}={n} ranks")
    L = S // n
    positions = torch.arange(r * L, (r + 1) * L, device=ids.device)
    return (ids[:, r * L:(r + 1) * L], ids[:, r * L + 1:(r + 1) * L + 1],
            positions.expand(B, L), group)
