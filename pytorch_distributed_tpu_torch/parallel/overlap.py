"""Gradient compression on the wire: the port of the ship plan and the
error feedback of ``pytorch_distributed_tpu/parallel/overlap.py``, and
of the JAX ring's compressed all-reduce (``native/hostring.cpp``:
``hr_allreduce`` on halves, ``hr_allreduce_q8``).

* :class:`ShipPlan` groups a list of gradient leaves as the JAX plan
  does: float leaves under :data:`COALESCE_MAX_ELEMS` elements coalesce
  into one flat buffer per wire dtype (a group needs two members),
  every other leaf ships alone, and under int8 compression a solo f32
  leaf of at least that many elements goes block-quantized (q8), every
  other item exact.
* :func:`q8_local_roundtrip` is ``dequant(quant(x))`` of the ring's
  block quantizer: 256-element blocks from the leaf's element 0, scale
  ``amax / 127``, ``x * (1 / scale)`` in f32, clamped to +-127, rounded
  half away from zero; a block holding a NaN or an inf comes back NaN,
  a block of zeros stays 0.
* :class:`ErrorFeedback` keeps the q8 residuals, one per key: a sync
  ships ``g + e`` and keeps ``e' = (g + e) - Q(g + e)``, non-finite
  residuals zeroed (``GradSyncEngine._reduce_item``).
* :func:`ring_all_reduce` averages one flat item over the process group
  the way the JAX ring does, in two stages. Each chunk of
  :func:`chunk_elems` elements is cut into one segment per rank (the
  last rank takes the tail; q8 segments are 256-aligned); the ranks
  send each owner its segment (``all_to_all_single``: q8 as int8 codes
  and f32 scales, halves as halves); the owner folds them in f32 in the
  ring's order (its own exact values first, then ranks ``rank + 1,
  rank + 2, ...``), divides by the world size, and rounds once
  (requantizes, or casts to the half type); every rank, the owner too,
  takes that rounded value from ``all_gather_into_tensor``, so the
  ranks end bitwise equal. NCCL's own half-precision all-reduce would
  round at every hop.

The JAX engine's comm thread, staging buffers and bucket queue are not
ported: DDP's buckets already overlap the sync with the backward
(``parallel/ddp.py`` runs this module from a DDP communication hook).

The owner's q8 fold is a fused multiply-add in the ring
(``acc += q * s``, contracted by the compiler): here each step is
``q * s + acc`` in f64, rounded once to f32, which is that FMA except
where the f64 sum itself had to round (double rounding). Where the
folds differ by an ulp the requantized code can move by one step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.runtime import distributed as dist

#: float leaves below this element count coalesce into one flat wire
#: buffer per dtype; also the q8 path's exact-f32 threshold
COALESCE_MAX_ELEMS = 4096
#: elements per q8 scale (``kQBlock`` in native/hostring.cpp)
Q8_BLOCK = 256
#: the JAX ring's default slot (``runtime/hostring.py``): it sets each
#: wire form's chunk, and the chunk decides which rank owns an element
SLOT_BYTES = 4 << 20

_COALESCE_DTYPES = {torch.float32: "float32", torch.float64: "float64",
                    torch.float16: "float16", torch.bfloat16: "bfloat16"}


@dataclasses.dataclass
class ShipItem:
    """One unit on the wire: ``kind`` "flat" (coalesced small leaves,
    ``offsets`` their starts) or "solo" (one whole leaf)."""

    kind: str
    leaf_ids: Tuple[int, ...]
    q8: bool
    offsets: Tuple[int, ...] = ()


class ShipPlan:
    """The JAX ``ShipPlan``'s grouping over leaf ``specs`` ((shape,
    dtype) pairs, dtypes as they go on the wire): flats first, in dtype
    name order, then the solo leaves in leaf order."""

    def __init__(self, specs: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
                 *, quantize: bool = False):
        self.specs = [(tuple(s), d) for s, d in specs]
        self.sizes = [int(torch.Size(s).numel()) for s, _ in self.specs]
        by_dtype: Dict[str, List[int]] = {}
        for i, (_, dt) in enumerate(self.specs):
            if self.sizes[i] < COALESCE_MAX_ELEMS and dt in _COALESCE_DTYPES:
                by_dtype.setdefault(_COALESCE_DTYPES[dt], []).append(i)
        groups = [ids for _, ids in sorted(by_dtype.items())
                  if len(ids) >= 2]
        coalesced = {i for g in groups for i in g}
        items: List[ShipItem] = []
        for g in groups:
            offsets, total = [], 0
            for i in g:
                offsets.append(total)
                total += self.sizes[i]
            items.append(ShipItem("flat", tuple(g), False, tuple(offsets)))
        for i, (_, dt) in enumerate(self.specs):
            if i in coalesced:
                continue
            q8 = (quantize and dt == torch.float32
                  and self.sizes[i] >= COALESCE_MAX_ELEMS)
            items.append(ShipItem("solo", (i,), q8))
        self.items = items


# --------------------------------------------------------------------------
# The block quantizer, in torch: the same bits on the CPU and the card.
# Every division is tensor by tensor: a CUDA division by a host scalar
# multiplies by its reciprocal instead, which rounds otherwise.
# --------------------------------------------------------------------------
def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _q8_codes(x: torch.Tensor):
    """``(codes f32 [nb, 256], scales f32 [nb], bad [nb])`` of a flat f32
    ``x`` zero-padded to whole blocks; ``bad`` marks blocks holding a NaN
    or an inf (``amax <= 3.4e38`` fails for them)."""
    n = x.numel()
    xp = F.pad(x.reshape(-1), (0, (-n) % Q8_BLOCK)).view(-1, Q8_BLOCK)
    amax = xp.abs().amax(dim=1)
    bad = ~(amax <= _full(amax, 3.4e38))
    s = amax / _full(amax, 127.0)
    inv = _full(s, 1.0) / torch.where(s > 0, s, _full(s, 1.0))
    v = (xp * inv[:, None]).clamp(-127.0, 127.0)
    return torch.trunc(v + torch.copysign(_full(v, 0.5), v)), s, bad


def q8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(codes int8 [n], scales f32 [ceil(n / 256)])`` of a flat f32
    ``x``, blocks from its element 0 (``quantize_block``: a block with a
    NaN or an inf gets scale NaN and codes 1)."""
    codes, s, bad = _q8_codes(x)
    q = torch.where(bad[:, None], torch.ones_like(codes), codes)
    s = torch.where(bad, _full(s, float("nan")), s)
    return q.to(torch.int8).reshape(-1)[:x.numel()], s


def q8_dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``float(q) * scale`` of its block (``dequant_copy``), f32."""
    n = q.numel()
    qp = F.pad(q.to(torch.float32), (0, (-n) % Q8_BLOCK)).view(-1, Q8_BLOCK)
    return (qp * s[:, None]).reshape(-1)[:n]


def _q8_fold(acc: torch.Tensor, q: torch.Tensor,
             s: torch.Tensor) -> torch.Tensor:
    """``acc + q * scale`` rounded once to f32 (the ring's FMA; see the
    module docstring)."""
    n = q.numel()
    qp = F.pad(q.to(torch.float64), (0, (-n) % Q8_BLOCK)).view(-1, Q8_BLOCK)
    prod = (qp * s.to(torch.float64)[:, None]).reshape(-1)[:n]
    return (acc.to(torch.float64) + prod).to(torch.float32)


def q8_local_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """``dequant(quant(x))`` of a flat f32 tensor, per 256-element block,
    as the JAX package's numpy replication computes it (codes kept as
    floats, so a code of -0 dequantizes to -0): a block of zeros comes
    back +0, a block with a NaN or an inf NaN."""
    x = x.reshape(-1).to(torch.float32)
    codes, s, bad = _q8_codes(x)
    out = codes * s[:, None]
    out = torch.where((s == 0)[:, None], torch.zeros_like(out), out)
    out = torch.where(bad[:, None], torch.full_like(out, float("nan")), out)
    return out.reshape(-1)[:x.numel()]


class ErrorFeedback:
    """q8 residuals by key (a leaf's index for ``sync_grads``, the
    parameter for the DDP hook), f32, created at zero."""

    def __init__(self):
        self.residuals: Dict[Hashable, torch.Tensor] = {}

    def apply(self, key: Hashable, g: torch.Tensor) -> torch.Tensor:
        """``g + e``, keeping ``e' = (g + e) - Q(g + e)`` (its non-finite
        elements zeroed) for the next call."""
        e = self.residuals.get(key)
        if e is None or e.shape != g.shape:
            e = torch.zeros_like(g)
        ship = g + e
        res = ship - q8_local_roundtrip(ship)
        self.residuals[key] = torch.where(torch.isfinite(res), res,
                                          torch.zeros_like(res))
        return ship

    def reset(self) -> None:
        self.residuals.clear()


@dataclasses.dataclass
class SyncStats:
    """What the sync put on the wire: ``wire_bytes`` this rank sent to
    the others (each ``all_to_all`` block to a peer, and its gathered
    segment once per peer)."""

    wire_bytes: int = 0


def chunk_elems(dtype: torch.dtype, q8: bool) -> int:
    """The ring's chunk for a wire form: one slot of the dtype's
    elements, and for q8 the slot's half (its f32 reduce scratch),
    ``hostring.cpp:586-590``."""
    if q8:
        n = SLOT_BYTES * Q8_BLOCK // (Q8_BLOCK + 4)
        return min(n - 8 if n > 8 else n, SLOT_BYTES // 2)
    return SLOT_BYTES // torch.empty((), dtype=dtype).element_size()


def _segments(n: int, world: int, q8: bool) -> List[Tuple[int, int]]:
    """(start, length) of each rank's segment of an ``n``-element chunk."""
    seg = n // world
    if q8:
        seg &= ~(Q8_BLOCK - 1)
    return [(r * seg, (n - r * seg) if r == world - 1 else seg)
            for r in range(world)]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8).reshape(-1)


def _pad_to(t: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(t, (0, n - t.numel())) if t.numel() < n else t


def _q8_packet(q: torch.Tensor, s: torch.Tensor, elems: int) -> torch.Tensor:
    """A segment's codes and scales as bytes: ``[scales f32][codes]``,
    the codes padded to ``elems`` and to a multiple of 4 bytes, so every
    packet of one length keeps its scales 4-byte aligned."""
    nb = -(-elems // Q8_BLOCK)
    return torch.cat([_bytes(_pad_to(s, nb)),
                      _bytes(_pad_to(q, _ceil4(elems)))])


def _ceil4(n: int) -> int:
    return -(-n // 4) * 4


def _q8_unpacket(pkt: torch.Tensor, elems: int):
    nb = -(-elems // Q8_BLOCK)
    s = pkt[:4 * nb].clone().view(torch.float32)
    q = pkt[4 * nb:4 * nb + elems].clone().view(torch.int8)
    return q, s


def _reduce_chunk(x: torch.Tensor, q8: bool,
                  stats: Optional[SyncStats]) -> torch.Tensor:
    """One chunk of :func:`ring_all_reduce` (world > 1)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = x.numel()
    segs = _segments(n, world, q8)
    s0, sn = segs[rank]
    if q8:
        codes, scales = q8_quantize(x)
        sends = [_q8_packet(codes[a:a + m], scales[a // Q8_BLOCK:
                            -(-(a + m) // Q8_BLOCK)], m)
                 if j != rank else x.new_empty(0, dtype=torch.uint8)
                 for j, (a, m) in enumerate(segs)]
        width = 4 * -(-sn // Q8_BLOCK) + _ceil4(sn)
    else:
        sends = [_bytes(x[a:a + m]) if j != rank
                 else x.new_empty(0, dtype=torch.uint8)
                 for j, (a, m) in enumerate(segs)]
        width = sn * x.element_size()
    in_sizes = [t.numel() for t in sends]
    out_sizes = [0 if j == rank else width for j in range(world)]
    got = dist.all_to_all_single(torch.cat(sends), out_sizes, in_sizes)
    recv = dict(zip([j for j in range(world) if j != rank],
                    got.split(width) if width else
                    [got[:0]] * (world - 1)))
    own = x[s0:s0 + sn]
    world_t = _full(own.float(), float(world))
    if q8:
        acc = own.clone()
        for r in range(1, world):
            q, s = _q8_unpacket(recv[(rank + r) % world], sn)
            acc = _q8_fold(acc, q, s)
        codes, scales = q8_quantize(acc / world_t)
        row = -(-max(m for _, m in segs) // Q8_BLOCK) * Q8_BLOCK
        packet = _q8_packet(codes, scales, row)
    else:
        acc = own.to(torch.float64 if x.dtype == torch.float64
                     else torch.float32)
        for r in range(1, world):
            acc = acc + recv[(rank + r) % world].view(x.dtype).to(acc.dtype)
        acc = acc / world_t.to(acc.dtype)
        row = max(m for _, m in segs)
        packet = _bytes(_pad_to(acc.to(x.dtype), row))
    gathered = dist.all_gather_into_tensor(packet).view(world, -1)
    if stats is not None:
        stats.wire_bytes += sum(in_sizes) + packet.numel() * (world - 1)
    parts = []
    for j, (a, m) in enumerate(segs):
        if q8:
            parts.append(q8_dequantize(*_q8_unpacket(gathered[j], row))[:m])
        else:
            parts.append(gathered[j].clone().view(x.dtype)[:m])
    return torch.cat(parts)


def ring_all_reduce(x: torch.Tensor, *, q8: bool = False,
                    stats: Optional[SyncStats] = None) -> torch.Tensor:
    """The average over the process group of this rank's flat ``x`` (f32
    or f64 exact, bf16 or fp16 summed in f32 and rounded once, or f32
    through q8 with ``q8=True``), bitwise the same on every rank; ``x``
    itself in a world of one. See the module docstring."""
    if q8 and x.dtype != torch.float32:
        raise TypeError(f"q8 ships f32 items, got {x.dtype}")
    if x.dtype not in _COALESCE_DTYPES:
        raise TypeError(f"ring_all_reduce averages floats, got {x.dtype}")
    x = x.reshape(-1)
    if dist.get_world_size() == 1:
        return x
    step = chunk_elems(x.dtype, q8)
    return torch.cat([_reduce_chunk(x[off:off + step], q8, stats)
                      for off in range(0, x.numel(), step)])
