"""Paged, prefix-shared KV-cache pool: the port of
``pytorch_distributed_tpu/serve/kv_slots.py``.

* Device storage is one page pool per layer: each K and V buffer is
  ``[num_pages + 1, page_size, Hkv, D]`` (page 0 is the reserved null
  page, never allocated, padding for unused page-table entries).
* Requests hold a page table (``[max_pages]`` int32 per slot); which
  request owns which page at which offset is host bookkeeping.
* Freed pages return to one min-heap free list (lowest page first, so
  seeded workloads replay exactly).
* Identical prompt prefixes share pages copy-free via refcounts: full
  prompt pages are content-addressed by a chain hash of the token
  prefix, and admission maps matching leading pages into the new
  request's table. Copy-on-write is enforced at admission: a shared page
  is read-only, and the page holding the first token the request will
  write is always private.

The host logic is a direct port and integer-exact against the JAX pool.
The device side differs in one respect: the page pool is updated IN
PLACE (``index_copy_``), where the JAX package rebinds a donated buffer.

The frame codec (:func:`extract_frames`/:func:`splice_frames`) moves
whole page frames as verbatim bytes for KV migration between engines and
for the cross-engine prefix store (``adopt_page`` claims the page a
splice lands in). Its layout is the JAX pool's: buffer-name-major in the
JAX leaf order (``cached_key``, ``cached_key_scale``, ``cached_value``,
``cached_value_scale``), each name's frames ``[layers, pages, ps, H, D]``
in C order, as the JAX package's scan-stacked leaf holds them; so
:func:`frame_signature` and the bytes of a pool with the same contents
equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.ops.attention import CACHE_NAMES
from pytorch_distributed_tpu_torch.ops.paged_attention import (
    gather_dense,
    write_positions,
)
from pytorch_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# warn-once dedup for degenerate auto page sizes
_warned_page_sizes: set = set()


def reset_page_size_warnings() -> None:
    """Clear the warn-once dedup (tests asserting the warning fires)."""
    _warned_page_sizes.clear()


def auto_page_size(max_len: int, cap: int = 32) -> int:
    """Largest power-of-two divisor of ``max_len``, capped at ``cap``.

    An odd ``max_len`` degenerates to 1-token pages (valid, but every
    token becomes its own page); that warns once per ``max_len``.
    """
    ps = math.gcd(max_len, 1 << 30)  # largest power-of-2 divisor
    while ps > cap:
        ps //= 2
    if ps == 1 and max_len > 1 and max_len not in _warned_page_sizes:
        _warned_page_sizes.add(max_len)
        logger.warning(
            "auto_page_size(max_len=%d): odd max_len degenerates to "
            "1-token pages — %d page-table entries per slot. Use an even "
            "max_len or pass page_size explicitly.", max_len, max_len,
        )
    return ps


def init_page_cache(model, num_pages: int, page_size: int):
    """Zeroed page pool: the model's own per-layer cache buffers with
    batch = ``num_pages + 1`` frames and length = ``page_size`` (an int8
    model's with their per-token scale pools, zeroed as the JAX pool is).
    Frame 0 is the reserved null page."""
    cache = model.init_cache(num_pages + 1, page_size)
    for layer in cache:
        for buf in layer:
            buf.zero_()
    return cache


def gather_pages(cache, page_tables):
    """Page pool + ``[B, n]`` tables -> dense ``[B, n * page_size]``
    per-layer buffers (int8 payloads and scales gathered as they rest), a
    valid decode cache for the model."""
    return [tuple(gather_dense(buf, page_tables) for buf in layer)
            for layer in cache]


def scatter_kv(cache, dense, page_tables, positions, keep):
    """Write ``positions`` [B, W] of the dense view back into the page
    pool, IN PLACE; ``keep`` [B, W] False drops the write. Every kept
    position lands in a page the row owns privately (the pool's
    copy-on-write admission guarantees it). Returns ``cache``."""
    idx = positions.long()
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    # stale positions of dropped rows may sit past the dense width: read
    # a clamped entry, the keep mask drops it anyway
    src = idx.clamp(max=dense[0][0].shape[1] - 1)
    for layer, dlayer in zip(cache, dense):
        for buf, dbuf in zip(layer, dlayer):
            write_positions(buf, page_tables, idx, dbuf[rows, src], keep)
    return cache


# --------------------------------------------------------------------------
# the frame codec: whole page frames as verbatim bytes
# --------------------------------------------------------------------------

_NP_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.float16: "float16", torch.int8: "int8"}


def _frame_leaves(cache):
    """(name, per-layer buffers) for every KV buffer, in the JAX pool's
    leaf order: the ONE order the frame codec is defined over."""
    names = CACHE_NAMES[len(cache[0])]
    return [(name, [layer[i] for layer in cache])
            for i, name in sorted(enumerate(names), key=lambda t: t[1])]


def frame_signature(cache, page_size: int) -> str:
    """Geometry commitment for one page frame: buffer names, per-frame
    shapes (layers first) and dtypes in codec order, plus the page size.
    Two pools agree on it iff :func:`extract_frames` bytes from one
    splice losslessly into the other (the migration handshake's DETAIL
    string)."""
    parts = [f"ps={page_size}"]
    for name, bufs in _frame_leaves(cache):
        frame = (len(bufs),) + tuple(bufs[0].shape[1:])
        parts.append(f"{name}:{frame}:{_NP_NAMES[bufs[0].dtype]}")
    return "|".join(parts)


def frame_nbytes(cache) -> int:
    """Bytes of ONE page frame across every layer's buffers: the exact
    per-page payload :func:`extract_frames` produces (an int8 pool's
    int8 K/V plus their f32 per-token scales)."""
    return sum(
        buf[0].numel() * buf.element_size()
        for _, bufs in _frame_leaves(cache) for buf in bufs
    )


def frame_f32_nbytes(cache) -> int:
    """Bytes ONE page frame would cost as an f32 cache: payload elements
    at 4 bytes, no scales. An int8 pool's frames cost ``(1 + 4/D) / 4``
    of this."""
    return sum(
        buf[0].numel() * 4
        for name, bufs in _frame_leaves(cache)
        if not name.endswith("_scale") for buf in bufs
    )


def _as_bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).cpu().numpy().reshape(-1)


def extract_frames(cache, pages) -> np.ndarray:
    """Gather whole page frames into one flat ``uint8`` payload, in the
    codec's layout: per buffer name, ``[layers, len(pages), ps, H, D]``
    in C order and the native dtype. Verbatim bytes, so a splice into a
    pool of the same geometry is lossless for any cache dtype."""
    idx = torch.as_tensor(np.asarray(pages, np.int64).reshape(-1))
    chunks = []
    for _, bufs in _frame_leaves(cache):
        i = idx.to(bufs[0].device)
        chunks.append(_as_bytes(torch.stack(
            [b.index_select(0, i) for b in bufs])))
    return np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)


def splice_frames(cache, pages, payload):
    """Inverse of :func:`extract_frames`: write frame bytes into the pool
    at ``pages``, IN PLACE; returns ``cache``. Once per migrated request
    or adopted page, never per tick. Raises before writing anything when
    the payload's size disagrees with the pool's frame geometry (the
    byte-level half of the fingerprint handshake)."""
    idx = torch.as_tensor(np.asarray(pages, np.int64).reshape(-1))
    n = int(idx.numel())
    buf = np.ascontiguousarray(payload, np.uint8).reshape(-1)
    plan, off = [], 0
    for name, bufs in _frame_leaves(cache):
        shape = (len(bufs), n) + tuple(bufs[0].shape[1:])
        count = math.prod(shape) * bufs[0].element_size()
        if off + count > buf.size:
            raise ValueError(
                f"migration payload too short: {name} needs bytes "
                f"[{off}, {off + count}) of {buf.size}"
            )
        plan.append((bufs, shape, off, count))
        off += count
    if off != buf.size:
        raise ValueError(
            f"migration payload size mismatch: the pool's frames take "
            f"{off} bytes, the payload holds {buf.size}: pool geometries "
            f"disagree"
        )
    for bufs, shape, start, count in plan:
        frames = torch.from_numpy(buf[start:start + count].copy()).view(
            bufs[0].dtype).reshape(shape).to(bufs[0].device)
        i = idx.to(bufs[0].device)
        for layer, b in enumerate(bufs):
            b.index_copy_(0, i, frames[layer])
    return cache


@dataclasses.dataclass(frozen=True)
class SlotLease:
    """One admission's allocation: which slot, which pages, where prefill
    resumes. ``page_row`` is the ``[max_pages]`` table row (unused
    entries = null page 0); ``page_keys`` are the chain-hash keys of the
    prompt's full pages, registered for sharing once prefill wrote
    them."""

    slot: int
    skip: int                 # prefill resumes here (page-aligned, < P)
    page_row: np.ndarray      # [max_pages] int32
    n_pages: int              # pages charged to this slot
    shared_pages: int         # leading pages mapped from the registry
    page_keys: Tuple[bytes, ...]


class PagedKVPool:
    """Page-pool device buffers + host page tables / refcounts / registry.

    ``lengths[i]`` is slot ``i``'s filled prefix, the single source of
    truth the engine turns into positions, write cursors and the per-row
    causal mask.
    """

    def __init__(
        self,
        model,
        num_slots: int,
        max_len: int,
        *,
        page_size: Optional[int] = None,
        num_pages: Optional[int] = None,
        prefix_cache: bool = True,
    ):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        ps = page_size or auto_page_size(max_len)
        if ps < 1 or max_len % ps:
            raise ValueError(
                f"page_size {ps} must be >= 1 and divide max_len {max_len}"
            )
        self.num_slots = num_slots
        self.max_len = max_len
        self.page_size = ps
        self.max_pages = max_len // ps
        self.num_pages = (
            num_pages if num_pages is not None
            else num_slots * self.max_pages
        )
        if self.num_pages < self.max_pages:
            raise ValueError(
                f"num_pages {self.num_pages} cannot hold even one "
                f"max-length request ({self.max_pages} pages)"
            )
        self.prefix_cache = prefix_cache
        self.cache = init_page_cache(model, self.num_pages, ps)
        self.lengths = np.zeros(num_slots, np.int32)
        self.page_tables = np.zeros((num_slots, self.max_pages), np.int32)
        self._free_slots: List[int] = list(range(num_slots))
        heapq.heapify(self._free_slots)
        self._occupied = np.zeros(num_slots, bool)
        self._free_pages: List[int] = list(range(1, self.num_pages + 1))
        heapq.heapify(self._free_pages)
        self._ref = np.zeros(self.num_pages + 1, np.int32)
        self._slot_pages: List[Tuple[int, ...]] = [
            () for _ in range(num_slots)
        ]
        # chain-hash key -> page id, LRU-ordered; an entry holds one
        # refcount, so a registered page survives its writer's retirement
        self._registry: "OrderedDict[bytes, int]" = OrderedDict()
        self._page_key: Dict[int, bytes] = {}
        self.prefix_lookups = 0
        self.prefix_hits = 0          # admissions that shared >= 1 page
        self.shared_tokens = 0        # prompt tokens served from shares
        self.prompt_tokens = 0
        self.peak_pages = 0

    # -- prefix hashing ----------------------------------------------------
    def chain_keys(self, prompt_ids) -> List[bytes]:
        """Chain hash per FULL prompt page: key_i commits to tokens
        [0, (i+1) * page_size). [] with the prefix cache off."""
        if not self.prefix_cache:
            return []
        ids = np.ascontiguousarray(prompt_ids, dtype=np.int32)
        ps = self.page_size
        keys, key = [], b""
        for i in range(len(ids) // ps):
            h = hashlib.blake2b(key, digest_size=16)
            h.update(ids[i * ps:(i + 1) * ps].tobytes())
            key = h.digest()
            keys.append(key)
        return keys

    # -- allocation --------------------------------------------------------
    def shareable_skip(self, prompt_ids, *, max_new: int = 0,
                       chunk: Optional[int] = None, tail: int = 0,
                       max_skip: Optional[int] = None,
                       keys: Optional[List[bytes]] = None) -> int:
        """How many prompt tokens an allocate() now would serve from the
        registry (page-aligned). Read-only."""
        plan = self._plan(
            np.asarray(prompt_ids, np.int32).reshape(-1),
            max_new=max_new, chunk=chunk, tail=tail, max_skip=max_skip,
            keys=keys,
        )
        return plan[1] * self.page_size

    def _plan(self, ids, *, max_new, chunk, tail, max_skip, keys=None):
        """(keys, shared_pages, span) for a prospective admission."""
        P = int(ids.size)
        ps = self.page_size
        if keys is None:
            keys = self.chain_keys(ids)
        # at least one real prompt token must prefill (the final chunk
        # samples the first token from the last prompt column)
        cap = (P - 1) // ps
        if max_skip is not None:
            cap = min(cap, max_skip // ps)
        shared = 0
        for i in range(min(len(keys), cap)):
            if keys[i] not in self._registry:
                break
            shared += 1

        def span_for(shared_pages: int) -> int:
            skip = shared_pages * ps
            pre_end = skip + (
                -(-(P - skip) // chunk) * chunk if chunk else P - skip
            )
            return max(P + max_new + tail, pre_end)

        # a page-aligned (not chunk-aligned) skip can push the padded
        # final chunk past max_len: drop shares until it fits
        while shared and span_for(shared) > self.max_len:
            shared -= 1
        span = span_for(shared)
        if span > self.max_len:
            raise ValueError(
                f"request needs {span} buffer positions (prompt {P} "
                f"rounded to chunks of {chunk} + {max_new} new "
                f"+ {tail} speculative) but max_len is {self.max_len}"
            )
        return keys, shared, span

    def allocate(self, prompt_ids=None, *, max_new: int = 0,
                 chunk: Optional[int] = None, tail: int = 0,
                 max_skip: Optional[int] = None,
                 keys: Optional[List[bytes]] = None
                 ) -> Optional[SlotLease]:
        """Admit one request: lowest free slot + pages for its worst-case
        span, sharing registered prefix pages where the registry allows.
        Returns None when slots or pages are exhausted (the caller keeps
        the request queued: strict FIFO)."""
        if not self._free_slots:
            return None
        ps = self.page_size
        ids = (
            np.asarray(prompt_ids, np.int32).reshape(-1)
            if prompt_ids is not None else np.zeros(0, np.int32)
        )
        P = int(ids.size)
        if P:
            keys, shared_n, span = self._plan(
                ids, max_new=max_new, chunk=chunk, tail=tail,
                max_skip=max_skip, keys=keys,
            )
        else:
            keys, shared_n = [], 0
            span = max(max_new + tail, 1)
        n_span = -(-span // ps)
        needed = n_span - shared_n
        # feasibility BEFORE mutation: free pages plus registry entries
        # nothing references (evictable) must cover the private need
        shared_pages = [self._registry[k] for k in keys[:shared_n]]
        evictable = sum(
            1 for pg in self._registry.values()
            if self._ref[pg] == 1 and pg not in shared_pages
        )
        if needed > len(self._free_pages) + evictable:
            return None
        # commit: pin shares first so eviction can never reap them
        for pg in shared_pages:
            self._ref[pg] += 1
            self._registry.move_to_end(self._page_key[pg])
        fresh = []
        for _ in range(needed):
            if not self._free_pages:
                self._evict_lru()
            fresh.append(heapq.heappop(self._free_pages))
        for pg in fresh:
            self._ref[pg] = 1
        slot = heapq.heappop(self._free_slots)
        self._occupied[slot] = True
        row = np.zeros(self.max_pages, np.int32)
        row[:shared_n] = shared_pages
        row[shared_n:n_span] = fresh
        self.page_tables[slot] = row
        self._slot_pages[slot] = tuple(shared_pages) + tuple(fresh)
        skip = shared_n * ps
        self.lengths[slot] = skip
        if P:
            self.prefix_lookups += 1
            self.prompt_tokens += P
            if shared_n:
                self.prefix_hits += 1
                self.shared_tokens += skip
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return SlotLease(
            slot=slot, skip=skip, page_row=row, n_pages=n_span,
            shared_pages=shared_n, page_keys=tuple(keys),
        )

    def _evict_lru(self) -> None:
        """Reap the least-recently-shared registry page nobody holds."""
        for key, pg in self._registry.items():
            if self._ref[pg] == 1:
                del self._registry[key]
                del self._page_key[pg]
                self._ref[pg] = 0
                heapq.heappush(self._free_pages, pg)
                return
        raise RuntimeError(
            "page eviction requested with no evictable registry entry "
            "(allocate() counted wrong — a refcount invariant broke)"
        )

    def register_prefix(self, lease: SlotLease, prompt_ids) -> None:
        """Publish a finished prefill's full prompt pages for sharing.
        Already-registered keys refresh their LRU position; a racing
        duplicate keeps the first registration canonical."""
        if not self.prefix_cache:
            return
        row = self.page_tables[lease.slot]
        for i, key in enumerate(lease.page_keys):
            page = int(row[i])
            if key in self._registry:
                self._registry.move_to_end(key)
                continue
            if page in self._page_key:  # already canonical for another key
                continue
            self._registry[key] = page
            self._page_key[page] = key
            self._ref[page] += 1

    def adopt_page(self, key: bytes) -> Optional[int]:
        """Claim one free page and register it under ``key``: the
        bookkeeping half of pulling a prefix page from a cross-engine
        store (``serve/prefix_store.py``). The caller splices the store's
        frame bytes into the returned page, which from then on is a
        registered prefix page like one this pool's own prefill wrote
        (the registry holds its one reference). Returns the registered
        page when ``key`` is known, and None when the prefix cache is off
        or no page can be freed: adoption is an optimization."""
        if not self.prefix_cache:
            return None
        cur = self._registry.get(key)
        if cur is not None:
            self._registry.move_to_end(key)
            return cur
        if not self._free_pages:
            if not any(
                self._ref[pg] == 1 for pg in self._registry.values()
            ):
                return None
            self._evict_lru()
        pg = heapq.heappop(self._free_pages)
        self._ref[pg] = 1
        self._registry[key] = pg
        self._page_key[pg] = key
        return pg

    def free(self, slot: int) -> None:
        """Retire a slot: drop its page references; pages nobody else
        holds return to the free list. No device writes."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        if not self._occupied[slot]:
            raise ValueError(f"slot {slot} is already free")
        self._occupied[slot] = False
        for pg in self._slot_pages[slot]:
            self._ref[pg] -= 1
            if self._ref[pg] == 0:
                heapq.heappush(self._free_pages, pg)
        self._slot_pages[slot] = ()
        self.page_tables[slot] = 0
        self.lengths[slot] = 0
        heapq.heappush(self._free_slots, slot)

    # -- introspection -----------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free_slots)

    @property
    def num_occupied(self) -> int:
        return self.num_slots - len(self._free_slots)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free_pages)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of prompt tokens served from shared pages."""
        return (
            self.shared_tokens / self.prompt_tokens
            if self.prompt_tokens else 0.0
        )

    def kv_bytes(self) -> int:
        """Resident bytes of the page pool (null page and scales
        included: both are allocated memory)."""
        return sum(b.numel() * b.element_size()
                   for layer in self.cache for b in layer)

    def device_page_table(self, slot: int) -> np.ndarray:
        return self.page_tables[slot].copy()

    def valid_mask(self) -> np.ndarray:
        """[S, max_len] bool over the dense view: True where a position
        of an occupied slot holds a live token, the host statement of
        what each row's causal mask lets attention read."""
        mask = np.arange(self.max_len)[None, :] < self.lengths[:, None]
        mask[~self._occupied] = False
        return mask

    def check_consistency(self) -> None:
        """Audit the refcount/free-list/registry invariants; raises on
        the first violation."""
        if sorted(self._free_slots) != [
            s for s in range(self.num_slots) if not self._occupied[s]
        ]:
            raise AssertionError("slot free list / occupancy flags drift")
        expect = np.zeros(self.num_pages + 1, np.int64)
        for slot, pages in enumerate(self._slot_pages):
            if pages and not self._occupied[slot]:
                raise AssertionError(f"free slot {slot} still holds pages")
            for pg in pages:
                if not 1 <= pg <= self.num_pages:
                    raise AssertionError(
                        f"slot {slot} references invalid page {pg}"
                    )
                expect[pg] += 1
        for key, pg in self._registry.items():
            if self._page_key.get(pg) != key:
                raise AssertionError(f"registry/page_key disagree on {pg}")
            expect[pg] += 1
        if len(self._page_key) != len(self._registry):
            raise AssertionError("page_key index out of sync with registry")
        if not np.array_equal(expect, self._ref.astype(np.int64)):
            bad = np.nonzero(expect != self._ref)[0]
            raise AssertionError(
                f"refcount drift on pages {bad.tolist()}: expected "
                f"{expect[bad].tolist()}, recorded {self._ref[bad].tolist()}"
            )
        free = sorted(self._free_pages)
        if len(set(free)) != len(free):
            raise AssertionError("duplicate entries in the page free list")
        unref = sorted(
            pg for pg in range(1, self.num_pages + 1) if expect[pg] == 0
        )
        if free != unref:
            raise AssertionError(
                f"free list {free} != unreferenced pages {unref}"
            )
        if expect[0] != 0:
            raise AssertionError("null page 0 acquired a reference")
