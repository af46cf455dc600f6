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
The migration frame codec (``extract_frames``/``splice_frames``) and
``adopt_page`` serve the prefill/decode tiers and the prefix store,
which are not ported yet.
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

from pytorch_distributed_tpu_torch.ops.paged_attention import (
    gather_dense,
    write_positions,
)
from pytorch_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# warn-once dedup for degenerate auto page sizes
_warned_page_sizes: set = set()


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
    batch = ``num_pages + 1`` frames and length = ``page_size``. Frame 0
    is the reserved null page. int8 pools are not ported."""
    if getattr(model.config, "kv_cache_quantize", None) is not None:
        raise NotImplementedError(
            "int8 paged KV pools are not ported: the paged-attention kernel "
            "takes fp pools (ROADMAP A9.1)")
    return model.init_cache(num_pages + 1, page_size)


def gather_pages(cache, page_tables):
    """Page pool + ``[B, n]`` tables -> dense ``[B, n * page_size]``
    per-layer buffers, a valid decode cache for the model."""
    return [
        (gather_dense(k, page_tables), gather_dense(v, page_tables))
        for k, v in cache
    ]


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
    for (k, v), (dk, dv) in zip(cache, dense):
        write_positions(k, page_tables, idx, dk[rows, src], keep)
        write_positions(v, page_tables, idx, dv[rows, src], keep)
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

    def frame_bytes(self) -> int:
        """Bytes of ONE page frame across every layer's K and V."""
        return sum(
            k[0].numel() * k.element_size() + v[0].numel() * v.element_size()
            for k, v in self.cache
        )

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
