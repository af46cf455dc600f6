"""Cross-engine prefix registry: prefill a hot prompt once per FLEET;
the port's own copy of ``pytorch_distributed_tpu/serve/prefix_store.py``.

The pool's registry (``kv_slots.PagedKVPool._registry``) is per engine:
a popular system prompt behind a router would be prefilled once per
engine. This store externalizes it: keys are the pool's own chain-hash
page keys (prefix identity, tokens AND position), values the page's
frame bytes in the ``kv_slots.extract_frames`` codec.

* **publish**: when a prefill finishes, the engine pushes every full
  prompt page the store lacks (first writer wins; a racing duplicate is
  dropped), so a shared prefix is prefilled exactly once per fleet.
* **adopt**: before admitting a queued request, the engine walks its
  chain keys: a store hit claims a free page (``pool.adopt_page``),
  splices the bytes in, and the normal ``allocate`` shares it. Adoption
  stops at the first miss.

Entries are pinned by HOLDER (an engine id); the ROUTER releases a lost
or retired engine's pins (``release_holder``). A pinned entry is never
evicted; an unpinned one lives until capacity pressure reaps it, LRU
first. An entry evicted between a lookup and its splice is a missed
optimization, never a correctness hazard: the engine prefills the pages
itself.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Set

import numpy as np

from pytorch_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class PrefixStore:
    """The store protocol: what engines and the router call.

    Any implementation must keep ``get``/``put`` idempotent and
    first-writer-wins: a key's payload is immutable once stored (chain
    keys commit to tokens and page size, so two honest writers can only
    ever offer identical bytes).
    """

    def get(self, key: bytes, holder: Optional[str] = None):
        raise NotImplementedError

    def put(self, key: bytes, payload, holder: Optional[str] = None):
        raise NotImplementedError

    def release_holder(self, holder: str) -> int:
        raise NotImplementedError

    def stats(self) -> Dict[str, int]:
        raise NotImplementedError


class InProcPrefixStore(PrefixStore):
    """Reference in-process store: LRU + holder pins + counters.

    ``capacity_pages`` bounds resident entries (None = unbounded);
    eviction is LRU over UNPINNED entries only. ``signature``, when
    set, is the fleet's ``kv_slots.frame_signature`` — a put or get
    under a different signature raises, catching a mixed-geometry
    fleet at the store boundary instead of as a corrupt splice.
    """

    def __init__(self, capacity_pages: Optional[int] = None,
                 signature: Optional[str] = None):
        if capacity_pages is not None and capacity_pages < 1:
            raise ValueError(
                f"capacity_pages must be >= 1, got {capacity_pages}"
            )
        self.capacity_pages = capacity_pages
        self.signature = signature
        self._entries: "OrderedDict[bytes, np.ndarray]" = OrderedDict()
        self._holders: Dict[bytes, Set[str]] = {}
        self.puts = 0          # payloads actually stored (dups excluded)
        self.dup_puts = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def _check_signature(self, signature: Optional[str]) -> None:
        if (
            signature is not None and self.signature is not None
            and signature != self.signature
        ):
            raise ValueError(
                "prefix-store geometry mismatch: store holds "
                f"{self.signature!r}, caller offers {signature!r} — "
                "a splice across these would corrupt pages"
            )

    def get(self, key: bytes, holder: Optional[str] = None,
            signature: Optional[str] = None) -> Optional[np.ndarray]:
        """Payload for ``key`` (None on miss). ``holder`` pins the
        entry against eviction until ``release_holder(holder)``."""
        self._check_signature(signature)
        payload = self._entries.get(key)
        if payload is None:
            self.misses += 1
            return None
        self.hits += 1
        self._entries.move_to_end(key)
        if holder is not None:
            self._holders.setdefault(key, set()).add(holder)
        return payload

    def put(self, key: bytes, payload, holder: Optional[str] = None,
            signature: Optional[str] = None) -> bool:
        """Store ``key`` -> frame bytes. Returns True when the payload
        was actually stored (False = already present: first writer
        stays canonical, the duplicate is dropped unread)."""
        self._check_signature(signature)
        if key in self._entries:
            self.dup_puts += 1
            self._entries.move_to_end(key)
            if holder is not None:
                self._holders.setdefault(key, set()).add(holder)
            return False
        while (
            self.capacity_pages is not None
            and len(self._entries) >= self.capacity_pages
        ):
            if not self._evict_one():
                logger.warning(
                    "prefix store full (%d pages) with every entry "
                    "pinned — dropping put instead of evicting live "
                    "state", len(self._entries),
                )
                return False
        arr = np.frombuffer(
            np.ascontiguousarray(payload, np.uint8).tobytes(), np.uint8
        )
        self._entries[key] = arr
        if holder is not None:
            self._holders.setdefault(key, set()).add(holder)
        self.puts += 1
        return True

    def _evict_one(self) -> bool:
        for key in self._entries:
            if not self._holders.get(key):
                del self._entries[key]
                self._holders.pop(key, None)
                self.evictions += 1
                return True
        return False

    def release_holder(self, holder: str) -> int:
        """Drop every pin ``holder`` placed — the router's engine-churn
        hook (retired or lost engines). Entries stay resident (their
        bytes remain canonical for the fleet) until capacity pressure
        evicts them; returns how many pins were released."""
        released = 0
        for key, holders in list(self._holders.items()):
            if holder in holders:
                holders.discard(holder)
                released += 1
            if not holders:
                self._holders.pop(key, None)
        return released

    def pinned(self, key: bytes) -> int:
        """How many holders pin ``key`` (0 = evictable)."""
        return len(self._holders.get(key, ()))

    def resident_bytes(self) -> int:
        return sum(int(v.size) for v in self._entries.values())

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "bytes": self.resident_bytes(),
            "puts": self.puts,
            "dup_puts": self.dup_puts,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "pinned": sum(1 for h in self._holders.values() if h),
        }
