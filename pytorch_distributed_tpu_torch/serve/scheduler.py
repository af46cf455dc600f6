"""Request lifecycle + FIFO admission scheduling for the serve engine: the
port of ``pytorch_distributed_tpu/serve/scheduler.py`` (host-only state,
no framework code).

* **FIFO admission**: queued requests claim freed slots in arrival
  order; the free list hands out the lowest slot first, so a seeded
  workload replays exactly.
* **Chunked prefill**: a prompt prefills ``prefill_chunk`` tokens at a
  time, oldest admitted request first, at most
  ``prefill_chunks_per_step`` chunks per engine step, so a long prompt
  cannot stall the decode tick of the requests already flowing.
* **Deadlines** are absolute points checked every step: queued requests
  expire in place, in-flight requests are evicted and their slot freed.
  Cancellation follows the same eviction path.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    COMPLETED = "completed"
    CANCELLED = "cancelled"
    EXPIRED = "expired"
    FAILED = "failed"
    #: terminal on a prefill-tier engine: its pages were packed and
    #: shipped, and the request continues on a decode-tier peer
    MIGRATED = "migrated"


#: statuses a request can still make progress from
LIVE_STATUSES = (
    RequestStatus.QUEUED, RequestStatus.PREFILLING, RequestStatus.DECODING,
)

_req_counter = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request: the engine-facing analogue of a solo
    ``generate(prompt, max_new_tokens, temperature, top_k, top_p, eos_id,
    generator=Generator().manual_seed(seed))`` call."""

    prompt_ids: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_id: Optional[int] = None
    seed: int = 0
    #: seconds from submit() until the request is abandoned (queued OR
    #: mid-flight); None = no deadline
    deadline_s: Optional[float] = None
    request_id: str = ""

    def __post_init__(self):
        self.prompt_ids = np.asarray(self.prompt_ids, np.int32).reshape(-1)
        if self.prompt_ids.size < 1:
            raise ValueError("prompt_ids must hold at least one token")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}"
            )
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if not self.request_id:
            self.request_id = f"req-{next(_req_counter)}"

    @property
    def prompt_len(self) -> int:
        return int(self.prompt_ids.size)


class RequestHandle:
    """Live view of a submitted request: streamed tokens + status."""

    def __init__(self, request: Request, submitted_at: float):
        self.request = request
        self.status = RequestStatus.QUEUED
        self.tokens: List[int] = []
        self.error: Optional[BaseException] = None
        self.slot: Optional[int] = None
        self.submitted_at = submitted_at
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.on_token = None  # optional callable(handle, token)
        # -- scheduler internals --
        self._prefill_done = 0  # prompt tokens written into the slot
        self._cancel = False
        self._lease = None
        self._dlease = None
        # prompt chain-hash keys, computed once at the first admission
        # attempt (a page-blocked head retries every engine step)
        self._chain_keys = None

    @property
    def done(self) -> bool:
        return self.status not in LIVE_STATUSES

    @property
    def deadline_at(self) -> Optional[float]:
        d = self.request.deadline_s
        return None if d is None else self.submitted_at + d

    def emit(self, token: int, now: float) -> None:
        if self.first_token_at is None:
            self.first_token_at = now
        self.tokens.append(int(token))
        if self.on_token is not None:
            self.on_token(self, int(token))

    def __repr__(self):  # pragma: no cover - debugging nicety
        return (
            f"RequestHandle({self.request.request_id}, "
            f"{self.status.value}, tokens={len(self.tokens)})"
        )


@dataclasses.dataclass(frozen=True)
class PrefillChunk:
    """One planned prefill step: write ``ids[:chunk_len]`` (right-padded
    to the static chunk width by the engine) at position ``start`` of
    ``handle.slot``; ``final`` chunks sample the first token."""

    handle: RequestHandle
    start: int
    ids: np.ndarray  # [chunk_len] real prompt tokens (unpadded)
    final: bool

    @property
    def chunk_len(self) -> int:
        return int(self.ids.size)


class Scheduler:
    """FIFO queue + slot admission + chunk planning (host-only state)."""

    def __init__(self, num_slots: int, prefill_chunk: int):
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.prefill_chunk = prefill_chunk
        self.queue: Deque[RequestHandle] = deque()
        self.by_slot: Dict[int, RequestHandle] = {}
        self._prefilling: List[RequestHandle] = []  # admission order

    # -- intake ------------------------------------------------------------
    def enqueue(self, handle: RequestHandle) -> None:
        self.queue.append(handle)

    def queue_depth(self) -> int:
        return len(self.queue)

    def live_handles(self) -> List[RequestHandle]:
        return list(self.queue) + list(self.by_slot.values())

    def find(self, request_id: str) -> Optional[RequestHandle]:
        for h in self.live_handles():
            if h.request.request_id == request_id:
                return h
        return None

    # -- admission ---------------------------------------------------------
    def admit(self, pool, draft_pool=None, *, tail: int = 0
              ) -> List[RequestHandle]:
        """Move queued requests into freed slots + pages (strict FIFO: a
        head-of-line request that doesn't fit blocks the queue). Returns
        the newly admitted handles, PREFILLING with their prefill cursor
        at the shared-prefix skip. ``draft_pool`` is allocated in
        lockstep, on the skip both pools can serve from shares."""
        admitted = []
        while self.queue:
            h = self.queue[0]
            req = h.request
            if h._chain_keys is None:
                h._chain_keys = pool.chain_keys(req.prompt_ids)
            kw = dict(
                max_new=req.max_new_tokens, chunk=self.prefill_chunk,
                tail=tail, keys=h._chain_keys,
            )
            if draft_pool is None:
                lease = pool.allocate(req.prompt_ids, **kw)
                if lease is None:
                    break
                dlease = None
            else:
                joint = min(
                    pool.shareable_skip(req.prompt_ids, **kw),
                    draft_pool.shareable_skip(req.prompt_ids, **kw),
                )
                lease = pool.allocate(req.prompt_ids, max_skip=joint, **kw)
                if lease is None:
                    break
                dlease = draft_pool.allocate(
                    req.prompt_ids, max_skip=joint, **kw
                )
                if dlease is None:
                    pool.free(lease.slot)
                    break
                if dlease.slot != lease.slot or dlease.skip != lease.skip:
                    raise RuntimeError(
                        "target and draft pools drifted apart at admission"
                    )
            self.queue.popleft()
            h.slot = lease.slot
            h._lease = lease
            h._dlease = dlease
            h.status = RequestStatus.PREFILLING
            h._prefill_done = lease.skip
            self.by_slot[lease.slot] = h
            self._prefilling.append(h)
            admitted.append(h)
        return admitted

    def adopt(self, handle: RequestHandle, lease) -> None:
        """Bind an already-prefilled request to a slot, skipping the
        queue and the prefill plan: the decode-tier half of a KV
        migration (``ServeEngine.inject_migration``), whose pages arrive
        spliced, so the handle enters DECODING directly."""
        handle.slot = lease.slot
        handle._lease = lease
        handle._dlease = None
        handle.status = RequestStatus.DECODING
        handle._prefill_done = handle.request.prompt_len
        self.by_slot[lease.slot] = handle

    # -- prefill planning --------------------------------------------------
    def plan_prefill(self, budget: int) -> List[PrefillChunk]:
        """Up to ``budget`` chunks, oldest admitted request first."""
        plans: List[PrefillChunk] = []
        for h in self._prefilling:
            if len(plans) >= budget:
                break
            p = h.request.prompt_ids
            while h._prefill_done < p.size and len(plans) < budget:
                start = h._prefill_done
                ids = p[start:start + self.prefill_chunk]
                plans.append(PrefillChunk(
                    handle=h, start=start, ids=ids,
                    final=start + ids.size >= p.size,
                ))
                h._prefill_done = start + ids.size
        return plans

    def prefill_finished(self, handle: RequestHandle) -> None:
        """The final chunk ran and the first token was emitted."""
        handle.status = RequestStatus.DECODING
        if handle in self._prefilling:
            self._prefilling.remove(handle)

    # -- decode view -------------------------------------------------------
    def decoding(self) -> List[Tuple[int, RequestHandle]]:
        return sorted(
            ((s, h) for s, h in self.by_slot.items()
             if h.status is RequestStatus.DECODING),
            key=lambda sh: sh[0],
        )

    # -- retirement --------------------------------------------------------
    def release(self, handle: RequestHandle, pool, draft_pool=None) -> None:
        """Detach a handle from its slot (terminal status already set by
        the engine) and drop its page references in both pools."""
        if handle.slot is not None:
            self.by_slot.pop(handle.slot, None)
            pool.free(handle.slot)
            if draft_pool is not None:
                draft_pool.free(handle.slot)
            handle.slot = None
            handle._lease = None
            handle._dlease = None
        if handle in self._prefilling:
            self._prefilling.remove(handle)
        if handle in self.queue:
            self.queue.remove(handle)

    # -- deadline / cancellation sweeps ------------------------------------
    def sweep_expired(self, now: float) -> List[RequestHandle]:
        return [
            h for h in self.live_handles()
            if h.deadline_at is not None and now >= h.deadline_at
        ]

    def sweep_cancelled(self) -> List[RequestHandle]:
        return [h for h in self.live_handles() if h._cancel]
