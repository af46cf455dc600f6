"""Continuous-batching serve loop: admit/retire mid-flight over a paged
KV pool; the port of ``pytorch_distributed_tpu/serve/engine.py`` for the
solo engine.

The engine composes a ``PagedKVPool`` (page-granular device buffers +
host page tables), a ``Scheduler`` (host dynamism) and per-row sampling.
Eager PyTorch takes the place of the JAX package's jitted programs:

* **prefill**: one ``[1, prefill_chunk]`` model pass writes a chunk of
  one request's prompt into its pages (gather the slot's pages to a
  dense row, write the chunk at ``write_pos``, scatter the chunk back)
  and samples the first token on the final chunk.
* **decode** (``decode_mode="paged"``): one ``[S, 1]`` tick over all
  slots through ``generation.decode_step_body``, attending in place over
  the page pool: the model gets a ``PagedView``, new K/V lands through
  per-page writes (free and mid-prefill rows write nothing), and
  attention runs the paged-attention kernel, once per layer.
  ``decode_mode="dense"`` keeps the dense-gather tick as the A/B
  baseline.
* **length buckets**: the page-table width handed to the kernel (and
  the dense prefill row) rounds up to the live maximum's power-of-two
  page bucket instead of always ``max_len``.

Per-slot decode state (tokens, lengths, sampling params, page tables)
lives on the device and changes only at request transitions; the tick
advances the decoding rows in place, so a steady-state tick uploads
nothing and fetches the sampled tokens once. Each request samples with
its own ``torch.Generator`` seeded from ``Request.seed``, so a completed
stream equals the solo ``generate`` call with
``generator=torch.Generator(device).manual_seed(seed)``.

Failure model (degrade, don't crash): the ``serve.prefill`` and
``serve.decode`` fault sites fire per request; a poisoned request is
evicted as FAILED, its slot and page references released, and the
engine keeps serving.

Not ported yet: speculative decoding (``spec``), the prefill/decode
roles with KV migration, the cross-engine prefix store, and int8 KV
pools; each raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.generation import (
    decode_step_body,
    gumbel_noise,
    model_max_len,
)
from pytorch_distributed_tpu_torch.ops.paged_attention import PagedView
from pytorch_distributed_tpu_torch.runtime import faults
from pytorch_distributed_tpu_torch.runtime import tracing
from pytorch_distributed_tpu_torch.runtime.device import (
    DeviceLike,
    resolve_device,
)
from pytorch_distributed_tpu_torch.serve.kv_slots import (
    PagedKVPool,
    gather_pages,
    scatter_kv,
)
from pytorch_distributed_tpu_torch.serve.sampling import (
    TOP_K_OFF,
    TOP_P_OFF,
    sample_logits_rows,
)
from pytorch_distributed_tpu_torch.serve.scheduler import (
    Request,
    RequestHandle,
    RequestStatus,
    Scheduler,
)
from pytorch_distributed_tpu_torch.serve.telemetry import ServeTelemetry
from pytorch_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_slots: int = 4          # S: max concurrent in-flight requests
    max_len: int = 256          # per-request KV capacity
    prefill_chunk: int = 32     # static prompt-chunk width
    prefill_chunks_per_step: int = 1  # prefill/decode interleave ratio
    telemetry_every: int = 32   # engine steps between occupancy snapshots
    # page_size None -> largest power-of-2 divisor of max_len (<= 32);
    # num_pages None -> memory parity with a fixed [S, max_len] pool;
    # prefix_cache shares identical page-aligned prompt prefixes
    page_size: Optional[int] = None
    num_pages: Optional[int] = None
    prefix_cache: bool = True
    # "paged": the decode tick attends in place over the page pool;
    # "dense": the full-width gather tick, the A/B baseline
    decode_mode: str = "paged"
    # "solo" serves requests end to end; the "prefill"/"decode" tiers
    # are not ported yet
    role: str = "solo"
    engine_id: Optional[str] = None

    def __post_init__(self):
        if self.decode_mode not in ("paged", "dense"):
            raise ValueError(
                f"decode_mode must be 'paged' or 'dense', got "
                f"{self.decode_mode!r}"
            )
        if self.role not in ("solo", "prefill", "decode"):
            raise ValueError(
                f"role must be 'solo', 'prefill' or 'decode', got "
                f"{self.role!r}"
            )
        if self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.prefill_chunks_per_step < 1:
            raise ValueError("prefill_chunks_per_step must be >= 1")
        if self.max_len < 2:
            raise ValueError("max_len must be >= 2 (1 prompt + 1 new)")
        if self.prefill_chunk > self.max_len:
            raise ValueError(
                f"prefill_chunk {self.prefill_chunk} > max_len "
                f"{self.max_len}: no request could ever be admitted"
            )
        if self.page_size is not None and (
            self.page_size < 1 or self.max_len % self.page_size
        ):
            raise ValueError(
                f"page_size {self.page_size} must divide max_len "
                f"{self.max_len}"
            )


class ServeEngine:
    """Single-threaded, deterministic serve loop.

    Drive it with ``submit()`` + ``step()`` (one scheduler iteration:
    deadline sweep -> cancellations -> admission -> prefill chunks ->
    decode tick), or ``run_until_drained()``. Tokens stream into each
    ``RequestHandle.tokens`` as they are emitted.

    ``device`` defaults to the CUDA card and must hold ``model``; the
    CPU runs the plain PyTorch path only when asked for by name.
    """

    def __init__(
        self,
        model,
        config: EngineConfig = EngineConfig(),
        *,
        device: DeviceLike = None,
        spec=None,
        telemetry: Optional[ServeTelemetry] = None,
        prefix_store=None,
        clock=time.monotonic,
    ):
        device = resolve_device(device)
        if model.device != device:
            raise ValueError(
                f"the model lives on {model.device}, the engine was asked "
                f"for {device}"
            )
        if config.role != "solo":
            raise NotImplementedError(
                f"role={config.role!r}: the prefill/decode tiers are not "
                "ported yet (ROADMAP item A9.3)"
            )
        if spec is not None:
            raise NotImplementedError(
                "speculative decoding (SpecConfig) is not ported yet "
                "(ROADMAP item A9.2)"
            )
        if prefix_store is not None:
            raise NotImplementedError(
                "the cross-engine prefix store is not ported yet "
                "(ROADMAP item A9.3)"
            )
        self.model = model
        self.config = config
        self.device = device
        self.telemetry = telemetry or ServeTelemetry(
            clock=clock, engine_id=config.engine_id
        )
        self._clock = clock
        limit = model_max_len(model)
        if limit is not None and config.max_len > limit:
            raise ValueError(
                f"max_len {config.max_len} exceeds the model's maximum "
                f"sequence length {limit}"
            )
        with torch.no_grad():
            self.pool = PagedKVPool(
                model, config.num_slots, config.max_len,
                page_size=config.page_size, num_pages=config.num_pages,
                prefix_cache=config.prefix_cache,
            )
        self.scheduler = Scheduler(config.num_slots, config.prefill_chunk)
        S = config.num_slots
        mp = self.pool.max_pages
        dev = dict(device=device)
        # per-slot decode state on the device, written at request
        # transitions and advanced in place by the tick; stale rows of
        # free / mid-prefill slots are harmless: their tokens are
        # discarded and their pool writes dropped
        self._toks = torch.zeros(S, dtype=torch.long, **dev)
        self._lengths = torch.zeros(S, dtype=torch.int32, **dev)
        self._temps = torch.zeros(S, dtype=torch.float32, **dev)
        self._top_ks = torch.full((S,), TOP_K_OFF, dtype=torch.long, **dev)
        self._top_ps = torch.full((S,), TOP_P_OFF, dtype=torch.float32,
                                  **dev)
        self._pt = torch.zeros((S, mp), dtype=torch.int32, **dev)
        #: each sampling slot's own generator (None for greedy slots)
        self._gens: List[Optional[torch.Generator]] = [None] * S
        self._n_deadlines = 0
        self._any_cancel = False
        # the decoding set only changes at request transitions
        self._decoding_dirty = True
        self._decoding_cached: List[Tuple[int, RequestHandle]] = []
        self._active_cached: Optional[torch.Tensor] = None
        self._sampling_slots: List[int] = []
        self._steps = 0
        self._decode_ticks = 0
        self._buckets = (
            self._bucket_list(mp) if config.decode_mode == "paged" else [mp]
        )
        self.decode_bucket_ticks: dict = {}
        # analytic HBM accounting for the decode path, host-side ints
        self._frame_bytes = self.pool.frame_bytes()
        self.decode_gather_bytes = 0   # dense-intermediate traffic only
        self.decode_hbm_bytes = 0      # gather + attention-stream reads
        self._decode_tokens = 0

    # -- length buckets ----------------------------------------------------
    @staticmethod
    def _bucket_list(max_pages: int):
        """Power-of-two page widths up to (and always including) the full
        table. <= log2(max_pages) + 1 entries."""
        out, b = [], 1
        while b < max_pages:
            out.append(b)
            b *= 2
        out.append(max_pages)
        return out

    def _bucket_for(self, pages: int) -> int:
        for b in self._buckets:
            if b >= pages:
                return b
        return self._buckets[-1]

    def _tick_bucket(self, decoding) -> int:
        """The page width this tick runs at: the smallest bucket covering
        every ACTIVE row's reads and its write. Inactive rows may point
        beyond it; their reads are discarded and their writes dropped."""
        if self.config.decode_mode == "dense":
            return self.pool.max_pages
        need = max(int(self.pool.lengths[slot]) for slot, _ in decoding) + 1
        return self._bucket_for(-(-need // self.pool.page_size))

    def _tick_cost(self, n_pages: int) -> Tuple[int, int]:
        """(gather_bytes, total_hbm_bytes) one decode tick moves: the
        dense tick gathers (reads + writes a dense copy) before it
        attends; the paged tick reads each page once."""
        S = self.config.num_slots
        attn = S * n_pages * self._frame_bytes
        gather = 2 * attn if self.config.decode_mode == "dense" else 0
        return gather, gather + attn

    @property
    def decode_ticks(self) -> int:
        return self._decode_ticks

    @property
    def decode_hbm_bytes_per_token(self) -> float:
        return self.decode_hbm_bytes / max(self._decode_tokens, 1)

    # -- intake ------------------------------------------------------------
    def _validate_request(self, request: Request) -> None:
        cfg = self.config
        P = request.prompt_len
        chunks = -(-P // cfg.prefill_chunk)
        if chunks * cfg.prefill_chunk > cfg.max_len:
            raise ValueError(
                f"prompt ({P} tokens) rounds up to "
                f"{chunks * cfg.prefill_chunk} chunked-prefill slots, "
                f"exceeding max_len {cfg.max_len}"
            )
        if P + request.max_new_tokens > cfg.max_len:
            raise ValueError(
                f"prompt ({P}) + max_new_tokens ({request.max_new_tokens}) "
                f"exceeds the engine's max_len {cfg.max_len}"
            )

    def submit(self, request: Request) -> RequestHandle:
        """Validate + enqueue; returns the streaming handle."""
        self._validate_request(request)
        handle = RequestHandle(request, submitted_at=self._clock())
        if request.deadline_s is not None:
            self._n_deadlines += 1
        self.scheduler.enqueue(handle)
        self.telemetry.record_submit(handle)
        return handle

    def cancel(self, request_id: str) -> bool:
        """Flag a live request for eviction at the next step."""
        h = self.scheduler.find(request_id)
        if h is None:
            return False
        h._cancel = True
        self._any_cancel = True
        return True

    def inject_migration(self, frame, submitted_at=None):
        raise NotImplementedError(
            "KV migration between prefill and decode tiers is not ported "
            "yet (ROADMAP item A9.3)"
        )

    # -- the loop ----------------------------------------------------------
    def has_work(self) -> bool:
        return bool(self.scheduler.queue or self.scheduler.by_slot)

    def step(self) -> bool:
        """One scheduler iteration; returns True when any device work
        ran (a prefill chunk or a decode tick)."""
        self._steps += 1
        if self._n_deadlines:
            now = self._clock()
            for h in self.scheduler.sweep_expired(now):
                self._finish(h, RequestStatus.EXPIRED)
        if self._any_cancel:
            self._any_cancel = False
            for h in self.scheduler.sweep_cancelled():
                self._finish(h, RequestStatus.CANCELLED)
        for h in self.scheduler.admit(self.pool):
            with tracing.span("serve.admit", request=h.request.request_id):
                self._configure_slot(h)
        did = self._run_prefill()
        did = self._run_decode() or did
        if self.config.telemetry_every and (
            self._steps % self.config.telemetry_every == 0
        ):
            self._snapshot()
        return did

    def run_until_drained(self, max_steps: int = 1_000_000) -> None:
        """Step until every submitted request reaches a terminal state."""
        for _ in range(max_steps):
            if not self.has_work():
                return
            self.step()
        raise RuntimeError(
            f"engine did not drain within {max_steps} steps "
            f"({len(self.scheduler.live_handles())} requests live)"
        )

    def _snapshot(self) -> None:
        pool = self.pool
        occupancy = (
            pool.pages_in_use / pool.num_pages if pool.num_pages else 0.0
        )
        self.telemetry.record_snapshot(
            queue_depth=self.scheduler.queue_depth(),
            slots_occupied=pool.num_occupied,
            slots_total=pool.num_slots,
            decode_ticks=self._decode_ticks,
            pages_in_use=pool.pages_in_use,
            pages_total=pool.num_pages,
            page_occupancy=occupancy,
            prefix_hit_rate=pool.prefix_hit_rate,
            decode_gather_bytes=self.decode_gather_bytes,
            decode_hbm_bytes_per_token=round(
                self.decode_hbm_bytes_per_token, 1
            ),
        )
        if tracing._tracer is not None:
            tracing.counter("serve.kv_pages_in_use", pool.pages_in_use)
            tracing.counter("serve.kv_page_occupancy", occupancy)
            tracing.counter("serve.prefix_hit_rate", pool.prefix_hit_rate)
            tracing.counter(
                "serve.decode_hbm_bytes_per_token",
                self.decode_hbm_bytes_per_token,
            )

    # -- phase bodies ------------------------------------------------------
    def _run_prefill(self) -> bool:
        cfg = self.config
        did = False
        for plan in self.scheduler.plan_prefill(cfg.prefill_chunks_per_step):
            h = plan.handle
            if h.done:  # evicted earlier in this very step's plan list
                continue
            if faults.active():
                try:
                    faults.check("serve.prefill", path=h.request.request_id)
                except faults.InjectedFault as e:
                    self._finish(h, RequestStatus.FAILED, error=e)
                    continue
            ids = np.zeros((1, cfg.prefill_chunk), np.int64)
            ids[0, :plan.chunk_len] = plan.ids
            # the chunk reaches positions [0, start + C): gather the
            # smallest bucket covering them, not the max_len-wide row
            n_pages = self._bucket_for(
                -(-(plan.start + cfg.prefill_chunk) // self.pool.page_size)
            )
            with tracing.span(
                "serve.prefill_chunk", request=h.request.request_id
            ):
                tok = self._prefill_chunk(ids, h.slot, plan, n_pages)
            self.pool.lengths[h.slot] = plan.start + plan.chunk_len
            did = True
            if plan.final:
                # the slot's full prompt pages now hold canonical KV
                self.pool.register_prefix(h._lease, h.request.prompt_ids)
                self.scheduler.prefill_finished(h)
                self._decoding_dirty = True
                self._emit(h, tok)
        return did

    @torch.no_grad()
    def _prefill_chunk(self, ids, slot, plan, n_pages) -> Optional[int]:
        """One chunk through the model over the slot's bucket of pages;
        on the final chunk, samples and returns the first token."""
        C = self.config.prefill_chunk
        dev = self.device
        row_pt = self._pt[slot:slot + 1, :n_pages]
        positions = plan.start + torch.arange(C, device=dev)[None]
        dense = gather_pages(self.pool.cache, row_pt)
        logits, dense = self.model(
            torch.from_numpy(ids).to(dev), positions, cache=dense,
            write_pos=torch.full((1,), plan.start, dtype=torch.int32,
                                 device=dev),
            decode=True, cache_len=n_pages * self.pool.page_size,
        )
        scatter_kv(
            self.pool.cache, dense, row_pt, positions,
            torch.ones((1, C), dtype=torch.bool, device=dev),
        )
        # the device length cursor advances with EVERY chunk: a decode
        # tick between chunks must see it at the next chunk's start
        self._lengths[slot] = plan.start + plan.chunk_len
        if not plan.final:
            return None
        last = logits[:, plan.chunk_len - 1]          # [1, V]
        s = slice(slot, slot + 1)
        gen = self._gens[slot]
        noise = (
            torch.zeros_like(last) if gen is None
            else gumbel_noise(last.shape, gen, dev)
        )
        tok = sample_logits_rows(
            last, noise, self._temps[s], self._top_ks[s], self._top_ps[s]
        )
        self._toks[s] = tok
        return int(tok)

    def _run_decode(self) -> bool:
        if self._decoding_dirty:
            self._decoding_cached = self.scheduler.decoding()
            active = np.zeros(self.config.num_slots, bool)
            for slot, _ in self._decoding_cached:
                active[slot] = True
            self._active_cached = torch.from_numpy(active).to(self.device)
            self._sampling_slots = [
                slot for slot, h in self._decoding_cached
                if h.request.temperature > 0
            ]
            self._decoding_dirty = False
        decoding = self._decoding_cached
        if not decoding:
            return False
        self._decode_ticks += 1
        n_pages = self._tick_bucket(decoding)
        self.decode_bucket_ticks[n_pages] = (
            self.decode_bucket_ticks.get(n_pages, 0) + 1
        )
        span = (
            tracing._NULL_SPAN if tracing._tracer is None
            else tracing.span("serve.decode_tick", active=len(decoding))
        )
        with span:
            nxt = self._decode_tick(n_pages)
        gb, hb = self._tick_cost(n_pages)
        self.decode_gather_bytes += gb
        self.decode_hbm_bytes += hb
        self._decode_tokens += len(decoding)
        with tracing.span("serve.token_fetch"):
            # the one per-tick device sync: every sampled token comes down
            nxt = nxt.cpu().numpy()
        fault_armed = faults.active()
        for slot, h in decoding:
            # the tick wrote this slot's token at lengths[slot]
            self.pool.lengths[slot] += 1
            if fault_armed:
                try:
                    faults.check("serve.decode", path=h.request.request_id)
                except faults.InjectedFault as e:
                    self._finish(h, RequestStatus.FAILED, error=e)
                    continue
            self._emit(h, int(nxt[slot]))
        return True

    @torch.no_grad()
    def _decode_tick(self, n_pages: int) -> torch.Tensor:
        """One ``[S, 1]`` decode step over every slot; advances the
        decoding rows' token/length state in place and returns the
        sampled tokens [S]."""
        active = self._active_cached
        kw = dict(
            cache_len=self.config.max_len,
            positions=self._lengths[:, None], write_pos=self._lengths,
        )
        if self.config.decode_mode == "paged":
            view = PagedView(
                page_tables=self._pt[:, :n_pages].contiguous(),
                keep=active, page_size=self.pool.page_size,
            )
            last, _ = decode_step_body(
                self.model, self.pool.cache, self._toks, paged=view, **kw
            )
        else:
            dense = gather_pages(self.pool.cache, self._pt)
            last, dense = decode_step_body(
                self.model, dense, self._toks, **kw
            )
            # persist ONLY the decoding rows' written token
            scatter_kv(
                self.pool.cache, dense, self._pt, self._lengths[:, None],
                active[:, None],
            )
        if self._sampling_slots:
            noise = torch.zeros_like(last)
            for slot in self._sampling_slots:
                noise[slot] = gumbel_noise(
                    (1, last.shape[-1]), self._gens[slot], self.device
                )[0]
            nxt = sample_logits_rows(
                last, noise, self._temps, self._top_ks, self._top_ps
            )
        else:
            # all-greedy tick: the rows version's greedy lane, without
            # the vocab sort the filters need
            nxt = torch.argmax(last, dim=-1)
        self._toks = torch.where(active, nxt, self._toks)
        self._lengths += active.to(torch.int32)
        return nxt

    # -- emission / retirement ---------------------------------------------
    def _emit(self, h: RequestHandle, token: int) -> None:
        h.emit(token, self._clock())
        req = h.request
        if req.eos_id is not None and token == req.eos_id:
            self._finish(h, RequestStatus.COMPLETED)
        elif len(h.tokens) >= req.max_new_tokens:
            self._finish(h, RequestStatus.COMPLETED)

    def _finish(self, h: RequestHandle, status: RequestStatus,
                error: Optional[BaseException] = None) -> None:
        h.status = status
        h.error = error
        h.finished_at = self._clock()
        if h.request.deadline_s is not None:
            self._n_deadlines -= 1
        self._decoding_dirty = True
        if h.slot is not None:
            self._gens[h.slot] = None
        with tracing.span(
            "serve.evict", request=h.request.request_id, status=status.value,
        ):
            self.scheduler.release(h, self.pool)
        self.telemetry.record_done(h)
        if status is RequestStatus.FAILED:
            logger.warning(
                "serve: evicted request %s after fault: %s",
                h.request.request_id, error,
            )

    # -- admission-time slot setup ----------------------------------------
    def _configure_slot(self, h: RequestHandle) -> None:
        req = h.request
        slot = h.slot
        lease = h._lease
        self._temps[slot] = req.temperature
        self._top_ks[slot] = TOP_K_OFF if req.top_k is None else req.top_k
        self._top_ps[slot] = TOP_P_OFF if req.top_p is None else req.top_p
        # the write cursor parks at `skip`, the first position the
        # request's own prefill writes; everything before is shared
        # read-only prefix pages
        self._lengths[slot] = lease.skip
        self._pt[slot] = torch.from_numpy(lease.page_row).to(self.device)
        self._gens[slot] = (
            torch.Generator(device=self.device).manual_seed(req.seed)
            if req.temperature > 0 else None
        )
