"""Continuous-batching serve loop: admit/retire mid-flight over a paged
KV pool; the port of ``pytorch_distributed_tpu/serve/engine.py``.

The engine composes a ``PagedKVPool`` (page-granular device buffers +
host page tables), a ``Scheduler`` (host dynamism) and per-row sampling.
It serves any model with the decode contract of ``generation.generate``
(GPT-2 and Llama). Eager PyTorch takes the place of the JAX package's
jitted programs:

* **prefill**: one ``[1, prefill_chunk]`` model pass writes a chunk of
  one request's prompt into its pages (gather the slot's pages to a
  dense row, write the chunk at ``write_pos``, scatter the chunk back)
  and samples the first token on the final chunk. With ``SpecConfig``
  the same chunk also fills the draft model's pages.
* **decode** (``decode_mode="paged"``): one ``[S, 1]`` tick over all
  slots through ``generation.decode_step_body``, attending in place over
  the page pool: the model gets a ``PagedView``, new K/V lands through
  per-page writes (free and mid-prefill rows write nothing), and
  attention runs the paged-attention kernel, once per layer. An int8
  pool (``kv_cache_quantize="int8"``) attends on the ``gather`` path
  instead: the kernel takes fp pools only. ``decode_mode="dense"`` keeps
  the dense-gather tick as the A/B baseline.
* **speculative** (``SpecConfig``): the tick becomes k single-token
  draft steps over a dense, bucket-sliced view of the draft's own pool,
  one feed that caches the last proposal, and one ``[S, k + 1]`` target
  verify in place over the target pool (the paged kernel at W = k + 1,
  once per layer). Greedy rows accept the target's own argmax prefix
  plus its correction, so their streams are the target's greedy
  ``generate``; sampled rows take ``speculative_accept``'s rejection
  rule with the slot's own generator. Rewind is free: rejected drafts
  sit at positions >= the accepted length, where the next tick writes
  before anything attends them.
* **length buckets**: the page-table width handed to the kernel (and
  the dense prefill row and draft view) rounds up to the live maximum's
  power-of-two page bucket instead of always ``max_len``.

Fleet roles (``EngineConfig.role``): ``"solo"`` serves requests end to
end; ``"prefill"`` fills pages, samples the first token and parks a
``MigrationFrame`` in ``outbox``; ``"decode"`` takes work only through
``inject_migration``. A ``prefix_store`` shares full prompt pages across
engines, so a fleet prefills a shared prompt once.

Per-slot decode state (tokens, lengths, sampling params, page tables)
lives on the device and changes only at request transitions; the tick
advances the decoding rows in place, so a steady-state tick uploads
nothing and fetches the sampled tokens once. Each request samples with
its own ``torch.Generator`` seeded from ``Request.seed``, so a completed
non-speculative stream equals the solo ``generate`` call with
``generator=torch.Generator(device).manual_seed(seed)``, migrated or not.

Failure model (degrade, don't crash): the ``serve.prefill``,
``serve.decode`` and ``serve.kv_migrate`` fault sites fire per request;
a poisoned request is evicted as FAILED, its slot and page references
released, and the engine keeps serving.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, List, Optional, Tuple

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
from pytorch_distributed_tpu_torch.serve.disagg import (
    MigrationError,
    MigrationFrame,
    request_from_wire,
    request_to_wire,
)
from pytorch_distributed_tpu_torch.serve.kv_slots import (
    PagedKVPool,
    extract_frames,
    frame_nbytes,
    frame_signature,
    gather_pages,
    scatter_kv,
    splice_frames,
)
from pytorch_distributed_tpu_torch.serve.sampling import (
    TOP_K_OFF,
    TOP_P_OFF,
    filter_logits_rows,
    sample_logits_rows,
)
from pytorch_distributed_tpu_torch.serve.scheduler import (
    Request,
    RequestHandle,
    RequestStatus,
    Scheduler,
)
from pytorch_distributed_tpu_torch.serve.telemetry import ServeTelemetry
from pytorch_distributed_tpu_torch.speculative import speculative_accept
from pytorch_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Opt-in speculative decoding for the engine tick.

    ``draft_model`` shares the target's vocabulary, device and decode
    contract; ``num_draft_tokens`` (k) is the proposal width: every tick
    drafts k tokens and verifies them in one ``[S, k + 1]`` target pass,
    emitting 1 to k + 1 tokens per decoding request. The paged kernel
    takes G * (k + 1) <= 64 query rows per kv head (G = query heads per
    kv head), so Llama-3 (G = 4) takes k <= 15 on the card, Qwen2-7B
    (G = 7) k <= 8 and Gemma-2B (G = 8, one kv head) k <= 7.
    """

    draft_model: Any
    num_draft_tokens: int = 4

    def __post_init__(self):
        if self.num_draft_tokens < 1:
            raise ValueError(
                f"num_draft_tokens must be >= 1, got {self.num_draft_tokens}"
            )


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
    # "solo" serves requests end to end; "prefill" fills pages and ships
    # MigrationFrames through ``outbox``; "decode" takes work through
    # ``inject_migration`` only
    role: str = "solo"
    # fleet label: stamps telemetry records and migration frames
    engine_id: Optional[str] = None
    # synthetic compute a disaggregated tier can overlap: a prefill chunk
    # sleeps prefill_delay_s * chunk_len, a decode tick decode_delay_s *
    # active rows. Sleeps never touch the math.
    prefill_delay_s: float = 0.0
    decode_delay_s: float = 0.0

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
        if self.prefill_delay_s < 0 or self.decode_delay_s < 0:
            raise ValueError(
                "prefill_delay_s / decode_delay_s must be >= 0, got "
                f"{self.prefill_delay_s} / {self.decode_delay_s}"
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
    deadline sweep -> cancellations -> migrated intake -> prefix-store
    adoption -> admission -> prefill chunks -> decode tick), or
    ``run_until_drained()``. Tokens stream into each
    ``RequestHandle.tokens`` as they are emitted.

    ``device`` defaults to the CUDA card and must hold ``model`` (and the
    draft); the CPU runs the plain PyTorch path only when asked for by
    name.
    """

    def __init__(
        self,
        model,
        config: EngineConfig = EngineConfig(),
        *,
        device: DeviceLike = None,
        spec: Optional[SpecConfig] = None,
        telemetry: Optional[ServeTelemetry] = None,
        prefix_store=None,
        clock=time.monotonic,
    ):
        device = resolve_device(device)
        for what, m in (("model", model),
                        ("draft model", spec and spec.draft_model)):
            if m is not None and m.device != device:
                raise ValueError(
                    f"the {what} lives on {m.device}, the engine was "
                    f"asked for {device}"
                )
        if config.role != "solo" and spec is not None:
            raise ValueError(
                f"role={config.role!r} requires spec=None: speculative "
                "decoding is solo-engine only (the draft cache does not "
                "ride the migration frame)"
            )
        if prefix_store is not None and spec is not None:
            raise ValueError(
                "prefix_store requires spec=None: store adoption splices "
                "target pages only, and a draft pool sharing the slot "
                "would miss the prefix"
            )
        self.model = model
        self.config = config
        self.device = device
        self.spec = spec
        self.role = config.role
        self.engine_id = config.engine_id
        self.telemetry = telemetry or ServeTelemetry(
            clock=clock, engine_id=config.engine_id
        )
        if self.telemetry.engine_id is None and config.engine_id:
            self.telemetry.engine_id = config.engine_id
        self._clock = clock
        for what, m in (("model's", model),
                        ("DRAFT model's", spec and spec.draft_model)):
            limit = model_max_len(m) if m is not None else None
            if limit is not None and config.max_len > limit:
                raise ValueError(
                    f"max_len {config.max_len} exceeds the {what} maximum "
                    f"sequence length {limit}"
                )
        self._vocab = model.config.vocab_size
        with torch.no_grad():
            self.pool = PagedKVPool(
                model, config.num_slots, config.max_len,
                page_size=config.page_size, num_pages=config.num_pages,
                prefix_cache=config.prefix_cache,
            )
            self.draft_pool = None
            self._spec_tail = 0
            if spec is not None:
                # the draft shares the target's page geometry, so one
                # chunk stream and one joint prefix skip drive both
                self.draft_pool = PagedKVPool(
                    spec.draft_model, config.num_slots, config.max_len,
                    page_size=self.pool.page_size,
                    num_pages=config.num_pages,
                    prefix_cache=config.prefix_cache,
                )
                # the verify writes up to k rejected drafts past the
                # emitted horizon: reserved at admission
                self._spec_tail = spec.num_draft_tokens
        self.scheduler = Scheduler(config.num_slots, config.prefill_chunk)
        # -- fleet state ---------------------------------------------------
        #: commits the pool's frame layout; every migration frame and
        #: store access is checked against it
        self.migration_signature = frame_signature(
            self.pool.cache, self.pool.page_size
        )
        #: prefill role: packed frames awaiting the router's pick-up
        self.outbox: Deque[MigrationFrame] = deque()
        #: decode/solo role: injected handles awaiting slot capacity
        self._inject_backlog: Deque[RequestHandle] = deque()
        self._store = prefix_store
        if prefix_store is not None:
            sig = getattr(prefix_store, "signature", None)
            if sig is None:
                prefix_store.signature = self.migration_signature
            elif sig != self.migration_signature:
                raise ValueError(
                    "prefix-store geometry mismatch at attach: store "
                    f"holds {sig!r}, this engine's pool is "
                    f"{self.migration_signature!r}"
                )
        self._holder = config.engine_id or f"engine-{id(self):x}"
        self.migrated_out = 0          # frames shipped (prefill role)
        self.migrated_in = 0           # frames spliced (decode/solo)
        self.store_published_pages = 0
        self.store_adopted_pages = 0
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
        self._dpt = (torch.zeros((S, mp), dtype=torch.int32, **dev)
                     if spec is not None else None)
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
        #: ticks and prefill chunks run at each bucket width (pages)
        self.decode_bucket_ticks: dict = {}
        self.prefill_bucket_chunks: dict = {}
        # analytic HBM accounting for the decode path, host-side ints,
        # priced at what runs: the dense tick and an int8 pool's paged
        # tick gather a dense slab; the kernel reads each page once
        quantized = getattr(model.config, "kv_cache_quantize", None)
        self._attn_impl = (
            "dense" if config.decode_mode == "dense"
            else "gather" if quantized is not None else "kernel"
        )
        self._frame_bytes_target = frame_nbytes(self.pool.cache)
        self._frame_bytes_draft = (
            frame_nbytes(self.draft_pool.cache)
            if self.draft_pool is not None else 0
        )
        self.decode_gather_bytes = 0   # dense-intermediate traffic only
        self.decode_hbm_bytes = 0      # gather + attention-stream reads
        self._decode_tokens = 0
        # speculative bookkeeping (per-verify acceptance; host ints)
        self.spec_verifies = 0
        self.spec_drafted = 0
        self.spec_accepted = 0

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
        every ACTIVE row's reads and its write span (1, or k + 1 under
        speculation). Inactive rows may point beyond it; their reads are
        discarded and their writes dropped."""
        if self.config.decode_mode == "dense":
            return self.pool.max_pages
        W = 1 if self.spec is None else self.spec.num_draft_tokens + 1
        need = max(int(self.pool.lengths[slot]) for slot, _ in decoding) + W
        return self._bucket_for(-(-need // self.pool.page_size))

    def _tick_cost(self, n_pages: int) -> Tuple[int, int]:
        """(gather_bytes, total_hbm_bytes) one decode tick moves: a gather
        reads and writes a dense copy before attention reads it; the
        kernel reads each page once. The speculative draft gathers its
        bucket and re-reads it for k proposals and the fill feed."""
        S = self.config.num_slots
        fb = self._frame_bytes_target
        attn = S * n_pages * fb
        gather = 2 * attn if self._attn_impl in ("dense", "gather") else 0
        if self.spec is not None:
            dfb = S * n_pages * self._frame_bytes_draft
            gather += 2 * dfb
            attn += (self.spec.num_draft_tokens + 2) * dfb
        return gather, gather + attn

    @property
    def decode_ticks(self) -> int:
        return self._decode_ticks

    @property
    def decode_buckets(self):
        """Bucket widths (pages) the decode tick has run at."""
        return set(self.decode_bucket_ticks)

    @property
    def prefill_buckets(self):
        return set(self.prefill_bucket_chunks)

    @property
    def decode_hbm_bytes_per_token(self) -> float:
        return self.decode_hbm_bytes / max(self._decode_tokens, 1)

    def precompile_decode_buckets(self) -> None:
        """Run one idle tick at every bucket width, so that nothing (a
        cuBLAS plan, an allocator block, the kernel's library) is used
        for the first time inside a timed run.

        Every row rides as INACTIVE: pool writes are dropped, token and
        length rows pass through unchanged, and no generator draws. The
        tick and byte counters are left alone (nothing was served)."""
        idle = torch.zeros(self.config.num_slots, dtype=torch.bool,
                           device=self.device)
        for n in self._buckets:
            if self.spec is None:
                self._decode_tick(n, idle, [])
            else:
                self._spec_tick(n, idle, [])

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
        if P + request.max_new_tokens + self._spec_tail > cfg.max_len:
            tail = (f" + {self._spec_tail} speculative-verify slots"
                    if self._spec_tail else "")
            raise ValueError(
                f"prompt ({P}) + max_new_tokens ({request.max_new_tokens})"
                f"{tail} exceeds the engine's max_len {cfg.max_len}"
            )

    def submit(self, request: Request) -> RequestHandle:
        """Validate + enqueue; returns the streaming handle."""
        if self.role == "decode":
            raise RuntimeError(
                "decode-tier engines take work via inject_migration() "
                "only: route submissions to a prefill or solo engine"
            )
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

    # -- migration intake (decode/solo roles) ------------------------------
    def inject_migration(
        self, frame: MigrationFrame, submitted_at: Optional[float] = None,
    ) -> RequestHandle:
        """Adopt a prefill-tier frame: check it against this pool's
        signature, rebuild the ``Request``, and queue it for
        direct-to-DECODING admission at the next ``step()``.
        ``submitted_at`` (the router's original submit time) keeps TTFT
        honest across the hand-off."""
        if self.role == "prefill":
            raise RuntimeError(
                "prefill-tier engines ship frames via outbox; they do not "
                "accept them"
            )
        if frame.signature != self.migration_signature:
            raise MigrationError(
                "migration frame geometry mismatch: this pool is "
                f"{self.migration_signature!r}, frame declares "
                f"{frame.signature!r}: refusing the splice"
            )
        req = request_from_wire(frame.request)
        self._validate_request(req)
        if frame.prompt_len != req.prompt_len:
            raise MigrationError(
                f"frame prompt_len {frame.prompt_len} disagrees with its "
                f"own request ({req.prompt_len} tokens)"
            )
        want_pages = -(-frame.prompt_len // self.pool.page_size)
        if frame.n_pages != want_pages:
            raise MigrationError(
                f"frame ships {frame.n_pages} pages but a "
                f"{frame.prompt_len}-token prompt spans {want_pages} at "
                f"page_size {self.pool.page_size}"
            )
        h = RequestHandle(
            req,
            submitted_at=(self._clock() if submitted_at is None
                          else submitted_at),
        )
        if req.deadline_s is not None:
            self._n_deadlines += 1
        h._mig_frame = frame
        self._inject_backlog.append(h)
        self.telemetry.record_submit(h)
        return h

    def _admit_injected(self, h: RequestHandle) -> bool:
        """Bind an injected handle to a slot: allocate the span the solo
        path would, splice the frame's page bytes in, and write the
        decode row the prefill tier's final chunk left. Returns False
        when no slot or pages fit yet (strict FIFO over the backlog)."""
        frame: MigrationFrame = h._mig_frame
        req = h.request
        # keys=[]: the arriving pages are private splices, neither shared
        # from nor registered in this pool's prefix registry
        lease = self.pool.allocate(
            req.prompt_ids, max_new=req.max_new_tokens,
            chunk=self.config.prefill_chunk, tail=self._spec_tail, keys=[],
        )
        if lease is None:
            return False
        self.scheduler.adopt(h, lease)
        slot = lease.slot
        span = (
            tracing._NULL_SPAN if tracing._tracer is None
            else tracing.span(
                "serve.migrate_in", request=req.request_id,
                pages=int(frame.n_pages), nbytes=frame.payload_nbytes,
            )
        )
        with span:
            splice_frames(self.pool.cache, lease.page_row[:frame.n_pages],
                          frame.payload)
        self.pool.lengths[slot] = frame.prompt_len
        self._set_sampling_row(slot, req)
        self._lengths[slot] = frame.prompt_len
        self._toks[slot] = int(frame.first_token)
        self._pt[slot] = torch.from_numpy(lease.page_row).to(self.device)
        gen = self._gens[slot]
        if gen is not None:
            # the prefill tier's final chunk drew the first token's noise
            # from a generator seeded the same way: replay that one draw,
            # so the next draw is the solo engine's
            gumbel_noise((1, self._vocab), gen, self.device)
        self._decoding_dirty = True
        self.migrated_in += 1
        h._mig_frame = None
        self._emit(h, int(frame.first_token))
        return True

    def _drain_inject_backlog(self) -> None:
        now = self._clock()
        while self._inject_backlog:
            h = self._inject_backlog[0]
            if h.done:  # cancelled/expired while waiting
                self._inject_backlog.popleft()
                continue
            if h.deadline_at is not None and now >= h.deadline_at:
                self._inject_backlog.popleft()
                self._finish(h, RequestStatus.EXPIRED)
                continue
            if not self._admit_injected(h):
                break
            self._inject_backlog.popleft()

    # -- the loop ----------------------------------------------------------
    def has_work(self) -> bool:
        return bool(
            self.scheduler.queue or self.scheduler.by_slot
            or self._inject_backlog
        )

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
        if self._inject_backlog:
            self._drain_inject_backlog()
        if self._store is not None and self.scheduler.queue:
            self._adopt_from_store()
        for h in self.scheduler.admit(
            self.pool, self.draft_pool, tail=self._spec_tail
        ):
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
        gauges = dict(
            pages_in_use=pool.pages_in_use,
            pages_total=pool.num_pages,
            page_occupancy=occupancy,
            prefix_hit_rate=pool.prefix_hit_rate,
            decode_gather_bytes=self.decode_gather_bytes,
            decode_hbm_bytes_per_token=round(
                self.decode_hbm_bytes_per_token, 1
            ),
        )
        if self.spec is not None:
            gauges.update(
                spec_verifies=self.spec_verifies,
                spec_drafted=self.spec_drafted,
                spec_accepted=self.spec_accepted,
            )
        self.telemetry.record_snapshot(
            queue_depth=self.scheduler.queue_depth(),
            slots_occupied=pool.num_occupied,
            slots_total=pool.num_slots,
            decode_ticks=self._decode_ticks,
            **gauges,
        )
        if tracing._tracer is not None:
            tracing.counter("serve.kv_pages_in_use", pool.pages_in_use)
            tracing.counter("serve.kv_page_occupancy", occupancy)
            tracing.counter("serve.prefix_hit_rate", pool.prefix_hit_rate)
            tracing.counter(
                "serve.decode_hbm_bytes_per_token",
                self.decode_hbm_bytes_per_token,
            )
            if self.spec is not None and self.spec_verifies:
                tracing.counter(
                    "serve.spec_accepted_per_verify",
                    self.spec_accepted / self.spec_verifies,
                )

    # -- cross-engine prefix store -----------------------------------------
    def _adopt_from_store(self) -> None:
        """Walk each queued request's chain keys: pages the fleet already
        prefilled (a store hit) that this pool lacks are claimed
        (``adopt_page``) and spliced in, so the normal ``allocate`` then
        shares them. Stops at the first miss; a page that cannot be
        claimed is a skipped optimization, never an error. A handle is
        walked again only when the store has grown since its last walk."""
        pool = self.pool
        if not pool.prefix_cache:
            return
        version = getattr(self._store, "puts", None)
        for h in self.scheduler.queue:
            if getattr(h, "_store_walked", None) == version:
                continue
            h._store_walked = version
            req = h.request
            if h._chain_keys is None:
                h._chain_keys = pool.chain_keys(req.prompt_ids)
            cap = (req.prompt_len - 1) // pool.page_size
            for key in h._chain_keys[:cap]:
                if key in pool._registry:
                    continue
                payload = self._store.get(
                    key, holder=self._holder,
                    signature=self.migration_signature,
                )
                if payload is None:
                    break
                pg = pool.adopt_page(key)
                if pg is None:
                    break
                splice_frames(pool.cache, [pg], payload)
                self.store_adopted_pages += 1

    def _publish_prefixes(self, h: RequestHandle) -> None:
        """Push the finished prompt's full pages the store lacks (first
        writer wins)."""
        lease = h._lease
        row = self.pool.page_tables[lease.slot]
        for i, key in enumerate(lease.page_keys):
            if key in self._store:
                continue
            payload = extract_frames(self.pool.cache, [row[i]])
            if self._store.put(
                key, payload, holder=self._holder,
                signature=self.migration_signature,
            ):
                self.store_published_pages += 1

    # -- migration packing (prefill role) ----------------------------------
    def _pack_migration(self, h: RequestHandle, first_token: int):
        """Freeze a finished prefill into a MigrationFrame, before
        ``_finish`` releases the slot. Ships ``ceil(P / page_size)``
        pages: every position < P lives there."""
        req = h.request
        n = -(-req.prompt_len // self.pool.page_size)
        pages = self.pool.page_tables[h._lease.slot][:n]
        return MigrationFrame(
            request=request_to_wire(req),
            first_token=int(first_token),
            prompt_len=req.prompt_len,
            n_pages=n,
            signature=self.migration_signature,
            payload=extract_frames(self.pool.cache, pages),
            src_engine=self.engine_id or "",
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
            self.prefill_bucket_chunks[n_pages] = (
                self.prefill_bucket_chunks.get(n_pages, 0) + 1
            )
            with tracing.span(
                "serve.prefill_chunk", request=h.request.request_id
            ):
                tok = self._prefill_chunk(ids, h.slot, plan, n_pages)
            self.pool.lengths[h.slot] = plan.start + plan.chunk_len
            if self.draft_pool is not None:
                self.draft_pool.lengths[h.slot] = plan.start + plan.chunk_len
            if cfg.prefill_delay_s:
                time.sleep(cfg.prefill_delay_s * plan.chunk_len)
            did = True
            if not plan.final:
                continue
            # the slot's full prompt pages now hold canonical KV
            self.pool.register_prefix(h._lease, h.request.prompt_ids)
            if self.draft_pool is not None:
                self.draft_pool.register_prefix(h._dlease,
                                                h.request.prompt_ids)
            if self._store is not None:
                self._publish_prefixes(h)
            if self.role == "prefill":
                # tier hand-off: pack the prompt's pages and the first
                # token, park the frame for the router, retire here as
                # MIGRATED (the request continues on a decode peer)
                try:
                    if faults.active():
                        faults.check("serve.kv_migrate",
                                     path=h.request.request_id)
                    frame = self._pack_migration(h, tok)
                except faults.InjectedFault as e:
                    self._finish(h, RequestStatus.FAILED, error=e)
                    continue
                self.outbox.append(frame)
                self.migrated_out += 1
                self._finish(h, RequestStatus.MIGRATED)
                continue
            self.scheduler.prefill_finished(h)
            self._decoding_dirty = True
            self._emit(h, tok)
        return did

    def _chunk_through(self, model, cache, pt, ids, slot, plan, n_pages):
        """One model's chunk over its pool: gather the slot's bucket of
        pages to a dense row, write the ``[1, C]`` chunk at
        ``plan.start``, scatter the chunk's positions back. Returns the
        chunk's logits."""
        C = self.config.prefill_chunk
        dev = self.device
        row_pt = pt[slot:slot + 1, :n_pages]
        positions = plan.start + torch.arange(C, device=dev)[None]
        dense = gather_pages(cache, row_pt)
        logits, dense = model(
            ids, positions, cache=dense,
            write_pos=torch.full((1,), plan.start, dtype=torch.int32,
                                 device=dev),
            decode=True, cache_len=n_pages * self.pool.page_size,
        )
        scatter_kv(cache, dense, row_pt, positions,
                   torch.ones((1, C), dtype=torch.bool, device=dev))
        return logits

    @torch.no_grad()
    def _prefill_chunk(self, ids, slot, plan, n_pages) -> Optional[int]:
        """One chunk through the model (and the draft) over the slot's
        bucket of pages; on the final chunk, samples and returns the
        first token."""
        ids = torch.from_numpy(ids).to(self.device)
        logits = self._chunk_through(self.model, self.pool.cache, self._pt,
                                     ids, slot, plan, n_pages)
        if self.spec is not None:
            self._chunk_through(self.spec.draft_model, self.draft_pool.cache,
                                self._dpt, ids, slot, plan, n_pages)
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
            else gumbel_noise(last.shape, gen, self.device)
        )
        tok = sample_logits_rows(
            last, noise, self._temps[s], self._top_ks[s], self._top_ps[s]
        )
        self._toks[s] = tok
        return int(tok)

    def _refresh_decoding(self) -> None:
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

    def _run_decode(self) -> bool:
        if self._decoding_dirty:
            self._refresh_decoding()
        decoding = self._decoding_cached
        if not decoding:
            return False
        self._decode_ticks += 1
        n_pages = self._tick_bucket(decoding)
        self.decode_bucket_ticks[n_pages] = (
            self.decode_bucket_ticks.get(n_pages, 0) + 1
        )
        if self.spec is not None:
            return self._run_spec_tick(decoding, n_pages)
        span = (
            tracing._NULL_SPAN if tracing._tracer is None
            else tracing.span("serve.decode_tick", active=len(decoding))
        )
        with span:
            nxt = self._decode_tick(n_pages, self._active_cached,
                                    self._sampling_slots)
        gb, hb = self._tick_cost(n_pages)
        self.decode_gather_bytes += gb
        self.decode_hbm_bytes += hb
        self._decode_tokens += len(decoding)
        if self.config.decode_delay_s:
            time.sleep(self.config.decode_delay_s * len(decoding))
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

    def _row_noise(self, logits, sampling_slots) -> torch.Tensor:
        """Gumbel noise [S, V]: each sampling slot's row drawn from its
        own generator, zeros elsewhere."""
        noise = torch.zeros_like(logits, dtype=torch.float32)
        for slot in sampling_slots:
            noise[slot] = gumbel_noise(
                (1, logits.shape[-1]), self._gens[slot], self.device
            )[0]
        return noise

    @torch.no_grad()
    def _decode_tick(self, n_pages: int, active, sampling_slots
                     ) -> torch.Tensor:
        """One ``[S, 1]`` decode step over every slot; advances the
        active rows' token/length state in place and returns the sampled
        tokens [S]."""
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
        if sampling_slots:
            nxt = sample_logits_rows(
                last, self._row_noise(last, sampling_slots), self._temps,
                self._top_ks, self._top_ps,
            )
        else:
            # all-greedy tick: the rows version's greedy lane, without
            # the vocab sort the filters need
            nxt = torch.argmax(last, dim=-1)
        self._toks = torch.where(active, nxt, self._toks)
        self._lengths += active.to(torch.int32)
        return nxt

    @torch.no_grad()
    def _spec_tick(self, n_pages: int, active, sampling_slots
                   ) -> torch.Tensor:
        """The speculative tick: k draft proposals over the draft pool's
        dense bucket view, a fill feed, one ``[S, k + 1]`` target verify
        over the target pool, per-row acceptance. Advances the active
        rows' state in place; returns ``[S, k + 2]``: the k + 1 emit
        columns (the first a + 1 real) and the accepted count a."""
        k = self.spec.num_draft_tokens
        draft = self.spec.draft_model
        S = self.config.num_slots
        dev = self.device
        ps = self.pool.page_size
        width = n_pages * ps
        toks = self._toks
        # active rows sit below width - k (the bucket covers their k + 1
        # writes); stale rows of free or mid-prefill slots are clamped
        # into the position tables: their outputs are discarded and
        # their writes dropped
        lengths = self._lengths.clamp(max=width - k - 1)
        temps, top_ks, top_ps = self._temps, self._top_ks, self._top_ps
        greedy_row = temps <= 0
        dpt = self._dpt[:, :n_pages]
        dense_d = gather_pages(self.draft_pool.cache, dpt)
        tok, drafts, q_probs = toks, [], []
        for j in range(k):
            logits, dense_d = decode_step_body(
                draft, dense_d, tok, cache_len=width,
                positions=(lengths + j)[:, None], write_pos=lengths + j,
            )
            tok = torch.argmax(logits, dim=-1)
            if sampling_slots:
                filt = filter_logits_rows(logits, temps, top_ks, top_ps)
                sampled = torch.argmax(
                    filt + self._row_noise(filt, sampling_slots), dim=-1)
                tok = torch.where(greedy_row, tok, sampled)
                q_probs.append(torch.softmax(filt, dim=-1))
            drafts.append(tok)
        # one sampling-free feed caches the LAST proposal's K/V: a fully
        # accepted round advances past position lengths + k, which would
        # otherwise stay a hole the draft attends forever after
        _, dense_d = decode_step_body(
            draft, dense_d, tok, cache_len=width,
            positions=(lengths + k)[:, None], write_pos=lengths + k,
        )
        drafts = torch.stack(drafts, dim=1)                # [S, k]
        idx = torch.arange(k + 1, device=dev)
        pos = lengths[:, None] + idx                       # [S, k + 1]
        keep = active[:, None].expand(S, k + 1)
        scatter_kv(self.draft_pool.cache, dense_d, dpt, pos, keep)

        # ---- verify: one target pass scores the proposal ----
        chunk = torch.cat([toks[:, None], drafts], dim=1)
        if self.config.decode_mode == "paged":
            view = PagedView(
                page_tables=self._pt[:, :n_pages].contiguous(),
                keep=active, page_size=ps,
            )
            logits, _ = self.model(
                chunk, pos, cache=self.pool.cache, write_pos=lengths,
                decode=True, cache_len=self.config.max_len, paged=view,
            )
        else:
            dense_t = gather_pages(self.pool.cache, self._pt)
            logits, dense_t = self.model(
                chunk, pos, cache=dense_t, write_pos=lengths, decode=True,
                cache_len=self.config.max_len,
            )
            scatter_kv(self.pool.cache, dense_t, self._pt, pos, keep)

        # ---- acceptance ----
        # greedy: the longest draft prefix matching the target's own
        # argmax chain, then the target's next choice
        preds = torch.argmax(logits, dim=-1)               # [S, k + 1]
        match = (drafts == preds[:, :k]).long()
        a = torch.cumprod(match, dim=1).sum(dim=1)
        corr = torch.gather(preds, 1, a[:, None])[:, 0]
        for slot in sampling_slots:
            # rejection sampling with the row's own filtered target and
            # draft distributions and its own generator
            rows = logits[slot]                            # [k + 1, V]
            p_probs = torch.softmax(filter_logits_rows(
                rows, temps[slot].expand(k + 1),
                top_ks[slot].expand(k + 1), top_ps[slot].expand(k + 1),
            ), dim=-1)
            qs = torch.stack([q[slot] for q in q_probs])   # [k, V]
            a_s, c_s = speculative_accept(
                p_probs[None], qs[None], drafts[slot:slot + 1],
                self._gens[slot],
            )
            a[slot], corr[slot] = a_s[0], c_s[0]
        drafts_ext = torch.cat(
            [drafts, torch.zeros_like(drafts[:, :1])], dim=1)
        emit = torch.where(idx < a[:, None], drafts_ext, corr[:, None])
        # the correction is the round's last emitted token: next tick's
        # input, its KV written by next tick's chunk at the new length
        self._toks = torch.where(active, corr, toks)
        self._lengths = self._lengths + torch.where(
            active, a + 1, torch.zeros_like(a)).to(torch.int32)
        # the accepted count rides as one extra column: one fetch a tick
        return torch.cat([emit, a[:, None]], dim=1)

    def _run_spec_tick(self, decoding, n_pages) -> bool:
        """One draft + verify tick; emits 1..k+1 tokens per request."""
        span = (
            tracing._NULL_SPAN if tracing._tracer is None
            else tracing.span("serve.spec_tick", active=len(decoding),
                              k=self.spec.num_draft_tokens)
        )
        with span:
            emit_acc = self._spec_tick(n_pages, self._active_cached,
                                       self._sampling_slots)
        gb, hb = self._tick_cost(n_pages)
        self.decode_gather_bytes += gb
        self.decode_hbm_bytes += hb
        if self.config.decode_delay_s:
            time.sleep(self.config.decode_delay_s * len(decoding))
        with tracing.span("serve.token_fetch"):
            emit_acc = emit_acc.cpu().numpy()
        emit, acc = emit_acc[:, :-1], emit_acc[:, -1]
        k = self.spec.num_draft_tokens
        self.spec_verifies += 1
        fault_armed = faults.active()
        for slot, h in decoding:
            n = int(acc[slot]) + 1
            self._decode_tokens += n
            # the verify wrote k + 1 entries, a + 1 became sequence; the
            # rejected tail lies past the length, where the next tick's
            # chunk lands before anything attends it
            self.pool.lengths[slot] += n
            self.draft_pool.lengths[slot] += n
            self.spec_drafted += k
            self.spec_accepted += n - 1
            if fault_armed:
                try:
                    faults.check("serve.decode", path=h.request.request_id)
                except faults.InjectedFault as e:
                    self._finish(h, RequestStatus.FAILED, error=e)
                    continue
            for j in range(n):
                self._emit(h, int(emit[slot, j]))
                if h.done:  # eos / max_new truncation retires the row
                    break
        return True

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
            self.scheduler.release(h, self.pool, self.draft_pool)
        self.telemetry.record_done(h)
        if status is RequestStatus.FAILED:
            logger.warning(
                "serve: evicted request %s after fault: %s",
                h.request.request_id, error,
            )

    # -- admission-time slot setup ----------------------------------------
    def _set_sampling_row(self, slot: int, req: Request) -> None:
        self._temps[slot] = req.temperature
        self._top_ks[slot] = TOP_K_OFF if req.top_k is None else req.top_k
        self._top_ps[slot] = TOP_P_OFF if req.top_p is None else req.top_p
        self._gens[slot] = (
            torch.Generator(device=self.device).manual_seed(req.seed)
            if req.temperature > 0 else None
        )

    def _configure_slot(self, h: RequestHandle) -> None:
        slot = h.slot
        lease = h._lease
        self._set_sampling_row(slot, h.request)
        # the write cursor parks at `skip`, the first position the
        # request's own prefill writes; everything before is shared
        # read-only prefix pages
        self._lengths[slot] = lease.skip
        self._pt[slot] = torch.from_numpy(lease.page_row).to(self.device)
        if self._dpt is not None:
            self._dpt[slot] = torch.from_numpy(
                h._dlease.page_row).to(self.device)
