"""Deterministic telemetry-driven admission over a fleet of engines;
the port of ``pytorch_distributed_tpu/serve/router.py``.

The router owns a fleet of ``ServeEngine``s: N solo engines (load
balancing only), or a prefill tier and a decode tier (prefill engines
fill pages and pack ``MigrationFrame``s; the router ships each frame to
a decode engine, which owns the tick from the first token on). One
router, one thread, one clock: every engine is stepped in sorted
engine-id order inside ``Router.step()``.

**Admission is deterministic.** The router routes on a ``GaugeBoard``
fed only by the engines' own telemetry records (a ``_BoardWriter`` tee
wraps each engine's writer, so the records a run logs are the ones that
route it). The pick is ``min`` over ``(outstanding, occupancy,
TTFT-EWMA, engine_id)``: a pure function of the record stream, so a
replayed storm routes identically, request for request.

**Engine loss is evict-and-replay.** The ``serve.engine_loss`` fault
site is checked once per live engine per step (``path`` = the engine
id). A lost engine takes its queue, slots, outbox and pages with it;
the router submits every request it owned again, from scratch, on a
surviving peer: same ``Request``, same seed, so the final stream equals
the no-fault run's. The partial stream restarts (at-least-once
emission). The victim's prefix-store pins are released by the router.

Limits: one router drives the fleet from one thread; the occupancy
gauge is as stale as the engines' ``telemetry_every`` snapshots
(staleness skews balance, never correctness); a replay re-anchors the
request's deadline at the new submit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from pytorch_distributed_tpu_torch.runtime import faults, flightrec
from pytorch_distributed_tpu_torch.serve.disagg import roundtrip_frame
from pytorch_distributed_tpu_torch.serve.scheduler import (
    Request,
    RequestStatus,
)
from pytorch_distributed_tpu_torch.serve.telemetry import ServeTelemetry
from pytorch_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

#: statuses a ROUTER-level request can still make progress from —
#: MIGRATED is terminal for a prefill ENGINE but in-flight for the
#: fleet (its frame is in an outbox or already on a decode peer)
_ROUTER_LIVE = (
    RequestStatus.QUEUED, RequestStatus.PREFILLING,
    RequestStatus.DECODING, RequestStatus.MIGRATED,
)


class GaugeBoard:
    """Latest per-engine routing inputs, folded from telemetry records.

    ``outstanding`` counts requests the router placed on an engine that
    have not yet produced a terminal ``event="request"`` record (the
    router increments at placement; the engine's own stream decrements
    — the board never reaches into engine state). ``ttft_ewma_ms`` and
    ``slot_occupancy`` fold the request/snapshot records as they flow.
    """

    def __init__(self, ema: float = 0.3):
        if not 0.0 < ema <= 1.0:
            raise ValueError(f"ema must be in (0, 1], got {ema}")
        self.ema = ema
        self._state: Dict[str, Dict[str, float]] = {}

    def _ensure(self, engine_id: str) -> Dict[str, float]:
        st = self._state.get(engine_id)
        if st is None:
            st = {
                "outstanding": 0, "ttft_ewma_ms": 0.0,
                "slot_occupancy": 0.0, "done": 0,
            }
            self._state[engine_id] = st
        return st

    def note_routed(self, engine_id: str) -> None:
        self._ensure(engine_id)["outstanding"] += 1

    def drop_engine(self, engine_id: str) -> None:
        self._state.pop(engine_id, None)

    def ingest(self, engine_id: str, metrics: Dict) -> None:
        st = self._ensure(engine_id)
        event = metrics.get("event")
        if event == "request":
            st["outstanding"] = max(0, st["outstanding"] - 1)
            st["done"] += 1
            ttft = metrics.get("ttft_ms")
            if ttft is not None:
                st["ttft_ewma_ms"] = (
                    ttft if st["done"] == 1 else
                    (1 - self.ema) * st["ttft_ewma_ms"]
                    + self.ema * ttft
                )
        elif event == "snapshot":
            occ = metrics.get("slot_occupancy")
            if occ is not None:
                st["slot_occupancy"] = float(occ)

    def rank(self, engine_id: str):
        """Total-order routing key: least-loaded first, engine id as
        the deterministic tiebreak."""
        st = self._ensure(engine_id)
        return (
            st["outstanding"], st["slot_occupancy"],
            st["ttft_ewma_ms"], engine_id,
        )

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {eid: dict(st) for eid, st in sorted(self._state.items())}

    def reset(self) -> None:
        self._state.clear()


class _BoardWriter:
    """MetricsWriter tee: every record an engine's telemetry writes is
    folded into the router's board AND forwarded to the engine's
    original writer (when one was wired) — one stream, two readers."""

    def __init__(self, board: GaugeBoard, engine_id: str, inner=None):
        self.board = board
        self.engine_id = engine_id
        self.inner = inner

    def write(self, step, metrics, split="train"):
        if split == "serve":
            self.board.ingest(self.engine_id, metrics)
        if self.inner is not None:
            self.inner.write(step, metrics, split=split)


class RouterHandle:
    """Fleet-level view of one request: delegates to whichever engine
    handle currently drives it (rebound at migration and at replay).
    ``tokens``/``status`` always reflect the CURRENT owner — after a
    replay the partial stream restarts (at-least-once emission), and
    the final stream matches the no-fault run bit for bit."""

    def __init__(self, request: Request, handle, engine_id: str):
        self.request = request
        self.current = handle
        self.engine_id = engine_id
        self.submitted_at = handle.submitted_at
        self.replays = 0

    @property
    def request_id(self) -> str:
        return self.request.request_id

    @property
    def tokens(self) -> List[int]:
        return self.current.tokens

    @property
    def status(self) -> RequestStatus:
        return self.current.status

    @property
    def error(self):
        return self.current.error

    @property
    def first_token_at(self):
        return self.current.first_token_at

    @property
    def done(self) -> bool:
        return self.current.status not in _ROUTER_LIVE

    def __repr__(self):  # pragma: no cover - debugging nicety
        return (
            f"RouterHandle({self.request_id}, {self.status.value}, "
            f"on={self.engine_id}, replays={self.replays})"
        )


class Router:
    """One deterministic admission/migration/loss loop over a fleet.

    Two fleet shapes:

    * ``Router(engines=[...])`` — N solo engines; the router only
      balances admissions.
    * ``Router(prefill=[...], decode=[...])`` — disaggregated tiers;
      the router additionally drains every prefill outbox each step and
      ships each frame (through the FULL wire codec —
      ``roundtrip_frame`` — so in-process fleets pay and account the
      identical framing + fingerprint discipline as cross-process ones)
      to the least-loaded decode engine.

    ``writer`` (any object with ``write(step, metrics, split=...)``,
    optional) receives the router's own records under ``split="serve"``:
    ``event="migrate"`` (src, dst, nbytes per frame) and
    ``event="replay"`` (lost engine, dst). Engine telemetry writers are
    wrapped in place at construction; the engines' own records keep
    flowing to whatever the caller wired.
    """

    def __init__(
        self,
        engines: Optional[Sequence] = None,
        *,
        prefill: Optional[Sequence] = None,
        decode: Optional[Sequence] = None,
        writer=None,
        store=None,
        ema: float = 0.3,
    ):
        if engines is not None and (prefill or decode):
            raise ValueError(
                "pass either engines= (solo fleet) or prefill=/decode= "
                "(disaggregated tiers), not both"
            )
        if engines is None and not (prefill and decode):
            raise ValueError(
                "a disaggregated fleet needs BOTH prefill= and decode= "
                "engines (a tier with nobody on the other side can "
                "never finish a request)"
            )
        self.disagg = engines is None
        self.board = GaugeBoard(ema=ema)
        self.writer = writer
        self._engines: Dict[str, object] = {}
        self._prefill_ids: List[str] = []
        self._decode_ids: List[str] = []
        self._solo_ids: List[str] = []
        if self.disagg:
            self._adopt_fleet(prefill, "prefill", "p", self._prefill_ids)
            self._adopt_fleet(decode, "decode", "d", self._decode_ids)
        else:
            self._adopt_fleet(engines, "solo", "e", self._solo_ids)
        sigs = {
            e.migration_signature for e in self._engines.values()
        }
        if len(sigs) > 1:
            raise ValueError(
                "mixed-geometry fleet: engines disagree on the frame "
                f"signature ({sorted(s[:40] for s in sigs)}...) — every "
                "engine behind one router must share model geometry, "
                "page size, and cache dtype"
            )
        self._store = store
        if self._store is None:
            for e in self._engines.values():
                if getattr(e, "_store", None) is not None:
                    self._store = e._store
                    break
        self._live: Dict[str, RouterHandle] = {}
        self._events = 0
        self.migration_frames = 0
        self.migration_bytes = 0          # full wire bytes
        self.migration_payload_bytes = 0  # KV page bytes only
        self.replays = 0
        self.lost_engines: List[str] = []

    def _adopt_fleet(self, fleet, role, prefix_char, ids) -> None:
        if not fleet:
            if role == "solo":
                raise ValueError("engines= must hold at least one engine")
            return
        for i, e in enumerate(fleet):
            if e.role != role:
                raise ValueError(
                    f"fleet slot {role}[{i}] holds a role={e.role!r} "
                    f"engine — construct it with "
                    f"EngineConfig(role={role!r})"
                )
            eid = e.engine_id or f"{prefix_char}{i}"
            if eid in self._engines:
                raise ValueError(f"duplicate engine_id {eid!r}")
            e.engine_id = eid
            e.telemetry.engine_id = eid
            # tee the engine's telemetry into the board — the routing
            # decision reads the same stream the run's JSONL records
            e.telemetry.writer = _BoardWriter(
                self.board, eid, e.telemetry.writer
            )
            self._engines[eid] = e
            ids.append(eid)

    # -- routing -----------------------------------------------------------
    def _pick(self, ids: Sequence[str]) -> str:
        if not ids:
            raise RuntimeError(
                "no surviving engine to route to — the fleet lost its "
                "last member of a required tier"
            )
        return min(ids, key=self.board.rank)

    def _emit_record(self, metrics: Dict) -> None:
        if self.writer is not None:
            self._events += 1
            self.writer.write(self._events, metrics, split="serve")

    def submit(self, request: Request) -> RouterHandle:
        """Route one request to the least-loaded admitting engine."""
        eid = self._pick(
            self._prefill_ids if self.disagg else self._solo_ids
        )
        h = self._engines[eid].submit(request)
        rh = RouterHandle(request, h, eid)
        self._live[request.request_id] = rh
        self.board.note_routed(eid)
        return rh

    # -- the loop ----------------------------------------------------------
    def step(self) -> bool:
        """One fleet iteration: loss sweep -> step every engine (sorted
        id order) -> drain prefill outboxes onto decode engines.
        Returns True when any engine did device work."""
        if faults.active():
            for eid in sorted(self._engines):
                try:
                    faults.check("serve.engine_loss", path=eid)
                except faults.InjectedFault as e:
                    self._lose_engine(eid, e)
        did = False
        for eid in sorted(self._engines):
            e = self._engines[eid]
            if e.has_work():
                did = e.step() or did
        if self.disagg:
            self._drain_outboxes()
        return did

    def _drain_outboxes(self) -> None:
        for eid in list(self._prefill_ids):
            e = self._engines[eid]
            while e.outbox:
                frame = e.outbox.popleft()
                dst = self._pick(self._decode_ids)
                target = self._engines[dst]
                # full wire codec even in-process: identical framing,
                # fingerprint check, and byte accounting as a ring hop
                wire_frame, nbytes = roundtrip_frame(
                    frame, target.migration_signature
                )
                rh = self._live.get(frame.request_id)
                h = target.inject_migration(
                    wire_frame,
                    submitted_at=(
                        rh.submitted_at if rh is not None else None
                    ),
                )
                self.migration_frames += 1
                self.migration_bytes += nbytes
                self.migration_payload_bytes += frame.payload_nbytes
                if rh is not None:
                    rh.current = h
                    rh.engine_id = dst
                self.board.note_routed(dst)
                self._emit_record({
                    "event": "migrate", "engine_id": eid, "dst": dst,
                    "request_id": frame.request_id,
                    "nbytes": int(nbytes),
                    "payload_nbytes": int(frame.payload_nbytes),
                    "n_pages": int(frame.n_pages),
                })

    # -- engine loss -------------------------------------------------------
    def _lose_engine(self, eid: str, cause: BaseException) -> None:
        """Evict a lost engine and replay every request it owned on a
        surviving peer — from scratch, same Request + seed, so the
        replayed final stream is bit-identical to the no-fault run."""
        flightrec.dump(f"serve engine {eid} lost: {cause!r}")
        self._engines.pop(eid)
        for ids in (self._prefill_ids, self._decode_ids, self._solo_ids):
            if eid in ids:
                ids.remove(eid)
        self.board.drop_engine(eid)
        self.lost_engines.append(eid)
        if self._store is not None:
            # the ROUTER releases the victim's prefix-store pins — the
            # engine is gone and can never do it itself; entries stay
            # resident for the fleet until capacity pressure
            self._store.release_holder(eid)
        victims = [
            rh for _, rh in sorted(self._live.items())
            if rh.engine_id == eid and not rh.done
        ]
        logger.warning(
            "serve.router: engine %s lost (%s) — replaying %d "
            "in-flight request(s) on surviving peers",
            eid, cause, len(victims),
        )
        for rh in victims:
            dst = self._pick(
                self._prefill_ids if self.disagg else self._solo_ids
            )
            h = self._engines[dst].submit(rh.request)
            rh.current = h
            rh.engine_id = dst
            rh.submitted_at = h.submitted_at
            rh.replays += 1
            self.replays += 1
            self.board.note_routed(dst)
            self._emit_record({
                "event": "replay", "engine_id": eid, "dst": dst,
                "request_id": rh.request_id,
            })

    # -- drive surface (duck-compatible with ServeEngine) ------------------
    def has_work(self) -> bool:
        return any(
            e.has_work() or (e.role == "prefill" and e.outbox)
            for e in self._engines.values()
        )

    def run_until_drained(self, max_steps: int = 1_000_000) -> None:
        for _ in range(max_steps):
            if not self.has_work():
                return
            self.step()
        raise RuntimeError(
            f"fleet did not drain within {max_steps} steps"
        )

    def drain(self, max_steps: int = 1_000_000) -> None:
        self.run_until_drained(max_steps)

    # -- warm-up -----------------------------------------------------------
    def warm_up(self, prompt_ids, *, precompile_buckets: bool = True):
        """Run every engine's paths once outside any measured window.

        Solo engines take the standard 2-token warm request; prefill
        engines run one warm prefill to a packed frame, and that SAME
        frame (round-tripped through the codec) warms every decode
        engine's splice, inject and decode tick; ``precompile_buckets``
        then runs an idle tick at every bucket width. Afterwards each
        engine's telemetry is replaced fresh (board included), so
        warm-up TTFTs never reach a reported percentile.
        """
        warm = Request(prompt_ids, max_new_tokens=2, request_id="warmup")
        if self.disagg:
            frame = None
            for eid in self._prefill_ids:
                e = self._engines[eid]
                h = e.submit(Request(
                    prompt_ids, max_new_tokens=2,
                    request_id=f"warmup-{eid}",
                ))
                while e.has_work():
                    e.step()
                if h.status is not RequestStatus.MIGRATED or not e.outbox:
                    raise RuntimeError(
                        f"warm-up prefill on {eid} did not migrate: "
                        f"{h.status.value}"
                    )
                frame = e.outbox.popleft()
            for eid in self._decode_ids:
                e = self._engines[eid]
                wire_frame, _ = roundtrip_frame(
                    frame, e.migration_signature
                )
                h = e.inject_migration(wire_frame)
                while e.has_work():
                    e.step()
                if h.status is not RequestStatus.COMPLETED:
                    raise RuntimeError(
                        f"warm-up decode on {eid} failed: "
                        f"{h.status.value}"
                    )
                if e.decode_ticks < 1:
                    raise RuntimeError(
                        f"warm-up on {eid} drained without a decode tick"
                    )
                if precompile_buckets:
                    e.precompile_decode_buckets()
        else:
            for eid in self._solo_ids:
                e = self._engines[eid]
                h = e.submit(Request(
                    prompt_ids, max_new_tokens=2,
                    request_id=f"warmup-{eid}",
                ))
                e.run_until_drained()
                if h.status is not RequestStatus.COMPLETED:
                    raise RuntimeError(
                        f"warm-up on {eid} failed: {h.status.value}"
                    )
                if e.decode_ticks < 1:
                    raise RuntimeError(
                        f"warm-up on {eid} drained without a decode tick"
                    )
                if precompile_buckets:
                    e.precompile_decode_buckets()
        del warm
        # reset measurement state: warm-up records must not bias the
        # board's EWMAs or any reported percentile
        for eid, e in self._engines.items():
            tee = e.telemetry.writer
            e.telemetry = ServeTelemetry(
                writer=tee, clock=e.telemetry.clock, engine_id=eid,
            )
        self.board.reset()
        self.migration_frames = 0
        self.migration_bytes = 0
        self.migration_payload_bytes = 0
        self._live.clear()

    # -- aggregates --------------------------------------------------------
    def summary(self) -> Dict[str, object]:
        per_engine = {
            eid: self._engines[eid].telemetry.summary()
            for eid in sorted(self._engines)
        }
        ttfts = []
        for e in self._engines.values():
            ttfts.extend(e.telemetry.ttfts_s)
        out = {
            "engines": per_engine,
            "migration_frames": self.migration_frames,
            "migration_bytes": self.migration_bytes,
            "migration_payload_bytes": self.migration_payload_bytes,
            "replays": self.replays,
            "lost_engines": list(self.lost_engines),
            "board": self.board.snapshot(),
        }
        if ttfts:
            from pytorch_distributed_tpu_torch.utils.timing import percentile
            for q in (50, 95, 99):
                out[f"ttft_ms_p{q}"] = percentile(ttfts, q) * 1e3
        return out
