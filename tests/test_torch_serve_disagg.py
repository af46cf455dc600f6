"""The port's disaggregated fleet: KV migration between prefill and
decode engines, the cross-engine prefix store, the router and the load
generator, held against the JAX package where the two share a format
and port against port where the JAX claim is about its own consistency.

* Wire codec: the port's ``encode_frame`` bytes equal the JAX package's
  for the same frame and signature; refusals of a wrong signature, a
  damaged payload, a mixed geometry and an inconsistent page count;
  ``send_frame``/``recv_frame`` over an in-process ring.
* Roles and migration: prefill -> wire -> decode streams equal the solo
  engine's, greedy and sampled (the decode side re-seeds the slot's
  generator and replays the prefill tier's one first-token draw), exact
  and int8 pools, with exact payload accounting.
* Prefix store: first writer wins, pins survive capacity pressure, a
  shared prompt is prefilled once per fleet.
* Router: ``GaugeBoard`` rankings equal the JAX board's on the same
  record stream; solo and disaggregated storms and an engine-loss
  replay end in the solo streams; the loss dumps the flight recorder.
* ``prefix_shared_requests`` is integer-equal to the JAX generator's
  for the same numpy rng.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.serve import disagg as jax_disagg
from pytorch_distributed_tpu.serve.loadgen import (
    prefix_shared_requests as jax_prefix_shared_requests,
)
from pytorch_distributed_tpu.serve.router import GaugeBoard as JaxGaugeBoard
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.runtime import faults, flightrec
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.serve import (
    EngineConfig,
    GaugeBoard,
    InProcPrefixStore,
    MigrationError,
    Request,
    RequestStatus,
    Router,
    ServeEngine,
    decode_frame,
    drive,
    encode_frame,
    extract_frames,
    frame_f32_nbytes,
    frame_nbytes,
    prefix_shared_requests,
    recv_frame,
    roundtrip_frame,
    send_frame,
    uniform_arrivals,
)

VOCAB = 97
ECFG = dict(num_slots=4, max_len=96, prefill_chunk=8, page_size=8)


def _gpt2(**kw):
    cfg = GPT2Config(vocab_size=VOCAB, n_positions=96, hidden_size=32,
                     num_layers=2, num_heads=2, dropout_rate=0.0, **kw)
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(0))
    return model.requires_grad_(False)


@pytest.fixture(scope="module")
def gpt2():
    return _gpt2()


@pytest.fixture(scope="module")
def gpt2_int8():
    return _gpt2(kv_cache_quantize="int8")


def _engine(model, **kw):
    return ServeEngine(model, EngineConfig(**(ECFG | kw)), device="cpu")


def _requests(n=6, seed=7, new=8):
    """Mixed greedy/sampled requests with ragged prompt lengths."""
    rng = np.random.default_rng(seed)
    return [
        Request(rng.integers(1, VOCAB, size=int(rng.integers(3, 25))),
                max_new_tokens=new, request_id=f"r{seed}-{i}",
                temperature=0.9 if i % 2 else 0.0,
                top_k=20 if i % 2 else None, seed=1000 + i)
        for i in range(n)
    ]


def _solo_streams(model, reqs):
    eng = _engine(model)
    hs = [eng.submit(r) for r in reqs]
    eng.run_until_drained()
    assert all(h.status is RequestStatus.COMPLETED for h in hs)
    return {r.request_id: h.tokens for r, h in zip(reqs, hs)}


def _migrate_all(pre, dec):
    """The router's loop, unrolled: every outbox frame through the full
    wire codec into the decode engine, then drain."""
    pre.run_until_drained()
    got = {}
    while pre.outbox:
        frame = pre.outbox.popleft()
        wire, _ = roundtrip_frame(frame, dec.migration_signature)
        got[frame.request_id] = dec.inject_migration(wire)
    dec.run_until_drained()
    return got


def _one_frame(model, seed=31):
    pre = _engine(model, role="prefill", engine_id="p0")
    pre.submit(_requests(1, seed)[0])
    pre.run_until_drained()
    return pre.outbox.popleft(), pre


# -- wire format -------------------------------------------------------------


def test_encode_frame_byte_equal_to_jax(gpt2):
    frame, _ = _one_frame(gpt2)
    ours = encode_frame(frame)
    theirs = jax_disagg.encode_frame(jax_disagg.MigrationFrame(
        **dataclasses.asdict(frame)))
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # and each package decodes the other's wire arrays
    back = decode_frame(*theirs[1:], expect_signature=frame.signature)
    assert back.request == frame.request
    assert back.payload.tobytes() == frame.payload.tobytes()


def test_codec_refusals(gpt2, gpt2_int8):
    frame, pre = _one_frame(gpt2)
    pre_, hdr, meta, payload = encode_frame(frame)
    with pytest.raises(MigrationError, match="fingerprint mismatch"):
        decode_frame(hdr, meta, payload, expect_signature="ps=4|other")
    bad = payload.copy()
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(MigrationError, match="fingerprint mismatch"):
        decode_frame(hdr, meta, bad, expect_signature=frame.signature)
    # a pool of another geometry (int8) refuses the frame at intake
    dec8 = _engine(gpt2_int8, role="decode")
    with pytest.raises(MigrationError, match="geometry mismatch"):
        dec8.inject_migration(frame)
    dec = _engine(gpt2, role="decode")
    with pytest.raises(MigrationError, match="spans"):
        dec.inject_migration(dataclasses.replace(frame,
                                                 n_pages=frame.n_pages + 1))
    with pytest.raises(MigrationError, match="disagrees"):
        dec.inject_migration(dataclasses.replace(
            frame, prompt_len=frame.prompt_len + 1))


def test_send_recv_over_a_ring(gpt2):
    """The P2P hand-off over any ring with send/recv: an in-process
    mailbox ring here (the port's cross-process ring is ROADMAP A11)."""

    class Ring:
        def __init__(self):
            self.box = []

        def send(self, array, dst):
            self.box.append((dst, np.array(array, copy=True)))

        def recv(self, buffer, src):
            dst, a = self.box.pop(0)
            assert a.shape == buffer.shape and a.dtype == buffer.dtype
            return a

    frame, pre = _one_frame(gpt2)
    ring = Ring()
    nbytes = send_frame(ring, frame, dst=1)
    assert [d for d, _ in ring.box] == [1] * 4
    got = recv_frame(ring, 0, expect_signature=pre.migration_signature)
    assert nbytes == sum(a.nbytes for a in encode_frame(frame))
    assert got.payload.tobytes() == frame.payload.tobytes()
    assert got.first_token == frame.first_token


# -- roles and migration -----------------------------------------------------


def test_roles_refuse_the_other_tier(gpt2):
    with pytest.raises(ValueError, match="role"):
        EngineConfig(role="bogus")
    with pytest.raises(RuntimeError, match="inject_migration"):
        _engine(gpt2, role="decode").submit(_requests(1)[0])
    frame, pre = _one_frame(gpt2)
    with pytest.raises(RuntimeError, match="outbox"):
        pre.inject_migration(frame)


def test_migration_parity_greedy_and_sampled(gpt2):
    reqs = _requests(6, seed=21)
    want = _solo_streams(gpt2, reqs)
    pre = _engine(gpt2, role="prefill")
    dec = _engine(gpt2, role="decode")
    hs = [pre.submit(r) for r in reqs]
    got = _migrate_all(pre, dec)
    assert all(h.status is RequestStatus.MIGRATED for h in hs)
    assert pre.migrated_out == dec.migrated_in == len(reqs)
    for rid, h in got.items():
        assert h.status is RequestStatus.COMPLETED, (rid, h.error)
        assert h.tokens == want[rid], rid
    dec.pool.check_consistency()


def test_int8_payload_accounting_and_parity(gpt2_int8):
    pre = _engine(gpt2_int8, role="prefill")
    dec = _engine(gpt2_int8, role="decode")
    per_page = frame_nbytes(pre.pool.cache)
    f32_page = frame_f32_nbytes(pre.pool.cache)
    # head_dim 16: (1 + 4/16) / 4 = 0.3125 of the f32 frame
    assert per_page * 100 <= 55 * f32_page
    reqs = _requests(4, seed=41)
    want = _solo_streams(gpt2_int8, reqs)
    for r in reqs:
        pre.submit(r)
    pre.run_until_drained()
    ps = pre.pool.page_size
    got = {}
    while pre.outbox:
        frame = pre.outbox.popleft()
        assert frame.n_pages == -(-frame.prompt_len // ps)
        assert frame.payload.nbytes == frame.n_pages * per_page
        wire, nbytes = roundtrip_frame(frame, dec.migration_signature)
        assert nbytes > frame.payload.nbytes
        h = got[frame.request_id] = dec.inject_migration(wire)
        dec._drain_inject_backlog()
        # the splice landed the wire bytes verbatim
        spliced = extract_frames(dec.pool.cache,
                                 h._lease.page_row[:frame.n_pages])
        assert spliced.tobytes() == frame.payload.tobytes()
    dec.run_until_drained()
    for rid, toks in want.items():
        assert got[rid].tokens == toks, rid


# -- prefix store --------------------------------------------------------------


def test_store_first_writer_wins_and_pins_survive():
    store = InProcPrefixStore(capacity_pages=2, signature="sig")
    assert store.put(b"a", np.ones(4, np.uint8), holder="e0")
    assert not store.put(b"a", np.zeros(4, np.uint8), holder="e1")
    assert store.get(b"a").tolist() == [1] * 4
    assert store.put(b"b", np.ones(4, np.uint8))           # unpinned
    assert store.put(b"c", np.ones(4, np.uint8))           # evicts b
    assert b"a" in store and b"b" not in store and b"c" in store
    assert store.pinned(b"a") == 2
    assert store.release_holder("e0") == 1 and store.pinned(b"a") == 1
    with pytest.raises(ValueError, match="geometry mismatch"):
        store.get(b"a", signature="other")
    assert store.stats()["dup_puts"] == 1 and store.evictions == 1


def test_fleet_prefills_a_shared_prompt_once(gpt2):
    store = InProcPrefixStore()
    shared = np.arange(1, 17, dtype=np.int32)   # 2 full pages at ps 8
    rng = np.random.default_rng(5)
    reqs = [Request(np.concatenate([shared, rng.integers(1, VOCAB, size=5)]),
                    max_new_tokens=6, request_id=f"shared-{i}")
            for i in range(4)]
    want = _solo_streams(gpt2, reqs)
    engines = [ServeEngine(gpt2, EngineConfig(engine_id=f"e{i}", **ECFG),
                           device="cpu", prefix_store=store)
               for i in range(2)]
    h0 = [engines[0].submit(r) for r in reqs[:2]]
    engines[0].run_until_drained()
    assert store.stats()["puts"] == 2 == engines[0].store_published_pages
    h1 = [engines[1].submit(r) for r in reqs[2:]]
    engines[1].run_until_drained()
    assert engines[1].store_adopted_pages == 2
    assert engines[1].store_published_pages == 0
    assert store.stats()["puts"] == 2 and store.stats()["hits"] >= 2
    for r, h in zip(reqs, h0 + h1):
        assert h.tokens == want[r.request_id], r.request_id
    for e in engines:
        e.pool.check_consistency()


def test_adopt_page_and_pool_views(gpt2):
    """``adopt_page`` claims a free page under a key (the registry holds
    it), returns the known page on a second call and nothing with the
    prefix cache off; the pool's host views follow a lease."""
    pool = _engine(gpt2).pool
    free = pool.num_free
    pg = pool.adopt_page(b"k" * 16)
    assert pool.adopt_page(b"k" * 16) == pg and pool._registry[b"k" * 16] == pg
    pool.check_consistency()
    lease = pool.allocate(np.arange(1, 12), max_new=4, chunk=8)
    pool.lengths[lease.slot] = 11
    assert pool.num_free == free - 1
    assert pool.device_page_table(lease.slot).tolist() == (
        lease.page_row.tolist())
    mask = pool.valid_mask()
    assert mask[lease.slot].sum() == 11 and mask.sum() == 11
    assert pool.kv_bytes() == (pool.num_pages + 1) * frame_nbytes(pool.cache)
    off = _engine(gpt2, prefix_cache=False).pool
    assert off.adopt_page(b"k" * 16) is None


def test_page_size_warning_resets(monkeypatch):
    """An odd max_len degenerates to 1-token pages and warns once per
    max_len; ``reset_page_size_warnings`` arms the warning again."""
    from pytorch_distributed_tpu_torch.serve import kv_slots

    warned = []
    monkeypatch.setattr(kv_slots.logger, "warning",
                        lambda *a, **k: warned.append(a))
    kv_slots.reset_page_size_warnings()
    assert kv_slots.auto_page_size(25) == kv_slots.auto_page_size(25) == 1
    kv_slots.reset_page_size_warnings()
    kv_slots.auto_page_size(25)
    assert len(warned) == 2


def test_delays_never_touch_the_math(gpt2):
    """``prefill_delay_s``/``decode_delay_s`` sleep per prefill token and
    per active row a tick: the streams stay the solo engine's."""
    reqs = _requests(3, seed=61, new=4)
    want = _solo_streams(gpt2, reqs)
    eng = _engine(gpt2, prefill_delay_s=1e-4, decode_delay_s=1e-4)
    hs = [eng.submit(r) for r in reqs]
    eng.run_until_drained()
    assert [h.tokens for h in hs] == [want[r.request_id] for r in reqs]
    with pytest.raises(ValueError, match="delay"):
        EngineConfig(decode_delay_s=-1.0)


# -- router --------------------------------------------------------------------


def test_gauge_board_ranks_as_jax():
    """The same record stream folded by both boards gives the same state
    and the same routing order at every step."""
    rng = np.random.default_rng(3)
    ours, theirs = GaugeBoard(ema=0.4), JaxGaugeBoard(ema=0.4)
    ids = ["e0", "e1", "e2"]
    for _ in range(60):
        eid = ids[int(rng.integers(3))]
        kind = int(rng.integers(3))
        ttft = float(rng.integers(1, 99))
        for board in (ours, theirs):
            if kind == 0:
                board.note_routed(eid)
            elif kind == 1:
                board.ingest(eid, {"event": "request", "ttft_ms": ttft})
            else:
                board.ingest(eid, {"event": "snapshot",
                                   "slot_occupancy": ttft / 100})
        assert ours.snapshot() == theirs.snapshot()
        assert sorted(ids, key=ours.rank) == sorted(ids, key=theirs.rank)


def _fleet(model, n=2):
    return [ServeEngine(model, EngineConfig(engine_id=f"e{i}", **ECFG),
                        device="cpu") for i in range(n)]


def test_router_construction_refusals(gpt2, gpt2_int8):
    with pytest.raises(ValueError, match="not both"):
        Router(engines=_fleet(gpt2, 1), prefill=_fleet(gpt2, 1))
    with pytest.raises(ValueError, match="BOTH"):
        Router(prefill=[_engine(gpt2, role="prefill")])
    with pytest.raises(ValueError, match="role"):
        Router(prefill=_fleet(gpt2, 1), decode=[_engine(gpt2,
                                                        role="decode")])
    with pytest.raises(ValueError, match="mixed-geometry"):
        Router(engines=[_engine(gpt2), _engine(gpt2_int8)])


def test_solo_and_disagg_storms_equal_solo(gpt2):
    reqs = _requests(10, seed=51)
    want = _solo_streams(gpt2, reqs)
    solo = Router(engines=_fleet(gpt2))
    pre = _engine(gpt2, role="prefill", engine_id="p0")
    dec = _engine(gpt2, role="decode", engine_id="d0")
    tiers = Router(prefill=[pre], decode=[dec])
    for router in (solo, tiers):
        wall = drive(router, reqs, uniform_arrivals(len(reqs), 0.0))
        assert wall > 0
        for r in reqs:
            rh = router._live[r.request_id]
            assert rh.status is RequestStatus.COMPLETED
            assert rh.tokens == want[r.request_id], r.request_id
    assert tiers.migration_frames == len(reqs)
    pages = sum(-(-r.prompt_len // pre.pool.page_size) for r in reqs)
    assert tiers.migration_payload_bytes == pages * frame_nbytes(
        pre.pool.cache)
    assert tiers.migration_bytes > tiers.migration_payload_bytes
    assert sum(e.get("completed", 0)
               for e in solo.summary()["engines"].values()) == len(reqs)


def test_engine_loss_replays_to_the_solo_streams(gpt2, tmp_path):
    reqs = _requests(10, seed=53)
    want = _solo_streams(gpt2, reqs)
    router = Router(engines=_fleet(gpt2))
    hs = [router.submit(r) for r in reqs]
    flightrec.configure(out_dir=str(tmp_path), rank=0)
    try:
        with faults.injected(
            "serve.engine_loss:mode=raise,match=e1,after=2"
        ):
            router.run_until_drained()
    finally:
        flightrec._dump_dir = None
    assert router.lost_engines == ["e1"] and router.replays >= 1
    for r, h in zip(reqs, hs):
        assert h.status is RequestStatus.COMPLETED, (r.request_id, h.status)
        assert h.tokens == want[r.request_id], r.request_id
    assert all(h.engine_id == "e0" for h in hs if h.replays)
    dumps = flightrec.load_dumps(str(tmp_path))
    assert "e1 lost" in dumps[0]["reason"]
    # losing the last engine of a tier is loud
    last = Router(engines=_fleet(gpt2, 1))
    last.submit(reqs[0])
    with faults.injected("serve.engine_loss:mode=raise,match=e0"):
        with pytest.raises(RuntimeError, match="surviving"):
            last.run_until_drained()


def test_flight_recorder_ring(tmp_path):
    """The recorder's ring: records in order, the oldest overwritten past
    capacity, the newest completed one remembered; a dump round-trips
    through ``load_dumps``, and a torn one is skipped."""
    rec = flightrec.FlightRecorder(capacity=3)
    for i in range(5):
        seq = rec.begin("send", "-", "uint8", 4, 4, "inproc", "g")
        rec.start(seq)
        if i < 4:
            rec.complete(seq)
    got = rec.records()
    assert [r["seq"] for r in got] == [2, 3, 4]
    assert [r["state"] for r in got] == ["completed"] * 2 + ["started"]
    assert rec.last_completed() == (3, "send", "-")
    path = flightrec.dump("test", out_dir=str(tmp_path))
    (tmp_path / "flight-rank9.json.tmp").write_text("{")
    assert flightrec.load_dumps(str(tmp_path))[0]["reason"] == "test"
    assert path.endswith("flight-rank0.json")
    assert flightrec.dump("unarmed") is None


def test_prefix_shared_requests_equal_jax():
    kw = dict(prompt_len=(4, 12), new_tokens=(3, 9), prefix_share=0.6,
              shared_prefix_len=8, temperature=0.7, top_k=5)
    ours = prefix_shared_requests(np.random.default_rng(12), 9, VOCAB, **kw)
    theirs = jax_prefix_shared_requests(np.random.default_rng(12), 9, VOCAB,
                                        **kw)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.prompt_ids, b.prompt_ids)
        assert (a.max_new_tokens, a.seed, a.temperature, a.top_k) == (
            b.max_new_tokens, b.seed, b.temperature, b.top_k)
