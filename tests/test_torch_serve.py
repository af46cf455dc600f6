"""The PyTorch port's serving stack (pytorch_distributed_tpu_torch/serve/)
held against the JAX package's, and against itself.

* ``PagedKVPool`` and ``Scheduler`` are host logic: integer-exact
  against the JAX ones over the same seeded op sequence, prefix sharing,
  copy-on-write admission and LRU eviction included.
* ``filter_logits_rows`` masks exactly what the JAX one masks and keeps
  the kept logits bit for bit.
* The port's ``ServeEngine`` greedy streams on the CPU equal JAX
  ``generate`` greedy under an f32 policy, token for token; a flip is
  allowed only where JAX's top-2 logit gap is under FLIP_RTOL of the
  logits' magnitude (the frameworks' logits differ by ~1e-7 relative).
* The port's engine equals the port's own ``generate``, greedy and
  seeded-sampled, in both decode modes, with faults and cancellation.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.generation import generate as jax_generate
from pytorch_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.serve import PagedKVPool as JaxPool
from pytorch_distributed_tpu.serve import Request as JaxRequest
from pytorch_distributed_tpu.serve.sampling import (
    filter_logits_rows as jax_filter_rows,
)
from pytorch_distributed_tpu.serve.scheduler import (
    RequestHandle as JaxHandle,
    Scheduler as JaxScheduler,
)
from pytorch_distributed_tpu_torch.generation import generate
from pytorch_distributed_tpu_torch.interop import llama_params_from_jax
from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
)
from pytorch_distributed_tpu_torch.ops.paged_attention import paged_attention
from pytorch_distributed_tpu_torch.runtime import faults, tracing
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.serve import (
    EngineConfig,
    PagedKVPool,
    Request,
    RequestHandle,
    RequestStatus,
    Scheduler,
    ServeEngine,
    ServeTelemetry,
    filter_logits_rows,
    sample_logits_rows,
)

FLIP_RTOL = 1e-4
F32 = JaxPolicy(compute_dtype=jnp.float32)
VOCAB = 512


@pytest.fixture(scope="module")
def models():
    """The tiny JAX Llama, its params, and the port model on them (f32)."""
    jmodel = JaxLlama(JaxLlamaConfig.tiny())
    with use_policy(F32):
        params = jmodel.init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)
        )["params"]
    params = jax.device_get(params)
    model = LlamaForCausalLM(
        LlamaConfig.tiny(), device="cpu", policy=Policy.full()
    )
    model.load_state_dict(llama_params_from_jax(params, LlamaConfig.tiny()))
    return jmodel, params, model


# --------------------------------------------------------------------------
# host logic: integer-exact against JAX
# --------------------------------------------------------------------------


def _pool_state(pool):
    return dict(
        page_tables=pool.page_tables.tolist(),
        lengths=pool.lengths.tolist(),
        ref=pool._ref.tolist(),
        free_pages=sorted(pool._free_pages),
        free_slots=sorted(pool._free_slots),
        registry=list(pool._registry.items()),
        counters=(pool.peak_pages, pool.prefix_hits, pool.shared_tokens,
                  pool.prompt_tokens, pool.pages_in_use),
    )


def _lease(lease):
    if lease is None:
        return None
    d = dataclasses.asdict(lease)
    d["page_row"] = np.asarray(d["page_row"]).tolist()
    return d


def test_paged_pool_integer_exact_vs_jax(models):
    jmodel, params, model = models
    kw = dict(page_size=8, num_pages=14, prefix_cache=True)
    jpool = JaxPool(jmodel, params, 3, 64, **kw)
    pool = PagedKVPool(model, 3, 64, **kw)
    rng = np.random.default_rng(0)
    p1 = rng.integers(1, VOCAB, size=20)
    p2 = np.concatenate([p1[:16], rng.integers(1, VOCAB, size=9)])
    p3 = rng.integers(1, VOCAB, size=30)
    leases = {}

    def both(op, *args, **kw):
        a = getattr(jpool, op)(*args, **kw)
        b = getattr(pool, op)(*args, **kw)
        if op == "allocate":
            assert _lease(a) == _lease(b), op
        assert _pool_state(jpool) == _pool_state(pool), op
        return a, b

    script = [
        ("a", "allocate", p1, dict(max_new=10, chunk=8)),
        ("a", "register_prefix", p1, {}),
        ("b", "allocate", p2, dict(max_new=6, chunk=8)),   # shares 2 pages
        ("b", "register_prefix", p2, {}),
        ("a", "free", None, {}),
        ("c", "allocate", p3, dict(max_new=20, chunk=8)),  # evicts
        ("d", "allocate", p1, dict(max_new=30, chunk=8)),  # too big: None
        ("b", "free", None, {}),
        ("e", "allocate", p2, dict(max_new=4, chunk=8)),   # shares again
        ("c", "free", None, {}),
        ("e", "free", None, {}),
    ]
    for name, op, prompt, kwargs in script:
        if op == "allocate":
            leases[name] = both(op, prompt, **kwargs)
        elif op == "register_prefix":
            ja, pa = leases[name]
            jpool.register_prefix(ja, prompt)
            pool.register_prefix(pa, prompt)
            assert _pool_state(jpool) == _pool_state(pool), op
        else:
            both(op, leases[name][1].slot)
    assert leases["b"][1].shared_pages == 2
    assert leases["d"][1] is None
    assert leases["e"][1].shared_pages == 3  # b registered 3 full pages
    jpool.check_consistency()
    pool.check_consistency()


def test_scheduler_matches_jax(models):
    """FIFO admission, chunk plans and releases, request by request."""
    jmodel, params, model = models
    kw = dict(page_size=8, num_pages=12)
    jpool, pool = JaxPool(jmodel, params, 2, 48, **kw), PagedKVPool(
        model, 2, 48, **kw
    )
    jsched, sched = JaxScheduler(2, 8), Scheduler(2, 8)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, VOCAB, size=n) for n in (13, 5, 21, 9)]
    jh = [JaxHandle(JaxRequest(p, 6, request_id=f"q{i}"), 0.0)
          for i, p in enumerate(prompts)]
    ph = [RequestHandle(Request(p, 6, request_id=f"q{i}"), 0.0)
          for i, p in enumerate(prompts)]
    for a, b in zip(jh, ph):
        jsched.enqueue(a)
        sched.enqueue(b)

    def plans(s, budget):
        return [(p.handle.request.request_id, p.start, p.ids.tolist(),
                 p.final) for p in s.plan_prefill(budget)]

    for rnd in range(6):
        got_j = [(h.request.request_id, h.slot) for h in jsched.admit(jpool)]
        got_p = [(h.request.request_id, h.slot) for h in sched.admit(pool)]
        assert got_j == got_p, rnd
        pj, pp = plans(jsched, 2), plans(sched, 2)
        assert pj == pp, rnd
        for (rid, _, _, final) in pp:
            if final:
                i = int(rid[1:])
                jsched.prefill_finished(jh[i])
                sched.prefill_finished(ph[i])
        dec_j = [(s, h.request.request_id) for s, h in jsched.decoding()]
        dec_p = [(s, h.request.request_id) for s, h in sched.decoding()]
        assert dec_j == dec_p, rnd
        if dec_p:  # retire the lowest decoding slot each round
            i = int(dec_p[0][1][1:])
            jsched.release(jh[i], jpool)
            sched.release(ph[i], pool)
        assert _pool_state(jpool) == _pool_state(pool), rnd
    assert not sched.queue and not sched.by_slot


def test_filter_logits_rows_mask_exact_vs_jax():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((8, 64)) * 3).astype(np.float32)
    temps = np.array([0, .7, 1, 1.3, .9, 1, .5, 2], np.float32)
    top_ks = np.array([0, 5, 0, 10, 64, 100, 3, 0], np.int32)
    top_ps = np.array([np.inf, np.inf, .9, .5, .95, np.inf, .7, .8],
                      np.float32)
    ref = np.asarray(jax_filter_rows(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps),
    ))
    out = filter_logits_rows(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(top_ks), torch.from_numpy(top_ps),
    ).numpy()
    neg = np.finfo(np.float32).min
    assert np.array_equal(out == neg, ref == neg)
    assert np.array_equal(out, ref)  # kept logits are bit for bit equal
    # the "off" encodings mask nothing
    assert not (out[[0, 5]] == neg).any()
    # greedy rows take argmax of the raw logits; sampled rows only ever
    # draw a kept token
    noise = -np.log(-np.log(rng.uniform(size=logits.shape)))
    toks = sample_logits_rows(
        torch.from_numpy(logits), torch.from_numpy(noise.astype(np.float32)),
        torch.from_numpy(temps), torch.from_numpy(top_ks),
        torch.from_numpy(top_ps),
    ).numpy()
    assert toks[0] == logits[0].argmax()
    assert all(out[b, toks[b]] != neg for b in range(8))


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

CFG = EngineConfig(num_slots=3, max_len=64, prefill_chunk=8, page_size=8)


def _port_generate(model, req):
    gen = (torch.Generator().manual_seed(req.seed)
           if req.temperature > 0 else None)
    out = generate(
        model, req.prompt_ids[None], max_new_tokens=req.max_new_tokens,
        temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
        generator=gen, device="cpu",
    )
    return out[0, req.prompt_len:].tolist()


def test_engine_greedy_matches_jax_generate(models):
    """4 greedy requests over 3 slots (slot reuse) against one batched
    JAX generate call."""
    jmodel, params, model = models
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, VOCAB, size=(4, 10)).astype(np.int32)
    new = 8
    with use_policy(F32):
        ref = np.asarray(jax_generate(
            jmodel, params, jnp.asarray(prompts), max_new_tokens=new,
        ))[:, 10:]
    engine = ServeEngine(model, CFG, device="cpu")
    handles = [engine.submit(Request(p, new)) for p in prompts]
    engine.run_until_drained()
    for i, h in enumerate(handles):
        assert h.status is RequestStatus.COMPLETED
        mine = h.tokens
        if mine == ref[i].tolist():
            continue
        # a flip is allowed only at a near-tie of the reference's logits
        j = next(k for k in range(new) if mine[k] != ref[i, k])
        seq = np.concatenate([prompts[i], ref[i, :j]])[None]
        with use_policy(F32):
            lg = np.asarray(jmodel.apply(
                {"params": params}, jnp.asarray(seq, jnp.int32)
            ))[0, -1]
        top2 = np.sort(lg)[-2:]
        assert top2[1] - top2[0] < FLIP_RTOL * np.abs(lg).max(), (i, j)


@pytest.mark.parametrize("decode_mode", ["paged", "dense"])
def test_engine_matches_port_generate(models, decode_mode):
    """Greedy and seeded-sampled streams, a shared prefix admitted while
    its owner decodes, a fault-evicted request and a cancellation: every
    completed stream equals the port's solo generate; the CPU path never
    launches the kernel."""
    _, _, model = models
    rng = np.random.default_rng(4)
    mk = lambda P, new, **kw: Request(  # noqa: E731
        rng.integers(1, VOCAB, size=P).astype(np.int32), new, **kw
    )
    first = mk(20, 6)
    reqs = [
        first,
        mk(13, 9, temperature=0.8, top_p=0.9, seed=3),
        mk(5, 7, temperature=1.1, top_k=20, seed=5),
        mk(7, 12, request_id="victim"),
        mk(9, 30, request_id="doomed"),
    ]
    sharer = Request(
        np.concatenate([first.prompt_ids[:16], [7, 8, 9]]), 5,
        temperature=0.7, top_k=40, top_p=0.95, seed=11,
    )
    engine = ServeEngine(
        model, dataclasses.replace(CFG, decode_mode=decode_mode),
        device="cpu",
    )
    launches = paged_attention.launches
    with faults.injected("serve.decode:count=1,match=victim"):
        handles = [engine.submit(r) for r in reqs]
        while handles[0].status is not RequestStatus.DECODING:
            engine.step()
        handles.append(engine.submit(sharer))
        for _ in range(4):
            engine.step()
        assert engine.cancel("doomed")
        engine.run_until_drained()
    assert paged_attention.launches == launches
    by_id = {h.request.request_id: h for h in handles}
    assert by_id["victim"].status is RequestStatus.FAILED
    assert isinstance(by_id["victim"].error, faults.InjectedFault)
    assert by_id["doomed"].status is RequestStatus.CANCELLED
    if decode_mode == "paged":
        assert engine.decode_bucket_ticks.keys() <= {1, 2, 4, 8}
    assert engine.pool.prefix_hits >= 1
    for r in reqs[:3] + [sharer]:
        h = by_id[r.request_id]
        assert h.status is RequestStatus.COMPLETED, h
        assert h.tokens == _port_generate(model, r), r.request_id
    engine.pool.check_consistency()
    assert engine.pool.pages_in_use == len(engine.pool._registry)


def test_engine_refuses_what_is_not_ported(models):
    """What the JAX engine refuses, the port refuses: speculation with a
    fleet role or a prefix store, submissions to a decode-tier engine,
    migrations into a prefill-tier one, and a request over max_len."""
    from pytorch_distributed_tpu_torch.serve import (
        InProcPrefixStore,
        SpecConfig,
    )

    _, _, model = models
    spec = SpecConfig(model, num_draft_tokens=2)
    with pytest.raises(ValueError, match="solo-engine only"):
        ServeEngine(model, dataclasses.replace(CFG, role="prefill"),
                    device="cpu", spec=spec)
    with pytest.raises(ValueError, match="prefix_store requires spec"):
        ServeEngine(model, CFG, device="cpu", spec=spec,
                    prefix_store=InProcPrefixStore())
    dec = ServeEngine(model, dataclasses.replace(CFG, role="decode"),
                      device="cpu")
    with pytest.raises(RuntimeError, match="inject_migration"):
        dec.submit(Request(np.arange(1, 9), 4))
    pre = ServeEngine(model, dataclasses.replace(CFG, role="prefill"),
                      device="cpu")
    with pytest.raises(RuntimeError, match="outbox"):
        pre.inject_migration(None)
    engine = ServeEngine(model, CFG, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        engine.submit(Request(np.arange(1, 60), 10))
    with pytest.raises(ValueError, match="exceeds"):
        ServeEngine(model, CFG, device="cpu",
                    spec=SpecConfig(model, 4)).submit(
                        Request(np.arange(1, 40), 24))


def test_engine_telemetry_and_tracing(models, tmp_path):
    """Per-request and snapshot records reach the telemetry writer, the
    summary counts every completed token, and an armed tracer records
    the engine's spans and exports a Chrome trace."""
    _, _, model = models

    class Rows:
        def __init__(self):
            self.rows = []

        def write(self, step, metrics, split):
            self.rows.append((split, metrics))

    writer = Rows()
    engine = ServeEngine(
        model, dataclasses.replace(CFG, telemetry_every=1), device="cpu",
        telemetry=ServeTelemetry(writer),
    )
    rng = np.random.default_rng(6)
    with tracing.enabled(str(tmp_path)) as tracer:
        for n in (3, 5):
            engine.submit(Request(rng.integers(1, VOCAB, size=9), n))
        engine.run_until_drained()
    events = [m["event"] for split, m in writer.rows if split == "serve"]
    assert events.count("request") == 2 and "snapshot" in events
    summary = engine.telemetry.summary()
    assert summary["completed_tokens"] == 8 and summary["completed"] == 2
    assert "ttft_ms_p50" in summary
    roll = tracer.rollups()
    for name in ("serve.admit", "serve.prefill_chunk", "serve.decode_tick",
                 "serve.token_fetch", "serve.evict"):
        assert roll[name]["count"] >= 1, name
    assert roll["serve.decode_tick"]["count"] == engine.decode_ticks
    assert os.path.exists(tracer.export())
