"""GPT-2 through the port's paged serving engine, held against the JAX
package and against the port's own ``generate``.

* Paged decode logits: the same page pool, page tables and tokens
  through the JAX GPT-2 under its ``paged_view`` and the port's GPT-2
  with ``paged=``: a 6-token chunk into empty pages, a single-token
  step, and a 3-token verify block with one row's write dropped, exact
  KV and int8 pools (f32 policy; the JAX package's CPU route is its
  ``gather`` impl, the port's its ``stream`` reference for fp pools and
  ``gather`` for int8 ones).
* The engine's greedy streams equal JAX ``generate`` greedy, a flip
  allowed only where JAX's top-2 logit gap is under ``FLIP_RTOL`` of the
  logits' magnitude.
* The engine equals the port's solo ``generate``, greedy and
  seeded-sampled, in both decode modes: the reference's own claim,
  re-proved port against port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.generation import generate as jax_generate
from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from pytorch_distributed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from pytorch_distributed_tpu.ops.paged_attention import (
    PagedView as JaxPagedView,
    paged_view,
)
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.serve.kv_slots import (
    frame_signature as jax_frame_signature,
    init_page_cache as jax_init_page_cache,
)
from pytorch_distributed_tpu_torch.generation import generate
from pytorch_distributed_tpu_torch.interop import gpt2_params_from_jax
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.ops.paged_attention import (
    PagedView,
    paged_attention,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.serve import (
    EngineConfig,
    Request,
    RequestStatus,
    ServeEngine,
    frame_signature,
    init_page_cache,
)
from torch_parity import assert_close

F32 = JaxPolicy(compute_dtype=jnp.float32)
VOCAB = 97
# paged vs JAX logits: f32 sums in another order (the stream's online
# softmax against JAX's dense gather); int8 pools dequantize the same
# payloads with the same formula, but a payload rounds differently where
# the two frameworks' K/V differ by an ulp at a rounding boundary
RTOL = 1e-5
RTOL_INT8 = 1e-3
FLIP_RTOL = 1e-4
ECFG = EngineConfig(num_slots=3, max_len=64, prefill_chunk=8, page_size=8)


def _cfg(**kw):
    return dict(vocab_size=VOCAB, n_positions=64, hidden_size=32,
                num_layers=2, num_heads=2, dropout_rate=0.0, **kw)


def _build(q):
    """(JAX model, params, port model), KV exact or int8, f32 policy."""
    jmodel = JaxGPT2(JaxGPT2Config(**_cfg(), kv_cache_quantize=q))
    with use_policy(F32):
        params = jax.device_get(jmodel.init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    cfg = GPT2Config(**_cfg(), kv_cache_quantize=q)
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    model.load_state_dict(gpt2_params_from_jax(params, cfg))
    model.requires_grad_(False)
    return jmodel, params, model


@pytest.fixture(scope="module", params=[None, "int8"], ids=["exact", "int8"])
def gpt2(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def gpt2_exact():
    return _build(None)


def _jax_paged_step(jmodel, params, pool, tables, keep, ps, max_len, ids,
                    pos, wp):
    """One JAX paged decode call, jitted (its eager dispatch is slower
    than its compile at these sizes)."""

    def step(params, pool, tables, keep, ids, pos, wp):
        view = JaxPagedView(page_tables=tables, keep=keep, page_size=ps)
        with use_policy(F32), paged_view(view):
            return jmodel.apply(
                {"params": params, "cache": pool}, ids, decode=True,
                cache_len=max_len, mutable=["cache"], positions=pos,
                write_pos=wp,
            )

    i32 = lambda x: jnp.asarray(x, jnp.int32)  # noqa: E731
    return jax.jit(step)(params, pool, i32(tables), jnp.asarray(keep),
                         i32(ids), i32(pos), i32(wp))


def test_paged_decode_logits_match_jax(gpt2):
    jmodel, params, model = gpt2
    ps, n_pages, max_len = 4, 9, 16
    tables = np.array([[3, 1, 7, 0], [2, 9, 4, 6]], np.int32)
    rng = np.random.default_rng(0)
    steps = [  # (tokens [2, W], write_pos, keep)
        (rng.integers(1, VOCAB, size=(2, 6)), [0, 0], [True, True]),
        (rng.integers(1, VOCAB, size=(2, 1)), [6, 6], [True, True]),
        (rng.integers(1, VOCAB, size=(2, 3)), [7, 7], [True, False]),
    ]
    with use_policy(F32):
        jpool = jax_init_page_cache(jmodel, params, n_pages, ps)
    pool = init_page_cache(model, n_pages, ps)
    # the pools' frame geometry is the JAX one, name for name
    assert frame_signature(pool, ps) == jax_frame_signature(jpool, ps)
    launches = paged_attention.launches
    for i, (ids, wp, keep) in enumerate(steps):
        W = ids.shape[1]
        pos = np.asarray(wp)[:, None] + np.arange(W)
        ref, st = _jax_paged_step(jmodel, params, jpool, tables, keep, ps,
                                  max_len, ids, pos, wp)
        jpool = st["cache"]
        with torch.no_grad():
            out, pool = model(
                torch.from_numpy(ids), torch.from_numpy(pos),
                cache=pool, write_pos=torch.tensor(wp, dtype=torch.int32),
                decode=True, cache_len=max_len,
                paged=PagedView(page_tables=torch.from_numpy(tables),
                                keep=torch.tensor(keep), page_size=ps),
            )
        rtol = RTOL if model.config.kv_cache_quantize is None else RTOL_INT8
        assert_close(out, np.asarray(ref), rtol, f"step {i}")
    assert paged_attention.launches == launches   # the CPU runs no kernel
    # the pools hold the same keys, page for page (the dropped row's
    # write landed in neither); int8 payloads equal but for an entry a
    # rounding boundary may split
    jk = np.asarray(jpool["blocks"]["block"]["cached_key"])
    pk = np.stack([layer[0].numpy() for layer in pool])
    if model.config.kv_cache_quantize is None:
        assert_close(pk, jk, RTOL, "pool K")
    else:
        assert np.abs(pk.astype(int) - jk).max() <= 1
        assert np.mean(pk == jk) > 0.99


def _port_generate(model, req):
    gen = (torch.Generator().manual_seed(req.seed)
           if req.temperature > 0 else None)
    out = generate(
        model, req.prompt_ids[None], max_new_tokens=req.max_new_tokens,
        temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
        generator=gen, device="cpu",
    )
    return out[0, req.prompt_len:].tolist()


def test_engine_greedy_matches_jax_generate(gpt2_exact):
    """4 greedy requests over 3 slots (slot reuse) against one batched
    JAX generate call."""
    jmodel, params, model = gpt2_exact
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, VOCAB, size=(4, 10)).astype(np.int32)
    new = 8
    with use_policy(F32):
        ref = np.asarray(jax_generate(
            jmodel, params, jnp.asarray(prompts), max_new_tokens=new,
        ))[:, 10:]
    engine = ServeEngine(model, ECFG, device="cpu")
    handles = [engine.submit(Request(p, new)) for p in prompts]
    engine.run_until_drained()
    for i, h in enumerate(handles):
        assert h.status is RequestStatus.COMPLETED
        mine = h.tokens
        if mine == ref[i].tolist():
            continue
        j = next(k for k in range(new) if mine[k] != ref[i, k])
        seq = np.concatenate([prompts[i], ref[i, :j]])[None]
        with use_policy(F32):
            lg = np.asarray(jmodel.apply(
                {"params": params}, jnp.asarray(seq, jnp.int32)))[0, -1]
        top2 = np.sort(lg)[-2:]
        assert top2[1] - top2[0] < FLIP_RTOL * np.abs(lg).max(), (i, j)


@pytest.mark.parametrize("decode_mode", ["paged", "dense"])
def test_engine_matches_port_generate(gpt2, decode_mode):
    """Greedy and seeded-sampled GPT-2 streams, ragged prompts, a
    request admitted mid-flight: each equals the port's solo generate,
    the learned positions looked up at each row's own length."""
    _, _, model = gpt2
    rng = np.random.default_rng(4)
    reqs = [
        Request(rng.integers(1, VOCAB, size=int(rng.integers(3, 25))),
                int(rng.integers(4, 12)),
                temperature=0.9 if i % 2 else 0.0,
                top_k=20 if i % 2 else None, top_p=0.9 if i == 3 else None,
                seed=1000 + i, request_id=f"r{i}")
        for i in range(5)
    ]
    engine = ServeEngine(
        model, dataclasses.replace(ECFG, decode_mode=decode_mode),
        device="cpu",
    )
    handles = [engine.submit(r) for r in reqs[:4]]
    for _ in range(3):
        engine.step()
    handles.append(engine.submit(reqs[4]))
    engine.run_until_drained()
    for r, h in zip(reqs, handles):
        assert h.status is RequestStatus.COMPLETED, h
        assert h.tokens == _port_generate(model, r), r.request_id
    engine.pool.check_consistency()
    if decode_mode == "paged":
        assert engine.decode_buckets <= {1, 2, 4, 8}
