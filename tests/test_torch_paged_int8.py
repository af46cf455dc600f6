"""int8 paged KV pools in the port, held against the JAX package's
``PagedKVQuant`` and against the port's own dense int8 cache.

* ``decode_cache``'s paged int8 write quantizes each new entry per token
  (``ops.quant.symmetric_int8``, the JAX ``_q8_rows``) into the payload
  pool and its f32 scale pool: payloads integer-equal to the JAX
  package's ``paged_write`` of the same values, scales within an ulp.
* ``paged_attention`` over int8 pools: ``gather`` bitwise-class against
  the JAX ``gather`` (the same dequantize-then-attend formula; float
  sums in another framework), ``stream`` within a tolerance scaled to
  the output's magnitude (an absolute 3e-6, the JAX package's own
  stream check, is below the reassociation error at these magnitudes),
  and the dispatch sends int8 pools to ``gather``, never to the
  kernel.
* Paged int8 streams equal the dense int8 cache's, port against port.
* Frame bytes: an int8 pool's frame is ``(1 + 4/D) / 4`` of the f32
  frame, and ``frame_nbytes``/``frame_f32_nbytes``/``frame_signature``
  equal the JAX package's for the same geometry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from pytorch_distributed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from pytorch_distributed_tpu.ops.attention import _q8_rows as jax_q8_rows
from pytorch_distributed_tpu.ops.paged_attention import (
    PagedKVQuant as JaxPagedKVQuant,
    paged_attention as jax_paged_attention,
    paged_write as jax_paged_write,
)
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.serve import kv_slots as jax_kv_slots
from pytorch_distributed_tpu_torch.generation import generate
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.ops.attention import (
    CACHE_NAMES,
    decode_cache,
    dot_product_attention,
)
from pytorch_distributed_tpu_torch.ops.paged_attention import (
    PagedKVQuant,
    PagedView,
    gather_dense,
    paged_attention,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.serve import (
    EngineConfig,
    Request,
    RequestStatus,
    ServeEngine,
    extract_frames,
    frame_f32_nbytes,
    frame_nbytes,
    frame_signature,
    init_page_cache,
)
from torch_parity import assert_close

B, W, HQ, HKV, D, PS, N = 3, 2, 4, 2, 16, 4, 5
# gather: the same dequantized K/V through the same dense formula, f32
# sums in another framework's order
GATHER_RTOL = 1e-6
# stream: online softmax reassociates the sums page by page
STREAM_RTOL = 1e-5


def _pools(seed=5):
    rng = np.random.default_rng(seed)
    P1 = B * N + 1
    tables = (np.arange(B * N).reshape(B, N) + 1).astype(np.int32)
    rng.shuffle(tables.reshape(-1))
    lengths = np.array([3, 9, 17], np.int32)
    q = rng.standard_normal((B, W, HQ, D)).astype(np.float32)
    k8 = rng.integers(-127, 128, size=(P1, PS, HKV, D)).astype(np.int8)
    v8 = rng.integers(-127, 128, size=(P1, PS, HKV, D)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, size=(P1, PS, HKV, 1)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, size=(P1, PS, HKV, 1)).astype(np.float32)
    return q, k8, v8, ks, vs, tables, lengths


@pytest.mark.parametrize("impl", ["gather", "stream"])
def test_int8_pools_match_jax(impl):
    q, k8, v8, ks, vs, tables, lengths = _pools()
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), JaxPagedKVQuant(jnp.asarray(k8), jnp.asarray(ks),
                                        jnp.float32),
        JaxPagedKVQuant(jnp.asarray(v8), jnp.asarray(vs), jnp.float32),
        page_tables=jnp.asarray(tables), lengths=jnp.asarray(lengths),
        impl="gather",
    ))
    t = torch.from_numpy
    got = paged_attention(
        t(q), PagedKVQuant(t(k8), t(ks), torch.float32),
        PagedKVQuant(t(v8), t(vs), torch.float32),
        page_tables=t(tables), lengths=t(lengths), impl=impl,
    )
    rtol = GATHER_RTOL if impl == "gather" else STREAM_RTOL
    assert_close(got, want, rtol, impl)


def test_int8_dispatch_is_gather_and_bitwise_dense():
    """``impl=None`` sends an int8 pool to ``gather`` (no kernel launch),
    and ``gather`` is bitwise the dense attention over the dequantized
    slab, as the dense int8 cache computes it."""
    q, k8, v8, ks, vs, tables, lengths = _pools(6)
    t = torch.from_numpy
    kq = PagedKVQuant(t(k8), t(ks), torch.float32)
    vq = PagedKVQuant(t(v8), t(vs), torch.float32)
    args = dict(page_tables=t(tables), lengths=t(lengths))
    launches = paged_attention.launches
    auto = paged_attention(t(q), kq, vq, **args)
    assert paged_attention.launches == launches
    assert torch.equal(auto, paged_attention(t(q), kq, vq, impl="gather",
                                             **args))
    kd = (gather_dense(t(k8), t(tables)).float()
          * gather_dense(t(ks), t(tables)))
    vd = (gather_dense(t(v8), t(tables)).float()
          * gather_dense(t(vs), t(tables)))
    dense = dot_product_attention(t(q), kd, vd, causal=True,
                                  q_offset=t(lengths))
    assert torch.equal(auto, dense)


def test_paged_int8_write_matches_jax():
    """The paged int8 write: W new entries per row through the page
    table, one row dropped, payloads integer-equal to the JAX pools'."""
    rng = np.random.default_rng(7)
    P1 = B * N + 1
    tables = (np.arange(B * N).reshape(B, N) + 1).astype(np.int32)
    new_k = rng.standard_normal((B, W, HKV, D)).astype(np.float32)
    new_v = rng.standard_normal((B, W, HKV, D)).astype(np.float32)
    wp = np.array([0, 5, 13], np.int32)
    keep = np.array([True, False, True])
    jpools = []
    for new in (new_k, new_v):
        q8, s = jax_q8_rows(jnp.asarray(new))
        args = (jnp.asarray(tables), jnp.asarray(wp), jnp.asarray(keep))
        jpools.append(np.asarray(jax_paged_write(
            jnp.zeros((P1, PS, HKV, D), jnp.int8), q8, *args)))
        jpools.append(np.asarray(jax_paged_write(
            jnp.zeros((P1, PS, HKV, 1), jnp.float32), s, *args)))
    layer = (torch.zeros(P1, PS, HKV, D, dtype=torch.int8),
             torch.zeros(P1, PS, HKV, D, dtype=torch.int8),
             torch.zeros(P1, PS, HKV, 1), torch.zeros(P1, PS, HKV, 1))
    view = PagedView(page_tables=torch.from_numpy(tables),
                     keep=torch.from_numpy(keep), page_size=PS)
    k, v, off = decode_cache(layer, torch.from_numpy(new_k),
                             torch.from_numpy(new_v),
                             write_pos=torch.from_numpy(wp), paged=view)
    assert isinstance(k, PagedKVQuant) and k.dtype == torch.float32
    jk, jks, jv, jvs = jpools
    np.testing.assert_array_equal(k.pages.numpy(), jk)
    np.testing.assert_array_equal(v.pages.numpy(), jv)
    assert_close(k.scale, jks, 1e-7, "k scales")
    assert_close(v.scale, jvs, 1e-7, "v scales")
    assert not k.pages[tables[1]].any()     # the dropped row wrote nothing


def _gpt2(**kw):
    cfg = GPT2Config(vocab_size=97, n_positions=64, hidden_size=32,
                     num_layers=2, num_heads=2, dropout_rate=0.0, **kw)
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(0))
    return model.requires_grad_(False)


def test_paged_int8_streams_equal_dense_int8():
    """The same int8 model, greedy and sampled, through the paged and the
    dense engine tick and the solo ``generate`` over the dense int8
    cache: one stream each."""
    model = _gpt2(kv_cache_quantize="int8")
    rng = np.random.default_rng(8)
    reqs = [Request(rng.integers(1, 97, size=int(rng.integers(3, 20))), 10,
                    temperature=0.8 if i % 2 else 0.0, seed=50 + i,
                    request_id=f"q{i}") for i in range(4)]
    streams = {}
    for mode in ("paged", "dense"):
        engine = ServeEngine(model, EngineConfig(
            num_slots=2, max_len=48, prefill_chunk=8, page_size=8,
            decode_mode=mode), device="cpu")
        hs = [engine.submit(r) for r in reqs]
        engine.run_until_drained()
        assert all(h.status is RequestStatus.COMPLETED for h in hs)
        streams[mode] = [h.tokens for h in hs]
        # the int8 pool's byte accounting prices the gather it runs
        assert engine.decode_gather_bytes > 0
    assert streams["paged"] == streams["dense"]
    for r, toks in zip(reqs, streams["paged"]):
        gen = (torch.Generator().manual_seed(r.seed)
               if r.temperature > 0 else None)
        out = generate(model, r.prompt_ids[None], max_new_tokens=10,
                       temperature=r.temperature, generator=gen,
                       device="cpu")
        assert toks == out[0, r.prompt_len:].tolist(), r.request_id


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_frame_bytes_and_signature_match_jax(quantize):
    jcfg = JaxGPT2Config(vocab_size=97, n_positions=64, hidden_size=32,
                         num_layers=2, num_heads=2, dropout_rate=0.0,
                         kv_cache_quantize=quantize)
    jmodel = JaxGPT2(jcfg)
    with use_policy(JaxPolicy(compute_dtype=jnp.float32)):
        params = jmodel.init(jax.random.key(0),
                             jnp.zeros((1, 8), jnp.int32))["params"]
        jpool = jax_kv_slots.init_page_cache(jmodel, params, 6, 8)
    pool = init_page_cache(_gpt2(kv_cache_quantize=quantize), 6, 8)
    assert frame_signature(pool, 8) == jax_kv_slots.frame_signature(jpool, 8)
    assert frame_nbytes(pool) == jax_kv_slots.frame_nbytes(jpool)
    assert frame_f32_nbytes(pool) == jax_kv_slots.frame_f32_nbytes(jpool)
    head_dim = 16
    ratio = frame_nbytes(pool) / frame_f32_nbytes(pool)
    want = 1.0 if quantize is None else (1 + 4 / head_dim) / 4
    assert ratio == pytest.approx(want)
    # the codec's bytes are the JAX layout: equal for equal contents
    rng = np.random.default_rng(9)
    for layer in pool:
        for buf in layer:
            src = rng.integers(-100, 100, size=tuple(buf.shape))
            buf.copy_(torch.from_numpy(src).to(buf.dtype))
    jpool = jax.tree_util.tree_map_with_path(
        lambda path, leaf: _stacked(pool, path, leaf), jpool)
    pages = [4, 1, 6]
    np.testing.assert_array_equal(
        jax_kv_slots.extract_frames(jpool, pages),
        extract_frames(pool, pages))


def _stacked(pool, path, leaf):
    """The JAX pool's scan-stacked leaf holding the port pool's buffers
    of the same name, layer by layer."""
    name = getattr(path[-1], "key", None)
    names = CACHE_NAMES[len(pool[0])]
    if name not in names:
        return leaf
    i = names.index(name)
    return jnp.asarray(np.stack([layer[i].numpy() for layer in pool]))

