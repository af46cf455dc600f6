"""The PyTorch port's Llama (pytorch_distributed_tpu_torch/models/llama.py)
held against the JAX package's on the same weights.

Weights come from a JAX init and are carried across by
``interop.llama_params_from_jax``, for both the scan-stacked and the
unrolled JAX layouts. Both sides compute in f32 (the JAX model under an
f32 ``Policy``); logits agree to RTOL times their largest magnitude:
the frameworks sum in different orders and their cos/sin differ by an
ulp, nothing more.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
    RopeScaling as JaxRopeScaling,
)
from pytorch_distributed_tpu.ops.attention import (
    rope_frequencies as jax_rope_frequencies,
)
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu_torch.interop import llama_params_from_jax
from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    RopeScaling,
)
from pytorch_distributed_tpu_torch.ops.attention import rope_frequencies
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.serve.kv_slots import init_page_cache

RTOL = 1e-5
F32 = JaxPolicy(compute_dtype=jnp.float32)


@pytest.fixture(scope="module", params=[True, False],
                ids=["scanned", "unrolled"])
def pair(request):
    """(JAX model, its params, the port model on the same weights) for
    the scan-stacked and the unrolled JAX layouts."""
    jcfg = dataclasses.replace(
        JaxLlamaConfig.tiny(), scan_layers=request.param
    )
    jmodel = JaxLlama(jcfg)
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


def _close(out, ref, what):
    out = np.asarray(out)
    ref = np.asarray(ref)
    tol = RTOL * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol, err_msg=what)


def test_forward_logits_match_jax(pair):
    jmodel, params, model = pair
    ids = np.random.default_rng(0).integers(0, 512, size=(2, 24))
    with use_policy(F32):
        ref = jmodel.apply({"params": params}, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        out = model(torch.from_numpy(ids))
    assert out.dtype == torch.float32 and out.shape == (2, 24, 512)
    _close(out.numpy(), ref, "full forward")


def test_forward_attn_impl_picks_flash_or_einsum(pair):
    """``attn_impl`` reaches every layer: the plain flash version (GQA
    4:2, causal) and the einsum path both give JAX's logits."""
    jmodel, params, model = pair
    ids = np.random.default_rng(1).integers(0, 512, size=(2, 40))
    with use_policy(F32):
        ref = jmodel.apply({"params": params}, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        for impl in ("flash", "xla"):
            out = model(torch.from_numpy(ids), attn_impl=impl)
            _close(out.numpy(), ref, f"attn_impl={impl}")
    with pytest.raises(ValueError, match="unknown attention impl"):
        model(torch.from_numpy(ids), attn_impl="pallas")


def test_chunked_prefill_and_decode_match_jax(pair):
    """Two 8-token prefill chunks at per-row write positions, then two
    single-token decode ticks, through both models' KV caches."""
    jmodel, params, model = pair
    rng = np.random.default_rng(1)
    B, T = 2, 32
    steps = [(0, rng.integers(0, 512, size=(B, 8))),
             (8, rng.integers(0, 512, size=(B, 8)))]
    steps += [(16 + t, rng.integers(0, 512, size=(B, 1))) for t in range(2)]
    apply = jax.jit(
        lambda v, ids, pos, wp: jmodel.apply(
            v, ids, decode=True, cache_len=T, mutable=["cache"],
            positions=pos, write_pos=wp,
        )
    )
    jcache, cache = None, None
    for start, ids in steps:
        S = ids.shape[1]
        pos = np.broadcast_to(start + np.arange(S), (B, S))
        wp = np.full((B,), start, np.int32)
        variables = {"params": params}
        if jcache is not None:
            variables["cache"] = jcache
        with use_policy(F32):
            ref, state = apply(
                variables, jnp.asarray(ids, jnp.int32), jnp.asarray(pos),
                jnp.asarray(wp),
            )
        jcache = state["cache"]
        with torch.no_grad():
            out, cache = model(
                torch.from_numpy(ids), torch.from_numpy(pos.copy()),
                cache=cache, write_pos=torch.from_numpy(wp), decode=True,
                cache_len=T,
            )
        _close(out.numpy(), ref, f"step at {start}")


def test_rope_llama3_scaling_matches_jax():
    cos, sin = rope_frequencies(64, 200, 500_000.0, scaling=RopeScaling())
    jcos, jsin = jax_rope_frequencies(
        64, 200, 500_000.0, scaling=JaxRopeScaling()
    )
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=2e-6)


def test_seeded_init_is_reproducible_and_refuses_int8_kv():
    a = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").init_weights(
        torch.Generator().manual_seed(3)
    )
    b = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").init_weights(
        torch.Generator().manual_seed(3)
    )
    assert a.embed.weight.dtype == torch.bfloat16  # the serving policy
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    # the int8 cache, dense and paged: int8 payloads with f32 per-token
    # scale pools, a page pool zeroed as the JAX one is
    q = LlamaForCausalLM(
        dataclasses.replace(LlamaConfig.tiny(), kv_cache_quantize="int8"),
        device="cpu",
    )
    assert q.init_cache(1, 4)[0][0].dtype == torch.int8
    pool = init_page_cache(q, 4, 8)
    assert [b.dtype for b in pool[0]] == [torch.int8] * 2 + [torch.float32] * 2
    assert tuple(pool[0][2].shape) == (5, 8, 2, 1)
    assert all(not b.any() for layer in pool for b in layer)
