"""The PyTorch port's GPT-2 (pytorch_distributed_tpu_torch/models/gpt2.py)
held against the JAX package's on the same weights.

Weights come from a JAX init and are carried across by
``interop.gpt2_params_from_jax``, for both the scan-stacked and the
unrolled JAX layouts. Both sides compute in f32 (the JAX model under an
f32 ``Policy``, the port under ``Policy.full()``); outputs agree to
RTOL times their largest magnitude: the frameworks sum in different
orders (and flax's LayerNorm takes E[x^2] - E[x]^2 where torch's takes
E[(x - mean)^2]), nothing more.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.data.packing import (
    pack_documents as jax_pack_documents,
)
from pytorch_distributed_tpu.models.gpt2 import (
    GPT2Config as JaxGPT2Config,
    GPT2LMHead as JaxGPT2,
)
from pytorch_distributed_tpu.ops import attention as jax_attn_mod
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu_torch.interop import gpt2_params_from_jax
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.runtime.precision import Policy

RTOL = 1e-5
F32 = JaxPolicy(compute_dtype=jnp.float32)


@pytest.fixture(scope="module", params=[True, False],
                ids=["scanned", "unrolled"])
def pair(request):
    """(JAX model, its params, the port model on the same weights)."""
    jcfg = dataclasses.replace(JaxGPT2Config.tiny(), scan_layers=request.param)
    jmodel = JaxGPT2(jcfg)
    with use_policy(F32):
        params = jmodel.init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32)
        )["params"]
    params = jax.device_get(params)
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu", policy=Policy.full())
    model.load_state_dict(gpt2_params_from_jax(params, GPT2Config.tiny()))
    return jmodel, params, model


def _close(out, ref, what):
    out, ref = np.asarray(out), np.asarray(ref)
    tol = RTOL * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol, err_msg=what)


def _packed(seed=0, S=32, rows=2):
    """Packed rows from seeded document lengths (the JAX packer's output,
    which tests/test_torch_train.py pins integer-equal to the port's)."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 512, size=int(n)) for n in
            rng.integers(3, 20, size=6)]
    packed = jax_pack_documents(docs, S)
    return {k: v[:rows] for k, v in packed.items()}


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_logits_and_hidden_match_jax(pair, attn_impl):
    jmodel, params, model = pair
    ids = np.random.default_rng(0).integers(0, 512, size=(2, 24))
    with use_policy(F32):
        ref = jmodel.apply({"params": params}, jnp.asarray(ids, jnp.int32))
        ref_h = jmodel.apply({"params": params}, jnp.asarray(ids, jnp.int32),
                             return_hidden=True)
    with torch.no_grad():
        out = model(torch.from_numpy(ids), attn_impl=attn_impl)
        hid = model(torch.from_numpy(ids), return_hidden=True,
                    attn_impl=attn_impl)
    assert out.dtype == torch.float32 and out.shape == (2, 24, 512)
    assert hid.shape == (2, 24, 64)
    _close(out.numpy(), ref, "logits")
    _close(hid.numpy(), ref_h, "hidden")


@pytest.mark.parametrize("jax_impl", ["xla", "flash"])
def test_packed_rows_match_jax(pair, jax_impl, monkeypatch):
    """Packed rows (segment_ids + per-document positions) through the
    JAX model's einsum path and its Pallas flash kernel (interpret mode;
    the dispatcher flag is patched, not set, so no jit cache is cleared)
    against the port's flash path."""
    jmodel, params, model = pair
    monkeypatch.setattr(jax_attn_mod, "_IMPL", jax_impl)
    packed = _packed()
    with use_policy(F32):
        ref = jmodel.apply(
            {"params": params}, jnp.asarray(packed["input_ids"]),
            jnp.asarray(packed["positions"]),
            segment_ids=jnp.asarray(packed["segment_ids"]),
        )
    with torch.no_grad():
        out = model(
            torch.from_numpy(packed["input_ids"]),
            torch.from_numpy(packed["positions"]),
            segment_ids=torch.from_numpy(packed["segment_ids"]),
            attn_impl="flash",
        )
    _close(out.numpy(), ref, f"packed rows vs JAX {jax_impl}")


def test_train_policy_keeps_f32_weights_and_bf16_products(pair):
    """Policy.train(): f32 parameters, f32 logits, bf16 products: within
    bf16 rounding (2^-8 relative, a few roundings deep) of the f32
    model."""
    _, _, full = pair
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu", policy=Policy.train())
    model.load_state_dict(full.state_dict())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 16)))
    with torch.no_grad():
        out, ref = model(ids), full(ids)
    assert out.dtype == torch.float32
    err = (out - ref).abs().max().item()
    assert err <= 5e-2 * ref.abs().max().item(), err


def test_seeded_init_follows_flax_initializers():
    # small's widths, one layer and a short vocab (the statistics only
    # need enough draws per tensor)
    cfg = dataclasses.replace(GPT2Config.small(), num_layers=1,
                              vocab_size=4096)
    a = GPT2LMHead(cfg, device="cpu", policy=Policy.train()).init_weights(
        torch.Generator().manual_seed(3)
    )
    b = GPT2LMHead(cfg, device="cpu", policy=Policy.train()).init_weights(
        torch.Generator().manual_seed(3)
    )
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    D = cfg.hidden_size
    blk = a.blocks[0]
    # lecun normal: std 1/sqrt(fan_in), truncated at 2 std
    for dense, fan_in in ((blk.attn_qkv, D), (blk.mlp_down, 4 * D)):
        w = dense.weight
        assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.02
        assert w.abs().max().item() <= 2.0 / (fan_in ** 0.5 * 0.8796) + 1e-6
        assert torch.count_nonzero(dense.bias) == 0
    assert abs(a.wte.weight.std().item() * D ** 0.5 - 1.0) < 0.02
    assert torch.equal(blk.ln1.weight, torch.ones(D))


def test_refuses_what_is_not_ported():
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="write_pos"):
        model(ids, decode=True)   # decode takes explicit write_pos/positions
    # mixture-of-experts FFNs are ported (tests/test_torch_moe.py): the
    # block holds experts in place of the dense MLP
    moe = GPT2LMHead(dataclasses.replace(GPT2Config.tiny(), moe_experts=4),
                     device="cpu")
    assert hasattr(moe.blocks[0], "moe")
    assert not hasattr(moe.blocks[0], "mlp_up")
    with pytest.raises(ValueError, match="n_positions"):
        model(torch.zeros(1, 65, dtype=torch.long))
    with pytest.raises(ValueError, match="generator"):
        model(ids, train=True)
