"""Rematerialization (``models/scan.py``, ``GPT2Config.remat``) in the
port: each block under non-reentrant ``torch.utils.checkpoint``, the
dropout generator replayed in the recompute.

* Port against port, dropout on, every policy (``full``, ``dots``,
  ``dots_no_batch``), einsum attention and the flash path's plain
  version: the gradients with remat equal those without to the bit, and
  the generator ends, after the forward and after the backward, where a
  run without remat leaves it. Without the replay the recompute would
  draw other masks: the test also shows that such a recompute would
  differ.
* The port with remat against the JAX package's ``remat=True`` model on
  converted weights, dropout off, f32: loss within 1e-5 and gradients
  within 1e-4 of the largest magnitude (``tests/test_torch_train.py``'s
  limits for the same model without remat).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models.gpt2 import (
    GPT2Config as JaxGPT2Config,
    GPT2LMHead as JaxGPT2,
)
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train.losses import (
    causal_lm_loss_fn as jax_loss_fn,
)
from pytorch_distributed_tpu_torch.interop import (
    gpt2_params_from_jax,
    gpt2_params_to_jax,
)
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.models.scan import remat_call, remat_policy
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.runtime.prng import generator_for
from pytorch_distributed_tpu_torch.train import causal_lm_loss_fn
from tests.torch_parity import assert_close

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
F32 = JaxPolicy(compute_dtype=jnp.float32)
POLICIES = ("full", "dots", "dots_no_batch")


def _model(remat, policy="full", dropout=0.1, seed=0):
    cfg = dataclasses.replace(GPT2Config.tiny(), remat=remat,
                              remat_policy=policy, dropout_rate=dropout)
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def _ids(seed=1, B=2, S=24):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 512, (B, S)))


def _grads_and_states(model, ids, attn_impl, chunk=None):
    gen = generator_for(3, 7, "cpu")
    loss_fn = causal_lm_loss_fn(model, vocab_chunk_size=chunk,
                                attn_impl=attn_impl)
    loss, _ = loss_fn({"input_ids": ids}, gen)
    after_fwd = gen.get_state().clone()
    loss.backward()
    return ([p.grad.clone() for p in model.parameters()], loss.item(),
            after_fwd, gen.get_state().clone())


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gradients_equal_no_remat_with_dropout(policy, attn_impl):
    ids = _ids()
    ref = _grads_and_states(_model(False), ids, attn_impl)
    got = _grads_and_states(_model(True, policy), ids, attn_impl)
    assert got[1] == ref[1]
    assert all(torch.equal(a, b) for a, b in zip(got[0], ref[0]))
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])


def test_remat_with_the_chunked_loss_equals_no_remat():
    ids = _ids(seed=4)
    ref = _grads_and_states(_model(False), ids, "xla", chunk=100)
    got = _grads_and_states(_model(True), ids, "xla", chunk=100)
    assert all(torch.equal(a, b) for a, b in zip(got[0], ref[0]))
    assert torch.equal(got[3], ref[3])


def test_a_recompute_without_the_replay_would_draw_other_masks():
    """What the snapshot guards against: a block recomputed from the live
    generator (advanced by the forward) draws other dropout masks."""
    model = _model(False)
    block = model.blocks[0]
    x = torch.randn(2, 8, 64)
    gen = torch.Generator().manual_seed(0)
    a = block(x, None, train=True, generator=gen)
    b = block(x, None, train=True, generator=gen)
    assert not torch.equal(a, b)
    gen = torch.Generator().manual_seed(0)
    c = remat_call(block, x.requires_grad_(), None, train=True,
                   generator=gen, policy="full")
    assert torch.equal(c, a)
    state = gen.get_state().clone()
    c.sum().backward()   # the recompute runs here, replaying the masks
    assert torch.equal(gen.get_state(), state)


def test_policy_names():
    assert remat_policy(None) is None and remat_policy("full") is None
    assert callable(remat_policy("dots"))
    assert callable(remat_policy("dots_no_batch"))
    with pytest.raises(ValueError, match="remat_policy"):
        remat_policy("everything")


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_jax_remat(policy):
    jcfg = dataclasses.replace(JaxGPT2Config.tiny(), dropout_rate=0.0,
                               remat=True, remat_policy=policy)
    jmodel = JaxGPT2(jcfg)
    with use_policy(F32):
        params = jax.device_get(jmodel.init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    ids = np.random.default_rng(2).integers(0, 512, (2, 24)).astype(np.int32)
    fn = jax_loss_fn(jmodel)
    with use_policy(F32):
        (want, _), grads = jax.value_and_grad(
            lambda p: fn(p, None, {"input_ids": jnp.asarray(ids)},
                         jax.random.key(0)), has_aux=True)(params)
    cfg = dataclasses.replace(GPT2Config.tiny(), dropout_rate=0.0,
                              remat=True, remat_policy=policy)
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    model.load_state_dict(gpt2_params_from_jax(params, cfg))
    loss, _ = causal_lm_loss_fn(model)({"input_ids": torch.from_numpy(ids)},
                                       None)
    loss.backward()
    assert_close(loss.item(), float(want), LOSS_RTOL, "loss")
    got = gpt2_params_to_jax({n: p.grad for n, p in model.named_parameters()},
                             cfg)
    jgrads = jax.device_get(grads)

    def walk(a, b, path=""):
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert_close(a[k], np.asarray(b[k]), GRAD_RTOL, path + k)

    walk(got, jgrads)
