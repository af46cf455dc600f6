"""The port's Llama in training mode held against the JAX Llama: a tiny
model (2 layers, hidden 64, 4 query heads over 2 KV heads, vocab 512)
on weights carried from a JAX init (``llama_params_from_jax``), the same
seeded numpy batches on both sides.

Two policies. ``train`` is ``Policy.train()`` on both sides: f32
parameters, bf16 products, f32 logits and loss. The two frameworks'
bf16 products round the same f32 sums, but their CPU kernels add in
another order, so an entry can land one bf16 step (2^-8 of itself)
apart, and the difference travels through the layers: limits relative
to the reference's largest magnitude, 2e-2 for logits and hidden
states, 5e-3 for the loss (a mean over every token), 5e-2 for the
gradients (the flash path rounds P to bf16 against its running maximum
where the JAX einsum rounds the f32 softmax once, and the norms' scale
gradients sum such products over every token: 2.3e-2 read here; a wrong
gradient reads ~1). ``full`` is
f32 everywhere, where the two differ in summation order only: 1e-5 for
logits, hidden states and the loss, 1e-4 for gradients. The JAX side
runs its own attention dispatch (the einsum path on the CPU); the port
runs its einsum path and, for the loss, the plain version of its flash
kernels (``attn_impl="flash"``: the blocked forward, dq and dkv that the
card's kernels replace), with GQA and packed rows. Remat is held
port-against-port, to the bit: each policy recomputes the same ops on
the same inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu.data.packing import (
    pack_documents as jax_pack_documents,
)
from pytorch_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train import (
    TrainState as JaxTrainState,
    build_train_step as jax_build_train_step,
    causal_lm_loss_fn as jax_loss_fn,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.interop import (
    llama_params_from_jax,
    llama_params_to_jax,
)
from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import (
    TrainState,
    build_train_step,
    causal_lm_loss_fn,
)
from tests.torch_parity import assert_close

POLICIES = {
    "train": (JaxPolicy(), Policy.train()),
    "full": (JaxPolicy(compute_dtype=jnp.float32), Policy.full()),
}
RTOL = {   # (logits and hidden, loss, gradients)
    "train": (2e-2, 5e-3, 5e-2),
    "full": (1e-5, 1e-5, 1e-4),
}
CHUNK = 100   # a ragged last chunk over the 512-token vocabulary
LR = 1e-3


@pytest.fixture(scope="module")
def jax_pair():
    jmodel = JaxLlama(JaxLlamaConfig.tiny())
    with use_policy(POLICIES["full"][0]):
        params = jmodel.init(jax.random.key(0),
                             jnp.zeros((1, 8), jnp.int32))["params"]
    return jmodel, jax.device_get(params)


def _port(params, policy, **cfg_kw):
    cfg = dataclasses.replace(LlamaConfig.tiny(), **cfg_kw)
    model = LlamaForCausalLM(cfg, device="cpu", policy=policy)
    model.load_state_dict(llama_params_from_jax(params, cfg))
    return model


def _batch(seed, packed, B=4, S=24):
    rng = np.random.default_rng(seed)
    if not packed:
        return {"input_ids": rng.integers(0, 512, (B, S)).astype(np.int32)}
    docs = [rng.integers(1, 512, size=int(n))
            for n in rng.integers(2, 14, size=4 * B)]
    return {k: v[:B] for k, v in jax_pack_documents(docs, S).items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def test_f32_model_takes_the_jax_weights(jax_pair):
    _, params = jax_pair
    model = _port(params, Policy.train())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    back = llama_params_to_jax(model.state_dict(), model.config)
    for path, arr in _flat(back):
        np.testing.assert_array_equal(arr, _get(params, path), err_msg=path)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_logits_and_hidden_match_jax(jax_pair, policy, packed):
    jmodel, params = jax_pair
    jpol, tpol = POLICIES[policy]
    batch = _batch(1, packed)
    extra = {k: v for k, v in batch.items() if k != "input_ids"}
    jb = {k: jnp.asarray(v) for k, v in extra.items()}
    with use_policy(jpol):
        variables = {"params": params}
        ids = jnp.asarray(batch["input_ids"])
        want = jmodel.apply(variables, ids, train=True, **jb)
        want_h = jmodel.apply(variables, ids, train=True,
                              return_hidden=True, **jb)
    model = _port(params, tpol)
    tb = _torch(batch)
    ids = tb.pop("input_ids")
    with torch.no_grad():
        got = model(ids, train=True, **tb)
        got_h = model(ids, train=True, return_hidden=True, **tb)
    assert got.dtype == got_h.dtype == torch.float32
    rtol = RTOL[policy][0]
    assert_close(got, want, rtol, "logits")
    assert_close(got_h, want_h, rtol, "hidden")


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["full", "chunked"])
@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_loss_and_grads_match_jax(jax_pair, policy, chunk, packed, attn):
    jmodel, params = jax_pair
    jpol, tpol = POLICIES[policy]
    batch = _batch(2, packed)
    jfn = jax_loss_fn(jmodel, vocab_chunk_size=chunk)
    with use_policy(jpol):
        (want, _), grads = jax.value_and_grad(
            lambda p: jfn(p, None, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                          jax.random.key(0)),
            has_aux=True)(params)
    model = _port(params, tpol)
    loss, _ = causal_lm_loss_fn(model, vocab_chunk_size=chunk,
                                attn_impl=attn)(_torch(batch), None)
    loss.backward()
    _, loss_rtol, grad_rtol = RTOL[policy]
    assert_close(loss.item(), float(want), loss_rtol, "loss")
    port = llama_params_to_jax(
        {n: p.grad for n, p in model.named_parameters()}, model.config)
    jgrads = jax.device_get(grads)
    for path, got in _flat(port):
        assert_close(got, _get(jgrads, path), grad_rtol, path)


def _grads(model, batch, chunk):
    model.zero_grad(set_to_none=True)
    loss, _ = causal_lm_loss_fn(model, vocab_chunk_size=chunk)(batch, None)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize("remat_policy", ["full", "dots", "dots_no_batch"])
@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["full", "chunked"])
def test_remat_gradients_equal_no_remat(jax_pair, remat_policy, chunk):
    _, params = jax_pair
    batch = _torch(_batch(3, packed=True))
    plain = _port(params, Policy.train())
    remat = _port(params, Policy.train(), remat=True,
                  remat_policy=remat_policy)
    loss0, g0 = _grads(plain, batch, chunk)
    loss1, g1 = _grads(remat, batch, chunk)
    assert torch.equal(loss0, loss1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_two_steps_match_the_jax_recipe_step(jax_pair, accum_steps):
    """The JAX recipe's optimizer, clip_by_global_norm(1.0) then
    optax.adamw(lr) with its default decay 1e-4, against the port's
    clip then AdamW(weight_decay=1e-4) in f32. Each step's update of
    every leaf within 2e-2 of its norm: Adam divides by |g| + 1e-8, so an
    entry whose gradient is near 1e-8 (an embedding or head row the
    batch barely touches) steps by its rounding noise, up to lr, in one
    framework and not the other (8% of lr on one entry read here), while
    a wrong update moves the whole leaf."""
    from pytorch_distributed_tpu_torch.recipes.llama_fsdp import (
        ADAMW_WEIGHT_DECAY,
    )

    assert ADAMW_WEIGHT_DECAY == 1e-4   # optax.adamw's default
    jmodel, params = jax_pair
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                  tx=tx)
    jstep = jax.jit(jax_build_train_step(
        jax_loss_fn(jmodel, vocab_chunk_size=CHUNK), accum_steps=accum_steps))
    model = _port(params, Policy.full())
    opt = optim.clip_grad_norm(optim.AdamW(
        model, lr=LR, weight_decay=ADAMW_WEIGHT_DECAY), 1.0)
    state = TrainState(model, opt, policy=Policy.full())
    step = build_train_step(causal_lm_loss_fn(model, vocab_chunk_size=CHUNK),
                            accum_steps=accum_steps)
    for i in range(2):
        batch = _batch(10 + i, packed=i == 1)
        with use_policy(POLICIES["full"][0]):
            jstate, jmetrics = jstep(
                jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        before = dict(_flat(llama_params_to_jax(model.state_dict(),
                                                model.config)))
        state, metrics = step(state, _torch(batch))
        assert_close(float(metrics["loss"]), float(jmetrics["loss"]), 1e-5,
                     f"loss at step {i}")
        got = llama_params_to_jax(model.state_dict(), model.config)
        want = jax.device_get(jstate.params)
        for path, arr in _flat(got):
            ref = _get(want, path).astype(np.float64) - before[path]
            err = np.linalg.norm(arr - before[path] - ref)
            assert err <= 2e-2 * np.linalg.norm(ref), (path, i, err)


def test_recipe_adamw_decays_as_optax_adamw():
    """The recipe's AdamW(lr, weight_decay=ADAMW_WEIGHT_DECAY) is
    ``optax.adamw(lr)`` with its default decay, at an lr and weights
    large enough that the decay term shows (without it the parameters
    land 1e-3 away)."""
    from pytorch_distributed_tpu_torch.recipes.llama_fsdp import (
        ADAMW_WEIGHT_DECAY,
    )

    rng = np.random.default_rng(7)
    p0 = (rng.normal(size=(64, 32)) * 20).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(2)]
    tx = optax.adamw(0.5)
    jp, jst = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g in grads:
        upd, jst = tx.update(jnp.asarray(g), jst, jp)
        jp = optax.apply_updates(jp, upd)

    def port(decay):
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = optim.AdamW([p], lr=0.5, weight_decay=decay)
        for g in grads:
            p.grad = torch.from_numpy(g)
            opt.step()
        return p.detach().numpy()

    assert_close(port(ADAMW_WEIGHT_DECAY), np.asarray(jp), 1e-6, "adamw")
    assert np.abs(port(0.0) - np.asarray(jp)).max() > 1e-3


def test_training_mode_refusals(jax_pair):
    _, params = jax_pair
    model = _port(params, Policy.train())
    ids = torch.zeros(2, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="kv_mask is for KV-cache decode"):
        model(ids, kv_mask=torch.ones(2, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match="mutually exclusive"):
        model(ids, segment_ids=torch.ones(2, 8, dtype=torch.long),
              decode=True, write_pos=torch.zeros(2, dtype=torch.long),
              positions=torch.zeros(2, 8, dtype=torch.long))
