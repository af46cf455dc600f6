"""The port's ``GradScaler`` held against the JAX one, and the fp16 train
step's skip held against the JAX ``build_train_step(scaler=...)``.

* The scale, growth tracker and finite flag over a scripted sequence of
  finite and non-finite gradients (inf, NaN, and a finite 1e30 that
  must count as finite) equal the JAX ones exactly, at a small growth
  interval and the default one.
* bf16 mode is the identity, and the eager torch-shaped methods refuse
  in fp16 mode, as the JAX ones do.
* Four steps of a tiny BERT classifier, the second with an inf injected
  into the loss: every gradient is non-finite, the scale halves, the
  optimizer does not step (parameters, AdamW moments and torch's
  per-parameter ``step``, which is optax's count, bitwise as they were)
  while ``state.step`` advances, and the fourth step grows the scale
  back (growth interval 2). Under ``Policy.full()`` products (the scaler
  still fp16's) every step is held to the JAX step: loss within 1e-5,
  each leaf's update within 2e-2 of its norm (Adam divides by
  |g| + 1e-8, so an entry whose gradient is near 1e-8 steps by its
  rounding noise: the key projection's bias, whose gradient is exactly
  zero, is left out), moments within 1e-4 of their largest entry. Under
  fp16 products the skip and the scaler state are held exactly and the
  loss within 1e-3 (``tests/test_torch_bert.py``'s fp16 loss limit).
* Over gloo at world 2 (ranks from ``tests/torch_bert_workers.py``): an
  inf on one rank's share reaches both through DDP's all-reduce, both
  skip, and their scaler states and parameters stay equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models import bert as jbert
from pytorch_distributed_tpu.optim import AdamW as JaxAdamW
from pytorch_distributed_tpu.optim import DEFAULT_NO_DECAY as JAX_NO_DECAY
from pytorch_distributed_tpu.runtime.precision import (
    GradScaler as JaxGradScaler,
    Policy as JaxPolicy,
    ScalerState as JaxScalerState,
    use_policy as jax_policy,
)
from pytorch_distributed_tpu.train import (
    TrainState as JaxTrainState,
    build_train_step as jax_build_train_step,
    text_classification_loss_fn as jax_text_loss,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.interop import (
    bert_params_from_jax,
    bert_params_to_jax,
)
from pytorch_distributed_tpu_torch.models import bert as tbert
from pytorch_distributed_tpu_torch.runtime.precision import (
    GradScaler,
    Policy,
    ScalerState,
)
from pytorch_distributed_tpu_torch.train import (
    TrainState,
    build_train_step,
    text_classification_loss_fn,
)
from tests import torch_bert_workers as bert_workers
from tests import torch_dp_workers as workers
from tests.torch_bert_workers import poisoned_loss
from tests.torch_parity import assert_close

# per step: the gradients' kind ("ok", "inf", "nan", "big": a finite 1e30)
SCRIPT = ("ok", "ok", "ok", "ok", "inf", "ok", "nan", "ok", "ok", "big",
          "ok", "inf", "inf", "ok", "ok", "ok")


def _grads(kind, seed):
    rng = np.random.default_rng(seed)
    g = [rng.normal(size=(3, 4)).astype(np.float32),
         rng.normal(size=(5,)).astype(np.float32)]
    if kind != "ok":
        g[1][2] = {"inf": np.inf, "nan": np.nan, "big": 1e30}[kind]
    return g


@pytest.mark.parametrize("interval", [3, 2000])
def test_trajectory_equals_jax(interval):
    kw = dict(init_scale=2.0 ** 15, growth_factor=2.0, backoff_factor=0.5,
              growth_interval=interval, dtype=jnp.float16)
    jscaler = JaxGradScaler(**kw)
    scaler = GradScaler(**dict(kw, dtype=torch.float16))
    jstate, state = jscaler.init_state(), scaler.init_state()
    assert state.scale.dtype == torch.float32
    assert state.growth_tracker.dtype == torch.int32
    grew = backed_off = 0
    for i, kind in enumerate(SCRIPT):
        g = _grads(kind, i)
        jstate, jok = jscaler.functional_update(
            [jnp.asarray(a) for a in g], jstate)
        prev = float(state.scale)
        state, ok = scaler.functional_update(
            [torch.from_numpy(a) for a in g], state)
        assert bool(ok) == bool(jok) == (kind in ("ok", "big")), (i, kind)
        assert float(state.scale) == float(jstate.scale), i
        assert int(state.growth_tracker) == int(jstate.growth_tracker), i
        assert state.scale.dtype == torch.float32
        assert state.growth_tracker.dtype == torch.int32
        grew += float(state.scale) > prev
        backed_off += float(state.scale) < prev
    assert backed_off == 4 and grew == (3 if interval == 3 else 0)


def test_scale_and_unscale_equal_jax():
    jscaler = JaxGradScaler(init_scale=2.0 ** 12, dtype=jnp.float16)
    scaler = GradScaler(init_scale=2.0 ** 12, dtype=torch.float16)
    g = _grads("ok", 0)
    want = jscaler.unscale_grads([jnp.asarray(a) for a in g],
                                 jscaler.init_state())
    got = scaler.unscale_grads([torch.from_numpy(a.copy()) for a in g],
                               scaler.init_state())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    loss = scaler.scale_value(torch.tensor(1.5), scaler.init_state())
    assert float(loss) == float(jscaler.scale_value(
        jnp.float32(1.5), jscaler.init_state())) == 1.5 * 2 ** 12


def test_bf16_is_an_exact_no_op_and_fp16_refuses_eager_calls():
    scaler = GradScaler()   # bf16
    assert not scaler.enabled and scaler.init_state() is None
    loss = torch.tensor(2.0)
    assert scaler.scale_value(loss, None) is loss
    g = [torch.ones(3)]
    assert scaler.unscale_grads(g, None) is g
    state, ok = scaler.functional_update(g, None)
    assert state is None and bool(ok)
    assert scaler.scale(loss) is loss and scaler.get_scale() == 1.0
    assert scaler.step(lambda x: x + 1, 1) == 2
    fp16 = GradScaler(dtype=torch.float16)
    for call in (lambda: fp16.scale(loss), lambda: fp16.unscale_(g),
                 lambda: fp16.step(lambda: None), fp16.update,
                 fp16.get_scale):
        with pytest.raises(RuntimeError, match="functional"):
            call()
    with pytest.raises(ValueError, match="scaler_state"):
        build_train_step(lambda b, g: (None, {}), scaler=fp16)(
            TrainState(torch.nn.Linear(2, 2), None), {})


POLICIES = {
    "full": (JaxPolicy(compute_dtype=jnp.float32), Policy.full()),
    "fp16": (JaxPolicy(compute_dtype=jnp.float16), Policy.fp16()),
}
B, S = 4, 24
STEPS, POISONED = 4, 1
LR = 1e-3


def _batches():
    rng = np.random.default_rng(3)
    out = []
    for i in range(STEPS):
        out.append({
            "input_ids": rng.integers(0, 1024, (B, S)).astype(np.int32),
            "attention_mask": np.arange(S)[None] < rng.integers(
                8, S + 1, (B, 1)),
            "label": rng.integers(0, 2, (B,)).astype(np.int32),
            "poison": np.full((B,), np.inf if i == POISONED else 1.0,
                              np.float32),
        })
    return out


def _jax_poisoned(loss_fn):
    def fn(params, batch_stats, batch, rng):
        loss, aux = loss_fn(params, batch_stats, batch, rng)
        return loss * jnp.max(batch["poison"]), aux
    return fn


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_fp16_step_skips_as_the_jax_step(policy):
    jpol, tpol = POLICIES[policy]
    jcfg = dataclasses.replace(jbert.BertConfig.tiny(), dropout_rate=0.0)
    tcfg = dataclasses.replace(tbert.BertConfig.tiny(), dropout_rate=0.0)
    jmodel = jbert.BertForSequenceClassification(jcfg)
    with jax_policy(jpol):
        params = jax.device_get(jmodel.init(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    sk = dict(init_scale=2.0 ** 10, growth_interval=2)
    jscaler = JaxGradScaler(dtype=jnp.float16, **sk)
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=params,
        tx=JaxAdamW(LR, weight_decay=0.01, no_decay=JAX_NO_DECAY),
        scaler_state=jscaler.init_state())
    with jax_policy(jpol):
        jstep = jax.jit(jax_build_train_step(
            _jax_poisoned(jax_text_loss(jmodel)), scaler=jscaler))
    model = tbert.BertForSequenceClassification(tcfg, device="cpu",
                                                policy=tpol)
    model.load_state_dict(bert_params_from_jax(params, tcfg))
    opt = optim.AdamW(model, lr=LR, weight_decay=0.01,
                      no_decay=optim.DEFAULT_NO_DECAY)
    scaler = GradScaler(dtype=torch.float16, **sk)
    state = TrainState(model, opt, policy=tpol,
                       scaler_state=scaler.init_state("cpu"))
    step = build_train_step(poisoned_loss(text_classification_loss_fn(model)),
                            scaler=scaler)
    for i, batch in enumerate(_batches()):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        moments = {id(p): {k: v.clone() for k, v in s.items()}
                   for p, s in opt.state.items()}
        jbefore = dict(_flat(bert_params_to_jax(
            model.state_dict(), tcfg)))
        with jax_policy(jpol):
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        finite = i != POISONED
        assert float(m["grads_finite"]) == float(jm["grads_finite"]) == finite
        assert float(state.scaler_state.scale) == float(
            jstate.scaler_state.scale) == float(m["loss_scale"])
        assert int(state.scaler_state.growth_tracker) == int(
            jstate.scaler_state.growth_tracker)
        assert state.step == int(jstate.step) == i + 1
        counts = {int(s["step"]) for s in opt.state.values()}
        assert counts == {int(jstate.opt_state[0].count)}, i
        if not finite:
            assert float(state.scaler_state.scale) == 2.0 ** 9
            for n, p in model.named_parameters():
                assert torch.equal(p, before[n]), n
            for p, s in opt.state.items():
                for k, v in s.items():
                    assert torch.equal(v, moments[id(p)][k]), k
            continue
        if policy == "fp16":
            assert_close(float(m["loss"]), float(jm["loss"]), 1e-3, "loss")
            continue
        assert_close(float(m["loss"]), float(jm["loss"]), 1e-5, "loss")
        got = dict(_flat(bert_params_to_jax(model.state_dict(), tcfg)))
        want = dict(_flat(jax.device_get(jstate.params)))
        for path, arr in got.items():
            if path.endswith("attn/key/bias"):
                continue
            ref = want[path].astype(np.float64) - jbefore[path]
            err = np.linalg.norm(arr - jbefore[path] - ref)
            assert err <= 2e-2 * np.linalg.norm(ref), (path, i, err)
        mu = dict(_flat(jax.device_get(jstate.opt_state[0].mu)))
        got_mu = dict(_flat(bert_params_to_jax(
            {n: opt.state[p]["exp_avg"] for n, p in
             model.named_parameters()}, tcfg)))
        for path, arr in got_mu.items():
            if not path.endswith("attn/key/bias"):
                assert_close(arr, mu[path], 1e-4, f"mu {path}")
    assert float(state.scaler_state.scale) == 2.0 ** 10   # grew back


def test_world2_both_ranks_skip_an_inf_on_one():
    ranks = workers.spawn(bert_workers.scaler_skip, 2)
    for i in range(bert_workers.SCALER_STEPS):
        r0, r1 = ranks[0][i], ranks[1][i]
        finite = i != bert_workers.POISONED_STEP
        for r in (r0, r1):
            assert r["finite"] == float(finite), (i, r["finite"])
            assert r["step"] == i + 1
            assert r["count"] == [i + 1 - (i >= bert_workers.POISONED_STEP)]
        assert (r0["scale"], r0["tracker"]) == (r1["scale"], r1["tracker"])
        for n in r0["params"]:
            np.testing.assert_array_equal(r0["params"][n], r1["params"][n],
                                          err_msg=n)
        if not finite:
            prev = ranks[0][i - 1]["params"]
            for n, p in r0["params"].items():
                np.testing.assert_array_equal(p, prev[n], err_msg=n)
    scales = [r["scale"] for r in ranks[0]]
    assert scales == [2.0 ** 10, 2.0 ** 9, 2.0 ** 9, 2.0 ** 10]


def test_scaler_state_is_two_device_scalars():
    state = GradScaler(dtype=torch.float16).init_state("cpu")
    assert isinstance(state, ScalerState)
    assert state.scale.shape == () and state.growth_tracker.shape == ()
    jstate = JaxGradScaler(dtype=jnp.float16).init_state()
    assert isinstance(jstate, JaxScalerState)
    assert float(state.scale) == float(jstate.scale) == 2.0 ** 15
