"""Every optimizer, schedule and wrapper of the JAX package's
``optim.py`` against its port (``pytorch_distributed_tpu_torch.optim``),
on the same seeded numpy parameters and gradients.

* Optimizers: eight steps of the JAX constructor's optax trajectory and
  the port's, f32, on a weight ``[6, 5]`` and a bias ``[5]``, with L2
  decay and the no-decay split on the bias where the optimizer takes
  them: parameters within 1e-5 of the reference's largest magnitude
  (a few hundred f32 ulps after eight steps that divide by square
  roots of sums taken in another order; 1e-6 is read for most).
* Schedules: the first 40 values of each against the JAX schedule's f32
  values, within 8 f32 ulps of the largest (the JAX side rounds every
  step of the formula to f32; 4.4 ulps is read for CyclicLR).
* ``ReduceLROnPlateau`` on a given metric sequence: the scale after each
  value equal to optax's (both in f32), and the parameters of an SGD run
  under it within 1e-6.
* ``param_groups`` (per-group optimizers, the rest frozen) and
  ``clip_grad_value`` against the JAX wrappers, within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu import optim as jopt
from pytorch_distributed_tpu_torch import optim
from tests.torch_dp_workers import RANK_THREADS
from tests.torch_parity import assert_close, assert_close_ulps

STEPS = 8
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads, as the spawned ranks take
    (``torch_dp_workers.RANK_THREADS``): the test workers share the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    yield
    torch.set_num_threads(threads)


class _Net(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.from_numpy(params["weight"]))
        self.bias = torch.nn.Parameter(torch.from_numpy(params["bias"]))


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"weight": rng.standard_normal((6, 5)).astype(np.float32),
            "bias": rng.standard_normal(5).astype(np.float32)}


def _trajectories(jtx, make, steps=STEPS, values=None):
    """(JAX params, port module) after ``steps`` updates of the same
    seeded gradients; ``values`` threads a metric into each update."""
    params = _params()
    net = _Net({k: v.copy() for k, v in params.items()})
    opt = make(net)
    jp, st = params, jtx.init(params)
    rng = np.random.default_rng(1)
    for i in range(steps):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        kw = {} if values is None else {"value": values[i]}
        upd, st = jtx.update(grads, st, jp, **kw)
        jp = optax.apply_updates(jp, upd)
        for name, p in net.named_parameters():
            p.grad = torch.from_numpy(grads[name].copy())
        opt.step(**kw)
    return jax.device_get(jp), net


ND = (r"bias$",)   # the no-decay pattern, the same on both sides' names
OPTIMIZERS = {
    "rmsprop": (lambda: jopt.RMSprop(1e-2, weight_decay=1e-2, no_decay=ND),
                lambda m: optim.RMSprop(m, 1e-2, weight_decay=1e-2,
                                        no_decay=ND)),
    "rmsprop_centered_momentum": (
        lambda: jopt.RMSprop(1e-2, momentum=0.9, centered=True),
        lambda m: optim.RMSprop(m, 1e-2, momentum=0.9, centered=True)),
    "rmsprop_scheduled": (
        lambda: jopt.RMSprop(jopt.StepLR(1e-2, 3, 0.5)),
        lambda m: optim.RMSprop(m, optim.StepLR(1e-2, 3, 0.5))),
    "adagrad": (lambda: jopt.Adagrad(1e-1, lr_decay=0.05, weight_decay=1e-2,
                                     initial_accumulator_value=0.1),
                lambda m: optim.Adagrad(m, 1e-1, lr_decay=0.05,
                                        weight_decay=1e-2,
                                        initial_accumulator_value=0.1)),
    "adadelta": (lambda: jopt.Adadelta(1.0, weight_decay=1e-2),
                 lambda m: optim.Adadelta(m, 1.0, weight_decay=1e-2)),
    "radam": (lambda: jopt.RAdam(1e-2, weight_decay=1e-2),
              lambda m: optim.RAdam(m, 1e-2, weight_decay=1e-2)),
    "nadam": (lambda: jopt.NAdam(1e-2, weight_decay=1e-2),
              lambda m: optim.NAdam(m, 1e-2, weight_decay=1e-2)),
    "lars": (lambda: jopt.LARS(0.1, weight_decay=1e-2, no_decay=ND),
             lambda m: optim.LARS(m, 0.1, weight_decay=1e-2, no_decay=ND)),
    "lars_scheduled": (
        lambda: jopt.LARS(jopt.CosineAnnealingLR(0.1, 8)),
        lambda m: optim.LARS(m, optim.CosineAnnealingLR(0.1, 8))),
    "lamb": (lambda: jopt.LAMB(1e-2, weight_decay=1e-2, no_decay=ND),
             lambda m: optim.LAMB(m, 1e-2, weight_decay=1e-2, no_decay=ND)),
    "lamb_scheduled": (
        lambda: jopt.LAMB(jopt.WarmupCosine(1e-2, 2, 8)),
        lambda m: optim.LAMB(m, optim.WarmupCosine(1e-2, 2, 8))),
    "adam_l2": (lambda: jopt.Adam(1e-2, weight_decay=1e-2, no_decay=ND),
                lambda m: optim.Adam(m, 1e-2, weight_decay=1e-2,
                                     no_decay=ND)),
    "clip_grad_value": (
        lambda: jopt.clip_grad_value(jopt.SGD(0.1, momentum=0.9), 0.5),
        lambda m: optim.clip_grad_value(optim.SGD(m, 0.1, momentum=0.9),
                                        0.5)),
    "param_groups": (
        lambda: jopt.param_groups([
            ((r"bias$",), jopt.AdamW(1e-2, weight_decay=0.0))]),
        lambda m: optim.param_groups(m, [
            ((r"bias$",), lambda ps: optim.AdamW(ps, 1e-2,
                                                 weight_decay=0.0))])),
    "param_groups_default": (
        lambda: jopt.param_groups(
            [((r"bias$",), jopt.AdamW(1e-2, weight_decay=0.0))],
            default=jopt.SGD(0.1)),
        lambda m: optim.param_groups(
            m, [((r"bias$",), lambda ps: optim.AdamW(ps, 1e-2,
                                                     weight_decay=0.0))],
            default=lambda ps: optim.SGD(ps, 0.1))),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_trajectory_equals_optax(name):
    jmake, make = OPTIMIZERS[name]
    jp, net = _trajectories(jmake(), make)
    for key, p in net.named_parameters():
        assert_close(p, jp[key], RTOL, f"{name} {key}")
    if name == "param_groups":   # the weight matches no group: frozen
        np.testing.assert_array_equal(net.weight.detach().numpy(),
                                      _params()["weight"])


SCHEDULES = {
    "StepLR": ((0.1, 7, 0.5), {}),
    "MultiStepLR": ((0.1, [5, 12, 12, 30], 0.3), {}),
    "CosineAnnealingLR": ((0.1, 25, 1e-3), {}),
    "CosineAnnealingWarmRestarts": ((0.1, 5, 1, 1e-3), {}),
    "CosineAnnealingWarmRestarts_mult": ((0.1, 3, 2, 0.0), {}),
    "WarmupCosine": ((0.1, 5, 30, 1e-3, 1e-2), {}),
    "LinearLR": ((0.1, 0.25, 1.0, 10), {}),
    "ExponentialLR": ((0.1, 0.9), {}),
    "OneCycleLR": ((0.1, 30), {}),
    "ConstantLR": ((0.1, 0.5, 6), {}),
    "PolynomialLR": ((0.1, 20, 2.0), {}),
    "CyclicLR": ((1e-3, 0.1, 4, 6), {}),
    "CyclicLR_triangular2": ((1e-3, 0.1, 5), {"mode": "triangular2"}),
    "CyclicLR_exp_range": ((1e-3, 0.1, 5), {"mode": "exp_range",
                                             "gamma": 0.97}),
}


def _schedule(mod, name):
    args, kw = SCHEDULES[name]
    return getattr(mod, name.split("_")[0]
                   if not name.startswith("CosineAnnealingWarm")
                   else "CosineAnnealingWarmRestarts")(*args, **kw)


def _values(fn, n=40):
    return np.array([float(fn(c)) for c in range(n)])


def _jvalues(fn, n=40):
    return np.array([float(fn(jnp.asarray(c))) for c in range(n)],
                    np.float32)


@pytest.mark.parametrize("name", sorted(SCHEDULES) + [
    "LambdaLR", "MultiplicativeLR", "SequentialLR", "ChainedScheduler"])
def test_schedule_values_equal_optax(name):
    if name in SCHEDULES:
        got, want = _values(_schedule(optim, name)), _jvalues(
            _schedule(jopt, name))
    elif name == "LambdaLR":
        got = _values(optim.LambdaLR(0.1, lambda c: 1.0 / (1.0 + c)))
        want = _jvalues(jopt.LambdaLR(0.1, lambda c: 1.0 / (1.0 + c)))
    elif name == "MultiplicativeLR":
        got = _values(optim.MultiplicativeLR(0.1, lambda i: 0.95))
        want = _jvalues(jopt.MultiplicativeLR(0.1, lambda i: 0.95))
    elif name == "SequentialLR":
        got = _values(optim.SequentialLR(
            [optim.LinearLR(0.1, 0.1, 1.0, 5), optim.ExponentialLR(0.1, 0.9)],
            [5]))
        want = _jvalues(jopt.SequentialLR(
            [jopt.LinearLR(0.1, 0.1, 1.0, 5), jopt.ExponentialLR(0.1, 0.9)],
            [5]))
    else:
        got = _values(optim.ChainedScheduler(
            [optim.ConstantLR(0.1, 0.5, 4), optim.ExponentialLR(1.0, 0.9)]))
        want = _jvalues(jopt.ChainedScheduler(
            [jopt.ConstantLR(0.1, 0.5, 4), jopt.ExponentialLR(1.0, 0.9)]))
    assert_close_ulps(got, want, 8, what=name)


METRICS = [1.0, 0.9, 0.95, 0.97, 0.96, 0.99, 0.98, 0.97, 1.2, 0.5, 0.55,
           0.56, 0.6]


@pytest.mark.parametrize("mode, kw", [
    ("min", dict(patience=2)),
    ("min", dict(patience=1, cooldown=2, accumulation_size=2)),
    ("max", dict(patience=1, factor=0.5, min_scale=0.2))])
def test_reduce_on_plateau_scales_as_optax(mode, kw):
    jtx = jopt.ReduceLROnPlateau(jopt.SGD(0.1), mode=mode, **kw)
    port = optim.ReduceLROnPlateau(optim.SGD(torch.nn.Linear(2, 2), 0.1),
                                   mode=mode, **kw)
    params = {"w": np.zeros(3, np.float32)}
    st = jtx.init(params)
    got, want = [], []
    for value in METRICS:
        _, st = jtx.update({"w": np.ones(3, np.float32)}, st, params,
                           value=value)
        want.append(float(st[1].scale))
        got.append(port.observe(value))
    assert got == want
    assert min(got) < 1.0   # the sequence plateaus: the scale moved


def test_reduce_on_plateau_trajectory():
    jp, net = _trajectories(
        jopt.ReduceLROnPlateau(jopt.SGD(0.1, momentum=0.9), patience=1),
        lambda m: optim.ReduceLROnPlateau(optim.SGD(m, 0.1, momentum=0.9),
                                          patience=1),
        values=METRICS[:STEPS])
    for key, p in net.named_parameters():
        assert_close(p, jp[key], 1e-6, key)


def test_leafwise_optimizers_take_norms_over_the_stacked_leaf():
    """LARS and LAMB on a 2-layer GPT-2 group its layers by JAX leaf:
    one trust ratio per stacked leaf, as the JAX package's run over its
    scan-stacked tree takes it."""
    from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from pytorch_distributed_tpu_torch.runtime.precision import Policy

    model = GPT2LMHead(GPT2Config.tiny(), device="cpu", policy=Policy.full())
    for cls in (optim.LARS, optim.LAMB):
        opt = cls(model, 1e-2)
        paths = {leaf.path: len(leaf.params) for leaf in opt.leaves}
        assert paths["blocks/block/attn_qkv/kernel"] == \
            model.config.num_layers
        assert paths["wte/embedding"] == 1
