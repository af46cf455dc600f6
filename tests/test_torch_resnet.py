"""The port's ResNet held against the JAX ResNet on the same weights.

Tiny models (stages [1, 1], width 8) with both block types and all three
stems, at inputs of 32 and 33 pixels (34 for the s2d stem, which needs an
even side), so that the stride-2 convs see both an even input (flax's
SAME pads (0, 1)) and an odd one (it pads (1, 1)). Weights come from the
JAX init through ``resnet_params_from_jax``, with the BatchNorm scales,
biases and running statistics redrawn in numpy first: the zero-init
scales would otherwise leave every block's conv branch out of the
comparison. Forwards compute in f32 on the CPU; the JAX model runs
under ``use_policy(Policy(compute_dtype=float32))``. Gradients are
compared in f64 on both sides (``jax.enable_x64``): at f32, the JAX
model's own gradients differ from its f64 gradients by up to 3e-2 of
their largest entry in the bottleneck/CIFAR-stem case at 32 pixels,
where the port's f32 gradients stay within 3e-6 of f64.

Tolerances (``tests/torch_parity.py``), relative to the reference's
largest magnitude: 1e-5 for logits, losses and running statistics (the
two frameworks sum in another order and take the batch variance by
different formulas); 1e-6 for f64 gradients (the JAX loss takes the
logits to f32, where the port's keeps f64); 1e-4 for parameters after f32 SGD
steps (longer sums; lr 0.1 moves every weight). Exact pieces (the
space-to-depth permutation, the s2d kernel rewrite, parameter counts)
are compared for equality.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu.data import (
    device_normalizer_for as jax_device_normalizer_for,
)
from pytorch_distributed_tpu.models import resnet as jres
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train import (
    TrainState as JaxTrainState,
    build_train_step as jax_build_train_step,
    classification_eval_step as jax_classification_eval_step,
    classification_loss_fn as jax_classification_loss_fn,
)
from pytorch_distributed_tpu.train.losses import (
    cross_entropy as jax_cross_entropy,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.data import device_normalizer_for
from pytorch_distributed_tpu_torch.interop import resnet_params_from_jax
from pytorch_distributed_tpu_torch.models import resnet
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import (
    TrainState,
    build_train_step,
    classification_eval_step,
    classification_loss_fn,
    cross_entropy,
)
from tests.torch_parity import assert_close, assert_equal

F32 = JaxPolicy(compute_dtype=jnp.float32)
F64 = JaxPolicy(jnp.float64, jnp.float64, jnp.float64)
OUT_RTOL, GRAD64_RTOL, STEP_RTOL = 1e-5, 1e-6, 1e-4
BLOCKS = {"basic": (jres.BasicBlock, resnet.BasicBlock),
          "bottleneck": (jres.Bottleneck, resnet.Bottleneck)}
STEM_SIZES = {"imagenet": (32, 33), "s2d": (32, 34), "cifar": (32, 33)}
CASES = [(b, s, n) for b in BLOCKS for s in STEM_SIZES
         for n in STEM_SIZES[s]]


def _randomize_norms(params, stats, rng):
    """BatchNorm scales in [0.5, 1.5], biases and means N(0, 0.1), running
    variances in [0.5, 1.5]; convs and the head keep the JAX init."""
    def redraw(path, a):
        leaf = path[-1].key
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if leaf == "mean" or (leaf == "bias" and path[-2].key != "head"):
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return np.asarray(a)

    return (jax.tree_util.tree_map_with_path(redraw, params),
            jax.tree_util.tree_map_with_path(redraw, stats))


def _pair(block, stem, num_classes=5, size=32, seed=0, width=8):
    """(JAX model, params, batch_stats, port model on those weights)."""
    jblock, pblock = BLOCKS[block]
    jmodel = jres.ResNet(stage_sizes=[1, 1], block_cls=jblock,
                         num_classes=num_classes, width=width, stem=stem)
    with use_policy(F32):
        v = jax.device_get(jmodel.init(
            jax.random.key(seed), jnp.zeros((1, size, size, 3)),
            train=False))
    params, stats = _randomize_norms(v["params"], v["batch_stats"],
                                     np.random.default_rng(seed))
    model = resnet.ResNet([1, 1], pblock, num_classes, width=width,
                          stem=stem, device="cpu", policy=Policy.full())
    model.load_state_dict(resnet_params_from_jax(params, stats))
    return jmodel, params, stats, model


@pytest.mark.parametrize("block, stem, size", CASES,
                         ids=[f"{b}-{s}-{n}" for b, s, n in CASES])
def test_forward_stats_and_grads_match_jax(block, stem, size):
    jmodel, params, stats, model = _pair(block, stem)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 5, size=4).astype(np.int32)
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels)

    def jax_loss(p, s, dtype):
        logits, mut = jmodel.apply(
            {"params": p, "batch_stats": s}, jnp.asarray(x, dtype),
            train=True, mutable=["batch_stats"])
        return jax_cross_entropy(logits, jnp.asarray(labels)), (
            logits, mut["batch_stats"])

    with use_policy(F32):
        want_eval = jmodel.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x), train=False)
        want_loss, (want_train, new_stats) = jax_loss(params, stats,
                                                      jnp.float32)
    with torch.no_grad():
        assert_close(model(xt, train=False), want_eval, OUT_RTOL, "eval")
        logits = model(xt, train=True)
    assert_close(logits, want_train, OUT_RTOL, "train logits")
    assert_close(cross_entropy(logits, lt), want_loss, OUT_RTOL, "loss")
    want = resnet_params_from_jax(params, jax.device_get(new_stats))
    for name, buf in model.named_buffers():
        assert_close(buf, want[name], OUT_RTOL, name)

    to64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float64), t)
    with jax.enable_x64(True), use_policy(F64):
        grads = jax.grad(lambda p: jax_loss(p, to64(stats), jnp.float64)[0])(
            to64(params))
    want = resnet_params_from_jax(jax.device_get(grads), stats)
    model64 = resnet.ResNet(
        [1, 1], BLOCKS[block][1], 5, width=8, stem=stem, device="cpu",
        policy=Policy(torch.float64, torch.float64, torch.float64))
    model64.load_state_dict(resnet_params_from_jax(params, stats))
    cross_entropy(model64(xt.double(), train=True), lt).backward()
    for name, p in model64.named_parameters():
        assert_close(p.grad, want[name], GRAD64_RTOL, f"grad {name}")


def test_space_to_depth_and_s2d_kernel_rewrite_are_exact():
    rng = np.random.default_rng(0)
    x = rng.integers(-1000, 1000, size=(2, 8, 6, 3)).astype(np.int32)
    assert_equal(resnet.space_to_depth(torch.from_numpy(x), 2),
                 np.asarray(jres.space_to_depth(jnp.asarray(x), 2)))
    k7 = rng.normal(size=(7, 7, 3, 8)).astype(np.float32)
    got = resnet.s2d_stem_kernel_from_conv7(k7)
    assert got.dtype == np.float32
    assert np.array_equal(got, jres.s2d_stem_kernel_from_conv7(k7))
    # and the rewrite is the same function: the 7x7/2 conv with pad 3 on
    # x equals the 4x4/1 conv with pad (2, 1) on space_to_depth(x)
    xf = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    want = torch.nn.functional.conv2d(
        xf.permute(0, 3, 1, 2), torch.from_numpy(k7).permute(3, 2, 0, 1),
        stride=2, padding=3)
    s2d = resnet.space_to_depth(xf, 2).permute(0, 3, 1, 2)
    got = torch.nn.functional.conv2d(
        torch.nn.functional.pad(s2d, (2, 1, 2, 1)),
        torch.from_numpy(got).permute(3, 2, 0, 1))
    assert_close(got, want, OUT_RTOL, "s2d conv")


def test_same_padding_is_flax_same():
    # stride-2 3x3: (0, 1) on an even side, (1, 1) on an odd one; 1x1
    # stride-2 projections pad nothing; stride-1 3x3 pads (1, 1)
    assert resnet.same_padding(8, 3, 2) == (0, 1)
    assert resnet.same_padding(9, 3, 2) == (1, 1)
    assert resnet.same_padding(8, 1, 2) == (0, 0)
    assert resnet.same_padding(7, 3, 1) == (1, 1)


@pytest.mark.parametrize("name", ["ResNet18", "ResNet34", "ResNet50",
                                  "ResNet101", "ResNet152"])
def test_parameter_counts_equal_jax(name):
    """Counted on the meta device (no memory) and from JAX's abstract
    init; ResNet-50 is 25,557,032 (torchvision's 25.56 M)."""
    model = getattr(resnet, name)(device="meta")
    got = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(
        lambda: getattr(jres, name)().init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)
    )["params"]
    want = sum(math.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes))
    assert got == want
    if name == "ResNet50":
        assert got == 25_557_032


def test_fresh_init_matches_jax_statistics():
    """Per leaf, the port's init std against the JAX init's: within five
    standard errors of a sample std (std * sqrt(1 / 2n) each); BatchNorm
    scales are one, except the last norm of every block, which is
    zero."""
    jmodel = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.Bottleneck,
                         num_classes=200, width=32, stem="imagenet")
    with use_policy(F32):
        v = jax.device_get(jmodel.init(
            jax.random.key(3), jnp.zeros((1, 32, 32, 3)), train=False))
    want = resnet_params_from_jax(v["params"], v["batch_stats"])
    model = resnet.ResNet([1, 1], resnet.Bottleneck, 200, width=32,
                          device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(3))
    got = model.state_dict()
    for name, w in want.items():
        g = got[name]
        if name.endswith(("running_mean", "running_var")) or w.ndim == 1:
            assert torch.equal(g, w), name   # constants: 0, 1 or zero scale
            continue
        sw, sg = w.std().item(), g.std().item()
        se = math.sqrt(sw**2 / (2 * w.numel()) + sg**2 / (2 * g.numel()))
        assert abs(sg - sw) <= 5 * se, (name, sg, sw, se)
    last = [n for n in want if n.endswith(("bn2.weight"))]
    assert last and all(not got[n].any() for n in last)
    assert got["stem_bn.weight"].eq(1).all()


LR, WARMUP, TOTAL = 0.1, 1, 4


def test_sgd_nesterov_warmup_cosine_steps_match_jax():
    """Three steps of build_train_step + classification_loss_fn (label
    smoothing 0.1, L2 1e-4) + SGD(nesterov, warmup-cosine from 0) on
    uint8 batches normalized by the device normalizer, against the JAX
    jitted step with optax.sgd: the loss of every step, then every
    parameter and running statistic after it. Step 0's lr is 0, so it
    moves only the momentum trace and the statistics."""
    jmodel, params, stats, model = _pair("bottleneck", "cifar",
                                         num_classes=10, size=16)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    schedule = optax.warmup_cosine_decay_schedule(0.0, LR, WARMUP, TOTAL)
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=params, batch_stats=stats,
        tx=optax.sgd(schedule, momentum=0.9, nesterov=True))
    jstep = jax.jit(jax_build_train_step(
        jax_classification_loss_fn(jmodel, label_smoothing=0.1,
                                   weight_decay=1e-4),
        batch_transform=jax_device_normalizer_for(mean, std)))
    opt = optim.SGD(model, lr=optim.WarmupCosine(LR, WARMUP, TOTAL),
                    momentum=0.9, nesterov=True)
    state = TrainState(model, opt, policy=Policy.full())
    step = build_train_step(
        classification_loss_fn(model, label_smoothing=0.1,
                               weight_decay=1e-4),
        batch_transform=device_normalizer_for(mean, std))
    rng = np.random.default_rng(7)
    for i in range(3):
        batch = {"image": rng.integers(0, 256, (8, 16, 16, 3), np.uint8),
                 "label": rng.integers(0, 10, 8).astype(np.int32)}
        with use_policy(F32):
            jstate, jmetrics = jstep(
                jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, metrics = step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert_close(metrics["loss"], jmetrics["loss"], OUT_RTOL,
                     f"loss at step {i}")
        assert_close(metrics["accuracy"], jmetrics["accuracy"], 0.0,
                     f"accuracy at step {i}")
        want = resnet_params_from_jax(jax.device_get(jstate.params),
                                      jax.device_get(jstate.batch_stats))
        for name, t in model.state_dict().items():
            rtol = OUT_RTOL if "running" in name else STEP_RTOL
            assert_close(t, want[name], rtol, f"{name} after step {i}")
    assert state.step == 3 == int(jstate.step)


def test_eval_step_matches_jax():
    """``classification_eval_step`` on the running statistics, uint8 in,
    the normalizer as its batch transform: loss to 1e-5, accuracy and
    top-5 accuracy exactly (ten classes; labels drawn so that both are
    strictly between 0 and 1)."""
    jmodel, params, stats, model = _pair("basic", "imagenet",
                                         num_classes=10)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    rng = np.random.default_rng(5)
    batch = {"image": rng.integers(0, 256, (16, 32, 32, 3), np.uint8),
             "label": rng.integers(0, 10, 16).astype(np.int32)}
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                  batch_stats=stats, tx=optax.sgd(0.1))
    with use_policy(F32):
        want = jax_classification_eval_step(
            jmodel, batch_transform=jax_device_normalizer_for(mean, std))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    got = classification_eval_step(
        model, batch_transform=device_normalizer_for(mean, std))(
        None, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want) == {"loss", "accuracy", "top5_accuracy"}
    assert_close(got["loss"], want["loss"], OUT_RTOL, "eval loss")
    for key in ("accuracy", "top5_accuracy"):
        assert float(got[key]) == float(want[key]), key
    assert 0 < float(want["top5_accuracy"]) < 1
