"""The ResNet-18/CIFAR-10 recipe's step, EMA and the EMA checkpoint in
the port, held against the JAX package on the same weights and batches.

* ``WarmupCosine(lr, 0, T)`` is ``optax.cosine_decay_schedule(lr, T)``
  at every step and past its end, within f32 rounding (optax computes
  in f32, the port in f64).
* The recipe's step (``ImageBatchPipeline`` batches, pad 4 and flips,
  bitwise the JAX pipeline's; its device normalizer; L2 5e-4; SGD with
  Nesterov momentum on the cosine schedule) on ResNet-18's stages
  (``[2, 2, 2, 2]`` BasicBlocks, CIFAR stem) at width 16, 32x32, batch
  8, from the JAX init carried across, with ``ema_decay=0.9``: three
  steps against the JAX jitted step, at ``tests/test_torch_resnet.py``'s
  limits (losses and running statistics 1e-5, parameters and the EMA
  shadow 1e-4 of their largest magnitude).
* ``eval_with_ema`` evaluates the shadow: the port trainer's evaluation
  equals the JAX eval step on ``ema_params`` (the running statistics
  the model's own), and leaves the live parameters bitwise as they were.
* A checkpoint with ``ema_params`` restores in either package, bitwise;
  one without them restores with the shadow seeded from the parameters.
* ``ema_decay`` outside [0, 1), or an EMA step on a state without a
  shadow, or ``eval_with_ema`` with a step that keeps none, refuse.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu.data.native_pipeline import (
    ImageBatchPipeline as JaxImageBatchPipeline,
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
from pytorch_distributed_tpu.train.checkpoint import (
    restore_checkpoint as jax_restore_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.data import (
    ArrayDataset,
    ImageBatchPipeline,
)
from pytorch_distributed_tpu_torch.interop import (
    resnet_params_from_jax,
    resnet_slots,
)
from pytorch_distributed_tpu_torch.models import resnet
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    TrainState,
    build_train_step,
    classification_eval_step,
    classification_loss_fn,
    restore_checkpoint,
    save_checkpoint,
)
from tests import torch_dp_workers as workers
from tests.torch_parity import assert_close

F32 = JaxPolicy(compute_dtype=jnp.float32)
OUT_RTOL, STEP_RTOL = 1e-5, 1e-4
LR, WD, EMA = 0.1, 5e-4, 0.9
TOTAL = 6
CIFAR_MEAN, CIFAR_STD = (0.4914, 0.4822, 0.4465), (0.247, 0.243, 0.262)


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads, as the spawned ranks take
    (``torch_dp_workers.RANK_THREADS``): the test workers share the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(workers.RANK_THREADS)
    yield
    torch.set_num_threads(threads)


def test_cosine_schedule_is_optax_cosine_decay():
    for lr, total in ((0.1, 7), (0.4, 391), (1.0, 1)):
        want = optax.cosine_decay_schedule(lr, total)
        got = optim.WarmupCosine(lr, 0, total)
        for t in range(total + 3):
            np.testing.assert_allclose(got(t), float(want(t)), rtol=1e-6,
                                       atol=1e-7 * lr, err_msg=f"{lr} {t}")


def _jax_resnet18(width=16):
    return jres.ResNet(stage_sizes=[2, 2, 2, 2], block_cls=jres.BasicBlock,
                       num_classes=10, width=width, stem="cifar")


def _port_resnet18(params, stats, width=16):
    model = resnet.ResNet([2, 2, 2, 2], resnet.BasicBlock, 10, width=width,
                          stem="cifar", device="cpu", policy=Policy.full())
    model.load_state_dict(resnet_params_from_jax(params, stats))
    return model


def _shadow_as_jax(ema):
    """The port's shadow by JAX ``params`` path, in the JAX layouts."""
    slots = resnet_slots(ema.keys())
    return {"/".join(slots[n].path): slots[n].to_jax(t.numpy())
            for n, t in ema.items()}


@pytest.fixture(scope="module")
def run():
    """Three EMA steps in both packages; the states after each."""
    jmodel = _jax_resnet18()
    with use_policy(F32):
        v = jax.device_get(jmodel.init(jax.random.key(0),
                                       jnp.zeros((1, 32, 32, 3)),
                                       train=False))
    params, stats = v["params"], v["batch_stats"]
    model = _port_resnet18(params, stats)
    schedule = optax.cosine_decay_schedule(LR, TOTAL)
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=params, batch_stats=stats,
        tx=optax.sgd(schedule, momentum=0.9, nesterov=True), ema=True)
    rng = np.random.default_rng(11)
    arrays = dict(image=rng.integers(0, 256, (24, 32, 32, 3), np.uint8),
                  label=rng.integers(0, 10, 24).astype(np.int32))
    kw = dict(train=True, pad=4, mean=CIFAR_MEAN, std=CIFAR_STD, seed=0)
    pipe, jpipe = ImageBatchPipeline(32, **kw), JaxImageBatchPipeline(32, **kw)
    jstep = jax.jit(jax_build_train_step(
        jax_classification_loss_fn(jmodel, weight_decay=WD),
        batch_transform=jpipe.device_normalizer(), ema_decay=EMA))
    opt = optim.SGD(model, lr=optim.WarmupCosine(LR, 0, TOTAL),
                    momentum=0.9, nesterov=True)
    state = TrainState(model, opt, policy=Policy.full(), ema=True)
    step = build_train_step(classification_loss_fn(model, weight_decay=WD),
                            batch_transform=pipe.device_normalizer(),
                            ema_decay=EMA)
    history = []
    for i in range(3):
        idx = np.arange(8 * i, 8 * i + 8)
        batch = pipe(ArrayDataset(**arrays), idx)
        jbatch = jpipe(type("D", (), {"arrays": arrays})(), idx)
        for k in batch:
            np.testing.assert_array_equal(batch[k], jbatch[k])
        with use_policy(F32):
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in jbatch.items()})
        state, m = step(state, {k: torch.from_numpy(v.copy())
                                for k, v in batch.items()})
        history.append(dict(
            loss=(float(m["loss"]), float(jm["loss"])),
            sd={k: v.clone() for k, v in model.state_dict().items()},
            want=resnet_params_from_jax(jax.device_get(jstate.params),
                                        jax.device_get(jstate.batch_stats)),
            ema={k: v.clone() for k, v in state.ema_params.items()},
            jema=jax.device_get(jstate.ema_params)))
    return dict(jmodel=jmodel, jstate=jstate, state=state, model=model,
                history=history, arrays=arrays)


def test_cifar_step_with_ema_matches_jax(run):
    for i, h in enumerate(run["history"]):
        assert_close(h["loss"][0], h["loss"][1], OUT_RTOL, f"loss {i}")
        for name, t in h["sd"].items():
            rtol = OUT_RTOL if "running" in name else STEP_RTOL
            assert_close(t, h["want"][name], rtol, f"{name} step {i}")
        # the shadow, in the params' JAX layout, against the JAX shadow
        want = resnet_params_from_jax(h["jema"], jax.device_get(
            run["jstate"].batch_stats))
        for name, e in h["ema"].items():
            assert e.dtype == torch.float32
            assert_close(e, want[name], STEP_RTOL, f"ema {name} step {i}")
    assert run["state"].step == 3 == int(run["jstate"].step)


def test_eval_with_ema_evaluates_the_shadow(run):
    model, state, jstate = run["model"], run["state"], run["jstate"]
    rng = np.random.default_rng(2)
    batch = {"image": rng.integers(0, 256, (8, 32, 32, 3), np.uint8),
             "label": rng.integers(0, 10, 8).astype(np.int32)}
    pipe = ImageBatchPipeline(32, train=False, mean=CIFAR_MEAN, std=CIFAR_STD)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(
        state, build_train_step(classification_loss_fn(model),
                                ema_decay=EMA),
        [], eval_step=classification_eval_step(
            model, batch_transform=pipe.device_normalizer()),
        eval_loader=[{k: torch.from_numpy(v) for k, v in batch.items()}],
        config=TrainerConfig(eval_with_ema=True, handle_preemption=False))
    got = trainer.evaluate(0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with use_policy(F32):
        want = jax_classification_eval_step(
            run["jmodel"], batch_transform=JaxImageBatchPipeline(
                32, train=False, mean=CIFAR_MEAN,
                std=CIFAR_STD).device_normalizer())(
            jstate.replace(params=jstate.ema_params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    assert_close(got["loss"], float(want["loss"]), 1e-4, "ema eval loss")
    with pytest.raises(ValueError, match="without ema_decay"):
        Trainer(state, build_train_step(classification_loss_fn(model)), [],
                config=TrainerConfig(eval_with_ema=True))


def test_ema_checkpoint_restores_in_either_package(run, tmp_path):
    state, jstate = run["state"], run["jstate"]
    save_checkpoint(str(tmp_path / "port"), state)
    restored = jax_restore_checkpoint(str(tmp_path / "port"), jstate)
    by_path = _shadow_as_jax(state.ema_params)
    flat = jax.tree_util.tree_flatten_with_path(
        jax.device_get(restored.ema_params))[0]
    names = {"/".join(k.key for k in path): np.asarray(a)
             for path, a in flat}
    assert set(names) == set(by_path)
    for k, v in names.items():
        np.testing.assert_array_equal(v, by_path[k], k)
    # the JAX package's checkpoint into a port state of other weights
    jax_save_checkpoint(str(tmp_path / "jax"), jstate)
    other = copy.deepcopy(state)
    for e in other.ema_params.values():
        e.zero_()
    restore_checkpoint(str(tmp_path / "jax"), other)
    want = resnet_params_from_jax(jax.device_get(jstate.ema_params),
                                  jax.device_get(jstate.batch_stats))
    for name, e in other.ema_params.items():
        np.testing.assert_array_equal(e.numpy(), want[name].numpy(), name)
    assert other.step == 3


def test_a_checkpoint_without_ema_seeds_the_shadow(run, tmp_path):
    state = run["state"]
    plain = TrainState(state.model, state.optimizer, step=state.step,
                       policy=state.policy)
    save_checkpoint(str(tmp_path), plain)
    fresh = copy.deepcopy(state)
    for e in fresh.ema_params.values():
        e.zero_()
    restore_checkpoint(str(tmp_path), fresh)
    for name, p in fresh.model.named_parameters():
        assert torch.equal(fresh.ema_params[name], p.detach()), name


def test_ema_refusals():
    model = torch.nn.Linear(3, 2)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        build_train_step(lambda mb, g: None, ema_decay=1.0)
    step = build_train_step(
        lambda mb, g: (model(mb["x"]).square().mean(), {}), ema_decay=0.5)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    with pytest.raises(ValueError, match="no shadow params"):
        step(state, {"x": torch.ones(2, 3)})
