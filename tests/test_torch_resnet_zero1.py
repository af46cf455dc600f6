"""ZeRO-1 for the ResNet recipe (``parallel.ZeRO1`` over the port's SGD)
in a gloo world of 2, against DDP, and its checkpoint in both packages.

* Three f64 steps of a small ResNet (CIFAR stem, BasicBlocks, global
  batch statistics; SGD with Nesterov momentum on a cosine schedule, L2
  and label smoothing): ZeRO-1 and DDP give the same losses, parameters
  and running statistics, to the bit; each rank's optimizer holds the
  momentum of its own parameters only, the two sets disjoint and
  together every parameter.
* The world-2 ZeRO-1 checkpoint (each rank wrote its own momentum
  traces) restores at world 1 into a plain SGD and into the JAX recipe's
  ``TrainState`` (``optax.sgd``'s ``trace`` and schedule ``count``), to
  the bit of the f32 leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu.models import resnet as jres
from pytorch_distributed_tpu.train import TrainState as JaxTrainState
from pytorch_distributed_tpu.train.checkpoint import (
    restore_checkpoint as jax_restore_checkpoint,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.interop import resnet_params_to_jax
from pytorch_distributed_tpu_torch.models import resnet
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import TrainState, restore_checkpoint
from tests import torch_compress_workers as cw
from tests import torch_dp_workers as workers


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    ckpt_dir = str(tmp_path_factory.mktemp("resnet_zero1"))
    return workers.spawn(cw.resnet_zero1_vs_ddp, 2, ckpt_dir), ckpt_dir


def test_resnet_zero1_equals_ddp_to_the_bit(world2):
    results, _ = world2
    for res in results:
        (dp_losses, dp_state), (z_losses, z_state) = res["dp"], res["zero"]
        assert z_losses == dp_losses and all(np.isfinite(z_losses))
        for name, t in dp_state.items():
            np.testing.assert_array_equal(z_state[name], t, err_msg=name)
    owned = [set(r["owned"]) for r in results]
    assert owned[0] and owned[1] and not owned[0] & owned[1]
    assert owned[0] | owned[1] == {
        n for n in results[0]["dp"][1] if "running" not in n}


def _port_state():
    model = resnet.ResNet([1, 1], resnet.BasicBlock, 10, width=8,
                          stem="cifar", device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(9))
    opt = optim.SGD(model, lr=optim.WarmupCosine(0.1, 0, 4), momentum=0.9,
                    nesterov=True)
    return TrainState(model, opt, policy=Policy.full())


def test_the_zero1_checkpoint_restores_in_both_packages(world2):
    results, ckpt_dir = world2
    state = _port_state()
    restore_checkpoint(ckpt_dir, state)
    assert state.step == cw.STEPS and state.optimizer.count == cw.STEPS
    final = results[0]["zero"][1]
    for name, t in state.model.state_dict().items():
        np.testing.assert_array_equal(
            t.numpy(), final[name].astype(np.float32), err_msg=name)
    traces = {n: state.optimizer.state[p]["momentum_buffer"]
              for n, p in state.model.named_parameters()}
    assert len(traces) == len(results[0]["owned"]) + len(
        results[1]["owned"])
    # the JAX recipe's state restores the same leaves
    jmodel = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BasicBlock,
                         num_classes=10, width=8, stem="cifar")
    v = jmodel.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)),
                    train=False)
    template = JaxTrainState.create(
        apply_fn=jmodel.apply, params=v["params"],
        batch_stats=v["batch_stats"],
        tx=optax.sgd(optax.cosine_decay_schedule(0.1, 4), momentum=0.9,
                     nesterov=True))
    jstate = jax_restore_checkpoint(ckpt_dir, template)
    assert int(jstate.step) == cw.STEPS
    params, stats = resnet_params_to_jax(state.model.state_dict())
    want = jax.tree_util.tree_map(np.asarray, params)
    got = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate.params))
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    trace_sd = {f"{n}": t for n, t in traces.items()}
    trace_jax, _ = resnet_params_to_jax(
        {**trace_sd, **{k: v for k, v in state.model.state_dict().items()
                        if "running" in k}})
    got_trace = jax.device_get(jstate.opt_state[0].trace)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, got_trace),
                           jax.tree_util.tree_map(np.asarray, trace_jax))
    assert int(jax.device_get(jstate.opt_state[1].count)) == cw.STEPS
