"""ZeRO-1 in the port (``parallel.ZeRO1``: DDP plus
``ZeroRedundancyOptimizer`` over the port's AdamW) in a gloo world of 2
(ranks spawned from ``tests/torch_dp_workers.py``, which imports no JAX).

* Three steps of two microbatches, tiny f32 GPT-2 with dropout, clip
  then AdamW: ZeRO-1 and DDP give the same losses and parameters to the
  bit, with the clip inactive (max norm 1.0) and active (0.05).
* Each rank's optimizer holds the moments of its own parameters only,
  the two sets disjoint and together every parameter.
* The clip wraps ``ZeroRedundancyOptimizer`` and takes the global norm;
  a clip around one rank's shard would take another one.
* The world-2 checkpoint (each rank wrote its own moments) restores at
  world 1 into a plain AdamW and into the JAX recipe's ``TrainState``,
  to the bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pytorch_distributed_tpu.models.gpt2 import (
    GPT2Config as JaxGPT2Config,
    GPT2LMHead as JaxGPT2,
)
from pytorch_distributed_tpu.train import TrainState as JaxTrainState
from pytorch_distributed_tpu.train.checkpoint import (
    _leaf_files,
    restore_checkpoint as jax_restore_checkpoint,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import (
    TrainState,
    restore_checkpoint,
    verify_checkpoint,
)
from pytorch_distributed_tpu_torch.train.checkpoint import checkpoint_diff
from pytorch_distributed_tpu_torch.train.ckpt_io import load_checkpoint
from tests import torch_dp_workers as workers


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    ckpt_dir = str(tmp_path_factory.mktemp("zero1"))
    results = workers.spawn(workers.zero1_vs_ddp, 2, ckpt_dir)
    return results, ckpt_dir


@pytest.mark.parametrize("max_norm", ["1.0", "0.05"],
                         ids=["clip_inactive", "clip_active"])
def test_zero1_equals_ddp_to_the_bit(world2, max_norm):
    results, _ = world2
    for res in results:
        assert res[f"zero_losses_{max_norm}"] == res[f"dp_losses_{max_norm}"]
        for name, p in res[f"dp_{max_norm}"].items():
            np.testing.assert_array_equal(res[f"zero_{max_norm}"][name], p,
                                          err_msg=name)
    # the two clip settings really differ: the clip acted at 0.05
    assert results[0]["zero_losses_1.0"] != results[0]["zero_losses_0.05"]


def test_each_rank_holds_only_its_own_moments(world2):
    results, _ = world2
    owned = [set(r["moments"]) for r in results]
    names = set(results[0]["dp_1.0"])
    assert owned[0] and owned[1] and not owned[0] & owned[1]
    assert owned[0] | owned[1] == names
    for r in results:
        assert r["steps"] == [workers.ZERO_STEPS]
        for moments in r["moments"].values():
            assert set(moments) == {"exp_avg", "exp_avg_sq"}


def test_the_clip_takes_the_global_norm(world2):
    results, _ = world2
    for r in results:
        local, every = r["norms"]
        assert local < every   # a shard's norm would clip by another factor
        # the clip around ZeroRedundancyOptimizer sees every gradient (its
        # f32 sum runs in another order: a few ulp)
        assert r["clip_norm"] == pytest.approx(every, rel=1e-6)
    assert results[0]["norms"][1] == results[1]["norms"][1]


def _fresh():
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu", policy=Policy.full())
    opt = optim.clip_grad_norm(optim.AdamW(model, lr=1e-2,
                                           weight_decay=1e-4), 1.0)
    return model, TrainState(model, opt, policy=Policy.full())


def test_world2_checkpoint_restores_at_world1(world2):
    results, ckpt_dir = world2
    assert verify_checkpoint(ckpt_dir) == []
    files = os.listdir(os.path.join(ckpt_dir, "latest"))
    for key in ("mu", "nu"):   # each rank wrote the moments it held
        writers = {f.split(".")[-2][:2] for f in files
                   if f"opt_state_1_0_{key}_" in f}
        assert writers == {"p0", "p1"}, writers
    assert not [f for f in files if "params_" in f and ".p1s" in f]
    model, state = _fresh()
    restore_checkpoint(ckpt_dir, state)
    assert state.step == workers.ZERO_STEPS
    params = results[0]["zero_0.05"]
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[name],
                                      err_msg=name)
    adam = state.optimizer.optimizer
    for name, p in model.named_parameters():
        held = [r["moments"][name] for r in results if name in r["moments"]]
        assert len(held) == 1
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(adam.state[p][k].numpy(),
                                          held[0][k], err_msg=f"{name}.{k}")
        assert int(adam.state[p]["step"]) == workers.ZERO_STEPS
    assert set(checkpoint_diff(ckpt_dir, state).values()) == {0.0}


def test_world2_checkpoint_restores_in_jax(world2):
    _, ckpt_dir = world2
    jmodel = JaxGPT2(JaxGPT2Config.tiny())
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    template = JaxTrainState.create(
        apply_fn=jmodel.apply, params=params,
        tx=optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-2)))
    restored = jax_restore_checkpoint(ckpt_dir, template)
    files = load_checkpoint(os.path.join(ckpt_dir, "latest")).leaves
    got = {k: np.asarray(v) for k, v in _leaf_files(restored)}
    assert sorted(got) == sorted(files)
    for name, arr in files.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    assert int(restored.step) == workers.ZERO_STEPS
    assert int(restored.opt_state[1][0].count) == workers.ZERO_STEPS


def test_zero1_needs_a_process_group():
    from pytorch_distributed_tpu_torch import parallel

    with pytest.raises(RuntimeError, match="process group"):
        parallel.ZeRO1("cpu")
