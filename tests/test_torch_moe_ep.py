"""Expert parallelism in the port (the ``ep`` mesh axis, ``ops/moe.py``
under ``parallel.DataParallel(mesh_spec=..., extra_rules=
mixtral_partition_rules())``), port against port over gloo, on the tiny
Mixtral with the JAX package's weights (``tests/test_torch_mixtral.py``'s
seeded tree) at capacity 1.25: the ``ep`` half of JAX
``tests/test_convergence.py``.

* ``--ep 2`` (world 2; GPT-2 with experts too), ``--ep 2 --tp 2`` and
  ``--dp 2 --ep 2`` (world 4) take the world-1 trajectory of three clip
  + AdamW steps: losses and
  load losses to 1e-6 of themselves, every parameter after the steps to
  1e-5 of its largest magnitude (f32; the experts' outputs and the
  gradients summed in other orders), the expert tensors cut over the
  ranks (and q's rows over ``tp``);
* a checkpoint written at ``--ep 2`` restores at world 1, every
  parameter and AdamW moment equal to the bit.
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.interop import mixtral_params_from_jax
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import TrainState
from tests import torch_dp_workers
from tests import torch_moe_workers as workers
from tests.test_torch_mixtral import RTOL, _cfg, _port, params  # noqa: F401
from tests.torch_parity import assert_close


def _ep_case(params, spec, cf=1.25):
    cfg = _cfg(cf)
    sd = {k: v.numpy() for k, v in mixtral_params_from_jax(params,
                                                           cfg).items()}
    return (spec, cfg, sd, workers.batches(cfg.vocab_size, seed=7))


@pytest.fixture(scope="module")
def reference(params):
    return torch_dp_workers.in_process(
        workers.mixtral_world, {"w1": _ep_case(params, dict(dp=1))})["w1"]


def _same_trajectory(got, want, name):
    for key in ("losses", "aux"):
        for a, b in zip(got[key], want[key]):
            assert_close(a, b, 1e-6, f"{name} {key}")
    for k, v in want["params"].items():
        if k.endswith("attn_qkv.bias"):
            # GPT-2's key bias: an exactly-zero gradient, whose rounding
            # noise Adam turns into steps as large as lr
            continue
        assert_close(got["params"][k], v, RTOL, f"{name} {k}")


def _gpt2_case(spec):
    """GPT-2 with 4 experts a block (``tests/test_moe_gpt2.py``'s config),
    seeded weights, at its default capacity 1.25."""
    cfg = GPT2Config(vocab_size=128, n_positions=32, hidden_size=32,
                     num_layers=2, num_heads=2, dropout_rate=0.0,
                     moe_experts=4)
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(3))
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return (spec, cfg, sd, workers.batches(cfg.vocab_size, rows=8,
                                           seed=9))


def test_ep2_takes_the_world1_trajectory(params, reference):
    gpt2_ref = torch_dp_workers.in_process(
        workers.mixtral_world, {"w1": _gpt2_case(dict(dp=1))})["w1"]
    got = torch_dp_workers.spawn(
        workers.mixtral_world, 2,
        {"ep2": _ep_case(params, dict(dp=1, ep=2)),
         "gpt2_ep2": _gpt2_case(dict(dp=1, ep=2))})[0]
    assert "layers.0.moe.w_in" in got["ep2"]["cut"], got["ep2"]["cut"]
    _same_trajectory(got["ep2"], reference, "ep2")
    assert "blocks.1.moe.w_out" in got["gpt2_ep2"]["cut"]
    _same_trajectory(got["gpt2_ep2"], gpt2_ref, "gpt2_ep2")


def test_ep2_tp2_and_dp2_ep2_take_the_world1_trajectory(params, reference):
    got = torch_dp_workers.spawn(
        workers.mixtral_world, 4,
        {"ep2_tp2": _ep_case(params, dict(dp=1, ep=2, tp=2)),
         "dp2_ep2": _ep_case(params, dict(dp=2, ep=2))},
        timeout_s=240.0)[0]
    for name, res in got.items():
        assert "layers.1.moe.w_out" in res["cut"], (name, res["cut"])
        _same_trajectory(res, reference, name)
    assert "layers.0.q.weight" in got["ep2_tp2"]["cut"]


def test_ep2_checkpoint_restores_at_world1(params, tmp_path):
    """A checkpoint written at ``--ep 2`` (each rank its experts' boxes of
    the stacked ``[L, E, ...]`` leaves) restores into a world-1 model:
    every parameter and AdamW moment equal to the bit."""
    from pytorch_distributed_tpu_torch.train import restore_checkpoint

    spec, cfg, sd, batches = _ep_case(params, dict(dp=1, ep=2))
    whole = torch_dp_workers.spawn(workers.mixtral_ckpt, 2, spec, cfg, sd,
                                   batches[0], str(tmp_path))[0]
    model = _port(params, 1.25)
    opt = optim.AdamW(model, lr=workers.LR, weight_decay=1e-4)
    state = TrainState(model, opt, policy=Policy.full())
    restore_checkpoint(str(tmp_path), state)
    assert state.step == 1
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), whole[name],
                                      err_msg=name)
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(opt.state[p][key].numpy(),
                                          whole[f"{name}.{key}"],
                                          err_msg=f"{name}.{key}")


