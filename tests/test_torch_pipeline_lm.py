"""The port's pipelined GPT-2 (``parallel/pipeline_lm.py``) against the
JAX package's.

* ``gpt2_pipeline_logits`` at ``pp`` 2 and at 4 stages of one layer each,
  and the pipelined loss with every gradient, against the JAX
  ``gpt2_pipeline_logits`` and ``jax.grad`` of the JAX pipelined loss on
  the conftest's CPU devices, the weights through
  ``interop.gpt2_params_from_jax``, in f32 products. Every stage's
  ``wte``/``wpe``/``ln_f`` gradients are checked: without the embedding's
  ``sum_grad`` the later stages' would miss the embedding part, and a
  two-way sum over ``pp`` would scale the blocks' by the stage count.
* ``PipelineParallel`` allocates only the stage's blocks.
* The recipe's ``--dp 2 --pp 2`` over a gloo world of 4 trains and
  evaluates as the plain recipe does at world 1 on the same weights and
  batches.
* The refusals, and the checkpoint round trips: a world-1 checkpoint
  restored under ``dp 2 x pp 2`` and a ``pp`` 2 one (the first data
  replica of each stage writing its layers) restored at world 1, to the
  bit, and the latter read by the JAX package's restore.

One gloo world of 4 is spawned and runs every case: ``pp`` 2 as ``dp 2
x pp 2`` (stage ``rank % 2``), ``pp`` 4 as ``dp 1 x pp 4``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pytorch_distributed_tpu as ptd
from pytorch_distributed_tpu.models.gpt2 import (
    GPT2Config as JaxGPT2Config,
    GPT2LMHead as JaxGPT2,
)
from pytorch_distributed_tpu.parallel.pipeline_lm import (
    gpt2_pipeline_logits as jax_pipeline_logits,
    pipelined_causal_lm_loss_fn as jax_pipelined_loss_fn,
)
from pytorch_distributed_tpu.runtime.mesh import MeshSpec as JaxMeshSpec
from pytorch_distributed_tpu.runtime.precision import (
    Policy as JaxPolicy,
    use_policy,
)
from pytorch_distributed_tpu.train import TrainState as JaxTrainState
from pytorch_distributed_tpu.train.checkpoint import (
    _leaf_files,
    restore_checkpoint as jax_restore_checkpoint,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.interop import (
    gpt2_params_from_jax,
    gpt2_params_to_jax,
)
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2LMHead
from pytorch_distributed_tpu_torch.parallel.pipeline_lm import (
    gpt2_pipeline_logits,
    pipelined_causal_lm_loss_fn,
)
from pytorch_distributed_tpu_torch.recipes import gpt2 as gpt2_recipe
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import (
    TrainState,
    build_train_step,
    causal_lm_loss_fn,
    restore_checkpoint,
    save_checkpoint,
)
from tests import torch_dp_workers
from tests import torch_pipeline_workers as workers
from tests.torch_parity import assert_close

F32 = JaxPolicy(compute_dtype=jnp.float32)
JAX_CFG = JaxGPT2Config(vocab_size=128, n_positions=32, hidden_size=32,
                        num_layers=4, num_heads=2, dropout_rate=0.0)
B, S = 4, 16
# f32 products summed in other orders: a few ulp of the largest value
LOGIT_RTOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-6, 1e-4
# --dp 2 --pp 2 against world 1: the same f32 math in another summation
# order. AdamW's first steps move a weight by about lr whatever the size
# of its gradient, so rounding noise in a gradient that is zero in exact
# arithmetic (the key bias's) becomes +-lr moves: the world-1 recipe alone
# moves its second loss by 1.3e-4 of itself between --accum-steps 4 and 1
RECIPE_LOSS_RTOL = 1e-3
RECIPE_ARGV = ["--device", "cpu", "--backend", "gloo", "--batch-size", "16",
               "--seq-len", "16", "--steps-per-epoch", "3", "--log-every",
               "1", "--lr", "1e-3", "--accum-steps", "4"]
CKPT_CFG = dict(num_layers=4)
CKPT_M = 2


def _jax_params():
    """Seeded weights as a JAX ``GPT2LMHead`` tree (drawn by the port's
    ``init_weights``, flax's initializers' distributions, and laid out by
    ``gpt2_params_to_jax``: no JAX compile)."""
    model = GPT2LMHead(workers.gpt2_cfg(), device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(0))
    return gpt2_params_to_jax(model.state_dict(), model.config)


def _ids(seed=1):
    return np.random.default_rng(seed).integers(
        0, JAX_CFG.vocab_size, (B, S)).astype(np.int64)


def _jax_logits(params, ids, pp):
    ptd.init_process_group(mesh_spec=JaxMeshSpec(dp=-1, pp=pp))
    with use_policy(F32):
        logits = jax.jit(lambda p: jax_pipeline_logits(
            JAX_CFG, p, jnp.asarray(ids), num_microbatches=pp))(params)
    ptd.destroy_process_group()
    return np.asarray(logits)


def _jax_loss_and_grads(params, ids, pp):
    """``jax.grad`` of the JAX pipelined loss on ``dp x pp``: the loss
    and every gradient under the port's names."""
    ptd.init_process_group(mesh_spec=JaxMeshSpec(dp=-1, pp=pp))
    with use_policy(F32):
        loss_fn = jax_pipelined_loss_fn(JAX_CFG, num_microbatches=pp)

        def loss(p):
            return loss_fn(p, {}, {"input_ids": jnp.asarray(ids)},
                           jax.random.key(0))[0]

        # one jitted program: eager, the shard_map'd loss compiles piece
        # by piece (ten times the time)
        value, grads = jax.jit(jax.value_and_grad(loss))(params)
    ptd.destroy_process_group()
    grads = {k: v.numpy() for k, v in gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, grads), JAX_CFG).items()}
    return float(value), grads


def _w1_checkpoint(ckpt_dir):
    """A world-1 GPT-2 (the checkpoint config), one clip + AdamW step,
    saved; its snapshot under the workers' names."""
    cfg = workers.gpt2_cfg(**CKPT_CFG)
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(5))
    inner = optim.AdamW(model, lr=1e-3, weight_decay=1e-4)
    state = TrainState(model, optim.clip_grad_norm(inner, 1.0),
                       policy=Policy.full())
    step = build_train_step(causal_lm_loss_fn(model), accum_steps=CKPT_M)
    state, _ = step(state, {"input_ids": torch.from_numpy(_ids(3))})
    save_checkpoint(ckpt_dir, state)
    return model, inner, state


def _whole_snapshot(model, inner, step):
    out = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    for key in ("exp_avg", "exp_avg_sq"):
        out.update({f"{key}:{n}": inner.state[p][key].numpy().copy()
                    for n, p in model.named_parameters()})
    out["step"] = step
    out["step_count"] = sorted({int(s["step"]) for s in inner.state.values()})
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_lm")
    params = _jax_params()
    sd = {k: v.numpy() for k, v in gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), JAX_CFG).items()}
    ids = _ids()
    w1 = _w1_checkpoint(str(tmp / "w1"))
    batch = {"input_ids": _ids(4)}
    ranks = torch_dp_workers.spawn(workers.world, 4, [
        ("pp2", "lm_grads", ({}, dict(dp=2, pp=2), sd, ids, 2)),
        ("pp4", "lm_grads", ({}, dict(dp=1, pp=4), sd, ids, 4)),
        ("refuse", "refusals", (dict(num_layers=3), dict(dp=2, pp=2))),
        ("ckpt", "ckpt_round_trip", (CKPT_CFG, dict(dp=2, pp=2),
                                     str(tmp / "w1"), str(tmp / "p2"),
                                     batch, CKPT_M)),
        ("dp2pp2", "recipe", (RECIPE_ARGV + ["--dp", "2", "--pp", "2"],
                              {})),
    ], timeout_s=240)
    # after the world: its ranks start slowly beside XLA's threads
    jax_ref = dict(logits={pp: _jax_logits(params, ids, pp) for pp in (2, 4)},
                   loss_and_grads=_jax_loss_and_grads(params, ids, 2))
    return dict(params=params, ids=ids, w1=w1, tmp=tmp, ranks=ranks,
                jax=jax_ref)


@pytest.mark.parametrize("pp", [2, 4])
def test_logits_loss_and_every_gradient_match_jax(run, pp):
    """Logits against the JAX pipeline at the same stage count; the loss
    and gradients against ``jax.grad`` at ``pp`` 2 (the same function at
    every stage count, to rounding)."""
    ranks = run["ranks"]
    case = f"pp{pp}"
    logits = run["jax"]["logits"][pp]
    loss, grads = run["jax"]["loss_and_grads"]
    for rank, res in enumerate(ranks):
        got = res[case]
        assert_close(got["logits"], logits, LOGIT_RTOL, f"stage {rank}")
        np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
        # this stage's blocks and every replicated leaf, on every stage
        lo, hi = got["layers"]
        want = {k for k in grads if not k.startswith("blocks.")
                or lo <= int(k.split(".")[1]) < hi}
        assert sorted(got["grads"]) == sorted(want), rank
        for name in want:
            assert_close(got["grads"][name], grads[name], GRAD_RTOL,
                         f"stage {rank} grad {name}")


def test_pipeline_parallel_allocates_only_its_stages_blocks(run):
    for pp in (2, 4):
        per = JAX_CFG.num_layers // pp
        for rank, res in enumerate(run["ranks"]):
            stage = rank % pp   # the mesh's pp coordinate
            assert res[f"pp{pp}"]["blocks"] == per
            assert tuple(res[f"pp{pp}"]["layers"]) == (stage * per,
                                                       (stage + 1) * per)


def test_dp2_pp2_recipe_trains_as_world_one(run):
    got = [res["dp2pp2"] for res in run["ranks"]]
    want = workers.recipe(RECIPE_ARGV + ["--strategy", "dp"], {})
    for res in got:   # every rank logs the world's mean
        assert res["step"] == want["step"] == 3
        np.testing.assert_allclose(res["losses"], want["losses"],
                                   rtol=RECIPE_LOSS_RTOL)
        assert res["losses"][-1] < res["losses"][0]
        for k in ("loss", "perplexity"):
            np.testing.assert_allclose(res["eval"][k], want["eval"][k],
                                       rtol=RECIPE_LOSS_RTOL)


def test_refusals():
    model = GPT2LMHead(workers.gpt2_cfg(), device="cpu",
                       policy=Policy.full())
    ids = torch.zeros(2, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="segment_ids"):
        pipelined_causal_lm_loss_fn(model, num_microbatches=2)(
            {"input_ids": ids, "segment_ids": ids}, None)
    base = ["--size", "tiny", "--device", "cpu", "--pp", "2"]
    with pytest.raises(SystemExit, match="vocab-chunk"):
        gpt2_recipe.main(base + ["--vocab-chunk", "16"])
    with pytest.raises(SystemExit, match="--pack"):
        gpt2_recipe.main(base + ["--pack"])
    # --pp with --tp trains (tests/test_torch_gpt2_tp.py); a world of one
    # cannot hold the pp x tp mesh
    with pytest.raises(ValueError, match="not divisible"):
        gpt2_recipe.main(base + ["--tp", "2"])
    with pytest.raises(NotImplementedError, match="A10.6"):
        gpt2_recipe.main(base + ["--strategy", "auto"])
    # one stage: the whole model's layers, the plain forward's logits
    with torch.no_grad():
        got = gpt2_pipeline_logits(model, ids, num_microbatches=2)
        np.testing.assert_allclose(got.numpy(), model(ids).numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_layers_not_divisible_and_dp_on_pp_raise(run):
    for res in run["ranks"]:
        errors = res["refuse"]
        for key in ("wrap", "logits"):
            assert "divisible" in errors[key], errors
        for key in ("dp", "fsdp"):
            assert "PipelineParallel" in errors[key], errors


def test_world1_checkpoint_restores_under_pp2_bitwise(run):
    model, inner, state = run["w1"]
    want = _whole_snapshot(model, inner, state.step)
    for rank, res in enumerate(run["ranks"]):
        got = res["ckpt"]["restored"]
        assert got["step"] == want["step"] == 1
        assert got["step_count"] == want["step_count"] == [1]
        keys = [k for k in got if k not in ("step", "step_count")]
        assert len(keys) < len(want) - 2, "a stage holds its layers only"
        for k in keys:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pp2_checkpoint_restores_at_world1_and_in_jax(run):
    saved = {}
    for res in run["ranks"]:
        for k, v in res["ckpt"]["saved"].items():
            # a stage's data replicas hold the same state, to the bit
            if k in saved:
                np.testing.assert_array_equal(v, saved[k], err_msg=k)
            saved[k] = v
    ckpt = str(run["tmp"] / "p2")
    model = GPT2LMHead(workers.gpt2_cfg(**CKPT_CFG), device="cpu",
                       policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(7))
    inner = optim.AdamW(model, lr=1e-3, weight_decay=1e-4)
    state = TrainState(model, optim.clip_grad_norm(inner, 1.0),
                       policy=Policy.full())
    restore_checkpoint(ckpt, state)
    got = _whole_snapshot(model, inner, state.step)
    assert sorted(got) == sorted(saved)
    for k in saved:
        np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
    assert got["step"] == 2 and got["step_count"] == [2]

    # the JAX package restores it, every leaf to the bit (the template:
    # JAX_CFG's params, the checkpoint config's shapes)
    template = JaxTrainState.create(
        apply_fn=JaxGPT2(JAX_CFG).apply, params=run["params"],
        tx=optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3)))
    restored = jax_restore_checkpoint(ckpt, template)
    leaves = {k: np.asarray(v) for k, v in _leaf_files(restored)}
    cfg = workers.gpt2_cfg(**CKPT_CFG)
    names = [n for n, _ in model.named_parameters()]

    def flat(tree, prefix):
        out = {}
        for k, v in tree.items():
            name = f"{prefix}_{k}"
            out.update(flat(v, name) if isinstance(v, dict)
                       else {name: np.asarray(v)})
        return out

    want = {"step": np.asarray(2, np.int32),
            "opt_state_1_0_count": np.asarray(2, np.int32)}
    for prefix, key in (("params", None), ("opt_state_1_0_mu", "exp_avg"),
                        ("opt_state_1_0_nu", "exp_avg_sq")):
        sd = {n: torch.from_numpy(saved[n if key is None else f"{key}:{n}"])
              for n in names}
        want.update(flat(gpt2_params_to_jax(sd, cfg), prefix))
    for name, v in want.items():
        np.testing.assert_array_equal(leaves[name], v, err_msg=name)
