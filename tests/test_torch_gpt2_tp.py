"""GPT-2's tensor parallelism in the port (``models/gpt2.py``'s fused
qkv grouped by rank, ``parallel.ZeRO1`` with a model axis,
``parallel.DataParallel`` on a ``dp x tp`` mesh, ``PipelineParallel`` at
``pp x tp``, ``interop.gpt2_slots``' split heads) against the JAX
package, GPT-2-tiny in f32 with dropout 0, weights from the JAX
``init`` through ``interop``:

* the logits at tp 2 and at dp 2 x tp 2 within ``1e-5 x max|ref|`` of
  the JAX model's;
* three clip + AdamW(1e-4) steps at dp 2 x tp 2 under ``zero1`` and
  under ``dp``, against the JAX recipe's step under
  ``ZeRO1(extra_rules=gpt2_partition_rules())`` on a ``dp x tp`` mesh:
  the losses within 1e-5 and the parameters within ``1e-4 x max|ref|``;
* the placement the JAX ``test_zero1_tp_params_stay_tp_only`` pins:
  the parameters TP-sharded and whole over ``dp``, the moments of each
  TP shard split over ``dp`` (each parameter's held by one data rank);
* the dp 2 x tp 2 ZeRO-1 checkpoint: bitwise against the state, restored
  bitwise at tp 4 in the same world, at world 1 and in the JAX package;
* one pipelined step at pp 2 x tp 2 against the loss of the JAX
  ``PipelineParallel(extra_rules=...)`` pipelined forward on its mesh;
* the Llama recipe's ``--strategy zero1`` and ``dp`` with ``--tp 2`` at
  ``--dp 2``: the losses of its ``fsdp`` run on the same mesh.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pytorch_distributed_tpu as ptd
from pytorch_distributed_tpu.models import gpt2 as jax_gpt2
from pytorch_distributed_tpu.parallel import ZeRO1 as JaxZeRO1
from pytorch_distributed_tpu.parallel.pipeline_lm import (
    PipelineParallel as JaxPipelineParallel,
    pipelined_causal_lm_loss_fn as jax_pipelined_loss_fn,
)
from pytorch_distributed_tpu.runtime.mesh import MeshSpec as JaxMeshSpec
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train import TrainState as JaxTrainState
from pytorch_distributed_tpu.train import build_train_step as jax_step
from pytorch_distributed_tpu.train import causal_lm_loss_fn as jax_loss_fn
from pytorch_distributed_tpu.train.checkpoint import (
    _leaf_files,
    restore_checkpoint as jax_restore_checkpoint,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.interop import gpt2_params_from_jax
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from pytorch_distributed_tpu_torch.train import TrainState, verify_checkpoint
from pytorch_distributed_tpu_torch.train import restore_checkpoint
from pytorch_distributed_tpu_torch.train.checkpoint import checkpoint_diff
from pytorch_distributed_tpu_torch.train.ckpt_io import load_checkpoint
from tests import torch_dp_workers
from tests import torch_gpt2_tp_workers as workers
from tests.torch_parity import assert_close

LOGIT_RTOL, LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-5, 1e-4
F32 = JaxPolicy(compute_dtype=jnp.float32)
JAX_CFG = dataclasses.replace(jax_gpt2.GPT2Config.tiny(), dropout_rate=0.0)
CFG = dataclasses.replace(GPT2Config.tiny(), dropout_rate=0.0)
B, S = 4, 16
LLAMA_ARGV = ["--size", "tiny", "--device", "cpu", "--backend", "gloo",
              "--batch-size", "4", "--seq-len", "16", "--steps-per-epoch",
              "2", "--log-every", "1", "--tp", "2", "--dp", "2"]


def _ids(seed):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (B, S)).astype(np.int64)


def _tx():
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(workers.LR))


def _jax_zero1_steps(jmodel, params, data):
    """The JAX recipe's step under ``ZeRO1(extra_rules=
    gpt2_partition_rules())`` on a ``dp x tp`` mesh of the CPU devices."""
    ptd.init_process_group(mesh_spec=JaxMeshSpec(dp=-1, tp=2))
    try:
        strategy = JaxZeRO1(extra_rules=jax_gpt2.gpt2_partition_rules())
        state = strategy.place(JaxTrainState.create(
            apply_fn=jmodel.apply, params=params, tx=_tx()))
        step = strategy.compile(jax_step(jax_loss_fn(jmodel)), state)
        losses = []
        for batch in data:
            with use_policy(F32):
                state, metrics = step(state, strategy.shard_batch(
                    {k: v.astype(np.int32) for k, v in batch.items()}))
            losses.append(float(metrics["loss"]))
        return losses, jax.device_get(state.params)
    finally:
        ptd.destroy_process_group()


def _jax_pipeline_loss(params, ids):
    """The loss of the JAX ``PipelineParallel(extra_rules=...)`` pipelined
    forward at pp 2 x tp 2 (the first step's loss)."""
    ptd.init_process_group(mesh_spec=JaxMeshSpec(dp=-1, pp=2, tp=2))
    try:
        strategy = JaxPipelineParallel(
            extra_rules=jax_gpt2.gpt2_partition_rules())
        placed = strategy.place(JaxTrainState.create(
            apply_fn=None, params=params, tx=optax.sgd(0.0))).params
        loss_fn = jax_pipelined_loss_fn(JAX_CFG, num_microbatches=4)
        with use_policy(F32):
            loss = jax.jit(lambda p: loss_fn(
                p, {}, {"input_ids": jnp.asarray(ids, jnp.int32)},
                jax.random.key(0))[0])(placed)
        return float(loss)
    finally:
        ptd.destroy_process_group()


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gpt2_tp")
    jmodel = jax_gpt2.GPT2LMHead(JAX_CFG)
    ids = _ids(3)
    with use_policy(F32):
        params = jax.device_get(jax.jit(jmodel.init)(
            jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    sd = {k: v.numpy() for k, v in gpt2_params_from_jax(params, CFG).items()}
    data = [{"input_ids": _ids(11 + i)} for i in range(3)]

    def case(spec, strategy="dp", steps=None, **kw):
        return dict(cfg=CFG, spec=spec, strategy=strategy, sd=sd, ids=ids,
                    steps=steps, **kw)

    def references():
        with use_policy(F32):
            logits = np.asarray(jmodel.apply({"params": params},
                                             jnp.asarray(ids, jnp.int32)))
        return dict(logits=logits,
                    steps=_jax_zero1_steps(jmodel, params, data),
                    pp_loss=_jax_pipeline_loss(params,
                                               data[0]["input_ids"]))

    ckpt = str(tmp / "dp2tp2")
    w4, w2, ref = torch_dp_workers.spawn_worlds(
        (workers.train_world, 4, {
            "cases": {
                "zero1": case(dict(dp=2, tp=2), "zero1", data, ckpt=ckpt,
                              restore_spec=dict(dp=1, tp=4)),
                "dp": case(dict(dp=2, tp=2), "dp", data),
                "pp2tp2": dict(cfg=CFG, spec=dict(dp=1, pp=2, tp=2), sd=sd,
                               micro=4, batch=data[0]),
            },
            "llama_recipe": [LLAMA_ARGV + ["--strategy", s]
                             for s in ("zero1", "dp", "fsdp")]}),
        (workers.train_world, 2, {"cases": {"tp2": case(dict(dp=1, tp=2))}}),
        timeout_s=240, meanwhile=references)
    return dict(params=params, ckpt=ckpt, w4=w4, w2=w2, jmodel=jmodel, **ref)


@pytest.mark.parametrize("world, case", [(2, "tp2"), (4, "zero1"),
                                         (4, "dp")])
def test_logits_match_jax(run, world, case):
    ranks = run["w2"] if world == 2 else run["w4"]
    for rank, res in enumerate(ranks):
        got = res[case]
        assert_close(got["logits"], run["logits"], LOGIT_RTOL,
                     f"{case} rank {rank}")
        # each rank holds its half of the heads and of the MLP
        assert got["local"]["blocks.0.attn_qkv.weight"] == (96, 64)
        assert got["local"]["blocks.0.mlp_down.weight"] == (64, 128)
        assert got["local"]["wte.weight"] == (512, 32)


@pytest.mark.parametrize("strategy", ["zero1", "dp"])
def test_steps_match_the_jax_zero1_step(run, strategy):
    losses, params = run["steps"]
    want = dict(_flat(params))
    ranks = run["w4"]
    # each rank logs its data share's mean; the two shares' mean is the
    # batch's
    assert_close(np.mean([r[strategy]["losses"] for r in ranks], axis=0),
                 losses, LOSS_RTOL, f"{strategy} losses")
    for rank, res in enumerate(ranks):
        for path, arr in _flat(res[strategy]["params"]):
            if path.endswith("attn_qkv/bias"):
                # the key bias's gradient is exactly zero, and Adam turns
                # its rounding noise into +-lr moves in either framework:
                # the query and value biases only
                arr, want_arr = arr[:, ::2], want[path][:, ::2]
            else:
                want_arr = want[path]
            assert_close(arr, want_arr, PARAM_RTOL,
                         f"{strategy} rank {rank} {path}")


def test_zero1_params_stay_tp_only_and_moments_split_over_dp(run):
    ranks = run["w4"]
    names = sorted(ranks[0]["zero1"]["local"])
    for tp in (0, 1):
        # ranks (dp, tp) in the JAX order: dp-major
        a, b = ranks[tp]["zero1"], ranks[2 + tp]["zero1"]
        assert (a["data"], b["data"]) == (0, 1)
        assert not set(a["owned"]) & set(b["owned"])
        assert sorted(a["owned"] + b["owned"]) == names
        assert a["owned"] and b["owned"]
        for res in (a, b):
            # parameters: the TP shard whole on every dp rank
            assert res["local"] == ranks[tp]["dp"]["local"]
            # moments: this rank's parameters' TP shards, nothing else
            assert sorted(res["moments"]) == res["owned"]
            for n, shape in res["moments"].items():
                assert shape == res["local"][n]


def _w1_state():
    model = GPT2LMHead(CFG, device="cpu", policy=Policy.full())
    inner = optim.AdamW(model, lr=workers.LR, weight_decay=1e-4)
    return model, TrainState(model, optim.clip_grad_norm(inner, 1.0),
                             policy=Policy.full())


def test_dp2_tp2_checkpoint_restores_at_tp4_world1_and_in_jax(run):
    ckpt = run["ckpt"]
    files = load_checkpoint(os.path.join(ckpt, "latest")).leaves
    assert verify_checkpoint(ckpt) == []
    saved = {f"params_{p.replace('/', '_')}": a
             for p, a in _flat(run["w4"][0]["zero1"]["params"])}
    for name, arr in saved.items():
        np.testing.assert_array_equal(files[name], arr, err_msg=name)
    for res in run["w4"]:
        got = res["zero1"]
        assert set(got["diff"].values()) == {0.0}
        assert set(got["restored"]["diff"].values()) == {0.0}
        assert got["restored"]["step"] == 3
        for path, arr in _flat(got["restored"]["params"]):
            np.testing.assert_array_equal(
                arr, saved[f"params_{path.replace('/', '_')}"],
                err_msg=f"tp 4 {path}")
    model, state = _w1_state()
    restore_checkpoint(ckpt, state)
    assert set(checkpoint_diff(ckpt, state).values()) == {0.0}
    assert state.step == 3
    # the JAX package restores the same leaves
    template = JaxTrainState.create(apply_fn=run["jmodel"].apply,
                                    params=run["params"], tx=_tx())
    restored = jax_restore_checkpoint(ckpt, template)
    got = {k: np.asarray(v) for k, v in _leaf_files(restored)}
    assert sorted(got) == sorted(files)
    for name, arr in files.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


def test_pipelined_step_at_pp2_tp2_matches_jax(run):
    for rank, res in enumerate(run["w4"]):
        got = res["pp2tp2"]
        np.testing.assert_allclose(got["loss"], run["pp_loss"],
                                   rtol=LOSS_RTOL, err_msg=f"rank {rank}")
        # its own layer of two, TP-sharded; the embedding on hidden
        assert got["local"]["blocks.0.attn_qkv.weight"] == (96, 64)
        assert "blocks.1.attn_qkv.weight" not in got["local"]
        assert got["local"]["wte.weight"] == (512, 32)
        # the stage's plain norms and positions in a group of their own
        assert got["groups"] == [["DTensor"], ["Parameter"]]
    assert [r["pp2tp2"]["stage"] for r in run["w4"]] == [0, 0, 1, 1]


def test_llama_recipe_zero1_and_dp_take_tp(run):
    for rank, res in enumerate(run["w4"]):
        zero1, dp, fsdp = res["llama_recipe"]
        assert len(fsdp) == 2
        assert_close(zero1, fsdp, LOSS_RTOL, f"zero1 rank {rank}")
        assert_close(dp, fsdp, LOSS_RTOL, f"dp rank {rank}")


def test_tp_shard_rows_of_the_fused_qkv_are_its_heads():
    """``set_qkv_ways`` regroups drawn rows so that each contiguous
    ``1 / tp`` chunk is one rank's q, k and v heads, and back."""
    model = GPT2LMHead(CFG, device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(0))
    w = model.blocks[0].attn_qkv.weight.detach().clone()
    D, hd = CFG.hidden_size, CFG.head_dim
    model.set_qkv_ways(2)
    got = model.blocks[0].attn_qkv.weight.detach()
    for r in range(2):
        chunk = got[r * 3 * D // 2:(r + 1) * 3 * D // 2].view(3, 2, hd, D)
        want = w.view(3, 4, hd, D)[:, 2 * r:2 * r + 2]
        torch.testing.assert_close(chunk, want, rtol=0, atol=0)
    torch.testing.assert_close(
        model.whole_rows("blocks.0.attn_qkv.weight", got), w, rtol=0,
        atol=0)
    model.set_qkv_ways(1)
    torch.testing.assert_close(model.blocks[0].attn_qkv.weight, w, rtol=0,
                               atol=0)
