"""FSDP checkpoints in the JAX ``TrainState``'s format (each rank writes
its own rows of every parameter and moment as boxes of the JAX leaf),
on the tiny Llama of ``tests/torch_fsdp_workers.py`` (uneven shards, a
kv head cut in two at world 2), over gloo:

* a JAX-written Llama ``TrainState`` (``chain(clip_by_global_norm,
  adamw)``, every leaf redrawn) restores into the port under FSDP at
  worlds 2 and 1: parameters, both moments, step and count equal to the
  bit;
* that world-2 state, trained two more steps and saved by both ranks,
  restores in the JAX package's ``restore_checkpoint`` bitwise (every
  leaf equal to the files and to the port's gathered state), and at
  world 1 in the port bitwise;
* the same under HSDP in a world of 4 (``MeshSpec(dp=2, fsdp=2)``):
  replica 0's two ranks write every row once, replica 1 writes nothing,
  and the checkpoint restores in JAX and at world 1 bitwise.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from pytorch_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train import TrainState as JaxTrainState
from pytorch_distributed_tpu.train.checkpoint import (
    _leaf_files,
    restore_checkpoint as jax_restore_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from pytorch_distributed_tpu_torch.train import verify_checkpoint
from pytorch_distributed_tpu_torch.train.ckpt_io import load_checkpoint
from tests import torch_dp_workers
from tests import torch_fsdp_workers as workers

JAX_STEP, MORE_STEPS = 5, 2


def _template():
    jmodel = JaxLlama(JaxLlamaConfig(**workers.CFG))
    with use_policy(JaxPolicy(compute_dtype=jnp.float32)):
        params = jmodel.init(jax.random.key(0),
                             jnp.zeros((1, 8), jnp.int32))["params"]
    tx = optax.chain(optax.clip_by_global_norm(workers.MAX_NORM),
                     optax.adamw(workers.LR))
    return JaxTrainState.create(apply_fn=jmodel.apply, params=params, tx=tx)


def _randomized(jstate, seed, step):
    rng = np.random.default_rng(seed)

    def redraw(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return np.full(x.shape, step, x.dtype)
        return (rng.normal(size=x.shape) * 0.05).astype(x.dtype) ** 2 + 1e-3

    return jax.tree_util.tree_map(redraw, jstate)


MESHES = {"fsdp2": (2, dict(dp=1, fsdp=-1)),
          "hsdp2x2": (4, dict(dp=2, fsdp=2))}


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("fsdp_ckpt_jax"))
    jstate = _randomized(_template(), seed=3, step=JAX_STEP)
    jax_save_checkpoint(jdir, jstate)
    w1_jax = torch_dp_workers.in_process(workers.fsdp_ckpt,
                                         {"restore": jdir, "seed": 2})
    return dict(jstate=jstate, jdir=jdir, w1_jax=w1_jax)


@pytest.fixture(scope="module", params=sorted(MESHES))
def worlds(request, jax_ckpt, tmp_path_factory):
    """The JAX checkpoint restored under one of ``MESHES`` (``w2``: the
    ranks' results), trained and saved to ``pdir``, and restored from
    there at world 1."""
    world, spec = MESHES[request.param]
    pdir = str(tmp_path_factory.mktemp(f"fsdp_ckpt_{request.param}"))
    w2 = torch_dp_workers.spawn(
        workers.fsdp_ckpt, world,
        {"spec": spec, "restore": jax_ckpt["jdir"], "steps": MORE_STEPS,
         "save": pdir, "seed": 1})
    w1_port = torch_dp_workers.in_process(workers.fsdp_ckpt,
                                          {"restore": pdir, "seed": 2})
    return dict(jax_ckpt, pdir=pdir, w2=w2, w1_port=w1_port)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def _assert_state_equal(got, want, what):
    for key in ("params", "exp_avg", "exp_avg_sq"):
        w = dict(_flat(want[key]))
        g = dict(_flat(got[key]))
        assert sorted(g) == sorted(w), (what, key)
        for path, arr in g.items():
            np.testing.assert_array_equal(arr, w[path],
                                          err_msg=f"{what} {key} {path}")
    assert got["step"] == want["step"], what


def _jax_as_port_snapshot(jstate):
    adam = jstate.opt_state[1][0]
    return {"params": jax.device_get(jstate.params),
            "exp_avg": jax.device_get(adam.mu),
            "exp_avg_sq": jax.device_get(adam.nu),
            "step": int(jstate.step)}


@pytest.mark.parametrize("world", [2, 1])
def test_jax_checkpoint_restores_into_fsdp(worlds, world):
    want = _jax_as_port_snapshot(worlds["jstate"])
    results = worlds["w2"] if world == 2 else [worlds["w1_jax"]]
    for res in results:
        _assert_state_equal(res["restored"], want, f"world {len(results)}")
        assert set(res["diff"].values()) == {0.0}


def test_world2_checkpoint_restores_in_jax_bitwise(worlds):
    pdir = worlds["pdir"]
    assert verify_checkpoint(pdir) == []
    files = load_checkpoint(os.path.join(pdir, "latest")).leaves
    restored = jax_restore_checkpoint(pdir, _template())
    got = {k: np.asarray(v) for k, v in _leaf_files(restored)}
    assert sorted(got) == sorted(files)
    for name, arr in files.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    assert int(restored.step) == JAX_STEP + MORE_STEPS
    assert int(restored.opt_state[1][0].count) == JAX_STEP + MORE_STEPS
    # ... and the files are the port's whole state, gathered
    final = worlds["w2"][0]["final"]
    _assert_state_equal(_jax_as_port_snapshot(restored), final, "jax")
    for res in worlds["w2"]:
        assert set(res["diff_saved"].values()) == {0.0}


def test_each_rank_wrote_its_own_rows(worlds):
    files = os.listdir(os.path.join(worlds["pdir"], "latest"))
    for kind in ("params_layers_block_k_kernel", "opt_state_1_0_mu_embed",
                 "opt_state_1_0_nu_layers_block_gate", "params_lm_head"):
        writers = {f.split(".")[-2][:2] for f in files if kind in f}
        # under HSDP ranks 0 and 1 are replica 0: 2 and 3 write nothing
        assert writers == {"p0", "p1"}, (kind, writers)
    # rank 1's rows of k (8 of the one kv head's 16) are a partial-head box
    with open(os.path.join(worlds["pdir"], "latest",
                           "manifest.json")) as f:
        manifest = json.load(f)
    entry = next(e for e in manifest["leaves"]
                 if e["path"] == "params_layers_block_k_kernel")
    boxes = sorted((tuple(s["start"]), tuple(s["stop"]))
                   for s in entry["shards"])
    assert ((0, 0, 0, 8), (1, 64, 1, 16)) in boxes


def test_world2_checkpoint_restores_at_world1(worlds):
    want = worlds["w2"][0]["final"]
    _assert_state_equal(worlds["w1_port"]["restored"], want, "world 1")
    assert set(worlds["w1_port"]["diff"].values()) == {0.0}
