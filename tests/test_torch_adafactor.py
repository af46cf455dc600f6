"""The port's Adafactor (``optim.Adafactor``) held against optax's, on
the JAX Llama's scan-stacked leaves.

* A 2-layer Llama-tiny, weights carried from a JAX init, five steps of
  the same seeded numpy gradients on both sides (drawn in the JAX leaf
  layout, carried to the port by ``llama_params_from_jax``), with
  ``min_dim_size_to_factor`` lowered to 8 so that the 4-D q/k/v/o
  kernels ``[L, D, H, hd]``, gate/up/down, the embedding and the head
  factor (layer by layer) and the ``[L, D]`` norm scales do not, and to
  2, where the norms factor over their layer axis too (the whole-leaf
  path): the parameters and every
  ``v_row``/``v_col``/``v`` within 1e-6 of the reference's largest
  magnitude (8 f32 ulps: 1.5e-7 is read; the means sum in another
  order).
* The same optimizer built on the parameters alone (each layer's
  tensor its own block, in the port's layout) departs from
  optax by more than a tenth of the update: the grouping by JAX leaf is
  what makes the trajectory optax's.
* FSDP over gloo at world 2 (the embedding, head, gate and up split
  unevenly, the one KV head cut in two, so ``k`` and ``v`` take the
  whole-leaf path and the rest the per-layer one) against world 1: the
  ranks' mean loss, the parameters and the factored statistics within
  1e-6 (the shard sums add in another order).
* The Llama recipe's ``--optimizer adafactor`` for 2 steps against the
  JAX recipe's step (``optim.Adafactor(lr)`` alone, no clip) on the
  recipe's own initial weights and batches, f32: losses within 1e-5,
  parameters within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu import optim as joptim
from pytorch_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from pytorch_distributed_tpu.runtime.precision import Policy as JaxPolicy
from pytorch_distributed_tpu.runtime.precision import use_policy
from pytorch_distributed_tpu.train import (
    TrainState as JaxTrainState,
    build_train_step as jax_build_train_step,
    causal_lm_loss_fn as jax_loss_fn,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.interop import (
    llama_params_from_jax,
    llama_params_to_jax,
)
from pytorch_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from tests import torch_dp_workers
from tests import torch_fsdp_workers as workers
from tests.torch_dp_workers import RANK_THREADS
from tests.torch_parity import assert_close

LR, MIN_DIM, STEPS = 1e-2, 8, 5
RTOL = 1e-6


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads, as the spawned ranks take
    (``torch_dp_workers.RANK_THREADS``): the test workers share the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    jmodel = JaxLlama(JaxLlamaConfig.tiny())
    with use_policy(JaxPolicy(compute_dtype=jnp.float32)):
        params = jmodel.init(jax.random.key(0),
                             jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.device_get(params)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def _run(params, per_tensor=False, min_dim=MIN_DIM):
    """``STEPS`` steps of optax's and the port's Adafactor on the same
    seeded gradients: (optax params, optax state, port model, port
    optimizer). ``per_tensor`` builds the port's on the parameters
    alone, each tensor its own leaf."""
    cfg = LlamaConfig.tiny()
    model = LlamaForCausalLM(cfg, device="cpu", policy=Policy.train())
    model.load_state_dict(llama_params_from_jax(params, cfg))
    opt = optim.Adafactor(list(model.parameters()) if per_tensor else model,
                          LR, min_dim_size_to_factor=min_dim)
    tx = joptim.Adafactor(LR, min_dim_size_to_factor=min_dim)
    jp, st = params, tx.init(params)
    rng = np.random.default_rng(0)
    for _ in range(STEPS):
        grads = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32),
            params)
        upd, st = tx.update(grads, st, jp)
        jp = optax.apply_updates(jp, upd)
        pg = llama_params_from_jax(grads, cfg)
        for n, p in model.named_parameters():
            p.grad = pg[n].clone()
        opt.step()
    return jax.device_get(jp), jax.device_get(st), model, opt


@pytest.mark.parametrize("min_dim", [MIN_DIM, 2])
def test_five_steps_equal_optax_on_stacked_leaves(jax_params, min_dim):
    jp, st, model, opt = _run(jax_params, min_dim=min_dim)
    got = dict(_flat(llama_params_to_jax(model.state_dict(), model.config)))
    for path, want in _flat(jp):
        assert_close(got[path], want, RTOL, path)
    factored = {leaf.path for leaf in opt.leaves if opt.factored(leaf)}
    assert {"layers/block/q/kernel", "layers/block/o/kernel",
            "embed/embedding"} <= factored
    # at 2 the norms' [L, D] leaves factor over the layer axis too: the
    # whole-leaf path; at 8 they keep v whole
    assert ("layers/block/attn_norm/scale" in factored) == (min_dim == 2)
    rows, cols, vs = (dict(_flat(t)) for t in (st[0].v_row, st[0].v_col,
                                               st[0].v))
    for leaf in opt.leaves:
        held = opt.leaf_state(leaf)
        assert_close(held["v_row"], rows[leaf.path], RTOL, leaf.path)
        assert_close(held["v_col"], cols[leaf.path], RTOL, leaf.path)
        if leaf.path in factored:
            assert tuple(held["v_row"].shape) == rows[leaf.path].shape
            assert vs[leaf.path].shape == (1,)
        else:
            v = torch.stack([opt.state[p]["v"] for p in leaf.params])
            assert_close(v.reshape(vs[leaf.path].shape), vs[leaf.path],
                         RTOL, leaf.path)
    assert {int(opt.state[p]["step"]) for p in model.parameters()} == {STEPS}


def test_per_tensor_blocks_depart_from_optax(jax_params):
    jp, _, model, _ = _run(jax_params, per_tensor=True)
    got = dict(_flat(llama_params_to_jax(model.state_dict(), model.config)))
    init = dict(_flat(jax_params))
    path = "layers/block/q/kernel"
    want = dict(_flat(jp))[path]
    moved = np.abs(want - init[path]).max()
    assert np.abs(got[path] - want).max() > 0.1 * moved


def test_fsdp_world2_equals_world1():
    spec = dict(dp=1, fsdp=-1)
    two = torch_dp_workers.spawn(workers.adafactor_steps, 2, spec)
    one = torch_dp_workers.in_process(workers.adafactor_steps, spec)
    # each rank's loss is of its half of the batch
    assert_close(np.mean([r["losses"] for r in two], axis=0),
                 one["losses"], RTOL, "losses")
    # rows that cut the one KV head (16 rows split 8 + 8) take the whole
    # leaf; every other factored leaf goes layer by layer on its rows
    assert not two[0]["per_layer"]["layers/block/k/kernel"]
    assert two[0]["per_layer"]["layers/block/q/kernel"]
    assert two[0]["per_layer"]["embed/embedding"]
    assert all(one["per_layer"].values())
    for res in two:
        for path, want in _flat(one["params"]):
            assert_close(dict(_flat(res["params"]))[path], want, RTOL, path)
        for key, held in one.items():
            if key in ("losses", "params", "per_layer"):
                continue
            for k, want in held.items():
                assert_close(res[key][k], want, RTOL, f"{key} {k}")


def test_recipe_adafactor_steps_equal_the_jax_recipe():
    """``recipes/llama_fsdp.py --optimizer adafactor`` against the JAX
    recipe's ``ptd.optim.Adafactor(lr)`` train step, in f32, on the port
    recipe's initial weights and first two batches."""
    from pytorch_distributed_tpu_torch.data import (
        DataLoader,
        SyntheticTextDataset,
    )
    from pytorch_distributed_tpu_torch.parallel import FSDP
    from pytorch_distributed_tpu_torch.recipes import llama_fsdp as recipe
    from pytorch_distributed_tpu_torch.runtime import distributed as dist
    from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec

    argv = ["--size", "tiny", "--device", "cpu", "--batch-size", "4",
            "--seq-len", "16", "--log-every", "1", "--steps-per-epoch", "2",
            "--optimizer", "adafactor", "--lr", str(LR)]
    full = recipe.Policy.train
    recipe.Policy.train = staticmethod(Policy.full)
    try:
        trainer = recipe.main(argv)
        dist.init_process_group("gloo", device="cpu", world_size=1, rank=0,
                                init_method=f"tcp://localhost:"
                                f"{torch_dp_workers._free_port()}")
        try:
            cfg = LlamaConfig.tiny()
            model, _ = recipe.build_model(
                cfg, FSDP("cpu", MeshSpec(dp=1, fsdp=-1)), "cpu", 0,
                Policy.full())
            init = {n: p.full_tensor().detach().clone()
                    for n, p in model.named_parameters()}
        finally:
            dist.destroy_process_group()
    finally:
        recipe.Policy.train = full
    assert isinstance(trainer.state.optimizer, optim.Adafactor)
    ds = SyntheticTextDataset(n=2 * 4, seq_len=16, vocab_size=512, seed=0)
    loader = DataLoader(ds, 4, seed=0)
    loader.set_epoch(0)
    jmodel = JaxLlama(JaxLlamaConfig.tiny())
    params = llama_params_to_jax(init, cfg)
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                  tx=joptim.Adafactor(LR))
    with use_policy(JaxPolicy(compute_dtype=jnp.float32)):
        jstep = jax.jit(jax_build_train_step(jax_loss_fn(jmodel)))
        want = []
        for batch in list(loader)[:2]:
            jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
            jstate, metrics = jstep(jstate, jb)
            want.append(float(metrics["loss"]))
    got = [r["loss"] for r in trainer.history]
    assert_close(got, want, 1e-5, "losses")
    final = {n: p.full_tensor() for n, p in
             trainer.state.model.named_parameters()}
    back = dict(_flat(llama_params_to_jax(final, cfg)))
    for path, w in _flat(jax.device_get(jstate.params)):
        assert_close(back[path], w, 1e-5, path)


def test_refusals():
    m = torch.nn.Linear(4, 4)
    with pytest.raises(ValueError, match="explicit lr"):
        optim.Adafactor(m, None)
    with pytest.raises(NotImplementedError, match="ZeRO-1"):
        optim.Adafactor([{"params": list(m.parameters())}], 1e-3)
    cfg = dataclasses.replace(LlamaConfig.tiny(), num_layers=1)
    model = LlamaForCausalLM(cfg, device="cpu", policy=Policy.train())
    opt = optim.Adafactor(model, 1e-3)
    # at the default min_dim_size_to_factor (128) no leaf of the tiny
    # model (hidden 64) has two axes that large: every leaf keeps v whole
    assert not any(opt.factored(leaf) for leaf in opt.leaves)
    assert opt.factored(type(opt.leaves[0])("x", [None], [None],
                                            (32, 4096, 32, 128), True)) \
        == (3, 1)   # Llama-3-8B's q kernel: over hd and D
