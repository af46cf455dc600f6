"""Rank processes for tests/test_torch_fsdp.py and
tests/test_torch_fsdp_ckpt.py (spawned by ``torch_dp_workers.spawn``;
this module imports no JAX). Each rank joins a gloo group on localhost,
runs a tiny Llama under ``parallel.FSDP`` and returns numpy results in
the JAX layout (``llama_params_to_jax``), gathered with
``DTensor.full_tensor`` where a test compares whole tensors.

The model is ``CFG``: 2 layers, hidden 64, 4 query heads over one KV
head of 16 (so a rank's rows of ``k``/``v`` cut a head in two at
``fsdp`` 2), vocab 509 and FFN 97 (so the embedding, the head, gate and
up split unevenly: 255 + 254 and 49 + 48 rows).
"""

from __future__ import annotations

import numpy as np
import torch

from tests.torch_dp_workers import _join, _run

CFG = dict(vocab_size=509, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=1, intermediate_size=97, max_seq_len=128)
LR, DECAY, MAX_NORM, CHUNK = 1e-2, 1e-4, 1.0, 100
BATCH, SEQ, STEPS, ACCUM = 8, 16, 3, 2


def config(**kw):
    from pytorch_distributed_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(**dict(CFG, **kw))


def batches(seed=1, n=STEPS):
    """``n`` seeded global batches of ``BATCH`` x ``SEQ`` token rows."""
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, CFG["vocab_size"], (BATCH, SEQ))
             .astype(np.int64)} for _ in range(n)]


def build(strategy, seed=0, policy=None):
    """(model, TrainState) with clip(MAX_NORM) then AdamW(LR, DECAY):
    under ``strategy`` (an ``FSDP``, or None for one process)."""
    from pytorch_distributed_tpu_torch import optim
    from pytorch_distributed_tpu_torch.models.llama import LlamaForCausalLM
    from pytorch_distributed_tpu_torch.recipes.llama_fsdp import build_model
    from pytorch_distributed_tpu_torch.runtime.precision import Policy
    from pytorch_distributed_tpu_torch.train import TrainState

    policy = policy or Policy.full()
    if strategy is None:
        model = LlamaForCausalLM(config(), device="cpu", policy=policy)
        model.init_weights(torch.Generator().manual_seed(seed))
        opt = optim.AdamW(model, lr=LR, weight_decay=DECAY)
    else:
        model, _ = build_model(config(), strategy, "cpu", seed, policy)
        opt = strategy.optimizer(model, optim.AdamW, lr=LR,
                                 weight_decay=DECAY)
    opt = optim.clip_grad_norm(opt, MAX_NORM)
    return model, TrainState(model, opt, policy=policy)


def full(t) -> np.ndarray:
    """The whole tensor as numpy (gathered when it is a DTensor)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy().copy()


def snapshot(model, state):
    """Parameters and both moments (gathered) in the JAX layout, and the
    step."""
    from pytorch_distributed_tpu_torch.interop import (
        llama_params_to_jax,
        unwrap_optimizer,
    )

    _, adam, _ = unwrap_optimizer(state.optimizer)
    named = dict(model.named_parameters())
    out = {"params": llama_params_to_jax(
        {n: torch.from_numpy(full(p)) for n, p in named.items()},
        model.config)}
    for key in ("exp_avg", "exp_avg_sq"):
        moments = {n: torch.from_numpy(full(adam.state[p][key]))
                   for n, p in named.items() if key in adam.state.get(p, {})}
        if moments:
            out[key] = llama_params_to_jax(moments, model.config)
    out["step"] = state.step
    return out


def run_steps(model, state, strategy, data, accum):
    """The train step with the chunked loss over ``data`` (each batch
    this rank's share); returns the logged losses."""
    from pytorch_distributed_tpu_torch.train import (
        build_train_step,
        causal_lm_loss_fn,
    )

    step = build_train_step(causal_lm_loss_fn(model, vocab_chunk_size=CHUNK),
                            accum_steps=accum)
    losses = []
    for batch in data:
        tb = (strategy.shard_batch(batch) if strategy is not None
              else {k: torch.from_numpy(v) for k, v in batch.items()})
        state, metrics = step(state, tb)
        losses.append(float(metrics["loss"]))
    return losses


def head_grad_and_norm(model, strategy, batch):
    """One chunked-loss backward: the whole ``d(lm_head)`` and the global
    gradient norm the clip would take."""
    from pytorch_distributed_tpu_torch import optim
    from pytorch_distributed_tpu_torch.train import causal_lm_loss_fn

    tb = (strategy.shard_batch(batch) if strategy is not None
          else {k: torch.from_numpy(v) for k, v in batch.items()})
    model.zero_grad(set_to_none=True)
    loss, _ = causal_lm_loss_fn(model, vocab_chunk_size=CHUNK)(tb, None)
    loss.backward()
    norm = optim.global_norm([p.grad for p in model.parameters()])
    head = full(model.lm_head.weight.grad)
    model.zero_grad(set_to_none=True)
    return head, float(norm)


def fsdp_steps(rank, world, port, spec, out):
    """FSDP at ``world`` over ``MeshSpec(**spec)``: the seeded init, one
    chunked-loss backward's head gradient and norm, then ``STEPS`` steps
    of ``ACCUM`` microbatches; the mesh it built and the batch rows this
    rank keeps."""
    from pytorch_distributed_tpu_torch.parallel import FSDP
    from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec

    def body():
        _join(rank, world, port)
        strategy = FSDP("cpu", MeshSpec(**spec))
        model, state = build(strategy)
        res = {"init": snapshot(model, state)["params"],
               "mesh": (strategy.mesh.mesh_dim_names,
                        tuple(strategy.mesh.shape)),
               "rows": {n: strategy.shard_batch({"i": np.arange(n)})["i"]
                        .numpy() for n in (8, 9)},
               "local_rows": {n: tuple(p.to_local().shape)
                              for n, p in model.named_parameters()}}
        res["head_grad"], res["norm"] = head_grad_and_norm(
            model, strategy, batches(seed=7, n=1)[0])
        res["losses1"] = run_steps(model, state, strategy, batches()[:1], 1)
        res["after1"] = snapshot(model, state)["params"]
        res["losses3"] = run_steps(model, state, strategy, batches()[1:],
                                   ACCUM)
        res["after3"] = snapshot(model, state)
        return res

    _run(rank, out, body)


def fsdp_ckpt(rank, world, port, job, out):
    """Checkpoints under FSDP at ``world``. ``job``: ``spec`` (the
    ``MeshSpec`` fields, every rank on ``fsdp`` unless given),
    ``restore`` (a checkpoint directory to restore into a fresh model
    first, or None), ``steps`` (then train that many steps of
    ``batches()``) and ``save`` (then save there, or None). Returns the
    state after the restore and at the end."""
    from pytorch_distributed_tpu_torch.parallel import FSDP
    from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
    from pytorch_distributed_tpu_torch.train import (
        restore_checkpoint,
        save_checkpoint,
    )
    from pytorch_distributed_tpu_torch.train.checkpoint import (
        checkpoint_diff,
    )

    def body():
        _join(rank, world, port)
        strategy = FSDP("cpu", MeshSpec(**job.get("spec",
                                                  dict(dp=1, fsdp=-1))))
        model, state = build(strategy, seed=job.get("seed", 0))
        res = {}
        if job.get("restore"):
            restore_checkpoint(job["restore"], state)
            res["restored"] = snapshot(model, state)
            res["diff"] = checkpoint_diff(job["restore"], state)
        if job.get("steps"):
            res["losses"] = run_steps(model, state, strategy,
                                      batches()[:job["steps"]], 1)
        if job.get("save"):
            save_checkpoint(job["save"], state)
            res["diff_saved"] = checkpoint_diff(job["save"], state)
        res["final"] = snapshot(model, state)
        return res

    _run(rank, out, body)


def llama_recipe(rank, world, port, argv, out):
    """The port's Llama recipe ``main(argv)`` under torchrun's
    environment: the logged losses, the strategy's mesh and the
    optimizer's weight decay."""
    import os

    from tests.torch_dp_workers import RANK_THREADS

    torch.set_num_threads(RANK_THREADS)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))

    def body():
        from pytorch_distributed_tpu_torch.recipes import llama_fsdp

        trainer = llama_fsdp.main(argv)
        model = trainer.state.model
        head = model.lm_head.weight
        return {"losses": [r["loss"] for r in trainer.history],
                "step": trainer.state.step,
                "local_rows": tuple(head.to_local().shape),
                "mesh": (head.device_mesh.mesh_dim_names,
                         tuple(head.device_mesh.shape)),
                "decay": {g["weight_decay"]
                          for g in trainer.state.optimizer.param_groups}}

    _run(rank, out, body)


def adafactor_steps(rank, world, port, spec, out):
    """Adafactor (``min_dim_size_to_factor`` 8, so the stacked kernels
    factor) over ``CFG`` under FSDP at ``world``: ``STEPS`` steps of the
    chunked loss; the parameters (gathered, the JAX layout) and each
    leaf's ``v_row``/``v_col`` and ``v`` after."""
    from pytorch_distributed_tpu_torch import optim
    from pytorch_distributed_tpu_torch.interop import llama_params_to_jax
    from pytorch_distributed_tpu_torch.parallel import FSDP
    from pytorch_distributed_tpu_torch.recipes.llama_fsdp import build_model
    from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
    from pytorch_distributed_tpu_torch.runtime.precision import Policy
    from pytorch_distributed_tpu_torch.train import TrainState

    def body():
        _join(rank, world, port)
        strategy = FSDP("cpu", MeshSpec(**spec))
        model, _ = build_model(config(), strategy, "cpu", 0, Policy.full())
        opt = strategy.optimizer(model, optim.Adafactor, lr=LR,
                                 min_dim_size_to_factor=8)
        state = TrainState(model, opt, policy=Policy.full())
        losses = run_steps(model, state, strategy, batches(), 1)
        named = dict(model.named_parameters())
        res = {"losses": losses, "params": llama_params_to_jax(
            {n: torch.from_numpy(full(p)) for n, p in named.items()},
            model.config)}
        from pytorch_distributed_tpu_torch.optim import _RowBox

        res["per_layer"] = {leaf.path: all(
            _RowBox(p, g).ok for p, g in zip(leaf.params, leaf.geoms))
            for leaf in opt.leaves if opt.factored(leaf)}
        for leaf in opt.leaves:
            held = opt.leaf_state(leaf)
            res[leaf.path] = {k: held[k].numpy().copy()
                              for k in ("v_row", "v_col")}
            if opt.factored(leaf) is None:
                res[leaf.path]["v"] = np.stack(
                    [full(opt.state[p]["v"]) for p in leaf.params])
        return res

    _run(rank, out, body)
