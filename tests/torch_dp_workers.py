"""Rank processes for tests/test_torch_dp.py (spawned; spawn imports
targets by reference, so they live in this module, which imports no
JAX). Each joins a gloo group of ``world`` ranks on
localhost, does its part, and puts ``(rank, result)`` on ``out``; a
failure puts ``(rank, traceback text)``."""

from __future__ import annotations

import dataclasses
import os
import traceback

import numpy as np
import torch


def _run(rank, out, fn):
    from pytorch_distributed_tpu_torch.runtime import distributed as dist

    try:
        out.put((rank, fn()))
    except BaseException:
        out.put((rank, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# intra-op threads a rank: the ranks of a world, and the test processes
# beside them, share the host's cores
RANK_THREADS = 2


def _join(rank, world, port):
    from pytorch_distributed_tpu_torch.runtime import distributed as dist

    torch.set_num_threads(RANK_THREADS)

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, device="cpu")


def facade(rank, world, port, rows, out):
    """The facade's collectives on this rank's row of ``rows``."""
    from pytorch_distributed_tpu_torch.runtime import distributed as dist

    def body():
        _join(rank, world, port)
        x = torch.from_numpy(rows[rank])
        res = {op.name: dist.all_reduce(x, op).numpy()
               for op in dist.ReduceOp}
        res["broadcast1"] = dist.broadcast(x, src=1).numpy()
        res["gather"] = dist.all_gather(x).numpy()
        res["world"], res["rank"] = dist.get_world_size(), dist.get_rank()
        dist.barrier()
        return res

    _run(rank, out, body)


MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
RESNET_STEPS, RESNET_BATCH = 3, 8


def build_resnet_step(parallel: bool):
    """(model, step, state, batches): a tiny bottleneck ResNet (BatchNorm
    scales drawn in [0.5, 1.5], so every conv branch counts), SGD with
    Nesterov momentum on a warmup-cosine schedule, label smoothing 0.1
    and L2 1e-4, uint8 batches normalized in the step. ``parallel``: in
    ``DataParallel`` over the process group, each batch this rank's
    share; else the whole global batch in one process."""
    from pytorch_distributed_tpu_torch import optim
    from pytorch_distributed_tpu_torch.data import device_normalizer_for
    from pytorch_distributed_tpu_torch.models import resnet
    from pytorch_distributed_tpu_torch.parallel import DataParallel
    from pytorch_distributed_tpu_torch.runtime.precision import Policy
    from pytorch_distributed_tpu_torch.train import (
        TrainState,
        build_train_step,
        classification_loss_fn,
    )

    gen = torch.Generator().manual_seed(0)
    model = resnet.ResNet([1, 1], resnet.Bottleneck, 10, width=8,
                          stem="cifar", device="cpu", policy=Policy.full())
    model.init_weights(gen)
    with torch.no_grad():
        for bn in model.batch_norms():
            bn.weight.uniform_(0.5, 1.5, generator=gen)
    opt = optim.SGD(model, lr=optim.WarmupCosine(0.1, 1, 4), momentum=0.9,
                    nesterov=True)
    rng = np.random.default_rng(1)
    batches = [{"image": rng.integers(0, 256, (RESNET_BATCH, 16, 16, 3),
                                      np.uint8),
                "label": rng.integers(0, 10, RESNET_BATCH).astype(np.int32)}
               for _ in range(RESNET_STEPS)]
    net = model
    if parallel:
        strategy = DataParallel("cpu")
        net = strategy.wrap(model)
        batches = [strategy.shard_batch(b) for b in batches]
    else:
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in batches]
    step = build_train_step(
        classification_loss_fn(net, label_smoothing=0.1, weight_decay=1e-4),
        batch_transform=device_normalizer_for(MEAN, STD))
    return model, step, TrainState(net, opt, policy=Policy.full()), batches


def resnet_steps(rank, world, port, out):
    """``build_resnet_step(parallel=True)``'s steps; returns the
    rank-averaged losses and the final state_dict."""
    from pytorch_distributed_tpu_torch.runtime import distributed as dist

    def body():
        _join(rank, world, port)
        model, step, state, batches = build_resnet_step(parallel=True)
        losses = []
        for batch in batches:
            state, metrics = step(state, batch)
            losses.append(float(dist.all_reduce(metrics["loss"],
                                                dist.ReduceOp.AVG)))
        return losses, {k: v.numpy().copy()
                        for k, v in model.state_dict().items()}

    _run(rank, out, body)


def f32_gpt2_recipe():
    """The GPT-2 recipe module, patched to run its tiny model without
    dropout and in f32 (``Policy.full()``), so that a data-parallel run
    and a single one can agree to f32 rounding: dropout masks follow the
    batch's shape, and bf16 products round differently at other batch
    shapes, which Adam turns into lr-sized steps on near-zero gradients.
    Returns a function that undoes the patch."""
    from pytorch_distributed_tpu_torch.recipes import gpt2

    tiny, policy = gpt2.SIZES["tiny"], gpt2.Policy
    gpt2.SIZES["tiny"] = lambda: dataclasses.replace(tiny(),
                                                     dropout_rate=0.0)
    gpt2.Policy = type("F32Policy", (), {"train": staticmethod(
        policy.full)})

    def undo():
        gpt2.SIZES["tiny"], gpt2.Policy = tiny, policy

    return gpt2, undo


def gpt2_recipe(rank, world, port, argv, out):
    """``f32_gpt2_recipe()``'s ``main`` with ``--strategy dp`` under
    torchrun's environment."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))

    def body():
        gpt2, _ = f32_gpt2_recipe()
        trainer = gpt2.main(argv + ["--strategy", "dp"])
        model = trainer.state.model.module
        return ([r["loss"] for r in trainer.history],
                {k: v.numpy().copy() for k, v in model.state_dict().items()})

    _run(rank, out, body)


def spawn(target, world, *args, timeout_s=180.0):
    """Run ``target(rank, world, port, *args, out)`` on ``world`` spawned
    ranks; returns their results by rank. A rank that fails, or a world
    that outlives ``timeout_s``, fails the caller (the processes are
    killed, never left running)."""
    import multiprocessing as mp
    import queue

    port = _free_port()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, world, port, *args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            try:
                rank, res = out.get(timeout=timeout_s)
            except queue.Empty:
                raise AssertionError(
                    f"{target.__name__}: no result within {timeout_s} s")
            if isinstance(res, str):
                raise AssertionError(f"rank {rank} failed:\n{res}")
            results[rank] = res
        for p in procs:
            p.join(timeout=30)
            assert not p.is_alive(), f"{target.__name__} rank hung at exit"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(world)]


def in_process(target, *args):
    """``target(0, 1, port, *args, out)`` in this process, a world of one
    without the cost of a spawn; returns its result, or fails the caller
    as :func:`spawn` does."""
    import queue

    out = queue.Queue()
    threads = torch.get_num_threads()
    try:
        target(0, 1, _free_port(), *args, out)
    finally:
        torch.set_num_threads(threads)
    _, res = out.get_nowait()
    if isinstance(res, str):
        raise AssertionError(f"{target.__name__} failed:\n{res}")
    return res


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def numpy_rows(seed, world, shape):
    return np.random.default_rng(seed).normal(
        size=(world,) + shape).astype(np.float32)


ZERO_STEPS, ZERO_BATCH, ZERO_SEQ = 3, 8, 16


def build_gpt2_step(strategy: str, max_norm: float = 1.0, seed: int = 0):
    """(model, step, state, batches): a tiny f32 GPT-2 (dropout 0.1 on,
    einsum attention) with clip(``max_norm``) then AdamW(1e-2, decay
    1e-4), two microbatches a step, in ``DataParallel`` (``"dp"``) or
    ``ZeRO1`` (``"zero1"``: the optimizer state sharded over the ranks)
    over the process group; each batch this rank's share of
    ``ZERO_STEPS`` seeded global batches."""
    from pytorch_distributed_tpu_torch import optim
    from pytorch_distributed_tpu_torch.models.gpt2 import (
        GPT2Config,
        GPT2LMHead,
    )
    from pytorch_distributed_tpu_torch.parallel import DataParallel, ZeRO1
    from pytorch_distributed_tpu_torch.runtime.precision import Policy
    from pytorch_distributed_tpu_torch.train import (
        TrainState,
        build_train_step,
        causal_lm_loss_fn,
    )

    cfg = GPT2Config.tiny()
    model = GPT2LMHead(cfg, device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(seed))
    if strategy == "zero1":
        par = ZeRO1("cpu")
        opt = par.optimizer(model, optim.AdamW, lr=1e-2, weight_decay=1e-4)
    else:
        par = DataParallel("cpu")
        opt = optim.AdamW(model, lr=1e-2, weight_decay=1e-4)
    net = par.wrap(model)
    opt = optim.clip_grad_norm(opt, max_norm)
    rng = np.random.default_rng(seed + 1)
    batches = [par.shard_batch({"input_ids": rng.integers(
        0, cfg.vocab_size, (ZERO_BATCH, ZERO_SEQ)).astype(np.int64)})
        for _ in range(ZERO_STEPS)]
    step = build_train_step(causal_lm_loss_fn(net), accum_steps=2)
    return model, step, TrainState(net, opt, policy=Policy.full()), batches


def zero1_vs_ddp(rank, world, port, ckpt_dir, out):
    """The same steps under DDP and under ZeRO-1; returns each run's
    parameters and losses, the ZeRO run's moments by parameter name (the
    ones this rank holds), the shard-local and global gradient norms of
    one clipped step, and writes the ZeRO state to ``ckpt_dir``."""
    from pytorch_distributed_tpu_torch import optim
    from pytorch_distributed_tpu_torch.train import save_checkpoint

    def run(strategy, max_norm):
        model, step, state, batches = build_gpt2_step(strategy, max_norm)
        losses = []
        for batch in batches:
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        params = {k: v.detach().numpy().copy()
                  for k, v in model.named_parameters()}
        return model, state, losses, params

    def body():
        _join(rank, world, port)
        res = {}
        for max_norm in (1.0, 0.05):   # clipping off at 1.0, on at 0.05
            _, _, res[f"dp_losses_{max_norm}"], res[f"dp_{max_norm}"] = run(
                "dp", max_norm)
            model, state, res[f"zero_losses_{max_norm}"], \
                res[f"zero_{max_norm}"] = run("zero1", max_norm)
        zero = state.optimizer.optimizer
        names = {id(p): n for n, p in model.named_parameters()}
        res["moments"] = {
            names[id(p)]: {k: v.numpy().copy() for k, v in s.items()
                           if k != "step"}
            for p, s in zero.optim.state.items()}
        res["steps"] = sorted({int(s["step"])
                               for s in zero.optim.state.values()})
        # the norm a clip around this rank's shard would take, against
        # the global one, and the one the clip around
        # ZeroRedundancyOptimizer takes (it scales the grads: last)
        owned = [p.grad for g in zero.optim.param_groups
                 for p in g["params"] if p.grad is not None]
        every = [p.grad for p in model.parameters() if p.grad is not None]
        res["norms"] = (float(optim.global_norm(owned)),
                        float(optim.global_norm(every)))
        save_checkpoint(ckpt_dir, state)
        res["clip_norm"] = float(state.optimizer.clip_())
        return res

    _run(rank, out, body)
