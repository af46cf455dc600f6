"""Rank processes for tests/test_torch_grad_compress.py,
test_torch_grad_compress_ddp.py and test_torch_resnet_zero1.py (spawned
by reference, so they live in this module, which imports JAX only
inside the JAX package's workers).

* :func:`jax_sync` runs the JAX package's ``sync_grads`` on its host
  ring (``tests/hostring_workers.run_ring_workers``' worker shape) for
  ``STEPS`` steps of seeded per-rank leaves, and saves every step's
  result and the error-feedback residuals after the last;
* :func:`port_sync` does the same with the port's ``sync_grads`` in a
  gloo world (``tests/torch_dp_workers.spawn``' worker shape);
* :func:`hook_vs_sync` trains a small ResNet-18 for ``STEPS`` steps at
  world 2 twice from one seed, once through the DDP hook
  (``DataParallel.wrap(grad_compress=...)``) and once through a plain
  model whose step calls ``sync_grads``, and returns both runs'
  parameters;
* :func:`resnet_zero1_vs_ddp` runs ResNet SGD steps in f64 under
  ``ZeRO1`` and under ``DataParallel``;
* :func:`facade_flat` runs the facade's flat collectives on one row.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 3
#: leaf sizes: coalesced (< 4096), solo f32 (exact or q8), and one leaf
#: longer than the ring's 2,097,152-element chunk
LEAF_SHAPES = {"a": (17,), "b": (33, 5), "c": (3000,), "d": (64, 100),
               "e": (70001,), "f": (2_097_152 + 1021,)}
KINDS = ("bf16", "fp16", "int8")


def leaves_for(step: int, rank: int) -> dict:
    """This rank's seeded gradient leaves at ``step`` (f32); ``d`` holds
    a block of zeros, to exercise a zero q8 scale."""
    rng = np.random.default_rng(1000 + 100 * step + rank)
    out = {k: (rng.standard_normal(s) * (1 + 3 * rng.random())).astype(
        np.float32) for k, s in LEAF_SHAPES.items()}
    out["d"].reshape(-1)[512:768] = 0.0
    return out


def _save(out_dir, who, rank, arrays):
    np.savez(os.path.join(out_dir, f"{who}-rank{rank}.npz"), **arrays)


def jax_sync(rank: int, world: int, name: str, q, out_dir: str) -> None:
    """The JAX package's ``sync_grads`` for each of ``KINDS``."""
    try:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["RANK"] = str(rank)
        os.environ["WORLD_SIZE"] = str(world)
        import jax

        jax.config.update("jax_platforms", "cpu")
        import pytorch_distributed_tpu as ptd
        from pytorch_distributed_tpu.parallel import overlap
        from pytorch_distributed_tpu.parallel.ddp import sync_grads

        ptd.init_process_group("gloo", group_name=name, timeout_s=120.0)
        keys = sorted(LEAF_SHAPES)
        res = {}
        for kind in KINDS:
            overlap.reset_engine()
            fn = jax.jit(lambda g, kind=kind: sync_grads(g, compress=kind))
            for step in range(STEPS):
                out = fn(leaves_for(step, rank))
                for k in keys:
                    res[f"{kind}/{step}/{k}"] = np.asarray(out[k])
            if kind == "int8":
                # the engine's residuals by leaf: its plan's items are the
                # shipped arrays (q8 ones never split), sync_grads' plan
                # maps those to leaves
                leaves = leaves_for(0, rank)
                ship = overlap.ShipPlan(
                    [(np.shape(leaves[k]), np.float32) for k in keys],
                    quantize=True, chunk_bytes=1 << 62)
                eng = overlap._ENGINE
                (per_plan,) = eng._residuals.values()
                (plan,) = [p for key, p in eng._plans.items()
                           if "shipped" in key[1]]
                for idx, r in per_plan.items():
                    leaf = ship.items[plan.items[idx].parent].leaf_ids[0]
                    res[f"residual/{keys[leaf]}"] = r.copy()
        _save(out_dir, "jax", rank, res)
        ptd.destroy_process_group()
        q.put((rank, "ok"))
    except Exception as e:  # pragma: no cover - reported via the queue
        import traceback

        q.put((rank, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


def port_sync(rank, world, port, out_dir, out):
    """The port's ``sync_grads`` for each of ``KINDS``, with one error
    feedback store per kind; also each kind's wire bytes."""
    import torch

    from tests.torch_dp_workers import _join, _run

    def body():
        from pytorch_distributed_tpu_torch.parallel.ddp import sync_grads
        from pytorch_distributed_tpu_torch.parallel.overlap import (
            ErrorFeedback,
            SyncStats,
        )

        _join(rank, world, port)
        keys = sorted(LEAF_SHAPES)
        res, wire = {}, {}
        for kind in KINDS:
            feedback, stats = ErrorFeedback(), SyncStats()
            for step in range(STEPS):
                leaves = leaves_for(step, rank)
                got = sync_grads([torch.from_numpy(leaves[k]) for k in keys],
                                 kind, feedback=feedback, stats=stats)
                for k, t in zip(keys, got):
                    res[f"{kind}/{step}/{k}"] = t.numpy()
            wire[kind] = stats.wire_bytes
            if kind == "int8":
                for i, r in feedback.residuals.items():
                    res[f"residual/{keys[i]}"] = r.numpy()
        _save(out_dir, "port", rank, res)
        return wire

    _run(rank, out, body)


def _resnet18_run(world: int, kind: str, hooked: bool):
    """(model, losses) of ``STEPS`` SGD steps of ResNet-18's stages at
    width 16 (leaves of 432 to 147,456 elements), 8x8 images, batch 2 a
    rank, through the hook (``hooked``) or ``sync_grads``."""
    import torch

    from pytorch_distributed_tpu_torch import optim
    from pytorch_distributed_tpu_torch.data import device_normalizer_for
    from pytorch_distributed_tpu_torch.models.resnet import ResNet18
    from pytorch_distributed_tpu_torch.parallel import DataParallel
    from pytorch_distributed_tpu_torch.runtime import distributed as dist
    from pytorch_distributed_tpu_torch.runtime.precision import Policy
    from pytorch_distributed_tpu_torch.train import (
        TrainState,
        build_train_step,
        classification_loss_fn,
    )

    model = ResNet18(10, width=16, device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(0))
    strategy = DataParallel("cpu")
    net = strategy.wrap(model, grad_compress=kind) if hooked else model
    opt = optim.SGD(model, lr=0.05, momentum=0.9, nesterov=True)
    step = build_train_step(
        classification_loss_fn(net, weight_decay=5e-4),
        batch_transform=device_normalizer_for((0.49, 0.48, 0.45),
                                              (0.25, 0.24, 0.26)),
        grad_compression=kind)
    state = TrainState(net, opt, policy=Policy.full())
    rng = np.random.default_rng(7)
    losses = []
    for _ in range(STEPS):
        batch = {"image": rng.integers(0, 256, (2 * world, 8, 8, 3),
                                       np.uint8),
                 "label": rng.integers(0, 10, 2 * world).astype(np.int32)}
        state, metrics = step(state, strategy.shard_batch(batch))
        losses.append(float(dist.all_reduce(metrics["loss"],
                                            dist.ReduceOp.AVG)))
    return model, losses


def hook_vs_sync(rank, world, port, kinds, out):
    """Per kind: the hook run's and the sync_grads run's parameters."""
    from tests.torch_dp_workers import _join, _run

    def body():
        _join(rank, world, port)
        res = {}
        for kind in kinds:
            for hooked in (True, False):
                model, losses = _resnet18_run(world, kind, hooked)
                res[(kind, hooked)] = (
                    losses, {n: p.detach().numpy().copy()
                             for n, p in model.named_parameters()})
        return res

    _run(rank, out, body)


def resnet_zero1_vs_ddp(rank, world, port, ckpt_dir, out):
    """f64 ResNet steps under DDP and under ZeRO-1 (SGD, Nesterov): both
    runs' losses, parameters and running statistics; the ZeRO run's
    state is checkpointed to ``ckpt_dir``."""
    import torch

    from tests.torch_dp_workers import _join, _run

    def run(strategy_name):
        from pytorch_distributed_tpu_torch import optim
        from pytorch_distributed_tpu_torch.models import resnet
        from pytorch_distributed_tpu_torch.parallel import (
            DataParallel,
            ZeRO1,
        )
        from pytorch_distributed_tpu_torch.runtime import distributed as dist
        from pytorch_distributed_tpu_torch.runtime.precision import Policy
        from pytorch_distributed_tpu_torch.train import (
            TrainState,
            build_train_step,
            classification_loss_fn,
        )

        policy = Policy(param_dtype=torch.float64,
                        compute_dtype=torch.float64,
                        output_dtype=torch.float64)
        model = resnet.ResNet([1, 1], resnet.BasicBlock, 10, width=8,
                              stem="cifar", device="cpu", policy=policy)
        model.init_weights(torch.Generator().manual_seed(0))
        schedule = optim.WarmupCosine(0.1, 0, 4)
        if strategy_name == "zero1":
            par = ZeRO1("cpu")
            opt = par.optimizer(model, optim.SGD, lr=schedule, momentum=0.9,
                                nesterov=True)
        else:
            par = DataParallel("cpu")
            opt = optim.SGD(model, lr=schedule, momentum=0.9, nesterov=True)
        net = par.wrap(model)
        step = build_train_step(classification_loss_fn(
            net, weight_decay=5e-4, label_smoothing=0.1))
        state = TrainState(net, opt, policy=policy)
        rng = np.random.default_rng(3)
        losses = []
        for _ in range(STEPS):
            batch = par.shard_batch({
                "image": rng.standard_normal((8, 16, 16, 3)),
                "label": rng.integers(0, 10, 8).astype(np.int32)})
            state, metrics = step(state, batch)
            losses.append(float(dist.all_reduce(metrics["loss"],
                                                dist.ReduceOp.AVG)))
        return state, losses, {k: v.numpy().copy()
                               for k, v in model.state_dict().items()}

    def body():
        from pytorch_distributed_tpu_torch.train import save_checkpoint

        _join(rank, world, port)
        _, dp_losses, dp_state = run("dp")
        state, z_losses, z_state = run("zero1")
        save_checkpoint(ckpt_dir, state)
        owned = sorted(
            n for n, p in state.model.module.named_parameters()
            if p in state.optimizer.optim.state)
        return dict(dp=(dp_losses, dp_state), zero=(z_losses, z_state),
                    owned=owned)

    _run(rank, out, body)


def facade_flat(rank, world, port, rows, out):
    """The port's flat collectives on this rank's row of ``rows``
    (``[world, world * 4]`` f32), and ``all_to_all`` of its int8 and
    bf16 casts."""
    import torch

    from tests.torch_dp_workers import _join, _run

    def body():
        from pytorch_distributed_tpu_torch.runtime import distributed as dist

        _join(rank, world, port)
        x = torch.from_numpy(rows[rank])
        res = {
            "gather": dist.all_gather_into_tensor(x).numpy(),
            "rs_tensor": dist.reduce_scatter_tensor(x).numpy(),
            "rs_avg": dist.reduce_scatter_tensor(
                x, dist.ReduceOp.AVG).numpy(),
            "rs_rows": dist.reduce_scatter(x.reshape(world, -1)).numpy(),
            "a2a": dist.all_to_all(x).numpy(),
            "a2a_int8": dist.all_to_all(x.to(torch.int8)).numpy(),
            "a2a_bf16": dist.all_to_all(
                x.to(torch.bfloat16)).float().numpy(),
        }
        # uneven blocks: rank j gets j + 1 rows of every rank's x
        sizes = [j + 1 for j in range(world)]
        res["a2a_split"] = dist.all_to_all_single(
            x[:sum(sizes)], [rank + 1] * world, sizes).numpy()
        return res

    _run(rank, out, body)
