"""Rank processes for tests/test_torch_collectives_more.py,
tests/test_torch_tp.py and tests/test_torch_sequence.py (spawned by
``torch_dp_workers.spawn``; this module imports no JAX). Each rank joins
a gloo group on localhost and returns numpy results; the tests hold them
against the JAX package's functions on the same inputs.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from tests import torch_fsdp_workers as fsdp_workers
from tests.torch_dp_workers import _join, _run


# --------------------------------------------------------------------------
# the facade's collectives
# --------------------------------------------------------------------------


def collectives(rank, world, port, rows, out):
    """``permute`` (a ring, one pair with zero fill, and its gradient),
    ``gather``, ``reduce``, ``scatter``, ``all_to_all_grad``'s gradient,
    ``monitored_barrier``, the object collectives and a ``new_group`` of
    ranks 1 and 3 on this rank's row of ``rows``."""
    from pytorch_distributed_tpu_torch.runtime import distributed as dist

    def body():
        _join(rank, world, port)
        x = torch.from_numpy(rows[rank])
        ring = [(i, (i + 1) % world) for i in range(world)]
        res = {"ring": dist.permute(x, ring).numpy(),
               "pair": dist.permute(x, [(0, 3)]).numpy()}
        xg = x.clone().requires_grad_(True)
        w = torch.arange(x.numel(), dtype=x.dtype).view(x.shape) * (rank + 1)
        (dist.permute_grad(xg, ring) * w).sum().backward()
        res["ring_grad"] = xg.grad.numpy()
        xg = x.clone().requires_grad_(True)
        (dist.permute_grad(xg, [(0, 3)]) * w).sum().backward()
        res["pair_grad"] = xg.grad.numpy()
        g = dist.gather(x, dst=2)
        res["gather"] = None if g is None else g.numpy()
        r = dist.reduce(x, dst=1)
        res["reduce"] = None if r is None else r.numpy()
        r = dist.reduce(x, dst=1, op=dist.ReduceOp.MAX)
        res["reduce_max"] = None if r is None else r.numpy()
        full = torch.from_numpy(rows) if rank == 0 else torch.zeros(
            rows.shape, dtype=x.dtype)
        res["scatter"] = dist.scatter(full, src=0).numpy()
        blocks = torch.from_numpy(np.ascontiguousarray(
            np.tile(rows[rank], (world, 1))))
        bg = blocks.clone().requires_grad_(True)
        wb = torch.arange(bg.numel(), dtype=bg.dtype).view(bg.shape)
        a2a = dist.all_to_all_grad(bg)
        res["a2a"] = a2a.detach().numpy()
        (a2a * wb).sum().backward()
        res["a2a_grad"] = bg.grad.numpy()
        dist.monitored_barrier(timeout_s=60)
        res["objects"] = dist.all_gather_object({"rank": rank,
                                                 "pad": "x" * rank})
        res["scattered"] = dist.scatter_object_list(
            [f"to {r}" for r in range(world)] if rank == 2 else None, src=2)
        res["broadcast_objects"] = dist.broadcast_object_list(
            [rank, "from me"] if rank == 3 else [None, None], src=3)
        sub = dist.new_group([3, 1])
        res["sub_member"] = sub.is_member
        if sub.is_member:
            res["sub_sum"] = dist.all_reduce(x, group=sub).numpy()
            res["sub_gather"] = dist.all_gather(x, group=sub).numpy()
            res["sub_bcast"] = dist.broadcast(x, src=3, group=sub).numpy()
            res["sub_perm"] = dist.permute(x, [(0, 1)], group=sub).numpy()
            dist.barrier(group=sub)
        else:
            try:
                dist.all_reduce(x, group=sub)
                res["refused"] = False
            except RuntimeError:
                res["refused"] = True
        dist.barrier()
        return res

    _run(rank, out, body)


# --------------------------------------------------------------------------
# tensor parallelism
# --------------------------------------------------------------------------


def load_full(model, state_dict) -> None:
    """Copy whole tensors (``state_dict``, the port's names, a world-1
    model's layout) into a model whose parameters may be sharded: each
    rank its own box, a TP GPT-2's fused qkv rows in its order."""
    from pytorch_distributed_tpu_torch.runtime.mesh import shard_box

    rows = getattr(model, "tp_rows", lambda name, t: t)
    with torch.no_grad():
        for name, p in model.named_parameters():
            local, offsets, _ = shard_box(p)
            box = tuple(slice(o, o + n) for o, n in zip(offsets, local.shape))
            local.copy_(rows(name, state_dict[name])[box].to(local.dtype))


def _tp_model(cfg, spec, params, policy):
    """A ``LlamaForCausalLM`` of ``cfg`` under ``FSDP`` on ``spec`` with
    the JAX ``params`` loaded; ``(model, strategy)``."""
    from pytorch_distributed_tpu_torch.interop import llama_params_from_jax
    from pytorch_distributed_tpu_torch.models.llama import LlamaForCausalLM
    from pytorch_distributed_tpu_torch.models.gemma import (
        gemma_partition_rules,
    )
    from pytorch_distributed_tpu_torch.parallel import FSDP
    from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec

    strategy = FSDP("cpu", MeshSpec(**spec),
                    extra_rules=gemma_partition_rules(cfg))
    model = LlamaForCausalLM(cfg, device="meta", policy=policy)
    strategy.wrap(model)
    model.to_empty(device="cpu")
    load_full(model, llama_params_from_jax(params, cfg))
    return model, strategy


def tp_world(rank, world, port, job, out):
    """``job["cases"]``: per case, a Llama-body config, a mesh spec, the
    JAX params and token rows; the logits on the whole rows, and with
    ``steps`` those clip + AdamW steps (``lr``) on this rank's share of
    each batch, then the whole parameters in the JAX layout. With
    ``job["ckpt"]``: the checkpoint round trip of
    ``torch_fsdp_workers.CFG`` trained at ``spec`` and restored at
    ``fsdp`` 4 in the same world."""
    from pytorch_distributed_tpu_torch import optim
    from pytorch_distributed_tpu_torch.interop import llama_params_to_jax
    from pytorch_distributed_tpu_torch.runtime.precision import Policy
    from pytorch_distributed_tpu_torch.train import (
        TrainState,
        build_train_step,
        causal_lm_loss_fn,
    )

    def body():
        _join(rank, world, port)
        res = {}
        for name, case in job.get("cases", {}).items():
            model, strategy = _tp_model(case["cfg"], case["spec"],
                                        case["params"], Policy.full())
            ids = torch.from_numpy(case["ids"])
            with torch.no_grad():
                logits = model(ids)
            got = {"logits": logits.numpy().copy(),
                   "local": {n: tuple(p.to_local().shape)
                             for n, p in model.named_parameters()},
                   "rows": {n: strategy.shard_batch({"i": np.arange(n)})[
                       "i"].numpy() for n in (8, 9)}}
            if case.get("steps"):
                opt = optim.clip_grad_norm(optim.AdamW(
                    model, lr=case["lr"], weight_decay=1e-4), 1.0)
                state = TrainState(model, opt, policy=Policy.full())
                step = build_train_step(causal_lm_loss_fn(
                    model, vocab_chunk_size=case.get("chunk")))
                losses = []
                for batch in case["steps"]:
                    state, metrics = step(state, strategy.shard_batch(batch))
                    losses.append(float(metrics["loss"]))
                got["losses"] = losses
                got["params"] = llama_params_to_jax(
                    {n: torch.from_numpy(fsdp_workers.full(p))
                     for n, p in model.named_parameters()}, model.config)
            res[name] = got
        if job.get("ckpt"):
            res["ckpt"] = _ckpt_round_trip(job["ckpt"])
        return res

    _run(rank, out, body)


def _ckpt_round_trip(job):
    """Train ``fsdp_workers.CFG`` at ``job["spec"]`` (TP rules applied),
    save to ``job["dir"]``, then restore into a fresh model at ``fsdp``
    4: both states gathered, and the restore's diff."""
    from pytorch_distributed_tpu_torch.models.llama import (
        llama_partition_rules,
    )
    from pytorch_distributed_tpu_torch.parallel import FSDP
    from pytorch_distributed_tpu_torch.runtime.mesh import MeshSpec
    from pytorch_distributed_tpu_torch.train import (
        restore_checkpoint,
        save_checkpoint,
    )
    from pytorch_distributed_tpu_torch.train.checkpoint import (
        checkpoint_diff,
    )

    strategy = FSDP("cpu", MeshSpec(**job["spec"]),
                    extra_rules=llama_partition_rules())
    model, state = fsdp_workers.build(strategy, seed=1)
    out = {"local": {n: tuple(p.to_local().shape)
                     for n, p in model.named_parameters()}}
    out["losses"] = fsdp_workers.run_steps(
        model, state, strategy, fsdp_workers.batches()[:job["steps"]], 1)
    save_checkpoint(job["dir"], state)
    out["diff_saved"] = checkpoint_diff(job["dir"], state)
    out["final"] = fsdp_workers.snapshot(model, state)
    strategy = FSDP("cpu", MeshSpec(dp=1, fsdp=-1))
    model, state = fsdp_workers.build(strategy, seed=2)
    restore_checkpoint(job["dir"], state)
    out["restored"] = fsdp_workers.snapshot(model, state)
    out["diff"] = checkpoint_diff(job["dir"], state)
    return out


# --------------------------------------------------------------------------
# sequence parallelism
# --------------------------------------------------------------------------


def _coord(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _chunk(a, axis, i, n):
    step = a.shape[axis] // n
    return np.take(a, range(i * step, (i + 1) * step), axis=axis)


def local_part(a, coord, spec, heads=True):
    """This rank's part of a global ``[B, S, H, ...]`` array: rows of its
    data share, positions of its ``sp`` index, heads of its ``tp``
    index."""
    d = coord["dp"] * spec["fsdp"] + coord["fsdp"]
    a = _chunk(a, 0, d, spec["dp"] * spec["fsdp"])
    a = _chunk(a, 1, coord["sp"], spec["sp"])
    return _chunk(a, 2, coord["tp"], spec["tp"]) if heads else a


def sp_world(rank, world, port, job, out):
    """``job["attn"]``: per case, ring or ulysses attention on this rank's
    part of global q/k/v (``mesh`` spec, ``causal``, ``window``), the
    output and the gradients of ``sum(out * w)``. ``job["llama"]``: per
    case, the Llama logits of this rank's positions under a
    sequence-parallel mode. ``job["refusals"]``: Ulysses' indivisible
    heads."""
    from pytorch_distributed_tpu_torch.interop import llama_params_from_jax
    from pytorch_distributed_tpu_torch.models.llama import LlamaForCausalLM
    from pytorch_distributed_tpu_torch.parallel import sequence
    from pytorch_distributed_tpu_torch.runtime.mesh import (
        MeshSpec,
        make_mesh,
    )
    from pytorch_distributed_tpu_torch.runtime.precision import Policy

    def body():
        _join(rank, world, port)
        res = {}
        for name, case in job.get("attn", {}).items():
            spec = MeshSpec(**case["mesh"]).resolve(world)
            sizes = dict(dp=spec.dp, fsdp=spec.fsdp, sp=spec.sp, tp=spec.tp)
            mesh = make_mesh(spec, "cpu")
            coord = _coord(mesh)
            q, k, v, w = (torch.from_numpy(np.ascontiguousarray(
                local_part(case[n], coord, sizes))).requires_grad_(n != "w")
                for n in ("q", "k", "v", "w"))
            fn = (sequence.ring_attention if case["impl"] == "ring"
                  else sequence.ulysses_attention)
            o = fn(q, k, v, causal=case["causal"], window=case.get("window"))
            (o * w).sum().backward()
            res[name] = {"coord": coord, "sizes": sizes,
                         "out": o.detach().numpy(), "dq": q.grad.numpy(),
                         "dk": k.grad.numpy(), "dv": v.grad.numpy()}
        for name, case in job.get("llama", {}).items():
            spec = MeshSpec(**case["mesh"]).resolve(world)
            sizes = dict(dp=spec.dp, fsdp=spec.fsdp, sp=spec.sp, tp=spec.tp)
            coord = _coord(make_mesh(spec, "cpu"))
            cfg = case["cfg"]
            model = LlamaForCausalLM(cfg, device="cpu", policy=Policy.full())
            model.load_state_dict(llama_params_from_jax(case["params"], cfg))
            ids = local_part(case["ids"][..., None], coord, sizes,
                             heads=False)[..., 0]
            r, L = coord["sp"], ids.shape[1]
            pos = torch.arange(r * L, (r + 1) * L).expand(ids.shape[0], L)
            with sequence.sequence_parallel("sp", case["impl"]), \
                    torch.no_grad():
                logits = model(torch.from_numpy(ids), positions=pos)
            res[name] = {"coord": coord, "sizes": sizes,
                         "logits": logits.numpy()}
        for name, case in job.get("refusals", {}).items():
            make_mesh(MeshSpec(**case["mesh"]), "cpu")
            q = torch.zeros(case["q_shape"])
            k = torch.zeros(case["kv_shape"])
            try:
                sequence.ulysses_attention(q, k, k)
                res[name] = None
            except ValueError as e:
                res[name] = str(e)
        return res

    _run(rank, out, body)


@contextlib.contextmanager
def recipe_f32():
    """The port's Llama recipe with its products in f32 (``Policy.full()``
    where it takes ``Policy.train()``), so that a mesh's reordered sums
    are the only difference between the losses of two meshes."""
    from pytorch_distributed_tpu_torch.recipes import llama_fsdp
    from pytorch_distributed_tpu_torch.runtime.precision import Policy

    class F32(Policy):
        @classmethod
        def train(cls):
            return Policy.full()

    llama_fsdp.Policy = F32
    try:
        yield llama_fsdp
    finally:
        llama_fsdp.Policy = Policy


def recipe_runs(rank, world, port, argvs, out):
    """The port's Llama recipe ``main(argv)`` for each of ``argvs`` in one
    gloo world (each run on the group this rank joined), products in
    f32: the logged losses of each."""

    def body():
        _join(rank, world, port)
        with recipe_f32() as llama_fsdp:
            return [[r["loss"] for r in llama_fsdp.main(argv).history]
                    for argv in argvs]

    _run(rank, out, body)
