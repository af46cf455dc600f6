#!/usr/bin/env python3
"""Mixtral-8x7B under expert parallelism across the cards of one host, one
process per card, under torchrun:

    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/port_moe_scale.py

Every configuration is the Mixtral recipe's model, optimizer and step
(``recipes/mixtral_moe.py``: Mixtral-8x7B at its published widths cut to
``--layers`` layers, ``Policy.train()``, capacity 1.25, remat, the
chunked loss at 8192 with the load loss at 0.01, clip(1.0) then
adamw(1e-4, decay 1e-4)), built from the same seeded weights and fed the
same global batch of ``--batch`` rows of ``--seq`` tokens:

* **world 1**: rank 0's card alone, in a process group of its own in a
  child process of rank 0 (nothing of it outlives the run: the child
  reports what it still held after the run and after a garbage
  collection), before the others join (one card holds the 2-layer cut
  whole);
* **ep 4**: ``DataParallel(mesh_spec=MeshSpec(dp=1, ep=4))``, each card
  2 of the 8 experts of every layer, the tokens on every card;
* **dp 2 x ep 2**: 4 experts a card, each ``dp`` pair half the rows (the
  routing's queues over the whole batch).

For each: the first 3 losses (the global batch's mean) and the first
batch's global gradient norm, ``--steps`` timed steps ending in one
value fetch (ms a step, tokens/s per card), each rank's allocated memory
when the configuration starts and its peak over the timed steps, and
on a card ``torch.profiler`` over two more steps: the busy share of the
window and NCCL's all-reduce ms a step. Against world 1's: the first
loss (the same weights and batch) within ``FIRST_LOSS_RTOL``, the
gradient norm within ``GNORM_RTOL``, the three losses within
``LOSS_RTOL`` (the trajectory: AdamW turns the bf16 rounding of the
first steps into different updates); a control run of ``ep 4`` with the
sum of the experts' outputs over ``ep`` left out (each card adds only
its own experts, dropping three quarters of them) must read above
``FIRST_LOSS_RTOL``.
Rank 0 prints each result, a JSON line, and ``nvidia-smi``'s name and
power limit of the cards, and exits non-zero when a check fails.
``--device cpu --size tiny --seq 16 --batch 4 --steps 2`` rehearses it on
gloo.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import gc
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

CHUNK, AUX, CF, LR = 8192, 0.01, 1.25, 1e-4
# Limits near the readings (NVIDIA H100 80GB HBM3, 700 W): --ep 4 reads
# world 1's numbers to the bit (each token's two expert outputs add in
# f32 on one card or over ep, and zeros add exactly); --dp 2 --ep 2 runs
# its products on 2 rows a card, so their bf16 rounding differs: the
# first loss read 7.2e-6 of world 1's, the gradient norm 3.1e-5, the
# third loss 3.0e-3 (after two AdamW steps on a loss falling 11.2 -> 2.6)
FIRST_LOSS_RTOL = 5e-5
GNORM_RTOL = 1e-4
LOSS_RTOL = 5e-3


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _config(args):
    import dataclasses

    from pytorch_distributed_tpu_torch import MixtralConfig

    base = (MixtralConfig.tiny() if args.size == "tiny"
            else MixtralConfig.mixtral_8x7b())
    return dataclasses.replace(base, num_layers=args.layers or
                               base.num_layers, capacity_factor=CF,
                               remat=True, max_seq_len=max(2 * args.seq, 32))


def _profile(step, state, batch, device):
    """torch.profiler over two steps: the window's ms a step, the ms a
    step in which some kernel ran (the union over streams), and NCCL's
    all-reduce kernels' ms a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(2):
            state, _ = step(state, batch)
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3 / 2
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    total, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    allreduce = sum(e.time_range.end - e.time_range.start for e in kernels
                    if "allreduce" in e.name.lower())
    return dict(window_ms_per_step=wall, busy_ms=total / 1e3 / 2,
                allreduce_ms=allreduce / 1e3 / 2)


def run(args, device, name, spec, cfg, ids, timed=True):
    """One configuration on the current process group (see the module
    docstring); ``timed=False`` stops after the losses."""
    import torch

    from pytorch_distributed_tpu_torch import (
        MeshSpec,
        Policy,
        TrainState,
        build_train_step,
        causal_lm_loss_fn,
        optim,
    )
    from pytorch_distributed_tpu_torch.models.mixtral import (
        mixtral_partition_rules,
    )
    from pytorch_distributed_tpu_torch.parallel import DataParallel
    from pytorch_distributed_tpu_torch.recipes.mixtral_moe import (
        ADAMW_WEIGHT_DECAY,
        build_model,
    )
    from pytorch_distributed_tpu_torch.runtime import distributed as dist

    world, on_card = dist.get_world_size(), device.type == "cuda"
    _free(device)
    start_gib = (torch.cuda.memory_allocated(device) / 2**30 if on_card
                 else 0.0)
    t0 = time.perf_counter()
    par = DataParallel(device, mesh_spec=MeshSpec(**spec),
                       extra_rules=mixtral_partition_rules())
    model, net = build_model(cfg, par, device, args.seed, Policy.train())
    opt = optim.clip_grad_norm(optim.AdamW(
        model, lr=LR, weight_decay=ADAMW_WEIGHT_DECAY), 1.0)
    loss_fn = causal_lm_loss_fn(net, moe_aux_weight=AUX,
                                vocab_chunk_size=CHUNK)
    step = build_train_step(loss_fn)
    state = TrainState(net, opt, policy=Policy.train())
    batch = par.shard_batch({"input_ids": ids})
    out = dict(name=name, spec=spec, layers=cfg.num_layers,
               rows=int(ids.shape[0]), seq=int(ids.shape[1]), world=world,
               init_s=time.perf_counter() - t0,
               local_rows=tuple(batch["input_ids"].shape))
    loss, _ = loss_fn(batch, None)
    loss.backward()
    out["grad_norm"] = float(optim.global_norm(
        [p.grad for p in net.parameters() if p.grad is not None]))
    net.zero_grad(set_to_none=True)
    del loss
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        v = metrics["loss"].detach().float().reshape(1).clone()
        losses.append(dist.all_reduce(v, dist.ReduceOp.AVG).item())
    out["losses"] = losses
    if timed:
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = step(state, batch)
        float(metrics["loss"])   # the value fetch ends the window
        dt = (time.perf_counter() - t0) / args.steps
        out["step_ms"] = 1e3 * dt
        out["tokens_per_s_per_card" if on_card
            else "tokens_per_s_per_rank_on_cpu"] = ids.size / dt / world
        if on_card:
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            out["peak_mem_gib_by_rank"] = dist.all_gather(torch.tensor(
                [peak], device=device))[:, 0].tolist()
            out["allocated_at_start_gib_by_rank"] = dist.all_gather(
                torch.tensor([start_gib], device=device))[:, 0].tolist()
            prof = _profile(step, state, batch, device)
            out["device_busy_share"] = (prof["busy_ms"]
                                        / prof["window_ms_per_step"])
            out["nccl_allreduce_ms_per_step"] = prof["allreduce_ms"]
            out["profile_rank0"] = prof
    if dist.get_rank() == 0:
        print(f"{name}: {json.dumps(out)}", flush=True)
    del model, net, opt, loss_fn, step, state, batch, par, metrics
    _free(device)
    return out


def _rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _agree(r, ref):
    """``r`` with its first loss's, gradient norm's and losses' relative
    distances from world 1's."""
    r["first_loss_rel_err_vs_world1"] = _rel(r["losses"][:1],
                                             ref["losses"][:1])
    r["grad_norm_rel_err_vs_world1"] = _rel([r["grad_norm"]],
                                            [ref["grad_norm"]])
    r["loss_rel_err_vs_world1"] = _rel(r["losses"], ref["losses"])
    return r


@contextlib.contextmanager
def _no_expert_sum():
    """The control: each card's MoE output without the others' experts."""
    from pytorch_distributed_tpu_torch.ops import moe

    real = moe.sum_outputs
    moe.sum_outputs = lambda y, group: y
    try:
        yield
    finally:
        moe.sum_outputs = real


def _world1_child(args, cfg, ids, results):
    """World 1 on rank 0's card in this (child) process, in a process
    group of its own (a store of its own), torn down after; then what the
    process still holds allocated, before and after a garbage
    collection."""
    import torch
    import torch.distributed as tdist

    from pytorch_distributed_tpu_torch.runtime import distributed as dist

    device = dist.rank_device(args.device)
    store = tdist.TCPStore("localhost", 0, 1, True,
                           timeout=datetime.timedelta(seconds=60))
    dist.init_process_group(store=store, world_size=1, rank=0, device=device)
    try:
        out = run(args, device, "world1", dict(dp=1), cfg, ids)
    finally:
        dist.destroy_process_group()
        del store
    if device.type == "cuda":
        out["left_allocated_gib"] = torch.cuda.memory_allocated(device) / 2**30
        gc.collect()
        out["left_allocated_gib_after_gc"] = (
            torch.cuda.memory_allocated(device) / 2**30)
    results.put(out)


def _world1(args, cfg, ids):
    """:func:`_world1_child` in a spawned child of rank 0, which exits
    before the others' group forms: nothing of world 1 stays allocated
    in rank 0's process for the readings after it."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    child = ctx.Process(target=_world1_child, args=(args, cfg, ids, results))
    child.start()
    try:
        out = results.get(timeout=1800)
    finally:
        child.join(timeout=60)
        if child.is_alive():
            child.kill()
            child.join()
    if child.exitcode != 0:
        raise RuntimeError(f"world 1 exited with {child.exitcode}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="this rank's card (LOCAL_RANK) unless given")
    ap.add_argument("--size", choices=("tiny", "8x7b"), default="8x7b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    from pytorch_distributed_tpu_torch.runtime import distributed as dist
    from pytorch_distributed_tpu_torch.runtime.device import device_info

    device = dist.rank_device(args.device)
    cfg = _config(args)
    ids = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int64)
    ref = None
    if int(os.environ.get("RANK", "0")) == 0:
        ref = _world1(args, cfg, ids)
    # the others wait here while rank 0 runs world 1 alone
    dist.init_process_group(device=device, timeout_s=1800.0)
    world, rank = dist.get_world_size(), dist.get_rank()
    ref = dist.broadcast_object_list([ref], src=0)[0]
    ok = True
    out = dict(world=world, world1=ref)
    try:
        for name, spec in (("ep4", dict(dp=1, ep=world)),
                           ("dp2_ep2", dict(dp=2, ep=world // 2))):
            r = _agree(run(args, device, name, spec, cfg, ids), ref)
            ok = ok and all(map(math.isfinite, r["losses"])) and (
                r["first_loss_rel_err_vs_world1"] <= FIRST_LOSS_RTOL
                and r["grad_norm_rel_err_vs_world1"] <= GNORM_RTOL
                and r["loss_rel_err_vs_world1"] <= LOSS_RTOL)
            out[name] = r
        with _no_expert_sum():
            control = run(args, device, "ep4_no_expert_sum",
                          dict(dp=1, ep=world), cfg, ids, timed=False)
        out["control"] = control = _agree(control, ref)
        if control["first_loss_rel_err_vs_world1"] <= FIRST_LOSS_RTOL:
            ok = False
            if rank == 0:
                print("port_moe_scale: the control without the experts' sum "
                      f"reads within {FIRST_LOSS_RTOL}: the limit cannot "
                      "see a missing sum", file=sys.stderr)
        out["ok"] = ok
        if rank == 0:
            print(json.dumps({"port_moe_scale": out}))
            if device.type == "cuda":
                print(device_info())
        if not ok:
            print(f"port_moe_scale: rank {rank}: a check failed",
                  file=sys.stderr)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
