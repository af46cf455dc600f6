#!/usr/bin/env python3
"""GPT-2-medium under ZeRO-1 across the cards of one host, one process
per card, under torchrun:

    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/port_zero1_scale.py

1. **timing**: the GPT-2-medium step under ``Policy.train()``,
   clip(1.0) then adamw(3e-4, decay 1e-4), ``--batch-per-chip`` rows of
   ``--seq`` tokens a card in 2 microbatches, one placed batch fed
   again, 2 warm-up and ``--steps`` timed steps ending in one value
   fetch, for each variant of ``--turns`` in its order (a fresh model
   each turn): ``zero1`` is the JAX recipe's ``--strategy zero1 --remat
   --vocab-chunk 8192`` (DDP with the AdamW state sharded by
   ``ZeroRedundancyOptimizer``), ``dp`` the same under plain DDP,
   ``zero1-dots`` with ``--remat-policy dots``; ``remat``, ``chunk`` and
   ``plain`` are one process's step without a group, taking off ZeRO/DDP,
   then remat, then the chunked loss. Tokens/s per card, each rank's
   peak memory, and rank 0's time in Python's garbage collector. With ``--profile`` (after every turn: the profiler slows
   the host after it), ``torch.profiler`` over two more steps of each
   variant named: device busy ms a step and the largest kernels.
2. **parity**: ZeRO-1 and DDP from the same weights on the same 3
   accumulated steps (``--check-batch`` rows, 2 microbatches, dropout
   on, einsum attention so both runs take their gradients from the same
   code); every rank compares every parameter: equal to the bit.
3. **re-sharding**: the ZeRO-1 run of (2) checkpoints at this world size
   (each rank writes the moments it holds); every rank's state equals the
   files to the bit (``checkpoint_diff``); then ranks 0 and 1 form a
   world of 2, and rank 0 alone a world of 1 (plain AdamW), each restores
   the checkpoint into a fresh model and optimizer, and must equal the
   files to the bit too (each rank checks and prints its own boxes, and
   exits non-zero on a difference).

Rank 0 prints each result, a JSON line, and ``nvidia-smi``'s name and
power limit of the cards. ``--device cpu --size tiny --seq 16
--batch-per-chip 2 --check-batch 8 --steps 2`` rehearses it on gloo.
At ``--nproc-per-node 1`` the variants' step times and profiles on one
card:

    python -m torch.distributed.run --nproc-per-node 1 \\
        scripts/port_zero1_scale.py --turns plain,chunk,remat,dp,zero1 \\
        --profile plain,zero1
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import gc
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHUNK = 8192
# name: (strategy, remat policy or None, vocab chunk or None for the full
# logits); "plain" is one process without a group
VARIANTS = {
    "zero1": ("zero1", "full", CHUNK),
    "dp": ("dp", "full", CHUNK),
    "zero1-dots": ("zero1", "dots", CHUNK),
    "remat": ("plain", "full", CHUNK),
    "chunk": ("plain", None, CHUNK),
    "plain": ("plain", None, None),
}


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _build(args, device, strategy, *, remat, seed, attn_impl=None,
           accum=2, chunk=CHUNK):
    """(model, step, state) for ``strategy`` ("zero1", "dp" or "plain":
    one process, no group), ``remat`` a policy or None."""
    import torch

    from pytorch_distributed_tpu_torch import (
        DataParallel,
        GPT2Config,
        GPT2LMHead,
        Policy,
        TrainState,
        ZeRO1,
        build_train_step,
        causal_lm_loss_fn,
        optim,
    )

    cfg = {"tiny": GPT2Config.tiny, "medium": GPT2Config.medium}[args.size]()
    cfg = dataclasses.replace(cfg, remat=remat is not None,
                              remat_policy=remat or "full")
    policy = Policy.train()
    model = GPT2LMHead(cfg, device=device, policy=policy)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    net = model
    if strategy == "zero1":
        par = ZeRO1(device)
        opt = par.optimizer(model, optim.AdamW, lr=3e-4, weight_decay=1e-4)
        net = par.wrap(model)
    else:
        opt = optim.AdamW(model, lr=3e-4, weight_decay=1e-4)
        if strategy == "dp":
            net = DataParallel(device).wrap(model)
    opt = optim.clip_grad_norm(opt, 1.0)
    step = build_train_step(
        causal_lm_loss_fn(net, vocab_chunk_size=chunk, attn_impl=attn_impl),
        accum_steps=accum)
    return model, step, TrainState(net, opt, policy=policy)


def _rows(args, seed, n, vocab):
    import numpy as np

    return np.random.default_rng(seed).integers(
        0, vocab, (n, args.seq)).astype(np.int64)


def _variant(args, device, dist, name):
    """(model, step, state, this rank's placed batch) of a variant, after
    2 warm-up steps."""
    from pytorch_distributed_tpu_torch.parallel import DataParallel

    strategy, remat, chunk = VARIANTS[name]
    model, step, state = _build(args, device, strategy, remat=remat,
                                chunk=chunk, seed=args.seed)
    batch = DataParallel(device).shard_batch({"input_ids": _rows(
        args, args.seed, args.batch_per_chip * dist.get_world_size(),
        model.config.vocab_size)})
    for _ in range(2):
        state, metrics = step(state, batch)
    float(metrics["loss"])
    return model, step, state, batch


def timing(args, device, dist, name):
    import torch

    model, step, state, batch = _variant(args, device, dist, name)
    from chip_smoke import GCTimer

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    with GCTimer() as gct:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = step(state, batch)
        loss = float(metrics["loss"])   # the value fetch ends the timing
        dt = time.perf_counter() - t0
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if on_card else 0.0
    peaks = dist.all_gather(torch.tensor([peak], device=device))
    tokens = args.batch_per_chip * args.seq * args.steps / dt
    # a CPU rehearsal's rate is no card's: it goes under another name
    out = dict(variant=name, device=device.type,
               tokens_per_s_per_card=tokens if on_card else None,
               tokens_per_s_per_rank_on_cpu=None if on_card else tokens,
               step_ms=1e3 * dt / args.steps, loss=loss,
               gc_ms_per_step=sum(gct.ms) / args.steps, gc_count=gct.count,
               peak_mem_gib_by_rank=peaks[:, 0].tolist() if on_card else None)
    if dist.get_rank() == 0:
        memory = ("peak memory by rank " + ", ".join(
            f"{p:.3f}" for p in out["peak_mem_gib_by_rank"]) + " GiB"
            if on_card else "peak memory not measured")
        strategy, remat, chunk = VARIANTS[name]
        print(f"timing {name} on {device.type}: {tokens:.1f} tokens/s "
              f"per {'card' if on_card else 'rank'} ({out['step_ms']:.2f} "
              f"ms/step over {args.steps} steps, {args.batch_per_chip} x "
              f"{args.seq} a rank in 2 microbatches, {strategy}, remat "
              f"{remat}, vocab chunk {chunk}); {memory}; rank 0 in the "
              f"collector {out['gc_ms_per_step']:.2f} ms/step (collections "
              f"by generation {gct.count})", flush=True)
    del model, step, state, batch
    _free(device)
    return out


def profile(args, device, dist, name):
    """torch.profiler over two steps of a variant (every rank steps; rank
    0 prints): device busy ms a step and the largest kernels."""
    from chip_smoke import profile_step

    model, step, state, batch = _variant(args, device, dist, name)
    total_us, rows = profile_step(step, state, batch)
    out = dict(variant=name, device_busy_ms=total_us / 2e3,
               top=[dict(name=k[:120], ms_per_step=us / 2e3, count=c // 2)
                    for k, us, c in rows[:15]])
    if dist.get_rank() == 0:
        print(f"profile {name}, rank 0, 2 steps: device busy "
              f"{out['device_busy_ms']:.2f} ms/step", flush=True)
        for r in out["top"]:
            print(f"  {r['ms_per_step']:9.3f} ms/step  x{r['count']:<5d} "
                  f"{r['name'][:90]}", flush=True)
    del model, step, state, batch
    _free(device)
    return out


def _max_diff(ckpt_dir, state):
    from pytorch_distributed_tpu_torch.train.checkpoint import (
        checkpoint_diff,
    )

    diffs = checkpoint_diff(ckpt_dir, state)
    return max(diffs.values()), len(diffs)


def parity_and_reshard(args, device, dist, ckpt_dir):
    import torch

    from pytorch_distributed_tpu_torch.parallel import DataParallel
    from pytorch_distributed_tpu_torch.train import (
        restore_checkpoint,
        save_checkpoint,
    )

    world, rank = dist.get_world_size(), dist.get_rank()
    runs = {}
    for strategy in ("dp", "zero1"):
        model, step, state = _build(args, device, strategy, remat=None,
                                    seed=args.seed, attn_impl="xla")
        for i in range(3):
            batch = DataParallel(device).shard_batch({"input_ids": _rows(
                args, args.seed + 1 + i, args.check_batch,
                model.config.vocab_size)})
            state, _ = step(state, batch)
        runs[strategy] = {n: p.detach().clone()
                          for n, p in model.named_parameters()}
        if strategy == "zero1":
            _sync(device)
            t0 = time.perf_counter()
            save_checkpoint(ckpt_dir, state)
            save_s = time.perf_counter() - t0
            own, n_leaves = _max_diff(ckpt_dir, state)
        del model, step, state
        _free(device)
    unequal = sum(not torch.equal(p, runs["zero1"][n])
                  for n, p in runs["dp"].items())
    unequal = int(dist.all_reduce(torch.tensor([unequal], device=device))
                  .item())
    worst = max((runs["dp"][n] - p).abs().max().item()
                for n, p in runs["zero1"].items())
    del runs
    _free(device)
    own = dist.all_reduce(torch.tensor([own], device=device),
                          dist.ReduceOp.MAX).item()
    out = dict(world=world, unequal_params_over_ranks=unequal,
               max_abs_diff_rank0=worst, save_s=save_s,
               written_state_vs_files=own, leaves=n_leaves)
    if rank == 0:
        print(f"parity: ZeRO-1 vs DDP after 3 accumulated steps, "
              f"{unequal} parameter tensors unequal over {world} ranks "
              f"(max |diff| on rank 0 {worst:.3e}); checkpoint at world "
              f"{world} in {save_s:.2f} s, state vs files max |diff| "
              f"{own:.3e} over {n_leaves} leaves")

    # re-shard: world 2 from ranks 0 and 1, then world 1 on rank 0
    port = torch.tensor([_free_port() if rank == 0 else 0], device=device)
    port = int(dist.broadcast(port, src=0).item())
    dist.destroy_process_group()
    for new_world in (2, 1):
        if rank >= new_world or new_world > world:
            continue
        if new_world > 1:
            # a store of our own: under torchrun a tcp:// init_method
            # would look for the launcher's store on that port
            store = torch.distributed.TCPStore(
                "localhost", port, new_world, rank == 0,
                timeout=datetime.timedelta(seconds=120))
            dist.init_process_group(store=store, world_size=new_world,
                                    rank=rank, device=device)
        strategy = "zero1" if new_world > 1 else "plain"
        model, step, state = _build(args, device, strategy, remat=None,
                                    seed=args.seed + 7, attn_impl="xla")
        _sync(device)
        t0 = time.perf_counter()
        restore_checkpoint(ckpt_dir, state)
        _sync(device)
        restore_s = time.perf_counter() - t0
        diff, n = _max_diff(ckpt_dir, state)   # this rank's boxes
        out[f"restore_world{new_world}"] = dict(
            strategy=strategy, max_abs_diff=diff, leaves=n,
            restore_s=restore_s, step=state.step)
        print(f"re-shard: rank {rank} restored at world {new_world} "
              f"({strategy}) in {restore_s:.2f} s, step {state.step}, its "
              f"state vs the files max |diff| {diff:.3e} over {n} leaves")
        del model, step, state
        _free(device)
        if new_world > 1:
            dist.destroy_process_group()
            del store
    return out


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="this rank's card (LOCAL_RANK) unless given")
    ap.add_argument("--size", choices=("tiny", "medium"), default="medium")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch-per-chip", type=int, default=8)
    ap.add_argument("--check-batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--turns", default="zero1,dp,dp,zero1,zero1,dp",
                    help="variants timed, in this order: "
                    + ", ".join(VARIANTS))
    ap.add_argument("--profile", default="",
                    help="variants to profile after the turns")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    named = [v for v in (args.turns + "," + args.profile).split(",") if v]
    if set(named) - set(VARIANTS):
        ap.error(f"unknown variants {sorted(set(named) - set(VARIANTS))}")

    from pytorch_distributed_tpu_torch.runtime import distributed as dist
    from pytorch_distributed_tpu_torch.runtime.device import device_info

    device = dist.rank_device(args.device)
    dist.init_process_group(device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    ckpt_dir = os.path.join(tempfile.gettempdir(),
                            f"ptd_zero1_scale_{os.environ.get('MASTER_PORT')}")
    try:
        out = dict(world=world, timing=[
            timing(args, device, dist, v) for v in args.turns.split(",")])
        if args.profile and device.type == "cuda":
            out["profile"] = [profile(args, device, dist, v)
                              for v in args.profile.split(",")]
        out["check"] = parity_and_reshard(args, device, dist, ckpt_dir)
        bad = [k for k, v in out["check"].items() if k.startswith("restore")
               and v["max_abs_diff"] != 0.0]
        ok = (out["check"]["unequal_params_over_ranks"] == 0
              and out["check"]["written_state_vs_files"] == 0.0 and not bad)
        out["ok"] = ok
        if rank == 0:
            print(json.dumps({"port_zero1_scale": out}))
            if device.type == "cuda":
                print(device_info())
        if not ok:
            print(f"port_zero1_scale: rank {rank}: a bitwise check failed",
                  file=sys.stderr)
    finally:
        dist.destroy_process_group()
        if rank == 0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
