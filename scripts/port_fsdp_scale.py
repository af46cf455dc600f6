#!/usr/bin/env python3
"""Llama-3-8B under FSDP full-shard across the cards of one host, one
process per card, under torchrun:

    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/port_fsdp_scale.py

1. **timing**: the JAX recipe's Llama-3-8B step (``recipes/llama_fsdp.py
   --strategy fsdp --fsdp 4 --remat --vocab-chunk 8192``) at full width
   and all 32 layers (8.03 B parameters), ``Policy.train()``,
   FSDP2 full-shard over every rank (the model made on the meta device,
   each rank drawing its own rows of the seeded weights), clip(1.0) then
   adamw(1e-4, decay 1e-4), ``--batch-per-chip`` rows of ``--seq``
   tokens a card, one placed batch fed again: 2 warm-up steps, then
   ``--turns`` windows of ``--steps`` steps in one process, each ending
   in one value fetch. Tokens/s per card for each window, each rank's
   peak memory. Then (on a card, after the windows: the profiler
   slows the host after it) ``torch.profiler`` over two more steps:
   device busy ms a step on each rank, and rank 0's time by kernel
   family.
2. **parity** at ``CHECK_LAYERS`` (reduced depth, full width of the
   blocks, the vocabulary cut to 32,003 rows: the f64 DDP state of the
   whole 128,256-row head and embedding alone would take 48 GB a card;
   odd, so it shards unevenly), in f64 on the einsum attention (the
   flash kernels take bf16 and f32): DDP from the seeded weights on 3
   steps of 2 microbatches, then FSDP from the same weights on the same
   batches; the first step's clipped gradients and the parameters it
   made equal within ``STEP1_RTOL`` of each tensor's largest magnitude,
   every parameter after the third step within ``STEP3_RTOL``.
3. **re-sharding** at the same size in f32: FSDP trains 2 steps and
   checkpoints at this world size (each rank writes its own rows);
   every rank's state equals the files to the bit (``checkpoint_diff``);
   then ranks 0 and 1 form a world of 2, and rank 0 alone a world of 1,
   each restores the checkpoint into a fresh FSDP model and optimizer,
   and must equal the files to the bit too; then every rank joins a
   world of all ranks again, where rank 0 learns the worst difference.

``--optimizer adafactor`` times the recipe's Adafactor instead
(unclipped; the optimizer state's bytes per rank printed beside the
peak memory); ``--phases`` picks which of ``timing``, ``parity`` and
``reshard`` run (all three by default; parity and re-sharding keep
AdamW).

Rank 0 prints each result, a JSON line, and ``nvidia-smi``'s name and
power limit of the cards, and exits non-zero when a check fails.
``--device cpu --size tiny --seq 16 --batch-per-chip 2 --check-batch 8
--steps 2 --turns 1`` rehearses it on gloo.
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
CHECK_LAYERS, CHECK_VOCAB = 2, 32_003
# FSDP against DDP in f64. After the first step: the same per-rank
# arithmetic from the same weights, the gradients summed over the ranks
# in another order (reduce-scatter vs allreduce, the clip's norm over
# shards): f64 rounding, ~1e-16 (5.3e-16 on four H100s), so 1e-12. From
# the second step the weights differ by that rounding, and RMSNorm and the
# loss take their statistics in f32 (as the JAX model does): a 1e-16
# change can flip an f32 rounding, an entry whose gradient cancels moves
# by far more than its ulp, and Adam's normalization turns that relative
# change into a change of its lr-sized update. After the third step:
# 1e-5 of the largest weight (4.4e-6 read on four H100s; a wrong gather,
# shard or reduction moves every entry by ~lr, 1e-3 of it).
STEP1_RTOL, STEP3_RTOL = 1e-12, 1e-5


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _config(args, *, check):
    from pytorch_distributed_tpu_torch import LlamaConfig

    if args.size == "tiny":
        cfg = LlamaConfig.tiny()
        return dataclasses.replace(cfg, num_layers=CHECK_LAYERS,
                                   vocab_size=509) if check else cfg
    cfg = LlamaConfig.llama3_8b()
    if check:
        return dataclasses.replace(cfg, num_layers=CHECK_LAYERS,
                                   vocab_size=CHECK_VOCAB)
    return dataclasses.replace(cfg, remat=True)


def _build(cfg, device, strategy, *, seed, policy, chunk, attn_impl=None,
           accum=1, optimizer="adamw"):
    """(model, step, state): ``strategy`` "fsdp" (full shard over every
    rank) or "dp" (DDP); ``optimizer`` the recipe's ``adamw`` (clipped)
    or ``adafactor`` (alone)."""
    from pytorch_distributed_tpu_torch import (
        FSDP,
        DataParallel,
        TrainState,
        build_train_step,
        causal_lm_loss_fn,
        optim,
    )
    from pytorch_distributed_tpu_torch.recipes.llama_fsdp import (
        ADAMW_WEIGHT_DECAY,
        build_model,
        build_optimizer,
    )

    par = FSDP(device) if strategy == "fsdp" else DataParallel(device)
    model, net = build_model(cfg, par, device, seed, policy)
    if optimizer == "adafactor":
        opt = build_optimizer("adafactor", model, par, 1e-4)
    elif strategy == "fsdp":
        opt = par.optimizer(model, optim.AdamW, lr=1e-4,
                            weight_decay=ADAMW_WEIGHT_DECAY)
    else:
        opt = optim.AdamW(model, lr=1e-4, weight_decay=ADAMW_WEIGHT_DECAY)
    if optimizer != "adafactor":
        opt = optim.clip_grad_norm(opt, 1.0)
    step = build_train_step(
        causal_lm_loss_fn(net, vocab_chunk_size=chunk, attn_impl=attn_impl),
        accum_steps=accum)
    return model, step, TrainState(net, opt, policy=policy), par


def _rows(seed, n, seq, vocab):
    import numpy as np

    return {"input_ids": np.random.default_rng(seed).integers(
        0, vocab, (n, seq)).astype(np.int64)}


def timing(args, device, dist):
    import torch

    from chip_smoke import LLAMA_FAMILIES, by_family, profile_step
    from pytorch_distributed_tpu_torch import Policy

    cfg = _config(args, check=False)
    world, rank = dist.get_world_size(), dist.get_rank()
    t0 = time.perf_counter()
    model, step, state, par = _build(cfg, device, "fsdp", seed=args.seed,
                                     policy=Policy.train(), chunk=CHUNK,
                                     optimizer=args.optimizer)
    _sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    batch = par.shard_batch(_rows(args.seed, args.batch_per_chip * world,
                                  args.seq, cfg.vocab_size))
    losses = []
    for _ in range(2):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    windows = []
    for turn in range(args.turns):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = step(state, batch)
        loss = float(metrics["loss"])   # the value fetch ends the window
        dt = time.perf_counter() - t0
        tokens = args.batch_per_chip * args.seq * args.steps / dt
        windows.append(dict(
            step_ms=1e3 * dt / args.steps, loss=loss,
            # a CPU rehearsal's rate is no card's: it goes under another name
            tokens_per_s_per_card=tokens if on_card else None,
            tokens_per_s_per_rank_on_cpu=None if on_card else tokens))
        if rank == 0:
            print(f"timing window {turn + 1}: {tokens:.1f} tokens/s per "
                  f"{'card' if on_card else 'rank'} "
                  f"({1e3 * dt / args.steps:.2f} ms/step over "
                  f"{args.steps} steps), loss {loss:.4f}", flush=True)
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if on_card else 0.0
    peaks = dist.all_gather(torch.tensor([peak], device=device))
    from chip_smoke import _opt_state_bytes
    from pytorch_distributed_tpu_torch.interop import unwrap_optimizer

    state_bytes = dist.all_gather(torch.tensor(
        [float(_opt_state_bytes(state.optimizer))], device=device))
    paths = ""
    if args.optimizer == "adafactor":
        # the factored leaves' path: each rank's rows layer by layer (the
        # partial means all-reduced), or the whole leaf on every rank
        opt = unwrap_optimizer(state.optimizer)[1]
        fac = [leaf for leaf in opt.leaves if opt.factored(leaf)]
        rows = sum(1 for leaf in fac if opt.per_layer(leaf))
        paths = (f"; factored leaves {len(fac)}: {rows} on each rank's rows,"
                 f" {len(fac) - rows} assembled whole")
    out = dict(layers=cfg.num_layers, params=n_params, world=world,
               optimizer=args.optimizer, factored_paths=paths[2:] or None,
               opt_state_bytes_by_rank=state_bytes[:, 0].tolist(),
               batch_per_chip=args.batch_per_chip, seq=args.seq,
               init_s=init_s, warmup_losses=losses, windows=windows,
               peak_mem_gib_by_rank=peaks[:, 0].tolist() if on_card else None)
    if rank == 0:
        print(f"timing: Llama-3-8B width, {cfg.num_layers} layers, {n_params}"
              f" parameters, FSDP full-shard over {world} ranks, remat, "
              f"vocab chunk {CHUNK}, {args.batch_per_chip} x {args.seq} a "
              f"rank, one placed batch (its loss {losses[0]:.4f} at the "
              f"first warm-up step); {args.optimizer}, optimizer state "
              f"by rank "
              + ", ".join(f"{b:.0f}" for b in out["opt_state_bytes_by_rank"])
              + f" bytes{paths}; init {init_s:.1f} s; peak memory by rank "
              + (", ".join(f"{p:.3f}" for p in out["peak_mem_gib_by_rank"])
                 + " GiB" if on_card else "not measured"), flush=True)
    if on_card:
        total_us, rows = profile_step(step, state, batch)
        busy = dist.all_gather(torch.tensor([total_us / 2e3], device=device))
        families = by_family(rows, LLAMA_FAMILIES)
        out["profile"] = dict(
            device_busy_ms_by_rank=busy[:, 0].tolist(),
            families_rank0=families,
            top_rank0=[dict(name=k[:120], ms_per_step=us / 2e3, count=c // 2)
                       for k, us, c in rows[:15]])
        if rank == 0:
            print("profile, 2 steps: device busy ms/step by rank "
                  + ", ".join(f"{b:.2f}" for b in busy[:, 0].tolist()),
                  flush=True)
            for name, ms in sorted(families.items(), key=lambda kv: -kv[1]):
                print(f"  {ms:9.3f} ms/step  {name}", flush=True)
            for k, us, c in rows[:15]:
                print(f"  {us / 2e3:9.3f} ms/step  x{c // 2:<5d} {k[:90]}",
                      flush=True)
    del model, step, state, batch, par
    _free(device)
    return out


def parity(args, device, dist):
    """FSDP against DDP in f64 at reduced depth."""
    import torch

    from pytorch_distributed_tpu_torch import Policy

    cfg = _config(args, check=True)
    f64 = Policy(torch.float64, torch.float64, torch.float64)
    world = dist.get_world_size()
    ref = {}

    def rel(tensors, key):   # max over tensors of max|diff| / max|ref|
        worst = 0.0
        for n, t in tensors:
            got = (t.full_tensor() if strategy == "fsdp" else t).to(
                "cpu", copy=True)   # a CPU parameter's .cpu() aliases it
            if strategy == "dp":
                ref[key, n] = got
                continue
            want = ref[key, n]
            err = (got - want).abs().max().item()
            worst = max(worst, err / max(want.abs().max().item(), 1e-300))
        return worst

    for strategy in ("dp", "fsdp"):
        model, step, state, par = _build(
            cfg, device, strategy, seed=args.seed, policy=f64, chunk=None,
            attn_impl="xla", accum=2)
        for i in range(3):
            state, _ = step(state, par.shard_batch(_rows(
                args.seed + 1 + i, args.check_batch, args.seq,
                cfg.vocab_size)))
            if i == 0:   # the clipped gradients and the first update
                grad_rel = rel(((n, p.grad.detach()) for n, p in
                                model.named_parameters()), "grad")
                step1_rel = rel(((n, p.detach()) for n, p in
                                 model.named_parameters()), "step1")
        step3_rel = rel(((n, p.detach()) for n, p in
                         model.named_parameters()), "step3")
        del model, step, state, par
        _free(device)
    worst = dist.all_reduce(torch.tensor(
        [grad_rel, step1_rel, step3_rel], device=device,
        dtype=torch.float64), dist.ReduceOp.MAX).tolist()
    limits = [STEP1_RTOL, STEP1_RTOL, STEP3_RTOL]
    out = dict(layers=cfg.num_layers, vocab=cfg.vocab_size, world=world,
               check_batch=args.check_batch, steps=3, accum=2,
               grad_step1_max_rel_diff=worst[0],
               param_step1_max_rel_diff=worst[1],
               param_step3_max_rel_diff=worst[2], rtol=limits,
               ok=all(w <= lim for w, lim in zip(worst, limits)))
    if dist.get_rank() == 0:
        print(f"parity: FSDP vs DDP in f64 at {cfg.num_layers} layers, vocab "
              f"{cfg.vocab_size}, 3 steps of 2 microbatches over {world} "
              f"ranks, max |diff| / max|ref| per tensor: step 1's clipped "
              f"gradients {worst[0]:.3e} and parameters {worst[1]:.3e} <= "
              f"{STEP1_RTOL:g}, parameters after step 3 {worst[2]:.3e} <= "
              f"{STEP3_RTOL:g} -> {'ok' if out['ok'] else 'FAIL'}",
              flush=True)
    return out


def _max_diff(ckpt_dir, state):
    from pytorch_distributed_tpu_torch.train.checkpoint import (
        checkpoint_diff,
    )

    diffs = checkpoint_diff(ckpt_dir, state)
    return max(diffs.values()), len(diffs)


def reshard(args, device, dist, ckpt_dir):
    import torch

    from pytorch_distributed_tpu_torch import Policy
    from pytorch_distributed_tpu_torch.train import (
        restore_checkpoint,
        save_checkpoint,
    )

    cfg = _config(args, check=True)
    world, rank = dist.get_world_size(), dist.get_rank()
    model, step, state, par = _build(cfg, device, "fsdp", seed=args.seed,
                                     policy=Policy.train(), chunk=CHUNK)
    for i in range(2):
        state, _ = step(state, par.shard_batch(_rows(
            args.seed + 1 + i, args.check_batch, args.seq, cfg.vocab_size)))
    _sync(device)
    t0 = time.perf_counter()
    save_checkpoint(ckpt_dir, state)
    save_s = time.perf_counter() - t0
    own, n_leaves = _max_diff(ckpt_dir, state)
    del model, step, state, par
    _free(device)
    own = dist.all_reduce(torch.tensor([own], device=device),
                          dist.ReduceOp.MAX).item()
    out = dict(world=world, save_s=save_s, written_state_vs_files=own,
               leaves=n_leaves)
    if rank == 0:
        print(f"re-shard: checkpoint at world {world} in {save_s:.2f} s, "
              f"state vs files max |diff| {own:.3e} over {n_leaves} leaves",
              flush=True)
    # a port for each smaller world's store and one for the world that
    # gathers the verdicts (a closed one lingers)
    ports = torch.tensor([_free_port() for _ in range(3)] if rank == 0
                         else [0, 0, 0], device=device)
    ports = dist.broadcast(ports, src=0).tolist()
    dist.destroy_process_group()
    # the store of the world that gathers the verdicts, joined now: the
    # ranks outside the smaller worlds wait there while rank 0 restores
    # (a client made after them timed out and retried on four H100s)
    verdicts = torch.distributed.TCPStore(
        "localhost", int(ports[2]), world, rank == 0,
        timeout=datetime.timedelta(seconds=900))
    for new_world in (2, 1):
        if rank >= new_world or new_world > world:
            continue
        # a store of our own: under torchrun a tcp:// init_method would
        # look for the launcher's store on that port
        store = torch.distributed.TCPStore(
            "localhost", int(ports[new_world - 1]), new_world, rank == 0,
            timeout=datetime.timedelta(seconds=120))
        dist.init_process_group(store=store, world_size=new_world, rank=rank,
                                device=device)
        model, step, state, par = _build(cfg, device, "fsdp",
                                         seed=args.seed + 7,
                                         policy=Policy.train(), chunk=CHUNK)
        _sync(device)
        t0 = time.perf_counter()
        restore_checkpoint(ckpt_dir, state)
        _sync(device)
        restore_s = time.perf_counter() - t0
        diff, n = _max_diff(ckpt_dir, state)   # this rank's boxes
        out[f"restore_world{new_world}"] = dict(
            max_abs_diff=diff, leaves=n, restore_s=restore_s, step=state.step)
        print(f"re-shard: rank {rank} restored at world {new_world} in "
              f"{restore_s:.2f} s, step {state.step}, its rows vs the "
              f"files max |diff| {diff:.3e} over {n} leaves", flush=True)
        del model, step, state, par
        _free(device)
        dist.destroy_process_group()
        del store
    # every rank again, so that rank 0 holds the worst restore of any
    dist.init_process_group(store=verdicts, world_size=world, rank=rank,
                            device=device)
    own = max([v["max_abs_diff"] for k, v in out.items()
               if k.startswith("restore")], default=0.0)
    out["restore_max_abs_diff"] = dist.all_reduce(
        torch.tensor([own], device=device), dist.ReduceOp.MAX).item()
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
    ap.add_argument("--size", choices=("tiny", "8b"), default="8b")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--batch-per-chip", type=int, default=2)
    ap.add_argument("--check-batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--optimizer", choices=("adamw", "adafactor"),
                    default="adamw",
                    help="the timing's optimizer (the recipe's)")
    ap.add_argument("--phases", default="timing,parity,reshard",
                    help="which of timing, parity, reshard to run")
    args = ap.parse_args(argv)

    from pytorch_distributed_tpu_torch.runtime import distributed as dist
    from pytorch_distributed_tpu_torch.runtime.device import device_info

    device = dist.rank_device(args.device)
    dist.init_process_group(device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    ckpt_dir = os.path.join(tempfile.gettempdir(),
                            f"ptd_fsdp_scale_{os.environ.get('MASTER_PORT')}")
    ok = False
    try:
        phases = args.phases.split(",")
        out = dict(world=world)
        ok = True
        if "timing" in phases:
            out["timing"] = timing(args, device, dist)
        if "parity" in phases:
            out["parity"] = parity(args, device, dist)
            ok = ok and out["parity"]["ok"]
        if "reshard" in phases:
            out["reshard"] = reshard(args, device, dist, ckpt_dir)
            ok = (ok and out["reshard"]["restore_max_abs_diff"] == 0.0
                  and out["reshard"]["written_state_vs_files"] == 0.0)
        out["ok"] = ok
        if rank == 0:
            print(json.dumps({"port_fsdp_scale": out}))
            if device.type == "cuda":
                print(device_info())
        if not ok:
            print(f"port_fsdp_scale: rank {rank}: a check failed",
                  file=sys.stderr)
    finally:
        dist.destroy_process_group()
        if rank == 0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
