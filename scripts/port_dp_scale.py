#!/usr/bin/env python3
"""ResNet-50 data-parallel across the cards of one host, one process per
card, under torchrun:

    torchrun --nproc-per-node 4 scripts/port_dp_scale.py

1. **check**: ``DataParallel`` over every rank equals one process on the
   same global batch. Three SGD steps (lr 0.1, momentum 0.9) of ResNet-50
   in f64 on a global batch of ``--check-batch`` images of ``--image``^2,
   BatchNorm on global statistics; rank 0 then trains a plain copy from
   the same weights on the whole batch and compares the rank-averaged
   loss of every step (to 1e-10 of its magnitude), every parameter
   (1e-8 of the largest entry of its tensor) and every running
   statistic (1e-10). In f64, because in f32 the backward of 53 norms
   at small batches magnifies the rounding of the two runs' other
   summation orders to ~1e-3 of a few bias updates (a gloo rehearsal at
   64^2: 3.6e-4 in f32, 1.5e-14 in f64).
2. **timing**: bench.py's ``bench_resnet50`` at this world size: 128
   images a card (``--batch-per-chip``), ``Policy.train()``, SGD(0.1,
   momentum 0.9), one placed batch fed again, 5 warm-up and ``--steps``
   timed steps ending in a value fetch: images/s per card. Twice with
   BatchNorm on global statistics (the port's data-parallel semantics)
   and twice on each rank's own batch, in turns, to price the global
   statistics' collectives; peak memory on rank 0.
3. **profile** (on the cards): ``torch.profiler`` over 2 more steps of
   each, rank 0's device ms a step by kernel family (``chip_smoke.py``'s
   ``profile_step`` and ``by_family``).

With ``--grad-compress none,bf16,fp16,int8`` (any of the four, comma
separated) the script runs, instead of 1-3, one **compress** phase per
form: a fresh ResNet-50 from the seed in ``DataParallel`` with that
form's DDP hook (``none``: DDP's own f32 all-reduce), SGD(0.1, momentum
0.9), ``--compress-steps`` steps on one placed batch (the loss after
them, against ``none``'s), then ``--steps`` timed steps: images/s per
card, the bytes each rank put on the wire a step (the hook's count;
for ``none`` a ring all-reduce's 2 (world - 1) / world of the f32
gradient bytes), and whether every rank's parameters are bitwise equal
(a digest of each rank's parameter bytes, gathered).

Rank 0 prints each result, a JSON line, and ``nvidia-smi``'s name and
power limit of the cards. ``--device cpu --image 32 --check-batch 8
--batch-per-chip 4 --steps 2`` rehearses it on gloo.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _model(device, policy, seed):
    import torch

    from pytorch_distributed_tpu_torch import ResNet50

    model = ResNet50(device=device, policy=policy)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


def _batch(rng, n, image):
    import numpy as np

    return {"image": rng.normal(size=(n, image, image, 3)).astype(np.float32),
            "label": rng.integers(1000, size=n).astype(np.int32)}


def check(args, device, dist):
    """DataParallel over the world against one process, rank 0 judging."""
    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch import (
        DataParallel,
        Policy,
        TrainState,
        build_train_step,
        classification_loss_fn,
        optim,
    )

    policy = Policy(torch.float64, torch.float64, torch.float64)
    model = _model(device, policy, args.seed)
    plain = copy.deepcopy(model)
    for bn in plain.batch_norms():      # rank 0 trains it alone
        bn.global_stats = False
    strategy = DataParallel(device)
    ddp = strategy.wrap(model)
    rng = np.random.default_rng(args.seed)
    batches = [_batch(rng, args.check_batch, args.image) for _ in range(3)]
    step = build_train_step(classification_loss_fn(ddp))
    state = TrainState(ddp, optim.SGD(model, lr=0.1, momentum=0.9),
                       policy=policy)
    losses = []
    for b in batches:
        state, metrics = step(state, strategy.shard_batch(b))
        losses.append(float(dist.all_reduce(metrics["loss"],
                                            dist.ReduceOp.AVG)))
    worst = {}
    if dist.get_rank() == 0:
        step1 = build_train_step(classification_loss_fn(plain))
        state1 = TrainState(plain, optim.SGD(plain, lr=0.1, momentum=0.9),
                            policy=policy)
        want = []
        for b in batches:
            state1, metrics = step1(
                state1, {k: torch.from_numpy(v).to(device)
                         for k, v in b.items()})
            want.append(float(metrics["loss"]))
        worst["loss"] = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        ref = plain.state_dict()
        for name, t in model.state_dict().items():
            kind = "stats" if "running" in name else "params"
            err = ((t - ref[name]).abs().max()
                   / ref[name].abs().max().clamp_min(1e-30)).item()
            worst[kind] = max(worst.get(kind, 0.0), err)
        ok = (worst["loss"] <= 1e-10 and worst["params"] <= 1e-8
              and worst["stats"] <= 1e-10)
        print(f"check: DataParallel x{dist.get_world_size()} vs one process "
              f"on {args.check_batch} images of {args.image}^2, 3 SGD steps, "
              f"f64: losses {losses} vs {want}; worst loss {worst['loss']:.2e}"
              f" (<= 1e-10), params {worst['params']:.2e} (<= 1e-8), running"
              f" statistics {worst['stats']:.2e} (<= 1e-10): "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        worst["ok"] = ok
    verdict = torch.tensor([float(worst.get("ok", True))], device=device)
    if not dist.broadcast(verdict, src=0).item():
        raise AssertionError("DataParallel disagrees with one process")
    return dict(losses=losses, **worst)


def timing(args, device, dist, global_stats, profile=False):
    """images/s per card at bench.py's resnet50 shape; with ``profile``,
    device ms a step by kernel family over 2 steps (torch.profiler on
    every rank, rank 0's reported) instead."""
    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch import (
        DataParallel,
        Policy,
        TrainState,
        build_train_step,
        classification_loss_fn,
        optim,
    )

    world = dist.get_world_size()
    mode = "global" if global_stats else "per-rank"
    model = _model(device, Policy.train(), args.seed)
    strategy = DataParallel(device)
    ddp = strategy.wrap(model)
    for bn in model.batch_norms():
        bn.global_stats = global_stats
    batch = strategy.shard_batch(_batch(np.random.default_rng(args.seed),
                                        args.batch_per_chip * world,
                                        args.image))
    step = build_train_step(classification_loss_fn(ddp))
    state = TrainState(ddp, optim.SGD(model, lr=0.1, momentum=0.9))
    for _ in range(5):
        state, metrics = step(state, batch)
    float(metrics["loss"])
    _sync(device)
    dist.barrier()
    if profile:
        from chip_smoke import by_family, profile_step

        total_us, rows = profile_step(step, state, batch)
        families = by_family(rows)
        if dist.get_rank() == 0:
            print(f"profile: world {world}, BatchNorm on {mode} statistics, "
                  f"rank 0: device busy {total_us / 2e3:.3f} ms/step",
                  flush=True)
            for name, ms in sorted(families.items(), key=lambda kv: -kv[1]):
                print(f"  {ms:9.3f} ms/step  {name}", flush=True)
            for key, us, count in rows[:12]:
                print(f"  {us / 2e3:9.3f} ms/step  x{count // 2:<5d} "
                      f"{key[:90]}", flush=True)
        return dict(global_stats=global_stats, device_busy_ms=total_us / 2e3,
                    families=families)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    dt = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    peak_txt = "not measured" if peak is None else f"{peak:.2f} GiB"
    ips = args.batch_per_chip * world * args.steps / dt / world
    if dist.get_rank() == 0:
        print(f"timing: world {world}, BatchNorm on {mode} statistics: "
              f"{ips:.2f} images/s per card, step {1e3 * dt / args.steps:.3f}"
              f" ms ({args.batch_per_chip} x {args.image}^2 a card), peak "
              f"memory {peak_txt} on rank 0, loss {loss:.4f}", flush=True)
    return dict(images_per_s_per_chip=ips, step_ms=1e3 * dt / args.steps,
                peak_mem_gib=peak, global_stats=global_stats, loss=loss)


def _param_digest(model) -> int:
    """The first 8 bytes of a SHA-256 over every parameter's bytes, as an
    int64: equal on two ranks exactly when their parameters are (short
    of a collision)."""
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().contiguous().view(-1).numpy().tobytes())
    return int.from_bytes(h.digest()[:8], "little", signed=True)


def compress(args, device, dist, form):
    """One ``--grad-compress`` form: the loss after ``--compress-steps``
    steps, images/s per card over ``--steps`` more, wire bytes a step,
    and the ranks' parameters bitwise equal or not."""
    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch import (
        DataParallel,
        Policy,
        TrainState,
        build_train_step,
        classification_loss_fn,
        optim,
    )

    world = dist.get_world_size()
    kind = None if form == "none" else form
    model = _model(device, Policy.train(), args.seed)
    strategy = DataParallel(device)
    ddp = strategy.wrap(model, grad_compress=kind)
    batch = strategy.shard_batch(_batch(np.random.default_rng(args.seed),
                                        args.batch_per_chip * world,
                                        args.image))
    step = build_train_step(classification_loss_fn(ddp),
                            grad_compression=kind)
    state = TrainState(ddp, optim.SGD(model, lr=0.1, momentum=0.9))
    losses = []
    for _ in range(args.compress_steps):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    losses = [float(dist.all_reduce(x, dist.ReduceOp.AVG)) for x in losses]
    hook = ddp.grad_compress_hook
    sent0 = hook.stats.wire_bytes if hook is not None else 0
    _sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, metrics = step(state, batch)
    float(metrics["loss"])
    dt = time.perf_counter() - t0
    grad_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if hook is not None:
        wire = (hook.stats.wire_bytes - sent0) / args.steps
    else:
        wire = 2 * (world - 1) / world * grad_bytes
    digests = dist.all_gather(torch.tensor(_param_digest(model),
                                           device=device)).tolist()
    equal = len(set(digests)) == 1
    ips = args.batch_per_chip * args.steps / dt
    if dist.get_rank() == 0:
        print(f"compress {form}: world {world}, {ips:.2f} images/s per card "
              f"(step {1e3 * dt / args.steps:.3f} ms, {args.batch_per_chip} x "
              f"{args.image}^2 a card), {wire / 2**20:.2f} MiB on the wire a "
              f"rank a step ({wire / grad_bytes:.3f} of the f32 gradients' "
              f"{grad_bytes / 2**20:.2f} MiB), loss after "
              f"{args.compress_steps} steps {losses[-1]:.6f} (first "
              f"{losses[0]:.6f}), ranks' parameters "
              f"{'bitwise equal' if equal else 'DIFFER'}", flush=True)
    if not equal:
        raise AssertionError(f"{form}: the ranks' parameters differ")
    return dict(form=form, images_per_s_per_chip=ips,
                step_ms=1e3 * dt / args.steps, wire_bytes_per_step=wire,
                grad_bytes=grad_bytes, losses=losses,
                params_bitwise_equal=equal)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="this rank's card (LOCAL_RANK) unless given")
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--check-batch", type=int, default=32)
    ap.add_argument("--batch-per-chip", type=int, default=128)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad-compress", default=None,
                    help="comma-separated forms among none,bf16,fp16,int8: "
                    "run the compress phase for each, instead of 1-3")
    ap.add_argument("--compress-steps", type=int, default=20)
    args = ap.parse_args(argv)
    forms = [] if args.grad_compress is None else args.grad_compress.split(",")
    bad = set(forms) - {"none", "bf16", "fp16", "int8"}
    if bad:
        ap.error(f"unknown --grad-compress form(s) {sorted(bad)}")

    import torch

    from pytorch_distributed_tpu_torch.runtime import distributed as dist
    from pytorch_distributed_tpu_torch.runtime.device import device_info

    device = dist.rank_device(args.device)
    dist.init_process_group(device=device)
    try:
        if device.type == "cuda":
            torch.backends.cudnn.benchmark = True
        out = dict(world=dist.get_world_size())
        if forms:
            out["compress"] = [compress(args, device, dist, f) for f in forms]
            ref = out["compress"][0]["losses"][-1]
            if dist.get_rank() == 0:
                print("compress: loss after "
                      f"{args.compress_steps} steps against {forms[0]}'s: "
                      + ", ".join(f"{c['form']} {c['losses'][-1] - ref:+.2e}"
                                  for c in out["compress"]), flush=True)
        else:
            out.update(check=check(args, device, dist), timing=[])
            for global_stats in (True, False, False, True):
                out["timing"].append(timing(args, device, dist,
                                            global_stats))
            if device.type == "cuda":   # last: the profiler slows the host
                out["profile"] = [timing(args, device, dist, g,
                                         profile=True)
                                  for g in (True, False)]
        if dist.get_rank() == 0:
            print(json.dumps({"port_dp_scale": out}))
            if device.type == "cuda":
                print(device_info())
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
