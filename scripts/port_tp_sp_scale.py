#!/usr/bin/env python3
"""Llama-3-8B under tensor and sequence parallelism across the cards of
one host, one process per card, under torchrun:

    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/port_tp_sp_scale.py

Each configuration is the Llama recipe's model, optimizer and step
(``recipes/llama_fsdp.py``: ``Policy.train()``, FSDP2 over ``fsdp`` with
the TP plan of ``llama_partition_rules`` over ``tp``, remat, the chunked
loss at 8192, clip(1.0) then adamw(1e-4, decay 1e-4)), built from the
same seeded weights and fed the same global batch, placed once:

* **(a) tp**: full width and all 32 layers, a global batch of
  ``--tp-batch`` rows of 2048: ``--fsdp 2 --tp 2`` against ``--fsdp 4``;
* **(b) sp**: full width cut to ``--sp-layers`` layers, ``--sp-batch``
  rows of ``--sp-seq`` (8192): ``--sp 4`` in ring mode and in Ulysses
  mode against ``--fsdp 4 --sp 1``.

For each: the first 3 losses (the global batch's mean), the global
gradient norm of the first batch (summed over ``sp`` as the step sums
it), 2 warm-up steps, then ``--steps`` timed steps ending in one value
fetch (ms a step, tokens/s per card), each rank's peak memory, and on a
card ``torch.profiler`` over two more steps: the share of the window in
which some kernel ran on the card (the union over streams), the same
for the kernels other than NCCL's, and rank 0's largest kernels. The
losses of each configuration must be finite and within its part's limit
of its reference's (``TP_LOSS_RTOL``, ``SP_LOSS_RTOL``); a control run
of ring at ``--sp 4`` with its causal mask planted off (losses only)
must read above ``SP_LOSS_RTOL``, or that limit could not see a wrong
mask. The first batch's gradients are dropped before the peak is reset:
the window holds the step's own.

The allocator runs with ``expandable_segments:True`` unless
``PYTORCH_CUDA_ALLOC_CONF`` says otherwise. ``--parts tp,sp`` picks the
parts. Rank 0 prints each result, a JSON
line, and ``nvidia-smi``'s name and power limit of the cards, and exits
non-zero when a check fails. ``--device cpu --size tiny --tp-batch 4
--sp-batch 4 --sp-seq 32 --steps 2`` rehearses it on gloo.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the caching allocator grows segments in place rather than cutting new
# ones: ring's per-block f32 tensors at 4 x 8192 otherwise fragment the
# card's memory near its peak (set before torch is imported)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

CHUNK = 8192
# the same weights and batch under two meshes: bf16 products cut along
# other dims (TP's row-parallel partial sums are rounded to bf16 before
# they are summed) and, under ring, f32 attention blocks in place of the
# flash kernels, so the losses part by bf16 rounding. Each part's limit
# sits near its reading (NVIDIA H100 80GB HBM3, 700 W): tp 2 read 1.47e-3
# of fsdp 4's losses, ring and Ulysses at sp 4 4.7e-5 of fsdp 4 sp 1's
TP_LOSS_RTOL = 3e-3
SP_LOSS_RTOL = 2e-4


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _config(args, layers):
    from pytorch_distributed_tpu_torch import LlamaConfig

    # tiny: 4 kv heads, so that Ulysses divides them over 4 ranks
    cfg = (dataclasses.replace(LlamaConfig.tiny(), num_kv_heads=4)
           if args.size == "tiny" else LlamaConfig.llama3_8b())
    return dataclasses.replace(cfg, remat=True,
                               num_layers=layers or cfg.num_layers)


def _profile(step, state, batch, device):
    """torch.profiler over two steps: the window's wall ms a step, the ms
    a step in which any kernel ran on the card (the union of the kernels'
    intervals over every stream: NCCL's overlap the compute's), the same
    for the kernels other than NCCL's, and the largest kernels by summed
    time."""
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

    def union_ms(events):
        total, end = 0.0, None
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in events):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e3 / 2

    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / 2
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(window_ms_per_step=wall, busy_ms=union_ms(kernels),
                compute_busy_ms=union_ms(
                    [e for e in kernels if "nccl" not in e.name.lower()]),
                top_kernels_ms_per_step=[(k[:100], v) for k, v in top])


def _global_loss(dist, value, device):
    """The global batch's mean loss: every rank logs its data share's
    (the ``sp`` and ``tp`` ranks of one share log the same), so the
    average over the ranks."""
    import torch

    return dist.all_reduce(torch.tensor([float(value)], device=device),
                           dist.ReduceOp.AVG).item()


def _first_grad_norm(loss_fn, batch, net, optim):
    """The first batch's global gradient norm, summed over sp as the step
    sums it. Only the float leaves: the gradients are gone when it
    returns, so they do not sit in the timed window's peak."""
    import torch

    loss, _ = loss_fn(batch, None)
    loss.backward()
    group = getattr(net, "sequence_grad_group", None)
    grads = [p.grad for p in net.parameters() if p.grad is not None]
    if group is not None:
        for g in grads:
            torch.distributed.all_reduce(optim._local(g), group=group)
    norm = float(optim.global_norm(grads))
    net.zero_grad(set_to_none=True)
    return norm


@contextlib.contextmanager
def _ring_unmasked():
    """Ring attention with its causal mask planted off (the control)."""
    from pytorch_distributed_tpu_torch.parallel import sequence

    ring = sequence.ring_attention
    sequence.ring_attention = (
        lambda *a, **kw: ring(*a, **{**kw, "causal": False}))
    try:
        yield
    finally:
        sequence.ring_attention = ring


def run(args, device, dist, name, spec, mode, cfg, rows, seq, timed=True):
    """One configuration (see the module docstring); ``timed=False``
    stops after the losses."""
    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch import (
        FSDP,
        MeshSpec,
        Policy,
        TrainState,
        build_train_step,
        causal_lm_loss_fn,
        optim,
    )
    from pytorch_distributed_tpu_torch.models.llama import (
        llama_partition_rules,
    )
    from pytorch_distributed_tpu_torch.parallel import sequence_parallel
    from pytorch_distributed_tpu_torch.recipes.llama_fsdp import (
        ADAMW_WEIGHT_DECAY,
        build_model,
    )

    world, rank = dist.get_world_size(), dist.get_rank()
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    par = FSDP(device, MeshSpec(**spec), extra_rules=llama_partition_rules())
    model, net = build_model(cfg, par, device, args.seed, Policy.train())
    opt = optim.clip_grad_norm(par.optimizer(
        model, optim.AdamW, lr=1e-4, weight_decay=ADAMW_WEIGHT_DECAY), 1.0)
    loss_fn = causal_lm_loss_fn(net, vocab_chunk_size=CHUNK)
    step = build_train_step(loss_fn)
    state = TrainState(net, opt, policy=Policy.train())
    ids = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (rows, seq)).astype(np.int64)
    batch = par.shard_batch({"input_ids": ids})
    init_s = time.perf_counter() - t0
    ctx = sequence_parallel("sp", mode) if mode else contextlib.nullcontext()
    out = dict(name=name, spec=spec, mode=mode, layers=cfg.num_layers,
               rows=rows, seq=seq, world=world, init_s=init_s,
               local_rows=tuple(batch["input_ids"].shape))
    with ctx:
        out["grad_norm"] = _first_grad_norm(loss_fn, batch, net, optim)
        losses = []
        for _ in range(3):
            state, metrics = step(state, batch)
            losses.append(_global_loss(dist, metrics["loss"], device))
        out["losses"] = losses
        if timed:
            _time_steps(args, step, state, batch, device, dist, out)
    if rank == 0:
        print(f"{name}: {json.dumps(out)}", flush=True)
    del model, net, opt, step, state, batch, par
    _free(device)
    return out


def _time_steps(args, step, state, batch, device, dist, out) -> None:
    """``--steps`` timed steps ending in one value fetch, each rank's peak
    since they began and, on a card, the profile, into ``out``."""
    import torch

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, metrics = step(state, batch)
    float(metrics["loss"])   # the value fetch ends the window
    dt = (time.perf_counter() - t0) / args.steps
    out["step_ms"] = 1e3 * dt
    tokens = out["rows"] * out["seq"] / dt / out["world"]
    out["tokens_per_s_per_card" if on_card
        else "tokens_per_s_per_rank_on_cpu"] = tokens
    if not on_card:
        out["peak_mem_gib_by_rank"] = None
        return
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    out["peak_mem_gib_by_rank"] = dist.all_gather(torch.tensor(
        [peak], device=device))[:, 0].tolist()
    prof = _profile(step, state, batch, device)
    shares = dist.all_gather(torch.tensor(
        [prof["busy_ms"] / prof["window_ms_per_step"],
         prof["compute_busy_ms"] / prof["window_ms_per_step"]],
        device=device))
    out["device_busy_share_by_rank"] = shares[:, 0].tolist()
    out["compute_busy_share_by_rank"] = shares[:, 1].tolist()
    out["profile_rank0"] = prof


def _agree(out, ref, rtol):
    got, want = out["losses"], ref["losses"]
    err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    out["loss_rel_err_vs_" + ref["name"]] = err
    return all(math.isfinite(x) for x in got) and err <= rtol


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="this rank's card (LOCAL_RANK) unless given")
    ap.add_argument("--size", choices=("tiny", "8b"), default="8b")
    ap.add_argument("--tp-batch", type=int, default=8,
                    help="(a)'s global batch rows of 2048 (--sp-seq on "
                         "the CPU)")
    ap.add_argument("--sp-layers", type=int, default=4)
    ap.add_argument("--sp-batch", type=int, default=4)
    ap.add_argument("--sp-seq", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="tp,sp")
    args = ap.parse_args(argv)

    from pytorch_distributed_tpu_torch.runtime import distributed as dist
    from pytorch_distributed_tpu_torch.runtime.device import device_info

    device = dist.rank_device(args.device)
    dist.init_process_group(device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    ok = True
    out = dict(world=world)
    tp_seq = 2048 if args.size == "8b" else args.sp_seq
    try:
        parts = args.parts.split(",")
        if "tp" in parts:
            cfg = _config(args, None)
            ref = run(args, device, dist, "fsdp4", dict(dp=1, fsdp=world),
                      None, cfg, args.tp_batch, tp_seq)
            tp = run(args, device, dist, "fsdp2_tp2",
                     dict(dp=1, fsdp=world // 2, tp=2), None, cfg,
                     args.tp_batch, tp_seq)
            ok = _agree(tp, ref, TP_LOSS_RTOL) and ok
            out["tp"] = [ref, tp]
        if "sp" in parts:
            cfg = _config(args, args.sp_layers)
            ref = run(args, device, dist, "fsdp4_sp1",
                      dict(dp=1, fsdp=world), None, cfg, args.sp_batch,
                      args.sp_seq)
            runs = [ref]
            for mode in ("ring", "ulysses"):
                r = run(args, device, dist, f"sp4_{mode}",
                        dict(dp=1, sp=world), mode, cfg, args.sp_batch,
                        args.sp_seq)
                ok = _agree(r, ref, SP_LOSS_RTOL) and ok
                runs.append(r)
            with _ring_unmasked():
                control = run(args, device, dist, "sp4_ring_unmasked",
                              dict(dp=1, sp=world), "ring", cfg,
                              args.sp_batch, args.sp_seq, timed=False)
            if _agree(control, ref, SP_LOSS_RTOL):
                ok = False
                if rank == 0:
                    print("port_tp_sp_scale: the unmasked ring control "
                          f"reads within {SP_LOSS_RTOL}: the limit cannot "
                          "see a wrong mask", file=sys.stderr)
            runs.append(control)
            out["sp"] = runs
        out["ok"] = ok
        if rank == 0:
            print(json.dumps({"port_tp_sp_scale": out}))
            if device.type == "cuda":
                print(device_info())
        if not ok:
            print(f"port_tp_sp_scale: rank {rank}: losses disagree",
                  file=sys.stderr)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
