#!/usr/bin/env python3
"""Tensor parallelism for GPT-2 and for inference across the cards of
one host, one process per card, under torchrun:

    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/port_tp_scale.py

(a) The port's GPT-2 recipe (``recipes/gpt2.py``'s ``main``) at
``scripts/port_pp_scale.py``'s yardstick: GPT-2-medium,
``Policy.train()``, clip(1.0) then adamw(3e-4), global batch ``--batch``
x ``--seq`` in ``--accum`` microbatches, dropout off in the config, the
same seeded weights and batches:

* ``zero1``: ``--strategy zero1`` over the four cards (dp 4), the
  yardstick;
* ``dp2_tp2_zero1`` and ``dp2_tp2_dp``: ``--dp 2 --tp 2`` under
  ``zero1`` (the moments of each TP shard split over dp) and ``dp``;
* ``tp4``: ``--tp 4`` (zero1 at dp 1);
* ``pp2_tp2``: ``--pp 2 --tp 2``, the GPipe form with TP-sharded stages.

For each: the median of the Trainer's logged step times after the first
(``--steps`` timed steps), tokens/s per card, every rank's peak memory,
the four kernels' launches over the run (its eval included),
the first 3 losses (the first within ``FIRST_LOSS_RTOL`` and all three
within ``LOSS_RTOL`` of the yardstick's), then ``torch.profiler`` over
two more steps on rank 0: the ms a step in which an NCCL kernel ran (the
union of their intervals) beside the window and the compute kernels'.
``--runs`` picks (a)'s runs beside the yardstick.

(b) Llama-3-8B at full width and all 32 layers (bf16, seeded) through
``ServeEngine`` with phase 4's 8 requests of ``chip_smoke.py`` (8 slots,
2048 positions, 64-1024-token prompts, 32-64 new tokens, 2 sampled, a
shared 256-token prefix): first at tp 1 on rank 0's card alone (the
other ranks wait), then sharded over the four cards at tp 4 (8 of the 32
query heads and 2 of the 8 kv heads a rank; each rank's page pool holds
its 2 kv heads). For each: every greedy token within the teacher-forced
margin of the model's own einsum forward, the streams against tp 1's
(where one parts, the gap between the two tokens in a teacher-forced
forward of the shared prefix on the tp 4 model, within the margin),
the decode-tick ms (the ``serve.decode_tick`` + ``serve.token_fetch``
spans), TTFT p50/p99, the paged kernel's launches (= ticks x 32 on every
rank), the pool's shape (its kv heads tp 1's over 4) and every rank's
peak memory.

Rank 0 prints each result, a JSON line, and ``nvidia-smi``'s name and
power limit, and exits non-zero when a check fails. ``--device cpu
--size tiny --llama tiny --batch 16 --seq 16 --steps 2`` rehearses it on
gloo (the profile and the peaks are the card's only).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (a) against the dp 4 yardstick: the same f32 weights and batches, bf16
# products over each rank's half (or quarter) of the heads and hidden
# units, summed by an all-reduce: the first loss moves by the products'
# rounding, and AdamW then turns rounding noise in near-zero gradients
# into +-lr moves
FIRST_LOSS_RTOL = 2e-3
LOSS_RTOL = 5e-3
GREEDY_MARGIN = 0.25   # chip_smoke.py's (phase 4)
# (a)'s runs on four cards: the recipe's flags beside --strategy zero1
RUNS = {
    "dp2_tp2_zero1": ["--dp", "2", "--tp", "2"],
    "dp2_tp2_dp": ["--dp", "2", "--tp", "2", "--strategy", "dp"],
    "tp4": ["--tp", "4"],
    "pp2_tp2": ["--pp", "2", "--tp", "2"],
}


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _peaks(device):
    """Every rank's peak allocated GiB since its last reset."""
    import torch

    from pytorch_distributed_tpu_torch.runtime import distributed as dist

    if device.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    return dist.all_gather(torch.tensor([peak], device=device))[:, 0].tolist()


def _size(args):
    """The recipe's ``--size`` config with dropout off, registered as
    ``<size>-nodrop``."""
    from pytorch_distributed_tpu_torch.recipes import gpt2 as gpt2_recipe

    name = f"{args.size}-nodrop"
    base = gpt2_recipe.SIZES[args.size]
    gpt2_recipe.SIZES[name] = lambda: dataclasses.replace(base(),
                                                          dropout_rate=0.0)
    return name


def _nccl_profile(trainer, device):
    """torch.profiler over two more steps of ``trainer``'s step on its
    next batch: the window's wall ms a step, and the ms a step in which
    any kernel, a compute kernel and an NCCL kernel ran (the unions of
    their intervals)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = next(iter(trainer.train_loader))
    state, step = trainer.state, trainer.train_step
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

    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    return dict(window_ms_per_step=wall, busy_ms=union_ms(kernels),
                nccl_ms=union_ms(nccl),
                compute_busy_ms=union_ms([e for e in kernels
                                          if e not in nccl]))


def recipe_run(args, device, name, extra):
    """One run of the recipe's ``main`` on the current process group."""
    import torch

    from pytorch_distributed_tpu_torch.recipes import gpt2 as gpt2_recipe
    from pytorch_distributed_tpu_torch.runtime import distributed as dist

    on_card = device.type == "cuda"
    _free(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    argv = ["--size", _size(args), "--batch-size", str(args.batch),
            "--seq-len", str(args.seq), "--accum-steps", str(args.accum),
            "--steps-per-epoch", str(args.steps + 1), "--log-every", "1",
            "--seed", str(args.seed)] + extra
    if not on_card:
        argv += ["--device", "cpu", "--backend", "gloo"]
    import chip_smoke as cs

    if on_card:
        cs.kernel_counts(reset=True)
    t0 = time.perf_counter()
    trainer = gpt2_recipe.main(argv)
    counts = cs.kernel_counts() if on_card else None
    hist = trainer.history
    steady = sorted(r["step_time_s"] for r in hist[1:])
    step_s = steady[len(steady) // 2]
    world = dist.get_world_size()
    out = dict(name=name, argv=extra, world=world,
               losses=[r["loss"] for r in hist], step_ms=1e3 * step_s,
               wall_s=time.perf_counter() - t0, launches=counts,
               peak_mem_gib_by_rank=_peaks(device))
    tokens = args.batch * args.seq / step_s / world
    out["tokens_per_s_per_card" if on_card
        else "tokens_per_s_per_rank_on_cpu"] = tokens
    if on_card:
        # every rank steps: the collectives need them all
        prof = _nccl_profile(trainer, device)
        if dist.get_rank() == 0:
            out["profile_rank0"] = prof
    if dist.get_rank() == 0:
        print(f"{name}: {json.dumps(out)}", flush=True)
    del trainer
    _free(device)
    return out


def _rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


# -- (b) Llama-3-8B through the engine ----------------------------------------


def _llama(args, device, spec):
    """Llama-3-8B (or ``--llama tiny``) in the serving policy, seeded;
    sharded on ``spec`` when given (``llama_partition_rules``)."""
    import torch

    from pytorch_distributed_tpu_torch import (
        LlamaConfig,
        LlamaForCausalLM,
        MeshSpec,
    )
    from pytorch_distributed_tpu_torch.models.llama import (
        llama_partition_rules,
    )
    from pytorch_distributed_tpu_torch.parallel import DataParallel

    cfg = (LlamaConfig.llama3_8b() if args.llama == "8b"
           else LlamaConfig.tiny())
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if spec is None:
        model = LlamaForCausalLM(cfg, device=device)
    else:
        strategy = DataParallel(device, mesh_spec=MeshSpec(**spec),
                                extra_rules=llama_partition_rules())
        model = strategy.wrap(LlamaForCausalLM(cfg, device="meta"))
        model.to_empty(device=device)
    model.init_weights(gen)
    return model.requires_grad_(False)


def _requests(args, vocab):
    """Phase 4's 8 requests (``chip_smoke._requests``); for the tiny
    rehearsal, 8 requests of 8-40 prompt and 4-8 new tokens alike."""
    import numpy as np

    import chip_smoke as cs
    from pytorch_distributed_tpu_torch.serve import Request

    if args.llama == "8b":
        return cs._requests(args.seed, vocab)
    rng = np.random.default_rng(args.seed)
    return [Request(rng.integers(1, vocab, size=int(rng.integers(8, 41))),
                    int(rng.integers(4, 9)),
                    temperature=0.8 if i >= 6 else 0.0,
                    top_p=0.95 if i >= 6 else None, seed=100 + i,
                    request_id=f"r{i}") for i in range(8)]


def serve_run(args, device, spec, name):
    """The 8 requests through a ``ServeEngine`` on the model of
    ``spec``: its streams, timings, launches, teacher-forced gaps."""
    import torch

    import chip_smoke as cs
    from pytorch_distributed_tpu_torch import RequestStatus, ServeEngine
    from pytorch_distributed_tpu_torch.runtime import tracing
    from pytorch_distributed_tpu_torch.serve import EngineConfig

    on_card = device.type == "cuda"
    _free(device)
    t0 = time.perf_counter()
    model = _llama(args, device, spec)
    init_s = time.perf_counter() - t0
    cfg = model.config
    ecfg = (EngineConfig(num_slots=8, max_len=2048, prefill_chunk=256)
            if args.llama == "8b" else
            EngineConfig(num_slots=4, max_len=64, prefill_chunk=16,
                         page_size=8))
    reqs = _requests(args, cfg.vocab_size)
    with torch.no_grad():
        warm = ServeEngine(model, ecfg, device=device)   # cuBLAS, allocator
        warm.submit(dataclasses.replace(reqs[0], max_new_tokens=2,
                                        request_id="warm"))
        warm.run_until_drained()
        del warm
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        counts = cs.kernel_counts(reset=True) if on_card else None
        engine = ServeEngine(model, ecfg, device=device)
        with tracing.enabled() as tracer:
            t0 = time.perf_counter()
            handles = [engine.submit(r) for r in reqs[:7]]
            while handles[0].status is not RequestStatus.DECODING:
                engine.step()
            handles.append(engine.submit(reqs[7]))
            engine.run_until_drained()
            if on_card:
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        if on_card:
            counts = cs.kernel_counts()
        roll = tracer.rollups()
        tick = [roll[k] for k in ("serve.decode_tick", "serve.token_fetch")]
        summary = engine.telemetry.summary()
        exact, gaps = cs._teacher_gaps(model, reqs, handles, device)
    out = dict(
        name=name, spec=spec, init_s=init_s, wall_s=wall,
        streams=[list(h.tokens) for h in handles],
        completed=all(h.status is RequestStatus.COMPLETED for h in handles),
        decode_ticks=engine.decode_ticks,
        decode_tick_ms=sum(x["mean_ms"] for x in tick),
        decode_tick_ms_p50=sum(x["p50_ms"] for x in tick),
        ttft_ms_p50=summary["ttft_ms_p50"], ttft_ms_p99=summary["ttft_ms_p99"],
        tokens_per_s=summary["tokens_per_sec"],
        pool=list(engine.pool.cache[0][0].shape), launches=counts,
        greedy_exact=exact, greedy_tokens=len(gaps),
        greedy_worst_gap=max(gaps), num_layers=cfg.num_layers)
    out["peak_mem_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30
                           if on_card else None)
    return model, reqs, out


def _forks(model, reqs, got, want, device):
    """Where a tp 4 stream parts from tp 1's: the first position and the
    gap between the two tokens chosen there, in a teacher-forced forward
    of the shared prefix on ``model`` (every rank runs the same
    forwards)."""
    import torch

    out = []
    with torch.no_grad():
        for r, a, b in zip(reqs, got, want):
            if r.temperature > 0 or a == b:
                continue
            j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            if j == min(len(a), len(b)):
                out.append(dict(request=r.request_id, position=j,
                                gap=float("inf")))
                continue
            seq = torch.tensor(list(r.prompt_ids) + b[:j],
                               device=device)[None].long()
            logits = model(seq, attn_impl="xla")[0, -1].float()
            out.append(dict(request=r.request_id, position=j,
                            gap=abs(float(logits[a[j]] - logits[b[j]]))))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="this rank's card (LOCAL_RANK) unless given")
    ap.add_argument("--size", choices=("tiny", "small", "medium"),
                    default="medium")
    ap.add_argument("--llama", choices=("tiny", "8b"), default="8b")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--accum", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="train,serve",
                    help="comma list of train (a) and serve (b)")
    ap.add_argument("--runs", default=",".join(RUNS),
                    help="(a)'s runs beside the zero1 yardstick")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))

    from pytorch_distributed_tpu_torch.runtime import distributed as dist
    from pytorch_distributed_tpu_torch.runtime.device import device_info

    device = dist.rank_device(args.device)
    dist.init_process_group(device=device, timeout_s=1800.0)
    world, rank = dist.get_world_size(), dist.get_rank()
    ok = True
    out = dict(world=world)
    try:
        if "train" in parts:
            ref = recipe_run(args, device, "zero1", ["--strategy", "zero1"])
            out["zero1"] = ref
            for name in args.runs.split(","):
                r = recipe_run(args, device, name, RUNS[name])
                r["first_loss_rel_err_vs_zero1"] = _rel(r["losses"][:1],
                                                        ref["losses"][:1])
                r["loss_rel_err_vs_zero1"] = _rel(r["losses"][:3],
                                                  ref["losses"][:3])
                ok = ok and all(map(math.isfinite, r["losses"])) and (
                    r["first_loss_rel_err_vs_zero1"] <= FIRST_LOSS_RTOL
                    and r["loss_rel_err_vs_zero1"] <= LOSS_RTOL)
                out[name] = r
        if "serve" in parts:
            solo = None
            if rank == 0:
                model, reqs, solo = serve_run(args, device, None, "tp1")
                del model
                brief = {k: v for k, v in solo.items() if k != "streams"}
                print(f"tp1: {json.dumps(brief)}", flush=True)
            dist.barrier()
            solo = dist.broadcast_object_list([solo], src=0)[0]
            model, reqs, got = serve_run(
                args, device, dict(dp=1, tp=world), f"tp{world}")
            got["forks_vs_tp1"] = _forks(model, reqs, got["streams"],
                                         solo["streams"], device)
            del model
            ranks = dist.all_gather_object(got)
            L = got["num_layers"]
            same = all(r["streams"] == ranks[0]["streams"] for r in ranks)
            worst_fork = max((f["gap"] for f in got["forks_vs_tp1"]),
                             default=0.0)
            launches_ok = (device.type != "cuda" or all(
                r["launches"]["paged_attention"] == r["decode_ticks"] * L
                for r in ranks))
            checks = dict(
                ranks_streams_equal=same, worst_fork_gap=worst_fork,
                streams_equal_to_tp1=sum(
                    a == b for a, b in zip(got["streams"], solo["streams"])),
                launches_ok=launches_ok,
                pool_heads=got["pool"][2], tp1_pool_heads=solo["pool"][2])
            ok = ok and same and launches_ok and all(
                r["completed"] and r["greedy_worst_gap"] <= GREEDY_MARGIN
                for r in ranks + [solo]) and worst_fork <= GREEDY_MARGIN \
                and got["pool"][2] == max(solo["pool"][2] // world, 1)
            out["serve"] = dict(
                tp1={k: v for k, v in solo.items() if k != "streams"},
                tp=[{k: v for k, v in r.items() if k != "streams"}
                    for r in ranks], checks=checks)
            if rank == 0:
                print(f"tp{world}: {json.dumps(out['serve'])}", flush=True)
        out["ok"] = ok
        if rank == 0:
            print(json.dumps({"port_tp_scale": out}))
            if device.type == "cuda":
                print(device_info())
        if not ok:
            print(f"port_tp_scale: rank {rank}: a check failed",
                  file=sys.stderr)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
