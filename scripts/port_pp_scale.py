#!/usr/bin/env python3
"""GPT-2-medium under pipeline parallelism across the cards of one host,
one process per card, under torchrun:

    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/port_pp_scale.py

(a)-(c) run the port's GPT-2 recipe (``recipes/gpt2.py``'s ``main``) at
its defaults (GPT-2-medium, ``Policy.train()``, clip(1.0) then
adamw(3e-4), global batch ``--batch`` x ``--seq``, accum 4), from the
same seeded weights and batches, with dropout off in the config (the
pipeline runs its blocks without dropout, so the data-parallel yardstick
must too):

* (a) ``--pp 4``: 6 layers a card, ``max(4, 2 x 4) = 8`` microbatches;
* (b) ``--dp 2 --pp 2``: 12 layers a card, 4 microbatches a data pair;
* (c) ``--strategy dp``: DDP over the four cards, the yardstick.

For each: ``--steps`` timed steps after one warm-up (the median of the
Trainer's logged step times), tokens/s per card, each rank's peak memory
over the run, and the first 3 losses; (a) and (b)'s first loss within
``FIRST_LOSS_RTOL`` and their 3 losses within ``LOSS_RTOL`` of (c)'s.

(d) the host 1F1B executor (``parallel/pipeline_schedule.py``) at ``pp``
4, in 1F1B and in GPipe order: GPT-2-medium's 24 layers in 4 stages of 6
over a gloo stage link, the global batch in 8 microbatches, AdamW(3e-4)
(the executor takes elementwise optimizers only), ``--steps`` traced
steps after 2 of warm-up. Per rank and order: ms a step, the peak
memory, the measured bubble from ``pipeline_trace_stats`` over each
step's ``pipeline.fwd``/``pipeline.bwd`` spans (the mean over the
steps) beside ``bubble_fraction(4, 8)``, the exposed link share, and
``peak_live_microbatches`` of the order's schedule; the two orders'
final parameters must be equal to the bit (the backwards fold in
microbatch order in both).

Rank 0 prints each result, a JSON line, and ``nvidia-smi``'s name and
power limit of the cards, and exits non-zero when a check fails.
``--device cpu --size tiny --layers 4 --batch 16 --seq 16 --steps 2``
rehearses it on gloo.
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

# (a), (b) against (c): the same f32 weights and batches, bf16 products
# over other microbatch shapes (8 x 4 rows against 4 x 2 a card), so the
# first loss may differ by the products' rounding; AdamW then moves
# weights by ~lr whatever their gradients' size, which turns rounding
# noise into different updates. Read on NVIDIA H100 80GB HBM3 at 700 W:
# first losses 0 and 8.4e-8 apart, the first three within 2.2e-5
FIRST_LOSS_RTOL = 1e-4
LOSS_RTOL = 5e-4
MICRO = 8          # (d): the microbatches of (a)


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _config(args, dropout=True):
    """The recipe's ``--size`` config (``--layers`` of it, when given)."""
    from pytorch_distributed_tpu_torch.recipes import gpt2 as gpt2_recipe

    cfg = gpt2_recipe.SIZES[args.size]()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg if dropout else dataclasses.replace(cfg, dropout_rate=0.0)


def _size(args):
    """:func:`_config` with dropout off, registered as the recipe's size
    ``<size>-nodrop``."""
    from pytorch_distributed_tpu_torch.recipes import gpt2 as gpt2_recipe

    name = f"{args.size}-nodrop"
    gpt2_recipe.SIZES[name] = lambda: _config(args, dropout=False)
    return name


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
            "--seq-len", str(args.seq), "--steps-per-epoch",
            str(args.steps + 1), "--log-every", "1", "--seed",
            str(args.seed)] + extra
    if not on_card:
        argv += ["--device", "cpu", "--backend", "gloo"]
    t0 = time.perf_counter()
    trainer = gpt2_recipe.main(argv)
    hist = trainer.history
    steady = sorted(r["step_time_s"] for r in hist[1:])
    step_s = steady[len(steady) // 2]
    world = dist.get_world_size()
    out = dict(name=name, argv=extra, world=world,
               losses=[r["loss"] for r in hist],
               eval=trainer.last_eval_metrics,
               step_ms=1e3 * step_s, wall_s=time.perf_counter() - t0)
    tokens = args.batch * args.seq / step_s / world
    out["tokens_per_s_per_card" if on_card
        else "tokens_per_s_per_rank_on_cpu"] = tokens
    layout = getattr(trainer.state.model, "pipeline_stage", None)
    if layout is not None:
        out["layers_per_rank"] = layout.stop - layout.start
    if on_card:
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        out["peak_mem_gib_by_rank"] = dist.all_gather(torch.tensor(
            [peak], device=device))[:, 0].tolist()
    if dist.get_rank() == 0:
        print(f"{name}: {json.dumps(out)}", flush=True)
    del trainer
    _free(device)
    return out


def _rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def host_run(args, device, schedule, link):
    """(d): this rank's stage of the host executor in ``schedule`` order."""
    import zlib

    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch import (
        GPT2LMHead,
        HostPipelineStep,
        Policy,
        optim,
    )
    from pytorch_distributed_tpu_torch.parallel import pipeline_schedule as ps
    from pytorch_distributed_tpu_torch.parallel.pipeline_lm import (
        GPT2HostStagePrograms,
        host_act_template,
        host_stage_params,
    )
    from pytorch_distributed_tpu_torch.runtime import distributed as dist
    from pytorch_distributed_tpu_torch.runtime import tracing

    on_card = device.type == "cuda"
    stage, S = link.stage, link.size
    _free(device)
    policy = Policy.train()
    model = GPT2LMHead(_config(args), device=device, policy=policy)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))
    module, buffers = host_stage_params(model, stage=stage, num_stages=S)
    del model
    _free(device)
    host = HostPipelineStep(
        GPT2HostStagePrograms(module, stage=stage, num_stages=S),
        stage=stage, num_stages=S, num_microbatches=MICRO,
        optimizer=optim.AdamW(module, lr=3e-4, weight_decay=1e-4),
        group=link, schedule=schedule,
        act_template=host_act_template(module.config, args.batch // MICRO,
                                       args.seq, policy.compute_dtype))
    rng = np.random.default_rng(args.seed + 1)
    batch = {"input_ids": rng.integers(
        0, module.config.vocab_size, (args.batch, args.seq))}
    losses = []
    for _ in range(2):   # warm-up
        losses.append(host.step(batch, buffers).get("loss"))
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    traces, times = [], []
    for _ in range(args.steps):
        tracer = tracing.configure()
        tracing.set_meta(rank=stage)
        dist.barrier()
        t0 = time.perf_counter()
        losses.append(host.step(batch, buffers).get("loss"))
        times.append(time.perf_counter() - t0)
        tracing.clear()
        path = os.path.join(args.trace_dir, f"{schedule}-s{stage}.json")
        tracer.export(path)
        with open(path) as f:
            traces.append(json.load(f))
    crc = 0
    for name, t in sorted(module.state_dict().items()):
        crc = zlib.crc32(t.detach().float().cpu().numpy().tobytes(), crc)
    stats = [ps.pipeline_trace_stats([doc])[stage] for doc in traces]
    out = dict(
        stage=stage, schedule=schedule,
        step_ms=1e3 * sorted(times)[len(times) // 2],
        bubble=sum(s["bubble"] for s in stats) / len(stats),
        link_share=sum(s["link_s"] / s["window_s"] for s in stats)
        / len(stats),
        busy_s=sum(s["busy_s"] for s in stats) / len(stats),
        peak_live_microbatches=ps.peak_live_microbatches(host.program),
        losses=[x for x in losses if x is not None], crc=crc)
    if on_card:
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    del host, module, buffers
    _free(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="this rank's card (LOCAL_RANK) unless given")
    ap.add_argument("--size", choices=("tiny", "small", "medium"),
                    default="medium")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the size's depth (its own unless given)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default="chiprun_out/port_pp_scale")
    args = ap.parse_args(argv)

    from pytorch_distributed_tpu_torch import StageLink
    from pytorch_distributed_tpu_torch.parallel.pipeline_schedule import (
        bubble_fraction,
    )
    from pytorch_distributed_tpu_torch.runtime import distributed as dist
    from pytorch_distributed_tpu_torch.runtime.device import device_info

    device = dist.rank_device(args.device)
    dist.init_process_group(device=device, timeout_s=1800.0)
    world, rank = dist.get_world_size(), dist.get_rank()
    os.makedirs(args.trace_dir, exist_ok=True)
    ok = True
    out = dict(world=world)
    try:
        ref = recipe_run(args, device, "dp", ["--strategy", "dp"])
        out["dp"] = ref
        for name, extra in (("pp4", ["--pp", str(world)]),
                            ("dp2_pp2", ["--dp", "2", "--pp",
                                         str(world // 2)])):
            r = recipe_run(args, device, name, extra)
            r["first_loss_rel_err_vs_dp"] = _rel(r["losses"][:1],
                                                 ref["losses"][:1])
            r["loss_rel_err_vs_dp"] = _rel(r["losses"][:3],
                                           ref["losses"][:3])
            ok = ok and all(map(math.isfinite, r["losses"])) and (
                r["first_loss_rel_err_vs_dp"] <= FIRST_LOSS_RTOL
                and r["loss_rel_err_vs_dp"] <= LOSS_RTOL)
            out[name] = r
        import torch.distributed as tdist

        link = StageLink(tdist.new_group(backend="gloo"))
        out["bubble_fraction_analytic"] = bubble_fraction(world, MICRO)
        for schedule in ("1f1b", "gpipe"):
            mine = host_run(args, device, schedule, link)
            out[f"host_{schedule}"] = dist.all_gather_object(mine)
            if rank == 0:
                print(f"host {schedule}: {json.dumps(out[f'host_{schedule}'])}",
                      flush=True)
        same = [a["crc"] == b["crc"] for a, b in zip(out["host_1f1b"],
                                                     out["host_gpipe"])]
        out["host_orders_bitwise_equal"] = all(same)
        ok = ok and all(same)
        out["ok"] = ok
        if rank == 0:
            print(json.dumps({"port_pp_scale": out}))
            if device.type == "cuda":
                print(device_info())
        if not ok:
            print(f"port_pp_scale: rank {rank}: a check failed",
                  file=sys.stderr)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
