#!/usr/bin/env python3
"""Where the PyTorch port's decode tick spends its time, on one CUDA card.

    python3 scripts/port_serve_profile.py [--ticks 8] [--mode paged|dense]

Builds Llama-3-8B at full width and depth with seeded random bf16
weights, admits chip_smoke.py's 8 requests (64 new tokens each), runs until
every request decodes, then profiles ``--ticks`` decode ticks with ``torch.profiler``
(CPU + CUDA activities). Prints the tick's wall time, the summed device
time of the kernels it ran (so the device's idle share), and the top
kernels by device time, then each paged-attention kernel's time per tick.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--mode", choices=("paged", "dense"), default="paged")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import _requests
    from pytorch_distributed_tpu_torch import (
        EngineConfig,
        LlamaConfig,
        LlamaForCausalLM,
        RequestStatus,
        ServeEngine,
        device_info,
    )

    device = torch.device("cuda", 0)
    cfg = LlamaConfig.llama3_8b()
    model = LlamaForCausalLM(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))
    model.requires_grad_(False)
    engine = ServeEngine(model, EngineConfig(
        num_slots=8, max_len=2048, prefill_chunk=256, decode_mode=args.mode,
    ))
    # 64 new tokens each, so no request retires inside the window
    handles = [
        engine.submit(dataclasses.replace(r, max_new_tokens=64))
        for r in _requests(args.seed, cfg.vocab_size)
    ]
    waiting = (RequestStatus.QUEUED, RequestStatus.PREFILLING)
    while any(h.status in waiting for h in handles):
        engine.step()
    for _ in range(3):           # warm: every slot decoding, no prefill
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(
        e.self_device_time_total for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    tick_ms = wall / args.ticks * 1e3
    busy_ms = device_us / args.ticks / 1e3
    print(device_info())
    print(f"mode {args.mode}: {args.ticks} ticks, {tick_ms:.3f} ms/tick wall "
          f"(profiler on), device busy {busy_ms:.3f} ms/tick, idle share "
          f"{1 - busy_ms / tick_ms:.3f}")
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    for e in events:   # the paged-attention kernels, wherever they rank
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "paged_" in e.key):
            print(f"{e.key}: {e.self_device_time_total / args.ticks / 1e3:.3f}"
                  f" ms/tick, {e.count / args.ticks:g} calls/tick, "
                  f"{e.self_device_time_total / e.count:.3f} us each")
    return 0


if __name__ == "__main__":
    sys.exit(main())
