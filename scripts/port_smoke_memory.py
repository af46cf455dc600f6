#!/usr/bin/env python3
"""Device memory that each phase of a checkout's ``chip_smoke.py`` leaves
allocated, up to and including its GPT-2 train phase, on one card:

    python scripts/port_smoke_memory.py CHECKOUT

Runs the checkout's ``chip_smoke.main()`` (its own package, built from
its own sources) and prints ``memory_allocated`` before and after each
phase; at every ``reset_peak_memory_stats`` the allocation it resets
from; at the train phase's reset the live CUDA tensors the garbage
collector tracks, by shape; and the train phase's peak. After each
phase also the ``torch.distributed`` objects still alive (process
groups, backends, work handles, device meshes), and the allocation again
after ``synchronize()`` and a 2 s wait, then after ``gc.collect()`` and
``empty_cache()``: what the first frees was held until collectives
retired, what the second frees sat in reference cycles, and what stays
is held elsewhere. Stops after the train phase. Run two checkouts in one
call to compare them on the same card.
"""

from __future__ import annotations

import argparse
import collections
import gc
import os
import sys
import time

PHASES = ("kernel_phase", "flash_phase", "serve_phase", "resnet_phase",
          "zero1_phase", "train_phase")
GIB = 2 ** 30


def _inventory(torch, top=12):
    """Unique storages of the CUDA tensors the collector tracks."""
    size, count, seen = collections.Counter(), collections.Counter(), set()
    for obj in gc.get_objects():
        try:
            if not (torch.is_tensor(obj) and obj.is_cuda):
                continue
            storage = obj.untyped_storage()
        except Exception:   # objects that refuse the question
            continue
        if storage.data_ptr() in seen:
            continue
        seen.add(storage.data_ptr())
        key = (tuple(obj.shape), str(obj.dtype).replace("torch.", ""),
               type(obj).__name__)
        size[key] += storage.nbytes()
        count[key] += 1
    print(f"  live tensors: {sum(size.values()) / GIB:.3f} GiB in "
          f"{sum(count.values())}", flush=True)
    for key, nbytes in size.most_common(top):
        print(f"    {nbytes / GIB:8.3f} GiB x{count[key]:<4d} {key}",
              flush=True)


def _c10d_alive():
    """Counts of live ``torch.distributed`` objects by type."""
    alive = collections.Counter()
    for obj in gc.get_objects():
        mod = getattr(type(obj), "__module__", None)
        if isinstance(mod, str) and mod.startswith(
                ("torch.distributed", "torch._C._distributed")):
            alive[type(obj).__name__] += 1
    keep = ("ProcessGroup", "Backend", "Work", "DeviceMesh", "Store")
    return {k: n for k, n in sorted(alive.items())
            if any(w in k for w in keep)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkout")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.checkout)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("port_smoke_memory: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    t0 = time.perf_counter()
    reset_peak = torch.cuda.reset_peak_memory_stats

    def reset(device=None):
        who = sys._getframe(1).f_code.co_name
        print(f"[{time.perf_counter() - t0:.0f} s] reset in {who}: "
              f"allocated {torch.cuda.memory_allocated() / GIB:.3f} GiB",
              flush=True)
        if who == "train_phase":
            _inventory(torch)
        reset_peak(device)

    torch.cuda.reset_peak_memory_stats = reset

    def wrap(name):
        phase = getattr(chip_smoke, name)

        def run(*a, **kw):
            print(f"[{time.perf_counter() - t0:.0f} s] before {name}: "
                  f"allocated {torch.cuda.memory_allocated() / GIB:.3f} GiB",
                  flush=True)
            out = phase(*a, **kw)
            print(f"[{time.perf_counter() - t0:.0f} s] after {name}: "
                  f"allocated {torch.cuda.memory_allocated() / GIB:.3f} GiB; "
                  f"alive {_c10d_alive()}", flush=True)
            if name != "train_phase":
                torch.cuda.synchronize()
                time.sleep(2)
                waited = torch.cuda.memory_allocated() / GIB
                gc.collect()
                torch.cuda.empty_cache()
                print(f"  after a 2 s wait {waited:.3f} GiB, after "
                      f"collecting {torch.cuda.memory_allocated() / GIB:.3f}"
                      " GiB", flush=True)
            if name == "train_phase":
                print(f"train phase peak {out[1]['peak_mem_gib']:.4f} GiB",
                      flush=True)
                os._exit(0)   # the smoke's later phases are not asked for
            return out

        setattr(chip_smoke, name, run)

    for name in PHASES:
        wrap(name)
    return chip_smoke.main([])


if __name__ == "__main__":
    sys.exit(main())
