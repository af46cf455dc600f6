#!/usr/bin/env python3
"""Time the port's paged-decode kernel at Llama-3-8B's decode tick, on one
CUDA card.

    python3 scripts/port_paged_bench.py [--root DIR] [--seed N] [--iters N]

The inputs are ``chip_smoke.py``'s main paged case (bf16, 8 rows of seeded
lengths up to 2000, 32 query / 8 kv heads, head_dim 128, 32-token pages,
a 64-page table), drawn with this checkout's ``chip_smoke.py``. The kernel
comes from the ``pytorch_distributed_tpu_torch`` package under ``--root``
(default: this checkout), so two checkouts, e.g. a parent commit unpacked
beside this one, can be timed on one card in turns. Prints the kernel's
time replayed from a CUDA graph and eager, SDPA's on the same K/V gathered
dense (replayed), the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("port_paged_bench: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_inputs", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from pytorch_distributed_tpu_torch.ops.paged_attention import (
        gather_dense,
        paged_attention,
    )
    from pytorch_distributed_tpu_torch.runtime.device import device_info

    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(args.seed)
    q, kp, vp, tables, lengths = smoke._paged_case(
        gen, B=8, W=1, Hq=32, Hkv=8, D=128, ps=32, n=64, max_len=2000,
        dtype=torch.bfloat16, device=device,
    )
    kw = dict(page_tables=tables, lengths=lengths)
    out = paged_attention(q, kp, vp, **kw)
    ref = paged_attention(q, kp, vp, impl="gather", **kw)
    err = (out.float() - ref.float()).abs().max().item()
    graph_ms = smoke._graph_ms(lambda: paged_attention(q, kp, vp, **kw),
                               args.iters)
    eager_ms = smoke._time_ms(lambda: paged_attention(q, kp, vp, **kw),
                              args.iters)
    kp0, vp0 = kp.clone(), vp.clone()
    kp0[0], vp0[0] = 0, 0
    kd = gather_dense(kp0, tables).transpose(1, 2)
    vd = gather_dense(vp0, tables).transpose(1, 2)
    qd = q.transpose(1, 2)
    kpos = torch.arange(tables.shape[1] * kp.shape[1], device=device)
    mask = (kpos[None, :] <= lengths[:, None].long())[:, None, None, :]
    sdpa_ms = smoke._graph_ms(
        lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                               enable_gqa=True),
        args.iters)
    card = device_info()
    print(f"root {root}: paged kernel {graph_ms:.4f} ms (graph replay), "
          f"{eager_ms:.4f} ms eager; sdpa {sdpa_ms:.4f} ms; max|err| vs "
          f"gather {err:.3e}")
    print(card)
    print(json.dumps(dict(root=root, graph_ms=graph_ms, eager_ms=eager_ms,
                          sdpa_ms=sdpa_ms, max_abs_err_vs_gather=err)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
