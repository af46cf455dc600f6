#!/usr/bin/env python
"""Offered-load generator for the PyTorch port's serving engine: the
port's counterpart of ``scripts/serve_loadgen.py``, with its flags.

Drives ``pytorch_distributed_tpu_torch.serve.ServeEngine`` with a seeded
stream of requests at a fixed arrival rate (uniform or Poisson), streams
the telemetry records as JSONL (``--log``), and prints the run summary::

    python scripts/port_serve_loadgen.py --model gpt2-small --requests 32 \\
        --rate 0 --slots 8 --prompt-len 64 --new-tokens 64

    # a fleet behind the deterministic router: N solo engines, or
    # prefill/decode tiers with KV migration and a shared prefix store
    python scripts/port_serve_loadgen.py --engines 4 --router --disagg \\
        --store --prefix-share 0.8 --prefix-len 16 --page-size 8

``--device`` defaults to the CUDA card (bf16 weights, the serving
policy); ``--device cpu`` runs the plain PyTorch path in f32 at a small
model. Nothing falls back to the CPU. Weights are drawn from ``--seed``:
the numbers measure the ENGINE, not a checkpoint.
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def build_model(name: str, device, policy, seed: int):
    """A named model with seeded random weights, frozen."""
    from pytorch_distributed_tpu_torch import (
        GPT2Config, GPT2LMHead, LlamaConfig, LlamaForCausalLM,
    )

    if name in ("gpt2-tiny", "gpt2-small"):
        cfg = GPT2Config.tiny() if name == "gpt2-tiny" else GPT2Config.small()
        model = GPT2LMHead(dataclasses.replace(cfg, dropout_rate=0.0),
                           device=device, policy=policy)
    elif name == "llama-tiny":
        model = LlamaForCausalLM(LlamaConfig.tiny(), device=device,
                                 policy=policy)
    elif name == "qwen2-tiny":
        raise NotImplementedError(
            "qwen2 is not ported yet: the Llama-family fields it needs are "
            "ROADMAP A7")
    else:
        raise SystemExit(f"unknown --model {name!r}")
    return draw(model, seed)


def draw(model, seed: int):
    import torch

    model.init_weights(torch.Generator(device=model.device).manual_seed(seed))
    return model.requires_grad_(False)


def draft_of(model, seed: int):
    """A 1-layer sibling at half the width, randomly initialized: it
    measures the engine's mechanics; a trained draft accepts more."""
    cfg = model.config
    dcfg = dataclasses.replace(cfg, num_layers=1,
                               hidden_size=max(cfg.hidden_size // 2, 16))
    return draw(type(model)(dcfg, device=model.device, policy=model.policy),
                seed)


def parse_range(s: str):
    lo, _, hi = s.partition(",")
    lo = int(lo)
    return (lo, int(hi) if hi else lo)


class JsonlWriter:
    """The telemetry writer protocol (``write(step, metrics, split)``)
    onto one JSON line per record."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "w")

    def write(self, step, metrics, split="train"):
        self._f.write(json.dumps(dict(metrics, step=step, split=split))
                      + "\n")

    def close(self):
        self._f.close()


def run_storm(args, model, max_len, reqs, arrivals, writer, spec, device):
    """--router fleet storm: N solo engines, or --disagg tiers with KV
    migration, behind the deterministic router."""
    import numpy as np

    from pytorch_distributed_tpu_torch.serve import (
        EngineConfig, InProcPrefixStore, Router, ServeEngine, drive,
    )

    store = InProcPrefixStore() if args.store else None

    def mk(role, eid):
        return ServeEngine(
            model,
            EngineConfig(num_slots=args.slots, max_len=max_len,
                         prefill_chunk=args.prefill_chunk,
                         page_size=args.page_size, num_pages=args.num_pages,
                         decode_mode=args.decode_mode, role=role,
                         engine_id=eid),
            device=device, spec=spec if role == "solo" else None,
            prefix_store=store if role != "decode" else None,
        )

    if args.disagg:
        n_pre = -(-args.engines // 2)
        prefill = [mk("prefill", f"p{i}") for i in range(n_pre)]
        decode = [mk("decode", f"d{i}")
                  for i in range(args.engines - n_pre)]
        for e in prefill + decode:
            e.telemetry.writer = writer
        router = Router(prefill=prefill, decode=decode, writer=writer,
                        store=store)
        shape = f"{n_pre} prefill + {args.engines - n_pre} decode"
    else:
        engines = [mk("solo", f"e{i}") for i in range(args.engines)]
        for e in engines:
            e.telemetry.writer = writer
        router = Router(engines=engines, writer=writer, store=store)
        shape = f"{args.engines} solo"
    router.warm_up(np.ones(1, np.int32))
    dt = drive(router, reqs, arrivals)
    if writer is not None:
        writer.close()
    s = router.summary()
    total = sum(e["completed_tokens"] for e in s["engines"].values())
    print(f"model={args.model} fleet=[{shape}] max_len={max_len} "
          f"requests={args.requests} rate={args.rate or 'closed-loop'} "
          f"wall={dt:.2f}s")
    print(f"  tokens/s (fleet)   = {total / max(dt, 1e-9):.2f} "
          f"({total} completed tokens)")
    for q in (50, 95, 99):
        v = s.get(f"ttft_ms_p{q}")
        if v is not None:
            print(f"  ttft_ms_p{q:<8} = {v:.2f}")
    if args.disagg:
        print(f"  migration          = {s['migration_frames']} frames, "
              f"{s['migration_bytes']:,d} wire B "
              f"({s['migration_payload_bytes']:,d} KV payload B)")
    if s["replays"] or s["lost_engines"]:
        print(f"  replays            = {s['replays']} "
              f"(lost engines: {s['lost_engines']})")
    if store is not None:
        st = store.stats()
        print(f"  prefix store       = {st['puts']} puts ({st['hits']} "
              f"hits, {st['dup_puts']} dup puts, {st['entries']} resident "
              f"pages)")
    for eid, es in s["engines"].items():
        print(f"  [{eid}] completed={es.get('completed', 0)} "
              f"tokens={es['completed_tokens']} "
              + (f"p99={es['ttft_ms_p99']:.1f}ms"
                 if "ttft_ms_p99" in es else ""))
    if args.log:
        print(f"telemetry JSONL -> {args.log}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="gpt2-tiny",
                    help="gpt2-tiny | gpt2-small | llama-tiny | qwen2-tiny")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="offered requests/sec (0 = submit all up front)")
    ap.add_argument("--poisson", action="store_true",
                    help="Poisson arrivals instead of uniform spacing")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-slot KV capacity (0 = fit the workload)")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--prompt-len", type=parse_range, default=(4, 16),
                    metavar="LO[,HI]")
    ap.add_argument("--new-tokens", type=parse_range, default=(8, 32),
                    metavar="LO[,HI]")
    ap.add_argument("--prefix-share", type=float, default=0.0,
                    help="fraction of requests opening with one common "
                    "system prompt")
    ap.add_argument("--prefix-len", type=int, default=16,
                    help="length of the shared system prompt")
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV page size (default: auto divisor of max_len)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="KV pool pages (default: parity with a fixed "
                    "[slots, max_len] pool)")
    ap.add_argument("--long-context", action="store_true",
                    help="preset: max_len 4x the workload fit (>= 256, "
                    "capped at the model's position table)")
    ap.add_argument("--decode-mode", choices=("paged", "dense"),
                    default="paged",
                    help="'dense' runs the full-width gather tick (the A/B "
                    "baseline) instead of the paged kernel")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding with k draft tokens a tick "
                    "(draft: a randomly initialized 1-layer sibling)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", default=None, help="telemetry JSONL path")
    ap.add_argument("--engines", type=int, default=1,
                    help="fleet size for --router storm mode")
    ap.add_argument("--router", action="store_true",
                    help="drive --engines N engines behind the router")
    ap.add_argument("--disagg", action="store_true",
                    help="split the fleet into prefill/decode tiers (half "
                    "each, prefill rounded up); implies --router")
    ap.add_argument("--store", action="store_true",
                    help="share one cross-engine prefix store")
    args = ap.parse_args(argv)
    if args.disagg:
        args.router = True
    if args.router and args.engines < 2:
        ap.error("--router needs --engines >= 2")
    if args.disagg and args.spec_k:
        ap.error("--disagg refuses --spec-k: the draft cache does not ride "
                 "the migration frame")
    if args.store and not args.router:
        ap.error("--store is a fleet feature: add --router --engines N")
    if args.long_context and args.max_len:
        ap.error("--long-context sizes max_len itself: pass one of "
                 "--long-context / --max-len")

    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch.generation import model_max_len
    from pytorch_distributed_tpu_torch.runtime.device import resolve_device
    from pytorch_distributed_tpu_torch.runtime.precision import Policy
    from pytorch_distributed_tpu_torch.serve import (
        EngineConfig, ServeEngine, ServeTelemetry, SpecConfig, drive,
        prefix_shared_requests, uniform_arrivals, warm_up,
    )

    device = resolve_device(args.device)
    policy = Policy.full() if device.type == "cpu" else Policy()
    model = build_model(args.model, device, policy, args.seed)
    rng = np.random.default_rng(args.seed)
    reqs = prefix_shared_requests(
        rng, args.requests, model.config.vocab_size,
        prompt_len=args.prompt_len, new_tokens=args.new_tokens,
        prefix_share=args.prefix_share,
        shared_prefix_len=args.prefix_len if args.prefix_share else 0,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        deadline_s=args.deadline_s,
    )
    if args.rate > 0 and args.poisson:
        gaps = rng.exponential(1.0 / args.rate, size=args.requests)
        arrivals = list(np.cumsum(gaps) - gaps[0])
    else:
        arrivals = uniform_arrivals(args.requests, args.rate)
    max_len = args.max_len or max(
        [-(-r.prompt_len // args.prefill_chunk) * args.prefill_chunk
         + r.max_new_tokens + args.spec_k for r in reqs]
        + [args.prefill_chunk + 2 + args.spec_k]
    )
    if args.long_context and not args.max_len:
        limit = model_max_len(model) or 1 << 30
        max_len = min(max(4 * max_len, 256), limit)
        if args.page_size:
            max_len = max(max_len - max_len % args.page_size, args.page_size)
    if not args.max_len and args.page_size:
        max_len = -(-max_len // args.page_size) * args.page_size
    writer = JsonlWriter(args.log) if args.log else None
    spec = (SpecConfig(draft_of(model, args.seed + 1),
                       num_draft_tokens=args.spec_k)
            if args.spec_k else None)
    if args.router:
        run_storm(args, model, max_len, reqs, arrivals, writer, spec, device)
        return 0
    engine = ServeEngine(
        model,
        EngineConfig(num_slots=args.slots, max_len=max_len,
                     prefill_chunk=args.prefill_chunk,
                     page_size=args.page_size, num_pages=args.num_pages,
                     decode_mode=args.decode_mode),
        device=device, spec=spec,
    )
    warm_up(engine, np.ones(1, np.int32),
            telemetry=ServeTelemetry(writer=writer))
    dt = drive(engine, reqs, arrivals)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if writer is not None:
        writer.close()
    s = engine.telemetry.summary()
    print(f"model={args.model} device={device} slots={args.slots} "
          f"max_len={max_len} requests={args.requests} "
          f"rate={args.rate or 'closed-loop'} wall={dt:.2f}s")
    for k in sorted(s):
        v = s[k]
        print(f"  {k:>18} = {v:.2f}" if isinstance(v, float)
              else f"  {k:>18} = {v}")
    pool = engine.pool
    print(f"  decode ticks       = {engine.decode_ticks} at buckets "
          f"{dict(sorted(engine.decode_bucket_ticks.items()))} (pages)")
    print(f"  kv pages           = {pool.peak_pages} peak / "
          f"{pool.num_pages} total (page_size={pool.page_size}, "
          f"{pool.kv_bytes():,d} B resident)")
    print(f"  prefix hit rate    = {pool.prefix_hit_rate:.3f} "
          f"({pool.prefix_hits}/{pool.prefix_lookups} admissions, "
          f"{pool.shared_tokens} prompt tokens served copy-free)")
    print(f"  decode bytes/token = {engine.decode_hbm_bytes_per_token:,.0f} "
          f"analytic HBM (mode={args.decode_mode}, gather "
          f"{engine.decode_gather_bytes:,d} B total)")
    if engine.spec is not None and engine.spec_verifies:
        print(f"  spec accept/verify = "
              f"{engine.spec_accepted / engine.spec_verifies:.2f} "
              f"(k={engine.spec.num_draft_tokens}, {engine.spec_verifies} "
              f"verifies, {engine.spec_accepted}/{engine.spec_drafted} "
              f"drafts accepted)")
    if args.log:
        print(f"telemetry JSONL -> {args.log}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
