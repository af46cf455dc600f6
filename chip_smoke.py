#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card: build its kernels, hold
each against its plain PyTorch version, and serve Llama-3-8B.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises (and so exits non-zero) on a failed check:

1. build: ``nvcc`` compiles ``pytorch_distributed_tpu_torch/csrc/*.cu``
   into ``pytorch_distributed_tpu_torch/_build/`` (ignored by git).
2. kernels: the paged-attention kernel at the decode tick's shapes
   (Llama-3-8B attention: 32 query / 8 kv heads, head_dim 128, 32-token
   pages, 8 rows of seeded lengths up to 2000), plus a W=5 verify block,
   a 256-token window and garbage in the null page, in bf16 and f32,
   against the plain ``stream`` and ``gather`` versions; then its time
   beside the plain version's, a bytes bound, and
   ``scaled_dot_product_attention`` over the same K/V gathered dense.
3. serve: ``ServeEngine`` on Llama-3-8B at full width and depth, weights
   drawn from a seeded generator: 8 requests (6 greedy, 2 sampled, two
   sharing a 256-token prefix). Every request must finish with its full
   token count, the kernel must have launched once per layer per decode
   tick, and every greedy token must be, within a stated bf16 margin,
   the argmax of a dense teacher-forced forward of the same model.

Output: a ``details`` JSON line (every check and serve number), a
``kernels`` JSON line, then the card's name and power limit as
``nvidia-smi`` prints them, then the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# kernel vs plain tolerances, relative to max|reference|: f32 differs
# only in summation order (chunks of 32-128 keys vs pages of 32, FMA
# contraction), a few ulp of f32; bf16 rounds the probabilities to bf16
# (8-bit mantissa) before P.V at different running maxima, and rounds
# the output, so about 2^-8 of the largest output plus accumulation
F32_RTOL = 1e-5
BF16_RTOL = 2e-2
# greedy tokens vs the dense teacher-forced forward: bf16 weights and
# activations, other matmul shapes and another attention path move the
# logits (themselves bf16 values of magnitude 4-8, ulp 2^-5) by a few
# ulps; on an H100 the worst gap measured 0.156 for the paged tick and
# 0.1875 for the dense tick without the kernel (the A/B below), so the
# margin is 8 such ulps. A wrong token sits several units below the max
# (the logits' spread is about 1.3 at std-0.02 weights).
GREEDY_MARGIN = 0.25


def _time_ms(fn, iters):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _paged_case(gen, *, B, W, Hq, Hkv, D, ps, n, dtype, max_len, device):
    """A page pool with seeded ragged lengths; each row owns distinct
    random pages for its live keys, the rest of its table is null page
    0, which holds large garbage that must stay unobservable."""
    import torch

    lengths = torch.randint(1, max_len + 1, (B,), generator=gen)
    live = [-(-(int(L) + W) // ps) for L in lengths]
    P1 = sum(live) + 1
    perm = torch.randperm(P1 - 1, generator=gen) + 1
    tables = torch.zeros(B, n, dtype=torch.int32)
    off = 0
    for b, k in enumerate(live):
        tables[b, :k] = perm[off:off + k].int()
        off += k
    kw = dict(generator=gen, dtype=torch.float32)
    q = torch.randn(B, W, Hq, D, **kw)
    kp = torch.randn(P1, ps, Hkv, D, **kw)
    vp = torch.randn(P1, ps, Hkv, D, **kw)
    kp[0] = 3e4
    vp[0] = -3e4
    to = lambda t: t.to(device=device, dtype=dtype)  # noqa: E731
    return (to(q), to(kp), to(vp), tables.to(device),
            lengths.int().to(device))


def _live_keys(lengths, W, n, ps, window):
    out = []
    for L in lengths.tolist():
        end = min(L + W, n * ps)
        start = max(0, L - window + 1) if window else 0
        out.append(max(end - start, 0))
    return out


def kernel_phase(device, seed):
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_tpu_torch.ops.paged_attention import (
        gather_dense,
        paged_attention,
    )

    gen = torch.Generator().manual_seed(seed)
    shape = dict(B=8, Hq=32, Hkv=8, D=128, ps=32, n=64, max_len=2000)
    cases = [
        ("decode W=1", dict(W=1), None),
        ("verify W=5", dict(W=5), None),
        ("window 256", dict(W=1), 256),
    ]
    checks = []
    main = None
    for dtype, rtol in ((torch.bfloat16, BF16_RTOL), (torch.float32,
                                                       F32_RTOL)):
        for name, kw, window in cases:
            q, kp, vp, tables, lengths = _paged_case(
                gen, dtype=dtype, device=device, **shape, **kw
            )
            args = dict(page_tables=tables, lengths=lengths, window=window)
            out = paged_attention(q, kp, vp, **args).float()
            torch.cuda.synchronize()
            for impl in ("stream", "gather"):
                ref = paged_attention(q, kp, vp, impl=impl, **args).float()
                err = (out - ref).abs().max().item()
                scale = ref.abs().max().item()
                ok = math.isfinite(err) and err <= rtol * scale
                checks.append(dict(
                    case=name, dtype=str(dtype).replace("torch.", ""),
                    plain=impl, max_abs_err=err, max_abs_ref=scale,
                    tol=rtol * scale, ok=ok,
                ))
                print(f"kernel {name} {dtype} vs {impl}: max|err| "
                      f"{err:.3e} <= {rtol:g} * max|ref| {scale:.4f} -> "
                      f"{'ok' if ok else 'FAIL'}")
            if dtype is torch.bfloat16 and name == "decode W=1":
                main = (q, kp, vp, tables, lengths)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")

    # time at the decode tick's shapes (bf16, W=1)
    q, kp, vp, tables, lengths = main
    B, W, Hq, D = q.shape
    ps, Hkv = kp.shape[1], kp.shape[2]
    n = tables.shape[1]
    args = dict(page_tables=tables, lengths=lengths)
    kernel_ms = _time_ms(lambda: paged_attention(q, kp, vp, **args), 200)
    plain_ms = _time_ms(
        lambda: paged_attention(q, kp, vp, impl="stream", **args), 5
    )
    # the library yardstick: SDPA over the same K/V gathered dense, with
    # the ragged lengths as a boolean mask. Its default (cuDNN) backend
    # lets the null page's large garbage through the mask, so the pages
    # it reads are gathered with a zeroed null page.
    kp0, vp0 = kp.clone(), vp.clone()
    kp0[0], vp0[0] = 0, 0
    kd = gather_dense(kp0, tables).transpose(1, 2)         # [B, Hkv, T, D]
    vd = gather_dense(vp0, tables).transpose(1, 2)
    qd = q.transpose(1, 2)                                 # [B, Hq, W, D]
    kpos = torch.arange(n * ps, device=device)
    mask = (kpos[None, :] <= lengths[:, None].long())[:, None, None, :]
    lib_out = F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True
    ).transpose(1, 2)
    ours = paged_attention(q, kp, vp, **args).float()
    lib_err = (lib_out.float() - ours).abs().max().item()
    garbage_out = F.scaled_dot_product_attention(
        qd, gather_dense(kp, tables).transpose(1, 2),
        gather_dense(vp, tables).transpose(1, 2), attn_mask=mask,
        enable_gqa=True,
    ).transpose(1, 2)
    garbage_err = (garbage_out.float() - ours).abs().max().item()
    library_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True
        ), 200,
    )
    live = _live_keys(lengths, W, n, ps, None)
    itemsize = q.element_size()
    nbytes = (sum(live) * Hkv * D * 2 * itemsize     # K and V, read once
              + 2 * q.numel() * itemsize              # q in, out
              + tables.numel() * 4 + lengths.numel() * 4)
    flops = sum(live) * Hq * W * D * 4                # QK^T and PV
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    record = dict(
        name="paged_attention", route="cuda",
        source="pytorch_distributed_tpu_torch/csrc/paged_attention.cu",
        replaces="pytorch_distributed_tpu/ops/paged_attention.py:423",
        launches=None,
        max_abs_err=max(c["max_abs_err"] for c in checks
                        if c["case"] == "decode W=1"
                        and c["dtype"] == "bfloat16"),
        ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library_ms,
    )
    print(f"kernel time {kernel_ms:.4f} ms, plain (stream) {plain_ms:.4f} "
          f"ms, sdpa {library_ms:.4f} ms (max|diff| vs kernel "
          f"{lib_err:.3e}; {garbage_err:.3e} with the null page's garbage "
          f"left in), bound {record['bound_ms']:.4f} ms "
          f"({nbytes} bytes, {flops} flops)")
    details = dict(checks=checks, bytes=nbytes, flops=flops,
                   live_keys=live, sdpa_max_abs_diff=lib_err,
                   sdpa_max_abs_diff_null_page_garbage=garbage_err)
    return record, details


def _requests(seed, vocab):
    """8 requests: seeded prompt lengths 64-1024 and 32-64 new tokens;
    requests 6 and 7 sample (T 0.8, top_p 0.95); request 7 repeats
    request 0's first 256 tokens (it is submitted after request 0's
    prefill has registered them, so it maps those pages shared)."""
    import numpy as np

    from pytorch_distributed_tpu_torch.serve import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(8):
        P = int(rng.integers(64, 1025))
        if i in (0, 7):
            P = max(P, 300)   # longer than the shared 256-token prefix
        prompt = rng.integers(1, vocab, size=P).astype(np.int32)
        if i == 7:
            prompt[:256] = reqs[0].prompt_ids[:256]
        sampled = i >= 6
        reqs.append(Request(
            prompt_ids=prompt, max_new_tokens=int(rng.integers(32, 65)),
            temperature=0.8 if sampled else 0.0,
            top_p=0.95 if sampled else None, seed=100 + i,
            request_id=f"r{i}",
        ))
    return reqs


def _drive(model, ecfg, reqs):
    """Serve ``reqs`` on a fresh engine: the first 7 at once, the last
    once request 0 decodes (so its prefix pages are registered)."""
    import torch

    from pytorch_distributed_tpu_torch import RequestStatus, ServeEngine
    from pytorch_distributed_tpu_torch.runtime import tracing

    engine = ServeEngine(model, ecfg)
    with tracing.enabled() as tracer:
        t0 = time.perf_counter()
        handles = [engine.submit(r) for r in reqs[:7]]
        while handles[0].status is not RequestStatus.DECODING:
            engine.step()
        handles.append(engine.submit(reqs[7]))
        engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for r, h in zip(reqs, handles):
        if h.status is not RequestStatus.COMPLETED or len(h.tokens) != (
            r.max_new_tokens
        ):
            raise AssertionError(
                f"{ecfg.decode_mode} {r.request_id}: {h.status} with "
                f"{len(h.tokens)} of {r.max_new_tokens} tokens"
            )
    engine.pool.check_consistency()
    roll = tracer.rollups()
    tick = [roll[k] for k in ("serve.decode_tick", "serve.token_fetch")]
    return engine, handles, dict(
        wall_s=wall,
        decode_tick_ms=sum(x["mean_ms"] for x in tick),
        decode_tick_ms_p50=sum(x["p50_ms"] for x in tick),
        prefill_chunk_ms=roll["serve.prefill_chunk"]["mean_ms"],
    )


def _teacher_gaps(model, reqs, handles, device):
    """For every greedy token: the dense teacher-forced forward's max
    logit minus the logit of the token the engine chose."""
    import torch

    gaps, exact = [], 0
    with torch.no_grad():
        for r, h in zip(reqs, handles):
            if r.temperature > 0:
                continue
            seq = torch.tensor(
                list(r.prompt_ids) + h.tokens, device=device
            )[None].long()
            logits = model(seq)[0, r.prompt_len - 1:-1]   # [new, V]
            if not torch.isfinite(logits).all():
                raise AssertionError(f"{r.request_id}: non-finite logits")
            toks = torch.tensor(h.tokens, device=device)
            mine = logits.gather(1, toks[:, None])[:, 0]
            gaps.extend((logits.max(dim=-1).values - mine).tolist())
            exact += int((logits.argmax(dim=-1) == toks).sum())
    return exact, gaps


def serve_phase(device, seed):
    import torch

    from pytorch_distributed_tpu_torch import (
        EngineConfig,
        LlamaConfig,
        LlamaForCausalLM,
        ServeEngine,
        paged_attention,
    )
    from pytorch_distributed_tpu_torch.serve import Request

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    model.requires_grad_(False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: Llama-3-8B, {n_params} params in bf16, seeded init "
          f"{init_s:.1f} s")
    ecfg = EngineConfig(num_slots=8, max_len=2048, prefill_chunk=256)

    # warm-up (cuBLAS handles, allocator) on its own engine
    warm = ServeEngine(model, ecfg)
    warm.submit(Request(prompt_ids=list(range(1, 40)), max_new_tokens=4))
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()

    reqs = _requests(seed, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats(device)
    paged_attention.launches = 0
    engine, handles, timing = _drive(model, ecfg, reqs)   # the main path
    launches = paged_attention.launches
    ticks = engine.decode_ticks
    summary = engine.telemetry.summary()
    peak_mem = torch.cuda.max_memory_allocated(device) / 2**30
    if engine.pool.prefix_hits < 1:
        raise AssertionError("the shared 256-token prefix was not shared")
    if launches != ticks * cfg.num_layers:
        raise AssertionError(
            f"paged_attention launched {launches} times over {ticks} "
            f"decode ticks x {cfg.num_layers} layers"
        )
    print(f"serve: {len(reqs)} requests completed, {ticks} decode ticks, "
          f"{launches} kernel launches (= ticks x {cfg.num_layers}), "
          f"prefix hits {engine.pool.prefix_hits}")
    exact, gaps = _teacher_gaps(model, reqs, handles, device)
    worst = max(gaps)
    print(f"greedy vs teacher-forced: {exact}/{len(gaps)} exact argmax, "
          f"worst logit gap {worst:.4f} (margin {GREEDY_MARGIN})")
    if worst > GREEDY_MARGIN:
        raise AssertionError(
            f"a greedy token sits {worst:.4f} below the teacher-forced "
            f"argmax (margin {GREEDY_MARGIN})"
        )
    stats = dict(
        requests=len(reqs), decode_ticks=ticks, launches=launches,
        tokens_per_s=summary["tokens_per_sec"],
        completed_tokens=summary["completed_tokens"],
        ttft_ms_p50=summary["ttft_ms_p50"], ttft_ms_p99=summary["ttft_ms_p99"],
        peak_pages=engine.pool.peak_pages, pages_total=engine.pool.num_pages,
        prefix_hits=engine.pool.prefix_hits, peak_mem_gib=peak_mem,
        greedy_exact=exact, greedy_tokens=len(gaps), greedy_worst_gap=worst,
        greedy_margin=GREEDY_MARGIN, model_init_s=init_s, **timing,
    )
    print(f"serve: {stats['tokens_per_s']:.1f} tokens/s, TTFT p50 "
          f"{stats['ttft_ms_p50']:.1f} ms p99 {stats['ttft_ms_p99']:.1f} ms, "
          f"decode tick {timing['decode_tick_ms']:.2f} ms, prefill chunk "
          f"{timing['prefill_chunk_ms']:.2f} ms, peak pages "
          f"{stats['peak_pages']}/{stats['pages_total']}, peak memory "
          f"{peak_mem:.1f} GiB")

    # A/B: the same requests through the dense-gather tick (no kernel),
    # which also shows the bf16 noise floor of the teacher-forced check
    del engine
    dense_engine, dhandles, dtiming = _drive(
        model, dataclasses.replace(ecfg, decode_mode="dense"), reqs
    )
    dexact, dgaps = _teacher_gaps(model, reqs, dhandles, device)
    print(f"dense A/B: decode tick {dtiming['decode_tick_ms']:.2f} ms, "
          f"greedy vs teacher-forced {dexact}/{len(dgaps)} exact, worst "
          f"gap {max(dgaps):.4f}")
    if max(dgaps) > GREEDY_MARGIN:
        raise AssertionError("the dense tick misses the teacher-forced check")
    stats["dense"] = dict(greedy_exact=dexact, greedy_worst_gap=max(dgaps),
                          **dtiming)
    return launches, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from pytorch_distributed_tpu_torch.ops.paged_attention import (
            build_kernel,
        )
        from pytorch_distributed_tpu_torch.runtime.device import device_info
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = build_kernel()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    log = lib.parent / "paged_attention.log"
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    record, kdetails = kernel_phase(device, args.seed)
    launches, stats = serve_phase(device, args.seed)
    record["launches"] = launches

    card = device_info()
    print(json.dumps({"details": dict(kernel=kdetails, serve=stats)}))
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
