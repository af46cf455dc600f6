"""Offered-load driving for the serving engine and the router: the
port of ``pytorch_distributed_tpu/serve/loadgen.py``, one warm-up and
pacing discipline shared by ``scripts/port_serve_loadgen.py`` and
``chip_smoke.py``'s serving phase.
"""

from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np

from pytorch_distributed_tpu_torch.serve.scheduler import Request, RequestStatus
from pytorch_distributed_tpu_torch.serve.telemetry import ServeTelemetry


def warm_up(
    engine, prompt_ids, telemetry: ServeTelemetry = None, *,
    precompile_buckets: bool = True,
) -> None:
    """Run the engine's paths once outside any measured window.

    A 2-token request is the minimum that reaches a decode tick: a
    1-token request emits its only token from the prefill and retires
    (checked here, loudly). ``precompile_buckets`` (default on) then
    runs an idle tick at every bucket width, so a live request crossing
    a page-bucket boundary mid-measurement uses nothing for the first
    time (a cuBLAS plan, an allocator block). Afterwards the engine's
    telemetry is replaced (``telemetry`` or a fresh one), so the
    warm-up's TTFT stays out of every reported stream and percentile.
    The engine's ``max_len`` must fit
    ``roundup(len(prompt_ids), prefill_chunk) + 2``.
    """
    h = engine.submit(Request(prompt_ids, max_new_tokens=2))
    engine.run_until_drained()
    if h.status is not RequestStatus.COMPLETED:
        raise RuntimeError(f"warm-up request failed: {h.status.value}")
    if engine.decode_ticks < 1:
        raise RuntimeError("warm-up drained without a decode tick")
    if precompile_buckets:
        engine.precompile_decode_buckets()
    engine.telemetry = telemetry or ServeTelemetry(
        # keep the engine's writer/clock/engine_id: replacing a
        # writer-backed telemetry with a writer-less one would silently
        # drop the JSONL stream the caller wired up, and dropping the
        # fleet label would anonymize a fleet member's records
        writer=engine.telemetry.writer,
        clock=engine.telemetry.clock,
        engine_id=engine.telemetry.engine_id,
    )
    # a caller-built telemetry was stamped BEFORE this warm-up ran —
    # restart its wall clock or summary() throughput eats the warm-up
    engine.telemetry.started_at = engine.telemetry.clock()


def drive(
    engine,
    requests: Sequence[Request],
    arrivals: Sequence[float],
    *,
    clock=time.perf_counter,
) -> float:
    """Submit ``requests[i]`` at ``arrivals[i]`` seconds from start and
    step the engine until everything drains; returns the wall seconds.

    Between steps with no work and a pending arrival, sleeps at most
    2 ms so pacing stays accurate without busy-burning the host core.
    """
    if len(requests) != len(arrivals):
        raise ValueError("requests and arrivals must pair up")
    t0 = clock()
    i, n = 0, len(requests)
    while i < n or engine.has_work():
        now = clock() - t0
        while i < n and now >= arrivals[i]:
            engine.submit(requests[i])
            i += 1
        if not engine.step() and i < n:
            time.sleep(min(max(arrivals[i] - now, 0.0), 0.002))
    return clock() - t0


def uniform_arrivals(n: int, rate: float) -> List[float]:
    """Fixed-rate arrival offsets: request i at ``i / rate`` (all at 0
    when ``rate`` is 0 — closed-loop saturation)."""
    if rate <= 0:
        return [0.0] * n
    return [i / rate for i in range(n)]


def prefix_shared_requests(
    rng,
    n: int,
    vocab: int,
    *,
    prompt_len=(4, 16),
    new_tokens=(8, 32),
    prefix_share: float = 0.0,
    shared_prefix_len: int = 0,
    temperature: float = 0.0,
    top_k=None,
    top_p=None,
    deadline_s=None,
) -> List[Request]:
    """Seeded mixed-length workload with a common-system-prompt knob.

    ``prefix_share`` of the requests open with ONE shared
    ``shared_prefix_len``-token system prompt (drawn once from ``rng``)
    followed by their own tail; the rest are fully independent. This is
    the workload shape the paged pool's prefix registry exists for.
    Lengths are inclusive
    ``(lo, hi)`` ranges; per-request seeds come from ``rng`` so sampled
    runs replay exactly.
    """
    if not 0.0 <= prefix_share <= 1.0:
        raise ValueError(
            f"prefix_share must be in [0, 1], got {prefix_share}"
        )
    if prefix_share > 0.0 and shared_prefix_len < 1:
        raise ValueError(
            "prefix_share > 0 needs shared_prefix_len >= 1 "
            "(the common system prompt must exist to be shared)"
        )
    system = rng.integers(
        1, vocab, size=shared_prefix_len
    ).astype(np.int32) if shared_prefix_len else None
    p_lo, p_hi = prompt_len
    n_lo, n_hi = new_tokens
    reqs = []
    for i in range(n):
        tail = rng.integers(
            1, vocab, size=int(rng.integers(p_lo, p_hi + 1))
        ).astype(np.int32)
        shared = system is not None and rng.random() < prefix_share
        ids = np.concatenate([system, tail]) if shared else tail
        reqs.append(Request(
            prompt_ids=ids,
            max_new_tokens=int(rng.integers(n_lo, n_hi + 1)),
            temperature=temperature, top_k=top_k, top_p=top_p,
            deadline_s=deadline_s,
            seed=int(rng.integers(0, 2**31)),
        ))
    return reqs
