"""SLO telemetry for the serve engine: TTFT / throughput / occupancy; the
port of ``pytorch_distributed_tpu/serve/telemetry.py``.

Records flow to any object with ``write(step, metrics, split=...)``:

* ``event="request"``: one per finished request: status, prompt/new
  token counts, TTFT (submit -> first token) and decode tokens/sec.
* ``event="snapshot"``: periodic gauges: queue depth, slot occupancy,
  decode ticks so far, page-pool occupancy.

``summary()`` aggregates the run: p50/p99 TTFT, completed-token
throughput and terminal status counts.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from pytorch_distributed_tpu_torch.utils.timing import percentile


class ServeTelemetry:
    """Collects per-request timings; optionally streams via a
    ``writer``. ``clock`` is injectable so tests drive deterministic
    time."""

    def __init__(self, writer=None, clock=time.monotonic,
                 engine_id: Optional[str] = None):
        self.writer = writer
        self.clock = clock
        self.engine_id = engine_id
        self.started_at = clock()
        self.ttfts_s: List[float] = []
        self.status_counts: Dict[str, int] = {}
        self.completed_tokens = 0
        self.total_tokens = 0
        self.submitted = 0
        self._events = 0

    # -- per-request lifecycle --------------------------------------------
    def record_submit(self, handle) -> None:
        self.submitted += 1

    def record_done(self, handle) -> None:
        """Called once, after the handle reaches a terminal status."""
        status = handle.status.value
        self.status_counts[status] = self.status_counts.get(status, 0) + 1
        n = len(handle.tokens)
        self.total_tokens += n
        metrics = {
            "event": "request",
            "request_id": handle.request.request_id,
            "status": status,
            "prompt_tokens": handle.request.prompt_len,
            "new_tokens": n,
        }
        if handle.first_token_at is not None:
            ttft = handle.first_token_at - handle.submitted_at
            metrics["ttft_ms"] = ttft * 1e3
            # every request that got a first token counts toward the
            # TTFT percentiles, whatever happened to it afterwards
            self.ttfts_s.append(ttft)
        if status == "completed":
            self.completed_tokens += n
            end = handle.finished_at or self.clock()
            # decode throughput: the clock starts at the FIRST token
            start = handle.first_token_at or handle.submitted_at
            dt = end - start
            if n > 1 and dt > 0:
                metrics["tokens_per_sec"] = (n - 1) / dt
        self._write(metrics)

    # -- periodic gauges ---------------------------------------------------
    def record_snapshot(
        self, *, queue_depth: int, slots_occupied: int, slots_total: int,
        decode_ticks: int, **gauges,
    ) -> None:
        self._write({
            "event": "snapshot",
            "queue_depth": queue_depth,
            "slots_occupied": slots_occupied,
            "slots_total": slots_total,
            "slot_occupancy": (
                slots_occupied / slots_total if slots_total else 0.0
            ),
            "decode_ticks": decode_ticks,
            **gauges,
        })

    def _write(self, metrics: Dict) -> None:
        if self.writer is not None:
            self._events += 1
            if self.engine_id is not None:
                metrics = {"engine_id": self.engine_id, **metrics}
            self.writer.write(self._events, metrics, split="serve")

    # -- aggregates --------------------------------------------------------
    def ttft_percentile_ms(self, q: float) -> Optional[float]:
        if not self.ttfts_s:
            return None
        return percentile(self.ttfts_s, q) * 1e3

    def summary(self) -> Dict[str, float]:
        wall = max(self.clock() - self.started_at, 1e-9)
        out = {
            "submitted": self.submitted,
            "total_tokens": self.total_tokens,
            "completed_tokens": self.completed_tokens,
            "tokens_per_sec": self.completed_tokens / wall,
            "wall_s": wall,
        }
        for status, n in sorted(self.status_counts.items()):
            out[status] = n
        for q in (50, 99):
            p = self.ttft_percentile_ms(q)
            if p is not None:
                out[f"ttft_ms_p{q}"] = p
        return out
