"""The percentile helper the port's telemetry and tracing share (a copy
of ``pytorch_distributed_tpu/utils/timing.percentile``)."""

from __future__ import annotations

import math
from typing import Iterable


def percentile(values: Iterable[float], q: float) -> float:
    """Linearly-interpolated percentile, ``q`` in [0, 100] (numpy's
    default ``linear`` method)."""
    vals = sorted(values)
    if not vals:
        return 0.0
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q={q} not in [0, 100]")
    if len(vals) == 1:
        return float(vals[0])
    pos = (len(vals) - 1) * (q / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return float(vals[lo] * (1.0 - frac) + vals[hi] * frac)
