"""Runtime tracing: the port's own copy of the part of
``pytorch_distributed_tpu/runtime/tracing.py`` that the serve engine and
the train step call.

Spans the port emits: ``serve.*`` (engine admit, prefill chunk, decode
tick, token fetch) and, per training step, ``train.step`` (the whole
step), ``train.fwd_bwd`` (its microbatch forward and backward passes),
``train.optim`` (clip and optimizer update) and ``train.data_wait``
(the batch's copy to the card). They time the host: a span around work
the card runs asynchronously ends when the work is queued, unless
something inside it waits for the card.

* :func:`span` — ``with span("serve.decode_tick"):`` around a host-side
  phase; Chrome ``trace_event`` complete events, loadable in Perfetto.
* :func:`counter` — gauges on the same timeline; :func:`instant` — a
  marker (the watchdog's ``watchdog.stall``); :func:`name_thread` —
  a label for the calling thread's track.
* :func:`note_compiles` — the recompile sentinel: a callable's
  cumulative compile count, whose every rise after the first report is
  counted and marked (the eager port compiles nothing per step, so its
  callers report only what they compile themselves).
* :func:`set_meta` / :func:`get_meta` — process metadata (rank, world)
  stamped into every export.
* :class:`GoodputAccount` — wall time by bucket (``productive``,
  ``stalled``, ``recovering``, ``checkpoint``, and ``other``, the
  rest), summing to wall; :func:`summarize_goodput` folds the
  ``split="goodput"`` records of several attempts into one account.

Unarmed (the default) every site is one module-global ``is None`` test,
and a kwarg-free ``span()`` returns one shared no-op object
(``_NULL_SPAN``); sites that attach args on a hot path test
``tracing._tracer is None`` themselves before building them.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from pytorch_distributed_tpu_torch.utils.timing import percentile


class _NullSpan:
    """The disarmed path's shared no-op span: reentrant, allocation-free."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

_tracer: Optional["Tracer"] = None

#: the goodput account's named buckets (``other`` is the remainder)
GOODPUT_BUCKETS = ("productive", "stalled", "recovering", "checkpoint",
                   "resize", "rebalance")

# process-level trace metadata (rank, world size, ...): survives
# configure()/clear() and goes into every export's otherData
_meta: Dict[str, Any] = {}


def set_meta(**kv) -> None:
    """Stamp process-level metadata into every later trace export."""
    _meta.update(kv)


def get_meta() -> Dict[str, Any]:
    return dict(_meta)


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc):
        t = self._tracer
        t.complete(self._name, self._args, self._t0, t._clock())
        return False


class Tracer:
    """Buffers trace events + per-span rollups; thread-safe. Beyond
    ``max_events`` events are dropped (counted); rollups keep counting."""

    def __init__(self, trace_dir: Optional[str] = None, *,
                 max_events: int = 200_000, sample_cap: int = 8192,
                 clock=time.perf_counter):
        self.trace_dir = trace_dir
        self.max_events = int(max_events)
        self.sample_cap = int(sample_cap)
        self._clock = clock
        self._t0 = clock()
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self.dropped = 0
        self._stats: Dict[str, list] = {}   # name -> [count, total_s, max_s]
        self._samples: Dict[str, Any] = {}
        self._compiles: Dict[str, int] = {}
        self.recompiles: Dict[str, int] = {}

    def _append(self, ev: Dict[str, Any]) -> None:
        # caller holds self._lock
        if len(self._events) >= self.max_events:
            self.dropped += 1
            return
        self._events.append(ev)

    def _ev(self, name: str, ph: str, t: float, **kw) -> Dict[str, Any]:
        return {"name": name, "ph": ph, "ts": round((t - self._t0) * 1e6, 3),
                "pid": self._pid, "tid": threading.get_ident(), **kw}

    def complete(self, name: str, args, t0: float, t1: float) -> None:
        ev = self._ev(name, "X", t0, dur=round((t1 - t0) * 1e6, 3))
        if args:
            ev["args"] = args
        dur = t1 - t0
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = [0, 0.0, 0.0]
                self._samples[name] = collections.deque(
                    maxlen=self.sample_cap
                )
            st[0] += 1
            st[1] += dur
            st[2] = max(st[2], dur)
            self._samples[name].append(dur)
            self._append(ev)

    def counter(self, name: str, value: float) -> None:
        ev = self._ev(name, "C", self._clock(), args={"value": value})
        with self._lock:
            self._append(ev)

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        ev = self._ev(name, "i", self._clock(), s="p")
        if args:
            ev["args"] = args
        with self._lock:
            self._append(ev)

    def name_thread(self, name: str) -> None:
        """Label the calling thread's track (Chrome ``thread_name``)."""
        ev = {"name": "thread_name", "ph": "M", "pid": self._pid,
              "tid": threading.get_ident(), "args": {"name": name}}
        with self._lock:
            self._append(ev)

    def note_compiles(self, name: str, n: int) -> None:
        """A callable's cumulative compile count: the first report is the
        baseline, every later rise a recompile (counted, marked)."""
        with self._lock:
            prev = self._compiles.get(name)
            self._compiles[name] = n
            if prev is None or n <= prev:
                return
            self.recompiles[name] = self.recompiles.get(name, 0) + n - prev
        self.instant("recompile", {"callable": name, "total_compiles": n})

    def rollups(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name count/total/mean/p50/p95/p99/max (ms)."""
        with self._lock:
            items = {
                k: (list(st), list(self._samples[k]))
                for k, st in self._stats.items()
            }
        out: Dict[str, Dict[str, float]] = {}
        for name in sorted(items):
            (count, total, mx), sample = items[name]
            out[name] = {
                "count": count,
                "total_ms": total * 1e3,
                "mean_ms": total / count * 1e3,
                "p50_ms": percentile(sample, 50) * 1e3,
                "p95_ms": percentile(sample, 95) * 1e3,
                "p99_ms": percentile(sample, 99) * 1e3,
                "max_ms": mx * 1e3,
            }
        return out

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Write Chrome trace_event JSON (default
        ``<trace_dir>/trace.json``)."""
        if path is None:
            if self.trace_dir is None:
                return None
            path = os.path.join(self.trace_dir, "trace.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with self._lock:
            doc = {
                "traceEvents": list(self._events),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "recompiles": dict(self.recompiles),
                              "meta": dict(_meta)},
            }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


# -- module-level sites (the is-None fast path) ----------------------------
def span(name: str, **args):
    """Span context manager; shared no-op when tracing is disarmed."""
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return _Span(t, name, args or None)


def counter(name: str, value) -> None:
    t = _tracer
    if t is not None:
        t.counter(name, value)


def instant(name: str, **args) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, args or None)


def name_thread(name: str) -> None:
    """Name the calling thread's trace track; no-op when disarmed."""
    t = _tracer
    if t is not None:
        t.name_thread(name)


def note_compiles(name: str, n: Optional[int]) -> None:
    """Recompile-sentinel site; no-op when disarmed or ``n`` unknown."""
    t = _tracer
    if t is not None and n is not None:
        t.note_compiles(name, int(n))


def configure(trace_dir: Optional[str] = None, **kw) -> Tracer:
    """Arm the process-wide tracer (replacing any active one)."""
    global _tracer
    _tracer = Tracer(trace_dir, **kw)
    return _tracer


def clear() -> None:
    global _tracer
    _tracer = None


@contextlib.contextmanager
def enabled(trace_dir: Optional[str] = None, **kw):
    """Scoped arming for tests; restores the previous tracer on exit."""
    global _tracer
    prev = _tracer
    t = configure(trace_dir, **kw)
    try:
        yield t
    finally:
        _tracer = prev


# -- goodput accounting ----------------------------------------------------
class GoodputAccount:
    """Wall time by bucket since construction: ``productive`` (train and
    eval steps, and the syncs that wait on them), ``stalled`` (what the
    watchdog saw idle), ``recovering`` (restore and the resume's batch
    replay), ``checkpoint`` (saves). The rest is ``other_s`` (data wait,
    logging, glue), so the buckets always sum to ``wall_s``.
    ``goodput_pct`` is productive seconds over wall seconds."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self.started_at = clock()
        self._lock = threading.Lock()
        self.buckets: Dict[str, float] = {}

    def add(self, bucket: str, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            self.buckets[bucket] = self.buckets.get(bucket, 0.0) + seconds

    def retract(self, bucket: str, seconds: float) -> None:
        """Withdraw seconds from ``bucket`` (not below 0): a watchdog stall
        that ends inside an accounted section was that section's time."""
        if seconds <= 0:
            return
        with self._lock:
            self.buckets[bucket] = max(
                self.buckets.get(bucket, 0.0) - seconds, 0.0)

    def wall_s(self) -> float:
        return max(self._clock() - self.started_at, 1e-9)

    def goodput_pct(self) -> float:
        return min(self.buckets.get("productive", 0.0) / self.wall_s(),
                   1.0) * 100.0

    def summary(self) -> Dict[str, float]:
        with self._lock:
            buckets = dict(self.buckets)
        wall = self.wall_s()
        out: Dict[str, float] = {
            "wall_s": wall,
            "goodput_pct": min(buckets.get("productive", 0.0) / wall,
                               1.0) * 100.0,
        }
        for b in sorted(set(GOODPUT_BUCKETS) | set(buckets)):
            out[f"{b}_s"] = buckets.get(b, 0.0)
        out["other_s"] = max(wall - sum(buckets.values()), 0.0)
        return out


def summarize_goodput(records, wall_s: Optional[float] = None) -> dict:
    """One account from the ``split="goodput"`` metrics records of one or
    more attempts of a run (a killed and restarted one). ``wall_s``, when
    given, is the denominator instead of the records' own sum (a drill's
    own clock, restart gaps included)."""
    g = [r for r in records if r.get("split") == "goodput"]
    out: Dict[str, Any] = {"attempts_recorded": len(g)}
    keys = set()
    for r in g:
        keys.update(k for k in r if k.endswith("_s"))
    for k in sorted(keys | {f"{b}_s" for b in GOODPUT_BUCKETS}
                    | {"other_s", "wall_s"}):
        out[k] = sum(float(r.get(k, 0.0)) for r in g)
    wall = wall_s if wall_s is not None else out.get("wall_s", 0.0)
    out["goodput_pct"] = (round(100.0 * out.get("productive_s", 0.0) / wall,
                                2) if wall > 0 else 0.0)
    if wall_s is not None:
        out["wall_s"] = wall_s
    return out
