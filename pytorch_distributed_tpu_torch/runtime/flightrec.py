"""Always-on flight recorder: the port's own copy of the part of
``pytorch_distributed_tpu/runtime/flightrec.py`` that the serving router
calls (``dump`` when it loses an engine), with ``configure``, the
recorder and ``load_dumps``.

A bounded, preallocated ring of records (``begin`` -> ``start`` ->
``complete``) costs a few stores per operation and is written to disk
only when something goes wrong. Dumps are ``flight-rank<r>.json``,
written through a ``.tmp`` file and ``os.replace``, so a torn dump is a
``.tmp`` orphan, never a half-written ``.json``.

* ``PTD_FLIGHT_DUMP=<dir>`` in the environment configures the dump
  directory at import and installs a ``SIGTERM`` handler that dumps
  before dying; :func:`configure` does the same in code.
* With no directory configured, :func:`dump` is a no-op returning None:
  error paths call it unconditionally.

Not ported yet: the collective hooks (the JAX package records every
host-ring collective and P2P leg) and the cross-rank autopsy, which wait
for the port's host runtime (ROADMAP A11).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

#: dump filename stem: ``flight-rank<r>.json`` (``.tmp`` while in flight)
DUMP_PREFIX = "flight-rank"
#: bumped when the record schema changes
DUMP_VERSION = 1

_ENQUEUED, _STARTED, _COMPLETED = 1, 2, 3
_STATE_NAMES = {_ENQUEUED: "enqueued", _STARTED: "started",
                _COMPLETED: "completed"}
_DEFAULT_CAPACITY = 4096


class FlightRecorder:
    """Bounded ring of records with fixed-slot storage: the hot path
    (:meth:`begin`, :meth:`start`, :meth:`complete`) overwrites
    preallocated columns and allocates nothing."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError(
                f"flight recorder capacity must be > 0, got {capacity}")
        self.capacity = n = int(capacity)
        self._lock = threading.Lock()
        self._seq = np.full(n, -1, dtype=np.int64)
        self._state = np.zeros(n, dtype=np.int8)
        self._count = np.zeros(n, dtype=np.int64)
        self._wire = np.zeros(n, dtype=np.int64)
        self._t0 = np.zeros(n, dtype=np.float64)
        self._t1 = np.zeros(n, dtype=np.float64)
        self._kind: List[Any] = [None] * n
        self._op: List[Any] = [None] * n
        self._dtype: List[Any] = [None] * n
        self._transport: List[Any] = [None] * n
        self._group: List[Any] = [None] * n
        self._next_seq = 0
        self._last_done: Optional[Tuple[int, str, str]] = None

    def begin(self, kind: str, op: str, dtype: Any, count: int,
              wire_bytes: int, transport: str, group: str) -> int:
        """Claim the next slot as ENQUEUED; returns the record's seq."""
        with self._lock:
            seq = self._next_seq
            self._next_seq = seq + 1
            i = seq % self.capacity
            self._seq[i] = seq
            self._state[i] = _ENQUEUED
            self._count[i] = count
            self._wire[i] = wire_bytes
            self._t0[i] = self._t1[i] = 0.0
            self._kind[i], self._op[i], self._dtype[i] = kind, op, dtype
            self._transport[i], self._group[i] = transport, group
        return seq

    def start(self, seq: int) -> None:
        i = seq % self.capacity
        if self._seq[i] == seq:
            self._t0[i] = time.monotonic()
            self._state[i] = _STARTED

    def complete(self, seq: int) -> None:
        i = seq % self.capacity
        if self._seq[i] == seq:
            self._t1[i] = time.monotonic()
            self._state[i] = _COMPLETED
            self._last_done = (seq, self._kind[i], self._op[i])

    def last_completed(self) -> Optional[Tuple[int, str, str]]:
        """``(seq, kind, op)`` of the newest completed record, or None."""
        return self._last_done

    def records(self) -> List[Dict[str, Any]]:
        """Snapshot of live records, oldest first."""
        with self._lock:
            end = self._next_seq
            out = []
            for seq in range(max(0, end - self.capacity), end):
                i = seq % self.capacity
                if self._seq[i] != seq:
                    continue
                out.append({
                    "seq": int(seq), "kind": self._kind[i],
                    "op": self._op[i], "dtype": str(self._dtype[i]),
                    "count": int(self._count[i]),
                    "wire_bytes": int(self._wire[i]),
                    "transport": self._transport[i],
                    "group": self._group[i],
                    "state": _STATE_NAMES.get(int(self._state[i]), "?"),
                    "t0_mono_s": float(self._t0[i]),
                    "t1_mono_s": float(self._t1[i]),
                })
            return out


#: the process-wide recorder (``PTD_FLIGHT_SLOTS`` overrides its capacity)
RECORDER = FlightRecorder(
    int(os.environ.get("PTD_FLIGHT_SLOTS", _DEFAULT_CAPACITY)))

_dump_dir: Optional[str] = None
_rank: Optional[int] = None
_world: Optional[int] = None
_dump_lock = threading.Lock()


def configure(out_dir: Optional[str] = None, rank: Optional[int] = None,
              world: Optional[int] = None) -> None:
    """Arm (or re-point) the dump path; each argument is sticky if None."""
    global _dump_dir, _rank, _world
    if out_dir is not None:
        _dump_dir = str(out_dir)
    if rank is not None:
        _rank = int(rank)
    if world is not None:
        _world = int(world)


def _resolved_rank() -> int:
    if _rank is not None:
        return _rank
    try:
        return int(os.environ.get("PTD_FLIGHT_RANK",
                                  os.environ.get("RANK", 0)))
    except ValueError:
        return 0


def dump(reason: str, out_dir: Optional[str] = None) -> Optional[str]:
    """Write ``flight-rank<r>.json`` atomically; no-op if unconfigured.
    Returns the path, or None. Never raises: it sits on error paths that
    must still deliver their own exception."""
    d = out_dir if out_dir is not None else _dump_dir
    if d is None:
        return None
    try:
        rank = _resolved_rank()
        payload = {
            "version": DUMP_VERSION, "rank": rank, "world_size": _world,
            "reason": reason, "wall_unix_s": time.time(),
            "monotonic_s": time.monotonic(), "meta": {},
            "records": RECORDER.records(),
        }
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{DUMP_PREFIX}{rank}.json")
        tmp = path + ".tmp"
        with _dump_lock:
            with open(tmp, "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        logger.warning("flight recorder dumped %d records to %s (%s)",
                       len(payload["records"]), path, reason)
        return path
    except Exception as e:  # pragma: no cover - defensive
        logger.warning("flight recorder dump failed: %s", e)
        return None


def _sigterm_dump(signum, frame):  # pragma: no cover - in a subprocess
    dump(f"signal {signum}")
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def _install_from_env() -> None:
    d = os.environ.get("PTD_FLIGHT_DUMP")
    if not d:
        return
    configure(out_dir=d)
    if threading.current_thread() is threading.main_thread():
        try:
            signal.signal(signal.SIGTERM, _sigterm_dump)
        except (ValueError, OSError):
            pass


_install_from_env()


def load_dumps(dump_dir: str, strict: bool = False
               ) -> Dict[int, Dict[str, Any]]:
    """Read every ``flight-rank*.json`` under ``dump_dir``: ``{rank:
    payload}``. A ``.tmp`` orphan or an unparseable file is skipped with
    a warning (raised with ``strict``); two dumps claiming one rank are
    refused."""
    out: Dict[int, Dict[str, Any]] = {}
    sources: Dict[int, str] = {}
    for name in sorted(os.listdir(dump_dir)):
        if not name.startswith(DUMP_PREFIX):
            continue
        path = os.path.join(dump_dir, name)
        if name.endswith(".tmp"):
            msg = f"skipping torn flight dump {path} (writer died mid-dump)"
            if strict:
                raise ValueError(msg)
            logger.warning(msg)
            continue
        if not name.endswith(".json"):
            continue
        try:
            with open(path) as f:
                payload = json.load(f)
            rank = int(payload["rank"])
            if int(payload.get("version", -1)) != DUMP_VERSION:
                raise ValueError(
                    f"unsupported dump version {payload.get('version')}")
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            if strict:
                raise ValueError(
                    f"torn or invalid flight dump {path}: {e}") from e
            logger.warning("skipping torn or invalid flight dump %s: %s",
                           path, e)
            continue
        if rank in out:
            raise ValueError(
                f"duplicate flight dumps for rank {rank}: {sources[rank]} "
                f"and {path}: refusing to merge ambiguous evidence")
        out[rank] = payload
        sources[rank] = path
    return out
