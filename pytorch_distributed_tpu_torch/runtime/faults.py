"""Deterministic, seeded fault injection at named sites: the port's own
copy of the part of ``pytorch_distributed_tpu/runtime/faults.py`` that
the serve engine, the router, the checkpoint and the host pipeline
executor call.

Production code calls :func:`check` at named sites; a chaos run arms a
subset of them with seeded probability/count budgets. Unarmed (the
default: ``PTD_FAULTS`` unset, no :func:`configure`) every check is one
module-global ``is None`` test.

Arming::

    PTD_FAULTS="serve.decode:count=1,match=req-7" python serve.py

or, in tests, ``with faults.injected("serve.prefill:count=1"): ...``.
Grammar: ``site[:key=value,...]`` joined by ``;``; options ``p``
(firing probability, default 1.0), ``count`` (firing budget), ``after``
(skip the first N eligible checks), ``mode`` (``raise``: raise
:class:`InjectedFault`, the default; ``kill``: ``os._exit``;
``truncate``: cut the site's file to half its length; ``bitflip``: flip
one byte in the middle of it; the last two report success, so only a
checksum can catch them; ``stall``: the site polls :func:`hang_action`
and sleeps ``seconds`` before it goes on, a rank that is alive but late,
which :func:`check` ignores), ``seconds`` (the stall's length, default
30) and ``match`` (only checks whose ``path`` contains this substring).
Each site draws from its own generator seeded by ``(seed, crc32(site))``.

Sites:

================== ====================================================
``serve.prefill``    before a serve-engine prefill chunk runs; ``path``
                     is the request id — the poisoned request is evicted
                     (FAILED), the engine keeps serving
``serve.decode``     per request per decode tick, before its sampled
                     token is accepted — same evict-and-continue contract
``serve.kv_migrate`` before a prefill-tier engine packs a finished
                     request's page frames for migration (``path`` is the
                     request id): the request is evicted (FAILED) on the
                     prefill engine, which keeps serving
``serve.engine_loss`` once per live engine per router step
                     (``serve/router.py``; ``path`` is the engine id, so
                     ``match=<engine_id>`` picks the victim): the router
                     stops driving that engine and replays its live
                     requests from scratch on a surviving peer
``ckpt.write_shard`` after each shard file is written and checksummed
                     (``train/ckpt_io.py``, ``train/checkpoint.py``);
                     raise/kill abort the save mid-write,
                     truncate/bitflip damage the file silently
``ckpt.swing``       inside the rename window of ``ckpt_io._swing``
                     (between ``final -> old`` and ``tmp -> final``)
``ckpt.read_shard``  before each shard is read on restore
``data.fetch``       before an image file is opened
                     (``data/image_folder.py``; ``path`` the file): a
                     transient read error, retried
``data.decode``      after an image file is opened, before it decodes:
                     permanent rot, quarantined without a retry
``pipeline.stage_stall`` polled before every compute op of the host
                     pipeline executor (``parallel/pipeline_schedule.py``;
                     ``path`` is ``s<stage>.<op>.m<microbatch>``):
                     ``mode=stall`` delays this stage's slot (the
                     straggler stage its neighbours' hand-offs then
                     wait for), ``mode=kill`` dies mid-schedule;
                     ``match`` selects the op (``match=s1.bwd.m2``)
================== ====================================================
"""

from __future__ import annotations

import contextlib
import os
import threading
import zlib
from typing import Dict, Optional

import numpy as np

from pytorch_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

ENV_SPEC = "PTD_FAULTS"
ENV_SEED = "PTD_FAULTS_SEED"

#: exit status of ``mode=kill``
KILLED_EXIT = 113

KNOWN_SITES = ("serve.prefill", "serve.decode", "serve.kv_migrate",
               "serve.engine_loss", "ckpt.write_shard", "ckpt.swing",
               "ckpt.read_shard", "data.fetch", "data.decode",
               "pipeline.stage_stall")
_MODES = ("raise", "kill", "truncate", "bitflip", "stall")


class InjectedFault(RuntimeError):
    """Raised at an armed fault site (``mode=raise``)."""

    def __init__(self, site: str, path: Optional[str] = None):
        msg = f"injected fault at {site}"
        if path:
            msg += f" ({path})"
        super().__init__(msg)
        self.site = site
        self.path = path


class _Site:
    """One armed site: its budgets and its private decision stream."""

    def __init__(self, name: str, *, p: float = 1.0,
                 count: Optional[int] = None, after: int = 0,
                 mode: str = "raise", match: Optional[str] = None,
                 seconds: float = 30.0, seed: int = 0):
        if mode not in _MODES:
            raise ValueError(
                f"fault site {name!r}: unknown mode {mode!r} "
                f"(one of {_MODES})"
            )
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"fault site {name!r}: p={p} not in [0, 1]")
        if count is not None and count < 0:
            raise ValueError(f"fault site {name!r}: count must be >= 0")
        if after < 0:
            raise ValueError(f"fault site {name!r}: after must be >= 0")
        if not seconds > 0:
            raise ValueError(
                f"fault site {name!r}: seconds must be > 0, got {seconds}")
        self.name = name
        self.seconds = float(seconds)
        self.p = float(p)
        self.count = count
        self.after = int(after)
        self.mode = mode
        self.match = match
        self.fired = 0
        self.seen = 0
        self._rng = np.random.default_rng(
            [int(seed), zlib.crc32(name.encode())]
        )
        self._lock = threading.Lock()

    def decide(self, path: Optional[str]) -> bool:
        with self._lock:
            if self.match is not None and (
                path is None or self.match not in str(path)
            ):
                return False
            self.seen += 1
            if self.seen <= self.after:
                return False
            if self.count is not None and self.fired >= self.count:
                return False
            if self.p < 1.0 and float(self._rng.random()) >= self.p:
                return False
            self.fired += 1
            return True


def parse(spec: str, *, seed: int = 0) -> Dict[str, _Site]:
    sites: Dict[str, _Site] = {}
    for part in filter(None, (s.strip() for s in spec.split(";"))):
        name, _, opts_str = part.partition(":")
        name = name.strip()
        if name not in KNOWN_SITES:
            raise ValueError(
                f"unknown fault site {name!r} (known: {KNOWN_SITES})"
            )
        kw: dict = {}
        for opt in filter(None, opts_str.split(",")):
            key, _, value = opt.partition("=")
            key, value = key.strip(), value.strip()
            if key in ("p", "seconds"):
                kw[key] = float(value)
            elif key in ("count", "after"):
                kw[key] = int(value)
            elif key in ("mode", "match"):
                kw[key] = value
            else:
                raise ValueError(
                    f"fault site {name!r}: unknown option {key!r}"
                )
        sites[name] = _Site(name, seed=seed, **kw)
    if not sites:
        raise ValueError(f"empty fault spec {spec!r}")
    return sites


_plan: Optional[Dict[str, _Site]] = None


def configure(spec: str, *, seed: Optional[int] = None):
    """Arm a fault plan (replacing any active one); returns it."""
    global _plan
    if seed is None:
        seed = int(os.environ.get(ENV_SEED, "0"))
    _plan = parse(spec, seed=seed)
    logger.warning("fault injection ARMED (seed %d): %s", seed, sorted(_plan))
    return _plan


def clear() -> None:
    """Disarm: every later check is a no-op again."""
    global _plan
    _plan = None


def active() -> bool:
    return _plan is not None


@contextlib.contextmanager
def injected(spec: str, *, seed: int = 0):
    """Scoped arming for tests; restores the previous plan on exit."""
    global _plan
    prev = _plan
    configure(spec, seed=seed)
    try:
        yield _plan
    finally:
        _plan = prev


def hang_action(site: str, path: Optional[str] = None):
    """The stall site: None unless ``site`` is armed with ``mode=stall``
    and its budgets elect this poll, and then ``("stall", seconds)``, for
    the caller to sleep before it goes on. Other modes at the same site
    are :func:`check`'s, so one poll never spends another's budget."""
    if _plan is None:
        return None
    s = _plan.get(site)
    if s is None or s.mode != "stall" or not s.decide(path):
        return None
    logger.warning("fault injection: stall %s at %s (%s s, %d/%s)", site,
                   path or "<no path>", s.seconds, s.fired,
                   s.count if s.count is not None else "inf")
    return ("stall", s.seconds)


def check(site: str, path: Optional[str] = None) -> None:
    """The production fault site: no-op unless ``site`` is armed and its
    budgets elect this check. ``path`` (a file, where the site has one)
    feeds ``match`` and the damaging modes. A ``stall`` site is
    :func:`hang_action`'s: it never fires here."""
    if _plan is None:
        return
    s = _plan.get(site)
    if s is None or s.mode == "stall" or not s.decide(path):
        return
    logger.warning(
        "fault injection: firing %s (mode=%s, %d/%s) at %s",
        site, s.mode, s.fired, s.count if s.count is not None else "inf",
        path or "<no path>",
    )
    if s.mode == "kill":
        os._exit(KILLED_EXIT)
    if s.mode == "raise":
        raise InjectedFault(site, path)
    _corrupt(path, s.mode)


def _corrupt(path: Optional[str], mode: str) -> None:
    """Damage ``path`` silently: cut it to half (``truncate``) or flip the
    byte in its middle (``bitflip``)."""
    if not path or not os.path.isfile(path):
        return
    size = os.path.getsize(path)
    if size == 0:
        return
    with open(path, "r+b") as f:
        if mode == "truncate":
            f.truncate(max(size // 2, 1))
        else:
            off = size // 2
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))


_env_spec = os.environ.get(ENV_SPEC)
if _env_spec:
    configure(_env_spec)
del _env_spec
