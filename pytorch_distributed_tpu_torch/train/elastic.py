"""Preemption: the port of the part of
``pytorch_distributed_tpu/train/elastic.py`` the recipes call.

* :class:`PreemptionHandler` latches SIGTERM (a cloud preemption) in a
  flag; the Trainer polls it between steps, writes a checkpoint and
  raises :class:`Preempted`.
* :func:`fit_elastic` runs ``trainer.fit()`` and turns ``Preempted`` into
  the exit code ``EX_TEMPFAIL`` (75, "retry me"), after which a
  supervisor restarts the job and ``Trainer.restore_checkpoint`` resumes
  it.

* :class:`Watchdog` notices a loop that stops ticking: no tick for
  ``stall_timeout_s`` (the first one gets a grace window) logs, dumps
  every thread's stack, calls ``on_stall(idle_s)`` (the Trainer counts
  the window as goodput's ``stalled``) and, when ``fatal``, aborts the
  process for a supervisor to restart.
* :func:`deferred_signals` holds SIGTERM/SIGINT across a block (a
  checkpoint's commit) and delivers them after it.

The in-process elastic world and ``PeerLost`` are not ported
(ROADMAP A11).
"""

from __future__ import annotations

import contextlib
import faulthandler
import logging
import os
import signal
import sys
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

EX_TEMPFAIL = 75  # exit code: "transient failure, restart me"


@contextlib.contextmanager
def deferred_signals(signums=(signal.SIGTERM, signal.SIGINT)):
    """Latch the given signals for the block and deliver any that came
    (``os.kill`` of this process) once it exits, so a few renames that
    must land together (a checkpoint's commit and swing) are not cut in
    two. Off the main thread, where handlers cannot be set, the block
    runs unprotected."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    pending = []
    previous = {s: signal.signal(s, lambda sig, frame: pending.append(sig))
                for s in signums}
    try:
        yield
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
        for s in pending:
            logger.warning("re-delivering signal %s deferred across the "
                           "commit window", s)
            os.kill(os.getpid(), s)


class Preempted(RuntimeError):
    """Raised by the Trainer once a preemption checkpoint is on disk."""

    def __init__(self, step: int, message: str = ""):
        super().__init__(message or f"preempted at step {step}")
        self.step = step


class PreemptionHandler:
    """A flag that SIGTERM (by default) sets between ``install`` and
    ``uninstall``. The handler only records the request: the training
    loop acts on it at a step boundary, where the state is whole."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._prev = {}
        self._requested = threading.Event()
        self._installed = False

    def _on_signal(self, signum, frame):
        self._requested.set()
        logger.warning("signal %s received: checkpointing and stopping at "
                       "the next step boundary", signal.Signals(signum).name)

    def install(self) -> "PreemptionHandler":
        if not self._installed:
            try:
                for s in self._signals:
                    self._prev[s] = signal.signal(s, self._on_signal)
            except ValueError:
                for s, prev in self._prev.items():
                    signal.signal(s, prev)
                self._prev.clear()
                logger.warning(
                    "cannot install preemption signal handlers off the main "
                    "thread: checkpoint with ckpt_every_steps instead")
                return self
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._prev.clear()
            self._installed = False

    @property
    def requested(self) -> bool:
        return self._requested.is_set()


def fit_elastic(trainer):
    """``trainer.fit()``; on preemption (the checkpoint is already
    written) exit ``EX_TEMPFAIL`` so the supervisor restarts the job."""
    try:
        return trainer.fit()
    except Preempted as e:
        logger.warning("exiting %d after the preemption checkpoint (step %d)",
                       EX_TEMPFAIL, e.step)
        sys.exit(EX_TEMPFAIL)


class Watchdog:
    """A thread that reports a loop which stops calling :meth:`tick`:
    after ``stall_timeout_s`` without a tick (``first_grace_s`` before
    the first one, which takes the first step's compiles and warm-up) it
    logs, dumps every thread's stack, calls ``on_stall(idle_s)`` and,
    when ``fatal``, aborts the process (SIGABRT) for a supervisor to
    restart. One report per stall: the next tick re-arms it."""

    def __init__(self, stall_timeout_s: float, *, fatal: bool = False,
                 on_stall: Optional[Callable[[float], None]] = None,
                 poll_s: Optional[float] = None,
                 first_grace_s: float = 900.0):
        self.stall_timeout_s = float(stall_timeout_s)
        self.fatal = fatal
        self.on_stall = on_stall
        self._poll_s = poll_s or max(0.5, self.stall_timeout_s / 10.0)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stalled = False
        self.stalls = 0
        self.last_step: Optional[int] = None
        self.first_grace_s = max(float(first_grace_s), self.stall_timeout_s)
        self._armed = False

    def tick(self, step: Optional[int] = None) -> None:
        """Progress: re-arms the watchdog and clears ``stalled``."""
        self._armed = True
        if step is not None:
            self.last_step = step
        self.stalled = False
        self._last = time.monotonic()

    def _watch(self) -> None:
        while not self._stop.wait(self._poll_s):
            idle = time.monotonic() - self._last
            limit = self.stall_timeout_s if self._armed else \
                self.first_grace_s
            if idle <= limit:
                continue
            self.stalled = True
            self.stalls += 1
            logger.error("watchdog: no train step for %.1f s (limit %.1f s; "
                         "last step %s): dumping stacks", idle,
                         self.stall_timeout_s,
                         "<none>" if self.last_step is None
                         else self.last_step)
            try:
                faulthandler.dump_traceback(file=sys.stderr)
            except Exception:   # a closed stderr must not kill the thread
                pass
            if self.on_stall is not None:
                self.on_stall(idle)
            if self.fatal:
                os.kill(os.getpid(), signal.SIGABRT)
            self._last = time.monotonic()

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._last = time.monotonic()
            self._stop.clear()
            self._thread = threading.Thread(target=self._watch,
                                            name="ptd-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
