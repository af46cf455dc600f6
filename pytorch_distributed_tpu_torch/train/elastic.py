"""Preemption: the port of the part of
``pytorch_distributed_tpu/train/elastic.py`` the recipes call.

* :class:`PreemptionHandler` latches SIGTERM (a cloud preemption) in a
  flag; the Trainer polls it between steps, writes a checkpoint and
  raises :class:`Preempted`.
* :func:`fit_elastic` runs ``trainer.fit()`` and turns ``Preempted`` into
  the exit code ``EX_TEMPFAIL`` (75, "retry me"), after which a
  supervisor restarts the job and ``Trainer.restore_checkpoint`` resumes
  it.

The watchdog, the in-process elastic world and its
``deferred_signals`` are not ported (ROADMAP A5, A11).
"""

from __future__ import annotations

import logging
import signal
import sys
import threading

logger = logging.getLogger(__name__)

EX_TEMPFAIL = 75  # exit code: "transient failure, restart me"


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
