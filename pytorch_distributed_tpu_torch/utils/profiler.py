"""Profiling hooks: the port of ``pytorch_distributed_tpu/utils/profiler.py``
on ``torch.profiler``.

* :func:`maybe_trace` — traces the host and the card (``CPU`` and, on
  a CUDA device, ``CUDA`` activities) over the block and writes one
  Chrome trace (``trace-<pid>.json``, loadable in Perfetto) into the
  directory; a no-op when the directory is None, so recipes pass
  ``--profile-dir`` unconditionally.
* :func:`annotate` — a named region on the profiler's timeline
  (``torch.profiler.record_function``).
* :class:`StepTimer` — a rolling window of step times (mean, p50, p95,
  rate) for the steps-a-second meters, without a trace; its
  :meth:`~StepTimer.percentile` takes a fraction (``0.95``), as the JAX
  package's.
* :func:`aten_flops` — counts the FLOPs of the ATen ops run inside it
  (``torch.utils.flop_counter``'s formulas), the counterpart of the
  JAX package's ``compiled_flops``; the trainer's ``log_mfu`` uses it.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Optional

import torch

from pytorch_distributed_tpu_torch.utils.timing import percentile


def trace_activities(device: Optional[torch.device] = None):
    """The profiler's activities: the host, and the card when there is
    one (or ``device`` is a CUDA device)."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    cuda = (device.type == "cuda" if device is not None
            else torch.cuda.is_available())
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return acts


def export_trace(prof, logdir: str) -> str:
    """Write ``prof``'s Chrome trace into ``logdir``; returns the path."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def maybe_trace(logdir: Optional[str], *,
                device: Optional[torch.device] = None):
    """``torch.profiler`` over the block, its Chrome trace written into
    ``logdir`` at the end (the profiler object is yielded; ``None`` and
    nothing traced when ``logdir`` is None)."""
    if logdir is None:
        yield None
        return
    from torch.profiler import profile

    with profile(activities=trace_activities(device)) as prof:
        yield prof
    export_trace(prof, logdir)


class _AtenFlops:
    """The FLOP total of an :func:`aten_flops` block."""

    def __init__(self):
        self.flops = 0


def _flop_mode(total: _AtenFlops):
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                total.flops += formula(*args, **kwargs, out_val=out)
            return out

    return Mode()


@contextlib.contextmanager
def aten_flops():
    """Count the FLOPs of the ATen ops inside the block (matmuls,
    convolutions, attention ops: ``torch.utils.flop_counter``'s
    formulas), backward passes included. A bare dispatch mode that
    runs every op unchanged: unlike ``FlopCounterMode``, which hooks
    every module to attribute its counts and so can reorder the
    backward's gradient sums, it leaves every result equal to the bit.
    Kernels launched outside ATen (ctypes) are not seen."""
    total = _AtenFlops()
    with _flop_mode(total):
        yield total


def annotate(name: str):
    """A named region on the profiler's timeline (host and card)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling window of step intervals: :meth:`tick` once a step, after
    a sync point, records the time since the previous tick."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times = collections.deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
        self._last = now
        return dt

    def add(self, dt: float) -> None:
        self.times.append(float(dt))

    def reset(self) -> None:
        self._last = None

    def __len__(self) -> int:
        return len(self.times)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def rate(self, samples_per_interval: float = 1.0) -> float:
        """Samples a second over the window (steps with the default)."""
        return samples_per_interval / self.mean if self.mean else 0.0

    def percentile(self, q: float) -> float:
        """The window's ``q`` quantile, ``q`` a fraction in [0, 1]."""
        return percentile(self.times, q * 100.0)

    def summary(self) -> dict:
        return {
            "step_time_mean_s": self.mean,
            "step_time_p50_s": self.percentile(0.50),
            "step_time_p95_s": self.percentile(0.95),
            "steps_timed": len(self.times),
        }
