"""Rank-0 logging for the port.

Only the first process of a ``torch.distributed`` group emits records,
the analogue of the reference recipes' ``if rank == 0: print(...)``. The
rank is read when a record is emitted, not when a logger is made:
modules make their loggers at import, before any process group exists.
"""

from __future__ import annotations

import logging
import sys

_ROOT = "pytorch_distributed_tpu_torch"
_CONFIGURED = False


class _Rank0Filter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
        return True


def _configure_root() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    handler.addFilter(_Rank0Filter())
    root = logging.getLogger(_ROOT)
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    """Logger that is silent on non-zero ranks."""
    _configure_root()
    return logging.getLogger(name)
