"""Parallelism strategies of the port: data parallelism so far."""

from pytorch_distributed_tpu_torch.parallel.strategies import (
    FSDP,
    DataParallel,
    ZeRO1,
)

__all__ = ["DataParallel", "ZeRO1", "FSDP"]
