"""Parallelism strategies of the port: data parallelism (DDP, ZeRO-1,
FSDP) and the compressed gradient sync."""

from pytorch_distributed_tpu_torch.parallel.ddp import (
    compress_hook,
    no_sync,
    sync_grads,
)
from pytorch_distributed_tpu_torch.parallel.strategies import (
    FSDP,
    DataParallel,
    ZeRO1,
)

__all__ = ["DataParallel", "ZeRO1", "FSDP", "compress_hook", "no_sync",
           "sync_grads"]
