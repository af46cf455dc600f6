"""The process-group facade on real ``torch.distributed``: the port of
``pytorch_distributed_tpu/runtime/distributed.py``.

The JAX facade is single-controller: one process drives every device,
and a collective takes one array whose leading dim indexes the
participants (``all_reduce(x)`` reduces ``x[0], x[1], ...``). The port is
one process per rank, as torch is: each rank passes its own tensor, and
gets back a tensor of that shape. So rank ``r``'s result here is the JAX
facade's result for the row ``x[r]``.

``init_process_group`` takes its world from one of three places:

* an explicit ``store`` (``torch.distributed.TCPStore`` on localhost,
  say) with ``world_size`` and ``rank``, or an ``init_method`` URL;
* torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``; ``LOCAL_RANK`` picks the card);
* neither: a world of one, this process, on an in-memory store.

The backend is NCCL when the device is a CUDA card and gloo on the CPU.
Until a group exists, ``get_world_size()`` is 1 and ``get_rank()`` 0.
"""

from __future__ import annotations

import datetime
import enum
import os
from typing import Optional

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.runtime.device import DeviceLike


class ReduceOp(enum.Enum):
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PRODUCT = "product"


_TORCH_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
}


def rank_device(device: DeviceLike = None) -> torch.device:
    """The rank's device: as given, else the card ``LOCAL_RANK`` names."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU (a gloo group)"
        )
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def init_process_group(
    backend: Optional[str] = None,
    *,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    store=None,
    init_method: Optional[str] = None,
    device: DeviceLike = None,
    timeout_s: float = 120.0,
) -> str:
    """Join (or make) the world; returns the backend. See the module
    docstring for where the world comes from. ``device`` is this rank's
    device (the card unless given); NCCL groups make it the current
    card."""
    if dist.is_initialized():
        raise RuntimeError(
            "a process group already exists; destroy_process_group() first"
        )
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None or init_method is not None:
        if world_size is None or rank is None:
            raise ValueError("an explicit store or init_method needs "
                             "world_size and rank")
        kw.update(store=store, init_method=init_method,
                  world_size=world_size, rank=rank)
    elif "RANK" in os.environ:
        kw.update(init_method="env://",
                  world_size=int(os.environ["WORLD_SIZE"]),
                  rank=int(os.environ["RANK"]))
    else:
        if (world_size or 1) != 1 or (rank or 0) != 0:
            raise ValueError(
                "a world of more than one process needs a store, an "
                "init_method or torchrun's RANK/WORLD_SIZE environment"
            )
        kw.update(store=dist.HashStore(), world_size=1, rank=0)
    dist.init_process_group(**kw)
    return backend


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_backend() -> str:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_process_group()")
    return dist.get_backend()


def all_reduce(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """This rank's ``x`` reduced over every rank, in a new tensor of
    ``x``'s shape (``AVG``: the sum over the world size)."""
    out = x.clone()
    if get_world_size() == 1:
        return out
    dist.all_reduce(out, op=_TORCH_OPS[ReduceOp.SUM if op is ReduceOp.AVG
                                       else op])
    if op is ReduceOp.AVG:
        out = out / get_world_size()
    return out


def broadcast(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank, in a new tensor."""
    if not 0 <= src < get_world_size():
        raise ValueError(
            f"src {src} out of range for {get_world_size()} ranks")
    out = x.clone()
    if get_world_size() > 1:
        dist.broadcast(out, src=src)
    return out


def barrier() -> None:
    if get_world_size() > 1:
        dist.barrier()


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``[world, *x.shape]``: every rank's ``x`` in rank order (the JAX
    facade's rows); ``x[None]`` in a world of one."""
    if get_world_size() == 1:
        return x[None].clone()
    out = x.new_empty((get_world_size(),) + tuple(x.shape))
    dist.all_gather(list(out.unbind(0)), x.contiguous())   # views of out
    return out
