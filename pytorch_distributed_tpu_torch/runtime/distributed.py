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

The flat-tensor collectives follow torch's per-rank shapes, which are the
JAX facade's under its multi-process backend: ``all_gather_into_tensor``
concatenates the ranks' tensors along dim 0, ``reduce_scatter_tensor``
returns this rank's reduced block of dim 0, ``reduce_scatter`` this
rank's reduced row of a ``[world, ...]`` input, and ``all_to_all`` sends
block ``j`` of dim 0 to rank ``j`` and returns the blocks it received in
rank order (``all_to_all_single`` with split sizes, for blocks that
differ in size).

The rest of the JAX facade: ``permute`` (point-to-point block exchange
over ``batch_isend_irecv``; a rank that no pair names receives zeros, as
under ``ppermute``), ``gather``/``reduce`` to one rank, ``scatter`` from
one, ``monitored_barrier``, the object collectives, and ``new_group``
subgroups, which ``all_reduce``, ``all_gather``, ``broadcast``,
``barrier``, ``gather``, ``reduce`` and ``permute`` take as ``group=``
(ranks in a subgroup's collectives are global ranks, as in the JAX
facade). ``permute`` and ``all_to_all`` have differentiable forms
(``permute_grad``, ``all_to_all_grad``: the backward is the inverse
exchange) for sequence-parallel attention.
"""

from __future__ import annotations

import datetime
import enum
import os
from typing import List, Optional, Sequence, Tuple

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
    from pytorch_distributed_tpu_torch.runtime.mesh import clear_current_mesh

    clear_current_mesh()   # its DeviceMesh's groups die with the world
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


class Subgroup:
    """Handle from :func:`new_group`: collectives over a subset of the
    world's ranks (``ranks``, sorted global ranks). ``group`` is torch's
    process group on the members and None on the others, whose
    collectives on it refuse."""

    def __init__(self, ranks: Tuple[int, ...], group, member: bool):
        self.ranks = ranks
        self.group = group
        self.is_member = member

    @property
    def size(self) -> int:
        return len(self.ranks)

    def close(self) -> None:
        if self.group is not None:
            dist.destroy_process_group(self.group)
            self.group = None


def new_group(ranks: Sequence[int], *, timeout_s: float = 60.0) -> Subgroup:
    """``torch.distributed.new_group``: a subgroup of the world. Every
    rank must call it with the same ``ranks`` in the same order, members
    or not (torch's contract, and the JAX facade's)."""
    rs = tuple(sorted(int(r) for r in ranks))
    if not rs:
        raise ValueError("new_group needs at least one rank")
    if len(set(rs)) != len(rs):
        raise ValueError(f"ranks must be unique, got {rs}")
    world = get_world_size()
    if rs[0] < 0 or rs[-1] >= world:
        raise ValueError(f"ranks {rs} out of range for world size {world}")
    if not dist.is_initialized():
        raise RuntimeError("new_group needs a process group: call "
                           "init_process_group() first")
    pg = dist.new_group(list(rs),
                        timeout=datetime.timedelta(seconds=timeout_s))
    member = get_rank() in rs
    return Subgroup(rs, pg if member else None, member)


def _pg(group, what: str):
    """torch's process group for ``group``: None (the world), a
    :class:`Subgroup`, or torch's own process group (a ``DeviceMesh``
    dim's ``get_group()``), passed through."""
    if group is None or not isinstance(group, Subgroup):
        return group
    if not group.is_member:
        raise RuntimeError(f"{what} on a subgroup this rank is not a "
                           f"member of (ranks={group.ranks})")
    if group.group is None:
        raise RuntimeError(f"{what} on a closed subgroup")
    return group.group


def _size(group) -> int:
    if group is None:
        return get_world_size()
    if isinstance(group, Subgroup):
        return group.size
    return dist.get_world_size(group)


def all_reduce(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM, *,
               group: Optional[Subgroup] = None) -> torch.Tensor:
    """This rank's ``x`` reduced over every rank (of ``group``), in a new
    tensor of ``x``'s shape (``AVG``: the sum over the rank count)."""
    pg = _pg(group, "all_reduce")
    out = x.clone()
    n = _size(group)
    if n == 1:
        return out
    dist.all_reduce(out, op=_TORCH_OPS[ReduceOp.SUM if op is ReduceOp.AVG
                                       else op], group=pg)
    if op is ReduceOp.AVG:
        out = out / n
    return out


def broadcast(x: torch.Tensor, src: int = 0, *,
              group: Optional[Subgroup] = None) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (of ``group``; ``src`` is a
    global rank and must be a member), in a new tensor."""
    pg = _pg(group, "broadcast")
    if group is not None and src not in group.ranks:
        raise ValueError(f"src {src} not in group ranks {group.ranks}")
    if not 0 <= src < get_world_size():
        raise ValueError(
            f"src {src} out of range for {get_world_size()} ranks")
    out = x.clone()
    if _size(group) > 1:
        dist.broadcast(out, src=src, group=pg)
    return out


def barrier(group: Optional[Subgroup] = None) -> None:
    """Every rank (of ``group``) waits for the others."""
    pg = _pg(group, "barrier")
    if _size(group) > 1:
        dist.barrier(group=pg)


def monitored_barrier(timeout_s: Optional[float] = None) -> None:
    """``torch.distributed.monitored_barrier``: a barrier that names the
    ranks that did not arrive within ``timeout_s`` (the group's timeout
    unless given). gloo has it; under NCCL, whose own barrier already
    fails at the group's timeout, it is the plain barrier, and a
    ``timeout_s`` other than the group's is refused, as the JAX facade
    refuses one it cannot honour."""
    if get_world_size() == 1:
        return
    if get_backend() == "gloo":
        kw = {} if timeout_s is None else dict(
            timeout=datetime.timedelta(seconds=timeout_s))
        dist.monitored_barrier(**kw)
        return
    if timeout_s is not None:
        raise NotImplementedError(
            f"per-call timeout {timeout_s}s: the {get_backend()} barrier "
            "fails at the group's timeout; pass timeout_s to "
            "init_process_group instead")
    dist.barrier()


def all_gather(x: torch.Tensor, *,
               group: Optional[Subgroup] = None) -> torch.Tensor:
    """``[n, *x.shape]``: every rank's ``x`` in rank order (the JAX
    facade's rows; with ``group`` its members' in member order);
    ``x[None]`` in a world of one."""
    pg = _pg(group, "all_gather")
    n = _size(group)
    if n == 1:
        return x[None].clone()
    out = x.new_empty((n,) + tuple(x.shape))
    dist.all_gather(list(out.unbind(0)), x.contiguous(), group=pg)
    return out


def gather(x: torch.Tensor, dst: int = 0, *,
           group: Optional[Subgroup] = None) -> Optional[torch.Tensor]:
    """``torch.distributed.gather``: ``[n, *x.shape]``, every rank's ``x``
    in rank order, on rank ``dst`` (a global rank); None on the others.
    The JAX facade returns the rows everywhere (one controller holds
    every shard); rank ``dst``'s result is its value."""
    pg = _pg(group, "gather")
    if group is not None and dst not in group.ranks:
        raise ValueError(f"dst {dst} not in group ranks {group.ranks}")
    n = _size(group)
    if n == 1:
        return x[None].clone()
    out = x.new_empty((n,) + tuple(x.shape)) if get_rank() == dst else None
    dist.gather(x.contiguous(),
                list(out.unbind(0)) if out is not None else None,
                dst=dst, group=pg)
    return out


def reduce(x: torch.Tensor, dst: int = 0, op: ReduceOp = ReduceOp.SUM, *,
           group: Optional[Subgroup] = None) -> Optional[torch.Tensor]:
    """``torch.distributed.reduce``: ``x`` reduced over every rank (of
    ``group``) on rank ``dst``, None on the others (the JAX facade's
    value on ``dst``)."""
    pg = _pg(group, "reduce")
    if group is not None and dst not in group.ranks:
        raise ValueError(f"dst {dst} not in group ranks {group.ranks}")
    n = _size(group)
    out = x.clone()
    if n > 1:
        dist.reduce(out, dst=dst, op=_TORCH_OPS[
            ReduceOp.SUM if op is ReduceOp.AVG else op], group=pg)
        if get_rank() != dst:
            return None
    if op is ReduceOp.AVG:
        out = out / n
    return out


def scatter(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``torch.distributed.scatter``: ``x`` is ``[world, ...]`` (rank
    ``src``'s rows; every other rank passes a tensor of that shape, whose
    contents are not read); returns row ``rank`` of rank ``src``'s ``x``
    (the JAX facade's row)."""
    world = get_world_size()
    if not 0 <= src < world:
        raise ValueError(f"src {src} out of range for {world} ranks")
    if x.shape[0] != world:
        raise ValueError(f"scatter input has {x.shape[0]} rows for "
                         f"world_size {world}")
    if world == 1:
        return x[0].clone()
    out = x.new_empty(tuple(x.shape[1:]))
    rows = [r.contiguous() for r in x.unbind(0)] if get_rank() == src \
        else None
    dist.scatter(out, rows, src=src)
    return out


def _check_perm(perm, n: int) -> List[Tuple[int, int]]:
    pairs = [(int(s), int(d)) for s, d in perm]
    for s, d in pairs:
        if not (0 <= s < n and 0 <= d < n):
            raise ValueError(f"perm pair ({s},{d}) out of range for {n}")
    srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"perm {pairs}: a rank sends or receives twice")
    return pairs


def permute(x: torch.Tensor, perm, *,
            group: Optional[Subgroup] = None) -> torch.Tensor:
    """Point-to-point block exchange: for each ``(src, dst)`` pair, rank
    ``dst`` receives rank ``src``'s ``x`` (ranks index the members of
    ``group`` in order, or the world). A rank that no pair names as
    ``dst`` gets zeros, as under the JAX facade's ``ppermute``. The sends
    and receives go out together (``batch_isend_irecv``)."""
    pg = _pg(group, "permute")
    n = _size(group)
    pairs = _check_perm(perm, n)
    if group is None:
        me, glob = get_rank(), (lambda r: r)
    elif isinstance(group, Subgroup):
        me, glob = group.ranks.index(get_rank()), group.ranks.__getitem__
    else:
        me = dist.get_rank(pg)
        glob = lambda r: dist.get_global_rank(pg, r)  # noqa: E731
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for s, d in pairs:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x, glob(d), group=pg))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, glob(s), group=pg))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pairs, group):
        ctx.pairs, ctx.group = pairs, group
        return permute(x, pairs, group=group)

    @staticmethod
    def backward(ctx, grad):
        inverse = [(d, s) for s, d in ctx.pairs]
        return permute(grad, inverse, group=ctx.group), None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=_pg(ctx.group, "sum_grad"))
        return grad, None


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, whose gradient autograd sums over ``group`` (a
    :class:`Subgroup` or torch's process group): Megatron's ``f``, for a
    tensor every rank computes whole but each rank's loss reaches only
    through its own part."""
    return _SumGrad.apply(x, group)


class _SumOutputs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=_pg(group, "sum_outputs"))
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_outputs(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (a :class:`Subgroup` or torch's process
    group), whose gradient goes back to every rank as it is: Megatron's
    ``g``, for the partial results of a layer split over the ranks (each
    rank's experts, or its share of their hidden units) that every rank
    then uses whole. The pair of :func:`sum_grad` on the layer's input."""
    return _SumOutputs.apply(x, group)


def permute_grad(x: torch.Tensor, perm, *,
                 group: Optional[Subgroup] = None) -> torch.Tensor:
    """:func:`permute` that autograd differentiates: the gradient goes
    back along the inverse pairs (a rank that sent nothing gets zeros)."""
    return _Permute.apply(x, _check_perm(perm, _size(group)), group)


def _flat_collective(*names):
    """The first of torch's names for a flat-tensor collective that this
    torch has (newer releases rename ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor`` to ``*_single``)."""
    for name in names:
        fn = getattr(dist, name, None)
        if fn is not None:
            return fn
    raise NotImplementedError(f"torch.distributed has none of {names}")


def all_gather_into_tensor(x: torch.Tensor) -> torch.Tensor:
    """``[world * x.shape[0], ...]``: every rank's ``x`` concatenated
    along dim 0 in rank order (``x`` itself in a world of one)."""
    if get_world_size() == 1:
        return x.clone()
    out = x.new_empty((get_world_size() * x.shape[0],) + tuple(x.shape[1:]))
    _flat_collective("all_gather_single", "all_gather_into_tensor")(
        out, x.contiguous())
    return out


def reduce_scatter_tensor(x: torch.Tensor,
                          op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """This rank's block of dim 0 of ``x`` (``[world * n, ...]``) reduced
    over every rank: ``[n, ...]`` (``AVG``: the sum over the world size)."""
    world = get_world_size()
    if x.shape[0] % world:
        raise ValueError(f"reduce_scatter_tensor input dim 0 ({x.shape[0]}) "
                         f"must divide by world_size {world}")
    if world == 1:
        return x.clone()
    out = x.new_empty((x.shape[0] // world,) + tuple(x.shape[1:]))
    _flat_collective("reduce_scatter_single", "reduce_scatter_tensor")(
        out, x.contiguous(),
        op=_TORCH_OPS[ReduceOp.SUM if op is ReduceOp.AVG else op])
    if op is ReduceOp.AVG:
        out = out / world
    return out


def reduce_scatter(x: torch.Tensor,
                   op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """Row ``rank`` of ``x`` (``[world, ...]``: row ``j`` is this rank's
    contribution to rank ``j``) summed over every rank. SUM only, as in
    the JAX facade."""
    if op is not ReduceOp.SUM:
        raise NotImplementedError("reduce_scatter supports SUM")
    if x.shape[0] != get_world_size():
        raise ValueError(f"reduce_scatter input has {x.shape[0]} rows for "
                         f"world_size {get_world_size()}")
    return reduce_scatter_tensor(x.reshape((-1,) + tuple(x.shape[2:]))
                                 ).reshape(x.shape[1:])


def all_to_all_single(x: torch.Tensor, output_split_sizes=None,
                      input_split_sizes=None) -> torch.Tensor:
    """Block ``j`` of ``x``'s dim 0 (``input_split_sizes[j]`` rows, equal
    blocks unless given) goes to rank ``j``; returns the blocks received,
    in rank order (``output_split_sizes[j]`` rows from rank ``j``)."""
    world = get_world_size()
    if output_split_sizes is None:
        if x.shape[0] % world:
            raise ValueError(f"all_to_all needs dim 0 ({x.shape[0]}) "
                             f"divisible by world_size {world}")
        rows = x.shape[0]
    else:
        if len(output_split_sizes) != world:
            raise ValueError("output_split_sizes needs one size per rank")
        rows = int(sum(output_split_sizes))
    if world == 1:
        return x.clone()
    out = x.new_empty((rows,) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), output_split_sizes,
                           input_split_sizes)
    return out


def all_to_all(x: torch.Tensor, *, group=None) -> torch.Tensor:
    """``all_to_all_single`` with equal blocks: the JAX facade's
    ``all_to_all`` row for this rank. ``group``: a :class:`Subgroup` or
    torch's process group (a ``DeviceMesh`` dim's, say)."""
    if group is None:
        return all_to_all_single(x)
    pg = _pg(group, "all_to_all")
    n = _size(group)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all needs dim 0 ({x.shape[0]}) "
                         f"divisible by the group's {n} ranks")
    if n == 1:
        return x.clone()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=pg)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group=group)

    @staticmethod
    def backward(ctx, grad):
        # an equal-block all-to-all is its own inverse
        return all_to_all(grad, group=ctx.group), None


def all_to_all_grad(x: torch.Tensor, *, group=None) -> torch.Tensor:
    """:func:`all_to_all` that autograd differentiates (the backward is
    the same exchange of the gradient's blocks)."""
    return _AllToAll.apply(x, group)


# --------------------------------------------------------------------------
# Object collectives: picklable objects, one per process, returned (torch
# fills lists in place).
# --------------------------------------------------------------------------


def all_gather_object(obj) -> list:
    """Every rank's ``obj`` (picklable, any size), in rank order."""
    if get_world_size() == 1:
        return [obj]
    out = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object_list(objs: list, src: int = 0) -> list:
    """Rank ``src``'s list on every rank (every rank passes a list of the
    same length); returned rather than filled in place."""
    if not 0 <= src < get_world_size():
        raise ValueError(
            f"src {src} out of range for {get_world_size()}-process world")
    out = list(objs)
    if get_world_size() > 1:
        dist.broadcast_object_list(out, src=src)
    return out


def scatter_object_list(objs: Optional[list], src: int = 0):
    """Rank ``src`` passes one object per rank; each rank gets its own.
    The other ranks may pass None."""
    world = get_world_size()
    if not 0 <= src < world:
        raise ValueError(f"src {src} out of range for {world}-process world")
    if get_rank() == src and (objs is None or len(objs) != world):
        raise ValueError(
            f"src must pass exactly {world} objects, got "
            f"{None if objs is None else len(objs)}")
    if world == 1:
        return objs[0]
    out = [None]
    dist.scatter_object_list(out, objs if get_rank() == src else None,
                             src=src)
    return out[0]


# --------------------------------------------------------------------------
# The stage link: tagged point-to-point hand-offs of host tensors between
# the stages of a host-dispatched pipeline (parallel/pipeline_schedule.py).
# --------------------------------------------------------------------------

#: torch's message tags of the link's three kinds of message, so that a
#: fingerprint, a payload and a verdict never match one another's receive
_FP_TAG, _PAYLOAD_TAG, _VERDICT_TAG = 1, 2, 3
#: bytes of a debug fingerprint (the JAX hostring's DETAIL handshake's)
FINGERPRINT_BYTES = 96


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


class StageLink:
    """Tagged sends and receives of host (CPU) tensors between pipeline
    stages over a gloo process group: the port's counterpart of the JAX
    hostring's ``send``/``recv``. Stage ``i`` is the ``i``-th rank of
    ``group`` (a :class:`Subgroup`, torch's process group, or None for
    the world). Tags name the message (``act.m{mb}.s{stage}``,
    ``grad.m{mb}.s{stage}``, ``tied.wte.grad``, ``tied.wte.param``).

    Hand-offs go through host memory, as the JAX executor hands numpy
    arrays over its ring: two stage processes can then share one card,
    which NCCL refuses. Each ordered pair of stages holds one message in
    flight, the ring's one-slot mailbox: :meth:`send` posts its message
    and returns, and the next send to the same stage first waits until
    the last one was received (``simulate_links`` proves that the
    schedules drain under exactly that). :meth:`flush` waits for every
    posted send; call it before the link is dropped (gloo abandons a
    send whose work is destroyed before its receive was posted).

    With ``debug=True`` a fingerprint of the transfer
    (``p2p|shape|dtype|src->dst|tag``, the hostring's DETAIL handshake)
    goes ahead of each payload, and the receiver sends its own back as
    its verdict: on a mismatch the receiver raises ``RuntimeError``
    ("P2P mismatch", both descriptions) at once and the sender when it
    next waits on that stage (its next send there, or :meth:`flush`). The
    verdict travels behind the payload, so debug mode keeps the one-slot
    semantics and the schedules drain as without it."""

    def __init__(self, group=None, *, debug: bool = False):
        if not dist.is_initialized():
            raise RuntimeError("StageLink needs a process group: call "
                               "init_process_group() first")
        self.pg = _pg(group, "StageLink")
        if group is None:
            self.ranks = tuple(range(get_world_size()))
        elif isinstance(group, Subgroup):
            self.ranks = group.ranks
        else:
            self.ranks = tuple(dist.get_global_rank(group, i)
                               for i in range(dist.get_world_size(group)))
        if dist.get_backend(self.pg) != "gloo":
            raise ValueError(
                "StageLink hands host tensors over a gloo group, got "
                f"{dist.get_backend(self.pg)!r}")
        self.stage = self.ranks.index(get_rank())
        self.debug = debug
        self._posted = {}   # peer stage -> its message in flight

    @property
    def size(self) -> int:
        return len(self.ranks)

    def _fingerprint(self, t: torch.Tensor, src: int, dst: int,
                     tag: str) -> torch.Tensor:
        sig = (f"p2p|{tuple(t.shape)}|{_dtype_name(t.dtype)}|{src}->{dst}"
               f"|{tag}").encode()[:FINGERPRINT_BYTES]
        fp = torch.zeros(FINGERPRINT_BYTES, dtype=torch.uint8)
        fp[:len(sig)] = torch.frombuffer(bytearray(sig), dtype=torch.uint8)
        return fp

    @staticmethod
    def _text(fp: torch.Tensor) -> str:
        return bytes(fp.tolist()).rstrip(b"\x00").decode(errors="replace")

    def _settle(self, peer: int) -> None:
        """Wait for the message in flight to ``peer``: its verdict first
        (debug), then its payload's delivery."""
        posted = self._posted.pop(peer, None)
        if posted is None:
            return
        fp, verdict, verdict_work, works, _payload = posted
        if verdict_work is not None:
            verdict_work.wait()
            if not torch.equal(fp, verdict):
                raise RuntimeError(
                    f"P2P mismatch (StageLink debug): rank {get_rank()} "
                    f"sent {self._text(fp)}; peer expects "
                    f"{self._text(verdict)}")
        for w in works:
            w.wait()

    def send(self, x: torch.Tensor, dst: int, *, tag: str = "") -> None:
        """Post host tensor ``x`` to stage ``dst`` (kept alive until it is
        received). Returns once the previous message to ``dst`` has been
        received, without waiting for this one."""
        from pytorch_distributed_tpu_torch.runtime import tracing

        if x.device.type != "cpu":
            raise ValueError(f"StageLink sends host tensors, got {x.device}")
        x = x.contiguous()
        self._settle(dst)
        peer = self.ranks[dst]
        span = (tracing._NULL_SPAN if tracing._tracer is None else
                tracing.span("comm.send", peer=dst, tag=tag,
                             bytes=x.numel() * x.element_size()))
        with span:
            fp = verdict = verdict_work = None
            works = []
            if self.debug:
                fp = self._fingerprint(x, self.stage, dst, tag)
                verdict = torch.empty_like(fp)
                works.append(dist.isend(fp, peer, group=self.pg,
                                        tag=_FP_TAG))
                verdict_work = dist.irecv(verdict, peer, group=self.pg,
                                          tag=_VERDICT_TAG)
            works.append(dist.isend(x, peer, group=self.pg,
                                    tag=_PAYLOAD_TAG))
        # the payload stays referenced until its send completes
        self._posted[dst] = (fp, verdict, verdict_work, works, x)

    def recv(self, proto: torch.Tensor, src: int, *,
             tag: str = "") -> torch.Tensor:
        """The next message from stage ``src``, a new host tensor shaped
        as ``proto``."""
        from pytorch_distributed_tpu_torch.runtime import tracing

        peer = self.ranks[src]
        out = torch.empty(tuple(proto.shape), dtype=proto.dtype)
        span = (tracing._NULL_SPAN if tracing._tracer is None else
                tracing.span("comm.recv", peer=src, tag=tag,
                             bytes=out.numel() * out.element_size()))
        with span:
            if self.debug:
                mine = self._fingerprint(out, src, self.stage, tag)
                theirs = torch.empty_like(mine)
                dist.recv(theirs, peer, group=self.pg, tag=_FP_TAG)
                dist.send(mine, peer, group=self.pg, tag=_VERDICT_TAG)
                if not torch.equal(mine, theirs):
                    raise RuntimeError(
                        f"P2P mismatch (StageLink debug): rank "
                        f"{get_rank()} expects {self._text(mine)}; peer "
                        f"sent {self._text(theirs)}")
            dist.recv(out, peer, group=self.pg, tag=_PAYLOAD_TAG)
        return out

    def flush(self) -> None:
        """Wait for every posted send (and, in debug mode, its verdict)."""
        for peer in list(self._posted):
            self._settle(peer)
