"""Checkpoints both packages restore: the port of ``save_checkpoint``,
``restore_checkpoint`` and the sampler cursor of
``pytorch_distributed_tpu/train/checkpoint.py``.

The port writes its state under the JAX ``TrainState``'s leaf names and
in the JAX layouts (``interop.model_slots``, ``interop.optimizer_layout``):
``step``, ``params_...`` (Dense kernels ``[in, out]`` with heads as their
own axes, conv kernels ``[kh, kw, I, O]``, GPT-2's layers stacked on a
leading ``[L]``), ``batch_stats_...``, the fp16 loss scaler's
``scaler_state_scale`` (f32) and ``scaler_state_growth_tracker``
(int32) when the state has one, and ``opt_state_...`` (optax's
``mu``/``nu``/``count`` of ``chain(clip_by_global_norm, adamw)``, the
``trace`` and schedule ``count`` of ``sgd``), in the manifest format of
``train/ckpt_io.py``. So the JAX package's ``restore_checkpoint``, given
its own template, restores what the port wrote, and the port's
:func:`restore_checkpoint` restores what the JAX package wrote, each
leaf matched by name.

Sharded writes: every rank of the process group writes only the boxes
it owns, into one shared ``<tag>.tmp``: the replicated leaves
(parameters, statistics, counts, step) from rank 0, the optimizer
moments from the rank whose optimizer holds them. Under
``ZeroRedundancyOptimizer`` a rank owns whole parameters, so its
moments are whole leaves, or whole layers ``[i:i+1]`` of a stacked leaf:
boxes the manifest records as any other shard, with no gather. Then
rank 0 merges the ranks' manifests, writes the COMMIT marker and swings
the directory into place, between barriers of the process group. A
restore reads, on each rank, the parameters whole and the moments of
the parameters its optimizer now holds, at any world size.

Under FSDP every parameter and both its moments are DTensors, and a
rank holds rows of dim 0 (``runtime.mesh.row_shard``). Each rank writes
its own rows of each, in the JAX layout, as boxes of the JAX leaf
(``interop.Slot.row_boxes``: rows of ``q.weight [H * hd, D]`` are a head
range of the ``[D, H, hd]`` kernel, rows of ``down.weight [D, I]`` a
column range of the ``[I, D]`` one, a range that cuts a head a partial
box), so no leaf is ever gathered on one rank; under HSDP only the first
replica of each shard writes. A restore reads each rank's rows back out
of whatever boxes the writer's world cut, at any world size, and the
JAX package reads the leaves whole.

Under LoRA (``lora.LoRAModel``) the state is the adapter tree: the
params are the adapters under the JAX leaves ``<kernel path>/a`` and
``/b``, the moments theirs, and the frozen base is in no checkpoint (it
comes from its seed, as in the JAX recipe).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.runtime import distributed as dist
from pytorch_distributed_tpu_torch.runtime.mesh import row_shard
from pytorch_distributed_tpu_torch.train.ckpt_io import (  # noqa: F401
    _MANIFEST,
    CheckpointCorrupted,
    _assemble,
    _swing,
    checkpoint_exists,
    checkpoint_step,
    load_checkpoint,
    recover_stranded_checkpoints,
    resolve_tag,
    restore_candidates,
    step_tags,
    verify_checkpoint,
    write_manifest_and_commit,
    write_shard,
)
from pytorch_distributed_tpu_torch.train.train_state import TrainState
from pytorch_distributed_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class _Box:
    """One box of a leaf: which layer of a stack (or 0 for the whole
    leaf), its extent, how to read it off the port's state and how to
    put it back."""

    index: int
    start: Tuple[int, ...]
    stop: Tuple[int, ...]
    read: Callable[[], np.ndarray]
    write: Callable[[np.ndarray], None]


@dataclasses.dataclass
class _Leaf:
    name: str
    shape: Tuple[int, ...]
    dtype: np.dtype
    boxes: List[_Box]      # the boxes this rank reads (and writes)
    writes: bool           # this rank writes its boxes


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _tensor_box(slot: interop.Slot, get: Callable[[], torch.Tensor],
                put: Callable[[torch.Tensor], None], shape) -> _Box:
    """The box of a port tensor (or a moment shaped like one) at its
    slot, mapped to and from the JAX layout."""
    one = shape if slot.layer is None else shape[1:]
    lead = () if slot.layer is None else (slot.layer,)
    start = lead + (0,) * len(one)
    stop = (() if slot.layer is None else (slot.layer + 1,)) + tuple(one)

    def read():
        arr = slot.to_jax(_numpy(get()))
        return arr if slot.layer is None else arr[None]

    def write(arr):
        arr = arr if slot.layer is None else arr[0]
        put(torch.from_numpy(np.ascontiguousarray(slot.from_jax(arr))))

    return _Box(slot.layer or 0, start, stop, read, write)


def _row_boxes(slot: interop.Slot, param: torch.Tensor,
               get: Callable[..., torch.Tensor]) -> List[_Box]:
    """The boxes of this rank's rows of a tensor sharded (or not) as
    ``param`` is: ``get(create)`` returns the tensor itself (a moment not
    yet made reads as zeros, and is made in the optimizer's state when
    written), whose local rows are read and written in place."""
    local, first, _ = row_shard(param)
    n = local.shape[0]
    boxes = []
    for ra, rb, start, stop, to_jax, from_jax in (
            slot.row_boxes(first, first + n) if n else ()):
        lo, hi = ra - first, rb - first

        def read(lo=lo, hi=hi, to_jax=to_jax):
            arr = to_jax(_numpy(row_shard(get(False))[0][lo:hi]))
            return arr if slot.layer is None else arr[None]

        def write(arr, lo=lo, hi=hi, from_jax=from_jax):
            arr = arr if slot.layer is None else arr[0]
            rows = row_shard(get(True))[0][lo:hi]
            with torch.no_grad():
                rows.copy_(torch.from_numpy(
                    np.ascontiguousarray(from_jax(arr))).to(rows.dtype))

        boxes.append(_Box(slot.layer or 0, start, stop, read, write))
    return boxes


def _owned_params(optimizer) -> List[torch.Tensor]:
    _, local, _ = interop.unwrap_optimizer(optimizer)
    return [p for g in local.param_groups for p in g["params"]]


def _update_count(local) -> int:
    """optax's one update count, from torch's ``step`` per parameter;
    every parameter this rank's optimizer holds must agree."""
    steps = {int(s["step"]) for s in local.state.values() if "step" in s}
    if len(steps) > 1:
        raise ValueError(
            f"the optimizer's parameters took different numbers of steps "
            f"{sorted(steps)}: optax keeps one count")
    return steps.pop() if steps else 0


def _plan(state: TrainState) -> List[_Leaf]:
    """Every leaf of the port's state under its JAX name, with the boxes
    this rank writes (and reads back)."""
    model = getattr(state.model, "module", state.model)
    slots = interop.model_slots(model)
    layout = interop.optimizer_layout(state.optimizer)
    _, local, zero = interop.unwrap_optimizer(state.optimizer)
    sd = model.state_dict(keep_vars=True)
    rank0 = dist.get_rank() == 0
    leaves: Dict[str, _Leaf] = {}

    def add(name, shape, dtype, boxes, writes):
        # a stacked leaf takes one add per layer; under ZeRO a rank
        # writes the leaf when it owns any of them
        leaf = leaves.setdefault(name, _Leaf(name, tuple(shape),
                                             np.dtype(dtype), [], False))
        leaf.boxes.extend(boxes)
        leaf.writes = leaf.writes or (writes and bool(boxes))

    def writer(t, replicated):
        # a sharded tensor's first replica writes its rows; a replicated
        # one is rank 0's (or, under ZeRO, its owner's) to write
        return row_shard(t)[2] if isinstance(t, DTensor) else replicated

    for key, slot in slots.items():
        t = sd[key]
        shape = slot.leaf_shape(tuple(t.shape))
        if slot.perm is not None:
            boxes = _row_boxes(slot, t, lambda create, t=t: t)
        else:
            def put(x, t=t):
                with torch.no_grad():
                    t.copy_(x.to(t.dtype))

            boxes = [_tensor_box(slot, lambda t=t: t, put, shape)]
        add(interop.leaf_name(slot.tree, *slot.path), shape, np.float32,
            boxes, writer(t, rank0))

    # moments: the parameters this rank's optimizer holds (all of them
    # unless ZeRO shards the optimizer over the ranks; under FSDP this
    # rank's rows of every one)
    owned = {id(p) for p in _owned_params(state.optimizer)}
    for p_name, p in model.named_parameters():
        if not p.requires_grad:   # a frozen base (LoRA): not in the state
            continue
        slot = slots[p_name]
        shape = slot.leaf_shape(tuple(p.shape))
        for key, prefix in layout.moments.items():
            name = interop.leaf_name(*prefix, *slot.path)
            if id(p) not in owned:
                add(name, shape, np.float32, [], False)
                continue

            def get(create=False, p=p, key=key):
                s = local.state.get(p, {})
                if s.get(key) is not None:
                    return s[key]
                z = torch.zeros_like(p)
                if create:
                    local.state.setdefault(p, {})[key] = z
                return z

            def put(x, p=p, key=key):
                local.state.setdefault(p, {})[key] = x.to(
                    device=p.device, dtype=p.dtype)

            if slot.perm is not None:
                boxes = _row_boxes(slot, p, get)
            else:
                boxes = [_tensor_box(slot, get, put, shape)]
            add(name, shape, np.float32, boxes,
                writer(p, rank0 if zero is None else True))

    def scalar(name, value_fn, put):
        add(name, (), np.int32,
            [_Box(0, (), (), lambda: np.asarray(value_fn(), np.int32),
                  lambda arr: put(int(arr)))], rank0)

    def set_step(v):
        state.step = v

    scalar("step", lambda: state.step, set_step)
    if state.scaler_state is not None:
        # the fp16 loss scaler's device scalars, as the JAX ScalerState's
        # leaves: an f32 scale and an int32 growth tracker
        for field, dtype in (("scale", np.float32),
                             ("growth_tracker", np.int32)):
            def read(field=field, dtype=dtype):
                return np.asarray(
                    _numpy(getattr(state.scaler_state, field)), dtype)

            def write(arr, field=field, dtype=dtype):
                t = getattr(state.scaler_state, field)
                with torch.no_grad():
                    t.copy_(torch.from_numpy(np.asarray(arr, dtype)))

            add(interop.leaf_name("scaler_state", field), (), dtype,
                [_Box(0, (), (), read, write)], rank0)
    if layout.count is not None:
        def set_count(v):
            # torch's per-parameter step, as its AdamW makes it (a CPU
            # scalar); at 0 with zero moments it is a fresh optimizer's
            for p in _owned_params(state.optimizer):
                local.state.setdefault(p, {})["step"] = torch.tensor(
                    float(v), dtype=torch.float32)
        scalar(interop.leaf_name(*layout.count),
               lambda: _update_count(local), set_count)
    if layout.schedule_count is not None:
        def set_sched(v):
            local.count = v
        scalar(interop.leaf_name(*layout.schedule_count),
               lambda: local.count, set_sched)
    return [leaves[k] for k in sorted(leaves)]


def _write_rank_files(tmp: str, plan: List[_Leaf], rank: int,
                      step: int) -> None:
    entries = []
    for i, leaf in enumerate(plan):
        if not leaf.writes:
            continue
        shards = [
            write_shard(tmp, f"{i:05d}_{leaf.name[:72]}.p{rank}s{b.index}.npy",
                        np.asarray(b.read(), leaf.dtype), b.start, b.stop)
            for b in leaf.boxes
        ]
        if shards:
            entries.append({"path": leaf.name, "shape": list(leaf.shape),
                            "dtype": str(leaf.dtype), "shards": shards})
    with open(os.path.join(tmp, f"manifest-p{rank}.json"), "w") as f:
        json.dump({"version": 2, "step": step, "leaves": entries}, f)


def _merge_manifests(tmp: str) -> List[dict]:
    """The union of the ranks' manifests (each holds its own shards)."""
    merged: Dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(tmp, "manifest-p*.json"))):
        with open(path) as f:
            part = json.load(f)
        for e in part["leaves"]:
            if e["path"] in merged:
                merged[e["path"]]["shards"].extend(e["shards"])
            else:
                merged[e["path"]] = e
        os.unlink(path)
    return [merged[k] for k in sorted(merged)]


def save_checkpoint(ckpt_dir: str, state: TrainState, *,
                    tag: str = "latest") -> str:
    """Write ``state`` under ``ckpt_dir/tag``; returns the path. In a
    process group every rank must call it (each writes its own boxes;
    rank 0 commits)."""
    plan = _plan(state)
    rank = dist.get_rank()
    final = os.path.join(ckpt_dir, tag)
    tmp = final + ".tmp"
    step = int(state.step)
    if rank == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    dist.barrier()
    _write_rank_files(tmp, plan, rank, step)
    dist.barrier()
    if rank == 0:
        write_manifest_and_commit(tmp, _merge_manifests(tmp), step)
        _swing(ckpt_dir, tag, tmp)
    dist.barrier()
    return final


def restore_checkpoint(ckpt_dir: str, state: TrainState, *,
                       tag: str = "latest", strict: bool = True
                       ) -> TrainState:
    """Load checkpoint ``tag`` into ``state`` in place (its model, its
    optimizer and its step), every leaf matched by name; a checkpoint
    the JAX package wrote restores the same way. ``strict=False`` keeps
    the current value of a leaf the checkpoint lacks."""
    final = os.path.join(ckpt_dir, tag)
    with open(os.path.join(final, _MANIFEST)) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    plan = _plan(state)
    # moments of parameters a (ZeRO) rank does not hold stay unread
    for leaf in plan:
        entry = by_path.get(leaf.name)
        if entry is None:
            if strict:
                raise ValueError(
                    f"state leaf {leaf.name!r} not found in checkpoint "
                    f"{final} (strict=True)")
            continue
        if tuple(entry["shape"]) != leaf.shape:
            raise ValueError(
                f"leaf {leaf.name}: checkpoint shape {tuple(entry['shape'])}"
                f" != state shape {leaf.shape}")
        for box in leaf.boxes:
            box.write(_assemble(final, entry, box.start, box.stop,
                                np.dtype(entry["dtype"])))
    unused = set(by_path) - {leaf.name for leaf in plan}
    if unused:
        logger.warning("checkpoint has %d leaves the state lacks (ignored):"
                       " %s", len(unused), sorted(unused)[:5])
    return state


def checkpoint_diff(ckpt_dir: str, state: TrainState, *,
                    tag: str = "latest") -> Dict[str, float]:
    """``{leaf: max |state - checkpoint|}`` over the boxes of every leaf
    this rank holds (all zeros: the state is the checkpoint's, to the
    bit). A leaf the checkpoint lacks reads ``inf``."""
    final = os.path.join(ckpt_dir, tag)
    with open(os.path.join(final, _MANIFEST)) as f:
        by_path = {e["path"]: e for e in json.load(f)["leaves"]}
    out = {}
    for leaf in _plan(state):
        entry = by_path.get(leaf.name)
        if entry is None:
            out[leaf.name] = float("inf")
            continue
        err = 0.0
        for box in leaf.boxes:
            want = _assemble(final, entry, box.start, box.stop,
                             np.dtype(entry["dtype"]))
            got = np.asarray(box.read(), want.dtype)
            if got.shape != want.shape:
                err = float("inf")
                break
            if got.size:
                err = max(err, float(np.abs(got.astype(np.float64)
                                            - want).max()))
        out[leaf.name] = err
    return out


_SAMPLER_CURSOR = "sampler_cursor.json"


def save_sampler_cursor(ckpt_dir: str, *, step: int, epoch: int,
                        offset: int) -> str:
    """The data cursor beside the checkpoints: ``epoch`` and ``offset``
    name the batch the run takes next, ``step`` the train step it was
    written at (a resume trusts only a cursor of the restored step).
    One file, written atomically, newest wins."""
    path = os.path.join(ckpt_dir, _SAMPLER_CURSOR)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": int(step), "epoch": int(epoch),
                   "offset": int(offset)}, f)
    os.replace(tmp, path)
    return path


def load_sampler_cursor(ckpt_dir: str) -> Optional[dict]:
    """The saved data cursor, or None when absent or unreadable."""
    try:
        with open(os.path.join(ckpt_dir, _SAMPLER_CURSOR)) as f:
            rec = json.load(f)
        return {k: int(rec[k]) for k in ("step", "epoch", "offset")}
    except (OSError, ValueError, TypeError, KeyError):
        return None
