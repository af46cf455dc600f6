"""Dataclass configs with CLI overrides: the port's own copy of
``pytorch_distributed_tpu/utils/config.py``.

A recipe declares one dataclass (subclassing :class:`RecipeConfig`, the
fields every recipe shares); :func:`parse_cli` makes one ``--flag`` per
field (its type and default from the dataclass, its help from a
trailing ``# doc:`` comment) and builds the config from the command
line::

    @dataclasses.dataclass
    class Config(RecipeConfig):
        lr: float = 0.1          # doc: peak learning rate

    cfg = parse_cli(Config)      # python -m recipe --lr 0.4 --dp 4

The fields are the JAX package's, with the port's values where the two
differ: ``backend`` is ``nccl`` or ``gloo``, ``data_dir`` is unset by
default (synthetic data unless given), ``profile_dir`` takes a
``torch.profiler`` trace, and ``trace_dir`` the span tracer's.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import re
import typing
from typing import Optional, Sequence, Type, TypeVar

T = TypeVar("T")

_FIELD_DOC = re.compile(r"#\s*doc:\s*(.*)")


@dataclasses.dataclass
class RecipeConfig:
    """Fields shared by every recipe."""

    backend: Optional[str] = None  # doc: nccl|gloo (default: the device's own)
    epochs: int = 1  # doc: training epochs
    batch_size: int = 128  # doc: GLOBAL batch size (split over the ranks)
    lr: float = 0.1  # doc: peak learning rate
    dp: int = -1  # doc: data-parallel width (-1: every rank)
    fsdp: int = 1  # doc: fully-sharded axis width
    tp: int = 1  # doc: tensor-parallel axis width
    seed: int = 0  # doc: global seed
    data_dir: Optional[str] = None  # doc: dataset root (synthetic data when unset)
    synthetic: bool = False  # doc: force synthetic data
    steps_per_epoch: Optional[int] = None  # doc: truncate epochs
    ckpt_dir: Optional[str] = None  # doc: checkpoint directory (enables resume)
    ckpt_every_steps: Optional[int] = None  # doc: mid-epoch checkpoint cadence
    keep_checkpoints: Optional[int] = None  # doc: retain newest N step-tagged checkpoints
    keep_best: Optional[str] = None  # doc: eval metric to track as the 'best' checkpoint
    best_mode: str = "max"  # doc: 'max' (accuracy-like) or 'min' (loss-like)
    async_checkpoint: bool = False  # doc: overlap checkpoint IO with training
    log_every: int = 50  # doc: steps between metric logs
    profile_dir: Optional[str] = None  # doc: write a torch.profiler trace of the run here
    metrics_path: Optional[str] = None  # doc: JSONL scalar metrics log
    trace_dir: Optional[str] = None  # doc: span-tracer output dir (trace.json + JSONL rollups)


def _field_docs(cls: type) -> dict:
    """The ``# doc:`` trailing comments of a dataclass's fields."""
    docs = {}
    try:
        src = inspect.getsource(cls)
    except (OSError, TypeError):
        return docs
    for line in src.splitlines():
        m = _FIELD_DOC.search(line)
        if m:
            name = line.split(":")[0].strip()
            if name.isidentifier():
                docs[name] = m.group(1).strip()
    return docs


def _add_field_arg(parser: argparse.ArgumentParser, f, doc: str) -> None:
    flag = "--" + f.name.replace("_", "-")
    default = (f.default if f.default is not dataclasses.MISSING
               else f.default_factory())  # type: ignore[misc]
    ftype = f.type
    if isinstance(ftype, str):   # "Optional[int]" under future annotations
        m = re.match(r"Optional\[(\w+)\]", ftype)
        inner = m.group(1) if m else ftype
        ftype = {"int": int, "float": float, "str": str,
                 "bool": bool}.get(inner, str)
    elif typing.get_origin(ftype) is typing.Union:
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        ftype = args[0] if args else str
    if ftype is bool:
        if default:
            parser.add_argument(flag.replace("--", "--no-", 1), dest=f.name,
                                action="store_false",
                                help=f"disable: {doc}" if doc else None)
        else:
            parser.add_argument(flag, action="store_true", help=doc or None)
    else:
        parser.add_argument(flag, type=ftype, default=default,
                            help=doc or " ")


def parse_cli(cls: Type[T], argv: Optional[Sequence[str]] = None,
              description: str = "") -> T:
    """``cls`` built from the command line, one ``--flag`` per field."""
    parser = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    docs = {}
    for klass in reversed(cls.__mro__):
        if dataclasses.is_dataclass(klass):
            docs.update(_field_docs(klass))
    for f in dataclasses.fields(cls):  # type: ignore[arg-type]
        _add_field_arg(parser, f, docs.get(f.name, ""))
    return cls(**vars(parser.parse_args(argv)))
