"""Crash-consistent checkpoint files: the port of the single-directory
format of ``pytorch_distributed_tpu/train/ckpt_io.py``, on disk byte for
byte as the JAX package writes and reads it.

``<ckpt_dir>/<tag>/`` holds shard ``.npy`` files, a ``manifest.json``
(version 2: per leaf its shape, dtype and shards, each shard its
``[start, stop)`` box of the leaf, byte length and checksum) and a
``COMMIT`` marker written last that records the manifest's own checksum.
A save lands in ``<tag>.tmp`` and swings into place with two renames
(:func:`_swing`); a directory without a readable manifest reads as
absent. The restore side walks candidates newest first
(:func:`restore_candidates`), finishes a swing a kill interrupted
(:func:`recover_stranded_checkpoints`) and checks every shard against
its recorded length and checksum (:func:`verify_checkpoint`).

The JAX package's per-rank sharded format (``rank-<r>/`` directories
under a ``WORLD_COMMIT``) belongs to its elastic engine, which is not
ported (ROADMAP A11): this module reads such a directory as absent,
and garbage-collects a ``.tmp`` of one that never got its
``WORLD_COMMIT``, as the JAX reader's two-phase rule does.

Fault sites: ``ckpt.write_shard`` after each shard file,
``ckpt.swing`` inside the rename window, ``ckpt.read_shard`` before
each shard read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.runtime import faults
from pytorch_distributed_tpu_torch.utils.integrity import (
    PREFERRED_ALGO,
    algo_supported,
    checksum_file,
)
from pytorch_distributed_tpu_torch.utils.logging import get_logger

_MANIFEST = "manifest.json"
_COMMIT = "COMMIT"  # written last: its presence means the dir is complete
_WORLD_COMMIT = "WORLD_COMMIT"  # the JAX package's sharded saves

logger = get_logger(__name__)


class CheckpointCorrupted(RuntimeError):
    """Checkpoints exist on disk but none survived the integrity checks;
    resuming fresh would discard, and later overwrite, the run's state."""


def _read_manifest(final: str) -> Optional[dict]:
    """The manifest of ``final``, or None when it is missing, truncated
    or not a manifest: a corrupt candidate reads as absent."""
    path = os.path.join(final, _MANIFEST)
    try:
        with open(path) as f:
            manifest = json.load(f)
        if not isinstance(manifest, dict) or "leaves" not in manifest:
            raise ValueError("not a checkpoint manifest")
        int(manifest["step"])
    except (OSError, ValueError, TypeError, KeyError) as e:
        if os.path.exists(path):
            logger.warning(
                "unreadable checkpoint manifest %s (%s): treating the "
                "checkpoint as absent", path, e,
            )
        return None
    return manifest


def _read_commit(final: str) -> Optional[dict]:
    """The COMMIT marker of ``final``, or None when absent or unreadable
    (checkpoints older than the integrity fields have none)."""
    try:
        with open(os.path.join(final, _COMMIT)) as f:
            commit = json.load(f)
        return commit if isinstance(commit, dict) else None
    except (OSError, ValueError):
        return None


def is_sharded_checkpoint(final: str) -> bool:
    """True when ``final`` is (or was meant to be) the JAX package's
    per-rank sharded save: no top-level manifest, but a WORLD_COMMIT or
    ``rank-<r>`` directories."""
    if os.path.isfile(os.path.join(final, _MANIFEST)):
        return False
    if os.path.isfile(os.path.join(final, _WORLD_COMMIT)):
        return True
    if not os.path.isdir(final):
        return False
    return any(
        name.startswith("rank-") and name[5:].isdigit()
        and os.path.isdir(os.path.join(final, name))
        for name in os.listdir(final)
    )


def checkpoint_exists(ckpt_dir: str, tag: str = "latest") -> bool:
    return os.path.exists(os.path.join(ckpt_dir, tag, _MANIFEST))


def checkpoint_step(ckpt_dir: str, tag: str = "latest") -> Optional[int]:
    """Step of ``tag``, or None when it is absent or cannot be restored
    here (a sharded save included)."""
    manifest = _read_manifest(os.path.join(ckpt_dir, tag))
    return None if manifest is None else int(manifest["step"])


def step_tags(ckpt_dir: str) -> List[int]:
    """Sorted step numbers of the ``step-<N>`` checkpoints present."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step-") and not name.endswith(".old"):
            try:
                out.append(int(name[len("step-"):]))
            except ValueError:
                continue
    return sorted(out)


def resolve_tag(ckpt_dir: str, tag: str = "latest") -> Optional[str]:
    """The tag to restore: a named tag only if it is restorable; the
    default ``latest`` resolves to the newest restorable checkpoint by
    step, ``latest`` or ``step-<N>`` (a hard kill can leave a stale
    ``latest`` beside newer step tags)."""
    if tag != "latest":
        return tag if checkpoint_step(ckpt_dir, tag) is not None else None
    best_tag, best_step = None, -1
    for cand in ["latest"] + [f"step-{s}" for s in step_tags(ckpt_dir)]:
        step = checkpoint_step(ckpt_dir, cand)
        if step is not None and step > best_step:
            best_tag, best_step = cand, step
    return best_tag


def verify_checkpoint(
    ckpt_dir: str, tag: str = "latest", *, deep: bool = True
) -> List[str]:
    """Integrity problems of checkpoint ``tag`` ([] when intact): the
    manifest is readable; the COMMIT marker, when present, matches the
    manifest's bytes and step; every shard exists at its recorded
    length; with ``deep``, every shard's checksum matches. Each problem
    names its file."""
    final = os.path.join(ckpt_dir, tag)
    if is_sharded_checkpoint(final):
        return [
            f"{final} is a per-rank sharded checkpoint, which this "
            "package does not read (ROADMAP A11)"
        ]
    manifest = _read_manifest(final)
    if manifest is None:
        return [f"manifest missing or unreadable in {final}"]
    problems = []
    commit = _read_commit(final)
    if commit is not None:
        algo = commit.get("checksum_algo", "")
        try:
            value, nbytes = checksum_file(
                os.path.join(final, _MANIFEST),
                algo if algo_supported(algo) else PREFERRED_ALGO,
            )
        except OSError as e:
            return [f"manifest unreadable in {final}: {e}"]
        if nbytes != commit.get("manifest_bytes"):
            problems.append("manifest length does not match COMMIT marker")
        elif algo_supported(algo) and value != commit.get(
                "manifest_checksum"):
            problems.append("manifest checksum does not match COMMIT marker")
        if int(commit.get("step", -1)) != int(manifest["step"]):
            problems.append("COMMIT step does not match manifest step")
    for entry in manifest["leaves"]:
        for shard in _entry_shards(entry):
            problem = _shard_problem(final, shard, deep=deep)
            if problem:
                problems.append(problem)
    return problems


def _shard_problem(final: str, shard: dict, *, deep: bool) -> Optional[str]:
    path = os.path.join(final, shard["file"])
    if not os.path.isfile(path):
        return f"shard {shard['file']} missing"
    nbytes = os.path.getsize(path)
    if "bytes" in shard and nbytes != shard["bytes"]:
        return (f"shard {shard['file']} truncated ({nbytes} bytes, "
                f"manifest says {shard['bytes']})")
    if deep and "checksum" in shard:
        algo = shard.get("checksum_algo", "crc32c")
        if algo_supported(algo):
            value, _ = checksum_file(path, algo)
            if value != shard["checksum"]:
                return f"shard {shard['file']} {algo} mismatch"
    return None


def _tag_names(ckpt_dir: str, tag: str) -> List[str]:
    """Directory names that could satisfy a restore of ``tag``, the
    ``.old`` leftovers of an interrupted swing included; ``latest``
    widens to every step tag."""
    if tag != "latest":
        return [tag, tag + ".old"]
    names = ["latest", "latest.old"]
    if os.path.isdir(ckpt_dir):
        for name in sorted(os.listdir(ckpt_dir)):
            base = name[:-len(".old")] if name.endswith(".old") else name
            if base.startswith("step-") and not base.endswith(".tmp"):
                names.append(name)
    return names


def restore_candidates(ckpt_dir: str, tag: str = "latest") -> List[str]:
    """Restorable directories for ``tag``, newest step first; an ``.old``
    directory ranks after a sibling of the same step. Unreadable
    manifests (and sharded saves) are left out."""
    ranked = []
    for name in _tag_names(ckpt_dir, tag):
        if not os.path.isdir(os.path.join(ckpt_dir, name)):
            continue
        step = checkpoint_step(ckpt_dir, name)
        if step is None:
            continue
        ranked.append((step, 0 if name.endswith(".old") else 1, name))
    return [name for _, _, name in sorted(ranked, reverse=True)]


def recover_stranded_checkpoints(ckpt_dir: str) -> List[str]:
    """Undo what a kill inside the save or the swing left behind:

    * ``<tag>.tmp`` with a COMMIT marker and shards that pass deep
      verification was fully written but never renamed: finish the
      swing (it is the newest state on disk). Verification comes first
      because the swing deletes ``<tag>.old``.
    * ``<tag>.old`` without ``<tag>``: the kill fell between the two
      renames and the tmp is unusable; promote the old directory back.
    * a sharded ``.tmp`` without a WORLD_COMMIT never happened (the JAX
      two-phase rule): it is removed.

    Returns the recovered tags. Call only when no save is in flight."""
    if not os.path.isdir(ckpt_dir):
        return []
    recovered = []
    for name in sorted(os.listdir(ckpt_dir)):
        if not name.endswith(".tmp"):
            continue
        tag = name[:-len(".tmp")]
        tmp = os.path.join(ckpt_dir, name)
        if is_sharded_checkpoint(tmp):
            if not os.path.isfile(os.path.join(tmp, _WORLD_COMMIT)):
                logger.warning(
                    "removing world-incomplete sharded checkpoint write "
                    "%s: without a WORLD_COMMIT it never happened", tmp)
                shutil.rmtree(tmp, ignore_errors=True)
            continue
        commit = _read_commit(tmp)
        if commit is None or _read_manifest(tmp) is None:
            continue  # an aborted write
        problems = verify_checkpoint(ckpt_dir, name)
        if problems:
            logger.warning(
                "stranded checkpoint write %s is COMMIT-complete but fails "
                "verification (%s): not promoting it", tmp,
                "; ".join(problems[:3]))
            continue
        logger.warning("recovering stranded checkpoint write %s (step %s): "
                       "finishing the interrupted commit", tmp,
                       commit.get("step"))
        _swing(ckpt_dir, tag, tmp)
        recovered.append(tag)
    for name in sorted(os.listdir(ckpt_dir)):
        if not name.endswith(".old"):
            continue
        tag = name[:-len(".old")]
        final = os.path.join(ckpt_dir, tag)
        old = os.path.join(ckpt_dir, name)
        if os.path.exists(final) or _read_manifest(old) is None:
            continue
        logger.warning("recovering stranded checkpoint %s: the swing was "
                       "interrupted; restoring it as %r", old, tag)
        os.replace(old, final)
        recovered.append(tag)
    return recovered


def _swing(ckpt_dir: str, tag: str, tmp: str) -> str:
    """Replace ``ckpt_dir/tag`` with the fully written ``tmp``."""
    final = os.path.join(ckpt_dir, tag)
    old = final + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(final):
        os.replace(final, old)
    # the crash window: a kill here leaves only <tag>.old (and the
    # complete <tag>.tmp), which recover_stranded_checkpoints undoes
    faults.check("ckpt.swing", path=final)
    os.replace(tmp, final)
    if os.path.exists(old):
        shutil.rmtree(old)
    return final


def write_shard(dest: str, fname: str, data: np.ndarray,
                start, stop) -> dict:
    """Write one shard file; returns its manifest record (box, byte
    length, checksum of the bytes as written). The ``ckpt.write_shard``
    site fires after the checksum, so damage it injects is detectable."""
    path = os.path.join(dest, fname)
    np.save(path, np.asarray(data, order="C"))
    value, nbytes = checksum_file(path)
    shard = {"file": fname, "start": list(start), "stop": list(stop),
             "bytes": nbytes}
    if value is not None:
        shard["checksum"] = value
        shard["checksum_algo"] = PREFERRED_ALGO
    faults.check("ckpt.write_shard", path=path)
    return shard


def write_manifest_and_commit(dest: str, entries: List[dict],
                              step: int) -> None:
    """The manifest, then the COMMIT marker from the manifest's bytes as
    they landed: a directory holding COMMIT holds a whole manifest."""
    manifest_path = os.path.join(dest, _MANIFEST)
    with open(manifest_path, "w") as f:
        json.dump({"version": 2, "step": int(step), "leaves": entries}, f,
                  indent=1)
    value, nbytes = checksum_file(manifest_path)
    commit = {"step": int(step), "manifest_bytes": nbytes}
    if value is not None:
        commit["manifest_checksum"] = value
        commit["checksum_algo"] = PREFERRED_ALGO
    with open(os.path.join(dest, _COMMIT), "w") as f:
        json.dump(commit, f)


def save_single_checkpoint(ckpt_dir: str, leaves: Dict[str, np.ndarray],
                           step: int, tag: str = "latest") -> str:
    """One process's checkpoint of flat host arrays, one shard per leaf:
    manifest, checksums, COMMIT, tmp and swing."""
    final = os.path.join(ckpt_dir, tag)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    entries = []
    for i, name in enumerate(sorted(leaves)):
        arr = np.asarray(leaves[name], order="C")
        shard = write_shard(tmp, f"{i:05d}_{name[:72]}.p0s0.npy", arr,
                            (0,) * arr.ndim, arr.shape)
        entries.append({"path": name, "shape": list(arr.shape),
                        "dtype": str(arr.dtype), "shards": [shard]})
    write_manifest_and_commit(tmp, entries, step)
    return _swing(ckpt_dir, tag, tmp)


def _entry_shards(entry: dict) -> List[dict]:
    """Shard list of a manifest entry; a version-1 entry is one shard."""
    if "shards" in entry:
        return entry["shards"]
    shape = entry["shape"]
    return [{"file": entry["file"], "start": [0] * len(shape),
             "stop": shape}]


def _load_shard(final: str, fname: str, **kw) -> np.ndarray:
    path = os.path.join(final, fname)
    faults.check("ckpt.read_shard", path=path)
    return np.load(path, **kw)


def _assemble(final: str, entry: dict, box_start: Tuple[int, ...],
              box_stop: Tuple[int, ...], dtype) -> np.ndarray:
    """The ``[start, stop)`` box of a leaf, read from the shards that
    overlap it."""
    box_start, box_stop = tuple(box_start), tuple(box_stop)
    out_shape = tuple(b - a for a, b in zip(box_start, box_stop))
    shards = _entry_shards(entry)
    for s in shards:   # one shard that is exactly the box
        if tuple(s["start"]) == box_start and tuple(s["stop"]) == box_stop:
            return _load_shard(final, s["file"]).astype(dtype, copy=False)
    out = np.empty(out_shape, dtype)
    if out.ndim == 0:
        if not shards:
            raise ValueError(f"leaf {entry['path']!r} has no shard")
        out[()] = _load_shard(final, shards[0]["file"])
        return out
    filled = 0
    for s in shards:
        lo = tuple(max(a, b) for a, b in zip(box_start, s["start"]))
        hi = tuple(min(a, b) for a, b in zip(box_stop, s["stop"]))
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        src = _load_shard(final, s["file"], mmap_mode="r")
        src_sel = tuple(slice(a - o, b - o)
                        for a, b, o in zip(lo, hi, s["start"]))
        dst_sel = tuple(slice(a - o, b - o)
                        for a, b, o in zip(lo, hi, box_start))
        out[dst_sel] = src[src_sel]
        filled += int(np.prod([b - a for a, b in zip(lo, hi)]))
    if filled < int(np.prod(out_shape)):
        raise ValueError(
            f"checkpoint shards for {entry['path']!r} do not cover the box "
            f"[{box_start}, {box_stop}): an incomplete save?")
    return out


def _read_entry(final: str, entry: dict) -> np.ndarray:
    """One leaf's full extent after checking each of its shards; a bad
    shard raises ``CheckpointCorrupted``."""
    for shard in _entry_shards(entry):
        problem = _shard_problem(final, shard, deep=True)
        if problem:
            raise CheckpointCorrupted(f"{problem} in {final}")
    shape = tuple(entry["shape"])
    return _assemble(final, entry, (0,) * len(shape), shape,
                     np.dtype(entry["dtype"]))


@dataclasses.dataclass
class LoadedCheckpoint:
    """What :func:`load_checkpoint` returns: the flat leaves by path."""

    leaves: Dict[str, np.ndarray]
    step: int
    tag: str = ""


def load_checkpoint(final: str) -> LoadedCheckpoint:
    """Every leaf of the checkpoint directory ``final`` (tag included),
    each checked against its shards' lengths and checksums."""
    if is_sharded_checkpoint(final):
        raise CheckpointCorrupted(
            f"{final} is a per-rank sharded checkpoint, which this package "
            "does not read (ROADMAP A11)")
    manifest = _read_manifest(final)
    if manifest is None:
        raise CheckpointCorrupted(f"no readable manifest in {final}")
    return LoadedCheckpoint(
        leaves={e["path"]: _read_entry(final, e)
                for e in manifest["leaves"]},
        step=int(manifest["step"]))
