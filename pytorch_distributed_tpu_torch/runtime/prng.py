"""Deterministic random streams: the port of
``pytorch_distributed_tpu/runtime/prng.py``.

The JAX package derives every key from one base seed folded with stable
integer tags (``key_for(step, tag)``), never from hidden sequential
state. The port keeps that shape with ``torch.Generator``s: every
purpose (dropout in step 7, microbatch 2, ...) gets its own generator,
seeded from the base seed, the step and the tag, so a step's randomness
does not depend on what ran before it. Torch and JAX draw different
numbers from the same seed; tests that compare the two feed both the
same random inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_distributed_tpu_torch.runtime.device import (
    DeviceLike,
    resolve_device,
)

_SEED: int = 0
_MASK64 = (1 << 64) - 1


def seed_all(seed: int) -> None:
    """Set the process-wide base seed (and numpy's and torch's global
    generators, for host-side shuffles and anything left unseeded)."""
    global _SEED
    _SEED = int(seed)
    np.random.seed(_SEED % (2**32))
    torch.manual_seed(_SEED)


def _mix(x: int) -> int:
    """splitmix64's finalizer: a bijective scramble of a 64-bit integer."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def seed_for(step: int, tag: int = 0) -> int:
    """The 63-bit seed of the (base seed, step, tag) stream."""
    return _mix(_mix(_mix(_SEED) ^ int(step)) ^ int(tag)) >> 1


def generator_for(step: int, tag: int = 0,
                  device: DeviceLike = None) -> torch.Generator:
    """A fresh generator on ``device`` (the card unless given) for the
    (step, tag) stream: the counterpart of ``key_for``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed_for(step, tag))
    return gen
