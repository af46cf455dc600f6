"""Dtype policy for the port's models.

The JAX package's default :class:`Policy` keeps f32 parameters and casts
them to bf16 for every matmul, with f32 logits. Serving only ever
computes in bf16, so the port stores the weights in bf16 to begin with
(half the memory of f32 master weights, the same products) and keeps the
KV page pool in bf16 too. ``Policy.full()`` is f32 everywhere, for the
CPU tests that hold the port against the JAX reference. Loss scaling
(``GradScaler``) arrives with training.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtypes a model is built and run with."""

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    @classmethod
    def full(cls) -> "Policy":
        """f32 parameters, compute and outputs."""
        return cls(torch.float32, torch.float32, torch.float32)
