"""Dtype policy for the port's models.

The JAX package's default :class:`Policy` keeps f32 parameters and casts
them to bf16 for every matmul, with f32 logits. The port's default is
the serving one instead: serving only ever computes in bf16, so it
stores the weights in bf16 to begin with (half the memory of f32 master
weights, the same products) and keeps the KV page pool in bf16 too.
Training needs the f32 master weights, since an optimizer step on bf16
weights loses every update below half a bf16 ulp: ``Policy.train()`` is
the JAX default (f32 parameters and optimizer state, bf16 products, f32
output). ``Policy.full()`` is f32 everywhere, for the CPU tests that hold
the port against the JAX reference. bf16 keeps f32's exponent range, so
no loss scaling is needed; fp16 scaling (``GradScaler``) is not ported.
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
    def train(cls) -> "Policy":
        """f32 parameters, bf16 compute, f32 output: the JAX default."""
        return cls(torch.float32, torch.bfloat16, torch.float32)

    @classmethod
    def full(cls) -> "Policy":
        """f32 parameters, compute and outputs."""
        return cls(torch.float32, torch.float32, torch.float32)
