"""Datasets: the port's copy of the part of
``pytorch_distributed_tpu/data/datasets.py`` the GPT-2 recipe uses. Items
are dicts of numpy arrays, drawn exactly as the JAX package draws them."""

from __future__ import annotations

from typing import Dict

import numpy as np


class ArrayDataset:
    """Dict-of-arrays dataset; leading dim indexes samples."""

    def __init__(self, **arrays: np.ndarray):
        if not arrays:
            raise ValueError("ArrayDataset needs at least one array")
        lengths = {k: len(v) for k, v in arrays.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"Mismatched lengths: {lengths}")
        self.arrays = arrays
        self._len = next(iter(lengths.values()))

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        return {k: v[i] for k, v in self.arrays.items()}


def stack_items(items):
    """Merge per-sample dict items into one batch."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class SyntheticTextDataset:
    """Deterministic random token sequences for LM recipes."""

    def __init__(
        self,
        n: int = 10_000,
        seq_len: int = 512,
        vocab_size: int = 50_257,
        seed: int = 0,
    ):
        self.n = n
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        i = int(i)
        if not 0 <= i < self.n:
            raise IndexError(i)
        g = np.random.default_rng(self.seed * 1_000_003 + i)
        return {
            "input_ids": g.integers(
                self.vocab_size, size=(self.seq_len,), dtype=np.int32
            )
        }
