"""Datasets: the port's copy of the part of
``pytorch_distributed_tpu/data/datasets.py`` the GPT-2, Llama, BERT and
ResNet recipes use. Items are dicts of numpy arrays, drawn exactly as
the JAX package draws them."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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
    """Deterministic random token sequences for LM and fine-tune recipes;
    with ``num_classes`` each item also carries an int32 ``label``, drawn
    after its tokens from the same per-index generator."""

    def __init__(
        self,
        n: int = 10_000,
        seq_len: int = 512,
        vocab_size: int = 50_257,
        num_classes: Optional[int] = None,  # set for classification heads
        seed: int = 0,
    ):
        self.n = n
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        i = int(i)
        if not 0 <= i < self.n:
            raise IndexError(i)
        g = np.random.default_rng(self.seed * 1_000_003 + i)
        item = {
            "input_ids": g.integers(
                self.vocab_size, size=(self.seq_len,), dtype=np.int32
            )
        }
        if self.num_classes is not None:
            item["label"] = np.int32(g.integers(self.num_classes))
        return item


class SyntheticImageDataset:
    """Deterministic random images and labels with real-recipe shapes
    (NHWC), each index drawn from its own seed (``seed * 1_000_003 + i``),
    byte for byte the JAX package's. ``dtype=np.uint8`` yields raw 0..255
    pixels for the device-normalize path; float32 yields pre-normalized
    gaussian noise."""

    def __init__(
        self,
        n: int = 50_000,
        image_shape: Tuple[int, int, int] = (32, 32, 3),
        num_classes: int = 10,
        seed: int = 0,
        dtype=np.float32,
    ):
        self.n = n
        self.image_shape = image_shape
        self.num_classes = num_classes
        self.seed = seed
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.dtype(np.float32), np.dtype(np.uint8)):
            raise ValueError(
                f"SyntheticImageDataset dtype must be float32 or uint8, "
                f"got {self.dtype}"
            )

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        i = int(i)
        if not 0 <= i < self.n:
            raise IndexError(i)
        g = np.random.default_rng(self.seed * 1_000_003 + i)
        if self.dtype == np.uint8:
            image = g.integers(0, 256, size=self.image_shape, dtype=np.uint8)
        else:
            image = g.normal(size=self.image_shape).astype(np.float32)
        return {
            "image": image,
            "label": np.int32(g.integers(self.num_classes)),
        }
