"""Fixed-shape document packing for LM training: the port's own copy of
``pytorch_distributed_tpu/data/packing.py`` (numpy only, unchanged).

Several documents are packed into each fixed-length row and attention is
masked across document boundaries (``segment_ids``, taken by
``ops.attention`` and the flash kernels). Segment id 0 is padding;
documents get ids 1..N per row. ``positions`` restart at 0 for each
document, so a packed document sees the positions it would alone.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np


def pack_documents(
    docs: Iterable[Sequence[int]],
    seq_len: int,
    *,
    pad_id: int = 0,
) -> Dict[str, np.ndarray]:
    """Greedy first-fit packing of token sequences into fixed rows.

    Returns ``input_ids``/``segment_ids``/``positions``, each
    [rows, seq_len] int32. Documents longer than ``seq_len`` are split
    into ``seq_len``-sized pieces, each its own segment.
    """
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    pieces: List[List[int]] = []
    for doc in docs:
        doc = list(doc)
        for off in range(0, len(doc), seq_len):
            piece = doc[off:off + seq_len]
            if piece:
                pieces.append(piece)
    # first-fit: place each piece in the first row with room
    rows: List[List[List[int]]] = []
    space: List[int] = []
    for piece in pieces:
        for i, free in enumerate(space):
            if len(piece) <= free:
                rows[i].append(piece)
                space[i] -= len(piece)
                break
        else:
            rows.append([piece])
            space.append(seq_len - len(piece))
    n = len(rows)
    input_ids = np.full((n, seq_len), pad_id, np.int32)
    segment_ids = np.zeros((n, seq_len), np.int32)
    positions = np.zeros((n, seq_len), np.int32)
    for r, row in enumerate(rows):
        off = 0
        for s, piece in enumerate(row, start=1):
            L = len(piece)
            input_ids[r, off:off + L] = piece
            segment_ids[r, off:off + L] = s
            positions[r, off:off + L] = np.arange(L)
            off += L
    return {
        "input_ids": input_ids,
        "segment_ids": segment_ids,
        "positions": positions,
    }


def packed_loss_mask(segment_ids):
    """Next-token loss mask for packed rows: position t trains iff its
    target t+1 exists, is not padding, and belongs to the same document.
    Shape in: [B, S]; out: [B, S-1] bool aligned with
    ``targets = input_ids[:, 1:]``. Works on numpy arrays and torch
    tensors alike."""
    seg = segment_ids
    return (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] != 0)
