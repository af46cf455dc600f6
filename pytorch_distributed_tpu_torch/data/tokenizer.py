"""Byte-level BPE over the repo's native trainer and encoder
(``native/bpe.cpp``): the port of ``pytorch_distributed_tpu/data/tokenizer.py``.

Every byte is a base token (ids 0-255), so any text round-trips; merge
``i`` is id ``256 + i``, learned by pair frequency. Training, encoding
and decoding run in C through ctypes, outside the interpreter lock. The
library is built from the source at first use
(``utils/native_build.py``), so the same merges and ids come out as in
the JAX package.

    tok = Tokenizer.train(text, vocab_size=1024)
    ids = tok.encode("hello world")
    assert tok.decode(ids) == "hello world"

``TokenizedTextDataset`` cuts an encoded corpus into fixed-length
windows for the causal-LM recipe (``--text-file``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import numpy as np

from pytorch_distributed_tpu_torch.utils.native_build import (
    build_native_library,
)

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_native_library("bpe"))
        i64, p = ctypes.c_int64, ctypes.c_void_p
        lib.bpe_train.argtypes = [p, i64, i64, p]
        lib.bpe_train.restype = i64
        lib.bpe_encode.argtypes = [p, i64, p, i64, p]
        lib.bpe_encode.restype = i64
        lib.bpe_decode.argtypes = [p, i64, p, i64, p, i64]
        lib.bpe_decode.restype = i64
        _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


class Tokenizer:
    """Byte-level BPE: ids ``0..255`` are raw bytes, ``256 + i`` merge i."""

    def __init__(self, merges: np.ndarray):
        merges = np.ascontiguousarray(merges, np.int32)
        if merges.ndim != 2 or merges.shape[1] != 2:
            raise ValueError(f"merges must be [n, 2], got {merges.shape}")
        self.merges = merges
        # byte length of every id, to size the decode buffer exactly
        lengths = np.ones(256 + len(merges), np.int64)
        for k, (left, right) in enumerate(merges):
            lengths[256 + k] = lengths[left] + lengths[right]
        self._token_bytes = lengths

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    @classmethod
    def train(cls, corpus: Union[str, bytes],
              vocab_size: int = 1024) -> "Tokenizer":
        if vocab_size < 256:
            raise ValueError("byte-level vocab_size must be >= 256")
        data = corpus.encode("utf-8") if isinstance(corpus, str) else corpus
        buf = np.frombuffer(data, np.uint8)
        want = vocab_size - 256
        merges = np.zeros((max(want, 1), 2), np.int32)
        got = _load().bpe_train(_ptr(buf), len(buf), want, _ptr(merges))
        if got < 0:
            raise RuntimeError("bpe_train failed")
        return cls(merges[:got])

    def encode(self, text: Union[str, bytes]) -> np.ndarray:
        data = text.encode("utf-8") if isinstance(text, str) else text
        buf = np.frombuffer(data, np.uint8)
        out = np.empty(max(len(buf), 1), np.int32)
        m = _load().bpe_encode(_ptr(buf), len(buf), _ptr(self.merges),
                               len(self.merges), _ptr(out))
        if m < 0:
            raise RuntimeError("bpe_encode failed")
        return out[:m].copy()

    def decode_bytes(self, ids) -> bytes:
        """The exact inverse of ``encode``, on bytes."""
        ids = np.ascontiguousarray(ids, np.int32)
        if np.any(ids < 0) or np.any(ids >= self.vocab_size):
            raise ValueError("token id out of range")
        cap = int(self._token_bytes[ids].sum()) if len(ids) else 1
        out = np.empty(cap, np.uint8)
        m = _load().bpe_decode(_ptr(ids), len(ids), _ptr(self.merges),
                               len(self.merges), _ptr(out), cap)
        if m < 0:
            raise RuntimeError("bpe_decode failed (bad id or overflow)")
        return out[:m].tobytes()

    def decode(self, ids) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def save(self, path: str) -> None:
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 merges=self.merges)

    @classmethod
    def load(cls, path: str) -> "Tokenizer":
        with np.load(path if path.endswith(".npz") else path + ".npz") as f:
            return cls(f["merges"])


class TokenizedTextDataset:
    """Fixed-length windows of an encoded corpus, ``{"input_ids": int32
    [seq_len]}`` per item, every ``stride`` tokens (``seq_len`` unless
    given), at most ``max_windows`` of them."""

    def __init__(self, text: Union[str, bytes], tokenizer: Tokenizer,
                 seq_len: int, *, stride: Optional[int] = None,
                 max_windows: Optional[int] = None):
        self._ids = tokenizer.encode(text)   # windows are slices of it
        self.seq_len = seq_len
        self.stride = stride or seq_len
        n = ((len(self._ids) - seq_len) // self.stride + 1
             if len(self._ids) >= seq_len else 0)
        if n <= 0:
            raise ValueError(f"corpus of {len(self._ids)} tokens too short "
                             f"for seq_len {seq_len}")
        self._n = min(n, max_windows) if max_windows else n
        self.tokenizer = tokenizer

    @property
    def num_tokens(self) -> int:
        return len(self._ids)

    def __len__(self) -> int:
        return self._n

    def _window(self, i: int) -> np.ndarray:
        start = int(i) * self.stride
        return self._ids[start: start + self.seq_len]

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return {"input_ids": self._window(i)}
        return {"input_ids": np.stack([self._window(j)
                                       for j in np.asarray(i)])}
