"""Checksums for checkpoint integrity: the port's copy of
``pytorch_distributed_tpu/utils/integrity.py``.

CRC32C (Castagnoli) through ``google_crc32c``'s C extension where it is
installed, plain ``zlib.crc32`` otherwise. Manifests record which one
made each value (``checksum_algo``), stored as the same JSON integer
both packages write, so either package verifies the other's files with
the writer's algorithm when it can and falls back to byte lengths when
it cannot.
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

try:
    import google_crc32c as _crc32c
except Exception:  # pragma: no cover - depends on the environment
    _crc32c = None

#: the algorithm new checksums use on this host
PREFERRED_ALGO = "crc32c" if _crc32c is not None else "crc32"

_CHUNK = 1 << 22  # 4 MB reads: bounded memory for GB-sized shards


def _extend(algo: str, value: int, chunk: bytes) -> int:
    if algo == "crc32c":
        return _crc32c.extend(value, chunk)
    return zlib.crc32(chunk, value)


def algo_supported(algo: str) -> bool:
    return algo == "crc32" or (algo == "crc32c" and _crc32c is not None)


def checksum_file(
    path: str, algo: str = PREFERRED_ALGO
) -> Tuple[Optional[int], int]:
    """(checksum, byte length) of a file, read in bounded chunks. The
    checksum is None when ``algo`` cannot be computed here; the length
    still serves the truncation checks."""
    value: Optional[int] = 0 if algo_supported(algo) else None
    nbytes = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            nbytes += len(chunk)
            if value is not None:
                value = _extend(algo, value, chunk)
    return value, nbytes
