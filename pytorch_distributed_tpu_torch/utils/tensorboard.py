"""TensorBoard scalar event files, written without the ``tensorboard``
package: the port of ``pytorch_distributed_tpu/utils/tensorboard.py``.

* :class:`SummaryWriter` — the torch-shaped API (``add_scalar``,
  ``add_scalars``, ``flush``, ``close``), reopening after ``close`` as
  torch's does;
* :class:`TensorBoardWriter` — the metrics-writer protocol
  (``write(step, metrics, split=)``), one event per call with the tags
  ``<split>/<name>``; values that are not numbers (the trainer's
  ``event`` and ``span`` labels) are left out, as the JAX writer leaves
  them.

The file is what TensorBoard's own ``EventFileWriter`` writes:
``events.out.tfevents.<time>.<host>.<pid>.<n>`` holding TFRecords
(little-endian u64 length, its masked CRC32C, the payload, the
payload's masked CRC32C), the first an ``Event`` with ``file_version
"brain.Event:2"``, then one ``Event`` (``wall_time``, ``step``,
``summary``) per write, each ``Summary.Value`` a ``tag`` and a
``simple_value`` (f32). The protobufs are encoded here field by field,
for scalars only: a value that is not a scalar raises.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from typing import Dict, Optional

_FILE_UID = itertools.count()


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum TFRecords carry."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(payload: bytes) -> bytes:
    """One TFRecord frame around ``payload``."""
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1   # int64 fields: two's complement, 10 bytes if < 0
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(number: int, payload: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _scalar(value) -> float:
    """``value`` as a float: a Python or numpy number, or a one-element
    tensor or array; anything else raises."""
    try:
        return float(value)
    except (TypeError, ValueError) as e:
        raise TypeError(f"TensorBoard scalars only: cannot write "
                        f"{type(value).__name__} {value!r}") from e


def scalar_event(step: int, scalars: Dict[str, float],
                 wall_time: Optional[float] = None) -> bytes:
    """An ``Event`` proto holding one ``Summary`` of ``tag:
    simple_value`` pairs."""
    values = b"".join(
        _field_bytes(1, _field_bytes(1, tag.encode())
                     + b"\x15" + struct.pack("<f", _scalar(v)))
        for tag, v in scalars.items())
    wall = time.time() if wall_time is None else float(wall_time)
    return (b"\x09" + struct.pack("<d", wall) + b"\x10" + _varint(int(step))
            + _field_bytes(5, values))


class _EventFile:
    """An event file under ``logdir``, opened with its version event."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time()):010d}."
                f"{socket.gethostname()}.{os.getpid()}.{next(_FILE_UID)}")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self.add(b"\x09" + struct.pack("<d", time.time())
                 + _field_bytes(3, b"brain.Event:2"))

    def add(self, event: bytes) -> None:
        self._f.write(tfrecord(event))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class SummaryWriter:
    """``torch.utils.tensorboard.SummaryWriter``-shaped scalar writer."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._w: Optional[_EventFile] = _EventFile(log_dir)

    def _writer(self) -> _EventFile:
        if self._w is None:   # torch's writer reopens after close()
            self._w = _EventFile(self.log_dir)
        return self._w

    def add_scalar(self, tag: str, value, global_step: int = 0) -> None:
        self._writer().add(scalar_event(global_step, {tag: value}))

    def add_scalars(self, main_tag: str, tag_scalar_dict: Dict[str, float],
                    global_step: int = 0) -> None:
        self._writer().add(scalar_event(
            global_step,
            {f"{main_tag}/{k}": v for k, v in tag_scalar_dict.items()}))

    def flush(self) -> None:
        if self._w is not None:
            self._w.flush()

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None


class TensorBoardWriter:
    """The metrics-writer protocol: one event per ``write``, the split
    the tags' prefix; values that are not numbers are left out."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._w: Optional[_EventFile] = _EventFile(logdir)

    @property
    def path(self) -> Optional[str]:
        return None if self._w is None else self._w.path

    def write(self, step: int, metrics: Dict[str, float], *,
              split: str = "train") -> None:
        if self._w is None:   # closed at the end of a fit(): reopen
            self._w = _EventFile(self.logdir)
        scalars = {}
        for k, v in metrics.items():
            if isinstance(v, str):
                continue
            scalars[f"{split}/{k}"] = _scalar(v)
        if scalars:
            self._w.add(scalar_event(step, scalars))

    def flush(self) -> None:
        if self._w is not None:
            self._w.flush()

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None


def read_records(path: str):
    """The payloads of a TFRecord file; raises on a CRC that does not
    check or a torn frame."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        if len(data) - pos < 12:
            raise ValueError(f"{path}: torn record header at byte {pos}")
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if hcrc != masked_crc32c(header):
            raise ValueError(f"{path}: length CRC fails at byte {pos}")
        payload = data[pos + 12:pos + 12 + n]
        if len(payload) != n or len(data) < pos + 16 + n:
            raise ValueError(f"{path}: torn record at byte {pos}")
        (pcrc,) = struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])
        if pcrc != masked_crc32c(payload):
            raise ValueError(f"{path}: payload CRC fails at byte {pos}")
        out.append(payload)
        pos += 16 + n
    return out
