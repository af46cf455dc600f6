"""Migration wire format: prefill-tier page frames -> decode-tier
splice; the port's own copy of ``pytorch_distributed_tpu/serve/disagg.py``
(numpy, hashlib and json only).

A request's KV is a page list, so a tier hand-off is four arrays:

* **preamble** ``int64[2]``: meta and payload sizes, so the receiver can
  shape its ``recv`` buffers;
* **header** ``uint8[96]``: ``blake2b-256(signature | meta | payload)``
  in bytes [0, 32), then the leading bytes of the sender's frame
  signature as a readable hint. The receiver recomputes the digest with
  ITS OWN pool signature, so a geometry mismatch (model, page size,
  dtype) and a damaged payload both end in the same loud
  :class:`MigrationError`, before a byte touches the pool;
* **meta**: JSON, the request's constructor fields. The decode side
  rebuilds the ``Request`` and re-derives the sampling state from its
  seed (a fresh ``torch.Generator`` that replays the prefill tier's one
  first-token draw) rather than shipping device state;
* **payload**: ``kv_slots.extract_frames`` bytes of the
  ``ceil(P / page_size)`` pages that hold the prompt's KV, verbatim in
  the pool's dtype (an int8 pool ships int8 K/V plus f32 scales).

:func:`send_frame`/:func:`recv_frame` take any ``ring`` with
``send(array, dst)`` and ``recv(buffer, src)``; the port has no
cross-process ring yet (ROADMAP A11), so the router's in-process
:func:`roundtrip_frame` is the path that runs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

HEADER_BYTES = 96
_DIGEST_BYTES = 32

#: Request constructor fields a frame carries (prompt_ids handled
#: separately — it is an array)
_REQ_FIELDS = (
    "max_new_tokens", "temperature", "top_k", "top_p", "eos_id",
    "seed", "deadline_s", "request_id",
)


class MigrationError(RuntimeError):
    """A migration packet was refused before touching the pool."""


@dataclasses.dataclass
class MigrationFrame:
    """One migrated request: everything the decode tier needs."""

    request: Dict[str, object]   # Request ctor kwargs, prompt_ids as list
    first_token: int             # sampled by the prefill tier's final chunk
    prompt_len: int
    n_pages: int                 # frames in ``payload``
    signature: str               # sender's kv_slots.frame_signature
    payload: np.ndarray          # uint8, extract_frames codec
    src_engine: str = ""

    @property
    def request_id(self) -> str:
        return str(self.request.get("request_id", ""))

    @property
    def payload_nbytes(self) -> int:
        return int(self.payload.size)


def request_to_wire(req) -> Dict[str, object]:
    """JSON-safe ``Request`` constructor kwargs."""
    d = {k: getattr(req, k) for k in _REQ_FIELDS}
    d["prompt_ids"] = np.asarray(req.prompt_ids, np.int32).tolist()
    return d


def request_from_wire(d: Dict[str, object]):
    from pytorch_distributed_tpu_torch.serve.scheduler import Request

    kw = dict(d)
    kw["prompt_ids"] = np.asarray(kw["prompt_ids"], np.int32)
    return Request(**kw)


def _digest(signature: str, meta: bytes, payload: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=_DIGEST_BYTES)
    h.update(signature.encode())
    h.update(meta)
    h.update(np.ascontiguousarray(payload, np.uint8).tobytes())
    return h.digest()


def encode_frame(frame: MigrationFrame) -> List[np.ndarray]:
    """Frame -> ``[preamble, header, meta, payload]`` wire arrays."""
    meta = json.dumps({
        "request": frame.request,
        "first_token": int(frame.first_token),
        "prompt_len": int(frame.prompt_len),
        "n_pages": int(frame.n_pages),
        "signature": frame.signature,
        "src_engine": frame.src_engine,
    }, sort_keys=True).encode()
    payload = np.ascontiguousarray(frame.payload, np.uint8).reshape(-1)
    header = np.zeros(HEADER_BYTES, np.uint8)
    header[:_DIGEST_BYTES] = np.frombuffer(
        _digest(frame.signature, meta, payload), np.uint8
    )
    hint = frame.signature.encode()[:HEADER_BYTES - _DIGEST_BYTES]
    header[_DIGEST_BYTES:_DIGEST_BYTES + len(hint)] = np.frombuffer(
        hint, np.uint8
    )
    preamble = np.array([len(meta), payload.size], np.int64)
    return [preamble, header, np.frombuffer(meta, np.uint8), payload]


def decode_frame(
    header: np.ndarray,
    meta: np.ndarray,
    payload: np.ndarray,
    expect_signature: Optional[str] = None,
) -> MigrationFrame:
    """Wire arrays -> frame, refusing on any fingerprint mismatch.

    ``expect_signature`` is the RECEIVING pool's frame signature; the
    digest is recomputed over (that signature, meta, payload), so a
    sender with different pool geometry — or bytes damaged in flight —
    is refused identically, naming both layouts.
    """
    meta_b = np.ascontiguousarray(meta, np.uint8).tobytes()
    try:
        obj = json.loads(meta_b.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise MigrationError(
            f"migration meta is not valid JSON ({e}) — framing drift "
            "between sender and receiver"
        ) from e
    theirs = str(obj.get("signature", ""))
    check_sig = expect_signature if expect_signature is not None else theirs
    want = np.frombuffer(
        _digest(check_sig, meta_b, payload), np.uint8
    )
    got = np.ascontiguousarray(header, np.uint8).reshape(-1)
    if got.size != HEADER_BYTES or not np.array_equal(
        got[:_DIGEST_BYTES], want
    ):
        raise MigrationError(
            "migration fingerprint mismatch: receiver pool is "
            f"{check_sig!r}, sender declared {theirs!r} — refusing the "
            "splice (geometry drift or bytes corrupted in flight)"
        )
    payload = np.ascontiguousarray(payload, np.uint8).reshape(-1)
    return MigrationFrame(
        request=obj["request"],
        first_token=int(obj["first_token"]),
        prompt_len=int(obj["prompt_len"]),
        n_pages=int(obj["n_pages"]),
        signature=theirs,
        payload=payload,
        src_engine=str(obj.get("src_engine", "")),
    )


def wire_nbytes(arrays: Sequence[np.ndarray]) -> int:
    """Total bytes a frame occupies on the wire (preamble + header +
    meta + payload) — what the router's migration accounting records."""
    return int(sum(int(a.nbytes) for a in arrays))


def send_frame(ring, frame: MigrationFrame, dst: int) -> int:
    """Ship one frame to ``dst`` over the ring's P2P mailboxes; returns
    wire bytes. Pure sends — bystander ranks are uninvolved."""
    arrays = encode_frame(frame)
    for a in arrays:
        ring.send(a, dst)
    return wire_nbytes(arrays)


def recv_frame(
    ring, src: int, expect_signature: Optional[str] = None
) -> MigrationFrame:
    """Receive one frame from ``src``, fingerprint-checked against the
    receiver's own pool ``expect_signature`` before anything is used."""
    pre = ring.recv(np.zeros(2, np.int64), src)
    meta_len, payload_len = int(pre[0]), int(pre[1])
    if not (0 <= meta_len <= 1 << 30 and 0 <= payload_len <= 1 << 34):
        raise MigrationError(
            f"migration preamble implausible: meta={meta_len} "
            f"payload={payload_len} bytes — stream out of sync"
        )
    header = ring.recv(np.zeros(HEADER_BYTES, np.uint8), src)
    meta = ring.recv(np.zeros(meta_len, np.uint8), src)
    payload = ring.recv(np.zeros(payload_len, np.uint8), src)
    return decode_frame(header, meta, payload, expect_signature)


def roundtrip_frame(
    frame: MigrationFrame, expect_signature: Optional[str] = None
):
    """In-process loopback through the FULL wire codec: encode, then
    decode under the receiver's signature. Returns ``(frame, wire
    bytes)``. The router uses this instead of a bare object hand-off so
    in-process fleets pay (and account) the identical framing +
    fingerprint discipline as cross-process ones."""
    arrays = encode_frame(frame)
    out = decode_frame(arrays[1], arrays[2], arrays[3], expect_signature)
    return out, wire_nbytes(arrays)
