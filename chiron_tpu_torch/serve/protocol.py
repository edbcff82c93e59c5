"""Wire protocol for the inference server: length-prefixed npz messages.

A copy of ``chiron_tpu/serve/protocol.py``, the dependency-free stand-in for
the reference's TF-Serving gRPC predict RPC (chiron/chiron_client.py:207-233):
a message is an 8-byte big-endian length followed by an .npz archive holding
the named arrays. Works over any socket-like stream.
"""

from __future__ import annotations

import io
import struct
from typing import Dict

import numpy as np

_LEN = struct.Struct(">Q")
MAX_MESSAGE = 1 << 31


def pack(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    return _LEN.pack(len(payload)) + payload


def read_message(sock) -> Dict[str, np.ndarray] | None:
    """The next message's arrays, or None where the stream ends first."""
    header = _read_exact(sock, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_MESSAGE:
        raise ValueError(f"message too large: {length}")
    payload = _read_exact(sock, length)
    if payload is None:
        return None
    with np.load(io.BytesIO(payload), allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _read_exact(sock, n: int) -> bytes | None:
    chunks = []
    remaining = n
    while remaining:
        chunk = sock.recv(min(remaining, 1 << 20))
        if not chunk:
            return None
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)
