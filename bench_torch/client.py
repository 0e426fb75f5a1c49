"""The embedding server's wire protocol, client side (raw uint8 crops):

  request:  ``<u32 0x4C414653> <u32 n> <u32 h> <u32 w>`` + n·h·w·3 bytes
  response: ``<u32 n> <u32 d>`` + n·d float32, or an error frame
            ``<u32 0xFFFFFFFF> <u32 len>`` + a UTF-8 message.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0x4C414653
ERR = 0xFFFFFFFF


def payload(faces: np.ndarray) -> bytes:
    n, h, w, _ = faces.shape
    return struct.pack("<IIII", MAGIC, n, h, w) + np.ascontiguousarray(
        faces, np.uint8).tobytes()


def recv_exact(sock, n: int) -> bytes:
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("server closed mid-message")
        got += k
    return bytes(buf)


def read_response(sock) -> np.ndarray:
    """One reply: (n, d) float32; raises RuntimeError on an error frame."""
    a, b = struct.unpack("<II", recv_exact(sock, 8))
    if a == ERR:
        raise RuntimeError(recv_exact(sock, b).decode(errors="replace"))
    return np.frombuffer(recv_exact(sock, a * b * 4), np.float32).reshape(a, b)
