"""Indexed RecordIO reader and writer, numpy only (the port's own copy of
``lafs_cvpr2024_tpu/data/recordio.py``: the JAX package's ``data``
package imports jax and PIL on import, so the port keeps this copy).

The reference delegates its whole data plane to ``mxnet.recordio``
(``image_iter.py:264-306``, ``img2rec.py:21-73``). The format is simple and
reimplemented here from its on-disk layout:

Record stream (``.rec``):
  [magic: uint32 LE = 0xced7230a]
  [lrecord: uint32 LE — upper 3 bits cflag (0 = complete record),
                        lower 29 bits payload length]
  [payload: length bytes][pad to 4-byte boundary]

Payload = IRHeader + optional extra labels + image bytes:
  IRHeader: struct '<IfQQ' = (flag, label, id, id2)
  if flag > 0: the scalar ``label`` field is 0 and ``flag`` float32 label
  values follow the header (multi-label records; the insightface header-0
  record uses this to carry the identity index range).

Index file (``.idx``): lines of ``key\toffset`` (offset of the record's
magic word).

Identity-range convention (insightface datasets, ``image_iter.py:271-291``):
record 0 has flag>0 and label = (ident_start, ident_end); records
[ident_start, ident_end) are per-identity headers whose label =
(img_start, img_end) gives each identity's image-record range.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Tuple, Union

import numpy as np

_MAGIC = 0xCED7230A
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)
_LREC_MASK = (1 << 29) - 1


@dataclass
class IRHeader:
    flag: int
    label: Union[float, np.ndarray]
    id: int
    id2: int = 0


def pack(header: IRHeader, data: bytes) -> bytes:
    """Serialize a record payload (mxnet ``recordio.pack`` layout)."""
    label = header.label
    if np.isscalar(label):
        payload = struct.pack(_IR_FORMAT, 0, float(label), header.id, header.id2) + data
    else:
        arr = np.asarray(label, dtype=np.float32)
        payload = (
            struct.pack(_IR_FORMAT, arr.size, 0.0, header.id, header.id2)
            + arr.tobytes()
            + data
        )
    return payload


def unpack(payload: bytes) -> Tuple[IRHeader, bytes]:
    flag, label, rid, rid2 = struct.unpack(_IR_FORMAT, payload[:_IR_SIZE])
    rest = payload[_IR_SIZE:]
    if flag > 0:
        labels = np.frombuffer(rest[: flag * 4], dtype=np.float32)
        return IRHeader(flag, labels, rid, rid2), rest[flag * 4:]
    return IRHeader(0, label, rid, rid2), rest


class IndexedRecordIOWriter:
    """Write an indexed ``.rec``/``.idx`` pair."""

    def __init__(self, idx_path: str, rec_path: str):
        self._rec = open(rec_path, "wb")
        self._idx = open(idx_path, "w")
        self._pos = 0

    def write_idx(self, key: int, payload: bytes) -> None:
        self._idx.write(f"{key}\t{self._pos}\n")
        n = len(payload)
        assert n <= _LREC_MASK, "record too large"
        buf = struct.pack("<II", _MAGIC, n) + payload
        pad = (-n) % 4
        buf += b"\x00" * pad
        self._rec.write(buf)
        self._pos += len(buf)

    def close(self) -> None:
        self._rec.close()
        self._idx.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class IndexedRecordIOReader:
    """Random-access reader. mmap-backed for zero-copy, fork-safe reopening
    for multi-worker loaders."""

    def __init__(self, idx_path: str, rec_path: str):
        self.idx_path = idx_path
        self.rec_path = rec_path
        self._offsets: Dict[int, int] = {}
        with open(idx_path) as f:
            for line in f:
                k, off = line.split("\t")
                self._offsets[int(k)] = int(off)
        self.keys: List[int] = list(self._offsets.keys())
        self._fd = os.open(rec_path, os.O_RDONLY)
        self._pid = os.getpid()

    def _ensure_open(self):
        # reopen after fork (worker processes must not share the fd offset)
        if os.getpid() != self._pid:
            self._fd = os.open(self.rec_path, os.O_RDONLY)
            self._pid = os.getpid()

    def read_idx(self, key: int) -> bytes:
        """Return the raw payload (header + labels + image bytes).

        Thread-safe: uses positioned reads (pread), so decode worker threads
        share one fd without seek races.
        """
        self._ensure_open()
        off = self._offsets[key]
        head = os.pread(self._fd, 8, off)
        magic, lrec = struct.unpack("<II", head)
        assert magic == _MAGIC, f"bad magic at key {key}"
        cflag = lrec >> 29
        length = lrec & _LREC_MASK
        assert cflag == 0, "multi-part records not supported"
        return os.pread(self._fd, length, off + 8)

    def __len__(self):
        return len(self.keys)

    def close(self):
        os.close(self._fd)


@dataclass
class FaceRecordIndex:
    """Parsed identity-range metadata of an insightface-style train.rec."""

    image_keys: List[int]
    id2range: Dict[int, Tuple[int, int]]
    num_identities: int


def parse_face_index(reader: IndexedRecordIOReader) -> FaceRecordIndex:
    """Reproduce the header-0 walk of ``image_iter.py:271-291``."""
    header, _ = unpack(reader.read_idx(0))
    if header.flag > 0:
        ident_start, ident_end = int(header.label[0]), int(header.label[1])
        image_keys: List[int] = []
        id2range: Dict[int, Tuple[int, int]] = {}
        for identity in range(ident_start, ident_end):
            h, _ = unpack(reader.read_idx(identity))
            a, b = int(h.label[0]), int(h.label[1])
            id2range[identity] = (a, b)
            image_keys.extend(range(a, b))
        return FaceRecordIndex(image_keys, id2range, ident_end - ident_start)
    return FaceRecordIndex(list(reader.keys), {}, 0)


class RecBuilder:
    """Dataset packing tool — reference ``img2rec.py:12-73``.

    Writes ``train.rec``/``train.idx`` + a ``property`` file
    ("num_classes,H,W"). Images must be pre-encoded bytes (JPEG) —
    encoding happens in the caller (PIL) to keep this module dependency-free.
    """

    def __init__(self, path: str, image_size=(112, 112)):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.image_size = image_size
        self.widx = 0
        self.max_label = -1
        self.writer = IndexedRecordIOWriter(
            os.path.join(path, "train.idx"), os.path.join(path, "train.rec")
        )

    def add_image(self, jpeg_bytes: bytes, label) -> None:
        idlabel = label[0] if isinstance(label, (list, tuple)) else label
        header = IRHeader(0, label, self.widx, 0)
        self.writer.write_idx(self.widx, pack(header, jpeg_bytes))
        self.widx += 1
        self.max_label = max(self.max_label, int(idlabel))

    def close(self) -> None:
        self.writer.close()
        with open(os.path.join(self.path, "property"), "w") as f:
            f.write(
                "%d,%d,%d\n" % (self.max_label + 1, self.image_size[0], self.image_size[1])
            )
            f.write("%d\n" % self.widx)


def read_property(path: str) -> Tuple[int, int, int]:
    """Parse the ``property`` file → (num_classes, H, W)
    (``train_largescale.py:511-512``)."""
    with open(os.path.join(path, "property")) as f:
        num_classes, h, w = [int(x) for x in f.readline().split(",")]
    return num_classes, h, w
