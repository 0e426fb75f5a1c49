"""Face dataset over indexed RecordIO without PIL (counterpart of
``lafs_cvpr2024_tpu/data/dataset.py::FaceRecordDataset``).

The JAX dataset decodes each record on the host (PIL or the native
libjpeg plane). Here the dataset yields the record's JPEG bytes and its
label, and ``data/decode.py`` decodes whole batches on the card. The
options keep the JAX semantics:

- ``bgr``: the records are BGR; the decoder flips the channels back
  (``data/dataset.py:126-127``);
- ``partition`` keeps the first fraction of samples (``image_iter.py:
  294-297``);
- ``random_subset`` caches a random index subset to JSON, in the same order
  as the JAX dataset draws it (``random.Random(seed).sample``,
  ``dataset.py:83-95``), so the two packages train on the same subset and
  share each other's cache file.
"""

from __future__ import annotations

import json
import os
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .recordio import IndexedRecordIOReader, parse_face_index, unpack


class FaceRecordDataset:
    """Map-style dataset: index → (JPEG bytes, float label)."""

    def __init__(self, rec_path: str, bgr: bool = False,
                 partition: Optional[float] = None,
                 random_subset: Optional[float] = None,
                 subset_cache_path: Optional[str] = None, seed: int = 0):
        self.reader = IndexedRecordIOReader(rec_path[:-4] + ".idx", rec_path)
        index = parse_face_index(self.reader)
        self.id2range = index.id2range
        self.num_identities = index.num_identities
        self.seq: List[int] = list(index.image_keys)
        self.bgr = bgr
        if random_subset:
            cache = subset_cache_path or (
                rec_path + f".subset{random_subset}.json")
            if os.path.exists(cache):
                with open(cache) as f:
                    order = json.load(f)["index"]
            else:
                n = int(len(self.seq) * random_subset)
                order = random.Random(seed).sample(range(len(self.seq)), n)
                with open(cache, "w") as f:
                    json.dump({"index": order}, f)
            self.seq = [self.seq[i] for i in order]
        if partition:
            self.seq = self.seq[: int(np.int64(len(self.seq) * partition))]

    def __len__(self) -> int:
        return len(self.seq)

    def __getitem__(self, index: int) -> Tuple[bytes, float]:
        header, img_bytes = unpack(self.reader.read_idx(self.seq[index]))
        label = header.label
        if not np.isscalar(label):
            label = float(np.asarray(label).ravel()[0])
        return img_bytes, float(label)

    def fetch_batch(self, indices: Sequence[int]):
        """``(list of JPEG bytes, float32 labels)`` of the samples."""
        items = [self[int(i)] for i in indices]
        return ([b for b, _ in items],
                np.asarray([lab for _, lab in items], np.float32))
