"""The training traffic: a ``train.rec``/``train.idx`` of JPEG face records
for the SSL CLI's data path, built once per checkout at a fixed place, and
the record → face map that the reference uses to find the pixels of the
records the sampler drew.

The file holds ``rounds`` passes over the benchmark's faces
(``data/faces.bin``), each in its own order from ``order_seed``. Which
records a run trains on comes from the run's seed, through the CLI's own
subset and epoch sampling, which :func:`epoch_sources` repeats."""

from __future__ import annotations

import hashlib
import json
import os
import random
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"


def faces_jpeg() -> list:
    meta = json.loads((DATA / "faces.json").read_text())
    blob = (DATA / "faces.bin").read_bytes()
    return [blob[o:o + n] for o, n in zip(meta["offsets"], meta["lengths"])]


def faces_decoded() -> np.ndarray:
    """libjpeg's decode of every face, uint8 (F, 112, 112, 3)."""
    with np.load(DATA / "faces_decoded.npz") as z:
        return z["faces"]


def source_map(traffic: dict, n_faces: int) -> np.ndarray:
    """Face index of every record."""
    rng = np.random.default_rng(traffic["order_seed"])
    return np.concatenate([rng.permutation(n_faces)
                           for _ in range(traffic["rounds"])])


def ensure_records(root: Path, traffic: dict) -> Path:
    """The record directory (built if it is missing or stale)."""
    jpegs = faces_jpeg()
    src = source_map(traffic, len(jpegs))
    key = hashlib.sha256((DATA / "faces.bin").read_bytes()
                         + json.dumps(traffic, sort_keys=True).encode()
                         ).hexdigest()[:16]
    out = root / "build" / "bench" / "ssl_records"
    stamp = out / "complete.json"
    if stamp.exists() and json.loads(stamp.read_text()).get("key") == key:
        return out
    from lafs_cvpr2024_tpu_torch.data.recordio import RecBuilder

    out.mkdir(parents=True, exist_ok=True)
    stamp.unlink(missing_ok=True)
    builder = RecBuilder(str(out), (112, 112))
    for k, f in enumerate(src):
        builder.add_image(jpegs[f], float(f))
    builder.close()
    stamp.write_text(json.dumps({"key": key, "records": len(src)}))
    os.sync()  # written back now, in set-up, not during the window
    return out


def epoch_sources(traffic: dict, n_faces: int, seed: int, batch: int,
                  subset: float, steps: int, epoch: int = 0) -> list:
    """Faces of the first ``steps`` batches of ``epoch``: the CLI's cached
    random subset (``random.Random(seed).sample``), then its epoch sampler
    (``numpy.random.default_rng(seed + epoch).shuffle``, one process,
    last partial batch dropped)."""
    src = source_map(traffic, n_faces)
    keys = np.arange(len(src))
    if subset:
        order = random.Random(seed).sample(range(len(keys)),
                                           int(len(keys) * subset))
        keys = keys[order]
    idx = np.arange(len(keys))
    np.random.default_rng(seed + epoch).shuffle(idx)
    return [src[keys[idx[t * batch:(t + 1) * batch]]] for t in range(steps)]


def clear(path: Path) -> None:
    """Remove a file if it is there (the CLI's subset cache of a run)."""
    if os.path.exists(path):
        os.remove(path)
