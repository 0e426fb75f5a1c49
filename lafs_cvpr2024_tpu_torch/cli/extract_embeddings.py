"""Batch embedding extraction — folder or RecordIO → ``embeddings.npy``
(counterpart of ``lafs_cvpr2024_tpu/cli/extract_embeddings.py``) on one
GPU: load a Part-fViT ``.pth``, sweep a packed ``train.rec`` or a
directory of face crops through the model (flip-fused by addition and
L2-normalised unless told otherwise) and write ``embeddings.npy`` +
``names.json`` (``str(i)`` for records, the sorted relative paths for a
folder: the JAX CLI's names).

The JPEG bytes decode with nvJPEG straight into device memory, ``--prefetch``
batches ahead of the embed on a side stream (``data/pipeline.py::
Prefetcher``). The port refuses what nvJPEG cannot take and what the JAX CLI
would resize: PNG and BMP files, and images that are not the model's
``--image-size`` square, raise with the file's name (ROADMAP.md §3). The
card unless ``--device cpu`` is given; without a card the CLI raises.

Example:
  python -m lafs_cvpr2024_tpu_torch.cli.extract_embeddings \\
      --checkpoint ckpt.pth --input /data/crops --output out/
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data.dataset import FaceRecordDataset
from ..data.decode import decode_batch, read_jpeg
from ..data.pipeline import EpochSampler, Prefetcher, serial
from ..eval.loading import (
    EVAL_DTYPES,
    add_arch_flags,
    add_input_scale_flag,
    arch_overrides_from_args,
    load_eval_model,
    make_model_embed,
    print_launches,
    resolve_input_scale,
)
from ..train.device import resolve

EXTS = (".jpg", ".jpeg", ".png", ".bmp")  # what the JAX CLI collects
REFUSED = (".png", ".bmp")                # nvJPEG decodes JPEG only


def get_args(argv=None):
    p = argparse.ArgumentParser("lafs embedding extraction (PyTorch/CUDA)")
    p.add_argument("--checkpoint", required=True, help="Part-fViT .pth")
    p.add_argument("--input", required=True,
                   help="image folder (recursive) or dir with train.rec")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--prefetch", type=int, default=2,
                   help="decode-ahead depth: the decode of the next batches "
                        "overlaps the embed (0 = serial)")
    p.add_argument("--eval-dtype", default="bfloat16",
                   choices=list(EVAL_DTYPES),
                   help="forward compute dtype; bf16 embeddings agree with "
                        "fp32 to cosine >~ 1-1e-3")
    p.add_argument("--no-flip", dest="flip", action="store_false",
                   default=True, help="disable flip-test fusion")
    p.add_argument("--no-normalize", dest="normalize", action="store_false",
                   default=True, help="skip final L2 normalization")
    p.add_argument("--bgr", action="store_true",
                   help="packed recs keep BGR order (ms1m-style)")
    p.add_argument("--workers", type=int, default=8,
                   help="threads reading a folder's files")
    p.add_argument("--device", default="cuda",
                   help="torch device; CUDA unless 'cpu' is given explicitly")
    add_arch_flags(p)
    add_input_scale_flag(p)
    return p.parse_args(argv)


class FolderJPEGs:
    """A folder's image files in the JAX CLI's order (sorted ``os.walk``
    paths) as JPEG bytes; ``fetch_batch`` reads them with a thread pool and
    checks each header, raising with the file's name for what the port
    refuses."""

    bgr = False

    def __init__(self, root: str, size: int, device, pool):
        self.root, self.size, self.device, self.pool = root, size, device, pool
        self.files = sorted(
            os.path.join(r, f)
            for r, _, fs in os.walk(root)
            for f in fs
            if f.lower().endswith(EXTS)
        )
        if not self.files:
            raise FileNotFoundError(f"no images or train.rec under {root}")
        refused = [f for f in self.files if f.lower().endswith(REFUSED)]
        if refused:
            raise ValueError(
                f"{refused[0]} (and {len(refused) - 1} more): PNG and BMP "
                "are not decoded by the port (nvJPEG; ROADMAP.md §3)")

    def __len__(self) -> int:
        return len(self.files)

    def names(self, idx) -> list:
        return [os.path.relpath(self.files[i], self.root) for i in idx]

    def _read(self, path: str) -> bytes:
        data, dims = read_jpeg(path, self.device)
        if dims != (self.size, self.size):
            raise ValueError(
                f"{path} is {dims[0]}x{dims[1]}, not {self.size}x{self.size}:"
                " the port does not resize (ROADMAP.md §3)")
        return data

    def fetch_batch(self, indices):
        idx = [int(i) for i in indices]
        return (list(self.pool.map(self._read, [self.files[i] for i in idx])),
                np.asarray(idx))


class RecordJPEGs:
    """A ``train.rec``'s records in order as JPEG bytes; batches carry
    their indices, whose strings are the names."""

    def __init__(self, path: str, bgr: bool):
        self.ds = FaceRecordDataset(path, bgr=bgr)
        self.bgr = bgr

    def __len__(self) -> int:
        return len(self.ds)

    def names(self, idx) -> list:
        return [str(int(i)) for i in idx]

    def fetch_batch(self, indices):
        return self.ds.fetch_batch(indices)[0], np.asarray(indices)


def iter_batches(args, device):
    """``(names, uint8 (B, S, S, 3) on device)`` in order, decoded
    ``--prefetch`` batches ahead (serially at 0)."""
    rec = os.path.join(args.input, "train.rec")
    pool = ThreadPoolExecutor(args.workers)
    if os.path.exists(rec):
        ds = RecordJPEGs(rec, args.bgr)
    else:
        ds = FolderJPEGs(args.input, args.image_size, device, pool)
    sampler = EpochSampler(len(ds), args.batch_size, shuffle=False,
                           drop_last=False)
    if args.prefetch > 0:
        batches = Prefetcher(ds, sampler, device, args.prefetch).epoch(0)
    else:
        batches = serial(ds, len(ds), args.batch_size,
                         lambda jpegs, _: decode_batch(jpegs, device, ds.bgr))
    size = (args.image_size, args.image_size)
    with pool:
        for imgs, idx in batches:
            names = ds.names(idx)
            if tuple(imgs.shape[1:3]) != size:
                raise ValueError(
                    f"{names[0]}..{names[-1]}: {tuple(imgs.shape[1:3])} "
                    f"images, not {size}: the port does not resize "
                    "(ROADMAP.md §3)")
            yield names, imgs


def main(argv=None):
    args = get_args(argv)
    device = resolve(args.device)
    loaded = load_eval_model(args.checkpoint, arch_overrides_from_args(args),
                             device=device)
    args.input_scale = resolve_input_scale(args.input_scale, loaded.family)
    embed = make_model_embed(loaded.model, args.input_scale,
                             EVAL_DTYPES[args.eval_dtype])

    os.makedirs(args.output, exist_ok=True)
    all_names, chunks = [], []
    for names, imgs in iter_batches(args, device):
        batch = torch.cat([imgs, imgs.flip(2)]) if args.flip else imgs
        emb = embed(batch).cpu().numpy()
        if args.flip:
            emb = emb[: len(names)] + emb[len(names):]  # flip fusion (add)
        if args.normalize:
            emb = emb / np.maximum(
                np.linalg.norm(emb, axis=1, keepdims=True), 1e-12
            )
        all_names.extend(names)
        chunks.append(emb)

    out = np.concatenate(chunks)
    np.save(os.path.join(args.output, "embeddings.npy"), out)
    with open(os.path.join(args.output, "names.json"), "w") as f:
        json.dump(all_names, f)
    print(f"wrote {out.shape} embeddings to {args.output}")
    print_launches(device)
    return out, all_names


if __name__ == "__main__":
    main()
