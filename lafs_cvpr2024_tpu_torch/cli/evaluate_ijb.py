"""IJB-B / IJB-C offline evaluation CLI (counterpart of
``lafs_cvpr2024_tpu/cli/evaluate_ijb.py``) on one GPU.

Pipeline: loose-crop JPEGs + 5-pt landmarks → Umeyama fit on the host →
nvJPEG decode and the affine warp to 112×112 on the card
(``ops/warp.py::decode_warp_batch``), ``--prefetch`` batches ahead of the
embed → [orig | flip] embeddings → flip fusion → media/template
aggregation → cosine pair scoring → TPR@FPR table (``eval/ijb.py``). Same
flags, ``load_image_list`` and printed table as the JAX CLI, plus
``--device`` (the card unless ``--device cpu`` is given; without a card
the CLI raises). A file nvJPEG cannot decode raises with its name: there
is no per-batch fallback to another decoder.

Example:
  python -m lafs_cvpr2024_tpu_torch.cli.evaluate_ijb \\
      --model-checkpoint ckpt.pth --image-path /data/IJBC/loose_crop \\
      --meta-path /data/IJBC/meta --target IJBC
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data.decode import read_jpeg
from ..data.pipeline import EpochSampler, Prefetcher, serial
from ..eval.ijb import (
    ARCFACE_SRC,
    IJBConfig,
    read_template_media_list,
    read_template_pair_list,
    run_ijb_protocol,
    umeyama,
)
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
from ..ops.warp import decode_warp_batch
from ..train.device import resolve


def get_args(argv=None):
    p = argparse.ArgumentParser("lafs IJB evaluation (PyTorch/CUDA)")
    p.add_argument("--model-checkpoint", required=True, help="Part-fViT .pth")
    p.add_argument("--image-path", required=True, help="loose_crop dir")
    p.add_argument("--meta-path", required=True)
    p.add_argument("--target", default="IJBC", choices=["IJBB", "IJBC"])
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--prefetch", type=int, default=2,
                   help="decode-ahead depth: the decode and alignment of the "
                        "next batches overlap the embed (0 = serial)")
    p.add_argument("--eval-dtype", default="bfloat16",
                   choices=list(EVAL_DTYPES),
                   help="forward compute dtype; bf16 embeddings agree with "
                        "fp32 to cosine >~ 1-1e-3")
    p.add_argument("--no-norm-score", dest="use_norm_score", action="store_false")
    p.add_argument("--no-detector-score", dest="use_detector_score", action="store_false")
    p.add_argument("--no-flip-test", dest="use_flip_test", action="store_false")
    p.add_argument("--workers", type=int, default=16,
                   help="threads reading the image files")
    p.add_argument("--no-native", action="store_true",
                   help="accepted for the JAX CLI's command lines; both "
                        "values decode and align on the device")
    p.add_argument("--device", default="cuda",
                   help="torch device; CUDA unless 'cpu' is given explicitly")
    add_arch_flags(p)
    add_input_scale_flag(p)
    return p.parse_args(argv)


def load_image_list(meta_path: str, target: str):
    """Parse ``<target>_name_5pts_score.txt``: path + 5 landmarks + faceness
    (reference ``IJB_evaluation.py:408-440``)."""
    path = os.path.join(meta_path, f"{target.lower()}_name_5pts_score.txt")
    names, landmarks, scores = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            names.append(parts[0])
            landmarks.append(np.array(parts[1:11], np.float32).reshape(5, 2))
            scores.append(float(parts[11]))
    return names, np.stack(landmarks), np.asarray(scores, np.float32)


class LooseCrops:
    """The image list as a dataset for the ``Prefetcher``: ``fetch_batch``
    reads the files with a thread pool and checks each JPEG header (a file
    the port cannot decode raises with its name); its ``extra`` is the
    batch's forward alignment matrices, from the landmarks on the host."""

    def __init__(self, image_path: str, names, landmarks, device, pool):
        self.image_path, self.names = image_path, names
        self.landmarks, self.device, self.pool = landmarks, device, pool

    def __len__(self) -> int:
        return len(self.names)

    def _read(self, i: int) -> bytes:
        return read_jpeg(os.path.join(self.image_path, self.names[i]),
                         self.device)[0]

    def fetch_batch(self, indices):
        idx = [int(i) for i in indices]
        mats = np.stack([umeyama(self.landmarks[i].astype(np.float32),
                                 ARCFACE_SRC)[:2] for i in idx])
        return list(self.pool.map(self._read, idx)), mats


def main(argv=None):
    args = get_args(argv)
    device = resolve(args.device)
    target = args.target
    loaded = load_eval_model(args.model_checkpoint,
                             arch_overrides_from_args(args), device=device)
    args.input_scale = resolve_input_scale(args.input_scale, loaded.family)
    embed = make_model_embed(loaded.model, args.input_scale,
                             EVAL_DTYPES[args.eval_dtype])

    templates, medias = read_template_media_list(
        os.path.join(args.meta_path, f"{target.lower()}_face_tid_mid.txt")
    )
    p1, p2, labels = read_template_pair_list(
        os.path.join(args.meta_path, f"{target.lower()}_template_pair_label.txt")
    )
    names, landmarks, faceness = load_image_list(args.meta_path, target)

    t0 = time.time()
    dim = loaded.cfg.dim
    feats = np.zeros((len(names), 2 * dim), np.float32)
    bs = args.batch_size

    def align(jpegs, mats):
        return decode_warp_batch(jpegs, mats, device, args.image_size)

    with ThreadPoolExecutor(args.workers) as pool:
        crops = LooseCrops(args.image_path, names, landmarks, device, pool)
        sampler = EpochSampler(len(names), bs, shuffle=False, drop_last=False)
        if args.prefetch > 0:
            batches = Prefetcher(crops, sampler, device, args.prefetch,
                                 align).epoch(0)
        else:
            batches = serial(crops, len(names), bs, align)
        for step, (batch, _) in enumerate(batches):
            start, n = step * bs, len(batch)
            emb = embed(torch.cat([batch, batch.flip(2)])).cpu().numpy()
            feats[start : start + n, :dim] = emb[:n]
            feats[start : start + n, dim:] = emb[n:]
            if start % (bs * 20) == 0:
                print(f"embedded {start}/{len(names)} "
                      f"({(start + n) / (time.time() - t0):.0f} faces/s)")
    print(f"feature extraction: {time.time() - t0:.1f}s")

    table = run_ijb_protocol(
        feats, templates, medias, p1, p2, labels,
        faceness_scores=faceness,
        cfg=IJBConfig(
            use_norm_score=args.use_norm_score,
            use_detector_score=args.use_detector_score,
            use_flip_test=args.use_flip_test,
        ),
    )
    print(f"\n{target} 1:1 verification TPR@FPR:")
    for fpr_t, tpr in sorted(table.items()):
        print(f"  FPR={fpr_t:.0e}: TPR={tpr * 100:.2f}%")
    print_launches(device)
    return table


if __name__ == "__main__":
    main()
