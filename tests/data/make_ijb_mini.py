"""Make the mini IJB fixture that the eval tests and ``chip_smoke.py`` run
the IJB protocol on (the machine with the card has no PIL to make one).

    python tests/data/make_ijb_mini.py [--seed 0] [--out tests/data/ijb_mini]

Takes the first 24 faces of ``tests/data/ssl_rec`` (4 identities of 6),
scales each by a random factor and pastes it at a random place into a
larger canvas of one of four sizes (a smooth background with faint
noise), and
writes:

- ``loose_crop/img_XX.jpg``: the 24 loose crops, JPEG quality 90 (4:2:0);
- ``meta/ijbc_name_5pts_score.txt``: each file's 5 landmarks (the face's
  eyes, nose tip and mouth corners, moved with it, plus up to 1 px of
  noise) and a faceness score;
- ``meta/ijbc_face_tid_mid.txt``: 8 templates of 3 images (2 per
  identity), each with two media (its first two images are one video);
- ``meta/ijbc_template_pair_label.txt``: every pair of the 8 templates,
  labelled 1 where they share an identity;
- ``aligned_ref.npz``: ``aligned``, the numpy ``norm_crop`` of PIL's decode
  of the first ``N_REF`` files (uint8, (8, 112, 112, 3); two of each
  canvas size: all 24 would take 0.5 MB), the reference the card's decode
  and warp are held to.
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from lafs_cvpr2024_tpu_torch.data.dataset import FaceRecordDataset  # noqa: E402
from lafs_cvpr2024_tpu_torch.eval.ijb import norm_crop  # noqa: E402

N, PER_TEMPLATE, TEMPLATES_PER_ID = 24, 3, 2
N_REF = 8
CANVASES = ((144, 144), (160, 176), (176, 136), (192, 192))  # (H, W)
# eyes, nose tip, mouth corners of the fixture's 112² faces, (x, y) px
FACE_5PTS = np.array([[42, 46], [70, 46], [56, 61], [44, 78], [68, 78]],
                     np.float64)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "ijb_mini"))
    args = p.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    ds = FaceRecordDataset(os.path.join(ROOT, "tests", "data", "ssl_rec",
                                        "train.rec"))
    crops, meta = (os.path.join(args.out, d) for d in ("loose_crop", "meta"))
    os.makedirs(crops, exist_ok=True)
    os.makedirs(meta, exist_ok=True)
    points, tids, mids, refs = [], [], [], []
    for i in range(N):
        # template t holds faces of identity t // 2 (the records' 8 per id)
        t = i // PER_TEMPLATE
        ident, j = t // TEMPLATES_PER_ID, i % (PER_TEMPLATE * TEMPLATES_PER_ID)
        jpeg, label = ds[8 * ident + j]
        assert int(label) == ident
        face = Image.open(io.BytesIO(jpeg)).convert("RGB")
        h, w = CANVASES[i % len(CANVASES)]
        scale = rng.uniform(0.8, 1.2)
        side = int(round(112 * scale))
        ox, oy = rng.integers(0, w - side + 1), rng.integers(0, h - side + 1)
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        bg = (rng.uniform(0.2, 0.8, 3) * (1 - yy[..., None])
              + rng.uniform(0.2, 0.8, 3) * xx[..., None]) * 255
        bg = np.clip(bg + rng.normal(0, 1, bg.shape), 0, 255).astype(np.uint8)
        canvas = Image.fromarray(bg)
        canvas.paste(face.resize((side, side), Image.BILINEAR), (ox, oy))
        name = f"img_{i:02d}.jpg"
        path = os.path.join(crops, name)
        canvas.save(path, "JPEG", quality=90)
        pts = FACE_5PTS * side / 112 + (ox, oy) + rng.uniform(-1, 1, (5, 2))
        points.append((name, np.round(pts, 2), rng.uniform(0.5, 1.0)))
        tids.append(t)
        mids.append(2 * t + (i % PER_TEMPLATE == 2))
        refs.append(norm_crop(np.asarray(Image.open(path).convert("RGB")),
                              np.round(pts, 2).astype(np.float32)))
    with open(os.path.join(meta, "ijbc_name_5pts_score.txt"), "w") as f:
        for name, pts, score in points:
            coords = " ".join(f"{v:.2f}" for v in pts.ravel())
            f.write(f"{name} {coords} {score:.4f}\n")
    with open(os.path.join(meta, "ijbc_face_tid_mid.txt"), "w") as f:
        for (name, _, _), t, m in zip(points, tids, mids):
            f.write(f"{name} {t} {m}\n")
    n_t = N // PER_TEMPLATE
    with open(os.path.join(meta, "ijbc_template_pair_label.txt"), "w") as f:
        for a in range(n_t):
            for b in range(a + 1, n_t):
                same = a // TEMPLATES_PER_ID == b // TEMPLATES_PER_ID
                f.write(f"{a} {b} {int(same)}\n")
    np.savez_compressed(os.path.join(args.out, "aligned_ref.npz"),
                        aligned=np.stack(refs[:N_REF]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
