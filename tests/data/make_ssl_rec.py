"""Make the small JPEG RecordIO fixture that ``chip_smoke.py`` trains the
port's SSL CLI on (the machine with the card has no PIL to make one).

    python tests/data/make_ssl_rec.py [--seed 0] [--out tests/data/ssl_rec]

Writes 64 face-like 112 × 112 RGB images (a skin-toned face on a
gradient background, eyes, brows, nose and mouth, each image with its own
pose, colours and lighting from ``--seed``: smooth shapes, not noise) as
JPEG quality 95 (4:2:0 chroma, PIL's default), 8 identities of 8, packed
with the port's ``RecBuilder`` into ``train.rec``, ``train.idx`` and
``property``; ``decoded_ref.npy``, PIL's decode of the first 4 images
(uint8, (4, 112, 112, 3)), the reference the card's decoder is held to;
and one more face as ``layout_{444,422,gray}.jpg`` in the other chroma
layouts the decoder takes, with PIL's decodes in ``layouts_ref.npy``.
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from lafs_cvpr2024_tpu_torch.data.recordio import RecBuilder  # noqa: E402

N, SIZE, PER_ID = 64, 112, 8


def ellipse(yy, xx, cy, cx, ry, rx, angle=0.0):
    """Soft-edged ellipse mask in [0, 1]."""
    c, s = np.cos(angle), np.sin(angle)
    u = ((xx - cx) * c + (yy - cy) * s) / rx
    v = (-(xx - cx) * s + (yy - cy) * c) / ry
    return np.clip((1.0 - (u * u + v * v)) * 6.0, 0.0, 1.0)


def face(rng) -> np.ndarray:
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float64)
    top, bottom = rng.uniform(0.2, 0.9, 3), rng.uniform(0.1, 0.8, 3)
    t = (yy / SIZE)[..., None]
    img = top * (1 - t) + bottom * t
    cy, cx = SIZE / 2 + rng.uniform(-6, 6), SIZE / 2 + rng.uniform(-6, 6)
    angle = rng.uniform(-0.25, 0.25)
    skin = np.array([0.85, 0.65, 0.5]) * rng.uniform(0.6, 1.1)
    light = 1.0 + 0.25 * ((xx - cx) / SIZE * rng.uniform(-1, 1))[..., None]
    m = ellipse(yy, xx, cy, cx, 44, 34, angle)[..., None]
    img = img * (1 - m) + np.clip(skin * light, 0, 1) * m
    dy, dx = rng.uniform(-2, 2, 2)
    for side in (-1, 1):
        ex = cx + side * 14 + dx
        brow = ellipse(yy, xx, cy - 20 + dy, ex, 2.5, 9, angle)[..., None]
        img = img * (1 - brow) + 0.2 * brow
        eye = ellipse(yy, xx, cy - 10 + dy, ex, 4, 7, angle)[..., None]
        img = img * (1 - eye) + eye
        iris = ellipse(yy, xx, cy - 10 + dy, ex + rng.uniform(-2, 2), 3, 3)
        img = img * (1 - iris[..., None]) + rng.uniform(0, 0.4, 3) * iris[
            ..., None]
    nose = ellipse(yy, xx, cy + 5, cx, 10, 4, angle)[..., None]
    img = img * (1 - 0.3 * nose) + 0.3 * nose * skin * 0.7
    mouth = ellipse(yy, xx, cy + 22 + dy, cx, 4, 14 + rng.uniform(-3, 3),
                    angle)[..., None]
    img = img * (1 - mouth) + np.array([0.6, 0.2, 0.25]) * mouth
    return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "ssl_rec"))
    args = p.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    builder = RecBuilder(args.out, (SIZE, SIZE))
    decoded = []
    for i in range(N):
        buf = io.BytesIO()
        Image.fromarray(face(rng)).save(buf, "JPEG", quality=95)
        builder.add_image(buf.getvalue(), float(i // PER_ID))
        if i < 4:
            decoded.append(np.asarray(Image.open(io.BytesIO(buf.getvalue()))
                                      .convert("RGB")))
    builder.close()
    np.save(os.path.join(args.out, "decoded_ref.npy"), np.stack(decoded))
    img, refs = Image.fromarray(face(rng)), []
    for name, im, kw in (("444", img, dict(subsampling=0)),
                         ("422", img, dict(subsampling=1)),
                         ("gray", img.convert("L"), {})):
        path = os.path.join(args.out, f"layout_{name}.jpg")
        im.save(path, "JPEG", quality=95, **kw)
        refs.append(np.asarray(Image.open(path).convert("RGB")))
    np.save(os.path.join(args.out, "layouts_ref.npy"), np.stack(refs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
