"""Make the benchmark's face crops: 512 face-like 112 × 112 RGB images
(a skin-toned face on a gradient background, brows, eyes, nose and mouth,
each with its own pose, colours and lighting), encoded as JPEG quality 95
with 4:2:0 chroma (as MS1M's crops are stored), and PIL's (libjpeg's)
decode of each, the pixels the reference starts from.

    python bench_torch/data/make_faces.py

writes ``faces.bin`` (the JPEGs back to back), ``faces.json`` (their
offsets and lengths) and ``faces_decoded.npz`` (uint8 (512, 112, 112, 3))
beside this file. Needs PIL; the benchmark itself reads the outputs only.
"""

import io
import json
import os

import numpy as np
from PIL import Image

N, SIZE = 512, 112
HERE = os.path.dirname(os.path.abspath(__file__))


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


def main() -> None:
    rng = np.random.default_rng(2024)
    blobs, decoded = [], []
    for _ in range(N):
        buf = io.BytesIO()
        Image.fromarray(face(rng)).save(buf, "JPEG", quality=95)
        blobs.append(buf.getvalue())
        decoded.append(np.asarray(Image.open(io.BytesIO(blobs[-1]))
                                  .convert("RGB")))
    offsets = np.cumsum([0] + [len(b) for b in blobs[:-1]]).tolist()
    with open(os.path.join(HERE, "faces.bin"), "wb") as f:
        f.write(b"".join(blobs))
    with open(os.path.join(HERE, "faces.json"), "w") as f:
        json.dump({"offsets": offsets, "lengths": [len(b) for b in blobs],
                   "size": SIZE}, f)
    np.savez_compressed(os.path.join(HERE, "faces_decoded.npz"),
                        faces=np.stack(decoded))


if __name__ == "__main__":
    main()
