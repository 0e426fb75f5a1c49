"""Face alignment of a batch on the device (counterpart of
``lafs_cvpr2024_tpu/data/native.py::decode_warp_batch``, the C++
``warp_bilinear`` of ``native/lafs_dataplane.cc:138-180`` and the numpy
``eval/ijb.py::warp_affine``). It is no TPU kernel: plain PyTorch ops.

:func:`warp_affine_batch` is the inverse bilinear warp with border 0 that
``warp_affine`` computes, in the same arithmetic: the inverse map from
``np.linalg.inv`` on the host, source coordinates and tap weights in
float64, the four taps accumulated into a float32 image in the numpy
function's order (each float64 sum rounded to float32), and the result
TRUNCATED to uint8, not rounded. So it gives ``warp_affine``'s pixels. A
degenerate or non-finite matrix (a rank-0 Umeyama fit is NaN) gives a
zero image, as both host warps do.

:func:`decode_warp_batch` decodes loose-crop JPEGs of any sizes with
``data/decode.py`` (nvJPEG on the card, one call per size) and aligns
them. The Umeyama fit stays on the host in numpy (``eval/ijb.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..data.decode import decode_batch, jpeg_dims

_F32, _F64 = torch.float32, torch.float64


def inverse_maps(mats) -> tuple:
    """Forward (B, 2, 3) src→dst affines → ``(inverse (B, 2, 3) float64,
    valid (B,) bool)``, each inverse as ``warp_affine`` computes it; an
    invalid (degenerate or non-finite) matrix gets a zero inverse."""
    mats = np.asarray(mats, np.float64)
    inv = np.zeros((len(mats), 2, 3))
    ok = np.zeros(len(mats), bool)
    for i, m in enumerate(mats):
        det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
        if np.isfinite(m).all() and abs(det) >= 1e-12:
            inv[i] = np.linalg.inv(np.vstack([m, [0, 0, 1]]))[:2]
            ok[i] = True
    return inv, ok


def warp_affine_batch(images: torch.Tensor, mats, size) -> torch.Tensor:
    """Warp uint8 images (B, H, W, C) by forward affines ``mats`` (B, 2, 3)
    (numpy, ``umeyama(...)[:2]``) to (B, oh, ow, C) uint8 on the images'
    device; ``size`` is an int or (oh, ow)."""
    oh, ow = (size, size) if isinstance(size, int) else size
    b, h, w, c = images.shape
    dev = images.device
    inv, ok = inverse_maps(mats)
    mi = torch.from_numpy(inv).to(dev)
    valid_img = torch.from_numpy(ok).to(dev)[:, None, None]
    ys = torch.arange(oh, device=dev, dtype=_F32)[:, None].expand(oh, ow)
    xs = torch.arange(ow, device=dev, dtype=_F32)[None, :].expand(oh, ow)
    xs, ys = xs.to(_F64), ys.to(_F64)

    def coord(r):
        a, bb, cc = (mi[:, r, j, None, None] for j in range(3))
        return a * xs + bb * ys + cc

    src_x, src_y = coord(0), coord(1)
    fx0, fy0 = torch.floor(src_x), torch.floor(src_y)
    wx, wy = src_x - fx0, src_y - fy0
    x0 = torch.where(valid_img, fx0, 0.0).to(torch.int64)
    y0 = torch.where(valid_img, fy0, 0.0).to(torch.int64)
    flat = images.reshape(-1, c)
    base = torch.arange(b, device=dev)[:, None, None] * (h * w)
    out = torch.zeros((b, oh, ow, c), dtype=_F32, device=dev)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h) & valid_img
            weight = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
            idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            tap = flat[idx].to(_F64) * weight[..., None] * valid[..., None]
            out = (out.to(_F64) + tap).to(_F32)
    return out.to(torch.uint8)


def decode_warp_batch(jpegs: Sequence[bytes], mats, device,
                      out_size: int = 112) -> torch.Tensor:
    """Decode JPEGs of any sizes on ``device`` and align each by its
    forward affine: (n, out_size, out_size, 3) uint8 on ``device``. Images
    of one size decode and warp as one batch."""
    mats = np.asarray(mats, np.float64)
    out = torch.empty((len(jpegs), out_size, out_size, 3), dtype=torch.uint8,
                      device=device)
    groups: dict = {}
    for i, data in enumerate(jpegs):
        groups.setdefault(jpeg_dims(data, device), []).append(i)
    for idx in groups.values():
        imgs = decode_batch([jpegs[i] for i in idx], device)
        rows = torch.as_tensor(idx, device=out.device)
        out[rows] = warp_affine_batch(imgs, mats[idx], out_size)
    return out
