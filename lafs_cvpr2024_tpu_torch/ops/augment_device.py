"""Device-side input scaling and the LAFS multi-crop (counterpart of
``lafs_cvpr2024_tpu/ops/augment_device.py``: ``scale_uint8`` and
``lafs_multicrop_device`` with its ops, ``:99-286, 343-376``).

The whole 20-crop transform runs on the card on the raw uint8 batch, in
plain PyTorch: bicubic random resized crops as two interpolation-matrix
products, flip, colour jitter, grayscale, a 9-tap Gaussian blur as two
banded-matrix products, solarize. No TPU kernel is behind it (JAX runs it
as XLA einsums). The JAX function's documented deviations from the PIL
transform stay: single-try crops with clamping, the jitter's sub-ops in a
fixed order, the exact HSV hue rotation.

The draws (``draw_lafs_multicrop``: random numbers from a
``torch.Generator`` on the images' device) are apart from the ops
(``*_apply``: pure functions of the images and the drawn tensors), so a
test can feed an op the numbers ``jax.random`` drew and compare with the
JAX op, whose random stream torch cannot reproduce. The multi-crop runs
each op once over the rows of all its crop pairs: the host issues a few
hundred small ops a batch, not a few hundred a pair. Images are NHWC
float32 in [0, 1] inside; the multi-crop returns [-1, 1] crops.
"""

from __future__ import annotations

import math

import torch

from ..utils import tracing

#: ImageNet statistics — the vanilla-DINO convention (``lafs_train.py:
#: 751-753``) for ``--arch vit_*`` checkpoints.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

#: valid ``scale_uint8`` conventions, in CLI-flag order
INPUT_SCALES = ("half", "unit", "imagenet")

_LUMA = (0.299, 0.587, 0.114)
_F32 = torch.float32


def scale_uint8(x: torch.Tensor, mode: str = "unit") -> torch.Tensor:
    """uint8 (or float) NHWC image → float32 in the model's input
    convention: ``"unit"`` → x/255·2−1 (training), ``"half"`` → x/255−0.5
    (the reference eval convention, ``IJB_evaluation.py:444``),
    ``"imagenet"`` → per-channel (x/255−mean)/std, channel-last. Always
    computes in fp32 on ``x``'s device."""
    x = x.to(torch.float32)
    if mode == "unit":
        return x / 255.0 * 2.0 - 1.0
    if mode == "half":
        return x / 255.0 - 0.5
    if mode == "imagenet":
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
        return (x / 255.0 - mean) / std
    raise ValueError(
        f"scale_uint8: unknown mode {mode!r} ({'|'.join(INPUT_SCALES)})"
    )


def _rand(gen, shape) -> torch.Tensor:
    """U[0, 1) in fp32 on ``gen``'s device, ``jax.random.uniform``'s base
    draw."""
    return torch.rand(shape, generator=gen, device=gen.device, dtype=_F32)


# ---------------------------------------------------------------------------
# geometric: random resized crop via interpolation-matrix products
# ---------------------------------------------------------------------------

def _cubic_weights(t: torch.Tensor) -> torch.Tensor:
    """Catmull-Rom/Keys cubic (a = −0.5, PIL/torch BICUBIC): the weights of
    the taps at offsets (−1, 0, 1, 2) for the fractional position t."""
    a = -0.5
    t1, t2, t3 = t + 1.0, 1.0 - t, 2.0 - t
    w0 = a * t1 ** 3 - 5 * a * t1 ** 2 + 8 * a * t1 - 4 * a
    w1 = (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1
    w2 = (a + 2) * t2 ** 3 - (a + 3) * t2 ** 2 + 1
    w3 = a * t3 ** 3 - 5 * a * t3 ** 2 + 8 * a * t3 - 4 * a
    return torch.stack([w0, w1, w2, w3], dim=-1)


def _resize_matrix(starts, sizes, in_size: int, out_size: int):
    """Per-image bicubic resampling matrix (B, out_size, in_size) for the
    crop [start, start + size) → out_size; edge taps clamp (PIL replicates
    edges inside the crop box)."""
    o = torch.arange(out_size, dtype=_F32, device=starts.device)
    src = starts[:, None] + (o[None, :] + 0.5) * (sizes[:, None] / out_size) - 0.5
    i0 = torch.floor(src)
    w = _cubic_weights(src - i0)                          # (B, out, 4)
    m = torch.zeros((starts.shape[0], out_size, in_size), dtype=_F32,
                    device=starts.device)
    for k in range(4):
        idx = torch.clamp(i0 + (k - 1), 0, in_size - 1).long()
        hit = torch.nn.functional.one_hot(idx, in_size).to(_F32)
        m = m + hit * w[..., k:k + 1]
    return m


def random_resized_crop_apply(images, out_size: int, area, log_r, ux, uy):
    """Batched bicubic RandomResizedCrop (B, H, W, C) → (P·B, S, S, C) of
    one drawn box per row of the draws (``random_resized_crop_batch`` for
    P = 1): P·B rows, pair-major, crop the batch P times without copying
    it P times."""
    b, h, w, c = images.shape
    aspect = torch.exp(log_r)
    cw = torch.clamp(torch.round(torch.sqrt(area * aspect)), 1, w)
    ch = torch.clamp(torch.round(torch.sqrt(area / aspect)), 1, h)
    my = _resize_matrix(uy * (h - ch), ch, h, out_size)   # (P·B, S, H)
    mx = _resize_matrix(ux * (w - cw), cw, w, out_size)   # (P·B, S, W)
    tmp = torch.einsum("pboh,bhwc->pbowc", my.view(-1, b, out_size, h), images)
    return torch.einsum("npw,nowc->nopc", mx,
                        tmp.reshape(-1, out_size, w, c)).contiguous()


# ---------------------------------------------------------------------------
# photometric ops (inputs in [0, 1])
# ---------------------------------------------------------------------------

def _grayscale(x):
    # an asynchronous copy: a blocking one waits for the card's queue
    luma = torch.tensor(_LUMA, dtype=x.dtype).to(x.device, non_blocking=True)
    return torch.einsum("...c,c->...", x, luma)[..., None].expand_as(x)


def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = x.amax(-1)
    mn = x.amin(-1)
    d = mx - mn
    safe_d = torch.where(d > 0, d, torch.ones_like(d))
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe_d, 6.0),
        torch.where(mx == g, (b - r) / safe_d + 2.0, (r - g) / safe_d + 4.0),
    ) / 6.0
    h = torch.where(d > 0, h, torch.zeros_like(h))
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    h6 = h * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.long(), 6)[None]

    # stacked along a new first dim: contiguous copies, not strided ones
    def pick(*vals):
        return torch.stack(vals).gather(0, i)[0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def color_jitter_apply(x, fb, fc, fs, fh):
    """torchvision ColorJitter semantics, per-image factors, fixed order
    (``color_jitter_batch``)."""
    x = torch.clamp(x * fb, 0, 1)
    gray_mean = _grayscale(x)[..., :1].mean(dim=(1, 2, 3), keepdim=True)
    x = torch.clamp((x - gray_mean) * fc + gray_mean, 0, 1)
    x = torch.clamp(_grayscale(x) + (x - _grayscale(x)) * fs, 0, 1)
    h, s, v = _rgb_to_hsv(x)
    return torch.clamp(_hsv_to_rgb(torch.remainder(h + fh, 1.0), s, v), 0, 1)


def random_grayscale_apply(x, mask):
    """``random_grayscale_batch`` for a drawn (b, 1, 1, 1) mask."""
    return torch.where(mask, _grayscale(x), x)


def _banded(wts, size: int):
    """(B, size, size) blur matrix, renormalised at the borders (PIL clips
    and renormalises the kernel)."""
    b, taps = wts.shape
    r = taps // 2
    i = torch.arange(size, device=wts.device)
    d = i[None, :, None] - i[None, None, :]
    m = torch.zeros((b, size, size), dtype=_F32, device=wts.device)
    for k in range(taps):
        m = m + (d == (k - r)).to(_F32) * wts[:, k, None, None]
    return m / torch.clamp(m.sum(dim=2, keepdim=True), min=1e-8)


def gaussian_blur_apply(x, sigma, apply, taps: int = 9):
    """PIL GaussianBlur with a per-image sigma as two banded-matrix
    products, where ``apply`` (``gaussian_blur_batch``)."""
    _, h, w, _ = x.shape
    r = taps // 2
    offs = torch.arange(-r, r + 1, dtype=_F32, device=x.device)
    wts = torch.exp(-0.5 * (offs[None, :] / sigma[:, None]) ** 2)
    wts = wts / wts.sum(dim=1, keepdim=True)              # (B, taps)
    blurred = torch.einsum("bij,bjwc->biwc", _banded(wts, h), x)
    blurred = torch.einsum("bkw,biwc->bikc", _banded(wts, w), blurred)
    return torch.where(apply, blurred, x)


def solarize_apply(x, mask, threshold: float = 128 / 255):
    """``solarize_batch`` for a drawn mask."""
    return torch.where(mask & (x >= threshold), 1.0 - x, x)


def random_flip_apply(x, mask):
    """``random_flip_batch`` (horizontal) for a drawn mask."""
    return torch.where(mask, x.flip(2), x)


# ---------------------------------------------------------------------------
# the full LAFS multi-crop
# ---------------------------------------------------------------------------

#: One crop pair's draws in the order the generator makes them (the crop
#: box, flip, jitter, its four factors, grayscale, blur sigma and mask;
#: global 2 then draws its solarize mask), each (b,) + (1,) * (ndim − 1).
_DRAWS = (("area", 1), ("log_r", 1), ("ux", 1), ("uy", 1), ("flip", 4),
          ("jitter", 4), ("fb", 4), ("fc", 4), ("fs", 4), ("fh", 3),
          ("gray", 4), ("sigma", 1), ("blur", 4))
#: U[lo, hi) of the draws that are not kept as drawn or compared
_RANGES = dict(log_r=(math.log(3 / 4), math.log(4 / 3)), fb=(0.6, 1.4),
               fc=(0.6, 1.4), fs=(0.8, 1.2), fh=(-0.1, 0.1), sigma=(0.1, 2.0))
#: blur probability of global 1, global 2 and the local crops
_BLUR_P = (1.0, 0.1, 0.5)
#: solarize probability of global 2 (the other crops never solarize)
_SOLARIZE_P = 0.2


def draw_lafs_multicrop(gen, b: int, h: int, w: int,
                        local_crops_number: int = 8,
                        global_crops_scale=(0.4, 1.0)) -> dict:
    """The draws of :func:`lafs_multicrop_apply` for its P = 2 + L crop
    pairs, one row per (pair, image), pair-major: the crop box, flip,
    jitter (applied with probability 0.8) and its factors, grayscale, blur
    and solarize (False outside global 2). ``gen`` is called pair by pair
    in a fixed order and shapes, the stream the benchmark's reference
    repeats; the ranges and comparisons are formed once over all rows."""
    n = 2 + local_crops_number
    u = {k: [] for k, _ in _DRAWS}
    for i in range(n):
        for k, nd in _DRAWS:
            u[k].append(_rand(gen, (b,) + (1,) * (nd - 1)))
        if i == 1:
            u_sol = _rand(gen, (b, 1, 1, 1))
    u = {k: torch.cat(v) for k, v in u.items()}
    r = {k: u[k] * (hi - lo) + lo for k, (lo, hi) in _RANGES.items()}
    lo, hi = global_crops_scale
    blur_p = torch.full((n, 1, 1, 1, 1), _BLUR_P[2], dtype=_F32,
                        device=gen.device)
    blur_p[0], blur_p[1] = _BLUR_P[0], _BLUR_P[1]
    solarize = torch.zeros((n * b, 1, 1, 1), dtype=torch.bool,
                           device=gen.device)
    solarize[b:2 * b] = u_sol < _SOLARIZE_P
    return dict(
        crop=dict(area=h * w * (u["area"] * (hi - lo) + lo),
                  log_r=r["log_r"], ux=u["ux"], uy=u["uy"]),
        flip=u["flip"] < 0.5, jitter=u["jitter"] < 0.8,
        color=dict(fb=r["fb"], fc=r["fc"], fs=r["fs"], fh=r["fh"]),
        gray=u["gray"] < 0.2,
        blur=dict(sigma=r["sigma"],
                  apply=(u["blur"].view(n, b, 1, 1, 1) < blur_p).view(
                      n * b, 1, 1, 1)),
        solarize=solarize)


def lafs_multicrop_apply(images_uint8, draws, out_size: int = 112):
    """(B, H, W, 3) uint8 → ``(glob_clean, glob_aug, loc_clean, loc_aug)``,
    (2, B, S, S, 3) and (L, B, S, S, 3) float32 in [-1, 1], for the drawn
    rows of :func:`draw_lafs_multicrop`. Each (clean, aug) pair shares its
    crop and flip, the landmark-consistency property of LAFS; local crops
    use the global scale at full resolution (``lafs_train.py:852-858``).
    Every op runs once over the P·B rows of all pairs: the pairs differ
    only in their draws."""
    b = images_uint8.shape[0]
    n = draws["flip"].shape[0] // b
    tracing.count("multicrop.pairs", n)
    x = images_uint8.to(_F32) / 255.0
    geo = random_resized_crop_apply(x, out_size, **draws["crop"])
    geo = random_flip_apply(torch.clamp(geo, 0.0, 1.0), draws["flip"])
    # flip_and_color_jitter minus the flip (``lafs_train.py:792-798``)
    aug = torch.where(draws["jitter"],
                      color_jitter_apply(geo, **draws["color"]), geo)
    aug = gaussian_blur_apply(random_grayscale_apply(aug, draws["gray"]),
                              **draws["blur"])
    aug = solarize_apply(aug, draws["solarize"])
    clean = (geo * 2.0 - 1.0).view(n, b, *geo.shape[1:])
    aug = (aug * 2.0 - 1.0).contiguous().view(n, b, *geo.shape[1:])
    return clean[:2], aug[:2], clean[2:], aug[2:]


def lafs_multicrop_device(images_uint8, gen, local_crops_number: int = 8,
                          out_size: int = 112, global_crops_scale=(0.4, 1.0)):
    """The LAFS 2 + L crop multi-crop of a uint8 batch on its device, its
    randomness from ``gen`` (a ``torch.Generator`` there): the layout and
    ranges of the JAX ``lafs_multicrop_device``."""
    b, h, w, _ = images_uint8.shape
    draws = draw_lafs_multicrop(gen, b, h, w, local_crops_number,
                                global_crops_scale)
    return lafs_multicrop_apply(images_uint8, draws, out_size)
