"""PyTorch port: the device LAFS multi-crop (``ops/augment_device.py``)
against the JAX package's ``ops/augment_device.py``.

``jax.random`` and ``torch.Generator`` draw different numbers, so each
port op is an apply function of drawn parameters: the tests draw them by
repeating the JAX function's own key splits and draws, feed them to the
port, and compare with the JAX op run on the same key. Images are fp32 in
[0, 1] made from a seed with numpy (non-square, 40 × 48, to catch a
swapped axis). Tolerance: 1e-5 absolute in [0, 1] (2e-5 on the [-1, 1]
crops), summation order of the interpolation and blur products only.

The port's own multi-crop runs every op once over the rows of all its
crop pairs; it is also held to the same ops applied pair by pair, to the
benchmark's plain reference on one seeded generator (the draw stream),
and to a count of the ops it dispatches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bench_torch.reference import ssl as bench_ref
from lafs_cvpr2024_tpu.ops import augment_device as jad
from lafs_cvpr2024_tpu_torch.ops import augment_device as tad
from lafs_cvpr2024_tpu_torch.utils import tracing

B, H, W = 3, 40, 48


def _images(seed=0):
    """Smooth colour fields with sharp edges, in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    out = []
    for _ in range(B):
        a = rng.uniform(0, 1, (3, 3))
        img = np.stack([np.clip(a[c, 0] + a[c, 1] * np.sin(6 * xx + c)
                                * np.cos(4 * yy) + a[c, 2] * (xx > 0.5), 0, 1)
                        for c in range(3)], -1)
        out.append(img)
    return np.asarray(out, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _crop_draws(key, b, h, w, scale, ratio=(3 / 4, 4 / 3)):
    """``random_resized_crop_batch``'s draws, repeated from its key."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return dict(
        area=_t(h * w * jax.random.uniform(k1, (b,), minval=scale[0],
                                           maxval=scale[1])),
        log_r=_t(jax.random.uniform(k2, (b,), minval=jnp.log(ratio[0]),
                                    maxval=jnp.log(ratio[1]))),
        ux=_t(jax.random.uniform(k3, (b,))), uy=_t(jax.random.uniform(k4, (b,))))


def _jitter_draws(key, b):
    kb, kc, ks, kh = jax.random.split(key, 4)
    s = (b, 1, 1, 1)
    return dict(fb=_t(jax.random.uniform(kb, s, minval=0.6, maxval=1.4)),
                fc=_t(jax.random.uniform(kc, s, minval=0.6, maxval=1.4)),
                fs=_t(jax.random.uniform(ks, s, minval=0.8, maxval=1.2)),
                fh=_t(jax.random.uniform(kh, (b, 1, 1), minval=-0.1,
                                         maxval=0.1)))


def _mask(key, p, b):
    return _t(jax.random.bernoulli(key, p, (b, 1, 1, 1)))


def _blur_draws(key, p, b, rmin=0.1, rmax=2.0):
    k1, k2 = jax.random.split(key)
    return dict(sigma=_t(jax.random.uniform(k1, (b,), minval=rmin,
                                            maxval=rmax)),
                apply=_mask(k2, p, b))


def _pair_draws(key, b, h, w, i, scale=(0.4, 1.0)):
    """One crop pair's draws of ``lafs_multicrop_device``, key by key."""
    kg, kf, kp = jax.random.split(key, 3)
    k1, k2, k3 = jax.random.split(kp, 3)
    j1, j2, j3 = jax.random.split(k1, 3)
    blur_p, solarize_p = (1.0, 0.0) if i == 0 else (
        (0.1, 0.2) if i == 1 else (0.5, 0.0))
    d = dict(crop=_crop_draws(kg, b, h, w, scale), flip=_mask(kf, 0.5, b),
             jitter=_mask(j1, 0.8, b), color=_jitter_draws(j2, b),
             gray=_mask(j3, 0.2, b), blur=_blur_draws(k2, blur_p, b))
    if solarize_p > 0:
        d["solarize"] = _mask(k3, solarize_p, b)
    return d


def _stack_pairs(pairs, b):
    """Per-pair draws → the pair-major rows ``lafs_multicrop_apply`` takes
    (solarize False for the pairs that draw none)."""
    def cat(vals):
        if isinstance(vals[0], dict):
            return {k: cat([v[k] for v in vals]) for k in vals[0]}
        return torch.cat(vals)
    out = cat([{k: v for k, v in d.items() if k != "solarize"}
               for d in pairs])
    out["solarize"] = torch.cat([d.get("solarize", torch.zeros(
        (b, 1, 1, 1), dtype=torch.bool)) for d in pairs])
    return out


def _rows(draws, i, b):
    """Pair ``i``'s rows of the stacked draws."""
    if isinstance(draws, dict):
        return {k: _rows(v, i, b) for k, v in draws.items()}
    return draws[i * b:(i + 1) * b]


def _uint8_images(seed, b=B, h=H, w=W):
    return torch.from_numpy((np.random.default_rng(seed).uniform(
        0, 1, (b, h, w, 3)) * 255).astype(np.uint8))


def _err(got, want):
    return np.abs(got.numpy().astype(np.float64) - np.asarray(want)).max()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scale", [(0.4, 1.0), (0.05, 0.4)])
def test_random_resized_crop_matches_jax(seed, scale):
    x = _images(seed)
    key = jax.random.PRNGKey(seed)
    want = jad.random_resized_crop_batch(key, jnp.asarray(x), 32, scale)
    got = tad.random_resized_crop_apply(_t(x), 32,
                                        **_crop_draws(key, B, H, W, scale))
    assert got.shape == want.shape == (B, 32, 32, 3)
    assert _err(got, want) <= 1e-5


def test_resize_matrix_matches_jax_at_the_edges():
    """Boxes that start at 0, end at the last pixel, span the whole axis,
    are one pixel wide, or sit at fractional offsets."""
    starts = np.array([0.0, 0.0, 47.0, 20.5, 0.25, 30.0], np.float32)
    sizes = np.array([48.0, 12.0, 1.0, 27.5, 47.75, 18.0], np.float32)
    for out in (16, 48, 112):
        want = jad._resize_matrix(jnp.asarray(starts), jnp.asarray(sizes), 48,
                                  out)
        got = tad._resize_matrix(_t(starts), _t(sizes), 48, out)
        assert _err(got, want) <= 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_color_jitter_matches_jax(seed):
    x = _images(seed)
    # saturated reds and magentas: hues at 0 and near 1, which the ±0.1
    # shift wraps around
    x[:, :8, :8] = np.array([0.9, 0.095, 0.1], np.float32)    # hue 0.999
    x[:, 8:16, :8] = np.array([0.9, 0.1, 0.095], np.float32)  # hue 0.001
    x[:, :8, 8:16] = np.array([0.95, 0.1, 0.9], np.float32)
    key = jax.random.PRNGKey(10 + seed)
    want = jad.color_jitter_batch(key, jnp.asarray(x))
    draws = _jitter_draws(key, B)
    got = tad.color_jitter_apply(_t(x), **draws)
    assert _err(got, want) <= 1e-5
    # the wrap-around really happened: a red's hue crossed 0 or 1
    h, _, _ = tad._rgb_to_hsv(_t(x[:, :16, :8]))
    shifted = h + draws["fh"]
    assert bool((shifted < 0).any()) or bool((shifted >= 1).any())


def test_hsv_round_trip_matches_jax():
    x = _images(3)
    hw, sw, vw = jad._rgb_to_hsv(jnp.asarray(x))
    h, s, v = tad._rgb_to_hsv(_t(x))
    for a, b in ((h, hw), (s, sw), (v, vw)):
        assert _err(a, b) <= 1e-6
    assert _err(tad._hsv_to_rgb(h, s, v), jad._hsv_to_rgb(hw, sw, vw)) <= 1e-6


def test_grayscale_solarize_flip_match_jax():
    x = _images(4)
    for i, (p, jfn, tfn) in enumerate((
            (0.5, jad.random_grayscale_batch, tad.random_grayscale_apply),
            (0.5, jad.solarize_batch, tad.solarize_apply),
            (0.5, jad.random_flip_batch, tad.random_flip_apply))):
        key = jax.random.PRNGKey(20 + i)
        want = jfn(key, jnp.asarray(x), p)
        mask = _mask(key, p, B)
        assert 0 < int(mask.sum()) < B or i  # a mix of applied and not
        assert _err(tfn(_t(x), mask), want) <= 1e-6


@pytest.mark.parametrize("sigma", [0.1, 2.0, None])
def test_gaussian_blur_matches_jax(sigma):
    """σ at both ends of the range and drawn from it; p = 0.5."""
    x = _images(5)
    rmin, rmax = (sigma, sigma) if sigma else (0.1, 2.0)
    key = jax.random.PRNGKey(30)
    want = jad.gaussian_blur_batch(key, jnp.asarray(x), 0.5, rmin, rmax)
    got = tad.gaussian_blur_apply(_t(x), **_blur_draws(key, 0.5, B, rmin, rmax))
    assert _err(got, want) <= 1e-5


def test_lafs_multicrop_matches_jax():
    """The whole 2 + 2 crop transform on uint8 images, the port fed every
    pair's draws from the JAX function's keys."""
    imgs = (np.random.default_rng(6).uniform(0, 1, (B, H, W, 3)) * 255
            ).astype(np.uint8)
    key = jax.random.PRNGKey(40)
    want = jad.lafs_multicrop_device(key, jnp.asarray(imgs),
                                     local_crops_number=2, out_size=32)
    keys = jax.random.split(key, 4)
    draws = _stack_pairs([_pair_draws(keys[i], B, H, W, i)
                          for i in range(4)], B)
    got = tad.lafs_multicrop_apply(_t(imgs), draws, out_size=32)
    shapes = ((2, B, 32, 32, 3), (2, B, 32, 32, 3), (2, B, 32, 32, 3),
              (2, B, 32, 32, 3))
    for g, w, s in zip(got, want, shapes):
        assert g.shape == w.shape == s and g.dtype == torch.float32
        assert _err(g, w) <= 2e-5


def test_lafs_multicrop_device_layout_and_ranges():
    """The port's own draws: the JAX layout, [-1, 1], each pair's clean
    crop sharing its geometry with the aug crop (identical where no
    photometric op fired), and the same result from the same seed."""
    imgs = torch.from_numpy((np.random.default_rng(7).uniform(
        0, 1, (4, 112, 112, 3)) * 255).astype(np.uint8))
    outs = [tad.lafs_multicrop_device(
        imgs, torch.Generator().manual_seed(3), local_crops_number=8)
        for _ in range(2)]
    gc, ga, lc, la = outs[0]
    assert gc.shape == ga.shape == (2, 4, 112, 112, 3)
    assert lc.shape == la.shape == (8, 4, 112, 112, 3)
    for t in outs[0]:
        assert t.dtype == torch.float32
        assert t.min().item() >= -1.0 and t.max().item() <= 1.0
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    other = tad.lafs_multicrop_device(imgs, torch.Generator().manual_seed(4))
    assert not torch.equal(other[0], gc)


def _per_pair(images_uint8, draws, n_pairs, out_size):
    """The multi-crop composed pair by pair from the module's ops: crop,
    clamp, flip, jitter where drawn, grayscale, blur, solarize (global 2),
    ×2−1."""
    b = images_uint8.shape[0]
    x = images_uint8.float() / 255.0
    clean, aug = [], []
    for i in range(n_pairs):
        d = _rows(draws, i, b)
        geo = tad.random_resized_crop_apply(x, out_size, **d["crop"])
        geo = tad.random_flip_apply(torch.clamp(geo, 0.0, 1.0), d["flip"])
        y = torch.where(d["jitter"], tad.color_jitter_apply(geo, **d["color"]),
                        geo)
        y = tad.gaussian_blur_apply(tad.random_grayscale_apply(y, d["gray"]),
                                    **d["blur"])
        if i == 1:
            y = tad.solarize_apply(y, d["solarize"])
        else:
            assert not d["solarize"].any()
        clean.append(geo * 2.0 - 1.0)
        aug.append(y * 2.0 - 1.0)
    return (torch.stack(clean[:2]), torch.stack(aug[:2]),
            torch.stack(clean[2:]), torch.stack(aug[2:]))


@pytest.mark.parametrize("local_crops", [2, 8])
def test_lafs_multicrop_equals_the_per_pair_composition(local_crops):
    """One chain over the rows of all 2 + L pairs computes each pair's
    crops as the ops applied to that pair alone."""
    imgs = _uint8_images(8)
    draws = tad.draw_lafs_multicrop(torch.Generator().manual_seed(9), B, H,
                                    W, local_crops)
    got = tad.lafs_multicrop_apply(imgs, draws, out_size=32)
    want = _per_pair(imgs, draws, 2 + local_crops, 32)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape and g.is_contiguous()
        assert (g - w_).abs().max().item() <= 1e-6


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_lafs_multicrop_draws_the_benchmark_reference_stream(seed):
    """The generator calls in the order and shapes the benchmark's plain
    reference makes them: the same crops from the same seed (a reordered
    or merged draw flips masks and misses by orders of magnitude)."""
    imgs = _uint8_images(10)
    got = tad.lafs_multicrop_device(imgs, torch.Generator().manual_seed(seed),
                                    8, out_size=32)
    want = bench_ref.multicrop(imgs, torch.Generator().manual_seed(seed), 8,
                               32, (0.4, 1.0))
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        assert (g - w_).abs().max().item() <= 1e-5


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_lafs_multicrop_ops_barely_grow_with_the_pairs():
    """The host issues the apply's ops once for all pairs: at L = 8 at most
    1.5× the ops of L = 2 (a loop over the pairs gives ~2.5×), and the
    tracer counts 2 + L pairs a call."""
    imgs = _uint8_images(11, 2, 16, 16)
    counts = {}
    tracing.reset()
    tracing.enable(True)
    try:
        for n_loc in (2, 8):
            with _OpCount() as c:
                tad.lafs_multicrop_device(imgs, torch.Generator().manual_seed(1),
                                          n_loc, out_size=16)
            counts[n_loc] = c.n
            assert tracing.export()["counters"]["multicrop.pairs"] == 2 + n_loc
            tracing.reset()
    finally:
        tracing.enable(False)
        tracing.reset()
    assert counts[8] <= 1.5 * counts[2], counts
