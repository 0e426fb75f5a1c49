"""PyTorch port: landmark patch gather (ops/patch_gather.py + kernel 1).

The port's plain gather is held against the JAX Pallas kernel (interpret
mode) and the JAX ``mxu`` form on the same numpy inputs, with
out-of-frame and fractional landmarks, on images in the served input range
(``scale_uint8(..., 'half')``, [-0.5, 0.5]). Max abs ≤ 1e-5 in fp32: the
two JAX forms differ by ~5e-6 from each other at these inputs, because the
Pallas form takes the bilinear fractions of coordinates shifted by its
18-pixel padding (fp32 spacing 1.5e-5 at 128). The CUDA kernel is held
against this plain version on the card (test_torch_cuda_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lafs_cvpr2024_tpu.ops.patch_gather import patch_gather as jax_patch_gather
from lafs_cvpr2024_tpu.ops.patch_gather_pallas import patch_gather_pallas
from lafs_cvpr2024_tpu_torch import _build
from lafs_cvpr2024_tpu_torch.ops.patch_gather import (
    patch_gather,
    patch_gather_plain,
)


def _inputs(seed, b, h, w, n, lo, hi, far=True):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(-0.5, 0.5, (b, h, w, 3)).astype(np.float32)
    lands = rng.uniform(lo, hi, (b, n, 2)).astype(np.float32)
    if far:  # beyond the ±(P+1) clamp, on every side
        lands[:, 0] = (-1000.0, 40.0)
        lands[:, 1] = (w + 500.0, 20.0)
        lands[:, 2] = (10.0, -300.0)
        lands[:, 3] = (30.0, h + 1e6)
        lands[:, 4] = (0.0, 0.0)
        lands[:, 5] = (w - 1.0, h - 1.0)
    return imgs, lands


@pytest.mark.parametrize("n_land", [16, 196])
def test_plain_matches_jax_pallas_and_mxu(n_land):
    imgs, lands = _inputs(0, 2, 112, 112, n_land, -12.0, 124.0)
    got = patch_gather_plain(torch.from_numpy(imgs), torch.from_numpy(lands), 8)
    assert got.shape == (2, n_land, 192) and got.dtype == torch.float32
    pallas = np.asarray(patch_gather_pallas(
        jnp.asarray(imgs), jnp.asarray(lands), 8, interpret=True))
    mxu = np.asarray(jax_patch_gather(
        jnp.asarray(imgs), jnp.asarray(lands), 8, impl="mxu"))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), mxu, rtol=0, atol=1e-5)


def test_plain_nonsquare_other_patch_size():
    imgs, lands = _inputs(1, 1, 64, 48, 9, -3.0, 50.0, far=False)
    got = patch_gather_plain(torch.from_numpy(imgs), torch.from_numpy(lands), 4)
    ref = np.asarray(jax_patch_gather(
        jnp.asarray(imgs), jnp.asarray(lands), 4, impl="gather"))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_kernel_impl_on_cpu_runs_the_plain_version():
    imgs, lands = _inputs(2, 2, 32, 32, 7, -4.0, 36.0)
    ti, tl = torch.from_numpy(imgs), torch.from_numpy(lands)
    before = _build.LAUNCHES["patch_gather"]
    got = patch_gather(ti, tl, 4, impl="kernel")
    assert torch.equal(got, patch_gather_plain(ti, tl, 4))
    assert _build.LAUNCHES["patch_gather"] == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="unknown patch_gather impl"):
        patch_gather(ti, tl, 4, impl="mxu")


def test_plain_bf16_images_compute_in_fp32():
    imgs, lands = _inputs(3, 1, 32, 32, 5, 0.0, 31.0, far=False)
    ti = torch.from_numpy(imgs).to(torch.bfloat16)
    tl = torch.from_numpy(lands).to(torch.bfloat16)
    got = patch_gather_plain(ti, tl, 4)
    assert got.dtype == torch.bfloat16
    want = patch_gather_plain(ti.float(), tl.float(), 4).to(torch.bfloat16)
    assert torch.equal(got, want)
