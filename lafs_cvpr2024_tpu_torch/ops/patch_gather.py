"""Landmark patch extraction (counterpart of ``lafs_cvpr2024_tpu/ops/
patch_gather.py``).

For every landmark ``(lx, ly)`` a ``P x P`` patch is sampled bilinearly with
``grid_sample(align_corners=False, padding_mode='zeros')`` semantics on

    x(i) = lx + i - P/2 - 0.5      (i = 0..P-1, indexes image *width*)
    y(j) = ly + j - P/2 - 0.5      (j = 0..P-1, indexes image *height*)

Landmark coordinate 0 is **x**; token features are flattened in
``(x_off, y_off, c)`` order — the reference's transposition quirk, kept for
checkpoint interop. Layouts follow the JAX package: NHWC images, (B, N, 2)
landmarks.
"""

from __future__ import annotations

import torch

IMPLS = ("kernel", "gather")


def patch_gather(images: torch.Tensor, landmarks: torch.Tensor,
                 patch_size: int = 8, impl: str = "kernel") -> torch.Tensor:
    """(B, H, W, C) images + (B, N, 2) landmarks → (B, N, P*P*C) tokens.

    ``impl='kernel'`` launches the CUDA kernel (``ops/patch_gather_cuda``)
    for a CUDA tensor and runs its plain PyTorch version for a CPU tensor;
    ``impl='gather'`` always runs the plain version (the reference
    configuration the kernel is held against on the card).
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown patch_gather impl {impl!r} ({IMPLS})")
    if impl == "kernel" and images.is_cuda:
        from .patch_gather_cuda import patch_gather_cuda

        return patch_gather_cuda(images, landmarks, patch_size)
    return patch_gather_plain(images, landmarks, patch_size)


def patch_gather_plain(images: torch.Tensor, landmarks: torch.Tensor,
                       patch_size: int = 8) -> torch.Tensor:
    """The plain PyTorch 4-corner gather (JAX ``_patch_gather_indexed``):
    the CPU path and the CUDA kernel's oracle. Computes in fp32 and returns
    the image dtype. Landmarks are clamped to ±(P+1) beyond the frame as the
    kernel does; that far out a patch samples only zeros either way."""
    b, h, w, c = images.shape
    p = patch_size
    lm = landmarks.float()
    lx = lm[..., 0].clamp(-(p + 1.0), w + p + 1.0)
    ly = lm[..., 1].clamp(-(p + 1.0), h + p + 1.0)
    offs = torch.arange(p, dtype=torch.float32, device=images.device) - p / 2
    x = (lx[..., None] + offs) - 0.5                      # (B, N, P) over i
    y = (ly[..., None] + offs) - 0.5                      # (B, N, P) over j
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx = (x - x0f)[..., :, None]                          # (B, N, P, 1)
    wy = (y - y0f)[..., None, :]                          # (B, N, 1, P)
    x0, y0 = x0f.long(), y0f.long()
    flat = images.reshape(b, h * w, c).float()

    def corner(ix, iy):
        # (B, N, P_i, P_j, C) values at integer corners, zero outside
        ixe, iye = ix[..., :, None], iy[..., None, :]
        inside = (ixe >= 0) & (ixe < w) & (iye >= 0) & (iye < h)
        lin = iye.clamp(0, h - 1) * w + ixe.clamp(0, w - 1)  # (B,N,P,P)
        vals = torch.gather(
            flat, 1, lin.reshape(b, -1, 1).expand(-1, -1, c)
        ).reshape(*lin.shape, c)
        return torch.where(inside[..., None], vals, 0.0)

    w00 = (1.0 - wx) * (1.0 - wy)
    w01 = (1.0 - wx) * wy
    w10 = wx * (1.0 - wy)
    w11 = wx * wy
    out = (corner(x0, y0) * w00[..., None] + corner(x0, y0 + 1) * w01[..., None]
           + corner(x0 + 1, y0) * w10[..., None]
           + corner(x0 + 1, y0 + 1) * w11[..., None])
    return out.reshape(b, landmarks.shape[1], p * p * c).to(images.dtype)
