"""Fixed-grid patch tokens (counterpart of ``patchify`` in
``lafs_cvpr2024_tpu/ops/patchify.py``): the reference's ``rearrange``
tokenisation (``ViT_face.py:760``) of the grid Part-fViT variants and the
SimMIM grid step (``use_landmarks=False``). A reshape and a permute: XLA
leaves it to the compiler too, and no kernel of the JAX package carries it.
"""

from __future__ import annotations

import torch


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) → (B, H/P · W/P, P·P·C) tokens, row-major over the patch
    grid, each flattened as (row offset, column offset, channel): torch
    ``rearrange('b c (h p1) (w p2) -> b (h w) (p1 p2 c)')`` on NCHW."""
    b, h, w, c = images.shape
    p = patch_size
    if h % p or w % p:
        raise ValueError(f"patchify: image {h}x{w} is not a whole number of "
                         f"{p}x{p} patches")
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)
