"""Kernel 1: the landmark patch gather as a hand-written CUDA kernel.

Counterpart of ``lafs_cvpr2024_tpu/ops/patch_gather_pallas.py::
patch_gather_pallas`` (Pallas ``_kernel``); the source is
``csrc/patch_gather.cu``, whose header says what bounds it on the card.
Its plain PyTorch version is ``ops.patch_gather.patch_gather_plain``.
"""

from __future__ import annotations

import torch

from .. import _build


def patch_gather_cuda(images: torch.Tensor, landmarks: torch.Tensor,
                      patch_size: int = 8) -> torch.Tensor:
    """(B, H, W, C) CUDA images + (B, N, 2) landmarks → (B, N, P*P*C)
    tokens in the image dtype, computed in fp32 by the kernel."""
    # the image and landmark dtypes are the kernel's arguments, apart
    _build.check_operands("patch_gather_cuda", images, landmarks,
                          one_dtype=False)
    if images.ndim != 4 or landmarks.ndim != 3 or landmarks.shape[-1] != 2 \
            or landmarks.shape[0] != images.shape[0]:
        raise ValueError(
            f"patch_gather_cuda: images {tuple(images.shape)} must be "
            f"(B,H,W,C) and landmarks {tuple(landmarks.shape)} (B,N,2)"
        )
    if patch_size < 1:
        raise ValueError(f"patch_size must be positive, got {patch_size}")
    images = images.contiguous()
    landmarks = landmarks.contiguous()
    b, h, w, c = images.shape
    n = landmarks.shape[1]
    out = torch.empty((b, n, patch_size * patch_size * c),
                      dtype=images.dtype, device=images.device)
    _build.launch("patch_gather", images, images.data_ptr(),
                  landmarks.data_ptr(), out.data_ptr(), b, h, w, c, n,
                  patch_size, int(images.dtype == torch.bfloat16),
                  int(landmarks.dtype == torch.bfloat16))
    return out
