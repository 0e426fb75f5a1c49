"""Device-side input scaling (counterpart of ``scale_uint8`` in
``lafs_cvpr2024_tpu/ops/augment_device.py``; the augmentations are not
ported yet)."""

from __future__ import annotations

import torch

#: ImageNet statistics — the vanilla-DINO convention (``lafs_train.py:
#: 751-753``) for ``--arch vit_*`` checkpoints.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

#: valid ``scale_uint8`` conventions, in CLI-flag order
INPUT_SCALES = ("half", "unit", "imagenet")


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
