"""Loss functions (counterpart of ``lafs_cvpr2024_tpu/train/losses.py``):
the DINO loss of the SSL step and the soft-target cross-entropy of
supervised finetuning, on one device.

The center's cross-device all-reduce (``losses.py:75-80``) comes with the
port's multi-GPU step; here the batch mean is the local one.
"""

from __future__ import annotations

from typing import Tuple

import torch


def softmax_cross_entropy(logits: torch.Tensor,
                          soft_targets: torch.Tensor) -> torch.Tensor:
    """timm ``SoftTargetCrossEntropy`` (``losses.py:18-20``): the batch mean
    of ``Σ −t · log_softmax(logits)``, in the logits' dtype."""
    return torch.sum(-soft_targets * torch.log_softmax(logits, dim=-1),
                     dim=-1).mean()


def dino_loss(student_output: torch.Tensor, teacher_output: torch.Tensor,
              center: torch.Tensor, teacher_temp: float, n_crops: int,
              student_temp: float = 0.1, center_momentum: float = 0.9
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DINO loss and the updated center (``losses.py:28-82``).

    ``student_output`` (n_crops·B, K) and ``teacher_output`` (2·B, K) are
    head logits stacked crop-major (crop 0's rows first); ``center`` is
    (1, K) or (K,). All math runs in fp32. Cross-entropy of the centred,
    sharpened teacher softmax of each global crop against the student
    log-softmax of every other crop, averaged over the 2·(n_crops − 1)
    pairs; the center moves by an EMA of the teacher's batch mean. The
    teacher side carries no gradient."""
    f32 = torch.float32
    k = student_output.shape[-1]
    center = center.reshape(1, k).to(f32)
    student = (student_output.to(f32) / student_temp).reshape(n_crops, -1, k)
    teacher_output = teacher_output.detach().to(f32)
    teacher = torch.softmax((teacher_output - center) / teacher_temp, dim=-1)
    teacher = teacher.reshape(2, -1, k)
    logp = torch.log_softmax(student, dim=-1)
    total, n_terms = 0.0, 0
    for iq in range(2):
        for v in range(n_crops):
            if v == iq:
                continue
            total = total + torch.sum(-teacher[iq] * logp[v], dim=-1).mean()
            n_terms += 1
    loss = total / n_terms
    batch_center = teacher_output.sum(0, keepdim=True) / teacher_output.shape[0]
    new_center = center * center_momentum + batch_center * (1 - center_momentum)
    return loss, new_center
