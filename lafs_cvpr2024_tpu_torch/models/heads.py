"""Heads (counterpart of ``lafs_cvpr2024_tpu/models/heads.py``): the DINO
head of the SSL step and the CosFace margin head of supervised finetuning.

Module names give the reference keys that the JAX exporter writes
(``train/checkpoint.py:1131-1147``): ``mlp.{0,2,4}.{weight,bias}`` for the
DINO head's three Linear layers with exact GELUs between them, and
``last_layer.weight_{g,v}`` for its weight-normed last layer; the margin
head's (C, D) class centres are ``weight`` (``loss.weight`` under
Part-fViT). ArcFace, SFace and Softmax heads are not ported yet
(ROADMAP.md, Open items 1.11).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x / max(‖x‖, eps)`` along ``dim`` (``heads.py::_l2norm``)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def cosface_logits(embeddings: torch.Tensor, weight: torch.Tensor,
                   labels: torch.Tensor, s: float = 64.0, m: float = 0.4,
                   num_classes: int | None = None) -> torch.Tensor:
    """CosFace ``s · (cos θ − m · y)`` (``heads.py:28-39``) with the (C, D)
    ``weight`` rows as class centres, in the embeddings' dtype. ``labels``
    are (B,) ints or (B, C) soft rows (mixup), which scale the margin by the
    soft label value (``ViT_face.py:69-73``)."""
    cosine = l2norm(embeddings) @ l2norm(weight).t()
    if labels.ndim > 1:
        one_hot = labels.to(cosine.dtype)
    else:
        one_hot = F.one_hot(labels.long(), num_classes or weight.shape[0]
                            ).to(cosine.dtype)
    return s * (cosine - m * one_hot)


class CosFace(nn.Module):
    """CosFace margin head over ``out_features`` classes (``heads.py:42-55``);
    ``weight`` (out, in), xavier-uniform at init (:func:`init_xavier_`)."""

    def __init__(self, in_features: int, out_features: int, s: float = 64.0,
                 m: float = 0.4):
        super().__init__()
        self.s, self.m = float(s), float(m)
        self.weight = nn.Parameter(torch.empty(out_features, in_features))

    def forward(self, embeddings, labels):
        return cosface_logits(embeddings, self.weight, labels, self.s, self.m,
                              self.weight.shape[0])


def init_xavier_(weight: torch.Tensor, rng: np.random.Generator) -> None:
    """Fill a (out, in) weight in place with U(−b, b), b = √(6 / (in + out))
    (flax ``xavier_uniform``), drawn with numpy from ``rng``."""
    bound = np.float32(np.sqrt(6.0 / (weight.shape[0] + weight.shape[1])))
    u = rng.random(tuple(weight.shape), dtype=np.float32)
    with torch.no_grad():
        weight.copy_(torch.from_numpy((2.0 * u - 1.0) * bound))


class WeightNormLinear(nn.Module):
    """Bias-free linear layer with ``w = g · v / ‖v‖`` row-wise (torch
    ``weight_norm`` with dim 0): ``weight_g`` (out, 1), ``weight_v``
    (out, in)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(out_dim, 1))
        self.weight_v = nn.Parameter(torch.empty(out_dim, in_dim))

    def forward(self, x):
        return x @ (self.weight_g * l2norm(self.weight_v, dim=1)).t()


class DINOHead(nn.Module):
    """DINO projection head (``heads.py:124-175``): MLP → L2 normalise →
    weight-normed last layer. ``norm_last_layer`` is the optimizer's
    business (the gain is gated out of its gradient, ``train/optim.py``),
    so the tree keeps ``weight_g`` either way."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256, nlayers: int = 3,
                 use_bn: bool = False):
        super().__init__()
        if use_bn:
            raise NotImplementedError(
                "DINOHead(use_bn=True) is not ported yet (ROADMAP.md, Open "
                "items 1.5)")
        if nlayers == 1:
            layers = [nn.Linear(in_dim, bottleneck_dim)]
        else:
            layers = [nn.Linear(in_dim, hidden_dim), nn.GELU()]
            for _ in range(nlayers - 2):
                layers += [nn.Linear(hidden_dim, hidden_dim), nn.GELU()]
            layers.append(nn.Linear(hidden_dim, bottleneck_dim))
        self.mlp = nn.Sequential(*layers)
        self.last_layer = WeightNormLinear(bottleneck_dim, out_dim)

    def forward(self, x):
        return self.last_layer(l2norm(self.mlp(x)))


def init_dino_head_(head: DINOHead, seed: int) -> DINOHead:
    """Fill ``head`` in place from ``seed`` on the JAX head's initializers:
    Linear weights and ``weight_v`` truncated N(0, 0.02²) (cut at ±2σ),
    biases 0, ``weight_g`` 1. Drawn with numpy, so the same seed gives the
    same weights on every device."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in head.named_parameters():
            if name.endswith("weight_g"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                v = rng.standard_normal(p.shape, dtype=np.float32)
                while (bad := np.abs(v) > 2.0).any():
                    v[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
                p.copy_(torch.from_numpy(v * np.float32(0.02)))
    return head
