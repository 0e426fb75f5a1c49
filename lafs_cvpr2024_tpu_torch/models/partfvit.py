"""Part-fViT, the landmark-conditioned face ViT (counterpart of
``lafs_cvpr2024_tpu/models/partfvit.py``), eval only.

Ported: the ``with_land`` image path (MobileNetV3 landmark regressor →
min-max rescale → patch gather at the landmarks → transformer → LayerNorm
of the CLS token) and the pre-gathered token path. The other variants
(standcoord, raw patchify, global token, SimMIM, margin heads) raise and
are queued in ROADMAP.md.

Module names follow the reference ``state_dict``: the landmark stem sits at
the top level as ``stn.*`` and ``output_layer.*`` (the JAX package nests
them under a ``landmark`` scope; its exporter lifts them back out).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.patch_gather import patch_gather
from .layers import Transformer
from .mobilenet import MobileNetV3Backbone


@dataclass(frozen=True)
class PartFViTConfig:
    """Same fields and names as the JAX config. The impl defaults differ:
    the port serves through its kernels (``gather_impl='kernel'``,
    ``mlp_impl='fused_ln'``), which fall back to their plain PyTorch
    versions only for CPU tensors; ``'gather'``/``'dense'`` is the plain
    configuration."""

    image_size: int = 112
    patch_size: int = 8
    num_patches: int = 196
    dim: int = 768
    depth: int = 12
    heads: int = 11
    dim_head: int = 64
    mlp_dim: int = 2048
    channels: int = 3
    dropout: float = 0.1
    emb_dropout: float = 0.1
    drop_path_rate: float = 0.1
    pool: str = "cls"                  # 'cls' | 'mean'
    with_land: bool = True
    use_standcoord: bool = False
    random_prob: bool = False
    shuffle: bool = False
    loss_type: str = "CosFace"
    num_classes: int = 205990
    cosface_m: float = 0.4
    cosface_s: float = 64.0
    gather_impl: str = "kernel"        # 'kernel' | 'gather'
    attn_impl: str = "einsum"
    mlp_impl: str = "fused_ln"         # 'fused_ln' | 'dense'
    remat_policy: str = "none"
    bn_axis_name: Optional[str] = None
    stn_mode: str = "large"
    simmim: bool = False
    use_global_token: bool = False


def minmax_rescale_landmarks(theta: torch.Tensor, num_landmarks: int,
                             scale: float = 111.0) -> torch.Tensor:
    """Min-max rescale of the raw regressor output to [0, scale] pixels over
    the WHOLE 2·N vector (reference ``ViT_face.py:694-698``), then
    (B, N, 2) with ``[..., 0]=x``."""
    t_max = theta.amax(dim=1, keepdim=True)
    t_min = theta.amin(dim=1, keepdim=True)
    theta = (theta - t_min) / (t_max - t_min + 1e-12) * scale
    return theta.reshape(-1, num_landmarks, 2)


def regress_landmarks(stn: MobileNetV3Backbone, output_layer: nn.Linear,
                      x: torch.Tensor, num_landmarks: int,
                      coord_scale: float):
    """NHWC image → ((B, N, 2) pixel landmarks, (B, C) pooled features)."""
    pooled = stn(x).mean(dim=(1, 2))
    theta = output_layer(pooled)  # Dropout(0.5) before it is the identity in eval
    return minmax_rescale_landmarks(theta, num_landmarks, coord_scale), pooled


class LandmarkRegressor(nn.Module):
    """MobileNetV3 stem + landmark head: image → (B, N, 2) pixel coords
    (reference ``stn`` + ``output_layer``, ``ViT_face.py:578,599-602``)."""

    def __init__(self, num_landmarks: int = 196, stn_mode: str = "large",
                 coord_scale: float = 111.0):
        super().__init__()
        self.num_landmarks, self.coord_scale = num_landmarks, coord_scale
        self.stn = MobileNetV3Backbone(stn_mode)
        self.output_layer = nn.Linear(self.stn.out_channels, num_landmarks * 2)

    def forward(self, x):
        return regress_landmarks(self.stn, self.output_layer, x,
                                 self.num_landmarks, self.coord_scale)


class PartFViT(nn.Module):
    """Images (B, H, W, C) NHWC, or pre-gathered tokens (B, N, P·P·C) →
    (B, dim) embeddings."""

    def __init__(self, cfg: PartFViTConfig):
        super().__init__()
        unported = [name for name in ("use_standcoord", "use_global_token",
                                      "simmim") if getattr(cfg, name)]
        if unported:
            raise NotImplementedError(
                f"PartFViT variants {unported} are not ported yet "
                "(ROADMAP.md, Open items 1.13)"
            )
        if cfg.pool not in ("cls", "mean"):
            raise ValueError(f"unknown pool {cfg.pool!r}")
        self.cfg = cfg
        if cfg.with_land:
            self.stn = MobileNetV3Backbone(cfg.stn_mode)
            self.output_layer = nn.Linear(self.stn.out_channels,
                                          cfg.num_patches * 2)
        patch_dim = cfg.patch_size ** 2 * cfg.channels
        self.patch_to_embedding = nn.Linear(patch_dim, cfg.dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        self.pos_embedding = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, cfg.dim))
        self.transformer = Transformer(
            cfg.dim, cfg.depth, cfg.heads, cfg.dim_head, cfg.mlp_dim,
            cfg.dropout, cfg.attn_impl, cfg.mlp_impl,
        )
        self.mlp_head = nn.Sequential(nn.LayerNorm(cfg.dim, eps=1e-5))

    def landmarks(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image → (B, N, 2) landmarks in pixels of [0, image_size-1]."""
        theta, _ = regress_landmarks(self.stn, self.output_layer, x,
                                     self.cfg.num_patches,
                                     float(self.cfg.image_size - 1))
        return theta

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if self.training:
            raise NotImplementedError(
                "PartFViT is ported for eval only (call .eval()); training "
                "comes with the train-step port (ROADMAP.md, Open items 1.7)"
            )
        if x.ndim == 4:
            if not cfg.with_land:
                raise NotImplementedError(
                    "raw-patchify image input (with_land=False) is not "
                    "ported yet (ROADMAP.md, Open items 1.2)"
                )
            tokens = patch_gather(x, self.landmarks(x), cfg.patch_size,
                                  impl=cfg.gather_impl)
        else:
            tokens = x  # pre-gathered tokens (the SSL multi-crop path)
        tokens = self.patch_to_embedding(tokens)
        b, n, _ = tokens.shape
        h = torch.cat([self.cls_token.expand(b, -1, -1), tokens], dim=1)
        h = h + self.pos_embedding[:, : n + 1]
        h = self.transformer(h)
        pooled = h.mean(dim=1) if cfg.pool == "mean" else h[:, 0]
        return self.mlp_head(pooled)


def init_random_(model: nn.Module, seed: int) -> nn.Module:
    """Fill ``model`` in place with random weights from ``seed`` on the
    flax initializers' scales: Linear/Conv weights N(0, 1/fan_in), biases
    0, norm scales 1, ``cls_token``/``pos_embedding`` N(0, 1), BatchNorm
    running stats (0, 1). Drawn with numpy, so the same seed gives the same
    weights on every device."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32) * np.float32(std))

    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in ("cls_token", "pos_embedding"):
                val = normal(p.shape, 1.0)
            elif leaf == "weight" and p.ndim >= 2:
                fan_in = int(np.prod(p.shape[1:]))
                val = normal(p.shape, fan_in ** -0.5)
            elif leaf == "weight":
                val = torch.ones(p.shape)
            else:
                val = torch.zeros(p.shape)
            p.copy_(val)
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
    return model
