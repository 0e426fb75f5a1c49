"""Part-fViT, the landmark-conditioned face ViT (counterpart of
``lafs_cvpr2024_tpu/models/partfvit.py``).

Ported: the ``with_land`` image path (MobileNetV3 landmark regressor →
Dropout(0.5) in training → min-max rescale → patch gather at the landmarks
→ transformer → LayerNorm of the CLS token → the CosFace head when labels
are given), in eval and in training, where the gradient flows through the
gather into the regressor and its BatchNorm trains; the pre-gathered token
path in eval and training mode (the SSL path); embedding dropout, dropout
and drop path drawn from a :class:`~.layers.DropoutRNG`; and the SSL
``LandmarkProvider``. The other variants (standcoord, raw patchify, global
token, SimMIM, the ArcFace/SFace/Softmax heads, ``random_coor``, the
``return_tokens``/``x_noaug``/``random_prob``/``glo_diff`` forward options)
raise and are queued in ROADMAP.md.

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
from .heads import CosFace, init_xavier_
from .layers import DropoutRNG, FastDropout, Transformer
from .mobilenet import MobileNetV3Backbone


@dataclass(frozen=True)
class PartFViTConfig:
    """Same fields and names as the JAX config. The impl defaults differ:
    the port serves through its kernels (``gather_impl='kernel'``,
    ``mlp_impl='fused_ln'``), which run their plain PyTorch versions only
    for CPU tensors; ``'gather'``/``'dense'`` is the plain configuration.
    ``attn_impl='fused'`` (kernels 6 and 7) is the supervised step's
    default (``train/supervised.py``), ``'einsum'`` the served one."""

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
    attn_impl: str = "einsum"          # 'einsum' | 'fused'
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
                      dropout: FastDropout, x: torch.Tensor,
                      num_landmarks: int, coord_scale: float,
                      rng: Optional[DropoutRNG] = None):
    """NHWC image → ((B, N, 2) pixel landmarks, (B, C) pooled features):
    mean-pooled stem features, Dropout(0.5) (training only; hard-coded in
    the JAX module, ``partfvit.py:115``, as flax ``nn.Dropout``, whose keep
    probability 0.5 :class:`~.layers.FastDropout` draws exactly), the
    landmark head, min-max rescale."""
    pooled = stn(x).mean(dim=(1, 2))
    theta = output_layer(dropout(pooled, rng))
    return minmax_rescale_landmarks(theta, num_landmarks, coord_scale), pooled


class LandmarkRegressor(nn.Module):
    """MobileNetV3 stem + landmark head: image → (B, N, 2) pixel coords
    (reference ``stn`` + ``output_layer``, ``ViT_face.py:578,599-602``)."""

    def __init__(self, num_landmarks: int = 196, stn_mode: str = "large",
                 coord_scale: float = 111.0):
        super().__init__()
        self.num_landmarks, self.coord_scale = num_landmarks, coord_scale
        self.stn = MobileNetV3Backbone(stn_mode)
        self.dropout = FastDropout(0.5)
        self.output_layer = nn.Linear(self.stn.out_channels, num_landmarks * 2)

    def forward(self, x, rng: Optional[DropoutRNG] = None):
        return regress_landmarks(self.stn, self.output_layer, self.dropout, x,
                                 self.num_landmarks, self.coord_scale, rng)


class LandmarkProvider(LandmarkRegressor):
    """Frozen landmark CNN of the SSL step (``partfvit.py:303-364``): image
    → (theta, patch tokens). Landmarks come from the CLEAN view ``x``, the
    patches from the augmented view ``x_aug``; ``jitter_std`` adds
    N(0, jitter_std²) px noise and ``ran_sample`` keeps that many landmarks
    drawn with replacement, both from ``generator`` (on x's device). Same
    ``stn.*``/``output_layer.*`` keys as :class:`LandmarkRegressor`; call it
    in eval mode under ``torch.no_grad()``."""

    def __init__(self, num_landmarks: int = 196, patch_size: int = 8,
                 stn_mode: str = "large", coord_scale: float = 111.0,
                 gather_impl: str = "kernel"):
        super().__init__(num_landmarks, stn_mode, coord_scale)
        self.patch_size, self.gather_impl = patch_size, gather_impl

    def forward(self, x, x_aug=None, generator=None, jitter_std: float = 0.0,
                ran_sample: int = 0, random_coor: bool = False):
        if random_coor:
            raise NotImplementedError(
                "random_coor landmarks are not ported yet (ROADMAP.md, Open "
                "items 1.4)")
        theta, _ = super().forward(x)
        if jitter_std > 0:
            theta = theta + jitter_std * torch.randn(
                theta.shape, generator=generator, device=theta.device,
                dtype=theta.dtype)
        if ran_sample:
            idx = torch.randint(0, theta.shape[1], (x.shape[0], ran_sample),
                                generator=generator, device=theta.device)
            theta = torch.gather(theta, 1, idx[..., None].expand(-1, -1, 2))
        src = x if x_aug is None else x_aug
        return theta, patch_gather(src, theta, self.patch_size,
                                   impl=self.gather_impl)


class PartFViT(nn.Module):
    """Images (B, H, W, C) NHWC, or pre-gathered tokens (B, N, P·P·C) →
    (B, dim) embeddings, or ``(logits, landmarks)`` when ``labels`` are
    given and the config has a margin head (``loss_type='CosFace'``).
    Training mode takes a :class:`~.layers.DropoutRNG` when any rate is
    above 0 (the landmark branch's Dropout(0.5) included)."""

    def __init__(self, cfg: PartFViTConfig):
        super().__init__()
        unported = [name for name in ("use_standcoord", "use_global_token",
                                      "simmim") if getattr(cfg, name)]
        if unported:
            raise NotImplementedError(
                f"PartFViT variants {unported} are not ported yet "
                "(ROADMAP.md, Open items 1.13)"
            )
        if cfg.loss_type not in ("None", "CosFace"):
            raise NotImplementedError(
                f"the {cfg.loss_type} head is not ported yet (ROADMAP.md, "
                "Open items 1.11)")
        if cfg.pool not in ("cls", "mean"):
            raise ValueError(f"unknown pool {cfg.pool!r}")
        self.cfg = cfg
        if cfg.with_land:
            self.stn = MobileNetV3Backbone(cfg.stn_mode, cfg.bn_axis_name)
            self.landmark_dropout = FastDropout(0.5)
            self.output_layer = nn.Linear(self.stn.out_channels,
                                          cfg.num_patches * 2)
        patch_dim = cfg.patch_size ** 2 * cfg.channels
        self.patch_to_embedding = nn.Linear(patch_dim, cfg.dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        self.pos_embedding = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, cfg.dim))
        self.emb_dropout = FastDropout(cfg.emb_dropout)
        self.transformer = Transformer(
            cfg.dim, cfg.depth, cfg.heads, cfg.dim_head, cfg.mlp_dim,
            cfg.dropout, cfg.drop_path_rate, cfg.attn_impl, cfg.mlp_impl,
        )
        self.mlp_head = nn.Sequential(nn.LayerNorm(cfg.dim, eps=1e-5))
        if cfg.loss_type == "CosFace":
            self.loss = CosFace(cfg.dim, cfg.num_classes, cfg.cosface_s,
                                cfg.cosface_m)

    def landmarks(self, x: torch.Tensor,
                  rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """NHWC image → (B, N, 2) landmarks in pixels of [0, image_size-1]."""
        theta, _ = regress_landmarks(self.stn, self.output_layer,
                                     self.landmark_dropout, x,
                                     self.cfg.num_patches,
                                     float(self.cfg.image_size - 1), rng)
        return theta

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None, *,
                return_tokens: bool = False, x_noaug=None,
                random_prob: bool = False, glo_diff: bool = False):
        """``labels``: (B,) ints or (B, C) soft rows for the margin head."""
        cfg = self.cfg
        if return_tokens or x_noaug is not None or random_prob or glo_diff:
            raise NotImplementedError(
                "PartFViT's return_tokens/x_noaug/random_prob/glo_diff "
                "forward options are not ported yet (ROADMAP.md, Open "
                "items 1.13)")
        theta = None
        if x.ndim == 4:
            if not cfg.with_land:
                raise NotImplementedError(
                    "raw-patchify image input (with_land=False) is not "
                    "ported yet (ROADMAP.md, Open items 1.2)"
                )
            theta = self.landmarks(x, rng)
            tokens = patch_gather(x, theta, cfg.patch_size,
                                  impl=cfg.gather_impl)
        else:
            tokens = x  # pre-gathered tokens (the SSL multi-crop path)
        tokens = self.patch_to_embedding(tokens)
        b, n, _ = tokens.shape
        h = torch.cat([self.cls_token.expand(b, -1, -1), tokens], dim=1)
        h = h + self.pos_embedding[:, : n + 1]
        h = self.transformer(self.emb_dropout(h, rng), rng)
        pooled = h.mean(dim=1) if cfg.pool == "mean" else h[:, 0]
        emb = self.mlp_head(pooled)
        if labels is not None and cfg.loss_type != "None":
            return self.loss(emb, labels), theta
        return emb


def init_random_(model: nn.Module, seed: int) -> nn.Module:
    """Fill ``model`` in place with random weights from ``seed`` on the
    flax initializers' scales: Linear/Conv weights N(0, 1/fan_in), biases
    0, norm scales 1, ``cls_token``/``pos_embedding`` N(0, 1), the CosFace
    ``loss.weight`` xavier-uniform, BatchNorm running stats (0, 1). Drawn
    with numpy, so the same seed gives the same weights on every device."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32) * np.float32(std))

    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "loss.weight":
                init_xavier_(p, rng)
                continue
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
