"""MobileNetV3 landmark backbone (counterpart of ``lafs_cvpr2024_tpu/models/
mobilenet.py``), BatchNorm in eval and training.

Module names follow the reference ``state_dict`` (``mobilenet.py:96-109``):
``features.0`` is the conv-BN-hswish stem, ``features.{i+1}.conv`` the i-th
bottleneck as a Sequential (0 pw conv, 1 BN, 3 depthwise conv, 4 BN,
5 SE with ``fc.0``/``fc.2``, 7 pw-linear conv, 8 BN). Convolutions run in
PyTorch's NCHW; :class:`MobileNetV3Backbone` takes and returns NHWC like
the JAX module.

BatchNorm is :class:`FlaxBatchNorm2d`: in training it normalises with the
batch statistics and moves the running statistics as flax ``BatchNorm``
does (``layers.py::SyncableBN``), which ``torch.nn.BatchNorm2d`` does not.
"""

from __future__ import annotations

import torch
from torch import nn

# (kernel, exp, out, se, activation, stride) — identical to the JAX package
# and to reference mobilenet.py:125-158.
LARGE_SETTING = [
    (3, 16, 16, False, "RE", 1),
    (3, 64, 24, False, "RE", 2),
    (3, 72, 24, False, "RE", 1),
    (5, 72, 40, True, "RE", 2),
    (5, 120, 40, True, "RE", 1),
    (5, 120, 40, True, "RE", 1),
    (3, 240, 80, False, "HS", 2),
    (3, 200, 80, False, "HS", 1),
    (3, 184, 80, False, "HS", 1),
    (3, 184, 80, False, "HS", 1),
    (3, 480, 112, True, "HS", 1),
    (3, 672, 112, True, "HS", 1),
    (5, 672, 160, True, "HS", 2),
    (5, 960, 160, True, "HS", 1),
    (5, 960, 160, True, "HS", 1),
]
SMALL_SETTING = [
    (3, 16, 16, True, "RE", 2),
    (3, 72, 24, False, "RE", 2),
    (3, 88, 24, False, "RE", 1),
    (5, 96, 40, True, "HS", 2),
    (5, 240, 40, True, "HS", 1),
    (5, 240, 40, True, "HS", 1),
    (5, 120, 48, True, "HS", 1),
    (5, 144, 48, True, "HS", 1),
    (5, 288, 96, True, "HS", 2),
    (5, 576, 96, True, "HS", 1),
    (5, 576, 96, True, "HS", 1),
]


def hswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hsigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


class HSwish(nn.Module):
    def forward(self, x):
        return hswish(x)


class HSigmoid(nn.Module):
    def forward(self, x):
        return hsigmoid(x)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d with flax's training statistics (momentum 0.9, eps 1e-5;
    ``layers.py:75-92``). In training it normalises x with the batch mean
    and the biased batch variance, both reduced in fp32 (at least) in flax's
    form
    (E[x²] − E[x]², whose gradient the backward follows), and updates the
    running statistics in place as ``0.9 · running + 0.1 · batch`` with the
    BIASED variance, where ``torch.nn.BatchNorm2d`` takes the unbiased one.
    ``num_batches_tracked`` stays as loaded (flax keeps no count). Eval is
    ``nn.BatchNorm2d``'s, on the running statistics."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        # flax's fast variance E[x²] − E[x]², clipped at 0 (_compute_stats)
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean.detach())
            self.running_var.mul_(0.9).add_(0.1 * var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias.to(xf.dtype)[:, None, None]).to(x.dtype)


def _act(name: str) -> nn.Module:
    return HSwish() if name == "HS" else nn.ReLU()


class ConvBN(nn.Sequential):
    """Conv (no bias) → BatchNorm → ReLU/hswish."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, act: str = "RE"):
        super().__init__(
            nn.Conv2d(in_ch, out_ch, kernel, stride, (kernel - 1) // 2,
                      bias=False),
            FlaxBatchNorm2d(out_ch),
            _act(act),
        )


class SEModule(nn.Module):
    """Squeeze-excite on NCHW: mean → fc → ReLU → fc → hsigmoid → scale."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False),
            nn.ReLU(),
            nn.Linear(channels // reduction, channels, bias=False),
            HSigmoid(),
        )

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class MobileBottleneck(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 exp_ch: int, se: bool, act: str):
        super().__init__()
        # residual only at stride 1 with equal widths (JAX mobilenet.py:114)
        self.residual = stride == 1 and in_ch == out_ch
        self.conv = nn.Sequential(
            nn.Conv2d(in_ch, exp_ch, 1, bias=False),
            FlaxBatchNorm2d(exp_ch),
            _act(act),
            nn.Conv2d(exp_ch, exp_ch, kernel, stride, (kernel - 1) // 2,
                      groups=exp_ch, bias=False),
            FlaxBatchNorm2d(exp_ch),
            SEModule(exp_ch) if se else nn.Identity(),
            _act(act),
            nn.Conv2d(exp_ch, out_ch, 1, bias=False),
            FlaxBatchNorm2d(out_ch),
        )

    def forward(self, x):
        h = self.conv(x)
        return x + h if self.residual else h


class MobileNetV3Backbone(nn.Module):
    """Headless MobileNetV3: NHWC image → NHWC final feature map
    (160 channels for ``mode='large'``, 96 for ``'small'``). ``axis_name``
    (SyncBatchNorm across devices) raises: training on more than one GPU is
    not ported yet."""

    def __init__(self, mode: str = "large", axis_name: str | None = None):
        super().__init__()
        if mode not in ("large", "small"):
            raise ValueError(f"unknown MobileNetV3 mode {mode!r}")
        if axis_name is not None:
            raise NotImplementedError(
                f"SyncBatchNorm over {axis_name!r} needs more than one GPU, "
                "which the port does not train on yet (ROADMAP.md, Open "
                "items 1.11)")
        setting = LARGE_SETTING if mode == "large" else SMALL_SETTING
        blocks = [ConvBN(3, 16, 3, 2, "HS")]
        in_ch = 16
        for k, exp, c, se, nl, s in setting:
            blocks.append(MobileBottleneck(in_ch, c, k, s, exp, se, nl))
            in_ch = c
        self.features = nn.Sequential(*blocks)
        self.out_channels = in_ch

    def forward(self, x):
        # NHWC in memory is NCHW in channels_last: a free permute
        feat = self.features(x.permute(0, 3, 1, 2))
        return feat.permute(0, 2, 3, 1)

    def shift_invariant_biases(self) -> list:
        """Parameter names of the BatchNorm biases whose gradient is zero in
        exact arithmetic in training, for any weights: the last BatchNorm
        of every bottleneck upstream of the last one without a residual
        path. A per-channel shift there reaches the output only through 1x1
        convs into another training-mode BatchNorm, which removes it, so two
        implementations' gradients there are both rounding noise."""
        blocks = list(self.features)[1:]
        last = max(i for i, b in enumerate(blocks, 1) if not b.residual)
        return [f"features.{i}.conv.8.bias" for i in range(1, last)]
