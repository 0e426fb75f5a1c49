"""Batch-mode Mixup/CutMix on the device (counterpart of
``lafs_cvpr2024_tpu/ops/mixup.py``, ``mode='batch'``).

The shipped recipe (``mixup_alpha=0.2, cutmix_alpha=0, prob=0.1,
switch_prob=0.5, label_smoothing=0``) mixes the whole batch with its
mirror (element i with element B−1−i) and builds soft one-hot targets.
The random draws are four host scalars per batch (apply, use CutMix, λ, the
box), taken from a numpy ``Generator`` (:func:`draw_mixup`);
:func:`mix_with_draws` applies given draws with the JAX formulas, so a
test can feed the same draws to both packages. The per-element modes
(``elem``, ``pair``) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class MixupConfig:
    """The JAX ``MixupConfig``'s fields and defaults (``mixup.py:49-67``)."""

    mixup_alpha: float = 0.2
    cutmix_alpha: float = 0.0
    cutmix_minmax: Any = None
    prob: float = 0.1
    switch_prob: float = 0.5
    label_smoothing: float = 0.0
    num_classes: int = 1000
    mode: str = "batch"

    @property
    def enabled(self) -> bool:
        """Mixing is on at a positive alpha or with a minmax box — the JAX
        gate (``mixup.py:64-67``; ADVICE r5's known deviation from timm,
        which the port mirrors)."""
        return (self.mixup_alpha > 0 or self.cutmix_alpha > 0
                or self.cutmix_minmax is not None)


class MixupDraws(NamedTuple):
    """The random part of one batch's mixing: ``apply`` (mix at all),
    ``use_cutmix``, the Beta draw ``lam`` (before the apply gate) and the
    CutMix ``box`` (y_lo, y_hi, x_lo, x_hi)."""

    apply: bool
    use_cutmix: bool
    lam: float
    box: Tuple[int, int, int, int]


def _check_minmax(minmax):
    mn, mx = minmax
    if not (0.0 < mn < mx <= 1.0):
        raise ValueError(f"cutmix_minmax must satisfy 0 < min < max <= 1, "
                         f"got {tuple(minmax)}")
    return float(mn), float(mx)


def one_hot_smooth(labels: torch.Tensor, num_classes: int,
                   smoothing: float = 0.0) -> torch.Tensor:
    """(B,) ints → (B, C) fp32 rows of ``1 − s + s/C`` at the label and
    ``s/C`` elsewhere (``mixup.py:152-155``)."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(labels.long(), num_classes).float() * (on - off) + off


def cutmix_box(h: int, w: int, lam: float, cfg: MixupConfig,
               rng: np.random.Generator) -> Tuple[int, int, int, int]:
    """timm's box for a CutMix at ``lam`` (``mixup.py:224-236``): a
    √(1 − λ)-scaled box around a uniform centre, clipped to the image; or,
    with ``cutmix_minmax``, side lengths uniform in [min·dim, max·dim) and a
    uniform corner (``rand_bbox_minmax``, λ not consulted)."""
    if cfg.cutmix_minmax is not None:
        mn, mx = _check_minmax(cfg.cutmix_minmax)
        cut_h = int(rng.integers(int(h * mn), max(int(h * mx), int(h * mn) + 1)))
        cut_w = int(rng.integers(int(w * mn), max(int(w * mx), int(w * mn) + 1)))
        yl = int(np.float32(rng.random()) * np.float32(h - cut_h))
        xl = int(np.float32(rng.random()) * np.float32(w - cut_w))
        return yl, yl + cut_h, xl, xl + cut_w
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h, cut_w = int(h * ratio), int(w * ratio)
    cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
    return (int(np.clip(cy - cut_h // 2, 0, h)), int(np.clip(cy + cut_h // 2, 0, h)),
            int(np.clip(cx - cut_w // 2, 0, w)), int(np.clip(cx + cut_w // 2, 0, w)))


def draw_mixup(cfg: MixupConfig, h: int, w: int,
               rng: np.random.Generator) -> MixupDraws:
    """One batch's draws, as the JAX batch mode takes them
    (``mixup.py:199-217``): apply with probability ``prob``; CutMix with
    probability ``switch_prob`` when both kinds are on; λ ~ Beta(α, α) of
    the chosen kind (α = 1 for a minmax CutMix without ``cutmix_alpha``);
    the box at the gated λ."""
    apply = bool(rng.random() < cfg.prob)
    cut_on = cfg.cutmix_alpha > 0 or cfg.cutmix_minmax is not None
    c_alpha = cfg.cutmix_alpha if cfg.cutmix_alpha > 0 else 1.0
    if cfg.mixup_alpha > 0 and cut_on:
        use_cutmix = bool(rng.random() < cfg.switch_prob)
    else:
        use_cutmix = cut_on
    alpha = c_alpha if use_cutmix else cfg.mixup_alpha
    lam = float(np.float32(rng.beta(alpha, alpha)))
    box = cutmix_box(h, w, lam if apply else 1.0, cfg, rng)
    return MixupDraws(apply, use_cutmix, lam, box)


def mix_with_draws(images: torch.Tensor, labels: torch.Tensor,
                   cfg: MixupConfig, draws: MixupDraws):
    """Mix a batch with given draws (the JAX formulas, ``mixup.py:217-248``).
    images (B, H, W, C) float, labels (B,) ints → (mixed images, (B, C)
    fp32 soft targets ``y·λ_eff + flip(y)·(1 − λ_eff)``), where λ_eff is
    the gated λ, or 1 − box area / image area for a CutMix."""
    y1 = one_hot_smooth(labels, cfg.num_classes, cfg.label_smoothing)
    h, w = images.shape[1], images.shape[2]
    flipped = torch.flip(images, dims=(0,))
    if draws.apply and draws.use_cutmix:
        yl, yh, xl, xh = draws.box
        mixed = images.clone()
        mixed[:, yl:yh, xl:xh] = flipped[:, yl:yh, xl:xh]
        lam = float(np.float32(1.0) - np.float32((yh - yl) * (xh - xl))
                    / np.float32(h * w))
    else:
        lam = draws.lam if draws.apply else 1.0
        mixed = images * lam + flipped * (1.0 - lam)
    lam = float(np.float32(lam))
    target = y1 * lam + torch.flip(y1, dims=(0,)) * (1.0 - lam)
    return mixed, target


def mixup_cutmix(images: torch.Tensor, labels: torch.Tensor,
                 cfg: MixupConfig, rng: np.random.Generator):
    """Batch-mode Mixup/CutMix with the draws from ``rng``; ``(images,
    one-hot targets)`` unmixed when the config is not ``enabled``."""
    if not cfg.enabled:
        return images, one_hot_smooth(labels, cfg.num_classes,
                                      cfg.label_smoothing)
    if cfg.mode in ("elem", "pair"):
        raise NotImplementedError(
            f"mixup mode {cfg.mode!r} is not ported yet (ROADMAP.md, Open "
            "items 1.11)")
    if cfg.mode != "batch":
        raise ValueError(f"unsupported mixup mode {cfg.mode!r}: expected "
                         "'batch', 'elem' or 'pair'")
    draws = draw_mixup(cfg, images.shape[1], images.shape[2], rng)
    return mix_with_draws(images, labels, cfg, draws)
