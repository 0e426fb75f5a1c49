"""Plain PyTorch reference of the LAFS supervised finetuning step (the
reference's ``train_largescale.py`` with ``finetune_largescale.sh``'s
recipe): uint8 faces scaled to [−1, 1], batch Mixup/CutMix against the
mirrored batch with soft targets, Part-fViT in training mode (the
MobileNetV3 landmark CNN with batch-statistics BatchNorm and Dropout(0.5)
on its pooled features, the patch gather at its landmarks, the ViT with
its dropouts), the CosFace head on the soft targets, the soft-target
cross-entropy, gradients summed over ``acc-step`` microbatches and
averaged, the BatchNorm running statistics carried from one microbatch to
the next, the non-finite guard, and AdamW with BEiT's layer-wise lr decay
and weight-decay groups. Float32 throughout; imports nothing of the
program.

The step's random draws follow the program's stated contract: the seeds
of step ``t`` come from ``numpy.random.SeedSequence([seed, t])``, two a
microbatch (the mixup draws from a numpy generator, the dropouts from a
``torch.Generator`` pair, :class:`.model.Rng`), and the draws come in the
order and shapes below: the landmark branch's Dropout(0.5) first, then
the ViT's (``model.vit``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .model import F32, FP32, LARGE, Rng, _act, _conv, _dropout16, gather, lin, vit


def micro_seeds(seed: int, step: int, acc: int):
    s = np.random.SeedSequence([int(seed), int(step)]).generate_state(2 * acc)
    return [(int(s[2 * i]), int(s[2 * i + 1])) for i in range(acc)]


# ------------------------------------------------------------------ mixup --

def mix(x: torch.Tensor, labels: torch.Tensor, m: dict, seed: int):
    """timm's batch Mixup/CutMix (``label_smoothing`` 0) from a numpy
    generator seeded ``seed``: apply with probability ``mixup-prob``; CutMix
    (when both kinds are on) with probability 0.5; λ ~ Beta(α, α) rounded
    to float32; the box a √(1 − λ)-scaled one around a uniform centre
    (drawn at λ = 1 when nothing is applied). Element i is mixed with
    element B − 1 − i; targets ``y·λ + flip(y)·(1 − λ)``."""
    rng = np.random.default_rng(seed)
    a_mix, a_cut = m["mixup"], m["cutmix"]
    apply = bool(rng.random() < m["mixup-prob"])
    use_cut = bool(rng.random() < 0.5) if (a_mix > 0 and a_cut > 0) else a_cut > 0
    alpha = a_cut if use_cut else a_mix
    lam = float(np.float32(rng.beta(alpha, alpha)))
    h, w = x.shape[1], x.shape[2]
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam if apply else 1.0))
    ch, cw = int(h * ratio), int(w * ratio)
    cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
    y1 = torch.nn.functional.one_hot(labels.long(), m["num-classes"]).to(F32)
    flipped = x.flip(0)
    if apply and use_cut:
        yl, yh = int(np.clip(cy - ch // 2, 0, h)), int(np.clip(cy + ch // 2, 0, h))
        xl, xh = int(np.clip(cx - cw // 2, 0, w)), int(np.clip(cx + cw // 2, 0, w))
        x = x.clone()
        x[:, yl:yh, xl:xh] = flipped[:, yl:yh, xl:xh]
        lam = float(np.float32(1.0) - np.float32((yh - yl) * (xh - xl))
                    / np.float32(h * w))
    else:
        lam = lam if apply else 1.0
        x = x * lam + flipped * (1.0 - lam)
    lam = float(np.float32(lam))
    return x, y1 * lam + y1.flip(0) * (1.0 - lam)


# --------------------------------------------- landmark CNN, training mode --

def _bn_train(x, w, stats, pre):
    """BatchNorm on the batch's statistics (mean, biased variance as
    E[x²] − E[x]² clipped at 0, eps 1e-5); the running statistics move to
    0.9 · running + 0.1 · batch in ``stats``."""
    mean = x.mean((0, 2, 3))
    var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        stats[pre + "running_mean"] = 0.9 * stats[pre + "running_mean"] + 0.1 * mean
        stats[pre + "running_var"] = 0.9 * stats[pre + "running_var"] + 0.1 * var
    inv = torch.rsqrt(var + 1e-5) * w[pre + "weight"]
    return ((x - mean[:, None, None]) * inv[:, None, None]
            + w[pre + "bias"][:, None, None])


def landmarks_train(w: dict, stats: dict, x: torch.Tensor, m: dict, rng: Rng,
                    p: str = "fp32") -> torch.Tensor:
    """NHWC image → (B, N, 2) landmarks in pixels, in training mode:
    MobileNetV3-large with batch-statistics BatchNorm (``stats`` moved in
    place), mean pool, Dropout(0.5), the landmark head, min-max rescale of
    the whole 2·N vector to [0, image-size − 1]."""
    s = "stn.features."
    h = x.permute(0, 3, 1, 2).to(F32)
    h = _act(_bn_train(_conv(h, w[s + "0.0.weight"], p, 2), w, stats,
                       s + "0.1."), "HS")
    cin = 16
    for i, (_, exp, c, se, nl, st) in enumerate(LARGE, 1):
        pre = f"{s}{i}.conv."
        y = _act(_bn_train(_conv(h, w[pre + "0.weight"], p), w, stats,
                           pre + "1."), nl)
        y = _bn_train(_conv(y, w[pre + "3.weight"], p, st, exp), w, stats,
                      pre + "4.")
        if se:
            z = torch.relu(lin(y.mean((2, 3)), w[pre + "5.fc.0.weight"], p=p))
            z = lin(z, w[pre + "5.fc.2.weight"], p=p)
            y = y * (torch.clamp(z + 3.0, 0.0, 6.0) / 6.0)[:, :, None, None]
        y = _bn_train(_conv(_act(y, nl), w[pre + "7.weight"], p), w, stats,
                      pre + "8.")
        h = h + y if (st == 1 and cin == c) else y
        cin = c
    pooled = _dropout16(h.mean((2, 3)), rng, 0.5)
    theta = lin(pooled, w["output_layer.weight"], w["output_layer.bias"], p)
    lo = theta.amin(1, keepdim=True)
    hi = theta.amax(1, keepdim=True)
    scale = m["image-size"] - 1.0
    return ((theta - lo) / (hi - lo + 1e-12) * scale).reshape(
        -1, m["num-patches"], 2)


# ------------------------------------------------------------------- step --

def cosface(e: torch.Tensor, weight: torch.Tensor, target: torch.Tensor,
            m: dict, p: str) -> torch.Tensor:
    """s · (cos θ − m · target) against the L2-normalised class centres."""
    e = e / e.norm(dim=1, keepdim=True).clamp_min(1e-12)
    wn = weight / weight.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return m["cosface-s"] * (lin(e, wn, p=p) - m["cosface-m"] * target)


def microbatch_loss(w: dict, stats: dict, x: torch.Tensor, target, m: dict,
                    seed: int, prec: dict) -> torch.Tensor:
    """The soft-target cross-entropy of one (mixed) microbatch through
    Part-fViT in training mode, the BatchNorm statistics moved in place."""
    rng = Rng(seed, x.device)
    theta = landmarks_train(w, stats, x, m, rng, prec["landmark"])
    e = vit(w, gather(x, theta, m["patch-size"]), m, prec["backbone"], rng)
    logits = cosface(e, w["loss.weight"], target, m, prec["head"])
    return (-target * torch.log_softmax(logits, -1)).sum(-1).mean()


def layer_id(name: str, depth: int) -> int:
    """BEiT's layer of a parameter: 0 for the embeddings and the landmark
    branch, i + 1 for transformer block i, depth + 1 for the rest."""
    if name.startswith(("cls_token", "pos_embedding", "patch_to_embedding",
                        "stn.", "output_layer.")):
        return 0
    if name.startswith("transformer.layers."):
        return int(name.split(".")[2]) + 1
    return depth + 1


def param_groups(params: dict, m: dict):
    """(lr scale, weight decay) per parameter: ``layer-decay`` to the power
    of the layers above it; no decay for biases and leaves of at most one
    dimension, ``stn-weight-decay`` for the landmark stem, ``weight-decay``
    for the rest."""
    n = m["depth"] + 1
    out = {}
    for k, v in params.items():
        lr = m["layer-decay"] ** (n - layer_id(k, m["depth"]))
        if v.ndim <= 1 or k.endswith("bias"):
            wd = 0.0
        elif k.startswith("stn."):
            wd = m["stn-weight-decay"]
        else:
            wd = m["weight-decay"]
        out[k] = (lr, wd)
    return out


def run_steps(params: dict, stats: dict, batches, m: dict, seed: int,
              prec: dict = FP32, half_batch: bool = False):
    """Run the reference over ``batches`` (uint8 (acc·B, H, W, 3) images and
    (acc·B,) int labels on the card), steps 0, 1, …, from ``params`` and
    ``stats`` (the float BatchNorm statistics) with zero moments at the
    configuration's constant lr. Returns ``(losses, first_grads, params)``:
    each step's loss, the first step's mean gradients and the parameters
    after the last step. ``half_batch``: the fault of a step given only the
    first half of its images."""
    params = {k: v.clone().to(F32) for k, v in params.items()}
    stats = {k: v.clone().to(F32) for k, v in stats.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    groups = param_groups(params, m)
    acc, lr = m["acc-step"], m["lr"]
    losses, first = [], None
    for t, (images, labels) in enumerate(batches):
        if half_batch:
            images, labels = images[: len(images) // 2], labels[: len(labels) // 2]
        b = images.shape[0] // acc
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        new_stats = dict(stats)
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        loss_sum = 0.0
        for i, (s_mix, s_drop) in enumerate(micro_seeds(seed, t, acc)):
            x = images[i * b:(i + 1) * b].to(F32) / 255.0 * 2.0 - 1.0
            x, target = mix(x, labels[i * b:(i + 1) * b], m, s_mix)
            loss = microbatch_loss(leaves, new_stats, x, target, m, s_drop,
                                   prec)
            for k, g in zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()), allow_unused=True)):
                if g is not None:
                    grads[k] += g
            loss_sum += loss.item()
            del loss
        loss = loss_sum / acc
        losses.append(loss)
        with torch.no_grad():
            if math.isfinite(loss):
                grads = {k: g / acc for k, g in grads.items()}
                stats = new_stats
            else:  # the guard: no gradient, parameters and statistics kept
                grads = {k: torch.zeros_like(g) for k, g in grads.items()}
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            c1, c2 = 1 - 0.9 ** (t + 1), 1 - 0.999 ** (t + 1)
            for k, g in grads.items():
                mu[k] = 0.9 * mu[k] + 0.1 * g
                nu[k] = 0.999 * nu[k] + 0.001 * g * g
                if math.isfinite(loss):
                    ls, wd = groups[k]
                    upd = (mu[k] / c1) / ((nu[k] / c2).sqrt() + 1e-8) + wd * params[k]
                    params[k] = params[k] - lr * ls * upd
    return losses, first, params
