"""Plain PyTorch reference of the LAFS SSL step as the pretraining CLI runs
it (``lafs_train.py``; DINO, Caron et al. 2021): the 2 + L crop LAFS
multi-crop of a uint8 batch, landmarks from the frozen CNN on each clean
crop, patches from the augmented crop, the EMA teacher on the globals, the
student on all crops, the DINO loss, and the update: the last-layer gates,
DINO's per-parameter clip, AdamW and the EMA teacher. Float32 throughout;
imports nothing of the program.

The step's random draws follow the program's stated contract: the seeds
of step ``t`` come from ``numpy.random.SeedSequence([seed, t])`` (landmark
jitter, global and local dropout) and ``SeedSequence([seed, t, 11])`` (the
multi-crop), each drives a ``torch.Generator``, and the draws come in the
order and shapes below.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .model import F32, FP32, Rng, gather, landmarks, lin, vit

LUMA = (0.299, 0.587, 0.114)


def step_seeds(seed: int, step: int):
    land, glob, loc = (int(s) for s in np.random.SeedSequence(
        [int(seed), int(step)]).generate_state(3))
    aug = int(np.random.SeedSequence([int(seed), int(step), 11])
              .generate_state(1)[0])
    return land, glob, loc, aug


# ------------------------------------------------------------ multi-crop --

def _u(gen, shape, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=F32) * (hi - lo) + lo


def _cubic(t):
    a = -0.5
    t1, t2, t3 = t + 1.0, 1.0 - t, 2.0 - t
    return torch.stack([a * t1 ** 3 - 5 * a * t1 ** 2 + 8 * a * t1 - 4 * a,
                        (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
                        (a + 2) * t2 ** 3 - (a + 3) * t2 ** 2 + 1,
                        a * t3 ** 3 - 5 * a * t3 ** 2 + 8 * a * t3 - 4 * a],
                       -1)


def _resize(start, size, n_in, n_out):
    """(B, n_out, n_in) bicubic (Keys, a = −0.5) resampling of the box
    [start, start + size), edge taps clamped."""
    o = torch.arange(n_out, dtype=F32, device=start.device)
    src = start[:, None] + (o + 0.5) * (size[:, None] / n_out) - 0.5
    i0 = torch.floor(src)
    wt = _cubic(src - i0)
    idx = torch.stack([torch.clamp(i0 + k - 1, 0, n_in - 1).long()
                       for k in range(4)], -1)
    m = torch.zeros(start.shape[0], n_out, n_in, dtype=F32,
                    device=start.device)
    return m.scatter_add_(2, idx, wt)


def _gray(x):
    return (x * torch.tensor(LUMA, device=x.device)).sum(-1, keepdim=True
                                                         ).expand_as(x)


def _hue_shift(x, fh):
    r, g, b = x.unbind(-1)
    mx, mn = x.amax(-1), x.amin(-1)
    d = mx - mn
    sd = torch.where(d > 0, d, torch.ones_like(d))
    h = torch.where(mx == r, torch.remainder((g - b) / sd, 6.0),
                    torch.where(mx == g, (b - r) / sd + 2.0,
                                (r - g) / sd + 4.0)) / 6.0
    h = torch.where(d > 0, h, torch.zeros_like(h))
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    h6 = torch.remainder(h + fh, 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    pp, qq, tt = mx * (1 - s), mx * (1 - s * f), mx * (1 - s * (1 - f))
    i = torch.remainder(i.long(), 6)[..., None]

    def pick(*v):
        return torch.stack(v, -1).gather(-1, i)[..., 0]

    return torch.stack([pick(mx, qq, pp, pp, tt, mx), pick(tt, mx, mx, qq, pp, pp),
                        pick(pp, pp, tt, mx, mx, qq)], -1)


def _band(wts, n):
    r = wts.shape[1] // 2
    i = torch.arange(n, device=wts.device)
    d = i[None, :, None] - i[None, None, :]
    m = torch.zeros(wts.shape[0], n, n, dtype=F32, device=wts.device)
    for k in range(wts.shape[1]):
        m = m + (d == (k - r)).to(F32) * wts[:, k, None, None]
    return m / torch.clamp(m.sum(2, keepdim=True), min=1e-8)


def multicrop(images: torch.Tensor, gen: torch.Generator, n_local: int,
              out: int, scale) -> tuple:
    """LAFS multi-crop of a uint8 (B, H, W, 3) batch: 2 + ``n_local``
    (clean, augmented) pairs sharing one bicubic random resized crop and
    flip; the augmented view gets colour jitter (p 0.8), grayscale (p 0.2),
    a 9-tap Gaussian blur (p 1, 0.1, 0.5 for global 1, global 2, locals)
    and, for global 2, solarize (p 0.2). Returns (2, B, S, S, 3) clean and
    augmented globals and (L, B, S, S, 3) locals, in [−1, 1]."""
    b, hh, ww, _ = images.shape
    x = images.to(F32) / 255.0
    cl, au = [], []
    for i in range(2 + n_local):
        blur_p, sol_p = (1.0, 0.0) if i == 0 else (
            (0.1, 0.2) if i == 1 else (0.5, 0.0))
        area = hh * ww * _u(gen, (b,), scale[0], scale[1])
        log_r = _u(gen, (b,), math.log(3 / 4), math.log(4 / 3))
        ux, uy = _u(gen, (b,)), _u(gen, (b,))
        flip = _u(gen, (b, 1, 1, 1)) < 0.5
        jit = _u(gen, (b, 1, 1, 1)) < 0.8
        s4 = (b, 1, 1, 1)
        fb, fc = _u(gen, s4, 0.6, 1.4), _u(gen, s4, 0.6, 1.4)
        fs, fh = _u(gen, s4, 0.8, 1.2), _u(gen, (b, 1, 1), -0.1, 0.1)
        gray = _u(gen, s4) < 0.2
        sigma = _u(gen, (b,), 0.1, 2.0)
        blur = _u(gen, s4) < blur_p
        sol = _u(gen, s4) < sol_p if sol_p > 0 else None
        ar = torch.exp(log_r)
        cw = torch.clamp(torch.round(torch.sqrt(area * ar)), 1, ww)
        ch = torch.clamp(torch.round(torch.sqrt(area / ar)), 1, hh)
        geo = torch.einsum("boh,bhwc->bowc", _resize(uy * (hh - ch), ch, hh, out), x)
        geo = torch.einsum("bpw,bowc->bopc", _resize(ux * (ww - cw), cw, ww, out), geo)
        geo = torch.clamp(geo, 0.0, 1.0)
        geo = torch.where(flip, geo.flip(2), geo)
        y = torch.clamp(geo * fb, 0, 1)
        mean = _gray(y)[..., :1].mean((1, 2, 3), keepdim=True)
        y = torch.clamp((y - mean) * fc + mean, 0, 1)
        y = torch.clamp(_gray(y) + (y - _gray(y)) * fs, 0, 1)
        y = torch.clamp(_hue_shift(y, fh), 0, 1)
        y = torch.where(jit, y, geo)
        y = torch.where(gray, _gray(y), y)
        offs = torch.arange(-4, 5, dtype=F32, device=x.device)
        k = torch.exp(-0.5 * (offs[None] / sigma[:, None]) ** 2)
        k = k / k.sum(1, keepdim=True)
        z = torch.einsum("bij,bjwc->biwc", _band(k, out), y)
        z = torch.einsum("bkw,biwc->bikc", _band(k, out), z)
        y = torch.where(blur, z, y)
        if sol is not None:
            y = torch.where(sol & (y >= 128 / 255), 1.0 - y, y)
        cl.append(geo * 2 - 1)
        au.append(y * 2 - 1)
    return (torch.stack(cl[:2]), torch.stack(au[:2]), torch.stack(cl[2:]),
            torch.stack(au[2:]))


# ------------------------------------------------------------------ step --

def head(w: dict, e: torch.Tensor, p: str) -> torch.Tensor:
    """DINO head: Linear-GELU-Linear-GELU-Linear, L2 normalise, the
    weight-normed last layer g·v/‖v‖."""
    g = torch.nn.functional.gelu
    e = g(lin(e, w["head.mlp.0.weight"], w["head.mlp.0.bias"], p))
    e = g(lin(e, w["head.mlp.2.weight"], w["head.mlp.2.bias"], p))
    e = lin(e, w["head.mlp.4.weight"], w["head.mlp.4.bias"], p)
    e = e / e.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    v = w["head.last_layer.weight_v"]
    wn = w["head.last_layer.weight_g"] * v / v.norm(dim=1, keepdim=True
                                                    ).clamp_min(1e-12)
    return lin(e, wn, p=p)


def _backbone(w):
    return {k[len("backbone."):]: v for k, v in w.items()
            if k.startswith("backbone.")}


def tokens(land: dict, clean, aug, m: dict, gen, keep: int, p: str):
    """Landmarks of the clean crops with N(0, jitter²) noise, ``keep`` of
    them drawn with replacement when > 0, patches from the augmented."""
    n, b = clean.shape[:2]
    c = clean.reshape(n * b, *clean.shape[2:])
    a = aug.reshape(n * b, *aug.shape[2:])
    th = landmarks(land, c, m["num-patches"], m["image-size"] - 1.0, p)
    th = th + m["landmark-jitter-std"] * torch.randn(
        th.shape, generator=gen, device=th.device, dtype=th.dtype)
    if keep:
        idx = torch.randint(0, th.shape[1], (n * b, keep), generator=gen,
                            device=th.device)
        th = torch.gather(th, 1, idx[..., None].expand(-1, -1, 2))
    return gather(a, th, m["patch-size"])


def dino_loss(s_out, t_out, center, t_temp, n_crops, s_temp, c_mom):
    k = s_out.shape[-1]
    logp = torch.log_softmax(s_out / s_temp, -1).reshape(n_crops, -1, k)
    t = torch.softmax((t_out - center) / t_temp, -1).reshape(2, -1, k)
    terms = [(-t[i] * logp[v]).sum(-1).mean()
             for i in range(2) for v in range(n_crops) if v != i]
    new_center = center * c_mom + t_out.mean(0, keepdim=True) * (1 - c_mom)
    return sum(terms) / len(terms), new_center


def schedules(m: dict, steps_per_epoch: int, batch: int):
    """The CLI's per-step lr, weight decay and teacher momentum and the
    per-epoch teacher temperature (DINO's linear-warmup cosine)."""
    ep, wu = m["epochs"], m["warmup-epochs"]

    def cosine(base, final, warm=0):
        w = np.linspace(0.0, base, warm * steps_per_epoch) if warm else []
        it = np.arange(ep * steps_per_epoch - warm * steps_per_epoch)
        rest = final + 0.5 * (base - final) * (1 + np.cos(np.pi * it / max(len(it), 1)))
        return np.concatenate((w, rest))

    lr = cosine(m["lr"] * batch / 256.0, m["min-lr"], wu)
    wd = cosine(m["weight-decay"], m["weight-decay-end"])
    mom = cosine(m["momentum-teacher"], 1.0)
    temp = np.concatenate((np.linspace(m["warmup-teacher-temp"], m["teacher-temp"],
                                       m["warmup-teacher-temp-epochs"]),
                           np.ones(max(ep - m["warmup-teacher-temp-epochs"], 0))
                           * m["teacher-temp"]))
    return lr, wd, mom, temp


def run_steps(student: dict, land: dict, batches, m: dict, seed: int,
              steps_per_epoch: int, prec: dict = FP32, half_batch=False):
    """Run the reference over ``batches`` (uint8 (B, H, W, 3) on the card),
    steps 0, 1, …, from ``student`` (teacher = student, zero moments and
    center). Returns ``(losses, first_grads, params)``: each step's loss,
    the first step's gradients as the optimizer takes them (gated and
    clipped) and the student after the last step. ``half_batch``: the
    fault of a step that drops half of its rows and averages the rest."""
    dev = next(iter(student.values())).device
    b = batches[0].shape[0]
    lr, wd, mom, temp = schedules(m, steps_per_epoch, b)
    params = {k: v.clone().to(F32) for k, v in student.items()}
    teacher = {k: v.clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    center = torch.zeros(1, m["out-dim"], device=dev)
    n_loc, ncrops = m["local-crops-number"], m["local-crops-number"] + 2
    losses, first = [], None
    for t, images in enumerate(batches):
        s_land, s_glob, s_loc, s_aug = step_seeds(seed, t)
        gen = torch.Generator(device=dev).manual_seed(s_aug)
        gc, ga, lc, la = multicrop(images, gen, n_loc, m["image-size"],
                                   m["global-crops-scale"])
        with torch.no_grad():
            lg = torch.Generator(device=dev).manual_seed(s_land)
            g_tok = tokens(land, gc, ga, m, lg, 0, prec["landmark"])
            l_tok = tokens(land, lc, la, m, lg, m["local-keep-landmarks"],
                           prec["landmark"])
            t_out = head(teacher, vit(_backbone(teacher), g_tok, m,
                                      prec["backbone"]), prec["head"])
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        bb = _backbone(leaves)
        emb = torch.cat([vit(bb, g_tok, m, prec["backbone"], Rng(s_glob, dev)),
                         vit(bb, l_tok, m, prec["backbone"], Rng(s_loc, dev))])
        s_out = head(leaves, emb, prec["head"])
        if half_batch:  # rows are crop-major: keep the first half of each crop
            keep = torch.arange(s_out.shape[0], device=dev) % b < b // 2
            s_out, t_sel = s_out[keep], t_out[torch.arange(2 * b, device=dev) % b < b // 2]
        else:
            t_sel = t_out
        loss, center = dino_loss(s_out, t_sel, center, float(temp[0]), ncrops,
                                 m["student-temp"], m["center-momentum"])
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        loss = loss.detach()
        losses.append(loss.item())
        with torch.no_grad():
            for k in grads:  # last-layer gates: the freeze (epoch 0), the gain
                if "last_layer" in k:
                    grads[k] = torch.zeros_like(grads[k])
            for k, g in grads.items():  # DINO's per-parameter clip
                g.mul_(torch.clamp(m["clip-grad"] / (g.norm() + 1e-6), max=1.0))
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            c1, c2 = 1 - 0.9 ** (t + 1), 1 - 0.999 ** (t + 1)
            for k, g in grads.items():
                mu[k].mul_(0.9).add_(g, alpha=0.1)
                nu[k].mul_(0.999).addcmul_(g, g, value=0.001)
                decay = 0.0 if (params[k].ndim <= 1 or k.endswith("bias")) else wd[t]
                upd = (mu[k] / c1) / ((nu[k] / c2).sqrt() + 1e-8) + decay * params[k]
                params[k] = params[k] - lr[t] * upd
                teacher[k] = mom[t] * teacher[k] + (1 - mom[t]) * params[k]
    return losses, first, params
