"""Plain PyTorch reference of Part-fViT (Sun et al., "LAFS: Landmark-based
Facial Self-supervised Learning for Face Recognition", CVPR 2024, and its
reference code ``ViT_face.py``, ``mobilenet.py``, ``lafs_train.py``),
written from those and imports nothing of the program.

Everything runs in float32 on flat dicts of tensors named as the reference
``state_dict``. The products (convolutions, linear layers, attention) take
their operands through :func:`q`, which rounds them to a lower precision
for the control: ``prec`` maps each part (``landmark``, ``backbone``,
``head``) to ``fp32``, ``bf16`` or ``fp8`` (e4m3 with one scale a tensor).

The training forward draws its dropout, drop-path and fused-MLP dropout
bits from the same generators, in the same order and shapes, as the
program's contract for its randomness states (a pure function of the step's
seeds), so that the reference and the program see the same masks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..weights import LARGE

F32 = torch.float32
FP32 = {"landmark": "fp32", "backbone": "fp32", "head": "fp32"}


def q(x: torch.Tensor, p: str) -> torch.Tensor:
    """``x`` rounded to the precision ``p`` and back to float32; the
    gradient passes through the rounding unchanged."""
    if p == "fp32":
        return x
    if p == "bf16":
        r = x.detach().to(torch.bfloat16).to(F32)
    elif p == "fp8":
        s = x.detach().abs().amax().clamp_min(1e-30) / 448.0
        r = (x.detach() / s).to(torch.float8_e4m3fn).to(F32) * s
    else:
        raise ValueError(f"unknown precision {p!r}")
    return x + (r - x.detach())


def lin(x, w, b=None, p="fp32"):
    y = torch.matmul(q(x, p), q(w, p).t())
    return y if b is None else y + b


def layer_norm(x, w, b, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


# ----------------------------------------------------------- landmark CNN --

def _hswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _act(x, kind):
    return _hswish(x) if kind == "HS" else torch.relu(x)


def _bn(x, w, pre):
    inv = torch.rsqrt(w[pre + "running_var"] + 1e-5) * w[pre + "weight"]
    return ((x - w[pre + "running_mean"][:, None, None]) * inv[:, None, None]
            + w[pre + "bias"][:, None, None])


def _conv(x, wt, p, stride=1, groups=1):
    k = wt.shape[-1]
    return F.conv2d(q(x, p), q(wt, p), None, stride, (k - 1) // 2, 1, groups)


def landmarks(w: dict, x: torch.Tensor, num: int, scale: float,
              p: str = "fp32") -> torch.Tensor:
    """NHWC image in the model's input scale → (B, num, 2) landmarks in
    pixels: MobileNetV3-large in eval mode, mean pool, the landmark head,
    min-max rescale of the whole 2·num vector to [0, scale]."""
    s = "stn.features."
    h = x.permute(0, 3, 1, 2).to(F32)
    h = _act(_bn(_conv(h, w[s + "0.0.weight"], p, 2), w, s + "0.1."), "HS")
    cin = 16
    for i, (_, exp, c, se, nl, st) in enumerate(LARGE, 1):
        pre = f"{s}{i}.conv."
        y = _act(_bn(_conv(h, w[pre + "0.weight"], p), w, pre + "1."), nl)
        y = _bn(_conv(y, w[pre + "3.weight"], p, st, exp), w, pre + "4.")
        if se:
            z = torch.relu(lin(y.mean((2, 3)), w[pre + "5.fc.0.weight"], p=p))
            z = lin(z, w[pre + "5.fc.2.weight"], p=p)
            y = y * (torch.clamp(z + 3.0, 0.0, 6.0) / 6.0)[:, :, None, None]
        y = _bn(_conv(_act(y, nl), w[pre + "7.weight"], p), w, pre + "8.")
        h = h + y if (st == 1 and cin == c) else y
        cin = c
    theta = lin(h.mean((2, 3)), w["output_layer.weight"],
                w["output_layer.bias"], p)
    lo = theta.amin(1, keepdim=True)
    hi = theta.amax(1, keepdim=True)
    return ((theta - lo) / (hi - lo + 1e-12) * scale).reshape(-1, num, 2)


def gather(images: torch.Tensor, theta: torch.Tensor, ps: int) -> torch.Tensor:
    """(B, H, W, C) images, (B, N, 2) landmarks (x first) → (B, N, P·P·C)
    tokens: a P×P bilinear patch centred on each landmark, sample i, j at
    (x + i − P/2 − 0.5, y + j − P/2 − 0.5) pixels, zeros outside the frame,
    flattened in (i, j, c) order (the reference's layout)."""
    b, hh, ww, c = images.shape
    n = theta.shape[1]
    lx = theta[..., 0].clamp(-(ps + 1.0), ww + ps + 1.0)
    ly = theta[..., 1].clamp(-(ps + 1.0), hh + ps + 1.0)
    off = torch.arange(ps, dtype=F32, device=images.device) - ps / 2 - 0.5
    gx = (2 * (lx[..., None] + off) + 1) / ww - 1              # (B, N, P_i)
    gy = (2 * (ly[..., None] + off) + 1) / hh - 1              # (B, N, P_j)
    grid = torch.stack(torch.broadcast_tensors(
        gx[..., :, None], gy[..., None, :]), -1)               # (B,N,Pi,Pj,2)
    out = F.grid_sample(images.permute(0, 3, 1, 2).to(F32),
                        grid.reshape(b, n * ps, ps, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.reshape(b, c, n, ps, ps).permute(0, 2, 3, 4, 1).reshape(
        b, n, ps * ps * c)


# --------------------------------------------------------------- the ViT --

class Rng:
    """The randomness of one training forward from its seed: a CPU
    generator for the fused MLP's integer seeds and one on the device for
    the dropout and drop-path masks."""

    def __init__(self, seed: int, device):
        self.cpu = torch.Generator().manual_seed(int(seed))
        self.dev = torch.Generator(device=device).manual_seed(int(seed))


def _dropout16(x, rng, rate):
    """Keep where 16 random bits fall below round(keep · 2¹⁶)."""
    keep = 1.0 - rate
    bits = torch.randint(0, 65536, x.shape, dtype=torch.int32,
                         generator=rng.dev, device=x.device)
    thresh = min(int(round(keep * 65536.0)), 65535)
    return torch.where(bits < thresh, x / keep, torch.zeros_like(x))


def _drop_path(x, rng, rate):
    keep = 1.0 - rate
    m = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), generator=rng.dev,
                   device=x.device) < keep
    return torch.where(m, x / keep, torch.zeros_like(x))


_M = 0xFFFFFFFF


def hash_keep(rows: int, cols: int, seed: int, draw: int, tile: int,
              rate: float, device) -> torch.Tensor:
    """Keep-mask of the fused MLP's counter-hash dropout: 32 bits per
    (row, column) from (seed, row tile, draw, row in tile, column) by a
    multiply-xorshift hash, kept where below round(keep · 2³²)."""
    r = torch.arange(rows, device=device, dtype=torch.int64)
    c = torch.arange(cols, device=device, dtype=torch.int64)
    key = (seed + (r // tile) * 0xB5297A4D + draw * 0x85EBCA6B) & _M
    v = ((((r % tile) * 2654435761) & _M)[:, None]
         ^ ((c * 0x9E3779B9) & _M)[None, :] ^ key[:, None])
    v = ((v ^ (v >> 16)) * 0x7FEB352D) & _M
    v = ((v ^ (v >> 15)) * 0x846CA68B) & _M
    v = v ^ (v >> 16)
    return v < min(int(round((1.0 - rate) * 2.0 ** 32)), 2 ** 32 - 1)


def vit(w: dict, tokens: torch.Tensor, m: dict, p: str = "fp32",
        rng: Rng | None = None) -> torch.Tensor:
    """(B, N, P·P·3) tokens → (B, dim) embeddings (the LayerNormed CLS
    token). With ``rng``, training mode: embedding dropout, dropout after
    the attention projection and in the MLP (the fused MLP's hash masks),
    drop path on each residual branch, all at the configuration's rates."""
    b, n, _ = tokens.shape
    heads, dh, dim = m["heads"], m["dim-head"], m["dim"]
    if rng is not None:
        rate, dpr = m["dropout"], m["drop-path-rate"]
        tile = 128 if m["compute-dtype"] == "bfloat16" else 64
    h = lin(tokens.to(F32), w["patch_to_embedding.weight"],
            w["patch_to_embedding.bias"], p)
    h = torch.cat([w["cls_token"].expand(b, -1, -1), h], 1)
    h = h + w["pos_embedding"][:, :n + 1]
    if rng is not None:
        h = _dropout16(h, rng, m["emb-dropout"])
    for i in range(m["depth"]):
        a = f"transformer.layers.{i}.0.fn."
        f = f"transformer.layers.{i}.1.fn."
        x = layer_norm(h, w[a + "norm.weight"], w[a + "norm.bias"])
        qkv = lin(x, w[a + "fn.to_qkv.weight"], p=p)
        qh, kh, vh = (t.reshape(b, n + 1, heads, dh).transpose(1, 2)
                      for t in qkv.chunk(3, -1))
        s = torch.matmul(q(qh, p), q(kh, p).transpose(-1, -2)) * dim ** -0.5
        o = torch.matmul(q(s.softmax(-1), p), q(vh, p))
        o = lin(o.transpose(1, 2).reshape(b, n + 1, heads * dh),
                w[a + "fn.to_out.0.weight"], w[a + "fn.to_out.0.bias"], p)
        if rng is not None:
            o = _drop_path(_dropout16(o, rng, rate), rng, dpr)
        h = h + o
        x = layer_norm(h, w[f + "norm.weight"], w[f + "norm.bias"])
        u = F.gelu(lin(x, w[f + "fn.net.0.weight"], w[f + "fn.net.0.bias"], p))
        if rng is not None:
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=rng.cpu))
            rows = b * (n + 1)
            u = torch.where(hash_keep(rows, u.shape[-1], seed, 0, tile, rate,
                                      u.device).view(b, n + 1, -1),
                            u / (1.0 - rate), torch.zeros_like(u))
        y = lin(u, w[f + "fn.net.3.weight"], w[f + "fn.net.3.bias"], p)
        if rng is not None:
            y = torch.where(hash_keep(rows, dim, seed, 1, tile, rate,
                                      y.device).view(b, n + 1, -1),
                            y / (1.0 - rate), torch.zeros_like(y))
            y = _drop_path(y, rng, dpr)
        h = h + y
    return layer_norm(h[:, 0], w["mlp_head.0.weight"],
                      w["mlp_head.0.bias"])


def embed_faces(w: dict, faces_uint8: torch.Tensor, m: dict,
                prec: dict = FP32, flip: bool = True) -> torch.Tensor:
    """What the embedding server answers, computed plainly: uint8 NHWC
    faces → x/255 − 0.5 → landmarks on the face → patches → ViT, plus the
    same of the mirrored face, summed and L2-normalised; (B, dim) float32."""
    x = faces_uint8.to(F32) / 255.0 - 0.5
    views = [x, x.flip(2)] if flip else [x]
    e = 0.0
    for v in views:
        theta = landmarks(w, v, m["num-patches"], m["image-size"] - 1.0,
                          prec["landmark"])
        e = e + vit(w, gather(v, theta, m["patch-size"]), m, prec["backbone"])
    return e / e.norm(dim=1, keepdim=True).clamp_min(1e-12)
