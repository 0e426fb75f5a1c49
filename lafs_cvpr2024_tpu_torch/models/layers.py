"""Transformer core layers (counterpart of ``lafs_cvpr2024_tpu/models/
layers.py``), eval and training mode.

Module names follow the reference ``state_dict`` (``ViT_face.py:100-213``):
``transformer.layers.{i}.0.fn.{norm,fn.to_qkv,fn.to_out.0}`` and
``transformer.layers.{i}.1.fn.{norm,fn.net.0,fn.net.3}``, so reference and
exported checkpoints load with ``strict=True``. The reference quirks stay:
attention scale ``dim ** -0.5`` with the MODEL dim, an inner width
``heads * dim_head`` that may differ from ``dim`` (704 for Part-fViT-B),
a bias-free ``to_qkv`` split q|k|v on the last axis, LayerNorm eps 1e-5 and
exact GELU.

Training mode draws its randomness from a :class:`DropoutRNG` passed down
the forward: ``FastDropout`` and ``drop_path`` masks from its generator on
the activations' device, the fused MLP's int seeds from its CPU generator
(read without waiting for the device).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.flash_attention import flash_attention
from ..ops.fused_attention import HEAD_DIM, MAX_SEQ, fused_attention
from ..ops.fused_ln_linear import fused_ln_linear
from ..ops.fused_mlp import fused_ln_mlp, fused_mlp
from ..utils import tracing

ATTN_IMPLS = ("einsum", "fused", "flash", "lnqkv")
MLP_IMPLS = ("dense", "fused", "fused_ln")


class DropoutRNG:
    """The randomness of one training forward, a pure function of ``seed``:
    ``device`` draws the dropout and drop-path masks where the activations
    live; ``kernel_seed()`` draws the fused MLP's int seeds on the CPU."""

    def __init__(self, seed: int, device):
        self.cpu = torch.Generator().manual_seed(int(seed))
        self.device = torch.Generator(device=device).manual_seed(int(seed))

    def kernel_seed(self) -> int:
        """An int seed in [0, 2**31 - 1), as the JAX layer draws one
        (``fused_mlp.py:623-627``)."""
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.cpu))


def _need_rng(rng, what: str):
    if rng is None:
        raise ValueError(f"{what}: active in training mode, but the forward "
                         "got no DropoutRNG")
    return rng


def drop_path(x: torch.Tensor, rate: float, rng: DropoutRNG) -> torch.Tensor:
    """Stochastic depth per sample (``layers.py:25-32``): each row of the
    batch is kept with probability 1 - rate and scaled by 1 / keep."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, generator=_need_rng(rng, "drop_path").device,
                      device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class FastDropout(nn.Module):
    """Dropout on 16 random bits per element (``layers.py:35-55``): the keep
    probability is quantised to 1/65536, and kept elements are scaled by
    1 / keep. The identity in eval mode and at rate 0."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)

    def forward(self, x, rng: DropoutRNG | None = None):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        thresh = min(int(round(keep * 65536.0)), 65535)
        bits = torch.randint(0, 65536, x.shape, dtype=torch.int32,
                             generator=_need_rng(rng, "FastDropout").device,
                             device=x.device)
        return torch.where(bits < thresh, x / keep, torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"p={self.p}"


class FeedForward(nn.Module):
    """Reference MLP: Linear, GELU (exact), Dropout, Linear, Dropout.
    ``mlp_impl`` 'fused' or 'fused_ln' with ``dim`` and ``hidden_dim``
    multiples of 128 runs the block as ``ops.fused_mlp`` (kernels 4 and 5
    on the card) when the caller applied the LayerNorm, as the JAX layer
    chooses (``layers.py:161-175``); a LayerNorm passed as ``ln`` runs
    inside ``fused_ln_mlp`` (kernels 2 and 3)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0,
                 mlp_impl: str = "dense"):
        super().__init__()
        self.net = nn.Sequential(
            nn.Linear(dim, hidden_dim), nn.GELU(), FastDropout(dropout),
            nn.Linear(hidden_dim, dim), FastDropout(dropout),
        )
        self.fused = (mlp_impl in ("fused", "fused_ln") and dim % 128 == 0
                      and hidden_dim % 128 == 0)

    def forward(self, x, rng: DropoutRNG | None = None,
                ln: nn.LayerNorm | None = None):
        """``ln`` given: the pre-MLP LayerNorm runs inside the fused kernel
        (``mlp_impl='fused_ln'``); ``x`` is then un-normalised."""
        fc1, act, drop1, fc2, drop2 = self.net
        if ln is None and not self.fused:
            return drop2(fc2(drop1(act(fc1(x)), rng)), rng)
        rate = drop1.p if self.training else 0.0
        seed = _need_rng(rng, "fused MLP dropout").kernel_seed() if rate else 0
        dt = x.dtype  # the JAX layer casts every operand to x's dtype
        w = (fc1.weight.to(dt), fc1.bias.to(dt), fc2.weight.to(dt),
             fc2.bias.to(dt))
        if ln is None:
            return fused_mlp(x, *w, rate=rate, seed=seed)
        return fused_ln_mlp(x, ln.weight.to(dt), ln.bias.to(dt), *w,
                            eps=ln.eps, rate=rate, seed=seed)


class Attention(nn.Module):
    """Multi-head self-attention. ``attn_impl='einsum'``: the score and
    value products stay ``torch.matmul``, as the JAX default leaves them to
    XLA. ``'fused'``: sequences of 128 to 512 tokens in heads of
    ``ops.fused_attention.HEAD_DIM`` (64) go through ``ops.fused_attention``
    (kernels 6 and 7 on the card; fp32 softmax), as the JAX layer chooses
    by length (``layers.py:218``); other lengths and head widths take the
    einsum path and count ``attn.fused_fallback`` (``utils/tracing.py``).
    The supervised step and every eval model (``eval/loading.py``) run
    it. ``'flash'``: every length through
    ``ops.flash_attention`` (kernels 11a-c on the card), as the JAX layer
    sends every length to its flash path (``layers.py:226-227``).
    ``'lnqkv'``: the caller passes the
    pre-attention LayerNorm as ``ln`` and ``x`` un-normalised, and
    ``to_qkv`` runs as ``ops.fused_ln_linear`` (kernels 8 and 9); the
    scores stay on the einsum path (``layers.py:197-208``)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, attn_impl: str = "einsum"):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.scale = dim ** -0.5  # reference quirk: model-dim scaling
        self.attn_impl = attn_impl
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), FastDropout(dropout))

    def forward(self, x, rng: DropoutRNG | None = None,
                ln: nn.LayerNorm | None = None):
        b, n, _ = x.shape
        if ln is None:
            qkv = self.to_qkv(x)
        else:
            dt = x.dtype  # the JAX layer casts every operand to x's dtype
            qkv = fused_ln_linear(x, ln.weight.to(dt), ln.bias.to(dt),
                                  self.to_qkv.weight.to(dt), eps=ln.eps)
        q, k, v = (
            t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
            for t in qkv.chunk(3, dim=-1)
        )
        fused = self.attn_impl == "fused"
        if fused and 128 <= n <= MAX_SEQ and self.dim_head == HEAD_DIM:
            out = fused_attention(q, k, v, self.scale)
        elif self.attn_impl == "flash":
            out = flash_attention(q, k, v, self.scale)
        else:
            if fused:
                tracing.count("attn.fused_fallback")
            attn = (torch.matmul(q, k.transpose(-1, -2)) * self.scale
                    ).softmax(-1)
            out = torch.matmul(attn, v)
        out = out.transpose(1, 2).reshape(b, n, -1)
        return self.to_out[1](self.to_out[0](out), rng)


class PreNorm(nn.Module):
    """LayerNorm, then ``fn``. ``fuse_ln``: the norm's parameters go to
    ``fn``, which normalises inside its kernel (kernel 2 of the fused MLP,
    kernel 8 of the ``lnqkv`` projection)."""

    def __init__(self, dim: int, fn: nn.Module, fuse_ln: bool = False):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn
        self.fuse_ln = fuse_ln

    def forward(self, x, rng: DropoutRNG | None = None):
        if self.fuse_ln:
            return self.fn(x, rng, ln=self.norm)
        return self.fn(self.norm(x), rng)


class Residual(nn.Module):
    """Pre-norm residual branch with DropPath on the branch (reference
    ``Residual_droppath``, ``layers.py:399-423``)."""

    def __init__(self, fn: nn.Module, drop_path_rate: float = 0.0):
        super().__init__()
        self.fn = fn
        self.drop_path_rate = float(drop_path_rate)

    def forward(self, x, rng: DropoutRNG | None = None):
        h = self.fn(x, rng)
        if self.training and self.drop_path_rate > 0.0:
            h = drop_path(h, self.drop_path_rate, rng)
        return x + h


class Transformer(nn.Module):
    """Depth-stacked pre-norm transformer. ``mlp_impl='fused_ln'`` runs each
    block's LayerNorm + MLP as kernel 2 (kernel 3 backward) and ``'fused'``
    its MLP alone as kernel 4 (kernel 5 backward) when ``dim`` and
    ``mlp_dim`` are multiples of 128, as the JAX block does; otherwise, and
    for ``'dense'``, plain PyTorch. ``attn_impl='fused'`` runs attention
    through kernels 6 and 7, ``'flash'`` through kernels 11a-c,
    ``'lnqkv'`` the LayerNorm and ``to_qkv`` through kernels 8 and 9 when
    ``dim`` is a multiple of 128 (see :class:`Attention`)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0,
                 drop_path_rate: float = 0.0, attn_impl: str = "einsum",
                 mlp_impl: str = "dense"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS or mlp_impl not in MLP_IMPLS:
            raise NotImplementedError(
                f"attn_impl={attn_impl!r}, mlp_impl={mlp_impl!r}: the port "
                f"has attn {ATTN_IMPLS} and mlp {MLP_IMPLS}; the other "
                "kernels are queued in ROADMAP.md"
            )
        fuse_ln = (mlp_impl == "fused_ln" and dim % 128 == 0
                   and mlp_dim % 128 == 0)
        lnqkv = attn_impl == "lnqkv" and dim % 128 == 0
        self.layers = nn.ModuleList(
            nn.ModuleList([
                Residual(PreNorm(dim, Attention(dim, heads, dim_head, dropout,
                                                attn_impl), lnqkv),
                         drop_path_rate),
                Residual(PreNorm(dim, FeedForward(dim, mlp_dim, dropout,
                                                  mlp_impl), fuse_ln),
                         drop_path_rate),
            ])
            for _ in range(depth)
        )

    def forward(self, x, rng: DropoutRNG | None = None):
        for attn, ff in self.layers:
            x = ff(attn(x, rng), rng)
        return x
