"""Transformer core layers (counterpart of ``lafs_cvpr2024_tpu/models/
layers.py``), eval mode.

Module names follow the reference ``state_dict`` (``ViT_face.py:100-213``):
``transformer.layers.{i}.0.fn.{norm,fn.to_qkv,fn.to_out.0}`` and
``transformer.layers.{i}.1.fn.{norm,fn.net.0,fn.net.3}``, so reference and
exported checkpoints load with ``strict=True``. The reference quirks stay:
attention scale ``dim ** -0.5`` with the MODEL dim, an inner width
``heads * dim_head`` that may differ from ``dim`` (704 for Part-fViT-B),
a bias-free ``to_qkv`` split q|k|v on the last axis, LayerNorm eps 1e-5 and
exact GELU.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.fused_mlp import fused_ln_mlp

ATTN_IMPLS = ("einsum",)
MLP_IMPLS = ("dense", "fused_ln")


class FeedForward(nn.Module):
    """Reference MLP: Linear, GELU (exact), Dropout, Linear, Dropout."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(
            nn.Linear(dim, hidden_dim), nn.GELU(), nn.Dropout(dropout),
            nn.Linear(hidden_dim, dim), nn.Dropout(dropout),
        )

    def forward(self, x, ln: nn.LayerNorm | None = None):
        """``ln`` given: the pre-MLP LayerNorm runs inside the fused kernel
        (``mlp_impl='fused_ln'``); ``x`` is then un-normalised."""
        if ln is None:
            return self.net(x)
        fc1, fc2 = self.net[0], self.net[3]
        dt = x.dtype  # the JAX layer casts every operand to x's dtype
        return fused_ln_mlp(
            x, ln.weight.to(dt), ln.bias.to(dt), fc1.weight.to(dt),
            fc1.bias.to(dt), fc2.weight.to(dt), fc2.bias.to(dt),
            eps=ln.eps, rate=self.net[2].p if self.training else 0.0,
        )


class Attention(nn.Module):
    """Multi-head self-attention on the einsum path: the score and value
    products stay ``torch.matmul``, as the JAX default leaves them to XLA."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.scale = dim ** -0.5  # reference quirk: model-dim scaling
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Dropout(dropout))

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = (
            t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
            for t in self.to_qkv(x).chunk(3, dim=-1)
        )
        attn = (torch.matmul(q, k.transpose(-1, -2)) * self.scale).softmax(-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, -1)
        return self.to_out(out)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class Residual(nn.Module):
    """Pre-norm residual branch (reference ``Residual_droppath``; DropPath is
    the identity in eval)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return x + self.fn(x)


class Transformer(nn.Module):
    """Depth-stacked pre-norm transformer. ``mlp_impl='fused_ln'`` runs each
    block's LayerNorm + MLP as kernel 2 when ``dim`` and ``mlp_dim`` are
    multiples of 128, as the JAX block does; otherwise, and for
    ``'dense'``, plain PyTorch."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0,
                 attn_impl: str = "einsum", mlp_impl: str = "dense"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS or mlp_impl not in MLP_IMPLS:
            raise NotImplementedError(
                f"attn_impl={attn_impl!r}, mlp_impl={mlp_impl!r}: the port "
                f"has attn {ATTN_IMPLS} and mlp {MLP_IMPLS}; the other "
                "kernels are queued in ROADMAP.md"
            )
        self.fuse_ln = (mlp_impl == "fused_ln" and dim % 128 == 0
                        and mlp_dim % 128 == 0)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                Residual(PreNorm(dim, Attention(dim, heads, dim_head, dropout))),
                Residual(PreNorm(dim, FeedForward(dim, mlp_dim, dropout))),
            ])
            for _ in range(depth)
        )

    def forward(self, x):
        for attn, ff in self.layers:
            x = attn(x)
            if self.fuse_ln:
                x = x + ff.fn.fn(x, ln=ff.fn.norm)
            else:
                x = ff(x)
        return x
