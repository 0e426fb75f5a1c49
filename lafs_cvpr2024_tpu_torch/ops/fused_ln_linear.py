"""LayerNorm fused into a bias-free linear projection (counterpart of
``lafs_cvpr2024_tpu/ops/fused_ln_linear.py``):

    y = LN(x; g, bt) @ wᵀ

the pre-attention LayerNorm and the reference's bias-free ``to_qkv``
(``attn_impl='lnqkv'``). LN statistics in fp32, ``xn`` rounded to x's
dtype, the product accumulated in fp32 (``fused_ln_linear.py:53-58``).
``w`` comes in the ``nn.Linear`` layout, (O, D), the transpose of the JAX
kernel's, and O is any width (2,112 for Part-fViT-B).

Two kernels carry it on the card, each beside its plain PyTorch version
(the CPU path and the kernel's oracle):

- kernel 8, ``csrc/fused_ln_linear.cu``, the forward (replaces the Pallas
  ``_fwd_kernel``);
- kernel 9, ``csrc/fused_ln_linear_bwd.cu``, the backward (replaces
  ``_bwd_kernel``): the LN statistics recomputed, ``xn`` emitted,
  ``dxn = dy·w`` and the LayerNorm backward, with per-block dγ/dβ partial
  sums.

:class:`FusedLNLinear` joins them into an autograd function; ``dW = dyᵀ·xn``
is a plain ``torch.matmul``, as the JAX package leaves it to XLA
(``fused_ln_linear.py:179-191``).
"""

from __future__ import annotations

import torch

from .. import _build
from .fused_mlp import _DTYPES, _ln_bwd, _ln_rows


def fused_ln_linear_fwd_plain(x, g, bt, w, *, eps: float = 1e-5):
    """Kernel 8's arithmetic in plain PyTorch on x (T, D): (T, O) in x's
    dtype."""
    f32 = torch.float32
    xhat, _ = _ln_rows(x.to(f32), eps)
    xn = (xhat * g.to(f32) + bt.to(f32)).to(x.dtype)
    return torch.matmul(xn.to(f32), w.to(f32).t()).to(x.dtype)


def fused_ln_linear_bwd_plain(x, dy, g, bt, w, *, eps: float = 1e-5):
    """Kernel 9's arithmetic in plain PyTorch (``_bwd_kernel``,
    ``fused_ln_linear.py:61-90``) on x (T, D) and dy (T, O): returns
    ``(xn, dx, dg, dbt)``, xn and dx in x's dtype, dγ and dβ as fp32 sums
    over the rows; dxn = dy·w stays fp32 into the LayerNorm backward."""
    dt, f32 = x.dtype, torch.float32
    xhat, rstd = _ln_rows(x.to(f32), eps)
    gf = g.to(f32)
    xn = (xhat * gf + bt.to(f32)).to(dt)
    dxn = torch.matmul(dy.to(f32), w.to(f32))
    dx, dg, dbt = _ln_bwd(dxn, xhat, rstd, gf)
    return xn, dx.to(dt), dg, dbt


def _checked(what, x, g, bt, w, dy=None):
    """x (T, D), g and bt (D,), w (O, D) and dy (T, O) on x's CUDA device
    in x's dtype, D a multiple of 128 up to 768, w 16-byte aligned:
    contiguous copies of (x, g, bt, w, dy)."""
    ops = (g, bt, w) + (() if dy is None else (dy,))
    d = x.shape[-1]
    if not x.is_cuda or any(t.device != x.device for t in ops):
        raise ValueError(f"{what}: every operand must be on x's CUDA device "
                         f"({x.device})")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ops):
        raise TypeError(
            f"{what} takes float32 or bfloat16 with every operand in x's "
            f"dtype, got x {x.dtype} and {[str(t.dtype) for t in ops]}")
    if d % 128 or d > 768:
        raise ValueError(f"{what} takes D % 128 == 0 and D <= 768, got D={d}")
    if x.ndim != 2 or w.ndim != 2 or w.shape[1] != d or w.shape[0] < 1 \
            or g.shape != (d,) or bt.shape != (d,) \
            or (dy is not None and tuple(dy.shape) != (x.shape[0], w.shape[0])):
        raise ValueError(
            f"{what}: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"{[tuple(t.shape) for t in ops]} do not form LN(x) @ wᵀ on "
            "(T, D) rows")
    x, g, bt, w = (t.contiguous() for t in (x, g, bt, w))
    if w.data_ptr() % 16:
        raise ValueError(f"{what}: w must be 16-byte aligned (16-byte tile "
                         "loads)")
    return x, g, bt, w, (None if dy is None else dy.contiguous())


def fused_ln_linear_fwd_cuda(x, g, bt, w, *, eps: float = 1e-5):
    """Launch kernel 8 on x (T, D) on its CUDA device; returns what
    :func:`fused_ln_linear_fwd_plain` returns."""
    x, g, bt, w, _ = _checked("fused_ln_linear_fwd_cuda", x, g, bt, w)
    t, d = x.shape
    o = w.shape[0]
    y = x.new_empty((t, o))
    lib = _build.library()
    fn = (lib.lafs_fused_ln_linear_bf16 if x.dtype == torch.bfloat16
          else lib.lafs_fused_ln_linear_f32)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), g.data_ptr(), bt.data_ptr(), w.data_ptr(),
                 y.data_ptr(), t, d, o, float(eps), _build.stream_ptr(x))
    _build.check(err, "fused_ln_linear kernel")
    _build.LAUNCHES["fused_ln_linear"] += 1
    return y


def fused_ln_linear_bwd_cuda(x, dy, g, bt, w, *, eps: float = 1e-5):
    """Launch kernel 9 on its CUDA device; returns what
    :func:`fused_ln_linear_bwd_plain` returns, dγ/dβ summed from the
    kernel's per-block partials (a deterministic ``.sum(0)``, no
    atomics)."""
    x, g, bt, w, dy = _checked("fused_ln_linear_bwd_cuda", x, g, bt, w, dy)
    t, d = x.shape
    lib = _build.library()
    blocks = lib.lafs_row_blocks(t)
    xn, dx = torch.empty_like(x), torch.empty_like(x)
    dgp = torch.empty((max(blocks, 1), d), device=x.device,
                      dtype=torch.float32)
    dbp = torch.empty_like(dgp)
    fn = (lib.lafs_fused_ln_linear_bwd_bf16 if x.dtype == torch.bfloat16
          else lib.lafs_fused_ln_linear_bwd_f32)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dy.data_ptr(), g.data_ptr(), bt.data_ptr(),
                 w.data_ptr(), xn.data_ptr(), dx.data_ptr(), dgp.data_ptr(),
                 dbp.data_ptr(), t, d, w.shape[0], float(eps),
                 _build.stream_ptr(x))
    _build.check(err, "fused_ln_linear_bwd kernel")
    _build.LAUNCHES["fused_ln_linear_bwd"] += 1
    return xn, dx, dgp[:blocks].sum(0), dbp[:blocks].sum(0)


def fused_ln_linear_fwd(x, g, bt, w, **kw):
    """Kernel 8 for a CUDA tensor, its plain version for a CPU tensor."""
    if x.is_cuda:
        return fused_ln_linear_fwd_cuda(x, g, bt, w, **kw)
    return fused_ln_linear_fwd_plain(x, g, bt, w, **kw)


def fused_ln_linear_bwd(x, dy, g, bt, w, **kw):
    """Kernel 9 for a CUDA tensor, its plain version for a CPU tensor."""
    if x.is_cuda:
        return fused_ln_linear_bwd_cuda(x, dy, g, bt, w, **kw)
    return fused_ln_linear_bwd_plain(x, dy, g, bt, w, **kw)


class FusedLNLinear(torch.autograd.Function):
    """LN + linear with its gradient (``fused_ln_linear.py::
    _fused_ln_linear2d``): kernel 8 forward, kernel 9 backward, then
    ``dW = dyᵀ·xn`` as a plain product (``fused_ln_linear.py:179-191``)."""

    @staticmethod
    def forward(ctx, x, g, bt, w, eps):
        ctx.save_for_backward(x, g, bt, w)
        ctx.eps = eps
        return fused_ln_linear_fwd(x, g, bt, w, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, g, bt, w = ctx.saved_tensors
        xn, dx, dg, dbt = fused_ln_linear_bwd(x, dy.contiguous(), g, bt, w,
                                              eps=ctx.eps)
        # a product in x's dtype accumulates in fp32, rounded once
        dw = torch.matmul(dy.t(), xn).to(w.dtype)
        return dx, dg.to(g.dtype), dbt.to(bt.dtype), dw, None


def fused_ln_linear(x, g, bt, w, *, eps: float = 1e-5) -> torch.Tensor:
    """x (..., D) → (..., O) = LN(x; g, bt) @ wᵀ, no bias. A CUDA tensor
    launches kernels 8 and 9; a CPU tensor runs their plain versions."""
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    ops = (x2, g, bt, w)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        y = FusedLNLinear.apply(*ops, float(eps))
    else:
        y = fused_ln_linear_fwd(*ops, eps=eps)
    return y.reshape(*lead, w.shape[0])
