"""The transformer MLP with dropout, fused (counterpart of
``lafs_cvpr2024_tpu/ops/fused_mlp.py``), with and without the pre-MLP
LayerNorm inside:

    fused_mlp:    y = drop₂(drop₁(gelu(x @ w1ᵀ + b1)) @ w2ᵀ + b2)
    fused_ln_mlp: the same on LN(x; g, bt)

Four kernels carry them on the card, each beside its plain PyTorch version
(the CPU path and the kernel's oracle):

- kernel 2, ``csrc/fused_ln_mlp.cu``, the LN-fused forward (replaces the
  Pallas ``_ln_fwd_kernel``), optionally saving the pre-activation ``u``;
- kernel 3, ``csrc/fused_ln_mlp_bwd.cu``, its backward (replaces
  ``_ln_bwd_kernel``): regenerated masks, GELU′, ``do·W2``, ``du·W1`` and the
  LayerNorm backward, with per-block dγ/dβ partial sums;
- kernel 4, ``csrc/fused_mlp.cu``, the forward without the LayerNorm
  (replaces ``_fwd_kernel``; ``mlp_impl='fused'``);
- kernel 5, ``csrc/fused_mlp_bwd.cu``, its backward (replaces
  ``_bwd_kernel``): regenerated masks, ``do·W2`` and GELU′, ending at
  ``(do, hd, du)``.

:class:`FusedLNMLP` and :class:`FusedMLP` join them into autograd
functions; the weight gradients (and kernel 5's ``dx = du·W1``) are plain
``torch.matmul`` products, as the JAX package leaves them to XLA outside its
kernels. Weights come in the ``nn.Linear`` layout: ``w1`` is (H, D) and
``w2`` is (D, H), the transposes of the JAX kernels'.

Dropout bits are the JAX kernels' interpret-mode counter hash
(``fused_mlp.py::_bits``, ``_thresh``), keyed by (seed, row tile, draw, row
in tile, column) with draw 0 for the hidden activation and draw 1 for the
output, and the JAX kernels' row tile (128 rows for bf16, 64 for fp32). So
the plain versions, the CUDA kernels and the JAX CPU reference draw the
same masks bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build

_DTYPES = (torch.float32, torch.bfloat16)
_M32 = 0xFFFFFFFF


def dropout_tile(dtype: torch.dtype) -> int:
    """Row tile of the JAX kernel for ``dtype`` (``fused_mlp.py::_tile``):
    the dropout hash's key, not a tile of the CUDA kernels."""
    return 128 if dtype.itemsize <= 2 else 64


def keep_threshold(rate: float) -> int:
    """Keep an element when its 32 random bits are below this
    (``fused_mlp.py::_thresh``)."""
    return min(int(round((1.0 - rate) * 2.0 ** 32)), 2 ** 32 - 1)


def inv_keep(rate: float) -> float:
    """The float32 factor ``1 / (1 - rate)`` that kept elements are scaled
    by, as the JAX kernel's ``h * (1.0 / keep)`` rounds it."""
    return float(np.float32(1.0 / (1.0 - rate)))


def dropout_bits(rows: int, cols: int, seed: int, draw: int,
                 tile: int, device=None) -> torch.Tensor:
    """(rows, cols) uint32 values (in int64) of the counter hash for
    global rows ``0..rows-1``. torch has no full uint32 arithmetic: every
    product is taken in int64 and cut to its low 32 bits, which survive
    int64 wrap-around."""
    r = torch.arange(rows, device=device, dtype=torch.int64)
    c = torch.arange(cols, device=device, dtype=torch.int64)
    key = (seed + (r // tile) * 0xB5297A4D + draw * 0x85EBCA6B) & _M32
    v = (((r % tile) * 2654435761) & _M32)[:, None] \
        ^ ((c * 0x9E3779B9) & _M32)[None, :] ^ key[:, None]
    v = ((v ^ (v >> 16)) * 0x7FEB352D) & _M32
    v = ((v ^ (v >> 15)) * 0x846CA68B) & _M32
    return v ^ (v >> 16)


def dropout_mask(rows: int, cols: int, seed: int, rate: float, draw: int,
                 dtype: torch.dtype, device=None) -> torch.Tensor:
    """Boolean keep-mask of one draw for a (rows, cols) activation of a
    call in ``dtype``."""
    bits = dropout_bits(rows, cols, seed, draw, dropout_tile(dtype), device)
    return bits < keep_threshold(rate)


def _gelu_grad(u: torch.Tensor) -> torch.Tensor:
    """d/du [u Φ(u)] = Φ(u) + u φ(u), exact erf form."""
    phi = torch.exp(-0.5 * u * u) * (1.0 / math.sqrt(2.0 * math.pi))
    return 0.5 * (1.0 + torch.erf(u * (1.0 / math.sqrt(2.0)))) + u * phi


def _ln_rows(xf: torch.Tensor, eps: float):
    """Row LayerNorm in fp32: (xhat, rstd), two-pass statistics."""
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return xc * rstd, rstd


def _ln_bwd(dxn: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
            gf: torch.Tensor):
    """LayerNorm backward in fp32 from dxn, the normalised rows and their
    rstd: ``(dx, dγ, dβ)``, dγ and dβ summed over the rows."""
    dxhat = dxn * gf
    m_1 = dxhat.mean(-1, keepdim=True)
    m_2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd * (dxhat - m_1 - xhat * m_2)
    return dx, (dxn * xhat).sum(0), dxn.sum(0)


# ------------------------------------------------------------ forward --

def fused_mlp_fwd_plain(x, w1, b1, w2, b2, *, rate: float = 0.0,
                        seed: int = 0, save_u: bool = False):
    """Kernel 4's arithmetic in plain PyTorch on x (T, D) (``_fwd_kernel``,
    ``fused_mlp.py:94-114``): both products accumulated in fp32, h cast to
    the input dtype before the second. Returns ``(y, u)``, ``u`` (T, H) in
    x's dtype when ``save_u``, else None."""
    dt, f32 = x.dtype, torch.float32
    t = x.shape[0]
    u = torch.matmul(x.to(f32), w1.to(f32).t()) + b1.to(f32)
    h = F.gelu(u)
    if rate > 0.0:
        m1 = dropout_mask(t, h.shape[1], seed, rate, 0, dt, x.device)
        h = torch.where(m1, h * inv_keep(rate), 0.0)
    y = torch.matmul(h.to(dt).to(f32), w2.to(f32).t()) + b2.to(f32)
    if rate > 0.0:
        m2 = dropout_mask(t, y.shape[1], seed, rate, 1, dt, x.device)
        y = torch.where(m2, y * inv_keep(rate), 0.0)
    return y.to(dt), (u.to(dt) if save_u else None)


def fused_ln_mlp_fwd_plain(x, g, bt, w1, b1, w2, b2, *, eps: float = 1e-5,
                           rate: float = 0.0, seed: int = 0,
                           save_u: bool = False):
    """Kernel 2's arithmetic in plain PyTorch on x (T, D): LN statistics in
    fp32, xn cast to the input dtype (``fused_mlp.py:371``), then kernel 4's
    (:func:`fused_mlp_fwd_plain`). Returns ``(y, u)`` as that does
    (``fused_mlp.py:471-475``)."""
    f32 = torch.float32
    xhat, _ = _ln_rows(x.to(f32), eps)
    xn = (xhat * g.to(f32) + bt.to(f32)).to(x.dtype)
    return fused_mlp_fwd_plain(xn, w1, b1, w2, b2, rate=rate, seed=seed,
                               save_u=save_u)


def _check(what, x, ops, d, hdim, max_d):
    if not x.is_cuda or any(t.device != x.device for t in ops):
        raise ValueError(f"{what}: every operand must be on x's CUDA device "
                         f"({x.device})")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ops):
        raise TypeError(
            f"{what} takes float32 or bfloat16 with every operand in x's "
            f"dtype, got x {x.dtype} and {[str(t.dtype) for t in ops]}")
    if d % 128 or d > max_d or hdim % 128:
        raise ValueError(
            f"{what} takes D % 128 == 0, D <= {max_d} and H % 128 == 0; "
            f"got D={d}, H={hdim}")


def _drop_args(rate: float, seed: int):
    """(seed, threshold, 1/keep, on) as the C interface takes them."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate == 0.0:
        return 0, 0, 1.0, 0
    return seed & _M32, keep_threshold(rate), inv_keep(rate), 1


def fused_ln_mlp_fwd_cuda(x, g, bt, w1, b1, w2, b2, *, eps: float = 1e-5,
                          rate: float = 0.0, seed: int = 0,
                          save_u: bool = False):
    """Launch kernel 2 on x (T, D) on its CUDA device (every operand in x's
    dtype, D a multiple of 128 up to 768, H a multiple of 128). Returns
    ``(y, u)`` as :func:`fused_ln_mlp_fwd_plain`."""
    d, hdim = x.shape[-1], w1.shape[0]
    ops = (g, bt, w1, b1, w2, b2)
    _check("fused_ln_mlp_fwd_cuda", x, ops, d, hdim, 768)
    if tuple(w1.shape) != (hdim, d) or tuple(w2.shape) != (d, hdim) \
            or g.shape != (d,) or bt.shape != (d,) or b1.shape != (hdim,) \
            or b2.shape != (d,) or x.ndim != 2:
        raise ValueError(
            f"fused_ln_mlp_fwd_cuda: shapes x {tuple(x.shape)}, w1 "
            f"{tuple(w1.shape)}, w2 {tuple(w2.shape)} do not form an MLP "
            f"of width {d} -> {hdim} on (T, D) rows")
    x = x.contiguous()
    g, bt, w1, b1, w2, b2 = (v.contiguous() for v in ops)
    if w1.data_ptr() % 32 or w2.data_ptr() % 32:
        raise ValueError("fused_ln_mlp_fwd_cuda: the weights must be 32-byte "
                         "aligned (tensor-core fragment loads)")
    t = x.shape[0]
    y = torch.empty_like(x)
    u = x.new_empty((t, hdim)) if save_u else None
    s, thresh, ik, drop = _drop_args(rate, seed)
    lib = _build.library()
    fn = (lib.lafs_fused_ln_mlp_bf16 if x.dtype == torch.bfloat16
          else lib.lafs_fused_ln_mlp_f32)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), g.data_ptr(), bt.data_ptr(), w1.data_ptr(),
                 b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
                 u.data_ptr() if save_u else None, t, d, hdim, float(eps),
                 s, thresh, ik, drop, _build.stream_ptr(x))
    _build.check(err, "fused_ln_mlp kernel")
    _build.LAUNCHES["fused_ln_mlp"] += 1
    return y, u


def fused_ln_mlp_fwd(x, g, bt, w1, b1, w2, b2, **kw):
    """Kernel 2 for a CUDA tensor, its plain version for a CPU tensor."""
    if x.is_cuda:
        return fused_ln_mlp_fwd_cuda(x, g, bt, w1, b1, w2, b2, **kw)
    return fused_ln_mlp_fwd_plain(x, g, bt, w1, b1, w2, b2, **kw)


# ----------------------------------------------------------- backward --

def fused_mlp_bwd_plain(u, dy, w2, *, rate: float = 0.0, seed: int = 0):
    """Kernel 5's arithmetic in plain PyTorch (``_bwd_kernel``,
    ``fused_mlp.py:117-148``) on dy (T, D) and the saved u (T, H): both
    masks regenerated, ``do = drop₂(dy)`` and ``hd = drop₁(gelu(u))``,
    ``dhd = do·W2`` accumulated in fp32 from the rounded do, masked, times
    GELU′(u). Returns ``(do, hd, du)`` in dy's dtype."""
    dt, f32 = dy.dtype, torch.float32
    t = dy.shape[0]
    uf, dyf = u.to(f32), dy.to(f32)
    h = F.gelu(uf)
    if rate > 0.0:
        ik = inv_keep(rate)
        m1 = dropout_mask(t, uf.shape[1], seed, rate, 0, dt, dy.device)
        m2 = dropout_mask(t, dyf.shape[1], seed, rate, 1, dt, dy.device)
        do = torch.where(m2, dyf * ik, 0.0)
        hd = torch.where(m1, h * ik, 0.0)
    else:
        do, hd = dyf, h
    do = do.to(dt)
    dhd = torch.matmul(do.to(f32), w2.to(f32))
    if rate > 0.0:
        dhd = torch.where(m1, dhd * ik, 0.0)
    return do, hd.to(dt), (dhd * _gelu_grad(uf)).to(dt)


def fused_ln_mlp_bwd_plain(x, u, dy, g, bt, w1, w2, *, eps: float = 1e-5,
                           rate: float = 0.0, seed: int = 0):
    """Kernel 3's arithmetic in plain PyTorch (``_ln_bwd_kernel``,
    ``fused_mlp.py:391-453``) on x, dy (T, D) and the saved u (T, H).

    Returns ``(do, hd, du, xn, dx, dg, dbt)``: do (T, D) and hd, du (T, H)
    (:func:`fused_mlp_bwd_plain`) and xn, dx (T, D) in x's dtype, dγ and dβ
    as fp32 sums over the rows. ``du`` is cast to x's dtype before
    ``du·W1``, as the JAX kernel does."""
    dt, f32 = x.dtype, torch.float32
    xhat, rstd = _ln_rows(x.to(f32), eps)
    gf = g.to(f32)
    xn = (xhat * gf + bt.to(f32)).to(dt)
    do, hd, du = fused_mlp_bwd_plain(u, dy.to(dt), w2, rate=rate, seed=seed)
    dxn = torch.matmul(du.to(f32), w1.to(f32))
    dx, dg, dbt = _ln_bwd(dxn, xhat, rstd, gf)
    return do, hd, du, xn, dx.to(dt), dg, dbt


def fused_ln_mlp_bwd_cuda(x, u, dy, g, bt, w1, w2, *, eps: float = 1e-5,
                          rate: float = 0.0, seed: int = 0):
    """Launch kernel 3 on its CUDA device; returns what
    :func:`fused_ln_mlp_bwd_plain` returns, dγ/dβ summed from the kernel's
    per-block partials (a deterministic ``.sum(0)``, no atomics)."""
    d, hdim = x.shape[-1], w1.shape[0]
    ops = (u, dy, g, bt, w1, w2)
    _check("fused_ln_mlp_bwd_cuda", x, ops, d, hdim, 768)
    t = x.shape[0]
    if x.ndim != 2 or tuple(dy.shape) != (t, d) or tuple(u.shape) != (t, hdim) \
            or tuple(w1.shape) != (hdim, d) or tuple(w2.shape) != (d, hdim) \
            or g.shape != (d,) or bt.shape != (d,):
        raise ValueError(
            f"fused_ln_mlp_bwd_cuda: shapes x {tuple(x.shape)}, u "
            f"{tuple(u.shape)}, dy {tuple(dy.shape)}, w1 {tuple(w1.shape)}, "
            f"w2 {tuple(w2.shape)} do not form an MLP of width {d} -> {hdim}")
    x, u, dy, g, bt, w1, w2 = (v.contiguous() for v in (x, u, dy, *ops[2:]))
    if w1.data_ptr() % 32 or w2.data_ptr() % 32:
        raise ValueError("fused_ln_mlp_bwd_cuda: the weights must be 32-byte "
                         "aligned (tensor-core fragment loads)")
    lib = _build.library()
    blocks = lib.lafs_row_blocks(t)
    do, xn, dx = (torch.empty_like(x) for _ in range(3))
    hd, du = torch.empty_like(u), torch.empty_like(u)
    dgp = torch.empty((max(blocks, 1), d), device=x.device, dtype=torch.float32)
    dbp = torch.empty_like(dgp)
    s, thresh, ik, drop = _drop_args(rate, seed)
    fn = (lib.lafs_fused_ln_mlp_bwd_bf16 if x.dtype == torch.bfloat16
          else lib.lafs_fused_ln_mlp_bwd_f32)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), u.data_ptr(), dy.data_ptr(), g.data_ptr(),
                 bt.data_ptr(), w1.data_ptr(), w2.data_ptr(), do.data_ptr(),
                 hd.data_ptr(), du.data_ptr(), xn.data_ptr(), dx.data_ptr(),
                 dgp.data_ptr(), dbp.data_ptr(), t, d, hdim, float(eps),
                 s, thresh, ik, drop, _build.stream_ptr(x))
    _build.check(err, "fused_ln_mlp_bwd kernel")
    _build.LAUNCHES["fused_ln_mlp_bwd"] += 1
    return do, hd, du, xn, dx, dgp[:blocks].sum(0), dbp[:blocks].sum(0)


def fused_ln_mlp_bwd(x, u, dy, g, bt, w1, w2, **kw):
    """Kernel 3 for a CUDA tensor, its plain version for a CPU tensor."""
    if x.is_cuda:
        return fused_ln_mlp_bwd_cuda(x, u, dy, g, bt, w1, w2, **kw)
    return fused_ln_mlp_bwd_plain(x, u, dy, g, bt, w1, w2, **kw)


class FusedLNMLP(torch.autograd.Function):
    """The fused MLP with its gradient (``fused_mlp.py::_fused_ln_mlp2d``):
    kernel 2 with ``u`` saved forward, kernel 3 backward, then the weight
    and bias gradients as plain products and sums (``fused_mlp.py:589-603``:
    XLA's work in the JAX package)."""

    @staticmethod
    def forward(ctx, x, g, bt, w1, b1, w2, b2, eps, rate, seed):
        y, u = fused_ln_mlp_fwd(x, g, bt, w1, b1, w2, b2, eps=eps, rate=rate,
                                seed=seed, save_u=True)
        ctx.save_for_backward(x, u, g, bt, w1, w2)
        ctx.hyper = dict(eps=eps, rate=rate, seed=seed)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, u, g, bt, w1, w2 = ctx.saved_tensors
        do, hd, du, xn, dx, dg, dbt = fused_ln_mlp_bwd(
            x, u, dy.contiguous(), g, bt, w1, w2, **ctx.hyper)
        f32 = torch.float32
        # products in x's dtype accumulate in fp32 (cuBLAS and the CPU
        # kernels), rounded once to the weight's dtype
        dw1 = torch.matmul(du.t(), xn).to(w1.dtype)
        dw2 = torch.matmul(do.t(), hd).to(w2.dtype)
        db1 = du.to(f32).sum(0).to(x.dtype)
        db2 = do.to(f32).sum(0).to(x.dtype)
        return (dx, dg.to(g.dtype), dbt.to(bt.dtype), dw1, db1, dw2, db2,
                None, None, None)


def fused_ln_mlp(x, g, bt, w1, b1, w2, b2, *, eps: float = 1e-5,
                 rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """x (..., D) → (..., D), dropout at ``rate`` with the int ``seed``.
    A CUDA tensor launches the kernels; a CPU tensor runs their plain
    versions. With autograd recording and an operand that needs a
    gradient, the forward saves ``u`` and the backward runs kernel 3."""
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    ops = (x2, g, bt, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        y = FusedLNMLP.apply(*ops, float(eps), float(rate), int(seed))
    else:
        y, _ = fused_ln_mlp_fwd(*ops, eps=eps, rate=rate, seed=seed)
    return y.reshape(*lead, d)


# ------------------------------------------------- without the LayerNorm --

def fused_mlp_fwd_cuda(x, w1, b1, w2, b2, *, rate: float = 0.0,
                       seed: int = 0, save_u: bool = False):
    """Launch kernel 4 on x (T, D) on its CUDA device (every operand in x's
    dtype, D a multiple of 128 up to 768, H a multiple of 128). Returns
    ``(y, u)`` as :func:`fused_mlp_fwd_plain`."""
    d, hdim = x.shape[-1], w1.shape[0]
    ops = (w1, b1, w2, b2)
    _check("fused_mlp_fwd_cuda", x, ops, d, hdim, 768)
    if tuple(w1.shape) != (hdim, d) or tuple(w2.shape) != (d, hdim) \
            or b1.shape != (hdim,) or b2.shape != (d,) or x.ndim != 2:
        raise ValueError(
            f"fused_mlp_fwd_cuda: shapes x {tuple(x.shape)}, w1 "
            f"{tuple(w1.shape)}, w2 {tuple(w2.shape)} do not form an MLP "
            f"of width {d} -> {hdim} on (T, D) rows")
    x = x.contiguous()
    w1, b1, w2, b2 = (v.contiguous() for v in ops)
    if w1.data_ptr() % 32 or w2.data_ptr() % 32:
        raise ValueError("fused_mlp_fwd_cuda: the weights must be 32-byte "
                         "aligned (tensor-core fragment loads)")
    t = x.shape[0]
    y = torch.empty_like(x)
    u = x.new_empty((t, hdim)) if save_u else None
    lib = _build.library()
    fn = (lib.lafs_fused_mlp_bf16 if x.dtype == torch.bfloat16
          else lib.lafs_fused_mlp_f32)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), y.data_ptr(), u.data_ptr() if save_u else None,
                 t, d, hdim, *_drop_args(rate, seed), _build.stream_ptr(x))
    _build.check(err, "fused_mlp kernel")
    _build.LAUNCHES["fused_mlp"] += 1
    return y, u


def fused_mlp_fwd(x, w1, b1, w2, b2, **kw):
    """Kernel 4 for a CUDA tensor, its plain version for a CPU tensor."""
    if x.is_cuda:
        return fused_mlp_fwd_cuda(x, w1, b1, w2, b2, **kw)
    return fused_mlp_fwd_plain(x, w1, b1, w2, b2, **kw)


def fused_mlp_bwd_cuda(u, dy, w2, *, rate: float = 0.0, seed: int = 0):
    """Launch kernel 5 on its CUDA device; returns what
    :func:`fused_mlp_bwd_plain` returns."""
    t, d = dy.shape[0], dy.shape[-1]
    hdim = u.shape[-1]
    _check("fused_mlp_bwd_cuda", dy, (u, w2), d, hdim, 768)
    if dy.ndim != 2 or tuple(u.shape) != (t, hdim) \
            or tuple(w2.shape) != (d, hdim):
        raise ValueError(
            f"fused_mlp_bwd_cuda: shapes u {tuple(u.shape)}, dy "
            f"{tuple(dy.shape)}, w2 {tuple(w2.shape)} do not form an MLP of "
            f"width {d} -> {hdim}")
    u, dy, w2 = u.contiguous(), dy.contiguous(), w2.contiguous()
    if w2.data_ptr() % 32:
        raise ValueError("fused_mlp_bwd_cuda: w2 must be 32-byte aligned "
                         "(tensor-core fragment loads)")
    do = torch.empty_like(dy)
    hd, du = torch.empty_like(u), torch.empty_like(u)
    lib = _build.library()
    fn = (lib.lafs_fused_mlp_bwd_bf16 if dy.dtype == torch.bfloat16
          else lib.lafs_fused_mlp_bwd_f32)
    with torch.cuda.device(dy.device):
        err = fn(u.data_ptr(), dy.data_ptr(), w2.data_ptr(), do.data_ptr(),
                 hd.data_ptr(), du.data_ptr(), t, d, hdim,
                 *_drop_args(rate, seed), _build.stream_ptr(dy))
    _build.check(err, "fused_mlp_bwd kernel")
    _build.LAUNCHES["fused_mlp_bwd"] += 1
    return do, hd, du


def fused_mlp_bwd(u, dy, w2, **kw):
    """Kernel 5 for a CUDA tensor, its plain version for a CPU tensor."""
    if dy.is_cuda:
        return fused_mlp_bwd_cuda(u, dy, w2, **kw)
    return fused_mlp_bwd_plain(u, dy, w2, **kw)


class FusedMLP(torch.autograd.Function):
    """The fused MLP without the LayerNorm, with its gradient
    (``fused_mlp.py::_fused_mlp2d``): kernel 4 with ``u`` saved forward,
    kernel 5 backward, then dx, the weight and the bias gradients as plain
    products and sums (``fused_mlp.py:281-304``: XLA's work in the JAX
    package)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, rate, seed):
        y, u = fused_mlp_fwd(x, w1, b1, w2, b2, rate=rate, seed=seed,
                             save_u=True)
        ctx.save_for_backward(x, u, w1, w2)
        ctx.hyper = dict(rate=rate, seed=seed)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, u, w1, w2 = ctx.saved_tensors
        do, hd, du = fused_mlp_bwd(u, dy.contiguous(), w2, **ctx.hyper)
        f32 = torch.float32
        # products in x's dtype accumulate in fp32, rounded once
        dx = torch.matmul(du, w1).to(x.dtype)
        dw1 = torch.matmul(du.t(), x).to(w1.dtype)
        dw2 = torch.matmul(do.t(), hd).to(w2.dtype)
        db1 = du.to(f32).sum(0).to(x.dtype)
        db2 = do.to(f32).sum(0).to(x.dtype)
        return dx, dw1, db1, dw2, db2, None, None


def fused_mlp(x, w1, b1, w2, b2, *, rate: float = 0.0,
              seed: int = 0) -> torch.Tensor:
    """x (..., D) → (..., D), dropout at ``rate`` with the int ``seed``; the
    caller applies any LayerNorm. A CUDA tensor launches kernels 4 and 5; a
    CPU tensor runs their plain versions. With autograd recording and an
    operand that needs a gradient, the forward saves ``u`` and the
    backward runs kernel 5."""
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    ops = (x2, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        y = FusedMLP.apply(*ops, float(rate), int(seed))
    else:
        y, _ = fused_mlp_fwd(*ops, rate=rate, seed=seed)
    return y.reshape(*lead, d)
