"""LayerNorm-fused transformer MLP (counterpart of ``lafs_cvpr2024_tpu/ops/
fused_mlp.py::fused_ln_mlp``), forward at dropout rate 0.

    y = gelu(LN(x; g, bt) @ w1ᵀ + b1) @ w2ᵀ + b2

Kernel 2 of the port, ``csrc/fused_ln_mlp.cu``, replaces the Pallas
``_ln_fwd_kernel``; its header says what bounds it on the card. Beside it,
:func:`fused_ln_mlp_plain` is its plain PyTorch version: the CPU path and
the kernel's oracle. Weights come in the ``nn.Linear`` layout that the
kernel reads: ``w1`` is (H, D) and ``w2`` is (D, H), the transposes of the
JAX kernel's (D, H) and (H, D).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build

_DTYPES = (torch.float32, torch.bfloat16)


def fused_ln_mlp(x, g, bt, w1, b1, w2, b2, *, eps: float = 1e-5,
                 rate: float = 0.0) -> torch.Tensor:
    """x (..., D) → (..., D). A CUDA tensor launches the kernel; a CPU
    tensor runs the plain version. Dropout is not ported: ``rate > 0``
    raises rather than silently dropping it."""
    if rate > 0.0:
        raise NotImplementedError(
            "fused_ln_mlp: dropout inside the fused MLP is not ported yet; it "
            "comes with the SSL training step (ROADMAP.md, Open items 1.7)"
        )
    if x.is_cuda:
        return fused_ln_mlp_cuda(x, g, bt, w1, b1, w2, b2, eps=eps)
    return fused_ln_mlp_plain(x, g, bt, w1, b1, w2, b2, eps=eps)


def fused_ln_mlp_plain(x, g, bt, w1, b1, w2, b2, *, eps: float = 1e-5):
    """The kernel's arithmetic in plain PyTorch: LN statistics in fp32, xn
    and h cast to the input dtype (``fused_mlp.py:371,381`` of the JAX
    kernel), both products accumulated in fp32."""
    dt = x.dtype
    f32 = torch.float32
    xf = x.to(f32)
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    xn = (xc * torch.rsqrt(var + eps) * g.to(f32) + bt.to(f32)).to(dt)
    u = torch.matmul(xn.to(f32), w1.to(f32).t()) + b1.to(f32)
    h = F.gelu(u).to(dt)
    y = torch.matmul(h.to(f32), w2.to(f32).t()) + b2.to(f32)
    return y.to(dt)


def fused_ln_mlp_cuda(x, g, bt, w1, b1, w2, b2, *, eps: float = 1e-5):
    """Launch kernel 2 on ``x``'s CUDA device (every operand in x's dtype,
    D a multiple of 128 up to 768, H a multiple of 128)."""
    d = x.shape[-1]
    hdim = w1.shape[0]
    ops = (g, bt, w1, b1, w2, b2)
    if not x.is_cuda or any(t.device != x.device for t in ops):
        raise ValueError("fused_ln_mlp_cuda: every operand must be on x's "
                         f"CUDA device ({x.device})")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ops):
        raise TypeError(
            "fused_ln_mlp_cuda takes float32 or bfloat16 with every operand "
            f"in x's dtype, got x {x.dtype} and "
            f"{[str(t.dtype) for t in ops]}"
        )
    if tuple(w1.shape) != (hdim, d) or tuple(w2.shape) != (d, hdim) \
            or g.shape != (d,) or bt.shape != (d,) or b1.shape != (hdim,) \
            or b2.shape != (d,):
        raise ValueError(
            f"fused_ln_mlp_cuda: shapes x {tuple(x.shape)}, w1 "
            f"{tuple(w1.shape)}, w2 {tuple(w2.shape)} do not form an MLP "
            f"of width {d} -> {hdim}"
        )
    if d % 128 or d > 768 or hdim % 128:
        raise ValueError(
            f"fused_ln_mlp_cuda takes D % 128 == 0, D <= 768 and H % 128 == 0;"
            f" got D={d}, H={hdim}"
        )
    x2 = x.reshape(-1, d).contiguous()
    t = x2.shape[0]
    g, bt, w1, b1, w2, b2 = (v.contiguous() for v in ops)
    if w1.data_ptr() % 32 or w2.data_ptr() % 32:
        raise ValueError("fused_ln_mlp_cuda: the weights must be 32-byte "
                         "aligned (tensor-core fragment loads)")
    y = torch.empty_like(x2)
    fn = (_build.library().lafs_fused_ln_mlp_bf16 if x.dtype == torch.bfloat16
          else _build.library().lafs_fused_ln_mlp_f32)
    with torch.cuda.device(x.device):
        err = fn(x2.data_ptr(), g.data_ptr(), bt.data_ptr(), w1.data_ptr(),
                 b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
                 t, d, hdim, float(eps), _build.stream_ptr(x2))
    _build.check(err, "fused_ln_mlp kernel")
    _build.LAUNCHES["fused_ln_mlp"] += 1
    return y.reshape(x.shape)
