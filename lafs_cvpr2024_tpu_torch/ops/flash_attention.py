"""Flash attention (counterpart of ``lafs_cvpr2024_tpu/models/layers.py::
_flash_attention``, which calls JAX's TPU flash attention,
``jax/experimental/pallas/ops/tpu/flash_attention.py``).

    O = softmax(scale · Q Kᵀ) V

on (B, H, N, D) operands of any length N ≥ 1, with the library's precision
chain: fp32 scores times ``scale``, an online fp32 softmax over key
blocks, p cast to V's dtype before the P·V product; the backward recomputes
p from the saved per-row logsumexp, forms ds = (dp − di)·p·scale in fp32
and casts p and ds to the operands' dtype before their products. Three
kernels carry it on the card, each beside its plain PyTorch version (the
CPU path and the kernels' oracle):

- kernel 11a, ``csrc/flash_attention.cu``, the forward (replaces the
  library's ``_flash_attention_kernel``);
- kernel 11b, ``csrc/flash_attention_bwd.cu``, dK and dV (replaces
  ``_flash_attention_dkv_kernel``);
- kernel 11c, same file, dQ (replaces ``_flash_attention_dq_kernel``).

:class:`FlashAttention` joins them into an autograd function that saves Q,
K, V, O and the fp32 logsumexp (the library saves O, l and m); its backward
computes ``di = rowsum(O ∘ dO)`` in plain PyTorch, as the library does in
XLA, and launches 11b and 11c. The JAX wrapper pads N to a multiple of 128
and masks the padded keys with segment ids, then slices the padded query
rows off; padded queries see only padded keys, so on the real rows the
kernels, which skip keys past N and touch no row past N, compute the same
function. Operands may be strided views of the ``to_qkv`` output (D
contiguous); the results come back as (B, H, N, D) views of (B, N, H, D)
tensors, as kernel 6's do.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .fused_attention import HEAD_DIM, _heads_view, _operand, _strides

_DTYPES = (torch.float32, torch.bfloat16)


def _scores(q, k, scale: float) -> torch.Tensor:
    """fp32 scores times ``scale``, as the library forms them."""
    f32 = torch.float32
    return torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * scale


def flash_attention_plain(q, k, v, scale: float):
    """Kernel 11a's arithmetic in plain PyTorch: fp32 scores, p = exp(s −
    m) cast to V's dtype, P·V accumulated in fp32 and divided by the fp32
    row sum l, cast to Q's dtype. Returns ``(o, lse)`` with the (B, H, N)
    fp32 ``lse = m + log l``. (The kernel's online softmax rounds p against
    each block's running max; the same values up to that rounding.)"""
    s = _scores(q, k, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float):
    """Kernels 11b and 11c in plain PyTorch: di = rowsum(O ∘ dO) and
    p = exp(s − lse) in fp32; dV = cast(p)ᵀ dO, dp = dO Vᵀ,
    ds = (dp − di)·p·scale, dQ = cast(ds) K, dK = cast(ds)ᵀ Q, each
    accumulated in fp32 and cast to Q's dtype. Returns ``(dq, dk, dv)``."""
    f32, dt = torch.float32, q.dtype
    dof = do.to(f32)
    di = (o.to(f32) * dof).sum(-1, keepdim=True)
    p = torch.exp(_scores(q, k, scale) - lse.unsqueeze(-1))
    dv = torch.matmul(p.to(do.dtype).to(f32).transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.to(f32).transpose(-1, -2))
    ds = ((dp - di) * p * scale).to(dt).to(f32)
    dq = torch.matmul(ds, k.to(f32))
    dk = torch.matmul(ds.transpose(-1, -2), q.to(f32))
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check(what: str, q: torch.Tensor, ops) -> None:
    if not q.is_cuda or any(t.device != q.device for t in ops):
        raise ValueError(f"{what}: every operand must be on q's CUDA device "
                         f"({q.device})")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ops):
        raise TypeError(f"{what} takes float32 or bfloat16 with every "
                        f"operand in q's dtype, got q {q.dtype} and "
                        f"{[str(t.dtype) for t in ops]}")
    if q.ndim != 4 or any(t.shape != q.shape for t in ops):
        raise ValueError(f"{what}: q {tuple(q.shape)} and the other operands "
                         f"{[tuple(t.shape) for t in ops]} must all be one "
                         "(B, H, N, D) shape")
    n, d = q.shape[2:]
    if d != HEAD_DIM or n < 1:
        raise ValueError(f"{what} takes D = {HEAD_DIM} and N >= 1; got D={d},"
                         f" N={n}")


def _stats(t: torch.Tensor, q: torch.Tensor, what: str) -> torch.Tensor:
    """A (B, H, N) fp32 row statistic as the kernels read it."""
    if t.shape != q.shape[:3] or t.dtype != torch.float32 or t.device != q.device:
        raise ValueError(f"{what}: expected fp32 {tuple(q.shape[:3])} on "
                         f"{q.device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.contiguous()


def _fn(lib, name: str, dtype):
    return getattr(lib, f"{name}_{'bf16' if dtype == torch.bfloat16 else 'f32'}")


def flash_attention_fwd_cuda(q, k, v, scale: float):
    """Launch kernel 11a on (B, H, N, D) CUDA operands in one dtype (D = 64,
    any N ≥ 1). Returns ``(o, lse)``: O as a (B, H, N, D) view of a
    (B, N, H, D) tensor, lse (B, H, N) fp32."""
    _check("flash_attention_fwd_cuda", q, (k, v))
    q, k, v = (_operand(t) for t in (q, k, v))
    b, h, n, d = q.shape
    o = _heads_view(q)
    lse = torch.empty((b, h, n), device=q.device, dtype=torch.float32)
    strides = _strides(q, k, v, o)
    fn = _fn(_build.library(), "lafs_flash_attention", q.dtype)
    with _build.device_guard(q):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), ctypes.addressof(strides), b, h, n, d,
                 float(scale), _build.stream_ptr(q))
    _build.check(err, "flash_attention kernel")
    _build.LAUNCHES["flash_attention"] += 1
    return o, lse


def flash_attention_bwd_dkv_cuda(q, k, v, do, lse, di, scale: float):
    """Launch kernel 11b: ``(dk, dv)`` from Q, K, V, dO and the fp32
    (B, H, N) ``lse`` and ``di``, as (B, H, N, D) views of (B, N, H, D)
    tensors."""
    _check("flash_attention_bwd_dkv_cuda", q, (k, v, do))
    lse = _stats(lse, q, "flash_attention_bwd_dkv_cuda lse")
    di = _stats(di, q, "flash_attention_bwd_dkv_cuda di")
    q, k, v, do = (_operand(t) for t in (q, k, v, do))
    b, h, n, d = q.shape
    dk, dv = _heads_view(q), _heads_view(q)
    strides = _strides(q, k, v, do, dk, dv)
    fn = _fn(_build.library(), "lafs_flash_attention_bwd_dkv", q.dtype)
    with _build.device_guard(q):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 ctypes.addressof(strides), b, h, n, d, float(scale),
                 _build.stream_ptr(q))
    _build.check(err, "flash_attention_bwd_dkv kernel")
    _build.LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd_dq_cuda(q, k, v, do, lse, di, scale: float):
    """Launch kernel 11c: dQ from the operands of
    :func:`flash_attention_bwd_dkv_cuda`, as a (B, H, N, D) view of a
    (B, N, H, D) tensor."""
    _check("flash_attention_bwd_dq_cuda", q, (k, v, do))
    lse = _stats(lse, q, "flash_attention_bwd_dq_cuda lse")
    di = _stats(di, q, "flash_attention_bwd_dq_cuda di")
    q, k, v, do = (_operand(t) for t in (q, k, v, do))
    b, h, n, d = q.shape
    dq = _heads_view(q)
    strides = _strides(q, k, v, do, dq)
    fn = _fn(_build.library(), "lafs_flash_attention_bwd_dq", q.dtype)
    with _build.device_guard(q):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                 ctypes.addressof(strides), b, h, n, d, float(scale),
                 _build.stream_ptr(q))
    _build.check(err, "flash_attention_bwd_dq kernel")
    _build.LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq


def flash_attention_bwd_cuda(q, k, v, o, lse, do, scale: float):
    """di = rowsum(O ∘ dO) in fp32 (plain PyTorch, as the library's XLA),
    then kernels 11b and 11c. Returns ``(dq, dk, dv)``."""
    di = (o.float() * do.float()).sum(-1)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, di, scale)
    dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, di, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Kernel 11a forward, kernels 11b and 11c backward for CUDA tensors;
    their plain versions for CPU tensors. Saves Q, K, V, O and lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        fwd = flash_attention_fwd_cuda if q.is_cuda else flash_attention_plain
        o, lse = fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd_cuda if q.is_cuda
               else flash_attention_bwd_plain)
        dq, dk, dv = bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(scale · Q Kᵀ) V on (B, H, N, D) tensors of any length N with
    the precision of JAX's TPU flash attention. A CUDA tensor launches the
    kernels (D = 64, or it raises); a CPU tensor runs their plain
    versions."""
    return FlashAttention.apply(q, k, v, float(scale))
