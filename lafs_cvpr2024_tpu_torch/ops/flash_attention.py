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
- kernel 11c, ``csrc/flash_attention_bwd.cu``, dQ (replaces the
  library's ``_flash_attention_dq_kernel``); it also forms
  ``di = rowsum(O ∘ dO)`` and writes each 64-row query tile's statistics,
  lse·log2 e and di, to a (B·H, ⌈N/64⌉, 2, 64) fp32 scratch;
- kernel 11b, same file, dK and dV from that scratch (replaces
  ``_flash_attention_dkv_kernel``).

:class:`FlashAttention` joins them into an autograd function that saves Q,
K, V, O and the fp32 logsumexp (the library saves O, l and m); its backward
on the card launches 11c, then 11b, and nothing else (the library forms
di in XLA). The JAX wrapper pads N to a multiple of 128 and masks the
padded keys with segment ids, then slices the padded query rows off;
padded queries see only padded keys, so on the real rows the kernels,
which skip keys past N and touch no row past N, compute the same
function. Operands may be strided views of the ``to_qkv`` output (D
contiguous); the results come back as (B, H, N, D) views of (B, N, H, D)
tensors, as kernel 6's do.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from .fused_attention import HEAD_DIM, _heads_view, _operand, _strides

LOG2E = 1.4426950408889634  # the kernels' exponentials are base 2
STATS_ROWS = 64             # query rows of one tile of the scratch


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
    """Kernels 11b and 11c in plain PyTorch, the library's arithmetic:
    di = rowsum(O ∘ dO) and p = exp(s − lse) in fp32; dV = cast(p)ᵀ dO,
    dp = dO Vᵀ, ds = (dp − di)·p·scale, dQ = cast(ds) K, dK = cast(ds)ᵀ Q,
    each accumulated in fp32 and cast to Q's dtype. Returns
    ``(dq, dk, dv)``; it equals the composition of
    :func:`flash_attention_bwd_dq_plain` and
    :func:`flash_attention_bwd_dkv_plain` up to fp32 rounding."""
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


def _probs2(q, k, lse2, scale: float) -> torch.Tensor:
    """p = 2^(s·c − lse·log2 e) in fp32 with c = scale·log2 e, as the
    kernels form it from the statistics scratch."""
    f32 = torch.float32
    s = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2))
    return torch.exp2(s * (scale * LOG2E) - lse2.unsqueeze(-1))


def flash_attention_bwd_dq_plain(q, k, v, o, do, lse, scale: float):
    """Kernel 11c in plain PyTorch: di = rowsum(O ∘ dO) and lse·log2 e,
    p = 2^(s·c − lse·log2 e), ds = (dp − di)·p·scale cast to Q's dtype,
    dQ = cast(ds) K accumulated in fp32. Returns ``(dq, stats)`` with
    ``stats`` the (B·H, ⌈N/64⌉, 2, 64) fp32 scratch that kernel 11b reads:
    per 64-row query tile its rows' lse·log2 e, then their di; rows past N
    hold +inf and 0, which make p exactly 0."""
    f32, dt = torch.float32, q.dtype
    b, h, n, _ = q.shape
    dof = do.to(f32)
    di = (o.to(f32) * dof).sum(-1)
    lse2 = lse * LOG2E
    p = _probs2(q, k, lse2, scale)
    dp = torch.matmul(dof, v.to(f32).transpose(-1, -2))
    ds = ((dp - di.unsqueeze(-1)) * p * scale).to(dt).to(f32)
    dq = torch.matmul(ds, k.to(f32)).to(dt)
    pad = stats_tiles(n) * STATS_ROWS - n
    rows = [F.pad(t.reshape(b * h, n), (0, pad), value=fill)
            .reshape(b * h, -1, STATS_ROWS)
            for t, fill in ((lse2, float("inf")), (di, 0.0))]
    return dq, torch.stack(rows, dim=2)


def flash_attention_bwd_dkv_plain(q, k, v, do, stats, scale: float):
    """Kernel 11b in plain PyTorch from kernel 11c's scratch: p =
    2^(s·c − lse·log2 e), dV = cast(p)ᵀ dO, ds = (dp − di)·p·scale cast to
    Q's dtype, dK = cast(ds)ᵀ Q, each accumulated in fp32. Returns
    ``(dk, dv)``."""
    f32, dt = torch.float32, q.dtype
    b, h, n, _ = q.shape
    lse2, di = (stats[:, :, i].reshape(b, h, -1)[..., :n] for i in (0, 1))
    dof = do.to(f32)
    p = _probs2(q, k, lse2, scale)
    dv = torch.matmul(p.to(dt).to(f32).transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.to(f32).transpose(-1, -2))
    ds = ((dp - di.unsqueeze(-1)) * p * scale).to(dt).to(f32)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(f32))
    return dk.to(dt), dv.to(dt)


def stats_tiles(n: int) -> int:
    """Query tiles of the statistics scratch for sequences of length n."""
    return -(-n // STATS_ROWS)


def _check(what: str, q: torch.Tensor, ops) -> None:
    _build.check_operands(what, q, *ops)
    if q.ndim != 4 or any(t.shape != q.shape for t in ops):
        raise ValueError(f"{what}: q {tuple(q.shape)} and the other operands "
                         f"{[tuple(t.shape) for t in ops]} must all be one "
                         "(B, H, N, D) shape")
    n, d = q.shape[2:]
    if d != HEAD_DIM or n < 1:
        raise ValueError(f"{what} takes D = {HEAD_DIM} and N >= 1; got D={d},"
                         f" N={n}")


def _check_f32(what: str, t: torch.Tensor, shape, q: torch.Tensor) -> None:
    """An fp32 side input (lse, the scratch) of the given shape on q's
    device."""
    if (t.shape != shape or t.dtype != torch.float32
            or t.device != q.device):
        raise ValueError(f"{what}: expected fp32 {tuple(shape)} on "
                         f"{q.device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


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
    _build.launch("flash_attention", q, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  ctypes.addressof(strides), b, h, n, d, float(scale))
    return o, lse


def _launch_dq(q, k, v, o, do, lse, scale: float):
    """Kernel 11c on checked operands (``_operand`` form)."""
    b, h, n, d = q.shape
    dq = _heads_view(q)
    stats = torch.empty((b * h, stats_tiles(n), 2, STATS_ROWS),
                        device=q.device, dtype=torch.float32)
    strides = _strides(q, k, v, o, do, dq, lse)
    _build.launch("flash_attention_bwd_dq", q, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  dq.data_ptr(), stats.data_ptr(), ctypes.addressof(strides),
                  b, h, n, d, float(scale))
    return dq, stats


def _launch_dkv(q, k, v, do, stats, scale: float):
    """Kernel 11b on checked operands (``_operand`` form)."""
    b, h, n, d = q.shape
    dk, dv = _heads_view(q), _heads_view(q)
    strides = _strides(q, k, v, do, dk, dv)
    _build.launch("flash_attention_bwd_dkv", q, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), do.data_ptr(), stats.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), ctypes.addressof(strides), b,
                  h, n, d, float(scale))
    return dk, dv


def flash_attention_bwd_dq_cuda(q, k, v, o, do, lse, scale: float):
    """Launch kernel 11c: ``(dq, stats)`` from Q, K, V, O, dO and the fp32
    (B, H, N) ``lse`` (any strides): dQ as a (B, H, N, D) view of a
    (B, N, H, D) tensor and the statistics scratch of
    :func:`flash_attention_bwd_dq_plain`, which 11b reads."""
    _check("flash_attention_bwd_dq_cuda", q, (k, v, o, do))
    _check_f32("flash_attention_bwd_dq_cuda lse", lse, q.shape[:3], q)
    q, k, v, o, do = (_operand(t) for t in (q, k, v, o, do))
    return _launch_dq(q, k, v, o, do, lse, scale)


def flash_attention_bwd_dkv_cuda(q, k, v, do, stats, scale: float):
    """Launch kernel 11b: ``(dk, dv)`` from Q, K, V, dO and kernel 11c's
    ``stats``, as (B, H, N, D) views of (B, N, H, D) tensors."""
    _check("flash_attention_bwd_dkv_cuda", q, (k, v, do))
    b, h, n, _ = q.shape
    _check_f32("flash_attention_bwd_dkv_cuda stats", stats,
               (b * h, stats_tiles(n), 2, STATS_ROWS), q)
    if not stats.is_contiguous():
        raise ValueError("flash_attention_bwd_dkv_cuda: stats must be "
                         "contiguous")
    q, k, v, do = (_operand(t) for t in (q, k, v, do))
    return _launch_dkv(q, k, v, do, stats, scale)


def flash_attention_bwd_cuda(q, k, v, o, lse, do, scale: float):
    """Kernel 11c (dQ, di and the statistics scratch), then kernel 11b
    (dK, dV), on the current stream and nothing else on the card. Returns
    ``(dq, dk, dv)``."""
    _check("flash_attention_bwd_cuda", q, (k, v, o, do))
    _check_f32("flash_attention_bwd_cuda lse", lse, q.shape[:3], q)
    q, k, v, o, do = (_operand(t) for t in (q, k, v, o, do))
    dq, stats = _launch_dq(q, k, v, o, do, lse, scale)
    dk, dv = _launch_dkv(q, k, v, do, stats, scale)
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
