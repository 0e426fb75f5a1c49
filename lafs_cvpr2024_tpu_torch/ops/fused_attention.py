"""Fused short-sequence attention (counterpart of
``lafs_cvpr2024_tpu/ops/fused_attention.py::fused_attention``).

    O = cast(softmax(scale · Q Kᵀ), V dtype) V

on (B, H, S, D) operands, the softmax in fp32 over the S real keys. Two
kernels carry it on the card, each beside its plain PyTorch version (the
CPU path and the kernel's oracle):

- kernel 6, ``csrc/fused_attention.cu``, the forward (replaces the Pallas
  ``_fwd_kernel``);
- kernel 7, ``csrc/fused_attention_bwd.cu``, the backward (replaces
  ``_bwd_kernel``): A recomputed from Q and K, then dV, dA,
  dS = A ∘ (dA − rowsum(dA ∘ A)), dQ and dK, with dS cast to Q's dtype
  before its two products.

:class:`FusedAttention` joins them into an autograd function that saves
only Q, K and V, as the JAX VJP does. The operands may be strided views of
the ``to_qkv`` output split into heads (D contiguous): the kernels read
them in place, and the results come back as (B, H, S, D) views of
(B, S, H, D) tensors, so the heads merge back without a copy. The TPU
kernel pads S to a multiple of 128 and masks the padded keys with −1e30;
the CUDA kernels mask keys at or past S themselves and store no padded
rows. In bf16 both kernels are Hopper designs (TMA, ``wgmma``, the exact
fp32 row softmax in registers); fp32 keeps the first FMA design, the
precision check.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

HEAD_DIM = 64     # the head width the kernels take
MAX_SEQ = 512     # the longest sequence they take (the JAX kernel's window)


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """fp32 attention probabilities as the JAX kernel forms them
    (``_bsoftmax``): fp32 logits · scale, max-shifted exp over the row,
    divided by its sum."""
    f32 = torch.float32
    logits = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * scale
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def fused_attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """Kernel 6's arithmetic in plain PyTorch (``_fwd_kernel``): A in fp32,
    cast to V's dtype before A·V, the product accumulated in fp32 and cast
    to Q's dtype."""
    a = _probs(q, k, scale).to(v.dtype)
    return torch.matmul(a.float(), v.float()).to(q.dtype)


def fused_attention_bwd_plain(q, k, v, do, scale: float):
    """Kernel 7's arithmetic in plain PyTorch (``_bwd_kernel``): A
    recomputed in fp32; dV = cast(A)ᵀ dO, dA = dO Vᵀ,
    dS = A ∘ (dA − rowsum(dA ∘ A)) from the fp32 A, dS cast to Q's dtype,
    dQ = scale · dS K and dK = scale · dSᵀ Q, each accumulated in fp32 and
    cast to Q's dtype. Returns ``(dq, dk, dv)``."""
    f32, dt = torch.float32, q.dtype
    a = _probs(q, k, scale)
    dof = do.to(f32)
    dv = torch.matmul(a.to(v.dtype).to(f32).transpose(-1, -2), dof)
    da = torch.matmul(dof, v.to(f32).transpose(-1, -2))
    ds = (a * (da - (da * a).sum(-1, keepdim=True))).to(dt).to(f32)
    dq = torch.matmul(ds, k.to(f32)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.to(f32)) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: D contiguous, every other stride a
    multiple of 16 bytes, 16-byte aligned; a contiguous copy otherwise."""
    vec = 16 // t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s % vec == 0 for s in t.stride()[:-1]))
    return t if ok else t.contiguous()


def _heads_view(like: torch.Tensor) -> torch.Tensor:
    """An uninitialised (B, H, S, D) result stored as (B, S, H, D)."""
    b, h, s, d = like.shape
    return torch.empty_strided((b, h, s, d), (s * h * d, d, h * d, 1),
                               dtype=like.dtype, device=like.device)


def _strides(*ts) -> ctypes.Array:
    """The (b, h, s) element strides of each tensor, as the C entry
    points take them."""
    flat = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _check(what: str, q: torch.Tensor, ops) -> None:
    _build.check_operands(what, q, *ops)
    if q.ndim != 4 or any(t.shape != q.shape for t in ops):
        raise ValueError(f"{what}: q {tuple(q.shape)} and the other operands "
                         f"{[tuple(t.shape) for t in ops]} must all be one "
                         "(B, H, S, D) shape")
    s, d = q.shape[2:]
    if d != HEAD_DIM or not 1 <= s <= MAX_SEQ:
        raise ValueError(f"{what} takes D = {HEAD_DIM} and 1 <= S <= "
                         f"{MAX_SEQ}; got D={d}, S={s}")


def fused_attention_cuda(q, k, v, scale: float) -> torch.Tensor:
    """Launch kernel 6 on (B, H, S, D) CUDA operands in one dtype (D = 64,
    S ≤ 512). Returns O as a (B, H, S, D) view of a (B, S, H, D) tensor."""
    _check("fused_attention_cuda", q, (k, v))
    q, k, v = (_operand(t) for t in (q, k, v))
    b, h, s, d = q.shape
    o = _heads_view(q)
    strides = _strides(q, k, v, o)
    _build.launch("fused_attention", q, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), ctypes.addressof(strides), b, h,
                  s, d, float(scale))
    return o


def fused_attention_bwd_cuda(q, k, v, do, scale: float):
    """Launch kernel 7 (its dq pass, then its dk/dv pass) on CUDA operands
    as :func:`fused_attention_cuda` takes them. Returns ``(dq, dk, dv)`` as
    (B, H, S, D) views of (B, S, H, D) tensors."""
    _check("fused_attention_bwd_cuda", q, (k, v, do))
    q, k, v, do = (_operand(t) for t in (q, k, v, do))
    b, h, s, d = q.shape
    dq, dk, dv = (_heads_view(q) for _ in range(3))
    # each query row's max, 1/sum (or sum) and rowsum(dA ∘ A) between the
    # two passes: (B·H, tiles, 3, 64) for bf16, (3, B·H, S) for fp32
    stats = torch.empty(b * h * 3 * 64 * -(-s // 64), device=q.device,
                        dtype=torch.float32)
    strides = _strides(q, k, v, do, dq, dk, dv)
    _build.launch("fused_attention_bwd", q, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), stats.data_ptr(), ctypes.addressof(strides),
                  b, h, s, d, float(scale))
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """Kernel 6 forward, kernel 7 backward for CUDA tensors; their plain
    versions for CPU tensors. Saves Q, K and V only (``_attn3_fwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if q.is_cuda:
            return fused_attention_cuda(q, k, v, scale)
        return fused_attention_plain(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if q.is_cuda:
            dq, dk, dv = fused_attention_bwd_cuda(q, k, v, do, ctx.scale)
        else:
            dq, dk, dv = fused_attention_bwd_plain(q, k, v, do, ctx.scale)
        return dq, dk, dv, None


def fused_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(scale · Q Kᵀ) V on (B, H, S, D) tensors with the fp32
    softmax of the JAX kernel. A CUDA tensor launches the kernels (D = 64,
    S ≤ 512, or it raises); a CPU tensor runs their plain versions."""
    return FusedAttention.apply(q, k, v, float(scale))
