"""The bias-free fused transformer MLP of the TPU microbenchmark (row 10;
counterpart of ``benchmarks/bench_mlp_fusion.py::pallas_mlp``, its kernel
``_mlp_kernel`` and ``_gelu_exact``):

    h = drop₀(gelu(x @ w1))      fp32 accumulate, dropout in fp32
    y = drop₁(bf16(h) @ w2)      fp32 accumulate, dropout in fp32, bf16 out

for bf16 x (T, 768) and the JAX layout of the weights, input by output:
``w1`` is (768, 2048) and ``w2`` (2048, 768). No biases, no saved
pre-activation, no LayerNorm and no backward.

- :func:`mlp_fusion_cuda` launches the hand-written kernel
  ``csrc/mlp_fusion.cu`` (any T: rows past T are zero-filled and not
  stored, where the TPU kernel pads T to its 256-row tile);
- :func:`mlp_fusion_plain` is the same function in PyTorch ops, the CPU
  path and the kernel's oracle;
- :func:`mlp_fusion_dense` is the counterpart of ``xla_mlp`` at rate 0
  (``torch.matmul``, exact ``F.gelu``, ``torch.matmul``): the library
  yardstick of the row, which nothing else in the port calls.

Dropout. No GPU reproduces the TPU's hardware PRNG; the kernel and the
plain version draw the same bits from the port's counter hash
(``ops.fused_mlp.dropout_bits``), keyed by the seed, the TPU kernel's
256-row token tile, the draw (0 for h, 1 for y), the row in the tile and
the column, with the TPU kernel's 32-bit threshold ``round(keep·2³²)``.
Both draws scale by the fp32 ``1/keep`` before the bf16 casts.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .fused_mlp import _drop_args, dropout_bits, inv_keep, keep_threshold

#: the TPU kernel's token tile (``bench_mlp_fusion.py:38``): the row tile
#: that keys the dropout hash
TILE = 256
#: the model width the kernel takes (the TPU kernel's, ``:37``) and the
#: hidden chunk it walks: H must be a multiple of it
WIDTH = 768
HIDDEN_CHUNK = 256


def mlp_fusion_weights_from_jax(w1, w2, device="cuda"):
    """The JAX microbenchmark's weights (numpy, any float dtype: bfloat16
    arrays from ``np.asarray`` of a JAX array included) as the contiguous
    bf16 tensors the kernel reads, in the same (input, output) layout:
    ``(w1 (D, H), w2 (H, D))`` on ``device``."""
    return tuple(torch.from_numpy(np.asarray(w, np.float32))
                 .to(device, torch.bfloat16).contiguous() for w in (w1, w2))


def _mask(rows: int, cols: int, seed: int, rate: float, draw: int, device):
    return dropout_bits(rows, cols, seed, draw, TILE, device) \
        < keep_threshold(rate)


def mlp_fusion_plain(x, w1, w2, *, rate: float = 0.0, seed: int = 0):
    """The kernel's arithmetic in PyTorch ops on x (T, D): both products
    accumulated in fp32, exact GELU, dropout on h and on y in fp32, h cast
    to x's dtype before the second product, the output in x's dtype."""
    dt, f32 = x.dtype, torch.float32
    t = x.shape[0]
    h = F.gelu(torch.matmul(x.to(f32), w1.to(f32)))
    if rate > 0.0:
        h = torch.where(_mask(t, h.shape[1], seed, rate, 0, x.device),
                        h * inv_keep(rate), 0.0)
    y = torch.matmul(h.to(dt).to(f32), w2.to(f32))
    if rate > 0.0:
        y = torch.where(_mask(t, y.shape[1], seed, rate, 1, x.device),
                        y * inv_keep(rate), 0.0)
    return y.to(dt)


def mlp_fusion_cuda(x, w1, w2, *, rate: float = 0.0, seed: int = 0):
    """Launch the row-10 kernel on bf16 x (T, D) on its CUDA device, with
    w1 (D, H) and w2 (H, D) there in bf16 (D = 768, H a multiple of 256:
    the TPU kernel takes only D = 768, H = 2048)."""
    _build.check_operands("mlp_fusion_cuda", x, w1, w2)
    if x.dtype != torch.bfloat16:
        raise TypeError("mlp_fusion_cuda takes bfloat16 x, w1 and w2, got "
                        f"{x.dtype}, {w1.dtype}, {w2.dtype}")
    d, hdim = x.shape[-1], w1.shape[-1]
    if x.ndim != 2 or tuple(w1.shape) != (d, hdim) \
            or tuple(w2.shape) != (hdim, d):
        raise ValueError(
            f"mlp_fusion_cuda: shapes x {tuple(x.shape)}, w1 "
            f"{tuple(w1.shape)}, w2 {tuple(w2.shape)} do not form an MLP "
            f"of width {d} -> {hdim} on (T, D) rows (w1 is (D, H))")
    if d != WIDTH or hdim < HIDDEN_CHUNK or hdim % HIDDEN_CHUNK:
        raise ValueError(f"mlp_fusion_cuda takes D = {WIDTH} and H a "
                         f"multiple of {HIDDEN_CHUNK}; got D={d}, H={hdim}")
    x, w1, w2 = x.contiguous(), w1.contiguous(), w2.contiguous()
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("mlp_fusion_cuda: x, w1 and w2 must be 16-byte "
                         "aligned (TMA loads)")
    y = torch.empty_like(x)
    _build.launch("mlp_fusion", x, x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                  y.data_ptr(), x.shape[0], d, hdim, *_drop_args(rate, seed))
    return y


def mlp_fusion(x, w1, w2, rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """x (T, D) → (T, D), dropout at ``rate`` with the int ``seed``. A CUDA
    tensor launches the kernel; a CPU tensor runs the plain version."""
    if x.is_cuda:
        return mlp_fusion_cuda(x, w1, w2, rate=rate, seed=seed)
    return mlp_fusion_plain(x, w1, w2, rate=rate, seed=seed)


def mlp_fusion_dense(x, w1, w2) -> torch.Tensor:
    """``xla_mlp`` at rate 0 as three PyTorch calls in x's dtype: the
    library yardstick of the kernel (cuBLAS on the card)."""
    return torch.matmul(F.gelu(torch.matmul(x, w1)), w2)
