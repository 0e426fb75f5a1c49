"""PyTorch port: the LN-fused MLP (ops/fused_mlp.py + kernel 2).

The port's plain ``fused_ln_mlp`` is held against the JAX Pallas kernel
(``fused_ln_mlp(interpret=True)``) and the JAX dense block (LayerNorm →
Dense → exact GELU → Dense) on the same numpy inputs, at a ragged token
count, to ≤ 1e-4 relative (max-norm) in fp32. The CUDA kernel is held
against this plain version on the card (test_torch_cuda_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from lafs_cvpr2024_tpu.ops.fused_mlp import fused_ln_mlp as jax_fused_ln_mlp
from lafs_cvpr2024_tpu_torch import _build
from lafs_cvpr2024_tpu_torch.ops.fused_mlp import (
    fused_ln_mlp,
    fused_ln_mlp_plain,
)


def _operands(seed, t, d, h):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (
        rng.standard_normal((t, d)).astype(f) * 2.0 + 0.5,
        1.0 + 0.1 * rng.standard_normal(d).astype(f),
        0.1 * rng.standard_normal(d).astype(f),
        rng.standard_normal((d, h)).astype(f) / np.sqrt(d),
        0.1 * rng.standard_normal(h).astype(f),
        rng.standard_normal((h, d)).astype(f) / np.sqrt(h),
        0.1 * rng.standard_normal(d).astype(f),
    )


def _torch(ops):
    """The port's operands: the weights in the nn.Linear layout."""
    x, g, bt, w1, b1, w2, b2 = (torch.from_numpy(np.ascontiguousarray(a))
                                for a in ops)
    return [x, g, bt, w1.t().contiguous(), b1, w2.t().contiguous(), b2]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_dense(x, g, bt, w1, b1, w2, b2):
    xn = fnn.LayerNorm(epsilon=1e-5).apply(
        {"params": {"scale": g, "bias": bt}}, x)
    u = jnp.dot(xn, w1) + b1
    return jnp.dot(fnn.gelu(u, approximate=False), w2) + b2


def test_plain_matches_jax_kernel_and_dense_block():
    ops = _operands(0, 37, 128, 256)  # 37 tokens: a ragged TPU tile
    got = fused_ln_mlp_plain(*_torch(ops)).numpy()
    jops = tuple(map(jnp.asarray, ops))
    pallas = np.asarray(jax_fused_ln_mlp(*jops, interpret=True))
    dense = np.asarray(_jax_dense(*jops))
    assert got.shape == (37, 128)
    assert _rel(got, pallas) <= 1e-4
    assert _rel(got, dense) <= 1e-4


def test_cpu_tensor_runs_the_plain_version_and_keeps_lead_dims():
    ops = _torch(_operands(1, 2 * 5, 128, 256))
    ops[0] = ops[0].reshape(2, 5, 128)
    before = _build.LAUNCHES["fused_ln_mlp"]
    got = fused_ln_mlp(*ops)
    assert got.shape == (2, 5, 128)
    assert torch.equal(got, fused_ln_mlp_plain(*ops))
    assert _build.LAUNCHES["fused_ln_mlp"] == before


def test_dropout_raises_instead_of_being_dropped():
    ops = _torch(_operands(2, 4, 128, 256))
    with pytest.raises(NotImplementedError, match="dropout"):
        fused_ln_mlp(*ops, rate=0.1)


def test_plain_bf16_keeps_the_kernel_casts():
    """xn and h are rounded to the input dtype before each product, the
    products accumulate in fp32 (the JAX kernel's casts)."""
    ops = [a.to(torch.bfloat16) for a in _torch(_operands(3, 8, 128, 256))]
    got = fused_ln_mlp_plain(*ops)
    assert got.dtype == torch.bfloat16
    f = [o.float() for o in ops]
    xn = torch.nn.functional.layer_norm(f[0], (128,), f[1], f[2], 1e-5)
    h = torch.nn.functional.gelu(xn.bfloat16().float() @ f[3].t() + f[4])
    want = (h.bfloat16().float() @ f[5].t() + f[6]).bfloat16()
    assert _rel(got.float(), want.float()) <= 1e-2
