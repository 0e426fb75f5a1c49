"""PyTorch port: the LN-fused MLP (ops/fused_mlp.py, kernels 2 and 3).

The port's plain forward and backward are held against the JAX Pallas
kernels (``_fused_ln_mlp2d(..., interpret=True)`` and its ``jax.vjp``) and
the JAX dense block (LayerNorm → Dense → exact GELU → Dense) on the same
numpy inputs, at ragged token counts, to ≤ 1e-4 relative (max-norm) in
fp32: the two sides differ only in summation order and in the JAX
kernel's A&S erf (|err| ≤ 1.5e-7). The dropout masks are the same bits.
The CUDA kernels are held against these plain versions on the card
(test_torch_cuda_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from lafs_cvpr2024_tpu.ops.fused_mlp import _bits as jax_bits
from lafs_cvpr2024_tpu.ops.fused_mlp import _fused_ln_mlp2d, _ln_fwd_call
from lafs_cvpr2024_tpu.ops.fused_mlp import fused_ln_mlp as jax_fused_ln_mlp
from lafs_cvpr2024_tpu_torch import _build
from lafs_cvpr2024_tpu_torch.ops.fused_mlp import (
    FusedLNMLP,
    dropout_bits,
    fused_ln_mlp,
    fused_ln_mlp_bwd_plain,
    fused_ln_mlp_fwd_plain,
)

SEED = 1234567


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
    got, u = fused_ln_mlp_fwd_plain(*_torch(ops))
    jops = tuple(map(jnp.asarray, ops))
    pallas = np.asarray(jax_fused_ln_mlp(*jops, interpret=True))
    dense = np.asarray(_jax_dense(*jops))
    assert got.shape == (37, 128) and u is None
    assert _rel(got.numpy(), pallas) <= 1e-4
    assert _rel(got.numpy(), dense) <= 1e-4


def test_cpu_tensor_runs_the_plain_version_and_keeps_lead_dims():
    ops = _torch(_operands(1, 2 * 5, 128, 256))
    before = dict(_build.LAUNCHES)
    want, _ = fused_ln_mlp_fwd_plain(*ops, rate=0.1, seed=SEED)
    ops[0] = ops[0].reshape(2, 5, 128)
    got = fused_ln_mlp(*ops, rate=0.1, seed=SEED)
    assert got.shape == (2, 5, 128)
    assert torch.equal(got.reshape(10, 128), want)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("dtype,tile", [(torch.float32, 64),
                                        (torch.bfloat16, 128)])
def test_dropout_bits_equal_the_jax_kernel_hash(dtype, tile):
    """The mask bits of both draws, row tile by row tile, at the JAX
    kernel's tile for the dtype: bit-identical to its interpret-mode
    ``_bits``, across three tiles of rows."""
    rows, cols = 3 * tile, 256
    for draw in (0, 1):
        got = dropout_bits(rows, cols, SEED, draw, tile).numpy()
        want = np.concatenate([
            np.asarray(jax_bits((tile, cols), jnp.int32(SEED), jnp.int32(i),
                                draw, True)) for i in range(3)])
        assert np.array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("t", [37, 130])  # 130 crosses a 64-row fp32 tile
def test_dropout_parity_with_jax_forward_and_vjp(t):
    """Rate 0.1, fp32: the port's plain forward and backward against the
    JAX kernels' forward and VJP at the same int seed, ≤ 1e-4 relative for
    y and every gradient; u equals JAX's saved pre-activation."""
    rate, eps = 0.1, 1e-5
    ops = _operands(2, t, 128, 256)
    jops = tuple(map(jnp.asarray, ops))
    seed = jnp.asarray([SEED], jnp.int32)
    dy = np.random.default_rng(3).standard_normal((t, 128)).astype(np.float32)

    def f(x, g, bt, w1, b1, w2, b2):
        return _fused_ln_mlp2d(x, g, bt, w1, b1, w2, b2, seed, rate, eps, True)

    y_j, vjp = jax.vjp(f, *jops)
    grads_j = [np.asarray(a) for a in vjp(jnp.asarray(dy))]
    tops = _torch(ops)
    y, u = fused_ln_mlp_fwd_plain(*tops, eps=eps, rate=rate, seed=SEED,
                                  save_u=True)
    assert _rel(y.numpy(), y_j) <= 1e-4
    _, u_j = _ln_fwd_call(*jops, seed, rate, eps, save_u=True,
                          interpret=True)
    assert _rel(u.numpy(), np.asarray(u_j)[:t]) <= 1e-4
    x, g, bt, w1, b1, w2, b2 = tops
    do, hd, du, xn, dx, dg, dbt = fused_ln_mlp_bwd_plain(
        x, u, torch.from_numpy(dy), g, bt, w1, w2, eps=eps, rate=rate,
        seed=SEED)
    got = [dx.numpy(), dg.numpy(), dbt.numpy(),
           (du.t() @ xn).t().numpy(), du.sum(0).numpy(),
           (do.t() @ hd).t().numpy(), do.sum(0).numpy()]
    names = ["dx", "dg", "dbt", "dw1", "db1", "dw2", "db2"]
    for name, a, b in zip(names, got, grads_j):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= 1e-4, name
    # the hidden mask drops ~10% of hd, exactly where JAX's draw 0 does
    keep = dropout_bits(t, 256, SEED, 0, 64).numpy() < round(0.9 * 2 ** 32)
    assert np.array_equal(hd.numpy() != 0, keep)
    assert 0.05 < 1 - keep.mean() < 0.15


def test_autograd_function_equals_autograd_through_plain_forward():
    """FusedLNMLP (plain forward with u saved, plain backward, weight
    gradients as products) against torch autograd through the plain
    forward's differentiable ops, rate 0.1, fp32."""
    tops = _torch(_operands(4, 70, 128, 256))
    dy = torch.from_numpy(
        np.random.default_rng(5).standard_normal((70, 128)).astype(np.float32))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in tops]
        y = fn(*leaves)
        y.backward(dy)
        return [y.detach()] + [t.grad for t in leaves]

    got = grads(lambda *a: FusedLNMLP.apply(*a, 1e-5, 0.1, SEED))
    want = grads(lambda *a: fused_ln_mlp_fwd_plain(*a, rate=0.1,
                                                   seed=SEED)[0])
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel(a.numpy(), b.numpy()) <= 1e-5
    # fused_ln_mlp takes the autograd path when an operand needs a gradient
    x = tops[0].clone().requires_grad_()
    y = fused_ln_mlp(x, *tops[1:], rate=0.1, seed=SEED)
    fn = y.grad_fn.next_functions[0][0]  # behind the lead-dims reshape
    assert type(fn).__name__ == "FusedLNMLPBackward"


def test_plain_bf16_keeps_the_kernel_casts():
    """xn and h are rounded to the input dtype before each product, the
    products accumulate in fp32 (the JAX kernel's casts)."""
    ops = [a.to(torch.bfloat16) for a in _torch(_operands(3, 8, 128, 256))]
    got, u = fused_ln_mlp_fwd_plain(*ops, save_u=True)
    assert got.dtype == u.dtype == torch.bfloat16
    f = [o.float() for o in ops]
    xn = torch.nn.functional.layer_norm(f[0], (128,), f[1], f[2], 1e-5)
    pre = xn.bfloat16().float() @ f[3].t() + f[4]
    h = torch.nn.functional.gelu(pre)
    want = (h.bfloat16().float() @ f[5].t() + f[6]).bfloat16()
    assert _rel(got.float(), want.float()) <= 1e-2
    assert torch.equal(u, pre.bfloat16())


def test_plain_bwd_bf16_keeps_the_kernel_casts():
    """Backward in bf16: do, hd, du, xn and dx come out in bf16, du is
    rounded before du·W1, dγ/dβ stay fp32 sums."""
    ops = [a.to(torch.bfloat16) for a in _torch(_operands(6, 40, 128, 256))]
    x, g, bt, w1, b1, w2, b2 = ops
    _, u = fused_ln_mlp_fwd_plain(*ops, save_u=True)
    dy = torch.randn(40, 128, generator=torch.Generator().manual_seed(0))
    outs = fused_ln_mlp_bwd_plain(x, u, dy.bfloat16(), g, bt, w1, w2,
                                  rate=0.1, seed=SEED)
    assert [o.dtype for o in outs] == [torch.bfloat16] * 5 + [torch.float32] * 2
    ref = fused_ln_mlp_bwd_plain(x.float(), u.float(), dy.bfloat16().float(),
                                 g.float(), bt.float(), w1.float(),
                                 w2.float(), rate=0.1, seed=SEED)
    # the fp32 run keys its masks by the fp32 tile (64 rows): compare only
    # the first 40 rows, which lie in tile 0 for both dtypes
    for a, b in zip(outs, ref):
        assert _rel(a.float().numpy(), b.numpy()) <= 5e-2
