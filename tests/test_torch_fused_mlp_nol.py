"""PyTorch port: the fused MLP without the LayerNorm (ops/fused_mlp.py,
``mlp_impl='fused'``, kernels 4 and 5).

The port's plain forward and backward are held against the JAX Pallas
kernels in interpret mode (``_fused_mlp2d(..., interpret=True)`` and its
``jax.vjp``) on the same numpy inputs at T = 130 (a ragged 64-row fp32
tile), D = 128, H = 256, dropout rates 0 and 0.1 at one int seed, fp32:
the forward to 1e-5 and every VJP output to 1e-4 relative (max-norm); the
two sides differ in summation order and in the JAX kernel's A&S erf
(|err| ≤ 1.5e-7). The dropout masks are the same bits. The CUDA kernels
are held against these plain versions on the card
(test_torch_cuda_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lafs_cvpr2024_tpu.models.layers import FeedForward as JaxFeedForward
from lafs_cvpr2024_tpu.ops.fused_mlp import _fused_mlp2d, _fwd_call
from lafs_cvpr2024_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from lafs_cvpr2024_tpu_torch import _build
from lafs_cvpr2024_tpu_torch.models.layers import FeedForward
from lafs_cvpr2024_tpu_torch.ops.fused_mlp import (
    FusedMLP,
    dropout_bits,
    fused_mlp,
    fused_mlp_bwd_plain,
    fused_mlp_fwd_plain,
    keep_threshold,
)

SEED = 7654321


def _operands(seed, t, d=128, h=256):
    rng = np.random.default_rng(seed)
    return tuple(a.astype(np.float32) for a in (
        rng.standard_normal((t, d)), rng.standard_normal((d, h)) / np.sqrt(d),
        0.1 * rng.standard_normal(h), rng.standard_normal((h, d)) / np.sqrt(h),
        0.1 * rng.standard_normal(d)))


def _torch(ops):
    """The port's operands: the weights in the nn.Linear layout."""
    x, w1, b1, w2, b2 = (torch.from_numpy(np.ascontiguousarray(a))
                         for a in ops)
    return [x, w1.t().contiguous(), b1, w2.t().contiguous(), b2]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_matches_jax_kernel_forward_and_vjp(rate):
    """The forward (y, the saved u) within 1e-5, and the VJP — dx, dW1,
    db1, dW2, db2 from the plain backward's (do, hd, du) and the products
    :class:`FusedMLP` takes — within 1e-4 of the JAX kernels and their
    custom VJP; the hidden mask is the JAX draw 0 bit for bit."""
    t = 130
    ops = _operands(0, t)
    jops = tuple(map(jnp.asarray, ops))
    seed = jnp.asarray([SEED], jnp.int32)
    dy = np.random.default_rng(1).standard_normal((t, 128)).astype(np.float32)

    def f(x, w1, b1, w2, b2):
        return _fused_mlp2d(x, w1, b1, w2, b2, seed, rate, True)

    y_j, vjp = jax.vjp(f, *jops)
    grads_j = [np.asarray(a) for a in vjp(jnp.asarray(dy))]
    _, u_j = _fwd_call(*jops, seed, rate, save_u=True, interpret=True)
    x, w1, b1, w2, b2 = _torch(ops)
    y, u = fused_mlp_fwd_plain(x, w1, b1, w2, b2, rate=rate, seed=SEED,
                               save_u=True)
    assert y.shape == (t, 128) and u.shape == (t, 256)
    assert _rel(y.numpy(), y_j) <= 1e-5
    assert _rel(u.numpy(), np.asarray(u_j)[:t]) <= 1e-5
    do, hd, du = fused_mlp_bwd_plain(u, torch.from_numpy(dy), w2, rate=rate,
                                     seed=SEED)
    got = [(du @ w1).numpy(), (du.t() @ x).t().numpy(), du.sum(0).numpy(),
           (do.t() @ hd).t().numpy(), do.sum(0).numpy()]
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, grads_j):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= 1e-4, name
    keep = dropout_bits(t, 256, SEED, 0, 64).numpy() < keep_threshold(rate)
    assert np.array_equal(hd.numpy() != 0, keep if rate else np.ones_like(keep))
    if rate:
        assert 0.05 < 1 - keep.mean() < 0.15


def test_public_function_matches_jax_and_keeps_lead_dims():
    """``fused_mlp`` on (2, 65, D) rows against the JAX public function in
    interpret mode, rate 0; a CPU tensor launches no kernel."""
    ops = _operands(2, 130)
    want = np.asarray(jax_fused_mlp(*map(jnp.asarray, ops), interpret=True))
    tops = _torch(ops)
    before = dict(_build.LAUNCHES)
    got = fused_mlp(tops[0].reshape(2, 65, 128), *tops[1:])
    assert got.shape == (2, 65, 128)
    assert _rel(got.reshape(130, 128).numpy(), want) <= 1e-5
    assert dict(_build.LAUNCHES) == before


def test_autograd_function_equals_autograd_through_plain_forward():
    """FusedMLP (plain forward with u saved, plain backward, dx and the
    weight gradients as products) against torch autograd through the plain
    forward's differentiable ops, rate 0.1, fp32."""
    tops = _torch(_operands(3, 70))
    dy = torch.from_numpy(
        np.random.default_rng(4).standard_normal((70, 128)).astype(np.float32))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in tops]
        y = fn(*leaves)
        y.backward(dy)
        return [y.detach()] + [t.grad for t in leaves]

    got = grads(lambda *a: FusedMLP.apply(*a, 0.1, SEED))
    want = grads(lambda *a: fused_mlp_fwd_plain(*a, rate=0.1, seed=SEED)[0])
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel(a.numpy(), b.numpy()) <= 1e-5
    x = tops[0].clone().requires_grad_()
    y = fused_mlp(x, *tops[1:], rate=0.1, seed=SEED)
    fn = y.grad_fn.next_functions[0][0]  # behind the lead-dims reshape
    assert type(fn).__name__ == "FusedMLPBackward"


def test_plain_bf16_keeps_the_kernel_casts():
    """bf16: h is rounded to bf16 before the second product, u and y come
    out in bf16; the backward's do, hd and du too, with do rounded before
    do·W2."""
    ops = [a.to(torch.bfloat16) for a in _torch(_operands(5, 8))]
    x, w1, b1, w2, b2 = ops
    y, u = fused_mlp_fwd_plain(*ops, save_u=True)
    assert y.dtype == u.dtype == torch.bfloat16
    f = [o.float() for o in ops]
    pre = f[0] @ f[1].t() + f[2]
    assert torch.equal(u, pre.bfloat16())
    h = torch.nn.functional.gelu(pre).bfloat16().float()
    assert _rel(y.float(), (h @ f[3].t() + f[4]).bfloat16().float()) <= 1e-2
    dy = torch.randn(8, 128, generator=torch.Generator().manual_seed(0))
    do, hd, du = fused_mlp_bwd_plain(u, dy.bfloat16(), w2, rate=0.1,
                                     seed=SEED)
    assert [t.dtype for t in (do, hd, du)] == [torch.bfloat16] * 3
    # keep where kept, by the bf16 tile's (128-row) mask
    assert torch.equal(do != 0, (dropout_bits(8, 128, SEED, 1, 128)
                                 < keep_threshold(0.1)) & (dy != 0))


def test_feedforward_fused_matches_jax_layer():
    """The port's FeedForward with ``mlp_impl='fused'`` (LayerNorm applied
    by the caller) against the JAX layer in the same impl, eval mode, on
    the same weights; same parameter names as the dense path."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 128)).astype(np.float32)
    jmod = JaxFeedForward(128, 256, 0.0, "fused")
    v = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    port = FeedForward(128, 256, 0.0, mlp_impl="fused").eval()
    p = v["params"]
    sd = {"net.0.weight": p["fc1"]["kernel"].T, "net.0.bias": p["fc1"]["bias"],
          "net.3.weight": p["fc2"]["kernel"].T, "net.3.bias": p["fc2"]["bias"]}
    port.load_state_dict({k: torch.from_numpy(np.array(a))
                          for k, a in sd.items()}, strict=True)
    assert port.fused and not FeedForward(128, 200, mlp_impl="fused").fused
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= 1e-5
