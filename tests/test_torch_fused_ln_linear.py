"""PyTorch port: the LN-fused linear projection (ops/fused_ln_linear.py,
``attn_impl='lnqkv'``, kernels 8 and 9).

The port's plain forward and backward are held against the JAX Pallas
kernels in interpret mode (``fused_ln_linear(..., interpret=True)`` and its
``jax.vjp``) on the same numpy inputs at T = 130 (ragged against the JAX
kernel's 64-row fp32 tile), D = 128 and output widths O = 384 and 192 (the
JAX kernel pads 192 to 256), fp32: the forward to 1e-5 and every VJP
output to 1e-4 relative (max-norm), summation order only. The CUDA kernels
are held against these plain versions on the card
(test_torch_cuda_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lafs_cvpr2024_tpu.models.layers import TransformerBlock as JaxBlock
from lafs_cvpr2024_tpu.ops.fused_ln_linear import (
    fused_ln_linear as jax_fused_ln_linear,
)
from lafs_cvpr2024_tpu_torch import _build
from lafs_cvpr2024_tpu_torch.models.layers import Transformer
from lafs_cvpr2024_tpu_torch.ops.fused_ln_linear import (
    FusedLNLinear,
    fused_ln_linear,
    fused_ln_linear_bwd_plain,
    fused_ln_linear_fwd_plain,
)
from lafs_cvpr2024_tpu_torch.train.checkpoint import (
    state_dict_from_flax,
    to_tensors,
)


def _operands(seed, t, d, o):
    rng = np.random.default_rng(seed)
    return tuple(a.astype(np.float32) for a in (
        rng.standard_normal((t, d)) * 2.0 + 0.5,
        1.0 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
        rng.standard_normal((d, o)) / np.sqrt(d),  # the JAX (D, O) layout
        rng.standard_normal((t, o))))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("o", [384, 192])
def test_plain_matches_jax_kernel_forward_and_vjp(o):
    x, g, bt, w, dy = _operands(0, 130, 128, o)
    jops = tuple(map(jnp.asarray, (x, g, bt, w)))
    y_j, vjp = jax.vjp(
        lambda *a: jax_fused_ln_linear(*a, interpret=True), *jops)
    dx_j, dg_j, dbt_j, dw_j = (np.asarray(a) for a in vjp(jnp.asarray(dy)))
    tx, tg, tbt, tdy = map(torch.from_numpy, (x, g, bt, dy))
    tw = torch.from_numpy(np.ascontiguousarray(w.T))  # nn.Linear (O, D)
    y = fused_ln_linear_fwd_plain(tx, tg, tbt, tw)
    assert y.shape == (130, o)
    assert _rel(y.numpy(), y_j) <= 1e-5
    xn, dx, dg, dbt = fused_ln_linear_bwd_plain(tx, tdy, tg, tbt, tw)
    dw = (tdy.t() @ xn).t()  # FusedLNLinear's product, in the JAX layout
    for name, a, b in (("dx", dx, dx_j), ("dg", dg, dg_j), ("dbt", dbt, dbt_j),
                       ("dw", dw, dw_j)):
        assert tuple(a.shape) == b.shape, name
        assert _rel(a.numpy(), b) <= 1e-4, name


def test_autograd_function_equals_autograd_through_plain_forward():
    """FusedLNLinear (plain forward, plain backward, dW as a product)
    against torch autograd through the plain forward, fp32; the public
    function takes the autograd path and keeps the lead dimensions; a CPU
    tensor launches no kernel."""
    x, g, bt, w, dy = map(torch.from_numpy, _operands(1, 70, 128, 192))
    w = w.t().contiguous()

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, g, bt, w)]
        y = fn(*leaves)
        y.backward(dy)
        return [y.detach()] + [t.grad for t in leaves]

    before = dict(_build.LAUNCHES)
    got = grads(lambda *a: FusedLNLinear.apply(*a, 1e-5))
    want = grads(fused_ln_linear_fwd_plain)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel(a.numpy(), b.numpy()) <= 1e-5
    xl = x.reshape(2, 35, 128).clone().requires_grad_()
    y = fused_ln_linear(xl, g, bt, w)
    assert y.shape == (2, 35, 192)
    assert type(y.grad_fn.next_functions[0][0]).__name__ == \
        "FusedLNLinearBackward"
    assert dict(_build.LAUNCHES) == before


def test_plain_bf16_keeps_the_kernel_casts():
    """bf16: xn is rounded before the product (fp32 accumulate), y, xn and
    dx come out in bf16, dγ/dβ stay fp32 sums."""
    x, g, bt, w, dy = (torch.from_numpy(a).bfloat16()
                       for a in _operands(2, 9, 128, 192))
    w = w.t().contiguous()
    y = fused_ln_linear_fwd_plain(x, g, bt, w)
    xn = torch.nn.functional.layer_norm(x.float(), (128,), g.float(),
                                        bt.float(), 1e-5).bfloat16()
    assert y.dtype == torch.bfloat16
    assert _rel(y.float(), (xn.float() @ w.float().t()).bfloat16().float()) \
        <= 1e-2
    outs = fused_ln_linear_bwd_plain(x, dy, g, bt, w)
    assert [t.dtype for t in outs] == [torch.bfloat16] * 2 + [torch.float32] * 2
    assert _rel(outs[0].float(), xn.float()) <= 1e-2


@pytest.mark.parametrize("train", [False, True])
def test_lnqkv_block_matches_jax_block(train):
    """One transformer block with ``attn_impl='lnqkv'`` against the JAX
    block in the same impl on the same weights (its norm1 and to_qkv load
    under the dense names), fp32, rate 0; in training mode the gradient
    of the input too."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 13, 128)).astype(np.float32)
    jb = JaxBlock(128, 2, 64, 256, 0.0, 0.0, "lnqkv", "dense")
    v = jax.jit(jb.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    y_j, vjp = jax.vjp(lambda a: jb.apply(v, a, deterministic=not train),
                       jnp.asarray(x))
    sd = state_dict_from_flax({"transformer": {"layers_0": v["params"]}})
    port = Transformer(128, 1, 2, 64, 256, attn_impl="lnqkv").train(train)
    port.load_state_dict({k[len("transformer."):]: t
                          for k, t in to_tensors(sd).items()}, strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt)
    assert _rel(y.detach().numpy(), y_j) <= 1e-5
    if train:
        dy = rng.standard_normal(x.shape).astype(np.float32)
        y.backward(torch.from_numpy(dy))
        (dx_j,) = vjp(jnp.asarray(dy))
        assert _rel(xt.grad.numpy(), dx_j) <= 1e-4
