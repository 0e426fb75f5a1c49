"""PyTorch port: the fused attention against the JAX package.

The port's ``fused_attention_plain`` (kernel 6's arithmetic) and its VJP
(``fused_attention_bwd_plain``, kernel 7's, reached through
``FusedAttention`` on a CPU tensor) against the JAX ``fused_attention``
run in Pallas interpret mode, as ``tests/test_fused_attention.py`` runs it:
the same numpy inputs, fp32. Tolerances: forward 1e-5 relative, dQ/dK/dV
1e-4 relative (max-norm): fp32 logits and softmax on both sides, products
summed in another order. Then the port's ``Attention(attn_impl='fused')``
against the JAX ``Attention(attn_impl='fused')`` on the same weights, and
the 37-token fallback to the einsum path, 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lafs_cvpr2024_tpu.models.layers import Attention as JaxAttention
from lafs_cvpr2024_tpu.ops.fused_attention import (
    fused_attention as jax_fused_attention,
)
from lafs_cvpr2024_tpu_torch.models import layers
from lafs_cvpr2024_tpu_torch.ops.fused_attention import (
    fused_attention,
    fused_attention_bwd_plain,
    fused_attention_plain,
)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _qkv(b, h, s, d=64, seed=0):
    rng = np.random.default_rng(seed)
    # logits of a few units, so the softmax is far from uniform
    return tuple((2.0 * rng.standard_normal((b, h, s, d))).astype(np.float32)
                 for _ in range(4))


# the path's lengths, and the edges of kernel 6's register-resident row
# (256) and of its two sweeps (257)
@pytest.mark.parametrize("s", [128, 130, 197, 256, 257])
def test_plain_forward_and_vjp_match_jax_interpret(s):
    q, k, v, do = _qkv(2, 2, s)
    scale = 128 ** -0.5
    out, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(
        a, b, c, scale, interpret=True), *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = fused_attention(tq, tk, tv, scale)
    assert _rel(got.detach(), out) <= 1e-5
    assert _rel(fused_attention_plain(tq, tk, tv, scale).detach(), out) <= 1e-5
    got.backward(torch.from_numpy(do))
    plain = fused_attention_bwd_plain(*(torch.from_numpy(a) for a in
                                        (q, k, v, do)), scale)
    for name, t, p, w in zip("qkv", (tq, tk, tv), plain, want_grads):
        assert _rel(t.grad, w) <= 1e-4, name
        assert torch.equal(t.grad, p), name


def _attention_pair(n, seed=1):
    """The JAX and the port's fused Attention on the same weights, and an
    input of n tokens."""
    dim, heads, dh = 128, 2, 64
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n, dim)).astype(np.float32)
    jmod = JaxAttention(dim, heads, dh, 0.0, "fused")
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, params)
    port = layers.Attention(dim, heads, dh, 0.0, attn_impl="fused").eval()
    p = params["params"]
    with torch.no_grad():
        port.to_qkv.weight.copy_(torch.tensor(p["to_qkv"]["kernel"].T))
        port.to_out[0].weight.copy_(torch.tensor(p["to_out"]["kernel"].T))
        port.to_out[0].bias.copy_(torch.tensor(p["to_out"]["bias"]))
    return jmod, params, port, x


@pytest.mark.parametrize("n,fused", [(130, True), (37, False)])
def test_attention_module_matches_jax(n, fused, monkeypatch):
    """attn_impl='fused': 130 tokens take the fused attention on both sides
    (interpret mode in JAX), 37 tokens the einsum path; the port's call is
    counted."""
    calls = []
    monkeypatch.setattr(layers, "fused_attention",
                        lambda *a: calls.append(1) or fused_attention(*a))
    jmod, params, port, x = _attention_pair(n)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= 1e-5
    assert len(calls) == int(fused)


def test_attention_module_gradient_matches_jax():
    """The module's input gradient through the fused path (kernel 7's
    arithmetic on the CPU) against JAX autodiff through its fused path:
    1e-4 relative."""
    jmod, params, port, x = _attention_pair(128, seed=2)
    g = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jmod.apply(params, a), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    port(tx).backward(torch.from_numpy(g))
    assert _rel(tx.grad, want) <= 1e-4
