"""PyTorch port: row 10, the bias-free fused MLP of
``benchmarks/bench_mlp_fusion.py``, against the JAX module's functions.

Importing ``bench_mlp_fusion`` changes the importing process (it sets
``jax_default_prng_impl`` to ``rbg`` and a compile-cache directory), so
the JAX side runs in a subprocess, on inputs made here with numpy from a
seed and handed over in an ``.npz``:

- bf16 at T = 300 and 512 (768 → 2048), rate 0: the port's plain version
  against ``_mlp_kernel`` run through its own ``pallas_call`` in interpret
  mode (T padded to the kernel's 256-row tile and sliced, as
  ``pallas_mlp`` does) and against ``xla_mlp``: ≤ 2e-2 relative to the
  output's largest value (both accumulate in fp32; a bf16 hidden value may
  round one ulp apart, and ``_gelu_exact`` is the rational erf);
- fp32 at the same T: the plain version in fp32 against the same
  arithmetic in JAX with ``_gelu_exact`` (h kept in fp32): ≤ 1e-5
  relative (the rational erf is within 1.5e-7 of erf).

Rate 0.1 cannot be compared with the TPU kernel (its hardware PRNG has no
CPU lowering); the plain version is held to its contract instead: each
draw keeps 0.9 ± 0.005 of its elements, the masks are the counter hash
keyed by the 256-row tile (checked against an independent numpy hash),
kept elements are scaled by the fp32 1/keep, and a seed gives one output.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lafs_cvpr2024_tpu_torch.ops import mlp_fusion as mf
from lafs_cvpr2024_tpu_torch.ops.fused_mlp import inv_keep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TS = (300, 512)
D, H = 768, 2048

_JAX = r"""
import functools, sys
import numpy as np
sys.path.insert(0, sys.argv[3])
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from benchmarks import bench_mlp_fusion as b

def pallas_interpret(x, w1, w2):
    n = x.shape[0]
    npad = pl.cdiv(n, b.TILE) * b.TILE
    x = jnp.pad(x, ((0, npad - n), (0, 0)))
    out = pl.pallas_call(
        functools.partial(b._mlp_kernel, rate=0.0),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(npad // b.TILE,),
            in_specs=[pl.BlockSpec((b.TILE, b.D), lambda i, s: (i, 0)),
                      pl.BlockSpec((b.D, b.H), lambda i, s: (0, 0)),
                      pl.BlockSpec((b.H, b.D), lambda i, s: (0, 0))],
            out_specs=pl.BlockSpec((b.TILE, b.D), lambda i, s: (i, 0))),
        out_shape=jax.ShapeDtypeStruct((npad, b.D), jnp.bfloat16),
        interpret=True,
    )(jnp.zeros((1,), jnp.int32), x, w1, w2)
    return out[:n]

def f32_ref(x, w1, w2):
    hi = jax.lax.Precision.HIGHEST
    h = b._gelu_exact(jnp.dot(x, w1, precision=hi))
    return jnp.dot(h, w2, precision=hi)

inp = np.load(sys.argv[1])
out = {}
w1, w2 = inp["w1"], inp["w2"]
for t in (300, 512):
    x = inp[f"x{t}"]
    xb, w1b, w2b = (jnp.asarray(a, jnp.bfloat16) for a in (x, w1, w2))
    out[f"pallas{t}"] = np.asarray(pallas_interpret(xb, w1b, w2b), np.float32)
    out[f"xla{t}"] = np.asarray(
        b.xla_mlp(jax.random.PRNGKey(1), xb, w1b, w2b, 0.0), np.float32)
    out[f"f32_{t}"] = np.asarray(f32_ref(jnp.asarray(x), jnp.asarray(w1),
                                         jnp.asarray(w2)))
np.savez(sys.argv[2], **out)
"""


def _bf16_exact(a):
    """float32 values that bf16 holds exactly (so both sides see one x)."""
    return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    rng = np.random.default_rng(0)
    arrs = {f"x{t}": _bf16_exact(rng.standard_normal((t, D))) for t in TS}
    # the microbenchmark's weight scale (N(0, 1) * 0.02)
    arrs["w1"] = _bf16_exact(rng.standard_normal((D, H)) * 0.02)
    arrs["w2"] = _bf16_exact(rng.standard_normal((H, D)) * 0.02)
    d = tmp_path_factory.mktemp("mlp_fusion")
    np.savez(d / "in.npz", **arrs)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX, str(d / "in.npz"), str(d / "out.npz"),
         ROOT], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return arrs, dict(np.load(d / "out.npz"))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("t", TS)
def test_plain_bf16_matches_jax_kernel_and_xla(jax_outputs, t):
    arrs, out = jax_outputs
    x = torch.from_numpy(arrs[f"x{t}"]).bfloat16()
    w1, w2 = mf.mlp_fusion_weights_from_jax(arrs["w1"], arrs["w2"], "cpu")
    got = mf.mlp_fusion(x, w1, w2)
    assert got.dtype == torch.bfloat16 and got.shape == (t, D)
    got = got.float().numpy()
    assert _rel(got, out[f"pallas{t}"]) <= 2e-2
    assert _rel(got, out[f"xla{t}"]) <= 2e-2
    dense = mf.mlp_fusion_dense(x, w1, w2).float().numpy()
    assert _rel(dense, out[f"xla{t}"]) <= 2e-2


@pytest.mark.parametrize("t", TS)
def test_plain_f32_matches_jax_gelu_exact(jax_outputs, t):
    arrs, out = jax_outputs
    x, w1, w2 = (torch.from_numpy(arrs[k]) for k in (f"x{t}", "w1", "w2"))
    got = mf.mlp_fusion_plain(x, w1, w2)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), out[f"f32_{t}"]) <= 1e-5


def _np_bits(rows, cols, seed, draw, tile):
    """The counter hash in numpy uint32 arithmetic (independent of the
    port's int64 emulation)."""
    m = np.uint32
    r = np.arange(rows, dtype=np.uint64)
    c = np.arange(cols, dtype=np.uint64)
    with np.errstate(over="ignore"):
        key = (m(seed) + (r // tile).astype(m) * m(0xB5297A4D)
               + m(draw) * m(0x85EBCA6B))
        v = (((r % tile).astype(m) * m(2654435761))[:, None]
             ^ (c.astype(m) * m(0x9E3779B9))[None, :] ^ key[:, None])
        v = (v ^ (v >> m(16))) * m(0x7FEB352D)
        v = (v ^ (v >> m(15))) * m(0x846CA68B)
        return v ^ (v >> m(16))


def test_plain_dropout_masks_scale_and_determinism():
    rng = np.random.default_rng(1)
    t, d, h = 512, 256, 512
    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((d, h)).astype(np.float32)
                          / np.sqrt(d))
    w2 = torch.from_numpy(rng.standard_normal((h, d)).astype(np.float32)
                          / np.sqrt(h))
    seed, rate = 1234, 0.1
    thresh = round(0.9 * 2 ** 32)
    m0 = _np_bits(t, h, seed, 0, 256) < thresh
    m1 = _np_bits(t, d, seed, 1, 256) < thresh
    for m in (m0, m1):
        assert abs(m.mean() - 0.9) <= 0.005
    assert not np.array_equal(m0[:256], m0[256:])  # the tile is in the key
    got = mf.mlp_fusion_plain(x, w1, w2, rate=rate, seed=seed)
    # the same function written out with the numpy masks, in float64
    hh = torch.nn.functional.gelu(x.double() @ w1.double()).numpy()
    hh = np.where(m0, hh * inv_keep(rate), 0.0)
    want = np.where(m1, (hh @ w2.double().numpy()) * inv_keep(rate), 0.0)
    assert np.array_equal(got.numpy() == 0, ~m1)
    assert _rel(got.numpy(), want) <= 1e-5
    assert inv_keep(rate) == np.float32(1 / 0.9)
    again = mf.mlp_fusion(x, w1, w2, rate, seed)
    other = mf.mlp_fusion(x, w1, w2, rate, seed + 1)
    assert torch.equal(got, again) and not torch.equal(got, other)
    assert mf.TILE == 256


def test_weights_from_jax_keep_the_layout_and_values():
    ml = pytest.importorskip("ml_dtypes")
    rng = np.random.default_rng(2)
    w1 = (rng.standard_normal((D, H)) * 0.02).astype(ml.bfloat16)
    w2 = (rng.standard_normal((H, D)) * 0.02).astype(ml.bfloat16)
    t1, t2 = mf.mlp_fusion_weights_from_jax(w1, w2, "cpu")
    assert t1.shape == (D, H) and t2.shape == (H, D)
    assert t1.dtype == t2.dtype == torch.bfloat16 and t1.is_contiguous()
    np.testing.assert_array_equal(t1.float().numpy(), w1.astype(np.float32))
    np.testing.assert_array_equal(t2.float().numpy(), w2.astype(np.float32))


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(4, 128, dtype=torch.bfloat16)
    w1 = torch.zeros(128, 256, dtype=torch.bfloat16)
    w2 = torch.zeros(256, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        mf.mlp_fusion_cuda(x, w1, w2)
