"""PyTorch port: the CUDA kernels against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither jax nor the JAX package, so it runs on a machine that has only
PyTorch and the CUDA toolkit; ``tests/conftest.py`` imports jax, so run it
there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the gather agrees to 1e-5 in fp32 and to one bf16 ulp in bf16
(the same four-corner sum, contracted to FMAs by nvcc); the MLP forward
and backward to 1e-4 relative in fp32 and 2e-2 in bf16 (both accumulate in
fp32 in another order, and a 1-ulp flip of a bf16 intermediate moves the
output), with and without the LayerNorm (kernels 2-5, all four also in
their Hopper design, bf16 at D 768 and H 256, 512 and 2048, at T from 1
to 333 across the edges of the 64-row tile and of the hash's 128-row
tile, every (rate, u saved) instance, kernel 3's one dγ/dβ partial row a
cluster, the profiler naming the Hopper instances on that path and only
there, misaligned operands copied to aligned ones by the wrappers),
and so do the LN-fused linear's forward and backward (kernels 8 and 9) at any output
width O (in their Hopper design, bf16 at D 768 with O a multiple of 8, at
T from 1 to 333 across the edges of their 64-row tiles,
one dγ/dβ partial row a cluster, the profiler naming the Hopper kernels
on that path and only there). A first backward in a fresh process whose
first node is a kernel that encodes a tensor map (3, 5 or 9) runs, with or without a
torch.profiler session before it. Dropout masks are the same bits: the kernels and the plain
versions hash the same keys. The fused attention forward and backward
agree to 1e-5 relative in fp32 and 2e-2 in bf16 (fp32 logits and softmax in
both; the products accumulate in another order, and bf16 A and dS may
round one ulp apart), and stay finite with logits up to 80; at the
served shape (512, 11, 197, 64) under inference mode too, and a served
Part-fViT-B forward loaded by ``load_eval_model`` launches kernel 6 once
in each of its 12 blocks. So do the flash attention forward and its two
backward kernels (11a-c) at any length N, the logsumexp and 11c's
statistics scratch within 1e-5 (its padded rows exactly +inf and 0); the
backward runs 11c, then 11b, and no other kernel, and two launches of each
give the same bits. The
bias-free fused MLP of row 10 agrees to 2e-2 in bf16 (its only dtype) at T
from 1 to the microbenchmark's (the edges of its 64-row cluster tile and
of the hash's 256-row tile included), and where its arithmetic is exact
(one-hot W2, a constant hidden layer) its output equals the plain
version's bit for bit at rate 0.1, which holds both dropout masks. The
batched face warp on the card equals its run on the CPU (the numpy warp's
arithmetic, in float64), and the card's decode and warp of the mini IJB
fixture lie within a mean of 1 level of the numpy ``norm_crop`` of PIL's
decode.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lafs_cvpr2024_tpu_torch import _build
from lafs_cvpr2024_tpu_torch.eval.loading import load_eval_model
from lafs_cvpr2024_tpu_torch.models.partfvit import (
    PartFViT,
    PartFViTConfig,
    init_random_,
)
from lafs_cvpr2024_tpu_torch.ops.fused_attention import (
    fused_attention,
    fused_attention_bwd_cuda,
    fused_attention_bwd_plain,
    fused_attention_cuda,
    fused_attention_plain,
)
from lafs_cvpr2024_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_cuda,
    flash_attention_bwd_dkv_cuda,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq_cuda,
    flash_attention_bwd_dq_plain,
    flash_attention_bwd_plain,
    flash_attention_fwd_cuda,
    flash_attention_plain,
)
from lafs_cvpr2024_tpu_torch.ops.fused_ln_linear import (
    FusedLNLinear,
    fused_ln_linear,
    fused_ln_linear_bwd_cuda,
    fused_ln_linear_bwd_plain,
    fused_ln_linear_fwd_cuda,
    fused_ln_linear_fwd_plain,
)
from lafs_cvpr2024_tpu_torch.ops.fused_mlp import (
    FusedLNMLP,
    FusedMLP,
    dropout_mask,
    fused_ln_mlp,
    fused_ln_mlp_bwd_cuda,
    fused_ln_mlp_bwd_plain,
    fused_ln_mlp_fwd_cuda,
    fused_ln_mlp_fwd_plain,
    fused_mlp,
    fused_mlp_bwd_cuda,
    fused_mlp_bwd_plain,
    fused_mlp_fwd_cuda,
    fused_mlp_fwd_plain,
)
from lafs_cvpr2024_tpu_torch.ops.mlp_fusion import (
    mlp_fusion,
    mlp_fusion_cuda,
    mlp_fusion_plain,
    mlp_fusion_weights_from_jax,
)
from lafs_cvpr2024_tpu_torch.ops.patch_gather import (
    patch_gather,
    patch_gather_plain,
)
from lafs_cvpr2024_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("patch", [8, 5])
def test_patch_gather_kernel_matches_plain(cuda, dtype, patch):
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-0.5, 0.5, (3, 112, 96, 3)).astype(np.float32)
    lands = rng.uniform(-12.0, 124.0, (3, 196, 2)).astype(np.float32)
    lands[:, :6] = [(-1e4, 5), (1e4, 5), (5, -1e9), (0, 0), (95, 111),
                    (95.5, 111.5)]
    ti = torch.from_numpy(imgs).to(cuda, dtype)
    tl = torch.from_numpy(lands).to(cuda, dtype)
    before = _build.LAUNCHES["patch_gather"]
    got = patch_gather(ti, tl, patch, impl="kernel")
    torch.cuda.synchronize()
    assert _build.LAUNCHES["patch_gather"] == before + 1
    want = patch_gather_plain(ti, tl, patch)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        _, e = torch.frexp(want.float())
        ulp = torch.ldexp(torch.ones_like(err), e - 8)
        assert bool((err <= ulp).all())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d,h", [(128, 256), (768, 2048)])
def test_fused_ln_mlp_kernel_matches_plain(cuda, dtype, tol, d, h):
    rng = np.random.default_rng(1)
    arrs = (rng.standard_normal((333, d)) * 2.0 + 0.5,  # 333: a ragged block
            1.0 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
            rng.standard_normal((h, d)) / np.sqrt(d),  # nn.Linear layout
            0.1 * rng.standard_normal(h),
            rng.standard_normal((d, h)) / np.sqrt(h),
            0.1 * rng.standard_normal(d))
    ops = [torch.from_numpy(a.astype(np.float32)).to(cuda, dtype)
           for a in arrs]
    before = _build.LAUNCHES["fused_ln_mlp"]
    got = fused_ln_mlp(*ops)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_ln_mlp"] == before + 1
    want, _ = fused_ln_mlp_fwd_plain(*ops)
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= tol


def _mlp_operands(cuda, dtype, t, d, h, seed=1):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((t, d)) * 2.0 + 0.5,
            1.0 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
            rng.standard_normal((h, d)) / np.sqrt(d),  # nn.Linear layout
            0.1 * rng.standard_normal(h),
            rng.standard_normal((d, h)) / np.sqrt(h),
            0.1 * rng.standard_normal(d))
    return [torch.from_numpy(a.astype(np.float32)).to(cuda, dtype)
            for a in arrs]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d,h", [(128, 256), (768, 2048)])
def test_fused_ln_mlp_dropout_and_u_match_plain(cuda, dtype, tol, d, h):
    """Kernel 2 at rate 0.1 with u saved: y and u within tolerance, and
    the output mask (the zeros of y) the plain version's bit for bit."""
    ops = _mlp_operands(cuda, dtype, 333, d, h)
    got, u = fused_ln_mlp_fwd_cuda(*ops, rate=0.1, seed=987654, save_u=True)
    want, u_want = fused_ln_mlp_fwd_plain(*ops, rate=0.1, seed=987654,
                                          save_u=True)
    torch.cuda.synchronize()
    assert u.dtype == dtype and u.shape == (333, h)
    assert _rel(got, want) <= tol and _rel(u, u_want) <= tol
    m2 = dropout_mask(333, d, 987654, 0.1, 1, dtype, cuda)
    assert torch.equal(got != 0, m2) and torch.equal(want != 0, m2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d,h", [(128, 256), (768, 2048)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_ln_mlp_bwd_kernel_matches_plain(cuda, dtype, tol, d, h, rate):
    """Kernel 3: do, hd, du, xn, dx, dγ and dβ against the plain version
    on the same saved u; both masks (the zeros of do and hd) bit for
    bit."""
    x, g, bt, w1, b1, w2, b2 = _mlp_operands(cuda, dtype, 333, d, h)
    _, u = fused_ln_mlp_fwd_plain(x, g, bt, w1, b1, w2, b2, save_u=True)
    dy = torch.randn(333, d, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(2)).to(dtype)
    before = _build.LAUNCHES["fused_ln_mlp_bwd"]
    got = fused_ln_mlp_bwd_cuda(x, u, dy, g, bt, w1, w2, rate=rate, seed=55)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_ln_mlp_bwd"] == before + 1
    want = fused_ln_mlp_bwd_plain(x, u, dy, g, bt, w1, w2, rate=rate, seed=55)
    names = ("do", "hd", "du", "xn", "dx", "dg", "dbt")
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= tol, name
    if rate:
        # dropped elements are 0; a kept one is 0 only where the value
        # before dropout is (GELU rounds to 0 far left of 0)
        m1 = dropout_mask(333, h, 55, rate, 0, dtype, cuda)
        m2 = dropout_mask(333, d, 55, rate, 1, dtype, cuda)
        h0 = torch.nn.functional.gelu(u.float()).to(dtype)
        assert torch.equal(got[1] != 0, m1 & (h0 != 0))
        assert torch.equal(got[0] != 0, m2 & (dy != 0))


def test_fused_autograd_function_launches_both_kernels(cuda):
    """FusedLNMLP on the card: kernel 2 forward, kernel 3 backward, and
    gradients within 1e-4 of the same function run on the CPU (plain)."""
    ops = _mlp_operands(cuda, torch.float32, 200, 128, 256)
    dy = torch.randn(200, 128, device=cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in ops]
        before = dict(_build.LAUNCHES)
        FusedLNMLP.apply(*leaves, 1e-5, 0.1, 77).backward(dy.to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert _build.LAUNCHES["fused_ln_mlp"] == \
                before.get("fused_ln_mlp", 0) + 1
            assert _build.LAUNCHES["fused_ln_mlp_bwd"] == \
                before.get("fused_ln_mlp_bwd", 0) + 1
        grads.append([t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) <= 1e-4


# Kernels 2 and 3 in their Hopper design (bf16, D = 768, H a multiple of
# 256): T at the edges of the 64-row cluster tile and of the hash's 128-row
# tile, and a ragged T
SM90_T = [1, 63, 64, 65, 127, 128, 129, 333]


@pytest.mark.parametrize("h", [256, 512, 2048])
@pytest.mark.parametrize("t", SM90_T)
@pytest.mark.parametrize("rate,save_u", [(0.0, False), (0.0, True),
                                         (0.1, False), (0.1, True)])
def test_fused_ln_mlp_hopper_design_matches_plain(cuda, h, t, rate, save_u):
    """Kernel 2's Hopper design: y (and u) within 2e-2 of the plain
    version, finite, and the output mask its bits."""
    ops = _mlp_operands(cuda, torch.bfloat16, t, 768, h, seed=t + h)
    kw = dict(rate=rate, seed=4321, save_u=save_u)
    got, u = fused_ln_mlp_fwd_cuda(*ops, **kw)
    want, u_want = fused_ln_mlp_fwd_plain(*ops, **kw)
    torch.cuda.synchronize()
    assert got.shape == (t, 768) and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 2e-2
    if save_u:
        assert u.shape == (t, h) and _rel(u, u_want) <= 2e-2
    else:
        assert u is None
    if rate:
        m2 = dropout_mask(t, 768, 4321, rate, 1, torch.bfloat16, cuda)
        assert torch.equal(got != 0, m2) and torch.equal(want != 0, m2)


@pytest.mark.parametrize("h", [256, 512, 2048])
@pytest.mark.parametrize("t", SM90_T)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_ln_mlp_bwd_hopper_design_matches_plain(cuda, h, t, rate):
    """Kernel 3's Hopper design: every output within 2e-2 of the plain
    version and finite, both masks bit for bit, one dγ/dβ partial row a
    64-row cluster."""
    x, g, bt, w1, b1, w2, b2 = _mlp_operands(cuda, torch.bfloat16, t, 768, h,
                                             seed=t + h + 1)
    _, u = fused_ln_mlp_fwd_plain(x, g, bt, w1, b1, w2, b2, save_u=True)
    dy = torch.randn(t, 768, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(t)
                     ).to(torch.bfloat16)
    got = fused_ln_mlp_bwd_cuda(x, u, dy, g, bt, w1, w2, rate=rate, seed=66)
    want = fused_ln_mlp_bwd_plain(x, u, dy, g, bt, w1, w2, rate=rate, seed=66)
    torch.cuda.synchronize()
    names = ("do", "hd", "du", "xn", "dx", "dg", "dbt")
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= 2e-2, name
    if rate:
        m1 = dropout_mask(t, h, 66, rate, 0, torch.bfloat16, cuda)
        m2 = dropout_mask(t, 768, 66, rate, 1, torch.bfloat16, cuda)
        h0 = torch.nn.functional.gelu(u.float()).to(torch.bfloat16)
        assert torch.equal(got[1] != 0, m1 & (h0 != 0))
        assert torch.equal(got[0] != 0, m2 & (dy != 0))
    lib = _build.library()
    assert lib.lafs_ln_mlp_bwd_partial_rows(t, 768, h, 1) == -(-t // 64)
    assert lib.lafs_ln_mlp_bwd_partial_rows(t, 768, h, 0) == -(-t // 32)
    assert lib.lafs_ln_mlp_bwd_partial_rows(t, 128, 256, 1) == -(-t // 32)


def test_fused_ln_mlp_runs_the_hopper_design_only_where_it_takes(cuda):
    """By the profiler's kernel names: bf16 at D 768, H 2048 launches the
    Hopper instances, (128, 256) and fp32 the first design's, and no call
    launches both."""
    from torch.profiler import ProfilerActivity, profile

    def names(dtype, d, h):
        x, g, bt, w1, b1, w2, b2 = _mlp_operands(cuda, dtype, 130, d, h)
        leaves = [a.requires_grad_() for a in (x, g, bt, w1, b1, w2, b2)]
        dy = torch.ones(130, d, device=cuda, dtype=dtype)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            y = fused_ln_mlp(*leaves, rate=0.1, seed=5)
            torch.autograd.grad(y, leaves, dy)
            torch.cuda.synchronize()
        return {e.key for e in prof.key_averages() if "ln_mlp" in e.key}

    hop = names(torch.bfloat16, 768, 2048)
    assert any("ln_mlp_fwd_sm90" in k for k in hop)
    assert any("ln_mlp_bwd_sm90" in k for k in hop)
    assert not any("ln_mlp_bf16_kernel" in k or "ln_mlp_bwd_bf16_kernel" in k
                   for k in hop)
    for dtype, d, h in ((torch.bfloat16, 128, 256), (torch.float32, 768, 2048)):
        first = names(dtype, d, h)
        assert first and not any("sm90" in k for k in first)


def test_fused_ln_mlp_kernel_refuses_widths_it_does_not_take(cuda):
    x = torch.zeros(8, 96, device=cuda)
    ops = (x, torch.ones(96, device=cuda), torch.zeros(96, device=cuda),
           torch.zeros(256, 96, device=cuda), torch.zeros(256, device=cuda),
           torch.zeros(96, 256, device=cuda), torch.zeros(96, device=cuda))
    with pytest.raises(ValueError, match="D % 128"):
        fused_ln_mlp(*ops)


def test_model_kernel_configuration_matches_plain(cuda):
    """The small Part-fViT of the CPU tests, on the card in fp32: the
    kernel configuration against the plain one, cosine ≥ 1 − 1e-5."""
    arch = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256,
                num_patches=36, image_size=48, loss_type="None",
                num_classes=0)
    state = init_random_(PartFViT(PartFViTConfig(**arch)), 0).state_dict()
    models = []
    for impls in (("kernel", "fused_ln"), ("gather", "dense")):
        m = PartFViT(PartFViTConfig(**arch, gather_impl=impls[0],
                                    mlp_impl=impls[1]))
        m.load_state_dict(state)
        models.append(m.eval().to(cuda))
    x = torch.rand(4, 48, 48, 3, device=cuda) - 0.5
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        got, want = models[0](x), models[1](x)
    assert _build.LAUNCHES["patch_gather"] == before.get("patch_gather", 0) + 1
    assert _build.LAUNCHES["fused_ln_mlp"] == before.get("fused_ln_mlp", 0) + 2
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    assert cos.min().item() >= 1 - 1e-5


def _attn_operands(cuda, dtype, b, h, s, seed=3):
    """q, k, v and dO as strided (B, H, S, 64) views of one (B, S, 3·H·64)
    tensor, as the Attention module splits its to_qkv output, and a
    contiguous dO."""
    gen = torch.Generator(cuda).manual_seed(seed)
    qkv = torch.randn(b, s, 3 * h * 64, device=cuda, generator=gen) * 2.0
    q, k, v = (t.reshape(b, s, h, 64).transpose(1, 2)
               for t in qkv.to(dtype).chunk(3, dim=-1))
    do = torch.randn(b, h, s, 64, device=cuda, generator=gen).to(dtype)
    return q, k, v, do


# every shape in both dtypes with logits of a few units: S = 1, the edges
# of the 64-row tiles (63, 64, 65), ragged S, the path's 197 (also at
# 25 · 11 = 275 (b, h), more blocks than one wave of two a multiprocessor),
# the edges of kernel 6's register-resident row (208, 256 | 257) and the
# longest S; then bf16 with logits up to 80 where the last query tile is
# ragged (a peaked softmax whose padded rows could overflow)
ATTN_SHAPES = [(3, 2, 1), (3, 2, 37), (2, 3, 63), (2, 3, 64), (2, 3, 65),
               (2, 3, 128), (2, 3, 130), (4, 11, 197), (25, 11, 197),
               (2, 2, 208), (2, 2, 256), (2, 2, 257), (2, 2, 512)]
ATTN_CASES = ([(dtype, tol, *shape, None)
               for dtype, tol in ((torch.float32, 1e-5),
                                  (torch.bfloat16, 2e-2))
               for shape in ATTN_SHAPES]
              + [(torch.bfloat16, 2e-2, b, h, s, 80.0)
                 for b, h, s in ((4, 11, 197), (2, 3, 65), (2, 2, 257))])


def _attn_scale(q, k, peak):
    """768^-0.5 · 4 (logits of a few units: a peaked softmax), or the scale
    that puts the largest |logit| at ``peak``."""
    if peak is None:
        return 768 ** -0.5 * 4.0
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return peak / logits.abs().max().item()


@pytest.mark.parametrize("dtype,tol,b,h,s,peak", ATTN_CASES)
def test_fused_attention_kernel_matches_plain(cuda, dtype, tol, b, h, s,
                                              peak):
    """Kernel 6 on strided views, ragged S: O finite and within tolerance
    of the plain version; the result is a view of a (B, S, H, D) tensor."""
    q, k, v, _ = _attn_operands(cuda, dtype, b, h, s)
    scale = _attn_scale(q, k, peak)
    before = _build.LAUNCHES["fused_attention"]
    got = fused_attention_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_attention"] == before + 1
    want = fused_attention_plain(q, k, v, scale)
    assert got.dtype == dtype and got.shape == want.shape == (b, h, s, 64)
    assert got.transpose(1, 2).is_contiguous()
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("dtype,tol,b,h,s,peak", ATTN_CASES)
def test_fused_attention_bwd_kernel_matches_plain(cuda, dtype, tol, b, h, s,
                                                  peak):
    """Kernel 7: dQ, dK and dV finite and within tolerance of the plain
    version."""
    q, k, v, do = _attn_operands(cuda, dtype, b, h, s)
    scale = _attn_scale(q, k, peak)
    before = _build.LAUNCHES["fused_attention_bwd"]
    got = fused_attention_bwd_cuda(q, k, v, do, scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_attention_bwd"] == before + 1
    want = fused_attention_bwd_plain(q, k, v, do, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape == (b, h, s, 64), name
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, w) <= tol, name


def test_fused_attention_autograd_launches_both_kernels(cuda):
    """FusedAttention on the card: kernel 6 forward, kernel 7 backward, and
    gradients within 1e-5 of the same function run on the CPU (plain)."""
    q, k, v, do = _attn_operands(cuda, torch.float32, 2, 3, 150)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        before = dict(_build.LAUNCHES)
        fused_attention(*leaves, 0.1).backward(do.to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            for name in ("fused_attention", "fused_attention_bwd"):
                assert _build.LAUNCHES[name] == before.get(name, 0) + 1
        grads.append([t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) <= 1e-5


def test_fused_attention_kernel_refuses_shapes_it_does_not_take(cuda):
    x = torch.zeros(1, 2, 513, 64, device=cuda)
    with pytest.raises(ValueError, match="S <= 512"):
        fused_attention(x, x, x, 0.1)
    y = torch.zeros(1, 2, 16, 32, device=cuda)
    with pytest.raises(ValueError, match="D = 64"):
        fused_attention(y, y, y, 0.1)


def test_fused_attention_kernel_at_the_served_shape(cuda):
    """Kernel 6 as the served forward calls it: 512 rows (256 faces and
    their flips) of 197 tokens in 11 heads, strided ``to_qkv`` views, the
    model's scale, through ``fused_attention`` under inference mode; O
    within 2e-2 of the plain version, one launch, a (B, S, H, D) view."""
    q, k, v, _ = _attn_operands(cuda, torch.bfloat16, 512, 11, 197)
    scale = 768 ** -0.5
    before = _build.LAUNCHES["fused_attention"]
    with torch.inference_mode():
        got = fused_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_attention"] == before + 1
    want = fused_attention_plain(q, k, v, scale)
    assert got.shape == (512, 11, 197, 64) and got.dtype == torch.bfloat16
    assert got.transpose(1, 2).is_contiguous()
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 2e-2


def test_served_forward_launches_kernel_6_once_a_block(cuda, tmp_path):
    """A Part-fViT-B ``.pth`` through ``load_eval_model``, in bf16 under
    inference mode, traced: 12 kernel 6 launches a forward, no fallback
    to the einsum path, embeddings at cosine ≥ 1 − 1e-3 of the same
    weights with ``attn_impl='einsum'``."""
    pth = str(tmp_path / "partfvit_b.pth")
    cfg = PartFViTConfig(loss_type="None", num_classes=0)
    torch.save(init_random_(PartFViT(cfg), 3).state_dict(), pth)
    loaded = load_eval_model(pth, device=cuda, log=lambda _: None)
    model = loaded.model.to(torch.bfloat16)
    plain = PartFViT(dataclasses.replace(loaded.cfg, attn_impl="einsum"))
    plain.load_state_dict(loaded.model.state_dict())
    plain.eval().to(cuda, torch.bfloat16)
    x = (torch.rand(4, 112, 112, 3, device=cuda) - 0.5).to(torch.bfloat16)
    tracing.enable(True)
    tracing.reset()
    try:
        with torch.inference_mode():
            got = model(x).float()
        torch.cuda.synchronize()
        counters = tracing.export()["counters"]
    finally:
        tracing.enable(False)
        tracing.reset()
    assert counters.get("launch.fused_attention") == 12
    assert "attn.fused_fallback" not in counters
    with torch.inference_mode():
        want = plain(x).float()
    assert torch.nn.functional.cosine_similarity(got, want).min() >= 1 - 1e-3


# ------------------------------------------------ kernels 4 and 5 (fused) --

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d,h", [(128, 256), (768, 2048)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_mlp_kernel_matches_plain(cuda, dtype, tol, d, h, rate):
    """Kernel 4 (no LayerNorm) with u saved: y and u within tolerance of
    the plain version, the output mask (the zeros of y) the plain
    version's bit for bit; without u the same y."""
    x, _, _, w1, b1, w2, b2 = _mlp_operands(cuda, dtype, 333, d, h)
    kw = dict(rate=rate, seed=24680)
    before = _build.LAUNCHES["fused_mlp"]
    got, u = fused_mlp_fwd_cuda(x, w1, b1, w2, b2, save_u=True, **kw)
    no_u, _ = fused_mlp_fwd_cuda(x, w1, b1, w2, b2, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_mlp"] == before + 2
    want, u_want = fused_mlp_fwd_plain(x, w1, b1, w2, b2, save_u=True, **kw)
    assert got.dtype == u.dtype == dtype and u.shape == (333, h)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= tol and _rel(u, u_want) <= tol
    assert torch.equal(got, no_u)
    if rate:
        m2 = dropout_mask(333, d, 24680, rate, 1, dtype, cuda)
        assert torch.equal(got != 0, m2) and torch.equal(want != 0, m2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d,h", [(128, 256), (768, 2048)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_mlp_bwd_kernel_matches_plain(cuda, dtype, tol, d, h, rate):
    """Kernel 5: do, hd and du against the plain version on the same saved
    u; both masks (the zeros of do and hd) bit for bit."""
    x, _, _, w1, b1, w2, b2 = _mlp_operands(cuda, dtype, 333, d, h)
    _, u = fused_mlp_fwd_plain(x, w1, b1, w2, b2, save_u=True)
    dy = torch.randn(333, d, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(4)).to(dtype)
    before = _build.LAUNCHES["fused_mlp_bwd"]
    got = fused_mlp_bwd_cuda(u, dy, w2, rate=rate, seed=66)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_mlp_bwd"] == before + 1
    want = fused_mlp_bwd_plain(u, dy, w2, rate=rate, seed=66)
    for name, a, b in zip(("do", "hd", "du"), got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= tol, name
    if rate:
        m1 = dropout_mask(333, h, 66, rate, 0, dtype, cuda)
        m2 = dropout_mask(333, d, 66, rate, 1, dtype, cuda)
        h0 = torch.nn.functional.gelu(u.float()).to(dtype)
        assert torch.equal(got[1] != 0, m1 & (h0 != 0))
        assert torch.equal(got[0] != 0, m2 & (dy != 0))


def test_fused_mlp_autograd_launches_both_kernels(cuda):
    """FusedMLP on the card: kernel 4 forward, kernel 5 backward, and
    gradients within 1e-4 of the same function run on the CPU (plain)."""
    x, _, _, w1, b1, w2, b2 = _mlp_operands(cuda, torch.float32, 200, 128,
                                            256)
    dy = torch.randn(200, 128, device=cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_()
                  for t in (x, w1, b1, w2, b2)]
        before = dict(_build.LAUNCHES)
        FusedMLP.apply(*leaves, 0.1, 77).backward(dy.to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            for name in ("fused_mlp", "fused_mlp_bwd"):
                assert _build.LAUNCHES[name] == before.get(name, 0) + 1
        grads.append([t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) <= 1e-4


@pytest.mark.parametrize("h", [256, 512, 2048])
@pytest.mark.parametrize("t", SM90_T)
@pytest.mark.parametrize("rate,save_u", [(0.0, False), (0.0, True),
                                         (0.1, False), (0.1, True)])
def test_fused_mlp_hopper_design_matches_plain(cuda, h, t, rate, save_u):
    """Kernel 4's Hopper design (kernel 2's body without the LayerNorm):
    y (and u) within 2e-2 of the plain version, finite, and the output
    mask its bits."""
    x, _, _, w1, b1, w2, b2 = _mlp_operands(cuda, torch.bfloat16, t, 768, h,
                                            seed=t + h + 2)
    kw = dict(rate=rate, seed=8642, save_u=save_u)
    got, u = fused_mlp_fwd_cuda(x, w1, b1, w2, b2, **kw)
    want, u_want = fused_mlp_fwd_plain(x, w1, b1, w2, b2, **kw)
    torch.cuda.synchronize()
    assert got.shape == (t, 768) and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 2e-2
    if save_u:
        assert u.shape == (t, h) and bool(torch.isfinite(u).all())
        assert _rel(u, u_want) <= 2e-2
    else:
        assert u is None
    if rate:
        m2 = dropout_mask(t, 768, 8642, rate, 1, torch.bfloat16, cuda)
        assert torch.equal(got != 0, m2) and torch.equal(want != 0, m2)


@pytest.mark.parametrize("h", [256, 512, 2048])
@pytest.mark.parametrize("t", SM90_T)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_mlp_bwd_hopper_design_matches_plain(cuda, h, t, rate):
    """Kernel 5's Hopper design: do, hd and du within 2e-2 of the plain
    version and finite, both masks bit for bit."""
    x, _, _, w1, b1, w2, b2 = _mlp_operands(cuda, torch.bfloat16, t, 768, h,
                                            seed=t + h + 3)
    _, u = fused_mlp_fwd_plain(x, w1, b1, w2, b2, save_u=True)
    dy = torch.randn(t, 768, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(t + 1)
                     ).to(torch.bfloat16)
    got = fused_mlp_bwd_cuda(u, dy, w2, rate=rate, seed=77)
    want = fused_mlp_bwd_plain(u, dy, w2, rate=rate, seed=77)
    torch.cuda.synchronize()
    for name, a, b in zip(("do", "hd", "du"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= 2e-2, name
    if rate:
        m1 = dropout_mask(t, h, 77, rate, 0, torch.bfloat16, cuda)
        m2 = dropout_mask(t, 768, 77, rate, 1, torch.bfloat16, cuda)
        h0 = torch.nn.functional.gelu(u.float()).to(torch.bfloat16)
        assert torch.equal(got[1] != 0, m1 & (h0 != 0))
        assert torch.equal(got[0] != 0, m2 & (dy != 0))


def _offset_view(a):
    """``a``'s values in a tensor whose data starts 2 bytes past a 16-byte
    boundary (a contiguous view one element into a larger buffer)."""
    buf = torch.empty(a.numel() + 1, device=a.device, dtype=a.dtype)
    view = buf[1:].view(a.shape)
    view.copy_(a)
    assert view.data_ptr() % 16 and view.is_contiguous()
    return view


def test_fused_mlp_wrappers_take_misaligned_operands(cuda):
    """Kernels 4 and 5 in the Hopper design given x, b1, b2, u and dy as
    views off a 16-byte boundary: the wrappers hand the kernels aligned
    copies, and the results equal those of the aligned operands."""
    x, _, _, w1, b1, w2, b2 = _mlp_operands(cuda, torch.bfloat16, 130, 768,
                                            512, seed=9)
    kw = dict(rate=0.1, seed=31)
    y, u = fused_mlp_fwd_cuda(x, w1, b1, w2, b2, save_u=True, **kw)
    y_off, u_off = fused_mlp_fwd_cuda(_offset_view(x), w1, _offset_view(b1),
                                      w2, _offset_view(b2), save_u=True, **kw)
    dy = torch.randn(130, 768, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(3)
                     ).to(torch.bfloat16)
    got = fused_mlp_bwd_cuda(u, dy, w2, **kw)
    got_off = fused_mlp_bwd_cuda(_offset_view(u), _offset_view(dy), w2, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, y_off) and torch.equal(u, u_off)
    for a, b in zip(got, got_off):
        assert torch.equal(a, b)
    want, _ = fused_mlp_fwd_plain(x, w1, b1, w2, b2, **kw)
    assert _rel(y_off, want) <= 2e-2


# The profiler's kernel names of a FusedMLP forward and backward, each case
# in this fresh process (see DESIGN_NAMES below)
MLP_DESIGN_NAMES = """
import json, numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from lafs_cvpr2024_tpu_torch.ops.fused_mlp import fused_mlp
out = {}
for dtype, d, h in ((torch.bfloat16, 768, 2048), (torch.bfloat16, 128, 256),
                    (torch.bfloat16, 768, 1920), (torch.float32, 768, 2048)):
    rng = np.random.default_rng(6)
    x, w1, b1, w2, b2, dy = (
        torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
        for a in (rng.standard_normal((130, d)),
                  rng.standard_normal((h, d)) / np.sqrt(d),
                  0.1 * rng.standard_normal(h),
                  rng.standard_normal((d, h)) / np.sqrt(h),
                  0.1 * rng.standard_normal(d), rng.standard_normal((130, d))))
    leaves = [a.requires_grad_() for a in (x, w1, b1, w2, b2)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = fused_mlp(*leaves, rate=0.1, seed=5)
        torch.autograd.grad(y, leaves, dy)
        torch.cuda.synchronize()
    out[f"{dtype} {d} {h}"] = sorted(
        {e.key for e in prof.key_averages()
         if "mlp_fwd" in e.key or "mlp_bwd" in e.key})
print(json.dumps(out))
"""


def test_fused_mlp_runs_the_hopper_design_only_where_it_takes(cuda):
    """By the profiler's kernel names: bf16 at D 768, H 2048 launches
    kernels 4 and 5's Hopper instances (named mlp_fwd_sm90 and
    mlp_bwd_sm90, never kernel 2's or 3's ln_mlp_ names) and no first-design
    kernel; D = 128, H = 1,920 and fp32 launch only the first design."""
    import json

    names = json.loads(_child(cuda, MLP_DESIGN_NAMES).stdout.splitlines()[-1])
    hop = names.pop("torch.bfloat16 768 2048")
    assert any("mlp_fwd_sm90" in k for k in hop)
    assert any("mlp_bwd_sm90" in k for k in hop)
    assert not any("ln_mlp_" in k or "bf16_kernel" in k for k in hop)
    for first in names.values():
        assert first and not any("sm90" in k for k in first)
        assert not any("ln_mlp_" in k for k in first)


def test_fused_mlp_kernel_refuses_widths_it_does_not_take(cuda):
    x = torch.zeros(8, 96, device=cuda)
    with pytest.raises(ValueError, match="D % 128"):
        fused_mlp(x, torch.zeros(256, 96, device=cuda),
                  torch.zeros(256, device=cuda),
                  torch.zeros(96, 256, device=cuda),
                  torch.zeros(96, device=cuda))


# ------------------------------------------ kernels 8 and 9 (LN + linear) --

def _ln_linear_operands(cuda, dtype, t, d, o, seed=5):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((t, d)) * 2.0 + 0.5,
            1.0 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
            rng.standard_normal((o, d)) / np.sqrt(d),  # nn.Linear layout
            rng.standard_normal((t, o)))
    return [torch.from_numpy(a.astype(np.float32)).to(cuda, dtype)
            for a in arrs]


LN_LINEAR_SHAPES = [(333, 128, 192), (130, 128, 100), (333, 768, 2112),
                    (130, 768, 192)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,d,o", LN_LINEAR_SHAPES)
def test_fused_ln_linear_kernel_matches_plain(cuda, dtype, tol, t, d, o):
    """Kernel 8 at ragged T and at output widths that are not a multiple
    of its 128-column block (2,112, 192) or of 16 (100)."""
    x, g, bt, w, _ = _ln_linear_operands(cuda, dtype, t, d, o)
    before = _build.LAUNCHES["fused_ln_linear"]
    got = fused_ln_linear_fwd_cuda(x, g, bt, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_ln_linear"] == before + 1
    want = fused_ln_linear_fwd_plain(x, g, bt, w)
    assert got.dtype == dtype and got.shape == want.shape == (t, o)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,d,o", LN_LINEAR_SHAPES)
def test_fused_ln_linear_bwd_kernel_matches_plain(cuda, dtype, tol, t, d, o):
    """Kernel 9: xn, dx, dγ and dβ against the plain version."""
    x, g, bt, w, dy = _ln_linear_operands(cuda, dtype, t, d, o)
    before = _build.LAUNCHES["fused_ln_linear_bwd"]
    got = fused_ln_linear_bwd_cuda(x, dy, g, bt, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_ln_linear_bwd"] == before + 1
    want = fused_ln_linear_bwd_plain(x, dy, g, bt, w)
    for name, a, b in zip(("xn", "dx", "dg", "dbt"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= tol, name


def test_fused_ln_linear_autograd_launches_both_kernels(cuda):
    """FusedLNLinear on the card: kernel 8 forward, kernel 9 backward, and
    gradients within 1e-4 of the same function run on the CPU (plain)."""
    x, g, bt, w, dy = _ln_linear_operands(cuda, torch.float32, 150, 128, 384)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (x, g, bt, w)]
        before = dict(_build.LAUNCHES)
        FusedLNLinear.apply(*leaves, 1e-5).backward(dy.to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            for name in ("fused_ln_linear", "fused_ln_linear_bwd"):
                assert _build.LAUNCHES[name] == before.get(name, 0) + 1
        grads.append([t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        assert _rel(a, b) <= 1e-4


def test_fused_ln_linear_kernel_refuses_widths_it_does_not_take(cuda):
    x = torch.zeros(8, 96, device=cuda)
    with pytest.raises(ValueError, match="D % 128"):
        fused_ln_linear(x, torch.ones(96, device=cuda),
                        torch.zeros(96, device=cuda),
                        torch.zeros(192, 96, device=cuda))


# Kernels 8 and 9 in their Hopper design (bf16, D = 768, O a multiple of
# 8): T at the edges of their 64-row tiles and a ragged T; O below a
# 64-wide chunk of kernel 9 (8), one 192-column tile of kernel 8 (192),
# Part-fViT-B's 2,112 (11 tiles, 33 chunks) and 2,120 (a last tile and
# chunk of 8)
SM90_O = [8, 192, 2112, 2120]


@pytest.mark.parametrize("o", SM90_O)
@pytest.mark.parametrize("t", SM90_T)
def test_fused_ln_linear_hopper_design_matches_plain(cuda, t, o):
    """Kernels 8 and 9 in their Hopper design: y, xn, dx, dγ and dβ within
    2e-2 of the plain versions, finite, one launch each; kernel 9 writes one
    dγ/dβ partial row a 64-row cluster (the first design one a 32-row
    block: from T = 33 on the two counts differ)."""
    x, g, bt, w, dy = _ln_linear_operands(cuda, torch.bfloat16, t, 768, o,
                                          seed=t + o)
    before = dict(_build.LAUNCHES)
    y = fused_ln_linear_fwd_cuda(x, g, bt, w)
    got = fused_ln_linear_bwd_cuda(x, dy, g, bt, w)
    torch.cuda.synchronize()
    for name in ("fused_ln_linear", "fused_ln_linear_bwd"):
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1
    assert y.shape == (t, o) and bool(torch.isfinite(y).all())
    assert _rel(y, fused_ln_linear_fwd_plain(x, g, bt, w)) <= 2e-2
    want = fused_ln_linear_bwd_plain(x, dy, g, bt, w)
    for name, a, b in zip(("xn", "dx", "dg", "dbt"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= 2e-2, name
    lib = _build.library()
    assert lib.lafs_ln_linear_bwd_partial_rows(t, 768, o, 1) == -(-t // 64)
    assert lib.lafs_ln_linear_bwd_partial_rows(t, 768, o, 0) == -(-t // 32)
    assert lib.lafs_ln_linear_bwd_partial_rows(t, 768, 100, 1) == -(-t // 32)
    assert lib.lafs_ln_linear_bwd_partial_rows(t, 128, o, 1) == -(-t // 32)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t", [1, 65, 333])
def test_fused_ln_linear_first_design_matches_plain_at_o_100(cuda, dtype,
                                                             tol, t):
    """O = 100 (not a multiple of 8) at D = 768 keeps the first design in
    both dtypes: y, xn, dx, dγ and dβ within tolerance."""
    x, g, bt, w, dy = _ln_linear_operands(cuda, dtype, t, 768, 100, seed=t)
    y = fused_ln_linear_fwd_cuda(x, g, bt, w)
    got = fused_ln_linear_bwd_cuda(x, dy, g, bt, w)
    torch.cuda.synchronize()
    assert _rel(y, fused_ln_linear_fwd_plain(x, g, bt, w)) <= tol
    for name, a, b in zip(("xn", "dx", "dg", "dbt"), got,
                          fused_ln_linear_bwd_plain(x, dy, g, bt, w)):
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= tol, name


# The profiler's names of the LN + linear kernels that one forward and
# backward launches at (dtype, D, O). The tests that read the profiler's
# device trace run it in a fresh process: on the H100, a torch.profiler
# session recorded no device events in a process that had run a session
# before, once another process (one of this file's children) had run one.
DESIGN_NAMES = """
import json, sys, numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from lafs_cvpr2024_tpu_torch.ops.fused_ln_linear import fused_ln_linear
out = {}
for dtype, d, o in ((torch.bfloat16, 768, 2112), (torch.bfloat16, 768, 100),
                    (torch.bfloat16, 128, 192), (torch.float32, 768, 2112)):
    rng = np.random.default_rng(5)
    x, g, bt, w, dy = (torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
                       for a in (rng.standard_normal((130, d)),
                                 1.0 + 0.1 * rng.standard_normal(d),
                                 0.1 * rng.standard_normal(d),
                                 rng.standard_normal((o, d)) / np.sqrt(d),
                                 rng.standard_normal((130, o))))
    leaves = [a.requires_grad_() for a in (x, g, bt, w)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = fused_ln_linear(*leaves)
        torch.autograd.grad(y, leaves, dy)
        torch.cuda.synchronize()
    out[f"{dtype} {d} {o}"] = sorted(
        {e.key for e in prof.key_averages() if "ln_linear" in e.key})
print(json.dumps(out))
"""


def _child(cuda, script, *args):
    """Run ``script`` in a fresh Python process on the card from the
    repository root, the kernel library built first: its run."""
    import os
    import subprocess
    import sys

    _build.library()  # built once here, loaded by the child
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (root, os.environ.get("PYTHONPATH")))))
    run = subprocess.run([sys.executable, "-c", script, *args], cwd=root,
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    return run


def test_fused_ln_linear_runs_the_hopper_design_only_where_it_takes(cuda):
    """By the profiler's kernel names: bf16 at D 768, O 2,112 launches the
    Hopper kernels, O = 100, D = 128 and fp32 the first design's, and no
    call launches both."""
    import json

    names = json.loads(_child(cuda, DESIGN_NAMES).stdout.splitlines()[-1])
    hop = names.pop("torch.bfloat16 768 2112")
    assert any("ln_linear_fwd_sm90" in k for k in hop)
    assert any("ln_linear_bwd_sm90" in k for k in hop)
    assert not any("bf16_kernel" in k for k in hop)
    for first in names.values():
        assert first and not any("sm90" in k for k in first)


# A first backward whose first node is one of the port's kernels that
# encode a tensor map (kernel 3, 5 or 9), in a fresh process: autograd's
# worker thread then makes its first CUDA call through the kernel library,
# with no context current to the thread yet; with and without a
# torch.profiler session before it.
FIRST_BACKWARD = """
import sys, torch
from torch.profiler import ProfilerActivity, profile
from lafs_cvpr2024_tpu_torch import _build
from lafs_cvpr2024_tpu_torch.ops.fused_ln_linear import FusedLNLinear
from lafs_cvpr2024_tpu_torch.ops.fused_mlp import FusedLNMLP, FusedMLP
op, profiled = sys.argv[1], sys.argv[2] == "1"
if profiled:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (torch.ones(4, device="cuda") * 2).sum().item()
        torch.cuda.synchronize()
gen = torch.Generator(device="cuda").manual_seed(0)
def leaf(*shape):
    t = torch.randn(*shape, device="cuda", generator=gen) * 0.05
    return t.bfloat16().requires_grad_()
if op == "ln_mlp":
    leaves = [leaf(130, 768), leaf(768), leaf(768), leaf(2048, 768),
              leaf(2048), leaf(768, 2048), leaf(768)]
    y = FusedLNMLP.apply(*leaves, 1e-5, 0.0, 1)
elif op == "mlp":
    leaves = [leaf(130, 768), leaf(2048, 768), leaf(2048), leaf(768, 2048),
              leaf(768)]
    y = FusedMLP.apply(*leaves, 0.0, 1)
else:
    leaves = [leaf(130, 768), leaf(768), leaf(768), leaf(2112, 768)]
    y = FusedLNLinear.apply(*leaves, 1e-5)
grads = torch.autograd.grad(y, leaves, torch.ones_like(y))
torch.cuda.synchronize()
assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
name = {"ln_mlp": "fused_ln_mlp_bwd", "mlp": "fused_mlp_bwd",
        "ln_linear": "fused_ln_linear_bwd"}[op]
assert _build.LAUNCHES[name] == 1, dict(_build.LAUNCHES)
"""


@pytest.mark.parametrize("profiled", [True, False])
@pytest.mark.parametrize("op", ["ln_mlp", "mlp", "ln_linear"])
def test_first_backward_in_a_fresh_process_runs_the_cluster_kernel(
        cuda, op, profiled):
    _child(cuda, FIRST_BACKWARD, op, str(int(profiled)))


def test_simmim_model_kernel_configuration_matches_plain(cuda):
    """A small SimMIM Part-fViT on the card in fp32, training mode at rate
    0 with a mask: the kernel configuration (``fused`` MLP, ``lnqkv``
    attention) against the plain one, the tokens within 1e-4 and every
    parameter gradient at cosine ≥ 1 − 1e-5, with kernels 4, 5, 8 and 9
    launched once per layer each."""
    arch = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256,
                num_patches=36, image_size=48, with_land=False, simmim=True,
                loss_type="None", num_classes=0, dropout=0.0,
                emb_dropout=0.0, drop_path_rate=0.0)
    state = init_random_(PartFViT(PartFViTConfig(**arch)), 0).state_dict()
    tokens = torch.rand(4, 36, 192, device=cuda) - 0.5
    mask = (torch.rand(4, 36, device=cuda) < 0.6).float()
    outs = []
    for impls in (("fused", "lnqkv"), ("dense", "einsum")):
        m = PartFViT(PartFViTConfig(**arch, mlp_impl=impls[0],
                                    attn_impl=impls[1]))
        m.load_state_dict(state)
        m = m.train().to(cuda)
        before = dict(_build.LAUNCHES)
        _, tok, _ = m(tokens, mask=mask, return_tokens=True)
        tok.square().sum().backward()
        torch.cuda.synchronize()
        launched = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                    if v != before.get(k, 0)}
        outs.append((tok.detach(), {n: p.grad for n, p in m.named_parameters()
                                    if p.grad is not None}, launched))
    (tk, gk, lk), (tp, gp, lp) = outs
    assert lk == {"fused_mlp": 2, "fused_mlp_bwd": 2, "fused_ln_linear": 2,
                  "fused_ln_linear_bwd": 2} and lp == {}
    assert _rel(tk, tp) <= 1e-4
    assert set(gk) == set(gp)
    for n in gp:
        cos = torch.nn.functional.cosine_similarity(
            gk[n].double().flatten(), gp[n].double().flatten(), dim=0)
        assert cos.item() >= 1 - 1e-5, n


# --------------------------------------------- kernels 11a-c (flash) --

# every tail width of the last 64-row tile (16, 32, 48, 64 rows: 11a's and
# 11c's last key block, 11b's last query tile and its ragged key tile),
# the single-tile path (N <= 64) and several tiles, at H = 11; past four
# tiles (193, 208 with a full last 16, 256, 257 with one row) and long N
FLASH_SHAPES = [(3, 2, 1), (3, 2, 37), (2, 3, 64), (2, 3, 128), (2, 3, 130),
                (4, 11, 197), (2, 2, 600), (1, 2, 1024), (2, 11, 16),
                (2, 11, 17), (2, 11, 48), (2, 11, 49), (2, 11, 63),
                (2, 11, 65), (3, 11, 197), (2, 3, 193), (2, 3, 208),
                (2, 2, 256), (2, 2, 257)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,n", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda, dtype, tol, b, h, n):
    """Kernel 11a on strided views, any N: O and the fp32 logsumexp within
    tolerance of the plain version; O is a view of a (B, N, H, D) tensor."""
    q, k, v, _ = _attn_operands(cuda, dtype, b, h, n, seed=7)
    scale = 768 ** -0.5 * 4.0
    before = _build.LAUNCHES["flash_attention"]
    got, lse = flash_attention_fwd_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    want, lse_want = flash_attention_plain(q, k, v, scale)
    assert got.dtype == dtype and got.shape == want.shape == (b, h, n, 64)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, n)
    assert got.transpose(1, 2).is_contiguous()
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= tol
    assert _rel(lse, lse_want) <= 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,n", FLASH_SHAPES)
def test_flash_attention_bwd_kernels_match_plain(cuda, dtype, tol, b, h, n):
    """Kernels 11b (dK, dV) and 11c (dQ) against the plain backward on the
    same O and lse, each launched once."""
    q, k, v, do = _attn_operands(cuda, dtype, b, h, n, seed=8)
    scale = 768 ** -0.5 * 4.0
    o, lse = flash_attention_plain(q, k, v, scale)
    before = dict(_build.LAUNCHES)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape == (b, h, n, 64), name
        assert bool(torch.isfinite(a).all()), name
        if n == 1 and name != "dv":
            # softmax over one key is constant: dQ and dK are 0 but for
            # rounding (dp - di), in both versions; held to dV's scale
            assert a.abs().max() <= tol * want[2].abs().max(), name
        else:
            assert _rel(a, w) <= tol, name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,n", [(3, 2, 1), (3, 2, 37), (2, 3, 130),
                                   (4, 11, 197), (2, 3, 208), (2, 2, 257)])
def test_flash_attention_bwd_kernels_match_their_twins(cuda, dtype, tol, b,
                                                        h, n):
    """11c's dQ and statistics scratch against
    ``flash_attention_bwd_dq_plain`` (real rows: lse·log2 e and di within
    1e-5; padded rows exactly +inf and 0), and 11b on that scratch against
    ``flash_attention_bwd_dkv_plain``; lse read in place from a strided
    view."""
    q, k, v, do = _attn_operands(cuda, dtype, b, h, n, seed=9)
    scale = 768 ** -0.5 * 4.0
    o, lse = flash_attention_plain(q, k, v, scale)
    lse_view = torch.empty(b, n, h, device=cuda).transpose(1, 2)
    lse_view.copy_(lse)
    dq, stats = flash_attention_bwd_dq_cuda(q, k, v, o, do, lse_view, scale)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, stats, scale)
    torch.cuda.synchronize()
    dq_w, stats_w = flash_attention_bwd_dq_plain(q, k, v, o, do, lse, scale)
    dk_w, dv_w = flash_attention_bwd_dkv_plain(q, k, v, do, stats_w, scale)
    assert stats.shape == stats_w.shape == (b * h, -(-n // 64), 2, 64)
    got = stats.permute(0, 2, 1, 3).reshape(b * h, 2, -1)
    want = stats_w.permute(0, 2, 1, 3).reshape(b * h, 2, -1)
    for i in (0, 1):
        assert _rel(got[:, i, :n], want[:, i, :n]) <= 1e-5, i
    assert bool((got[:, 0, n:] == float("inf")).all())
    assert bool((got[:, 1, n:] == 0).all())
    for name, a, w in (("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)):
        assert a.dtype == dtype and a.shape == (b, h, n, 64), name
        assert bool(torch.isfinite(a).all()), name
        if n == 1 and name != "dv":
            assert a.abs().max() <= tol * dv_w.abs().max(), name
        else:
            assert _rel(a, w) <= tol, name


@pytest.mark.parametrize("b,h,n", [(4, 11, 197), (2, 3, 65), (2, 2, 257)])
def test_flash_attention_bwd_kernels_stay_finite_at_logits_80(cuda, b, h, n):
    """bf16 with the largest |logit| at 80 and a ragged last tile (a peaked
    softmax whose padded rows and keys could overflow): dQ, dK, dV finite
    and within 2e-2 of the plain backward."""
    q, k, v, do = _attn_operands(cuda, torch.bfloat16, b, h, n)
    scale = _attn_scale(q, k, 80.0)
    o, lse = flash_attention_plain(q, k, v, scale)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, w) <= 2e-2, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernels_are_deterministic(cuda, dtype):
    """Two launches of 11c and of 11b on the same inputs give the same bits
    (no atomics: each output element is summed by one block in order)."""
    q, k, v, do = _attn_operands(cuda, dtype, 4, 11, 197, seed=5)
    o, lse = flash_attention_plain(q, k, v, 0.1)
    runs = []
    for _ in range(2):
        dq, stats = flash_attention_bwd_dq_cuda(q, k, v, o, do, lse, 0.1)
        runs.append((dq, stats, *flash_attention_bwd_dkv_cuda(
            q, k, v, do, stats, 0.1)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# One flash_attention_bwd_cuda call under the profiler, in a fresh process
# (see DESIGN_NAMES): its launch counts and its device kernels in order.
FLASH_BWD_TRACE = """
import json, sys, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, "tests")
from test_torch_cuda_kernels import _attn_operands
from lafs_cvpr2024_tpu_torch import _build
from lafs_cvpr2024_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_cuda, flash_attention_plain)
q, k, v, do = _attn_operands(torch.device("cuda"), torch.bfloat16, 4, 11, 197)
o, lse = flash_attention_plain(q, k, v, 0.1)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    flash_attention_bwd_cuda(q, k, v, o, lse, do, 0.1)
    torch.cuda.synchronize()
kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
print(json.dumps({"launches": dict(_build.LAUNCHES),
                  "names": [e.name for e in kernels]}))
"""


def test_flash_attention_bwd_runs_11c_then_11b_and_nothing_else(cuda):
    """``flash_attention_bwd_cuda`` on the card: one launch of 11c, then one
    of 11b, and no other kernel (no plain-PyTorch di pass), by the
    profiler's device trace and the launch counts."""
    import json

    got = json.loads(_child(cuda, FLASH_BWD_TRACE).stdout.splitlines()[-1])
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert got["launches"].get(name) == 1, name
    names = got["names"]
    assert len(names) == 2, names
    assert "flash_bwd_dq_bf16" in names[0] and "flash_bwd_dkv_bf16" in names[1]


def test_flash_attention_autograd_launches_all_kernels(cuda):
    """FlashAttention on the card: 11a forward, 11b and 11c backward, the
    gradients within 1e-5 of the same function run on the CPU (plain), and
    the same bits from two runs (no atomics)."""
    q, k, v, do = _attn_operands(cuda, torch.float32, 2, 3, 150)
    grads = []
    for dev in (cuda, cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        before = dict(_build.LAUNCHES)
        flash_attention(*leaves, 0.1).backward(do.to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            for name in ("flash_attention", "flash_attention_bwd_dkv",
                         "flash_attention_bwd_dq"):
                assert _build.LAUNCHES[name] == before.get(name, 0) + 1
        grads.append([t.grad.cpu() for t in leaves])
    for a, b, c in zip(*grads):
        assert torch.equal(a, b)
        assert _rel(a, c) <= 1e-5


def test_flash_attention_kernel_refuses_shapes_it_does_not_take(cuda):
    y = torch.zeros(1, 2, 16, 32, device=cuda)
    with pytest.raises(ValueError, match="D = 64"):
        flash_attention(y, y, y, 0.1)
    x = torch.zeros(1, 2, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="fp32"):
        flash_attention_bwd_dq_cuda(x, x, x, x, x, torch.zeros(
            1, 2, 16, device=cuda, dtype=torch.bfloat16), 0.1)
    with pytest.raises(ValueError, match="fp32"):
        flash_attention_bwd_dkv_cuda(x, x, x, x, torch.zeros(
            2, 1, 2, 32, device=cuda), 0.1)


# ------------------------------------------------ the card's JPEG decode --

def test_prefetcher_batches_under_load_match_plain_decode(cuda):
    """The prefetcher decodes on a side stream two batches ahead; with the
    default stream kept busy, as a training step keeps it, every batch it
    hands out equals a plain decode of the same records on the default
    stream (nvJPEG's queued copies once ran late and mixed images up)."""
    from pathlib import Path

    from lafs_cvpr2024_tpu_torch.data.dataset import FaceRecordDataset
    from lafs_cvpr2024_tpu_torch.data.decode import decode_batch
    from lafs_cvpr2024_tpu_torch.data.pipeline import EpochSampler, Prefetcher

    rec = Path(__file__).resolve().parent / "data" / "ssl_rec" / "train.rec"
    ds = FaceRecordDataset(str(rec))
    jpegs, _ = ds.fetch_batch(range(len(ds)))
    ref = decode_batch(jpegs, cuda)
    assert ref.shape == (64, 112, 112, 3) and ref.dtype == torch.uint8
    sampler = EpochSampler(len(ds), 16, seed=1)
    busy = torch.randn(8192, 8192, device=cuda)
    for epoch in range(2):
        idx = torch.as_tensor(sampler.epoch_indices(epoch), device=cuda)
        for it, (imgs, _) in enumerate(Prefetcher(ds, sampler, cuda)
                                       .epoch(epoch)):
            busy = busy @ busy
            busy = busy / busy.norm()
            assert torch.equal(imgs, ref[idx[16 * it:16 * it + 16]])


# ------------------------------------- row 10: the bias-free fused MLP --

def _mlp_fusion_operands(cuda, t, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((t, 768)).astype(np.float32))
    w1, w2 = mlp_fusion_weights_from_jax(
        rng.standard_normal((768, 2048)) * 0.02,
        rng.standard_normal((2048, 768)) * 0.02, cuda)
    return x.to(cuda, torch.bfloat16), w1, w2


# the cluster's 64-row tile, the TPU hash's 256-row tile and their edges,
# a ragged T and the microbenchmark's two
@pytest.mark.parametrize("t", [1, 63, 64, 65, 255, 256, 257, 300, 22016,
                               22080])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_mlp_fusion_kernel_matches_plain(cuda, t, rate):
    x, w1, w2 = _mlp_fusion_operands(cuda, t, t)
    before = _build.LAUNCHES["mlp_fusion"]
    got = mlp_fusion(x, w1, w2, rate, 77)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mlp_fusion"] == before + 1
    want = mlp_fusion_plain(x, w1, w2, rate=rate, seed=77)
    assert got.dtype == torch.bfloat16 and got.shape == (t, 768)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 2e-2
    # the output draw: zeros where the plain version's mask drops
    assert torch.equal(got == 0, want == 0)
    if rate and t >= 255:  # enough elements for the keep fraction
        assert abs((got != 0).float().mean().item() - 0.9) <= 0.01


def test_mlp_fusion_masks_are_the_plain_versions_bit_for_bit(cuda):
    """x = 1 and W1 = 1/16 make every hidden pre-activation 48 (GELU(48) =
    48 in fp32); a one-hot W2 routes hidden unit off + c to output column
    c. Each output element is then one hidden element, dropped or scaled,
    with no rounding between the two versions: the outputs are equal bit
    for bit iff the hidden and output masks agree (the hidden mask wherever
    the output draw keeps); three offsets cover the 2048 hidden units."""
    t = 300
    x = torch.ones(t, 768, device=cuda, dtype=torch.bfloat16)
    w1 = torch.full((768, 2048), 1 / 16, device=cuda, dtype=torch.bfloat16)
    for off in (0, 768, 1280):
        w2 = torch.zeros(2048, 768, device=cuda, dtype=torch.bfloat16)
        cols = torch.arange(768, device=cuda)
        w2[cols + off, cols] = 1.0
        got = mlp_fusion_cuda(x, w1, w2, rate=0.1, seed=5)
        want = mlp_fusion_plain(x, w1, w2, rate=0.1, seed=5)
        assert torch.equal(got, want)
        assert 0.75 < (got != 0).float().mean().item() < 0.87  # 0.9 · 0.9


def test_mlp_fusion_kernel_refuses_what_it_does_not_take(cuda):
    x, w1, w2 = _mlp_fusion_operands(cuda, 8, 0)
    with pytest.raises(TypeError, match="bfloat16"):
        mlp_fusion_cuda(x.float(), w1, w2)
    with pytest.raises(ValueError, match="do not form an MLP"):
        mlp_fusion_cuda(x, w1.t(), w2)
    # the widths the kernel no longer takes: D other than 768, H not a
    # multiple of 256
    for d, h in ((128, 256), (640, 2048), (768, 128), (768, 384)):
        with pytest.raises(ValueError, match="takes D = 768"):
            mlp_fusion_cuda(x[:, :d].contiguous(),
                            w1[:d, :h].contiguous(), w2[:h, :d].contiguous())
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(8 * 768 + 1, device=cuda, dtype=torch.bfloat16)
        mlp_fusion_cuda(flat[1:].view(8, 768), w1, w2)


# ----------------------------------------------- the card's face warp --

def test_warp_affine_batch_on_card_equals_cpu(cuda):
    from lafs_cvpr2024_tpu_torch.ops.warp import warp_affine_batch

    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (5, 150, 130, 3),
                                         dtype=np.uint8))
    mats = np.zeros((5, 2, 3))
    for i in range(4):
        a, s = rng.uniform(-0.4, 0.4), rng.uniform(0.5, 1.5)
        mats[i, :, :2] = s * np.array([[np.cos(a), -np.sin(a)],
                                       [np.sin(a), np.cos(a)]])
        mats[i, :, 2] = rng.uniform(-40, 10, 2)
    mats[4] = np.nan
    got = warp_affine_batch(imgs.to(cuda), mats, 112).cpu()
    want = warp_affine_batch(imgs, mats, 112)
    assert (got != want).float().mean().item() == 0.0
    assert not got[4].any() and got[:4].any()


def test_decode_warp_batch_on_card_within_a_level_of_norm_crop(cuda):
    from pathlib import Path

    from lafs_cvpr2024_tpu_torch.eval.ijb import ARCFACE_SRC, umeyama
    from lafs_cvpr2024_tpu_torch.ops.warp import decode_warp_batch

    root = Path(__file__).resolve().parent / "data" / "ijb_mini"
    meta = root / "meta" / "ijbc_name_5pts_score.txt"
    names = [line.split()[0] for line in meta.read_text().splitlines()]
    lms = np.loadtxt(meta, usecols=range(1, 11),
                     dtype=np.float32).reshape(-1, 5, 2)
    ref = np.load(root / "aligned_ref.npz")["aligned"]
    n = len(ref)
    jpegs = [(root / "loose_crop" / name).read_bytes() for name in names[:n]]
    mats = np.stack([umeyama(lm, ARCFACE_SRC)[:2] for lm in lms[:n]])
    got = decode_warp_batch(jpegs, mats, cuda).cpu().numpy()
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert got.shape == ref.shape and diff.mean() <= 1.0
