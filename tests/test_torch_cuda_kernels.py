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
output), with and without the LayerNorm (kernels 2-5), and so do the
LN-fused linear's forward and backward (kernels 8 and 9) at any output
width O. Dropout masks are the same bits: the kernels and the plain
versions hash the same keys. The fused attention forward and backward
agree to 1e-5 relative in fp32 and 2e-2 in bf16 (fp32 logits and softmax in
both; the products accumulate in another order, and bf16 A and dS may
round one ulp apart). So do the flash attention forward and its two
backward kernels (11a-c) at any length N, the logsumexp within 1e-5. The
bias-free fused MLP of row 10 agrees to 2e-2 in bf16 (its only dtype) at a
ragged T and at the microbenchmark's, and where its arithmetic is exact
(one-hot W2, a constant hidden layer) its output equals the plain
version's bit for bit at rate 0.1, which holds both dropout masks. The
batched face warp on the card equals its run on the CPU (the numpy warp's
arithmetic, in float64), and the card's decode and warp of the mini IJB
fixture lie within a mean of 1 level of the numpy ``norm_crop`` of PIL's
decode.
"""

import numpy as np
import pytest
import torch

from lafs_cvpr2024_tpu_torch import _build
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
    flash_attention_bwd_dq_cuda,
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,s", [(3, 2, 1), (3, 2, 37), (2, 3, 128),
                                   (2, 3, 130), (4, 11, 197), (2, 2, 257),
                                   (2, 2, 512)])
def test_fused_attention_kernel_matches_plain(cuda, dtype, tol, b, h, s):
    """Kernel 6 on strided views, ragged S: O within tolerance of the
    plain version; the result is a view of a (B, S, H, D) tensor."""
    q, k, v, _ = _attn_operands(cuda, dtype, b, h, s)
    scale = 768 ** -0.5 * 4.0  # logits of a few units: a peaked softmax
    before = _build.LAUNCHES["fused_attention"]
    got = fused_attention_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_attention"] == before + 1
    want = fused_attention_plain(q, k, v, scale)
    assert got.dtype == dtype and got.shape == want.shape == (b, h, s, 64)
    assert got.transpose(1, 2).is_contiguous()
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,s", [(3, 2, 1), (3, 2, 37), (2, 3, 128),
                                   (2, 3, 130), (4, 11, 197), (2, 2, 257),
                                   (2, 2, 512)])
def test_fused_attention_bwd_kernel_matches_plain(cuda, dtype, tol, b, h, s):
    """Kernel 7: dQ, dK and dV within tolerance of the plain version."""
    q, k, v, do = _attn_operands(cuda, dtype, b, h, s)
    scale = 768 ** -0.5 * 4.0
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

FLASH_SHAPES = [(3, 2, 1), (3, 2, 37), (2, 3, 64), (2, 3, 128), (2, 3, 130),
                (4, 11, 197), (2, 2, 600), (1, 2, 1024)]


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
        flash_attention_bwd_dq_cuda(x, x, x, x, torch.zeros(1, 2, 16,
                                    device=cuda, dtype=torch.bfloat16),
                                    torch.zeros(1, 2, 16, device=cuda), 0.1)


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


@pytest.mark.parametrize("t", [300, 22016])
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
    if rate:
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
