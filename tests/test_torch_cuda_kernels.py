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
output). Dropout masks are the same bits: the kernels and the plain
versions hash the same keys. The fused attention forward and backward
agree to 1e-5 relative in fp32 and 2e-2 in bf16 (fp32 logits and softmax in
both; the products accumulate in another order, and bf16 A and dS may
round one ulp apart).
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
from lafs_cvpr2024_tpu_torch.ops.fused_mlp import (
    FusedLNMLP,
    dropout_mask,
    fused_ln_mlp,
    fused_ln_mlp_bwd_cuda,
    fused_ln_mlp_bwd_plain,
    fused_ln_mlp_fwd_cuda,
    fused_ln_mlp_fwd_plain,
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
