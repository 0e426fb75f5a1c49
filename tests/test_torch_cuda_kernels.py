"""PyTorch port: the CUDA kernels against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither jax nor the JAX package, so it runs on a machine that has only
PyTorch and the CUDA toolkit; ``tests/conftest.py`` imports jax, so run it
there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the gather agrees to 1e-5 in fp32 and to one bf16 ulp in bf16
(the same four-corner sum, contracted to FMAs by nvcc); the MLP to 1e-4
relative in fp32 and 2e-2 in bf16 (both accumulate in fp32 in another
order, and a 1-ulp flip of the bf16 hidden activation moves the output).
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
from lafs_cvpr2024_tpu_torch.ops.fused_mlp import (
    fused_ln_mlp,
    fused_ln_mlp_plain,
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
    return ((got - want).abs().max() / want.abs().max()).item()


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
    want = fused_ln_mlp_plain(*ops)
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= tol


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
