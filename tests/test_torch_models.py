"""PyTorch port: models (MobileNetV3 stem, landmark regressor, Part-fViT).

One JAX Part-fViT (depth 2, dim 128, 2 heads × 64, mlp 256, 36 landmarks
on 48×48 images, MobileNetV3-large stem) is initialised once per module;
its tree goes through ``state_dict_from_flax`` into the port's modules
with ``load_state_dict(strict=True)``, and both packages run the same
numpy inputs in fp32. Embeddings must agree to cosine ≥ 1 − 1e-5.

Part-fViT-B's eval forward (every width as served, 12 blocks) with its
attention ``'fused'`` (kernel 6's plain version here) agrees with
``'einsum'`` on the same weights to 1e-5 relative in fp32 (measured
≤ 5.7e-7) and to cosine ≥ 1 − 2e-4 a row in bf16 (measured ≤ 5.2e-5 over
three seeds: the einsum path rounds scores and probabilities to bf16, the
fused one keeps them fp32). ``'fused'`` takes the kernel only at 128 to
512 tokens in heads of 64; elsewhere it runs the einsum path itself
(``tests/test_torch_eval.py`` counts ``attn.fused_fallback`` there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lafs_cvpr2024_tpu.models.mobilenet import (
    MobileNetV3Backbone as JaxBackbone,
)
from lafs_cvpr2024_tpu.models.partfvit import LandmarkRegressor as JaxRegressor
from lafs_cvpr2024_tpu.models.partfvit import PartFViT as JaxPartFViT
from lafs_cvpr2024_tpu.models.partfvit import PartFViTConfig as JaxConfig
from lafs_cvpr2024_tpu_torch.models import layers
from lafs_cvpr2024_tpu_torch.models.partfvit import (
    LandmarkRegressor,
    PartFViT,
    PartFViTConfig,
    init_random_,
    minmax_rescale_landmarks,
)
from lafs_cvpr2024_tpu_torch.train.checkpoint import (
    state_dict_from_flax,
    to_tensors,
)

ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256,
            num_patches=36, image_size=48, stn_mode="large",
            loss_type="None", num_classes=0)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


@pytest.fixture(scope="module")
def jax_model():
    """(JAX model, numpy variables with non-trivial BN stats, images)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.5, 0.5, (3, 48, 48, 3)).astype(np.float32)
    model = JaxPartFViT(JaxConfig(**ARCH))
    v = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    # running stats away from (0, 1) so eval-mode BN is really exercised
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda s: (s + rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
                   if s.min() >= 1.0 else
                   0.1 * rng.standard_normal(s.shape).astype(np.float32)),
        v["batch_stats"])
    return model, v, x


def _jax_embed(model, v, x):
    return jax.jit(lambda v, x: model.apply(v, x, train=False))(
        v, jnp.asarray(x))


def _port(v, **cfg):
    model = PartFViT(PartFViTConfig(**{**ARCH, **cfg})).eval()
    model.load_state_dict(
        to_tensors(state_dict_from_flax(v["params"], v["batch_stats"])),
        strict=True)
    return model


def test_mobilenet_stem_matches_jax(jax_model):
    _, v, x = jax_model
    lv = {"params": v["params"]["landmark"]["stn"],
          "batch_stats": v["batch_stats"]["landmark"]["stn"]}
    want = np.asarray(jax.jit(JaxBackbone("large").apply)(lv, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(v).stn(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 2, 2, 160)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_landmark_regressor_theta_matches_jax(jax_model):
    _, v, x = jax_model
    lv = {"params": v["params"]["landmark"],
          "batch_stats": v["batch_stats"]["landmark"]}
    want, _ = jax.jit(JaxRegressor(36, None, "large", 47.0).apply)(
        lv, jnp.asarray(x))
    reg = LandmarkRegressor(36, "large", 47.0).eval()
    sd = state_dict_from_flax(v["params"], v["batch_stats"])
    reg.load_state_dict(
        to_tensors({k: a for k, a in sd.items()
                    if k.startswith(("stn.", "output_layer."))}),
        strict=True)
    with torch.no_grad():
        got, pooled = reg(torch.from_numpy(x))
    assert got.shape == (3, 36, 2) and pooled.shape == (3, 160)
    # pixels in [0, 47]: 1e-4 px is far below any patch-sampling effect
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_minmax_rescale_spans_the_frame():
    theta = torch.tensor([[3.0, -1.0, 5.0, 1.0]])
    got = minmax_rescale_landmarks(theta, 2, 111.0)
    assert torch.allclose(got, torch.tensor([[[74.0, 0.0], [111.0, 37.0]]]))


@pytest.mark.parametrize("gather_impl,mlp_impl",
                         [("kernel", "fused_ln"), ("gather", "dense")])
def test_partfvit_embedding_matches_jax(jax_model, gather_impl, mlp_impl):
    model, v, x = jax_model
    want = np.asarray(_jax_embed(model, v, x))
    port = _port(v, gather_impl=gather_impl, mlp_impl=mlp_impl)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 128)
    assert _cos(got, want).min() >= 1 - 1e-5


def test_partfvit_token_path_matches_jax(jax_model):
    model, v, _ = jax_model
    tokens = np.random.default_rng(1).standard_normal(
        (2, 36, 192)).astype(np.float32)
    want = np.asarray(_jax_embed(model, v, tokens))
    with torch.no_grad():
        got = _port(v)(torch.from_numpy(tokens)).numpy()
    assert _cos(got, want).min() >= 1 - 1e-5


@pytest.mark.parametrize("field", ["use_global_token", "use_standcoord"])
def test_unported_variants_raise(field):
    with pytest.raises(NotImplementedError, match="not ported"):
        PartFViT(PartFViTConfig(**{**ARCH, "with_land": False, field: True}))


def test_eval_only_and_unported_impls_raise():
    """The image path is no longer eval only (it trains with the landmark
    branch); what is still not ported raises: the x_noaug, random_prob and
    glo_diff forward options, other margin heads, the packed attention
    impls (measured-negative in the JAX package, not to port)."""
    model = PartFViT(PartFViTConfig(**ARCH))
    for opt in (dict(random_prob=True), dict(glo_diff=True),
                dict(x_noaug=torch.zeros(1, 48, 48, 3))):
        with pytest.raises(NotImplementedError, match="not ported"):
            model(torch.zeros(1, 48, 48, 3), **opt)
    with pytest.raises(NotImplementedError, match="ArcFace"):
        PartFViT(PartFViTConfig(**{**ARCH, "loss_type": "ArcFace"}))
    with pytest.raises(NotImplementedError, match="attn_impl"):
        PartFViT(PartFViTConfig(**ARCH, attn_impl="packed_av"))


def test_init_random_is_seeded_and_finite():
    cfg = PartFViTConfig(**{**ARCH, "stn_mode": "small"})
    a = init_random_(PartFViT(cfg), seed=3).state_dict()
    b = init_random_(PartFViT(cfg), seed=3).state_dict()
    c = init_random_(PartFViT(cfg), seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["cls_token"], c["cls_token"])
    emb = PartFViT(cfg).eval()
    emb.load_state_dict(a)
    with torch.no_grad():
        out = emb(torch.rand(2, 48, 48, 3) - 0.5)
    assert out.shape == (2, 128) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_eval_forward_matches_einsum_at_full_width(dtype):
    cfg = dict(loss_type="None", num_classes=0)  # Part-fViT-B as served
    state = init_random_(PartFViT(PartFViTConfig(**cfg)), seed=7).state_dict()
    x = torch.rand(2, 112, 112, 3, generator=torch.Generator().manual_seed(5))
    out = {}
    for impl in ("fused", "einsum"):
        model = PartFViT(PartFViTConfig(**cfg, attn_impl=impl))
        model.load_state_dict(state, strict=True)
        model.eval().to(dtype)
        with torch.inference_mode():
            out[impl] = model((x - 0.5).to(dtype)).double()
    got, want = out["fused"], out["einsum"]
    assert got.shape == (2, 768) and bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    else:
        assert _cos(got.numpy(), want.numpy()).min() >= 1 - 2e-4


@pytest.mark.parametrize("dim_head,n,takes", [
    (64, 150, True),    # the kernel's window and head width
    (32, 150, False),   # heads of 32 (a --dim-head checkpoint)
    (64, 100, False),   # under 128 tokens
    (64, 513, False),   # over 512
])
def test_fused_attention_falls_back_where_kernel_6_does_not_take(
        monkeypatch, dim_head, n, takes):
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    real = layers.fused_attention
    monkeypatch.setattr(layers, "fused_attention", counted)
    torch.manual_seed(0)
    fused = layers.Attention(128, 2, dim_head, attn_impl="fused").eval()
    einsum = layers.Attention(128, 2, dim_head, attn_impl="einsum").eval()
    einsum.load_state_dict(fused.state_dict())
    x = torch.randn(2, n, 128)
    with torch.inference_mode():
        got, want = fused(x), einsum(x)
    assert len(calls) == int(takes)
    if takes:
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    else:
        assert torch.equal(got, want)
