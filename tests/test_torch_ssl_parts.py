"""PyTorch port: the parts of the SSL step against the JAX package.

Each part takes the same numpy inputs and weights on both sides, in fp32 on
the CPU: the DINO head, ``dino_loss`` (loss and new center), the landmark
provider (jitter 0, no resampling), the train-mode Part-fViT token path at
every dropout and drop-path rate 0, and the optimizer tail. Tolerances:
1e-5 relative for the forwards (summation order only), 1e-6 absolute for
one optimizer update (fp32 elementwise math on values of order 1). The
dropout modules are checked by their keep fractions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lafs_cvpr2024_tpu.models.heads import DINOHead as JaxDINOHead
from lafs_cvpr2024_tpu.models.partfvit import LandmarkProvider as JaxProvider
from lafs_cvpr2024_tpu.models.partfvit import PartFViT as JaxPartFViT
from lafs_cvpr2024_tpu.models.partfvit import PartFViTConfig as JaxConfig
from lafs_cvpr2024_tpu.train import optim as jax_optim
from lafs_cvpr2024_tpu.train.checkpoint import export_torch_state_dict
from lafs_cvpr2024_tpu.train.losses import dino_loss as jax_dino_loss
from lafs_cvpr2024_tpu_torch.models.heads import DINOHead
from lafs_cvpr2024_tpu_torch.models.layers import (
    DropoutRNG,
    FastDropout,
    drop_path,
)
from lafs_cvpr2024_tpu_torch.models.partfvit import (
    LandmarkProvider,
    PartFViT,
    PartFViTConfig,
)
from lafs_cvpr2024_tpu_torch.ops.patch_gather import patch_gather
from lafs_cvpr2024_tpu_torch.train import optim
from lafs_cvpr2024_tpu_torch.train.checkpoint import (
    state_dict_from_flax,
    to_tensors,
)
from lafs_cvpr2024_tpu_torch.train.losses import dino_loss

ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256,
            num_patches=36, image_size=48, stn_mode="small",
            loss_type="None", num_classes=0)
ZERO_RATES = dict(dropout=0.0, emb_dropout=0.0, drop_path_rate=0.0)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def head_params():
    head = JaxDINOHead(in_dim=128, out_dim=64, hidden_dim=96,
                       bottleneck_dim=32)
    v = head.init(jax.random.PRNGKey(0), jnp.zeros((2, 128)))["params"]
    # a gain away from 1 so the weight norm is really exercised
    v = dict(_np(v))
    v["last_layer_g"] = np.random.default_rng(0).uniform(
        0.5, 1.5, v["last_layer_g"].shape).astype(np.float32)
    return head, v


def test_dino_head_matches_jax(head_params):
    head, v = head_params
    x = np.random.default_rng(1).standard_normal((6, 128)).astype(np.float32)
    want = np.asarray(head.apply({"params": v}, jnp.asarray(x)))
    sd = state_dict_from_flax({"head": v})
    port = DINOHead(128, 64, 96, 32)
    port.load_state_dict(
        to_tensors({k[len("head."):]: a for k, a in sd.items()}), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (6, 64)
    assert _rel(got, want) <= 1e-5


def test_state_dict_from_flax_maps_the_dino_head_as_export_does(head_params):
    _, v = head_params
    bb = _np(jax.jit(JaxPartFViT(JaxConfig(**{**ARCH, "with_land": False}))
                     .init)(jax.random.PRNGKey(1), jnp.zeros((1, 36, 192))))
    tree = {**bb["params"], "head": v}
    got = state_dict_from_flax(tree)
    want = export_torch_state_dict(tree)
    assert list(got) == list(want)
    assert {k for k in got if k.startswith("head.")} == {
        "head.mlp.0.weight", "head.mlp.0.bias", "head.mlp.2.weight",
        "head.mlp.2.bias", "head.mlp.4.weight", "head.mlp.4.bias",
        "head.last_layer.weight_g", "head.last_layer.weight_v"}
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k])


def test_dino_loss_and_center_match_jax():
    rng = np.random.default_rng(2)
    n_crops, b, k = 4, 3, 50
    student = rng.standard_normal((n_crops * b, k)).astype(np.float32)
    teacher = rng.standard_normal((2 * b, k)).astype(np.float32)
    center = 0.1 * rng.standard_normal((1, k)).astype(np.float32)
    want_loss, want_c = jax_dino_loss(jnp.asarray(student), jnp.asarray(teacher),
                                      jnp.asarray(center), jnp.float32(0.04),
                                      n_crops)
    loss, new_c = dino_loss(torch.from_numpy(student),
                            torch.from_numpy(teacher),
                            torch.from_numpy(center), 0.04, n_crops)
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert new_c.shape == (1, k)
    assert _rel(new_c.numpy(), want_c) <= 1e-5


def test_landmark_provider_matches_jax():
    """Landmarks from the clean view, patches from the augmented one."""
    rng = np.random.default_rng(3)
    clean = rng.uniform(-1, 1, (3, 48, 48, 3)).astype(np.float32)
    aug = rng.uniform(-1, 1, (3, 48, 48, 3)).astype(np.float32)
    provider = JaxProvider(num_landmarks=36, patch_size=8, stn_mode="small",
                           coord_scale=47.0)
    v = _np(jax.jit(provider.init)({"params": jax.random.PRNGKey(4)},
                                   jnp.asarray(clean)))
    theta_j, tok_j = jax.jit(lambda v, c, a: provider.apply(v, c, x_aug=a))(
        v, jnp.asarray(clean), jnp.asarray(aug))
    port = LandmarkProvider(36, 8, "small", 47.0, gather_impl="gather").eval()
    port.load_state_dict(
        to_tensors(state_dict_from_flax(v["params"], v["batch_stats"])),
        strict=True)
    with torch.no_grad():
        theta, tok = port(torch.from_numpy(clean), torch.from_numpy(aug))
    assert theta.shape == (3, 36, 2) and tok.shape == (3, 36, 192)
    assert _rel(theta.numpy(), theta_j) <= 1e-5
    # the patches come from the augmented view: at JAX's landmarks the
    # port's gather gives JAX's tokens; its own landmarks differ by ~1e-4
    # px, which bilinear sampling turns into ~1e-4 relative on the tokens
    at_jax = patch_gather(torch.from_numpy(aug), torch.from_numpy(
        np.array(theta_j)), 8, impl="gather")
    assert _rel(at_jax.numpy(), tok_j) <= 1e-5
    assert _rel(tok.numpy(), tok_j) <= 1e-3


def test_landmark_provider_jitter_and_resampling_are_seeded():
    port = LandmarkProvider(36, 8, "small", 47.0, gather_impl="gather").eval()
    x = torch.rand(2, 48, 48, 3) * 2 - 1
    with torch.no_grad():
        base, _ = port(x)
        outs = [port(x, generator=torch.Generator().manual_seed(s),
                     jitter_std=5.0, ran_sample=20) for s in (7, 7, 8)]
    assert outs[0][0].shape == (2, 20, 2) and outs[0][1].shape == (2, 20, 192)
    assert torch.equal(outs[0][0], outs[1][0])
    assert not torch.equal(outs[0][0], outs[2][0])
    with pytest.raises(NotImplementedError, match="random_coor"):
        port(x, random_coor=True)


@pytest.mark.parametrize("mlp_impl", ["fused_ln", "dense"])
def test_train_mode_token_path_matches_jax(mlp_impl):
    """Part-fViT in training mode on tokens, every rate 0: the port's
    forward equals JAX ``apply(train=True)``, and gradients flow."""
    cfg = {**ARCH, **ZERO_RATES, "with_land": False}
    model = JaxPartFViT(JaxConfig(**cfg))
    tokens = np.random.default_rng(5).standard_normal(
        (3, 36, 192)).astype(np.float32)
    v = _np(jax.jit(model.init)(jax.random.PRNGKey(2), jnp.asarray(tokens)))
    want = np.asarray(model.apply(v, jnp.asarray(tokens), train=True,
                                  rngs={"dropout": jax.random.PRNGKey(0)}))
    port = PartFViT(PartFViTConfig(**cfg, mlp_impl=mlp_impl,
                                   gather_impl="gather")).train()
    port.load_state_dict(to_tensors(state_dict_from_flax(v["params"])),
                         strict=True)
    got = port(torch.from_numpy(tokens), DropoutRNG(0, "cpu"))
    assert _rel(got.detach().numpy(), want) <= 1e-5
    got.sum().backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in port.parameters())


def test_fast_dropout_and_drop_path_keep_fractions():
    """Keep fractions within 5 binomial standard deviations of 1 - rate;
    kept values scaled by 1 / keep; identity in eval mode."""
    rng = DropoutRNG(11, "cpu")
    x = torch.ones(400, 500)
    drop = FastDropout(0.1).train()
    y = drop(x, rng)
    kept = (y != 0).float().mean().item()
    n = x.numel()
    assert abs(kept - 0.9) <= 5 * (0.09 / n) ** 0.5
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert torch.equal(drop.eval()(x, rng), x)
    z = drop_path(torch.ones(20000, 3, 4), 0.1, rng)
    rows = (z[:, 0, 0] != 0).float()
    assert abs(rows.mean().item() - 0.9) <= 5 * (0.09 / 20000) ** 0.5
    assert torch.equal(z != 0, (z[:, :1, :1] != 0).expand_as(z))
    with pytest.raises(ValueError, match="DropoutRNG"):
        FastDropout(0.1).train()(x)


def _tail_inputs(moment_dtype):
    """A small student tree on both sides (JAX layout and the port's),
    with a DINO head's last layer, gradients, moments, teacher."""
    rng = np.random.default_rng(6)
    f = np.float32

    def r(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(f)

    jax_tree = {
        "backbone": {"patch_to_embedding": {"kernel": r(12, 8), "bias": r(8)},
                     "mlp_head": {"scale": r(8), "bias": r(8)}},
        "head": {"mlp_0": {"kernel": r(8, 6), "bias": r(6)},
                 "last_layer_g": np.ones((5, 1), f),
                 "last_layer_v": r(5, 6)},
    }
    grads = jax.tree_util.tree_map(lambda p: r(*p.shape, s=2.0), jax_tree)
    teacher = jax.tree_util.tree_map(lambda p: p + r(*p.shape, s=0.01), jax_tree)
    jdt = jnp.bfloat16 if moment_dtype == torch.bfloat16 else jnp.float32
    mu = jax.tree_util.tree_map(lambda p: r(*p.shape, s=0.1).astype(jdt),
                                jax_tree)
    nu = jax.tree_util.tree_map(
        lambda p: np.abs(r(*p.shape, s=0.1)).astype(jdt), jax_tree)

    def port(tree):
        sd = state_dict_from_flax({**tree["backbone"], "head": tree["head"]})
        out = {(k if k.startswith("head.") else f"backbone.{k}"): v
               for k, v in to_tensors(sd).items()}
        return out

    def port_m(tree):
        return {k: v.to(moment_dtype)
                for k, v in port(jax.tree_util.tree_map(
                    lambda a: np.asarray(a, np.float32), tree)).items()}

    return (jax_tree, grads, teacher, mu, nu,
            port(jax_tree), port(grads), port(teacher), port_m(mu), port_m(nu),
            port)


def _jax_gate(path, p):
    name = "/".join(str(getattr(k, "key", k)) for k in path)
    if name.endswith("last_layer_g"):
        return 2.0
    return 1.0 if "last_layer" in name else 0.0


def _port_gate(name):
    if name.endswith("last_layer.weight_g"):
        return 2.0
    return 1.0 if "last_layer" in name else 0.0


@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("freeze_last", [0.0, 1.0])
def test_fused_tail_matches_jax(moment_dtype, freeze_last):
    """One fused AdamW+EMA update (count 3, clip 3.0, wd 0.1, both gates)
    on identical numpy gradients: student, moments and teacher within
    1e-6 absolute, bf16 moments within one bf16 ulp."""
    (jt, jg, jteach, jmu, jnu, pt, pg, pteach, pmu, pnu,
     port) = _tail_inputs(moment_dtype)
    jstate = jax_optim.AdamWState(jnp.int32(2), jmu, jnu)
    new_j, opt_j, teach_j = jax_optim.fused_adamw_ema_update(
        jg, jstate, jt, jteach, jnp.float32(0.05), jnp.float32(0.1),
        jnp.float32(0.99), wd_scale_tree=jax_optim.dino_wd_mask(jt),
        gate_tree=jax.tree_util.tree_map_with_path(_jax_gate, jt),
        gate_scalar=jnp.float32(freeze_last), clip=3.0)
    new_p, opt_p, teach_p = optim.fused_adamw_ema_update(
        pg, optim.AdamWState(2, pmu, pnu), pt, pteach, 0.05, 0.1, 0.99,
        wd_scale=optim.dino_wd_mask(pt),
        gate={n: _port_gate(n) for n in pt}, gate_scalar=freeze_last,
        clip=3.0)
    assert opt_p.count == int(opt_j.count) == 3

    def f32(tree):
        return port(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                           tree))

    for got, want, atol in ((new_p, port(_np(new_j)), 1e-6),
                            (teach_p, port(_np(teach_j)), 1e-6),
                            (opt_p.mu, f32(opt_j.mu), 1e-6),
                            (opt_p.nu, f32(opt_j.nu), 1e-6)):
        assert set(got) == set(want)
        for k in want:
            g = got[k].float()
            tol = atol
            if moment_dtype == torch.bfloat16 and got[k].dtype == torch.bfloat16:
                tol = max(atol, 2.0 ** -8 * float(want[k].abs().max()))
            assert torch.allclose(g, want[k], rtol=0, atol=tol), k
    # the compared trees hold the gated gain with its decay on (mask 1),
    # the JAX deviation that the port mirrors
    assert optim.dino_wd_mask(pt)["head.last_layer.weight_g"] == 1.0


def test_last_layer_gain_decays_like_jax():
    """lr 0.1, wd 0.1, one step: the gated gain goes 1.0 → 0.99 in both
    packages (the reference would keep it at 1)."""
    g = {"head.last_layer.weight_g": torch.ones(4, 1)}
    new, _, _ = optim.fused_adamw_ema_update(
        {"head.last_layer.weight_g": torch.randn(4, 1)}, optim.adamw_init(g),
        g, g, 0.1, 0.1, 0.9, wd_scale=optim.dino_wd_mask(g),
        gate={"head.last_layer.weight_g": 2.0})
    assert optim.dino_wd_mask(g) == {"head.last_layer.weight_g": 1.0}
    assert torch.allclose(new["head.last_layer.weight_g"],
                          torch.full((4, 1), 0.99))


@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16])
def test_fused_tail_equals_separate_passes(moment_dtype):
    """gate + clip + adamw_update + ema_update compose to the fused tail
    (1e-7 absolute: the same fp32 operations, up to fused multiply-adds
    in the batched form)."""
    *_, pt, pg, pteach, pmu, pnu, _ = _tail_inputs(moment_dtype)
    state = optim.AdamWState(2, pmu, pnu)
    wd_mask = optim.dino_wd_mask(pt)
    before = [{k: v.clone() for k, v in t.items()}
              for t in (pt, pg, pteach, pmu, pnu)]
    fused = optim.fused_adamw_ema_update(
        pg, state, pt, pteach, 0.05, 0.1, 0.99, wd_scale=wd_mask,
        gate={n: _port_gate(n) for n in pt}, gate_scalar=0.0, clip=3.0)
    grads = optim.clip_grads_per_param(pg, 3.0)
    grads = {n: g * 0.0 if "last_layer" in n else g for n, g in grads.items()}
    grads = optim.zero_grads_by_path(
        grads, lambda n: n.endswith("last_layer.weight_g"))
    student, opt = optim.adamw_update(grads, state, pt, 0.05,
                                      wd_scale=wd_mask, wd=0.1)
    teacher = optim.ema_update(pteach, student, 0.99)
    for a, b in ((fused[0], student), (fused[1].mu, opt.mu),
                 (fused[1].nu, opt.nu), (fused[2], teacher)):
        for k in b:
            assert a[k].dtype == b[k].dtype
            assert torch.allclose(a[k].float(), b[k].float(), rtol=0,
                                  atol=1e-7 if a[k].dtype == torch.float32
                                  else 2.0 ** -8 * float(b[k].abs().max())), k
    # no input was written
    assert state.count == 2
    for old, new in zip(before, (pt, pg, pteach, pmu, pnu)):
        assert all(torch.equal(old[k], new[k]) for k in old)
