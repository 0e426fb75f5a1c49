"""PyTorch port: the parts of the supervised step against the JAX package.

Each part takes the same numpy inputs and weights on both sides, in fp32 on
the CPU. Tolerances: the gather and its VJP 1e-5 relative (summation order
of the four corners); BatchNorm in training 1e-5 relative for its output,
running statistics and gradients, and the training-mode MobileNetV3 stem
1e-4 after two updates (a dozen BatchNorms deep); CosFace logits and the
soft-target cross-entropy 1e-5 relative; Mixup/CutMix on the same draws
exact up to 1e-6 (the same fp32 elementwise formulas); the layer-decay
groups exact; one AdamW update with lr and wd trees 1e-6 absolute. The
dropout of the landmark branch and the port's own mixup draws are checked
by statistics (5 standard deviations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from lafs_cvpr2024_tpu.models.heads import cosface_logits as jax_cosface
from lafs_cvpr2024_tpu.models.mobilenet import (
    MobileNetV3Backbone as JaxMobileNet,
)
from lafs_cvpr2024_tpu.models.partfvit import PartFViT as JaxPartFViT
from lafs_cvpr2024_tpu.models.partfvit import PartFViTConfig as JaxConfig
from lafs_cvpr2024_tpu.ops import mixup as jax_mixup
from lafs_cvpr2024_tpu.ops.patch_gather import patch_gather as jax_gather
from lafs_cvpr2024_tpu.train import optim as jax_optim
from lafs_cvpr2024_tpu.train.losses import (
    softmax_cross_entropy as jax_softmax_ce,
)
from lafs_cvpr2024_tpu_torch.models.heads import CosFace, cosface_logits
from lafs_cvpr2024_tpu_torch.models.layers import DropoutRNG, FastDropout
from lafs_cvpr2024_tpu_torch.models.mobilenet import (
    FlaxBatchNorm2d,
    MobileNetV3Backbone,
)
from lafs_cvpr2024_tpu_torch.models.partfvit import (
    PartFViT,
    PartFViTConfig,
    init_random_,
)
from lafs_cvpr2024_tpu_torch.ops import patch_gather_cuda
from lafs_cvpr2024_tpu_torch.ops.mixup import (
    MixupConfig,
    MixupDraws,
    draw_mixup,
    mix_with_draws,
    mixup_cutmix,
)
from lafs_cvpr2024_tpu_torch.ops.patch_gather import (
    PatchGather,
    patch_gather,
    patch_gather_plain,
)
from lafs_cvpr2024_tpu_torch.train import optim
from lafs_cvpr2024_tpu_torch.train.checkpoint import (
    state_dict_from_flax,
    to_tensors,
)
from lafs_cvpr2024_tpu_torch.train.losses import softmax_cross_entropy


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------- gather --

def _gather_inputs():
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (2, 48, 40, 3)).astype(np.float32)
    lm = rng.uniform(-6.0, 50.0, (2, 30, 2)).astype(np.float32)
    # clamped far out of the frame, at the edges, at half-pixels
    lm[:, :6] = [(-1e4, 5), (1e4, 20), (7, -1e5), (0, 0), (39, 47),
                 (12.5, 30.5)]
    g = rng.standard_normal((2, 30, 192)).astype(np.float32)
    return img, lm, g


@pytest.mark.parametrize("route", ["autograd", "function"])
def test_gather_vjp_matches_jax_mxu(route, monkeypatch):
    """The VJP with respect to images and landmarks against ``jax.vjp`` of
    the ``mxu`` gather (what ``patch_gather_pallas_diff`` differentiates).
    'function' runs ``PatchGather``, the card's autograd function, with its
    CUDA forward swapped for the plain version."""
    img, lm, g = _gather_inputs()
    out, vjp = jax.vjp(lambda i, l: jax_gather(i, l, 8, impl="mxu"),
                       jnp.asarray(img), jnp.asarray(lm))
    want_i, want_l = vjp(jnp.asarray(g))
    ti, tl = (torch.from_numpy(a).requires_grad_() for a in (img, lm))
    if route == "function":
        monkeypatch.setattr(patch_gather_cuda, "patch_gather_cuda",
                            patch_gather_plain)
        got = PatchGather.apply(ti, tl, 8)
    else:
        got = patch_gather(ti, tl, 8, impl="kernel")  # a CPU tensor: plain
    got.backward(torch.from_numpy(g))
    assert _rel(got.detach(), out) <= 1e-5
    assert _rel(ti.grad, want_i) <= 1e-5
    assert _rel(tl.grad, want_l) <= 1e-5
    # clamped landmarks sample only zeros: no gradient reaches them
    assert torch.count_nonzero(tl.grad[:, :3]) == 0
    assert np.count_nonzero(np.asarray(want_l)[:, :3]) == 0


def test_gather_function_skips_the_grads_nobody_asked_for(monkeypatch):
    monkeypatch.setattr(patch_gather_cuda, "patch_gather_cuda",
                        patch_gather_plain)
    img, lm, g = _gather_inputs()
    ti = torch.from_numpy(img)
    tl = torch.from_numpy(lm).requires_grad_()
    PatchGather.apply(ti, tl, 8).backward(torch.from_numpy(g))
    assert ti.grad is None and tl.grad is not None


# ---------------------------------------------------------- BatchNorm --

def test_batchnorm_training_matches_flax_and_not_torch():
    """Two training updates of one BatchNorm: output, running statistics
    (momentum 0.9, BIASED variance) and gradients as flax computes them;
    ``torch.nn.BatchNorm2d`` keeps the unbiased variance instead."""
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((3, 4, 5, 6)).astype(np.float32) * 2 + 1
          for _ in range(2)]
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, 6).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = {"mean": np.zeros(6, np.float32), "var": np.ones(6, np.float32)}
    port = FlaxBatchNorm2d(6).train()
    ref = torch.nn.BatchNorm2d(6, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    for x in xs:
        params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

        def f(p, xx, st=stats):
            return bn.apply({"params": p, "batch_stats": st}, xx,
                            mutable=["batch_stats"])
        y, mut = f(params, jnp.asarray(x))
        gy = np.cos(np.asarray(y))
        _, pull = jax.vjp(lambda p, xx: f(p, xx)[0], params, jnp.asarray(x))
        gp, gx = pull(jnp.asarray(gy))
        stats = _np(mut["batch_stats"])
        tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        ty = port(tx)
        ty.backward(torch.from_numpy(gy).permute(0, 3, 1, 2))
        ref(tx.detach())
        assert _rel(ty.detach().permute(0, 2, 3, 1), y) <= 1e-5
        assert _rel(tx.grad.permute(0, 2, 3, 1), gx) <= 1e-5
        assert _rel(port.weight.grad, gp["scale"]) <= 1e-5
        assert _rel(port.bias.grad, gp["bias"]) <= 1e-5
        port.weight.grad = port.bias.grad = None
        assert _rel(port.running_mean, stats["mean"]) <= 1e-6
        assert _rel(port.running_var, stats["var"]) <= 1e-6
    # torch's own update: unbiased variance, ~1/(N-1) away at N = 60
    assert _rel(ref.running_var, stats["var"]) > 1e-3
    assert int(port.num_batches_tracked) == 0


def _bn_shifted(params, seed=2):
    """BatchNorm scales and biases moved off flax's init (1, 0), where the
    stem's gradients and some running means vanish in exact arithmetic."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        x = np.asarray(x)
        if name.endswith("bn/scale"):
            return x * rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name.endswith("bn/bias"):
            return x + rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(move, params)


def test_mobilenet_stem_in_training_matches_jax():
    """The small MobileNetV3 stem in training mode, two updates: the
    feature map and every running statistic against the JAX module."""
    rng = np.random.default_rng(3)
    xs = [rng.uniform(-1, 1, (4, 48, 48, 3)).astype(np.float32)
          for _ in range(2)]
    jm = JaxMobileNet("small")
    v = jax.jit(lambda r, x: jm.init(r, x, False))(jax.random.PRNGKey(0),
                                                  xs[0])
    params, stats = _bn_shifted(_np(v["params"])), _np(v["batch_stats"])
    sd = to_tensors(state_dict_from_flax({"landmark": {"stn": params}},
                                         {"landmark": {"stn": stats}}))
    port = MobileNetV3Backbone("small")
    port.load_state_dict({k[len("stn."):]: t for k, t in sd.items()})
    port.train()
    train = jax.jit(lambda p, st, x: jm.apply(
        {"params": p, "batch_stats": st}, x, True, mutable=["batch_stats"]))
    for x in xs:
        out, mut = train(params, stats, x)
        stats = _np(mut["batch_stats"])
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        assert _rel(got, out) <= 1e-4
    want = to_tensors(state_dict_from_flax({}, {"landmark": {"stn": stats}}))
    mine = port.state_dict()
    for k, t in want.items():
        if t.is_floating_point():
            assert _rel(mine[k[len("stn."):]], t) <= 1e-4, k


def test_syncbn_axis_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MobileNetV3Backbone("small", axis_name="data")


# ------------------------------------------------------- head, loss --

@pytest.mark.parametrize("soft", [False, True])
def test_cosface_logits_match_jax(soft):
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((6, 32)).astype(np.float32)
    w = rng.standard_normal((10, 32)).astype(np.float32)
    labels = np.array([0, 3, 9, 3, 1, 5])
    if soft:  # mixup rows: the margin scales with the soft label value
        y = np.eye(10, dtype=np.float32)[labels]
        labels = 0.7 * y + 0.3 * y[::-1]
    want = jax_cosface(jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels),
                       64.0, 0.4, 10)
    head = CosFace(32, 10)
    with torch.no_grad():
        head.weight.copy_(torch.from_numpy(w))
    got = head(torch.from_numpy(emb), torch.from_numpy(np.asarray(labels)))
    assert _rel(got.detach(), want) <= 1e-5
    assert _rel(cosface_logits(torch.from_numpy(emb), torch.from_numpy(w),
                               torch.from_numpy(np.asarray(labels))),
                want) <= 1e-5


def test_cosface_head_init_is_xavier_uniform():
    cfg = PartFViTConfig(dim=64, depth=1, heads=1, dim_head=64, mlp_dim=128,
                         num_patches=16, image_size=32, stn_mode="small",
                         num_classes=300)
    w = init_random_(PartFViT(cfg), 0).state_dict()["loss.weight"]
    bound = (6.0 / (300 + 64)) ** 0.5
    assert w.shape == (300, 64)
    assert w.abs().max().item() <= bound
    # uniform on [-b, b]: variance b²/3
    assert abs(w.var().item() / (bound ** 2 / 3) - 1) <= 0.05


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((6, 10)) * 20).astype(np.float32)
    t = rng.uniform(0, 1, (6, 10)).astype(np.float32)
    t /= t.sum(1, keepdims=True)
    want = jax_softmax_ce(jnp.asarray(logits), jnp.asarray(t))
    got = softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(t))
    assert _rel(got, want) <= 1e-5


# -------------------------------------------------------------- mixup --

MIX_CASES = {
    "mixup": dict(mixup_alpha=0.2, prob=1.0),
    "cutmix": dict(mixup_alpha=0.0, cutmix_alpha=1.0, prob=1.0),
    "switch": dict(mixup_alpha=0.2, cutmix_alpha=1.0, prob=1.0,
                   switch_prob=0.5),
    "minmax": dict(mixup_alpha=0.0, cutmix_minmax=(0.2, 0.6), prob=1.0),
    "not_applied": dict(mixup_alpha=0.2, prob=0.0),
    "smoothing": dict(mixup_alpha=0.2, prob=1.0, label_smoothing=0.1),
}


def _jax_draws(key, cfg, h, w):
    """The draws ``jax mixup_cutmix(key, ...)`` makes, read off its key
    splits (``mixup.py:199-236``)."""
    k_prob, k_switch, k_lam, k_box = jax.random.split(key, 4)
    apply = bool(jax.random.uniform(k_prob) < cfg.prob)
    cut_on = cfg.cutmix_alpha > 0 or cfg.cutmix_minmax is not None
    c_alpha = cfg.cutmix_alpha if cfg.cutmix_alpha > 0 else 1.0
    if cfg.mixup_alpha > 0 and cut_on:
        use_cut = bool(jax.random.uniform(k_switch) < cfg.switch_prob)
    else:
        use_cut = cut_on
    lam = float(jax_mixup._beta(k_lam, c_alpha if use_cut else cfg.mixup_alpha))
    if cfg.cutmix_minmax is not None:
        box = jax_mixup._minmax_box(k_box, h, w, cfg.cutmix_minmax)
    else:
        ratio = jnp.sqrt(1.0 - jnp.float32(lam if apply else 1.0))
        cut_h = (h * ratio).astype(jnp.int32)
        cut_w = (w * ratio).astype(jnp.int32)
        cy = jax.random.randint(k_box, (), 0, h)
        cx = jax.random.randint(jax.random.fold_in(k_box, 1), (), 0, w)
        box = (jnp.clip(cy - cut_h // 2, 0, h), jnp.clip(cy + cut_h // 2, 0, h),
               jnp.clip(cx - cut_w // 2, 0, w), jnp.clip(cx + cut_w // 2, 0, w))
    return MixupDraws(apply, use_cut, lam, tuple(int(b) for b in box))


@pytest.mark.parametrize("case", list(MIX_CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixup_with_the_same_draws_matches_jax(case, seed):
    kw = {**MIX_CASES[case], "num_classes": 7}
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(-1, 1, (6, 16, 12, 3)).astype(np.float32)
    labels = rng.integers(0, 7, 6)
    key = jax.random.PRNGKey(seed)
    jcfg = jax_mixup.MixupConfig(**kw)
    want_x, want_t = jax_mixup.mixup_cutmix(key, jnp.asarray(imgs),
                                            jnp.asarray(labels), jcfg)
    draws = _jax_draws(key, jcfg, 16, 12)
    got_x, got_t = mix_with_draws(torch.from_numpy(imgs),
                                  torch.from_numpy(labels),
                                  MixupConfig(**kw), draws)
    assert np.abs(got_x.numpy() - np.asarray(want_x)).max() <= 1e-6
    assert np.abs(got_t.numpy() - np.asarray(want_t)).max() <= 1e-6


def test_mixup_disabled_and_unported_modes():
    imgs, labels = torch.rand(4, 8, 8, 3), torch.tensor([0, 1, 2, 1])
    cfg = MixupConfig(mixup_alpha=0.0, num_classes=3)
    x, t = mixup_cutmix(imgs, labels, cfg, np.random.default_rng(0))
    assert not cfg.enabled and torch.equal(x, imgs)
    assert torch.equal(t, torch.eye(3)[labels])
    for mode in ("elem", "pair"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mixup_cutmix(imgs, labels, MixupConfig(mode=mode, num_classes=3),
                         np.random.default_rng(0))


def test_mixup_draws_by_statistics():
    """The port's own draws: apply at ``prob``, CutMix at ``switch_prob``,
    λ ~ Beta(α, α) (mean 1/2, variance 1/(4(2α+1))), boxes inside the
    image, and CutMix targets weighted by the box's area."""
    cfg = MixupConfig(mixup_alpha=0.2, cutmix_alpha=1.0, prob=0.3,
                      switch_prob=0.5, num_classes=4)
    rng = np.random.default_rng(7)
    draws = [draw_mixup(cfg, 20, 16, rng) for _ in range(4000)]
    n = len(draws)
    applied = np.mean([d.apply for d in draws])
    assert abs(applied - 0.3) <= 5 * (0.21 / n) ** 0.5
    cut = np.array([d.use_cutmix for d in draws])
    assert abs(cut.mean() - 0.5) <= 5 * (0.25 / n) ** 0.5
    for alpha, sel in ((0.2, ~cut), (1.0, cut)):
        lam = np.array([d.lam for d in draws])[sel]
        var = 1.0 / (4 * (2 * alpha + 1))
        assert abs(lam.mean() - 0.5) <= 5 * (var / len(lam)) ** 0.5
        assert abs(lam.var() / var - 1) <= 0.15
    for d in draws:
        yl, yh, xl, xh = d.box
        assert 0 <= yl <= yh <= 20 and 0 <= xl <= xh <= 16
    d = next(d for d in draws if d.apply and d.use_cutmix
             and d.box[1] > d.box[0] and d.box[3] > d.box[2])
    imgs, labels = torch.rand(4, 20, 16, 3), torch.tensor([0, 1, 2, 3])
    x, t = mix_with_draws(imgs, labels, cfg, d)
    yl, yh, xl, xh = d.box
    lam = 1 - (yh - yl) * (xh - xl) / (20 * 16)
    assert torch.allclose(t[0], torch.tensor([lam, 0, 0, 1 - lam]))
    assert torch.equal(x[0, yl:yh, xl:xh], imgs[3, yl:yh, xl:xh])


# ---------------------------------------------------------- optimizer --

@pytest.fixture(scope="module")
def jax_model_params():
    cfg = JaxConfig(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256,
                    num_patches=16, image_size=32, stn_mode="small",
                    num_classes=12)
    model = JaxPartFViT(cfg)
    x = jnp.zeros((1, 32, 32, 3))
    v = jax.jit(lambda r: model.init(r, x, jnp.zeros((1,), jnp.int32)))(
        jax.random.PRNGKey(0))
    return _np(v["params"])


def test_param_groups_lrd_matches_jax(jax_model_params):
    """The lr scales and weight decays of every parameter, the JAX trees
    mapped onto ``state_dict`` names, exactly; the groups of trap 4."""
    params = jax_model_params
    jlr, jwd = jax_optim.param_groups_lrd(params, 2, 0.1, 0.58, 5e-2)

    def port(tree):
        full = jax.tree_util.tree_map(
            lambda v, p: np.full(np.shape(p), v, np.float32), tree, params)
        return {k: float(np.asarray(a).reshape(-1)[0])
                for k, a in state_dict_from_flax(full).items()
                if not k.endswith("num_batches_tracked")}

    want_lr, want_wd = port(jlr), port(jwd)
    model = PartFViT(PartFViTConfig(dim=128, depth=2, heads=2, dim_head=64,
                                    mlp_dim=256, num_patches=16,
                                    image_size=32, stn_mode="small",
                                    num_classes=12))
    mine = {n: p for n, p in model.named_parameters()}
    lr, wd = optim.param_groups_lrd(mine, 2, 0.1, 0.58, 5e-2)
    assert set(lr) == set(want_lr) == set(mine)
    for n in mine:
        assert lr[n] == pytest.approx(want_lr[n], rel=1e-6), n
        assert wd[n] == pytest.approx(want_wd[n], rel=1e-6), n
    top = 0.58 ** 3
    assert lr["cls_token"] == lr["stn.features.0.0.weight"] == \
        lr["output_layer.weight"] == pytest.approx(top)
    assert lr["transformer.layers.1.1.fn.fn.net.0.weight"] == \
        pytest.approx(0.58)
    assert lr["loss.weight"] == lr["mlp_head.0.weight"] == 1.0
    assert wd["stn.features.0.0.weight"] == 5e-2
    assert wd["output_layer.weight"] == wd["loss.weight"] == 0.1
    assert wd["stn.features.0.1.weight"] == wd["output_layer.bias"] == 0.0


def test_adamw_with_lr_and_wd_trees_matches_jax():
    """One update at count 2 with per-leaf lr scales and absolute weight
    decays (``wd=1``), as the supervised step calls it: parameters and
    moments within 1e-6 absolute."""
    rng = np.random.default_rng(8)
    shapes = {"w": (6, 5), "b": (5,), "c": (3, 2, 2)}
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    grads = {k: 2 * rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    mu = {k: 0.1 * rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    nu = {k: np.abs(0.1 * rng.standard_normal(s)).astype(np.float32)
          for k, s in shapes.items()}
    lr_s = {"w": 0.58 ** 3, "b": 1.0, "c": 0.58}
    wd_s = {"w": 0.1, "b": 0.0, "c": 5e-2}
    new_j, opt_j = jax_optim.adamw_update(
        grads, jax_optim.AdamWState(jnp.int32(2), mu, nu), tree,
        jnp.float32(0.05), wd_scale_tree=wd_s, lr_scale_tree=lr_s, wd=1.0)
    t = {k: torch.from_numpy(v) for k, v in tree.items()}
    new_p, opt_p = optim.adamw_update(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        optim.AdamWState(2, {k: torch.from_numpy(v) for k, v in mu.items()},
                         {k: torch.from_numpy(v) for k, v in nu.items()}),
        t, 0.05, wd_scale=wd_s, wd=1.0, lr_scale=lr_s)
    assert opt_p.count == 3
    for got, want in ((new_p, new_j), (opt_p.mu, opt_j.mu),
                      (opt_p.nu, opt_j.nu)):
        for k in shapes:
            assert np.abs(got[k].numpy() - np.asarray(want[k])).max() <= 1e-6
    # the lr scale matters: without it the decayed leaves move further
    plain, _ = optim.adamw_update(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        optim.AdamWState(2, {k: torch.from_numpy(v) for k, v in mu.items()},
                         {k: torch.from_numpy(v) for k, v in nu.items()}),
        t, 0.05, wd_scale=wd_s, wd=1.0)
    assert not torch.allclose(plain["w"], new_p["w"])


# -------------------------------------------------- landmark dropout --

def test_landmark_dropout_by_statistics():
    """The landmark branch's Dropout(0.5) (flax ``nn.Dropout`` in JAX,
    ``FastDropout(0.5)`` in the port): keeps half the pooled features,
    scales them by 2, is the identity in eval and at p = 0, and needs a
    DropoutRNG in training."""
    drop = FastDropout(0.5).train()
    x = torch.ones(20000, 16)
    y = drop(x, DropoutRNG(3, "cpu"))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.5) <= 5 * (0.25 / x.numel()) ** 0.5
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert torch.equal(drop.eval()(x), x)
    with pytest.raises(ValueError, match="DropoutRNG"):
        FastDropout(0.5).train()(x)
    cfg = PartFViTConfig(dim=128, depth=1, heads=2, dim_head=64, mlp_dim=256,
                         num_patches=16, image_size=32, stn_mode="small",
                         num_classes=5)
    model = init_random_(PartFViT(cfg), 0).train()
    img = torch.rand(4, 32, 32, 3) - 0.5
    with torch.no_grad():
        a, b = (model.landmarks(img, DropoutRNG(s, "cpu")) for s in (1, 2))
        model.landmark_dropout.p = 0.0
        c, d = (model.landmarks(img, DropoutRNG(s, "cpu")) for s in (1, 2))
    assert not torch.equal(a, b) and torch.equal(c, d)
