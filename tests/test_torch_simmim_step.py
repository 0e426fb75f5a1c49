"""PyTorch port: SimMIM pretraining (train/simmim.py) and the pieces it
adds: the SimMIM Part-fViT (``mask_token``, ``return_tokens``), the grid
``patchify``, the global-norm clip, the state conversion and the encoder
export.

1. Model forward: a JAX Part-fViT with ``simmim=True`` (depth 2, dim 128,
   2 heads × 64, mlp 256, 36 patches of 48² images, MobileNetV3-small
   stem) and the port's on the same weights and a mask, fp32: embedding
   cosine ≥ 1 − 1e-5 and the returned tokens within 1e-5 absolute, in the
   port's kernel configuration (``fused``/``lnqkv``, their plain versions
   on the CPU) and its plain one.
2. Three steps: JAX ``make_simmim_train_step`` on a 1-device mesh (plain
   jit, ``dense`` MLP, ``einsum`` attention, XLA) and the port's step in
   its kernel configuration start from one state through
   ``simmim_state_from_flax`` and take 3 steps on the same uint8 images,
   with every dropout rate 0 and the JAX step's masks handed to the port
   through ``train.simmim.draw_mask``. fp32. The loss of each step, every
   parameter and every AdamW moment within 1e-4 relative (max-norm per
   leaf): summation order only. One step of the grid variant
   (``use_landmarks=False``) likewise. Every bias starts moved off its
   zero init by a seeded amount: a zero bias is, after Adam's first step,
   just lr·g/(|g| + eps) per element, and an element whose gradient is
   near eps = 1e-8 moves by a fraction of lr that rounding shifts by a
   few 1e-4 (measured 2.1e-4 on a LayerNorm bias). For the same reason lr
   is the CLI's 1e-4 (``cli/train_simmim.py:31``): a weight element whose
   fp32 gradient is rounding noise near eps moves by an lr·g/(|g| + eps)
   that differs between the packages by a percent of lr (measured: 2.2e-4
   of the decoder weight's max-norm at lr 1e-3).
3. The smaller pieces against JAX, and the port alone: the device default,
   unported options, and a step that is a pure function of (seed, step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from lafs_cvpr2024_tpu.models.partfvit import PartFViT as JaxPartFViT
from lafs_cvpr2024_tpu.models.partfvit import PartFViTConfig as JaxConfig
from lafs_cvpr2024_tpu.ops.patchify import patchify as jax_patchify
from lafs_cvpr2024_tpu.train import simmim as jax_simmim
from lafs_cvpr2024_tpu.train.checkpoint import (
    export_torch_state_dict,
    save_torch_state_dict,
)
from lafs_cvpr2024_tpu.train.optim import clip_grads_global as jax_clip
from lafs_cvpr2024_tpu.train.ssl import SSLConfig as JaxSSLConfig
from lafs_cvpr2024_tpu.train.ssl import (
    create_landmark_provider as jax_landmark_provider,
)
from lafs_cvpr2024_tpu_torch.eval.loading import load_eval_model
from lafs_cvpr2024_tpu_torch.models.partfvit import PartFViT, PartFViTConfig
from lafs_cvpr2024_tpu_torch.ops.patchify import patchify
from lafs_cvpr2024_tpu_torch.train import simmim
from lafs_cvpr2024_tpu_torch.train.checkpoint import (
    simmim_encoder_state_dict,
    simmim_state_from_flax,
    state_dict_from_flax,
    to_tensors,
)
from lafs_cvpr2024_tpu_torch.train.optim import clip_grads_global
from lafs_cvpr2024_tpu_torch.train.simmim import (
    SimMIMConfig,
    create_simmim_state,
    make_simmim_train_step,
)
from lafs_cvpr2024_tpu_torch.train.ssl import (
    SSLConfig,
    create_landmark_provider,
    create_ssl_state,
)

ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256,
            num_patches=36, image_size=48, stn_mode="small", with_land=False,
            loss_type="None", num_classes=0, simmim=True)
DETERMINISTIC = dict(dropout=0.0, emb_dropout=0.0, drop_path_rate=0.0)
KERNEL = dict(gather_impl="kernel", mlp_impl="fused", attn_impl="lnqkv")
PLAIN = dict(gather_impl="gather", mlp_impl="dense", attn_impl="einsum")
LR, WD = 1e-4, 0.05


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _rel_leaf(got, want):
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _images(b=4, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, 48, 48, 3),
                                                dtype=np.uint8)


def _port_cfg(**over):
    model = PartFViTConfig(**{**ARCH, **DETERMINISTIC, **KERNEL,
                              **over.pop("model", {})})
    return SimMIMConfig(model=model, compute_dtype=torch.float32,
                        input_scale="unit", **over)


# ----------------------------------------------------------------- model --

@pytest.fixture(scope="module")
def jax_model():
    """(JAX SimMIM model, numpy variables, tokens, mask)."""
    rng = np.random.default_rng(0)
    tokens = rng.standard_normal((3, 36, 192)).astype(np.float32)
    mask = (rng.uniform(size=(3, 36)) < 0.6).astype(np.float32)
    model = JaxPartFViT(JaxConfig(**ARCH))
    v = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, t: model.init(k, t, return_tokens=True))(
            jax.random.PRNGKey(0), jnp.asarray(tokens)))
    return model, v, tokens, mask


def _port_model(v, **impls):
    model = PartFViT(PartFViTConfig(**{**ARCH, **impls})).eval()
    model.load_state_dict(to_tensors(state_dict_from_flax(v["params"])),
                          strict=True)
    return model


@pytest.mark.parametrize("impls", [KERNEL, PLAIN], ids=["kernel", "plain"])
def test_masked_forward_with_tokens_matches_jax(jax_model, impls):
    model, v, tokens, mask = jax_model
    emb_j, tok_j, theta_j = jax.jit(lambda v, t, m: model.apply(
        v, t, return_tokens=True, mask=m))(v, jnp.asarray(tokens),
                                           jnp.asarray(mask))
    with torch.no_grad():
        emb, tok, theta = _port_model(v, **impls)(
            torch.from_numpy(tokens), mask=torch.from_numpy(mask),
            return_tokens=True)
    assert theta is None and theta_j is None
    assert tok.shape == (3, 36, 128)
    emb, emb_j = emb.numpy().astype(np.float64), np.asarray(emb_j, np.float64)
    cos = (emb * emb_j).sum(1) / np.linalg.norm(emb, axis=1) \
        / np.linalg.norm(emb_j, axis=1)
    assert cos.min() >= 1 - 1e-5
    assert np.abs(tok.numpy() - np.asarray(tok_j)).max() <= 1e-5
    # the mask matters: unmasked tokens differ
    with torch.no_grad():
        _, free, _ = _port_model(v, **impls)(torch.from_numpy(tokens),
                                             return_tokens=True)
    assert np.abs(free.numpy() - tok.numpy()).max() > 1e-3


def test_patchify_and_grid_image_path_match_jax(jax_model):
    """The grid image path (``with_land=False`` on images) patchifies as
    the JAX package does, token order and feature order included."""
    model, v, _, _ = jax_model
    x = np.random.default_rng(1).uniform(-1, 1, (2, 48, 48, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        patchify(torch.from_numpy(x), 8).numpy(),
        np.asarray(jax_patchify(jnp.asarray(x), 8)))
    want = np.asarray(jax.jit(model.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_model(v, **KERNEL)(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= 1e-5


def test_init_draws_the_mask_token_from_a_truncated_normal():
    params = create_simmim_state(_port_cfg(), 0, device="cpu").params
    tok = params["backbone.mask_token"]
    assert tok.shape == (1, 1, 128)
    assert tok.abs().max().item() <= 2 * 0.02 / 0.8796 + 1e-6
    assert 0.012 <= tok.std().item() <= 0.028
    assert params["decoder.weight"].shape == (192, 128)
    assert torch.equal(params["decoder.bias"], torch.zeros(192))


# ------------------------------------------------------------- the steps --

def _jax_cfg(use_landmarks=True, moment_dtype=jnp.float32):
    return jax_simmim.SimMIMConfig(
        model=JaxConfig(**ARCH, **DETERMINISTIC, mlp_impl="dense",
                        attn_impl="einsum", gather_impl="mxu"),
        compute_dtype=jnp.float32, input_scale="unit",
        use_landmarks=use_landmarks, moment_dtype=moment_dtype)


def _jax_steps(cfg, n_steps):
    """JAX state, landmark variables, the masks its step draws and the
    states and losses of ``n_steps`` steps on one batch."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    state = jax.jit(lambda r: jax_simmim.create_simmim_state(cfg, r))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(8)
    state = state._replace(params=jax.tree_util.tree_map_with_path(
        lambda path, x: x + rng.uniform(-0.1, 0.1, x.shape).astype(np.float32)
        if str(getattr(path[-1], "key", "")) == "bias" else x, state.params))
    land = jax_landmark_provider(JaxSSLConfig(model=cfg.model),
                                 jax.random.PRNGKey(1))
    # running stats away from (0, 1) so the frozen CNN's eval BN is exercised
    rng = np.random.default_rng(9)
    land = dict(land, batch_stats=jax.tree_util.tree_map(
        lambda s: np.asarray(s) + rng.uniform(0.1, 0.5, s.shape).astype(
            np.float32), land["batch_stats"]))
    step = jax_simmim.make_simmim_train_step(cfg, mesh)
    images = jnp.asarray(_images())
    states, losses, masks = [jax.device_get(state)], [], []
    for _ in range(n_steps):
        # the step's own draw (simmim.py:133-156), read off its key
        key = jax.random.fold_in(state.rng, state.step)
        _, k_mask, _ = jax.random.split(key, 3)
        masks.append(np.asarray(jax.random.bernoulli(
            k_mask, cfg.mask_ratio, (4, 36)), np.float32))
        state, m = step(state, land, images, jnp.float32(LR), jnp.float32(WD))
        states.append(jax.device_get(state))
        losses.append(float(m["loss"]))
    return states, jax.tree_util.tree_map(np.asarray, land), losses, masks


@pytest.fixture(scope="module")
def jax_run():
    return _jax_steps(_jax_cfg(), 3)


def _hand_masks(monkeypatch, masks):
    """The port's step takes these masks, in order, instead of its own."""
    queue = list(masks)

    def draw(seed, b, n, ratio, device):
        assert (b, n, ratio) == (4, 36, 0.6)
        return torch.from_numpy(queue.pop(0)).to(device)
    monkeypatch.setattr(simmim, "draw_mask", draw)
    return queue


def _compare(state, want, loss, want_loss, i):
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss), i
    assert state.step == want.step and \
        state.opt_state.count == want.opt_state.count
    assert set(state.params) == set(want.params)
    for got_t, want_t in ((state.params, want.params),
                          (state.opt_state.mu, want.opt_state.mu),
                          (state.opt_state.nu, want.opt_state.nu)):
        for k in want_t:
            assert _rel_leaf(got_t[k], want_t[k]) <= 1e-4, (i, k)


def test_simmim_state_from_flax_has_the_port_keys(jax_run):
    states = jax_run[0]
    port = simmim_state_from_flax(states[0], device="cpu")
    mine = create_simmim_state(_port_cfg(), 0, device="cpu")
    for a in (port.params, port.opt_state.mu, port.opt_state.nu):
        assert set(a) == set(mine.params)
        assert all(a[k].shape == mine.params[k].shape for k in a)
    dec = states[0].params["decoder"]["kernel"]
    assert torch.equal(port.params["decoder.weight"],
                       torch.from_numpy(np.asarray(dec).T.copy()))
    assert torch.equal(port.params["backbone.mask_token"], torch.from_numpy(
        np.array(states[0].params["backbone"]["mask_token"])))
    assert port.step == 0 and port.opt_state.count == 0


def test_three_steps_match_jax(jax_run, monkeypatch):
    states, land, losses, masks = jax_run
    taken = {"mlp": 0, "qkv": 0}
    from lafs_cvpr2024_tpu_torch.models import layers

    def spy(fn, key):
        def wrapped(*a, **k):
            taken[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(layers, "fused_mlp", spy(layers.fused_mlp, "mlp"))
    monkeypatch.setattr(layers, "fused_ln_linear",
                        spy(layers.fused_ln_linear, "qkv"))
    queue = _hand_masks(monkeypatch, masks)
    step = make_simmim_train_step(_port_cfg())
    landmark = to_tensors(state_dict_from_flax(land["params"],
                                               land["batch_stats"]))
    images = torch.from_numpy(_images())
    state = simmim_state_from_flax(states[0], device="cpu")
    for i in range(3):
        state, m = step(state, landmark, images, LR, WD)
        _compare(state, simmim_state_from_flax(states[i + 1], device="cpu"),
                 m["loss"].item(), losses[i], i)
    assert not queue
    # every layer of every step took the kernel configuration's paths
    assert taken == {"mlp": 3 * 2, "qkv": 3 * 2}


def test_grid_step_matches_jax(monkeypatch):
    """One step of the grid variant (``use_landmarks=False``: patchify)."""
    states, _, losses, masks = _jax_steps(_jax_cfg(use_landmarks=False), 1)
    _hand_masks(monkeypatch, masks)
    step = make_simmim_train_step(_port_cfg(use_landmarks=False))
    state, m = step(simmim_state_from_flax(states[0], device="cpu"), {},
                    torch.from_numpy(_images()), LR, WD)
    _compare(state, simmim_state_from_flax(states[1], device="cpu"),
             m["loss"].item(), losses[0], 0)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_grads_global_matches_jax(max_norm):
    """Clipped (norm above max_norm) and untouched (below) alike."""
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    want = jax_clip(jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
    got = clip_grads_global({"a": torch.from_numpy(tree["a"]),
                             "b.c": torch.from_numpy(tree["b"]["c"])},
                            max_norm)
    assert _rel(got["a"], want["a"]) <= 1e-6
    assert _rel(got["b.c"], want["b"]["c"]) <= 1e-6
    if max_norm > 10:
        assert torch.equal(got["a"], torch.from_numpy(tree["a"]))


def test_state_round_trip_keeps_bf16_moments():
    """A JAX state with bf16 moments after one step → the port's: params
    fp32, moments bf16 with the same bits (the moment layouts are
    transposes of the params', as the weights'), count and step."""
    states, _, _, _ = _jax_steps(_jax_cfg(moment_dtype=jnp.bfloat16), 1)
    port = simmim_state_from_flax(states[1], device="cpu")
    assert port.step == port.opt_state.count == 1
    assert all(v.dtype == torch.float32 for v in port.params.values())
    mu = port.opt_state.mu
    assert all(v.dtype == torch.bfloat16 for v in mu.values())
    jmu = states[1].opt_state.mu
    want = np.asarray(jmu["backbone"]["transformer"]["layers_0"]["mlp"]
                      ["fc1"]["kernel"]).astype(np.float32).T
    got = mu["backbone.transformer.layers.0.1.fn.fn.net.0.weight"]
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        mu["decoder.weight"].float().numpy(),
        np.asarray(jmu["decoder"]["kernel"]).astype(np.float32).T)


def test_encoder_pth_loads_and_embeds_as_jax(jax_model, tmp_path):
    """A SimMIM encoder ``.pth`` (it has a ``mask_token``) loads through the
    port's ``eval/loading.py`` and embeds images on the grid as JAX does;
    the port's own export of the same weights gives the same file."""
    model, v, _, _ = jax_model
    path = str(tmp_path / "simmim_encoder.pth")
    save_torch_state_dict(export_torch_state_dict(v["params"]), path)
    loaded = load_eval_model(path, device="cpu", log=lambda s: None)
    assert loaded.cfg.simmim and not loaded.cfg.with_land
    x = np.random.default_rng(2).uniform(-1, 1, (3, 48, 48, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(model.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = loaded.model(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= 1e-5
    params = {f"backbone.{k}": t for k, t in
              to_tensors(state_dict_from_flax(v["params"])).items()}
    params["decoder.weight"] = torch.zeros(192, 128)
    exported = simmim_encoder_state_dict(params)
    saved = torch.load(path, weights_only=True)
    assert set(exported) == set(saved)
    assert all(torch.equal(exported[k], saved[k].float()) for k in saved)


# ------------------------------------------------------------- port only --

def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    """With no CUDA device, the constructors refuse to build on the CPU
    unasked, and build there with ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_cfg()
    ssl_cfg = SSLConfig(model=PartFViTConfig(**{**ARCH, "simmim": False}),
                        out_dim=32, head_hidden_dim=64,
                        head_bottleneck_dim=16, compute_dtype=torch.float32)
    for build in (lambda **kw: create_simmim_state(cfg, 0, **kw),
                  lambda **kw: create_ssl_state(ssl_cfg, 0, **kw),
                  lambda **kw: create_landmark_provider(cfg, 0, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        built = build(device="cpu")
        tensors = built if isinstance(built, dict) else (
            built.params if hasattr(built, "params") else built.student)
        assert all(t.device.type == "cpu" for t in tensors.values())


def test_step_is_a_pure_function_of_seed_and_step():
    """Every dropout on (and the fused kernels' masks): the same state
    gives the same result twice, another seed another one; the mask token
    and the weights move, the loss is finite."""
    cfg = _port_cfg(model=dict(dropout=0.1, emb_dropout=0.1,
                               drop_path_rate=0.1))
    state = create_simmim_state(cfg, 0, device="cpu")
    land = create_landmark_provider(cfg, 1, device="cpu")
    step = make_simmim_train_step(cfg)
    images = torch.from_numpy(_images())
    a, ma = step(state, land, images, LR, WD)
    b, mb = step(state, land, images, LR, WD)
    c, mc = step(dataclasses.replace(state, seed=1), land, images, LR, WD)
    assert ma["loss"].item() == mb["loss"].item() != mc["loss"].item()
    assert np.isfinite(ma["loss"].item())
    for key in ("backbone.mask_token",
                "backbone.transformer.layers.0.0.fn.fn.to_qkv.weight"):
        assert torch.equal(a.params[key], b.params[key])
        assert not torch.equal(a.params[key], state.params[key])


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_simmim_train_step(_port_cfg(zero1=True))
