"""PyTorch port: the SSL training step as a whole.

1. Against the JAX package: JAX ``make_ssl_train_step`` on a 1-device mesh
   (plain jit, ``mlp_impl='dense'``, XLA) and the port's step (the fused
   MLP's plain versions on the CPU) start from one state through
   ``ssl_state_from_flax`` and take 3 steps on the same crops. With every
   dropout rate 0, landmark jitter 0 and all landmarks kept, neither step
   draws a random number, so both are deterministic. fp32 throughout.
   Tolerances: the loss of each step 1e-4 relative, the center 1e-5
   absolute, and every leaf of student, teacher and both moments 1e-4
   relative (max-norm per leaf): summation order only, and AdamW's first
   steps (≈ lr·sign(g)) do not amplify it for gradients away from 0.
2. The port's step alone, as ``tests/test_ssl.py`` drives the JAX step:
   finite loss, moving teacher and center, the last-layer freeze, and a
   falling loss on a fixed batch, with dropout and drop path on.

One JAX step is compiled per module (the ``jax_run`` fixture).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from lafs_cvpr2024_tpu.models.partfvit import PartFViTConfig as JaxConfig
from lafs_cvpr2024_tpu.train import ssl as jax_ssl
from lafs_cvpr2024_tpu_torch.models.partfvit import PartFViTConfig
from lafs_cvpr2024_tpu_torch.train.checkpoint import (
    ssl_state_from_flax,
    state_dict_from_flax,
    to_tensors,
)
from lafs_cvpr2024_tpu_torch.train.ssl import (
    SSLConfig,
    assemble_crop_batches,
    create_landmark_provider,
    create_ssl_state,
    make_ssl_train_step,
)

ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256,
            num_patches=36, image_size=48, stn_mode="small", with_land=False,
            loss_type="None", num_classes=0)
DETERMINISTIC = dict(dropout=0.0, emb_dropout=0.0, drop_path_rate=0.0)
RECIPE = dict(out_dim=64, head_hidden_dim=96, head_bottleneck_dim=32,
              local_crops_number=2)
ARGS = dict(lr=5e-4, wd=0.04, momentum=0.996, teacher_temp=0.04,
            freeze_last=1.0)


def _crops(b=4, seed=0):
    rng = np.random.default_rng(seed)
    crops = [rng.uniform(-1, 1, (b, 48, 48, 3)).astype(np.float32)
             for _ in range(4 + 2 * RECIPE["local_crops_number"])]
    return assemble_crop_batches(crops)


def _port_cfg(**over):
    model = PartFViTConfig(**{**ARCH, **over.pop("model", {})})
    return SSLConfig(model=model, compute_dtype=torch.float32,
                     **{**RECIPE, **over})


@pytest.fixture(scope="module")
def jax_run():
    """JAX state, landmark variables and three steps on one batch."""
    cfg = jax_ssl.SSLConfig(
        model=JaxConfig(**ARCH, **DETERMINISTIC, mlp_impl="dense"),
        compute_dtype=jnp.float32, landmark_jitter_std=0.0,
        local_keep_landmarks=0, **RECIPE)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    state = jax.jit(lambda r: jax_ssl.create_ssl_state(cfg, r))(
        jax.random.PRNGKey(0))
    land = jax_ssl.create_landmark_provider(cfg, jax.random.PRNGKey(1))
    # running stats away from (0, 1) so the frozen CNN's eval BN is exercised
    rng = np.random.default_rng(9)
    land = dict(land, batch_stats=jax.tree_util.tree_map(
        lambda s: np.asarray(s) + rng.uniform(0.1, 0.5, s.shape).astype(
            np.float32), land["batch_stats"]))
    step = jax_ssl.make_ssl_train_step(cfg, mesh)
    batch = tuple(map(jnp.asarray, _crops()))
    args = {k: jnp.float32(v) for k, v in ARGS.items()}
    states, losses = [jax.device_get(state)], []
    for _ in range(3):
        state, m = step(state, land, *batch, **args)
        states.append(jax.device_get(state))
        losses.append(float(m["loss"]))
    return states, jax.tree_util.tree_map(np.asarray, land), losses


def _rel_leaf(got, want):
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def test_ssl_state_from_flax_has_the_port_keys(jax_run):
    states, _, _ = jax_run
    port = ssl_state_from_flax(states[0], device="cpu")
    mine = create_ssl_state(_port_cfg(), 0, device="cpu")
    for a, b in ((port.student, mine.student), (port.teacher, mine.teacher),
                 (port.opt_state.mu, mine.opt_state.mu)):
        assert set(a) == set(b)
        assert all(a[k].shape == b[k].shape for k in a)
    assert port.step == 0 and port.opt_state.count == 0
    assert port.center.shape == (1, 64)


def test_three_steps_match_jax(jax_run):
    states, land, losses = jax_run
    cfg = _port_cfg(model=DETERMINISTIC, landmark_jitter_std=0.0,
                    local_keep_landmarks=0)
    step = make_ssl_train_step(cfg)
    landmark = to_tensors(state_dict_from_flax(land["params"],
                                               land["batch_stats"]))
    batch = tuple(torch.from_numpy(a) for a in _crops())
    state = ssl_state_from_flax(states[0], device="cpu")
    for i in range(3):
        state, m = step(state, landmark, *batch, **ARGS)
        want = ssl_state_from_flax(states[i + 1], device="cpu")
        assert abs(m["loss"].item() - losses[i]) <= 1e-4 * abs(losses[i]), i
        assert torch.allclose(state.center, want.center, rtol=0, atol=1e-5), i
        assert state.step == want.step and \
            state.opt_state.count == want.opt_state.count
        for got_t, want_t in ((state.student, want.student),
                              (state.teacher, want.teacher),
                              (state.opt_state.mu, want.opt_state.mu),
                              (state.opt_state.nu, want.opt_state.nu)):
            for k in want_t:
                assert _rel_leaf(got_t[k], want_t[k]) <= 1e-4, (i, k)


@pytest.fixture(scope="module")
def port_setup():
    """The port's step with dropout, drop path, jitter and resampling on."""
    cfg = _port_cfg(local_keep_landmarks=20)
    return (create_ssl_state(cfg, 0, device="cpu"),
            create_landmark_provider(cfg, 1, device="cpu"),
            make_ssl_train_step(cfg),
            tuple(torch.from_numpy(a) for a in _crops()))


def test_port_step_runs(port_setup):
    state, land, step, batch = port_setup
    new, m = step(state, land, *batch, **{**ARGS, "freeze_last": 0.0})
    assert np.isfinite(m["loss"].item())
    assert new.step == 1 and new.opt_state.count == 1
    assert new.center.abs().sum().item() > 0
    key = "backbone.patch_to_embedding.weight"
    assert not torch.allclose(new.teacher[key], state.teacher[key])
    # the step is a pure function of (seed, step): same state, same result
    again, m2 = step(state, land, *batch, **{**ARGS, "freeze_last": 0.0})
    assert m2["loss"].item() == m["loss"].item()
    assert torch.equal(again.student[key], new.student[key])


def test_port_step_freeze_last_layer(port_setup):
    state, land, step, batch = port_setup
    v = "head.last_layer.weight_v"
    g = "head.last_layer.weight_g"
    frozen, _ = step(state, land, *batch, **{**ARGS, "wd": 0.0,
                                             "freeze_last": 0.0})
    assert torch.equal(frozen.student[v], state.student[v])
    thawed, _ = step(state, land, *batch, **{**ARGS, "wd": 0.0,
                                             "freeze_last": 1.0})
    assert not torch.allclose(thawed.student[v], state.student[v])
    # the weight-norm gain is frozen in both (norm_last_layer) at wd 0...
    assert torch.equal(thawed.student[g], state.student[g])
    # ...and moves only by weight decay when wd > 0, as in the JAX tail
    decayed, _ = step(state, land, *batch, **{**ARGS, "lr": 0.1, "wd": 0.1})
    assert torch.allclose(decayed.student[g], 0.99 * state.student[g],
                          rtol=0, atol=1e-6)


def test_port_step_loss_decreases_on_fixed_batch(port_setup):
    state, land, step, batch = port_setup
    losses = []
    for _ in range(5):
        state, m = step(state, land, *batch, **{**ARGS, "wd": 0.0})
        losses.append(m["loss"].item())
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_separate_pass_tail_matches_fused(port_setup):
    """``fused_tail=False`` (clip, gates, adamw_update, ema_update) takes
    the same step as the fused tail, to 1e-6 relative per leaf."""
    state, land, _, batch = port_setup
    cfg = _port_cfg(local_keep_landmarks=20)
    fused, _ = make_ssl_train_step(cfg)(state, land, *batch, **ARGS)
    sep, _ = make_ssl_train_step(dataclasses.replace(cfg, fused_tail=False))(
        state, land, *batch, **ARGS)
    for k in fused.student:
        assert _rel_leaf(sep.student[k], fused.student[k]) <= 1e-6, k
        assert _rel_leaf(sep.teacher[k], fused.teacher[k]) <= 1e-6, k


@pytest.mark.parametrize("over", [
    dict(arch="vit_small"), dict(zero1=True), dict(glo_diff=True),
    dict(random_coor=True), dict(use_bn_in_head=True),
    dict(teacher_dtype=torch.bfloat16), dict(teacher_mlp_impl="dense"),
    dict(optimizer="sgd"),
    dict(optimizer="lars")])
def test_unported_options_raise(over):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_ssl_train_step(_port_cfg(**over))
