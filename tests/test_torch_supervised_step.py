"""PyTorch port: the supervised finetuning step as a whole.

1. Against the JAX package: JAX ``make_train_step`` on a 1-device mesh
   (plain jit, ``einsum`` attention, ``dense`` MLP, ``mxu`` gather, XLA)
   and the port's step in its kernel configuration (``fused`` attention,
   ``fused_ln`` MLP, ``kernel`` gather; their plain versions on the CPU)
   start from one state through ``supervised_state_from_flax`` and take 3
   steps of 2 microbatches on the same uint8 images. A tiny Part-fViT with
   127 landmarks, so the 128-token sequence takes the fused attention. With
   every dropout rate 0, mixup at probability 0 and the landmark branch's
   hard-coded Dropout(0.5) neutralised on both sides (a pass-through
   ``flax.linen.Dropout`` while the JAX step traces; ``p = 0`` on the
   port's module), neither step draws a random number. fp32 throughout.

   The state is moved off the JAX init in two ways, so that the comparison
   is well posed: (a) every BatchNorm scale and bias and every bias is
   shifted by a seeded random amount. At flax's init (scale 1, bias 0) the
   landmark CNN has gradients that vanish in exact arithmetic (ReLU is
   homogeneous, a depthwise conv keeps channels apart, and a training-mode
   BatchNorm removes per-channel scale and mean), so both packages return
   rounding noise there; and a zero-initialised bias is, after Adam's first
   steps, just the sign pattern of its gradient. (b) lr is 1e-5: Adam's
   first steps move each element by about lr·sign(g), so an element whose
   fp32 gradient is below rounding noise may flip between the packages; at
   this lr three flips stay below 1e-4 of every leaf. The update itself is
   held against JAX at lr 0.05 in ``test_torch_supervised_parts.py``.

   Tolerances: the loss of each step, every parameter and every BatchNorm
   statistic 1e-4 relative (max-norm per leaf); the AdamW moments 1e-4
   relative, except for the leaves whose gradient runs through the landmark
   CNN or the gathered patch tokens (``stn.*``, ``output_layer.*``,
   ``patch_to_embedding.*``): 1e-3 there (measured: 4.6e-4, against
   4.5e-5 on the other leaves); and the biases of the bottlenecks'
   last BatchNorm that reach the loss only through another training-mode
   BatchNorm (:func:`_zero_grad_leaves`), whose gradient is zero in exact
   arithmetic for any weights: there both packages' moments must be
   rounding noise, ≤ 1e-5 of the landmark CNN's largest. fp32 leaves the
   first group's gradients only ~1e-4 accurate: the port's own fp32
   gradients differ from its float64 ones by up to 1.5e-4 there, against
   3.3e-5 elsewhere (``test_fp32_gradients_match_float64``), and JAX
   rounds differently again.
2. The port's step alone: unported options raise, the non-finite guard
   leaves the parameters and statistics as they were, and the step is a
   pure function of (seed, step).

One JAX step is compiled per module (the ``jax_run`` fixture).
"""

import dataclasses
import re

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from lafs_cvpr2024_tpu.models.partfvit import PartFViTConfig as JaxConfig
from lafs_cvpr2024_tpu.ops.mixup import MixupConfig as JaxMixup
from lafs_cvpr2024_tpu.train import supervised as jax_sup
from lafs_cvpr2024_tpu_torch.models import layers
from lafs_cvpr2024_tpu_torch.models.partfvit import PartFViTConfig
from lafs_cvpr2024_tpu_torch.ops.mixup import MixupConfig
from lafs_cvpr2024_tpu_torch.train.checkpoint import supervised_state_from_flax
from lafs_cvpr2024_tpu_torch.train.supervised import (
    SupervisedConfig,
    create_state,
    make_train_step,
)

ARCH = dict(image_size=48, dim=128, depth=2, heads=2, dim_head=64,
            mlp_dim=256, num_patches=127, stn_mode="small", num_classes=10,
            dropout=0.0, emb_dropout=0.0, drop_path_rate=0.0)
MIX = dict(mixup_alpha=0.2, prob=0.0, num_classes=10)
LR = 1e-5
LOOSE = ("stn.", "output_layer.", "patch_to_embedding.")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (4, 48, 48, 3), dtype=np.uint8),
            np.array([1, 7, 3, 7], np.int32))


def _port_cfg(**over):
    model = PartFViTConfig(**{**ARCH, "attn_impl": "fused",
                              **over.pop("model", {})})
    kw = dict(acc_step=2, mixup=MixupConfig(**MIX),
              compute_dtype=torch.float32, input_scale="unit")
    return SupervisedConfig(model=model, **{**kw, **over})


def _port_step(cfg):
    step = make_train_step(cfg)
    step.model.landmark_dropout.p = 0.0
    return step


def _shift(params, seed=9):
    """Every bias and BatchNorm scale moved by a seeded random amount."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        x = np.asarray(x)
        if "/bn/" in name and name.endswith("scale"):
            return x * rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if "/bn/" in name and name.endswith("bias"):
            return x + rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)
        if name.endswith("bias"):
            return x + rng.uniform(-0.1, 0.1, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(move, params)


@pytest.fixture(scope="module")
def jax_run():
    """JAX state and three steps on one batch."""
    cfg = jax_sup.SupervisedConfig(
        model=JaxConfig(**ARCH, mlp_impl="dense", attn_impl="einsum",
                        gather_impl="mxu"),
        acc_step=2, mixup=JaxMixup(**MIX), compute_dtype=jnp.float32,
        input_scale="unit")
    state = jax.jit(lambda r: jax_sup.create_state(cfg, r))(
        jax.random.PRNGKey(0))
    state = state._replace(params=_shift(state.params))
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    w, w_opt = jax_sup.create_classifier(cfg, jax.random.PRNGKey(1),
                                         enabled=False)
    step = jax_sup.make_train_step(cfg, mesh)
    images, labels = map(jnp.asarray, _batch())
    states, losses = [jax.device_get(state)], []
    with pytest.MonkeyPatch.context() as mp:
        # the landmark branch's nn.Dropout(0.5), neutralised for the trace
        mp.setattr(flax.linen, "Dropout",
                   lambda *a, **k: (lambda x, deterministic=None: x))
        for _ in range(3):
            state, w, w_opt, m = step(state, w, w_opt, images, labels, LR)
            states.append(jax.device_get(state))
            losses.append(float(m["loss"]))
    return states, losses


def _zero_grad_leaves(cfg):
    """The landmark CNN's BatchNorm biases whose gradient is zero in exact
    arithmetic (``MobileNetV3Backbone.shift_invariant_biases``)."""
    stn = make_train_step(cfg).model.stn
    return {f"stn.{n}" for n in stn.shift_invariant_biases()}


def _rel_leaf(got, want):
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def test_supervised_state_from_flax_has_the_port_keys(jax_run):
    states, _ = jax_run
    port = supervised_state_from_flax(states[0], device="cpu")
    mine = create_state(_port_cfg(), 0, device="cpu")
    for a, b in ((port.params, mine.params), (port.opt_state.mu, mine.params),
                 (port.batch_stats, mine.batch_stats)):
        assert set(a) == set(b)
        assert all(a[k].shape == b[k].shape for k in a)
    assert port.step == 0 and port.opt_state.count == 0
    assert port.params["loss.weight"].shape == (10, 128)


def test_three_steps_match_jax(jax_run, monkeypatch):
    states, losses = jax_run
    taken = {"attention": 0, "mlp": 0}

    def spy(fn, key):
        def wrapped(*a, **k):
            taken[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(layers, "fused_attention",
                        spy(layers.fused_attention, "attention"))
    monkeypatch.setattr(layers, "fused_ln_mlp",
                        spy(layers.fused_ln_mlp, "mlp"))
    step = _port_step(_port_cfg())
    zero = _zero_grad_leaves(_port_cfg())
    images, labels = (torch.from_numpy(a) for a in _batch())
    state = supervised_state_from_flax(states[0], device="cpu")
    for i in range(3):
        state, m = step(state, images, labels.long(), LR)
        want = supervised_state_from_flax(states[i + 1], device="cpu")
        assert abs(m["loss"].item() - losses[i]) <= 1e-4 * abs(losses[i]), i
        assert m["skipped_nonfinite"].item() == 0.0
        assert state.step == want.step and \
            state.opt_state.count == want.opt_state.count
        for k in want.params:
            assert _rel_leaf(state.params[k], want.params[k]) <= 1e-4, (i, k)
        for k, t in want.batch_stats.items():
            if t.is_floating_point():
                assert _rel_leaf(state.batch_stats[k], t) <= 1e-4, (i, k)
        for got_t, want_t in ((state.opt_state.mu, want.opt_state.mu),
                              (state.opt_state.nu, want.opt_state.nu)):
            noise = 1e-5 * max(want_t[k].abs().max().item()
                               for k in want_t if k.startswith("stn."))
            for k in want_t:
                if k in zero:
                    assert got_t[k].abs().max().item() <= noise, (i, k)
                    assert want_t[k].abs().max().item() <= noise, (i, k)
                    continue
                tol = 1e-3 if k.startswith(LOOSE) else 1e-4
                assert _rel_leaf(got_t[k], want_t[k]) <= tol, (i, k)
    # both microbatches of each step took the kernel configuration's paths
    assert taken == {"attention": 3 * 2 * 2, "mlp": 3 * 2 * 2}


def test_fp32_gradients_match_float64(jax_run):
    """The port's own rounding: one step's gradients in the kernel
    configuration in fp32 against the plain configuration in float64 (its
    gather, BatchNorm, einsum attention, dense MLP and loss all run in the
    parameters' dtype), every leaf within 1e-3 relative, all but the LOOSE
    ones within 1e-4: the bounds the JAX comparison holds the moments to."""
    states, _ = jax_run
    images, labels = (torch.from_numpy(a) for a in _batch())
    plain = dict(gather_impl="gather", mlp_impl="dense", attn_impl="einsum")
    grads = {}
    for dt, model in ((torch.float32, {}), (torch.float64, plain)):
        state = supervised_state_from_flax(states[0], device="cpu")
        state = dataclasses.replace(
            state, params={k: v.to(dt) for k, v in state.params.items()},
            batch_stats={k: v.to(dt) if v.is_floating_point() else v
                         for k, v in state.batch_stats.items()})
        step = _port_step(_port_cfg(compute_dtype=dt, model=model))
        _, grads[dt], _ = step.loss_and_grads(state, images, labels.long())
    zero = _zero_grad_leaves(_port_cfg())
    noise = 1e-5 * max(g.abs().max().item() for k, g in
                       grads[torch.float64].items() if k.startswith("stn."))
    for k, want in grads[torch.float64].items():
        if k in zero:  # exact zeros: rounding noise in both dtypes
            assert grads[torch.float32][k].abs().max().item() <= noise, k
            continue
        tol = 1e-3 if k.startswith(LOOSE) else 1e-4
        assert _rel_leaf(grads[torch.float32][k], want) <= tol, k


def test_nonfinite_loss_skips_the_update():
    """A NaN batch (float input, no scaling) leaves the parameters and the
    BatchNorm statistics as they were; the moments take their decay on a
    zero gradient and the count moves, as with the JAX step's zero lr
    (``supervised.py:636-663``). A clean batch then steps."""
    cfg = _port_cfg(input_scale=None)
    state = create_state(cfg, 0, device="cpu")
    step = _port_step(cfg)
    labels = torch.tensor([1, 2, 3, 4])
    bad = torch.full((4, 48, 48, 3), float("nan"))
    new, m = step(state, bad, labels, 1e-2)
    assert m["skipped_nonfinite"].item() == 1.0
    assert not np.isfinite(m["loss"].item())
    for k, p in state.params.items():
        assert torch.equal(new.params[k], p), k
    for k, t in state.batch_stats.items():
        assert torch.equal(new.batch_stats[k], t), k
    assert new.opt_state.count == 1 and new.step == 1
    assert all(bool(torch.isfinite(v).all()) for v in new.opt_state.mu.values())
    good = torch.rand(4, 48, 48, 3) * 2 - 1
    newer, m2 = step(new, good, labels, 1e-2)
    assert m2["skipped_nonfinite"].item() == 0.0
    assert np.isfinite(m2["loss"].item())
    key = "transformer.layers.0.0.fn.fn.to_qkv.weight"
    assert not torch.equal(newer.params[key], new.params[key])
    moved = [k for k in newer.batch_stats if k.endswith("running_mean")
             and not torch.equal(newer.batch_stats[k], new.batch_stats[k])]
    assert moved


def test_step_is_a_pure_function_of_seed_and_step():
    """Mixup on (probability 1) and every dropout on: the same state gives
    the same result twice, another seed another one."""
    cfg = _port_cfg(model=dict(dropout=0.1, emb_dropout=0.1,
                               drop_path_rate=0.1),
                    mixup=MixupConfig(mixup_alpha=0.2, cutmix_alpha=1.0,
                                      prob=1.0, num_classes=10))
    state = create_state(cfg, 0, device="cpu")
    step = make_train_step(cfg)
    images, labels = (torch.from_numpy(a) for a in _batch())
    a, ma = step(state, images, labels.long(), 1e-3)
    b, mb = step(state, images, labels.long(), 1e-3)
    c, mc = step(dataclasses.replace(state, seed=1), images, labels.long(),
                 1e-3)
    assert ma["loss"].item() == mb["loss"].item() != mc["loss"].item()
    key = "stn.features.0.0.weight"
    assert torch.equal(a.params[key], b.params[key])
    assert np.isfinite(ma["loss"].item())


@pytest.mark.parametrize("over", [
    dict(network="iresnet50"), dict(factored_head=True),
    dict(pfc_ratio=0.5), dict(zero1=True), dict(landmark_distill=True),
    dict(fused_device_aug=True), dict(flip_only=True),
    dict(model=dict(loss_type="ArcFace"))])
def test_unported_options_raise(over):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(_port_cfg(**over))


def test_landmark_leaf_names_cover_the_loose_set():
    """The LOOSE prefixes name exactly the landmark CNN, its head and the
    patch embedding: every other leaf is held at 1e-4."""
    names = create_state(_port_cfg(), 0, device="cpu").params
    loose = {k for k in names if k.startswith(LOOSE)}
    assert all(re.match(r"(stn\.features\.\d+\.|output_layer\.|"
                        r"patch_to_embedding\.)", k) for k in loose)
    assert "loss.weight" not in loose and len(loose) < len(names)
