"""PyTorch port: the supervised step's passes over its leaves.

- The step, whose cast, gradient sum, scale and guard each run over one
  buffer and whose update is ``fused_adamw_ema_update``'s ``_foreach``
  passes, against the per-leaf form it replaced (a cast, an accumulation
  and a ``where`` a leaf, :func:`~optim.adamw_update` a leaf), written out
  below: three steps from one state in fp32 and in bf16 on the CPU, every
  dropout and mixup on, parameters, moments and statistics equal up to
  fp32 rounding; a NaN batch leaves both at the same place.
- ``fused_adamw_ema_update`` with a per-parameter ``lr_scale`` against
  ``adamw_update`` with the same scales, and at its default (and with
  ``keep`` 1) the same numbers as before for the SSL tail's gates, clip
  and teacher; ``keep`` 0 keeps the parameters and moves the moments.
- The tracer's ``sup.*`` spans and counters with the tracer on, and no
  record with it off.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.func import functional_call

from lafs_cvpr2024_tpu_torch.models.layers import DropoutRNG
from lafs_cvpr2024_tpu_torch.models.partfvit import PartFViTConfig
from lafs_cvpr2024_tpu_torch.ops.augment_device import scale_uint8
from lafs_cvpr2024_tpu_torch.ops.mixup import MixupConfig, mixup_cutmix
from lafs_cvpr2024_tpu_torch.train import optim
from lafs_cvpr2024_tpu_torch.train.losses import softmax_cross_entropy
from lafs_cvpr2024_tpu_torch.train.supervised import (
    SupervisedConfig,
    TrainState,
    create_state,
    make_train_step,
    micro_seeds,
)
from lafs_cvpr2024_tpu_torch.utils import tracing

ARCH = dict(image_size=48, dim=128, depth=2, heads=2, dim_head=64,
            mlp_dim=256, num_patches=36, stn_mode="small", num_classes=10)
LR = 3e-3


def _cfg(dtype=torch.float32, prob=1.0):
    return SupervisedConfig(
        model=PartFViTConfig(**ARCH, attn_impl="fused"), acc_step=2,
        mixup=MixupConfig(mixup_alpha=0.2, prob=prob, num_classes=10),
        compute_dtype=dtype, input_scale="unit")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (4, 48, 48, 3),
                                          dtype=np.uint8)),
            torch.tensor([1, 7, 3, 7]))


def per_leaf_step(cfg: SupervisedConfig, model):
    """The step as one cast, accumulation and ``where`` per leaf, and
    ``adamw_update`` per leaf."""
    cd = cfg.compute_dtype

    def step(state, images, labels, lr):
        b = images.shape[0] // cfg.acc_step
        leaves = {n: p.detach().requires_grad_()
                  for n, p in state.params.items()}
        grads = {n: torch.zeros_like(p) for n, p in leaves.items()}
        stats, loss_sum = state.batch_stats, None
        for i, (s_mix, s_drop) in enumerate(
                micro_seeds(state.seed, state.step, cfg.acc_step)):
            imgs = images[i * b:(i + 1) * b]
            if cfg.input_scale is not None:
                imgs = scale_uint8(imgs, cfg.input_scale)
            imgs, targets = mixup_cutmix(imgs, labels[i * b:(i + 1) * b],
                                         cfg.mixup,
                                         np.random.default_rng(s_mix))
            stats = {n: t.clone() for n, t in stats.items()}
            cast = {n: p.to(cd) for n, p in leaves.items()}
            logits, _ = functional_call(
                model, {**cast, **stats}, (imgs.to(cd),),
                dict(labels=targets, rng=DropoutRNG(s_drop, images.device)),
                strict=True)
            loss = softmax_cross_entropy(logits.float(), targets)
            for n, g in zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()))):
                grads[n] += g
            loss_sum = loss.detach() if loss_sum is None else \
                loss_sum + loss.detach()
        loss = loss_sum / cfg.acc_step
        grads = {n: g * (1.0 / cfg.acc_step) for n, g in grads.items()}
        lr_scale, wd = optim.param_groups_lrd(
            state.params, cfg.model.depth, cfg.weight_decay,
            cfg.layer_decay, cfg.stn_weight_decay)
        finite = torch.isfinite(loss)
        grads = {n: torch.where(finite, g, torch.zeros_like(g))
                 for n, g in grads.items()}
        stats = {n: torch.where(finite, t, state.batch_stats[n])
                 for n, t in stats.items()}
        params, opt = optim.adamw_update(grads, state.opt_state,
                                         state.params, lr, wd_scale=wd,
                                         wd=1.0, lr_scale=lr_scale)
        params = {n: torch.where(finite, p, state.params[n])
                  for n, p in params.items()}
        return TrainState(params, stats, opt, state.step + 1, state.seed)
    return step


def _rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_foreach_step_equals_the_per_leaf_step(dtype):
    cfg = _cfg(dtype)
    step = make_train_step(cfg)
    slow = per_leaf_step(cfg, step.model)
    a = b = create_state(cfg, 0, device="cpu")
    for t in range(3):
        images, labels = _batch(t)
        a, _ = step(a, images, labels, LR)
        b = slow(b, images, labels, LR)
    for got, want in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                      (a.opt_state.nu, b.opt_state.nu),
                      (a.batch_stats, b.batch_stats)):
        assert set(got) == set(want)
        for k in want:
            if want[k].is_floating_point():
                assert _rel(got[k], want[k]) <= 1e-6, k
            else:
                assert torch.equal(got[k], want[k]), k
    assert a.opt_state.count == b.opt_state.count == 3


def test_foreach_guard_equals_the_per_leaf_guard():
    """A NaN batch after a clean one: both forms keep the parameters and
    statistics and decay the moments alike."""
    cfg = dataclasses.replace(_cfg(prob=0.0), input_scale=None)
    step = make_train_step(cfg)
    slow = per_leaf_step(cfg, step.model)
    images, labels = _batch()
    state, _ = step(create_state(cfg, 0, device="cpu"),
                    images.float() / 127.5 - 1.0, labels, LR)
    bad = torch.full((4, 48, 48, 3), float("nan"))
    a, m = step(state, bad, labels, LR)
    b = slow(state, bad, labels, LR)
    assert m["skipped_nonfinite"].item() == 1.0
    for k, p in state.params.items():
        assert torch.equal(a.params[k], p) and torch.equal(b.params[k], p), k
    for k, t in state.batch_stats.items():
        assert torch.equal(a.batch_stats[k], t), k
        assert torch.equal(b.batch_stats[k], t), k
    for k, mu in state.opt_state.mu.items():
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), k
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]), k


def _tree(rng, shapes):
    return {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for n, s in shapes.items()}


SHAPES = {"a.weight": (5, 3), "a.bias": (5,), "b.weight": (4, 5),
          "head.last_layer.weight_g": (4, 1), "c": (7,)}


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16])
def test_fused_update_with_lr_scale_equals_adamw_update(moment_dtype, flat):
    """Per-leaf dicts take the ``_foreach`` passes; float32 ``FlatTree``
    operands the passes over their buffers (bf16 moments: the lists)."""
    rng = np.random.default_rng(3)
    params = _tree(rng, SHAPES)
    lr_scale = {"a.weight": 0.58 ** 3, "a.bias": 0.58 ** 3, "b.weight": 0.58,
                "head.last_layer.weight_g": 1.0, "c": 0.3}
    wd = {"a.weight": 0.1, "a.bias": 0.0, "b.weight": 0.05,
          "head.last_layer.weight_g": 0.1, "c": 0.0}
    fast = slow = optim.adamw_init(params, moment_dtype)
    pf = ps = params
    if flat:
        fast = optim.AdamWState(0, optim.FlatTree.copy_of(fast.mu),
                                optim.FlatTree.copy_of(fast.nu))
        pf = optim.FlatTree.copy_of(params)
    for _ in range(3):
        grads = _tree(rng, SHAPES)
        if flat:
            grads = optim.FlatTree.copy_of(grads)
        pf, fast, _ = optim.fused_adamw_ema_update(
            grads, fast, pf, None, 1e-2, 1.0, 0.0, wd_scale=wd,
            lr_scale=lr_scale)
        ps, slow = optim.adamw_update(grads, slow, ps, 1e-2, wd_scale=wd,
                                      wd=1.0, lr_scale=lr_scale)
    assert isinstance(pf, optim.FlatTree) == (
        flat and moment_dtype == torch.float32)
    for k in params:
        assert _rel(pf[k], ps[k]) <= 1e-6, k
        assert torch.equal(fast.mu[k], slow.mu[k])
        assert torch.equal(fast.nu[k], slow.nu[k])


def test_fused_update_default_lr_scale_and_keep_leave_the_ssl_tail():
    """The SSL tail (gates, clip, teacher) gives the same numbers with the
    default ``lr_scale``, all-1 scales and ``keep`` 1; ``keep`` 0 keeps
    the parameters while the moments move."""
    rng = np.random.default_rng(5)
    params, teacher, grads = (_tree(rng, SHAPES) for _ in range(3))
    state = optim.adamw_init(params, torch.bfloat16)
    kw = dict(wd_scale=optim.dino_wd_mask(params),
              gate={"head.last_layer.weight_g": 2.0, "b.weight": 1.0},
              gate_scalar=0.0, clip=0.5)
    base = optim.fused_adamw_ema_update(grads, state, params, teacher, 5e-3,
                                        0.04, 0.996, **kw)
    for extra in (dict(lr_scale={n: 1.0 for n in params}),
                  dict(keep=torch.tensor(1.0))):
        got = optim.fused_adamw_ema_update(grads, state, params, teacher,
                                           5e-3, 0.04, 0.996, **kw, **extra)
        for x, y in ((got[0], base[0]), (got[1].mu, base[1].mu),
                     (got[1].nu, base[1].nu), (got[2], base[2])):
            assert all(torch.equal(x[k], y[k]) for k in params)
    kept, moved, _ = optim.fused_adamw_ema_update(
        grads, state, params, None, 5e-3, 0.04, 0.0, keep=torch.tensor(0.0))
    stepped, want, _ = optim.fused_adamw_ema_update(
        grads, state, params, None, 5e-3, 0.04, 0.0)
    for k in params:
        assert torch.equal(kept[k], params[k])
        assert not torch.equal(stepped[k], params[k])
        assert torch.equal(moved.mu[k], want.mu[k])
        assert torch.equal(moved.nu[k], want.nu[k])


@pytest.fixture
def tracer():
    tracing.enable(False)
    tracing.reset()
    yield tracing
    tracing.enable(False)
    tracing.reset()


def test_supervised_spans_and_counters(tracer):
    cfg = _cfg()
    state = create_state(cfg, 0, device="cpu")
    step = make_train_step(cfg)
    tracer.enable(True)
    step(state, *_batch(), LR)
    rec = tracer.export()
    spans = {}
    for s in rec["spans"]:
        spans.setdefault(s["name"], []).append(s)
    (top,) = spans["sup.step"]
    assert top["parent"] is None and top["ids"] == {"step": 0}
    micro = spans["sup.micro"]
    assert [s["ids"] for s in micro] == [{"step": 0, "micro": i}
                                         for i in range(cfg.acc_step)]
    (upd,) = spans["sup.update"]
    assert all(s["parent"] == top["id"] for s in micro + [upd])
    assert micro[-1]["end_ns"] <= upd["start_ns"] <= upd["end_ns"]
    assert upd["end_ns"] <= top["end_ns"]
    assert all("device_ms" not in s for s in rec["spans"])  # no card here
    sup = {k: v for k, v in rec["counters"].items() if k.startswith("sup.")}
    assert sup == {"sup.microbatches": 2, "sup.mixed": 2, "sup.nonfinite": 0}
    tracer.reset()
    bad = torch.full((4, 48, 48, 3), float("nan"))
    step(create_state(dataclasses.replace(cfg, input_scale=None), 0,
                      device="cpu"), bad, _batch()[1], LR)
    assert tracer.export()["counters"]["sup.nonfinite"] == 1


def _raise(*a, **kw):
    raise AssertionError("called with tracing off")


def test_supervised_step_off_makes_no_record(tracer, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    cfg = _cfg()
    make_train_step(cfg)(create_state(cfg, 0, device="cpu"), *_batch(), LR)
    assert tracer.export() == {"spans": [], "counters": {}}
