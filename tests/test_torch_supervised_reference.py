"""PyTorch port: the supervised finetuning step against the benchmark's
plain reference (``bench_torch/reference/supervised.py``), which imports
nothing of the port and is the ``finetune_step`` cell's output check.

Both start from one set of seeded random weights (the benchmark's
``weights.generate``) and take three steps of two microbatches on the same
uint8 images and labels, with every dropout on: the landmark branch's
Dropout(0.5), embedding dropout, attention-output dropout, drop path and
the MLP's dropout. The port runs its plain configuration in fp32 on the
CPU (``gather`` gather, ``einsum`` attention) with the MLP on
``fused_ln``, whose plain version draws the fused kernels' counter-hash
masks: the contract the reference follows (the ``dense`` MLP draws its
masks from the device generator instead, which no reference of the
kernels' path repeats). Three mixing cases: none (probability 0), Mixup
and CutMix at probability 1.

Compared, as the cell compares them: each step's loss (the first 1e-6
relative, measured equal; the later ones 1e-4, measured 2e-5: Adam's first
steps move elements with noise-sized gradients by about ±lr either way);
the first step's mean gradient and each leaf's change after three steps,
the gap of each leaf over the larger of its own and the median leaf's
reference norm. The gradients agree to ~4e-6 of that norm (measured),
held at 1e-4. The change, which Adam's first steps take from the sign
pattern of the gradient, is held over the leaves whose reference gradient
is at least a thousandth of the median (the rest, the BatchNorm biases
whose gradient is zero in exact arithmetic, move by round-off alone): to
1e-3 (measured ≤ 4.7e-4), and to 1e-2 on the landmark branch and the patch
embedding (measured ≤ 3.2e-3), whose fp32 gradients are only ~1e-4
accurate elementwise (``test_torch_supervised_step.py``). Six images a
microbatch: with two, a pooled channel that Dropout(0.5) drops in every
image has a zero exact gradient in the last bottlenecks' biases, and its
round-off moved those leaves 9% apart.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from bench_torch.reference import supervised as ref
from bench_torch.runners import finetune_train as ft
from bench_torch.weights import generate
from lafs_cvpr2024_tpu_torch.train.optim import adamw_init
from lafs_cvpr2024_tpu_torch.train.supervised import (
    TrainState,
    make_train_step,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"dim": 128, "depth": 2, "heads": 2, "dim-head": 64, "mlp-dim": 256,
         "num-patches": 36, "image-size": 48, "num-classes": 20,
         "batch-size": 6, "acc-step": 2, "compute-dtype": "float32"}
MIXING = {"none": dict(mixup=0.2, cutmix=0.0, **{"mixup-prob": 0.0}),
          "mixup": dict(mixup=0.2, cutmix=0.0, **{"mixup-prob": 1.0}),
          "cutmix": dict(mixup=0.0, cutmix=1.0, **{"mixup-prob": 1.0})}
SEED = 2 ** 31 + 5
LANDMARK = ("stn.", "output_layer.", "patch_to_embedding.")


def small_config(mixing: str) -> dict:
    with open(os.path.join(ROOT, "bench_torch", "configs",
                           "partfvit_b_finetune.json")) as f:
        m = json.load(f)
    return {**m, **SMALL, **MIXING[mixing]}


def port_step(m: dict):
    cfg = ft.supervised_config(m)
    cfg = dataclasses.replace(
        cfg, compute_dtype=torch.float32,
        model=dataclasses.replace(cfg.model, gather_impl="gather",
                                  attn_impl="einsum", mlp_impl="fused_ln"))
    return make_train_step(cfg)


def batches(m: dict, n: int = 3):
    rng = np.random.default_rng(11)
    k, s = m["batch-size"] * m["acc-step"], m["image-size"]
    return [(torch.from_numpy(rng.integers(0, 256, (k, s, s, 3),
                                           dtype=np.uint8)),
             torch.from_numpy(rng.integers(0, m["num-classes"], k)))
            for _ in range(n)]


def leaf_gaps(got: dict, want: dict, keys) -> float:
    med = float(np.median([float(want[k].norm()) for k in want]))
    return max(float((got[k] - want[k]).norm()) / max(float(want[k].norm()),
                                                      med) for k in keys)


@pytest.mark.parametrize("mixing", sorted(MIXING))
def test_three_steps_match_the_plain_reference(mixing):
    m = small_config(mixing)
    step = port_step(m)
    cpu = torch.device("cpu")
    weights = generate(ft.spec(m), SEED, 0, cpu)
    names = {n for n, _ in step.model.named_parameters()}
    params = {n: t for n, t in weights.items() if n in names}
    stats = {n: t for n, t in weights.items() if n not in names}
    state = TrainState(params, stats, adamw_init(params, torch.float32), 0,
                       SEED)
    data = batches(m)
    losses, first, after = ref.run_steps(
        params, {k: v for k, v in stats.items() if "running_" in k}, data,
        m, SEED)
    grads = None
    for t, (images, labels) in enumerate(data):
        if t == 0:
            _, grads, _ = step.loss_and_grads(state, images, labels)
        state, metrics = step(state, images, labels, m["lr"])
        tol = 1e-6 if t == 0 else 1e-4
        assert abs(metrics["loss"].item() - losses[t]) <= tol * losses[t]
        assert metrics["skipped_nonfinite"].item() == 0.0
    assert leaf_gaps(grads, first, first) <= 1e-4
    med = float(np.median([float(g.norm()) for g in first.values()]))
    moving = [k for k, g in first.items() if float(g.norm()) >= 1e-3 * med]
    assert len(moving) > 0.8 * len(first)
    change = {k: state.params[k] - params[k] for k in params}
    want = {k: after[k] - params[k] for k in params}
    land = [k for k in moving if k.startswith(LANDMARK)]
    assert leaf_gaps(change, want, land) <= 1e-2
    assert leaf_gaps(change, want, set(moving) - set(land)) <= 1e-3
