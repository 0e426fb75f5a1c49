"""Supervised Part-fViT finetuning step on one GPU (counterpart of
``lafs_cvpr2024_tpu/train/supervised.py::make_train_step`` with the
in-model CosFace head).

One step takes ``acc_step`` microbatches of images and int labels and, per
microbatch, as the JAX ``lax.scan`` body does (``supervised.py:525-592``):

1. scales uint8 images on the device (``input_scale``);
2. mixes the batch with its mirror (batch-mode Mixup/CutMix, soft targets);
3. runs Part-fViT in training mode on a ``compute_dtype`` copy of the fp32
   master weights: the landmark CNN with batch-statistics BatchNorm and
   Dropout(0.5), the patch gather (differentiable into the regressor), the
   transformer, the CosFace head on the soft targets;
4. takes the soft-target cross-entropy in fp32 and its gradient, summed
   over microbatches in fp32; the BatchNorm running statistics carry from
   one microbatch to the next.

Then the mean over microbatches, the non-finite guard (a non-finite loss
zeroes the gradients, leaves the parameters as they were and reverts the
running statistics; the moments still take their decay, as with the JAX
step's zero lr) and AdamW with BEiT's layer-wise lr decay and weight-decay
groups.

Each pass over the 295 leaves is a few launches, not one a leaf: the
parameters, moments, gradients and statistics live in one buffer each
(``optim.FlatTree``; the first step copies a state of separate tensors
in), so the compute-dtype copy, the gradient sum and its scale are a
launch each and the guard one ``where`` a buffer; the update is
``optim.fused_adamw_ema_update`` with ``teacher=None``, whose element-wise
passes run over the buffers and whose layer-decay lr and weight decay are
``_foreach`` passes over the leaves, with the finite flag as its
``keep``.

Spans and counters (``utils/tracing.py``, when on): ``sup.step`` (host,
``step=k``) holds ``sup.micro`` (host and device, ``step=k, micro=i``: the
scale, mix, forward, loss, backward and gradient sum of one microbatch)
and ``sup.update`` (host and device: the guard and AdamW); counters
``sup.microbatches``, ``sup.mixed`` (microbatches whose mixup draw mixed)
and ``sup.nonfinite`` (steps the guard skipped, counted on the card).

Mixed precision as the JAX step does it (``supervised.py:343-351``), not by
autocast: the WHOLE model, landmark CNN and margin head included, runs on a
cast copy of the fp32 masters through ``torch.func.functional_call``; the
cross-entropy runs on fp32 logits.

The step's randomness is a pure function of (state.seed, state.step): one
mixup seed (a numpy generator: the draws are host scalars) and one dropout
seed per microbatch (:func:`micro_seeds`).

Not ported yet, and raising: other networks, the factored head and
PartialFC, ZeRO-1, landmark distillation, the fused device augmentation,
``flip_only``, and more than one GPU (ROADMAP.md, Open items 1.11).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..models.layers import DropoutRNG
from ..models.partfvit import PartFViT, PartFViTConfig, init_random_
from ..ops.augment_device import scale_uint8
from ..ops.mixup import (
    MixupConfig,
    draw_mixup,
    mix_with_draws,
    mixup_cutmix,
)
from ..utils import tracing
from .device import CUDA, resolve
from .losses import softmax_cross_entropy
from .optim import (
    AdamWState,
    FlatTree,
    Tree,
    adamw_init,
    fused_adamw_ema_update,
    param_groups_lrd,
)


@dataclass(frozen=True)
class SupervisedConfig:
    """The JAX ``SupervisedConfig``'s fields and defaults
    (``supervised.py:52-137``); dtypes are torch dtypes. The model's impl
    defaults are the port's kernel configuration: ``gather_impl='kernel'``,
    ``mlp_impl='fused_ln'`` and ``attn_impl='fused'`` (kernels 1, 2/3 and
    6/7); ``'gather'``/``'dense'``/``'einsum'`` is the plain one."""

    model: PartFViTConfig = field(
        default_factory=lambda: PartFViTConfig(attn_impl="fused"))
    network: str = "partfvit"
    iresnet_avg: bool = False
    acc_step: int = 3
    weight_decay: float = 0.1
    layer_decay: float = 0.58
    stn_weight_decay: float = 5e-2
    mixup: MixupConfig = field(default_factory=lambda: MixupConfig(prob=0.1))
    compute_dtype: torch.dtype = torch.bfloat16
    shard_classifier: bool = True
    landmark_distill: bool = False
    fused_device_aug: bool = False
    rand_aug: str = "rand-m1-mstd0.5-inc1"
    flip_only: bool = False
    input_scale: Optional[str] = None
    moment_dtype: torch.dtype = torch.float32
    factored_head: bool = False
    pfc_ratio: float = 1.0
    pfc_sampler: str = "block"
    zero1: bool = False


def check_supported(cfg: SupervisedConfig) -> None:
    """Raise for what the port's supervised step does not carry yet."""
    multi = (torch.distributed.is_available()
             and torch.distributed.is_initialized()
             and torch.distributed.get_world_size() > 1)
    unported = [
        (cfg.network != "partfvit", f"network={cfg.network!r}"),
        (cfg.factored_head, "factored_head"),
        (cfg.pfc_ratio < 1.0, "pfc_ratio < 1 (PartialFC)"),
        (cfg.zero1, "zero1"),
        (cfg.landmark_distill, "landmark_distill"),
        (cfg.fused_device_aug, "fused_device_aug"),
        (cfg.flip_only, "flip_only"),
        (multi, "more than one GPU (DDP, shard_classifier)"),
        (cfg.model.loss_type != "CosFace",
         f"loss_type={cfg.model.loss_type!r}"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(
                f"the port's supervised step does not carry {what} yet "
                "(ROADMAP.md, Open items 1.11)")


@dataclass
class TrainState:
    """fp32 master ``params`` and the landmark CNN's BatchNorm
    ``batch_stats`` as flat dicts under the model's ``state_dict`` names,
    the AdamW state over the params, the step count and the seed that the
    step's randomness derives from."""

    params: Tree
    batch_stats: Tree
    opt_state: AdamWState
    step: int
    seed: int


def create_state(cfg: SupervisedConfig, seed: int,
                 device=CUDA) -> TrainState:
    """Random Part-fViT with its CosFace head from ``seed``
    (:func:`~..models.partfvit.init_random_`), zero moments in
    ``moment_dtype``; load real weights with
    ``train.checkpoint.supervised_state_from_flax`` instead. On the card
    unless ``device`` says otherwise."""
    check_supported(cfg)
    device = resolve(device)
    model = init_random_(PartFViT(cfg.model), seed).to(device)
    params = {n: p.detach() for n, p in model.named_parameters()}
    return TrainState(
        params=params,
        batch_stats={n: b for n, b in model.named_buffers()},
        opt_state=adamw_init(params, cfg.moment_dtype),
        step=0, seed=int(seed))


def micro_seeds(seed: int, step: int, acc_step: int):
    """(mixup seed, dropout seed) of each microbatch of one step."""
    s = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        2 * acc_step)
    return [(int(s[2 * i]), int(s[2 * i + 1])) for i in range(acc_step)]


def _mix(images, labels, mix: MixupConfig, seed: int):
    """Mixup/CutMix of one microbatch with the draws of ``seed``; counts
    ``sup.mixed`` when the draw mixes."""
    rng = np.random.default_rng(seed)
    if not mix.enabled or mix.mode != "batch":
        return mixup_cutmix(images, labels, mix, rng)
    draws = draw_mixup(mix, images.shape[1], images.shape[2], rng)
    tracing.count("sup.mixed", int(draws.apply))
    return mix_with_draws(images, labels, mix, draws)


def make_train_step(cfg: SupervisedConfig) -> Callable:
    """Build ``step(state, images, labels, lr) -> (state, metrics)``.

    ``images`` (acc_step·B, H, W, 3) on the state's device, uint8 when
    ``cfg.input_scale`` is set, else float in [-1, 1]; ``labels``
    (acc_step·B,) int class ids; ``lr`` the scheduled Python float.
    Returns a new state (the input state is not written) and
    ``{"loss", "skipped_nonfinite"}`` as 0-d tensors. The model built here
    is a template on the meta device (``step.model``): every parameter and
    buffer comes from the state through ``functional_call``. Its
    ``landmark_dropout.p`` is the JAX module's hard-coded 0.5; a comparison
    at rate 0 sets it there.

    Passes over the parameters are a few launches each, not one a leaf:
    the ``compute_dtype`` copy is one copy a step into one buffer, whose
    views are the leaves the model runs on; each microbatch's gradients
    are joined by one ``cat`` and summed into one fp32 buffer
    (``optim.FlatTree``); the BatchNorm statistics are copied once a step
    into one buffer that the microbatches move in place. The returned
    state's parameters and moments are :class:`~.optim.FlatTree` too."""
    check_supported(cfg)
    with torch.device("meta"):
        model = PartFViT(cfg.model).train()
    cd = cfg.compute_dtype
    groups = {}

    def loss_and_grads(state: TrainState, images, labels):
        """The microbatch loop: ``(mean loss, mean fp32 grads keyed like
        the params, the float BatchNorm statistics after the last
        microbatch)``, the grads and statistics as :class:`FlatTree`."""
        dev = images.device
        b = images.shape[0] // cfg.acc_step
        cast = FlatTree.copy_of(state.params, cd)
        leaves = {n: t.detach().requires_grad_() for n, t in cast.items()}
        # BatchNorm moves these in place: one copy, carried across microbatches
        stats = FlatTree.copy_of({n: t for n, t in state.batch_stats.items()
                                  if t.is_floating_point()})
        acc, loss_sum = None, None
        seeds = micro_seeds(state.seed, state.step, cfg.acc_step)
        for i, (s_mix, s_drop) in enumerate(seeds):
            with tracing.span("sup.micro", step=state.step, micro=i), \
                    tracing.device_span("sup.micro", dev, step=state.step,
                                        micro=i):
                tracing.count("sup.microbatches")
                imgs = images[i * b:(i + 1) * b]
                labs = labels[i * b:(i + 1) * b]
                if cfg.input_scale is not None:
                    imgs = scale_uint8(imgs, cfg.input_scale)
                imgs, targets = _mix(imgs, labs, cfg.mixup, s_mix)
                logits, _ = functional_call(
                    model, {**leaves, **state.batch_stats, **stats},
                    (imgs.to(cd),),
                    dict(labels=targets, rng=DropoutRNG(s_drop, dev)),
                    strict=True)
                loss = softmax_cross_entropy(
                    logits.to(torch.promote_types(logits.dtype,
                                                  torch.float32)),
                    targets)
                g = torch.cat([x.reshape(-1) for x in torch.autograd.grad(
                    loss, list(leaves.values()))])
                acc = g.float() if acc is None else acc.add_(g)
                loss_sum = loss.detach() if loss_sum is None else \
                    loss_sum + loss.detach()
        inv = 1.0 / cfg.acc_step
        return loss_sum * inv, cast.like(acc.mul_(inv)), stats

    def update(state: TrainState, loss, grads: FlatTree, stats: FlatTree,
               lr):
        """The non-finite guard and AdamW with the layer-decay groups:
        ``(params, opt_state, batch_stats, finite)``. A non-finite loss
        zeroes the gradients, keeps the parameters and the statistics as
        they were and lets the moments decay: one ``where`` over each
        buffer, and the finite flag as the update's ``keep``."""
        if "lr_scale" not in groups:
            groups["lr_scale"], groups["wd"] = param_groups_lrd(
                state.params, cfg.model.depth, cfg.weight_decay,
                cfg.layer_decay, cfg.stn_weight_decay)
        with tracing.span("sup.update", step=state.step), \
                tracing.device_span("sup.update", loss.device,
                                    step=state.step):
            finite = torch.isfinite(loss)
            grads = grads.like(torch.where(finite, grads.flat, 0.0))
            before = FlatTree.copy_of({n: state.batch_stats[n]
                                       for n in stats})
            stats = {**state.batch_stats, **stats.like(
                torch.where(finite, stats.flat, before.flat))}
            # a state of separate tensors goes into one buffer each, once
            params, mu, nu = (t if isinstance(t, FlatTree)
                              else FlatTree.copy_of(t)
                              for t in (state.params, state.opt_state.mu,
                                        state.opt_state.nu))
            params, opt, _ = fused_adamw_ema_update(
                grads, AdamWState(state.opt_state.count, mu, nu), params,
                None, lr, 1.0, 0.0, wd_scale=groups["wd"],
                lr_scale=groups["lr_scale"], keep=finite.float())
        return params, opt, stats, finite

    def step(state: TrainState, images, labels, lr):
        with tracing.span("sup.step", step=state.step):
            loss, grads, stats = loss_and_grads(state, images, labels)
            params, opt, stats, finite = update(state, loss, grads, stats,
                                                lr)
        new = TrainState(params, stats, opt, state.step + 1, state.seed)
        skipped = 1.0 - finite.float()
        tracing.count("sup.nonfinite", skipped)
        return new, {"loss": loss, "skipped_nonfinite": skipped}

    # the template and the parts, for callers that compare or time them
    step.model = model
    step.loss_and_grads = loss_and_grads
    step.update = update
    return step


def make_embed_fn(cfg: SupervisedConfig, input_scale: Optional[str] = None,
                  compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """Eval-time embedding function for ``perform_val`` and IJB sweeps
    (``supervised.py:828-876``): ``embed(variables, images) -> (B, dim)``
    fp32, where ``variables`` is ``{**state.params, **state.batch_stats}``
    (the margin head's ``loss.*`` leaves are ignored).

    ``input_scale`` ('half' = x/255−0.5, 'unit' = x/255·2−1): ``images``
    are RAW uint8 on the device and are scaled there (pair with
    ``perform_val(..., device_scale=True)``). ``compute_dtype`` (e.g.
    ``torch.bfloat16``): the float leaves and the images are cast for the
    forward; ``None`` keeps fp32. One GPU, so no batch sharding.

    The model keeps ``cfg.model``'s impls: the port's eval runs the kernel
    configuration (gather kernel, ``fused_ln``), where the JAX function
    forces the dense MLP (a TPU measurement); both compute the same
    function on the same weights."""
    mcfg = dataclasses.replace(cfg.model, loss_type="None", num_classes=0)
    with torch.device("meta"):
        model = PartFViT(mcfg).eval()

    @torch.no_grad()
    def embed(variables, images):
        if input_scale is not None:
            images = scale_uint8(images, input_scale)
        tree = {n: v for n, v in variables.items() if not n.startswith("loss.")}
        if compute_dtype is not None:
            tree = {n: v.to(compute_dtype) if v.is_floating_point() else v
                    for n, v in tree.items()}
            images = images.to(compute_dtype)
        return functional_call(model, tree, (images,), strict=True).float()

    return embed
