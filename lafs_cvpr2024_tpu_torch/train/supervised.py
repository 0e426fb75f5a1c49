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
from ..ops.mixup import MixupConfig, mixup_cutmix
from .device import CUDA, resolve
from .losses import softmax_cross_entropy
from .optim import AdamWState, Tree, adamw_init, adamw_update, param_groups_lrd


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
    at rate 0 sets it there."""
    check_supported(cfg)
    with torch.device("meta"):
        model = PartFViT(cfg.model).train()
    cd = cfg.compute_dtype
    groups = {}

    def loss_and_grads(state: TrainState, images, labels):
        """The microbatch loop: ``(mean loss, mean fp32 grads keyed like
        the params, batch_stats after the last microbatch)``."""
        dev = images.device
        b = images.shape[0] // cfg.acc_step
        leaves = {n: p.detach().requires_grad_()
                  for n, p in state.params.items()}
        grads = {n: torch.zeros_like(p) for n, p in leaves.items()}
        stats, loss_sum = state.batch_stats, None
        seeds = micro_seeds(state.seed, state.step, cfg.acc_step)
        for i, (s_mix, s_drop) in enumerate(seeds):
            imgs, labs = images[i * b:(i + 1) * b], labels[i * b:(i + 1) * b]
            if cfg.input_scale is not None:
                imgs = scale_uint8(imgs, cfg.input_scale)
            imgs, targets = mixup_cutmix(imgs, labs, cfg.mixup,
                                         np.random.default_rng(s_mix))
            # BatchNorm moves these in place: a copy per microbatch
            stats = {n: t.clone() for n, t in stats.items()}
            cast = {n: p.to(cd) for n, p in leaves.items()}
            logits, _ = functional_call(
                model, {**cast, **stats}, (imgs.to(cd),),
                dict(labels=targets, rng=DropoutRNG(s_drop, dev)),
                strict=True)
            loss = softmax_cross_entropy(
                logits.to(torch.promote_types(logits.dtype, torch.float32)),
                targets)
            for n, g in zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()))):
                grads[n] += g
            loss_sum = loss.detach() if loss_sum is None else \
                loss_sum + loss.detach()
        inv = 1.0 / cfg.acc_step
        return (loss_sum * inv, {n: g * inv for n, g in grads.items()},
                stats)

    def update(state: TrainState, loss, grads, stats, lr):
        """The non-finite guard and AdamW with the layer-decay groups:
        ``(params, opt_state, batch_stats, finite)``."""
        if "lr_scale" not in groups:
            groups["lr_scale"], groups["wd"] = param_groups_lrd(
                state.params, cfg.model.depth, cfg.weight_decay,
                cfg.layer_decay, cfg.stn_weight_decay)
        finite = torch.isfinite(loss)
        grads = {n: torch.where(finite, g, torch.zeros_like(g))
                 for n, g in grads.items()}
        stats = {n: torch.where(finite, t, state.batch_stats[n])
                 for n, t in stats.items()}
        params, opt = adamw_update(
            grads, state.opt_state, state.params, lr, wd_scale=groups["wd"],
            wd=1.0, lr_scale=groups["lr_scale"])
        # a zero lr leaves p as it was (the JAX guard's lr·0)
        params = {n: torch.where(finite, p, state.params[n])
                  for n, p in params.items()}
        return params, opt, stats, finite

    def step(state: TrainState, images, labels, lr):
        loss, grads, stats = loss_and_grads(state, images, labels)
        params, opt, stats, finite = update(state, loss, grads, stats, lr)
        new = TrainState(params, stats, opt, state.step + 1, state.seed)
        return new, {"loss": loss,
                     "skipped_nonfinite": 1.0 - finite.float()}

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
