"""LAFS self-supervised pretraining step on one GPU (counterpart of
``lafs_cvpr2024_tpu/train/ssl.py``, ``arch='partfvit'``).

One step, split as the JAX step is split (``ssl.py:392-767``):

1. ``make_tokens``: the frozen landmark CNN predicts landmarks on the CLEAN
   view of each crop (eval mode, no gradient, in ``landmark_dtype``); 8×8
   patches are gathered from the AUGMENTED view: all landmarks with
   N(0, jitter²) noise for the 2 globals, ``local_keep_landmarks`` drawn
   with replacement for the locals;
2. the deterministic teacher forward on the 2B global token rows;
3. the student forward on all crops in training mode (dropout, embedding
   dropout, drop path), the DINO loss, and the backward;
4. the fused tail: gates, per-parameter clip, AdamW, EMA teacher.

Crops are stacked crop-major, ``(2, B, …) → (2B, …)`` and
``(L, B, …) → (LB, …)``, so head rows come crop by crop as the loss wants.
With ``fused_device_aug`` the step takes the raw uint8 batch (B, H, W, 3)
on the card in place of the crops and runs the LAFS multi-crop
(``ops/augment_device.py::lafs_multicrop_device``) first, as the JAX step
does (``ssl.py:546-571``).

Mixed precision as the JAX step does it (``ssl.py:454-478``), not by
autocast: the fp32 master parameters are cast to ``compute_dtype`` and fed
to the backbone through ``torch.func.functional_call``, so gradients flow
back through the cast to the fp32 leaves; the head runs in ``head_dtype``
on its own cast; LayerNorm and softmax run in whatever dtype their inputs
have, as in the JAX graph.

The step's randomness is a pure function of (state.seed, state.step), as
the JAX step folds ``state.step`` into ``state.rng`` (``ssl.py:530``):
three child seeds drive the landmark jitter/resampling and the dropout of
the global and local student forwards, and a fourth, keyed by 11 as JAX
folds 11 into the step key, the device multi-crop.

Spans (``utils/tracing.py``, when on): ``ssl.step`` (``step=k``) around the
parts ``ssl.multicrop``, ``ssl.tokens``, ``ssl.teacher``, ``ssl.student``
(forward, DINO loss, backward) and ``ssl.tail``, each both a host span and
a device span; callers that run the parts one by one record none.

Not ported yet, and raising: the other archs, ``zero1``, ``glo_diff``,
``random_coor``, ``use_bn_in_head``, a bf16 teacher, SGD/LARS and more
than one GPU (ROADMAP.md, Open items).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch.func import functional_call

from ..models.heads import DINOHead, init_dino_head_
from ..models.layers import DropoutRNG
from ..models.partfvit import (
    LandmarkProvider,
    PartFViT,
    PartFViTConfig,
    init_random_,
)
from ..ops.augment_device import lafs_multicrop_device
from ..utils import tracing
from .device import CUDA, resolve
from .losses import dino_loss
from .optim import (
    AdamWState,
    Tree,
    adamw_init,
    as_f32,
    adamw_update,
    clip_grads_per_param,
    dino_wd_mask,
    ema_update,
    fused_adamw_ema_update,
    zero_grads_by_path,
)


@dataclass(frozen=True)
class SSLConfig:
    """The JAX ``SSLConfig``'s fields and defaults (``ssl.py:70-167``);
    dtypes are torch dtypes. The model's impl defaults are the port's:
    its kernels (``gather_impl='kernel'``, ``mlp_impl='fused_ln'``)."""

    model: PartFViTConfig = field(
        default_factory=lambda: PartFViTConfig(
            with_land=False, loss_type="None", num_classes=0))
    arch: str = "partfvit"
    local_crop_size: int = 48
    out_dim: int = 100000
    head_hidden_dim: int = 2048
    head_bottleneck_dim: int = 256
    use_bn_in_head: bool = False
    norm_last_layer: bool = True
    local_crops_number: int = 8
    local_keep_landmarks: int = 36
    landmark_jitter_std: float = 5.0
    glo_diff: bool = False
    random_coor: bool = False
    global_crops_scale: tuple = (0.4, 1.0)
    local_crops_scale: tuple = (0.05, 0.4)
    student_temp: float = 0.1
    center_momentum: float = 0.9
    clip_grad: float = 3.0
    freeze_last_layer_epochs: int = 1
    compute_dtype: torch.dtype = torch.bfloat16
    head_dtype: torch.dtype = torch.float32
    landmark_dtype: torch.dtype = torch.float32
    moment_dtype: torch.dtype = torch.float32
    teacher_dtype: torch.dtype = torch.float32
    teacher_mlp_impl: str = "same"
    optimizer: str = "adamw"
    fused_tail: bool = True
    zero1: bool = False
    fused_device_aug: bool = False

    @property
    def ncrops(self) -> int:
        return self.local_crops_number + 2


def check_supported(cfg: SSLConfig) -> None:
    """Raise for what the port's SSL step does not carry yet."""
    unported = [
        (cfg.arch != "partfvit", f"arch={cfg.arch!r}", "1.13"),
        (cfg.zero1, "zero1", "1.13"),
        (cfg.glo_diff, "glo_diff", "1.13"),
        (cfg.random_coor, "random_coor", "1.4"),
        (cfg.use_bn_in_head, "use_bn_in_head", "1.5"),
        (cfg.teacher_dtype != torch.float32, "a bf16 teacher", "1.13"),
        (cfg.teacher_mlp_impl not in ("same", cfg.model.mlp_impl),
         f"teacher_mlp_impl={cfg.teacher_mlp_impl!r}", "1.13"),
        (cfg.optimizer != "adamw", f"optimizer={cfg.optimizer!r}", "1.13"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(
                f"the port's SSL step does not carry {what} yet (ROADMAP.md, "
                f"Open items {item})")


@dataclass
class SSLTrainState:
    """Student and teacher as flat dicts ``backbone.*``/``head.*`` →
    tensor (the reference MultiCropWrapper's keys), the AdamW state over
    the student's names, the (1, K) center, the step count and the seed
    that the step's randomness derives from."""

    student: Tree
    teacher: Tree
    opt_state: AdamWState
    center: torch.Tensor
    step: int
    seed: int


def _backbone(cfg: SSLConfig) -> PartFViT:
    over = {"with_land": False, "loss_type": "None"}
    return PartFViT(PartFViTConfig(**{**cfg.model.__dict__, **over}))


def _head(cfg: SSLConfig) -> DINOHead:
    return DINOHead(cfg.model.dim, cfg.out_dim, cfg.head_hidden_dim,
                    cfg.head_bottleneck_dim, use_bn=cfg.use_bn_in_head)


def _provider(cfg: SSLConfig) -> LandmarkProvider:
    return LandmarkProvider(
        num_landmarks=cfg.model.num_patches, patch_size=cfg.model.patch_size,
        stn_mode=cfg.model.stn_mode,
        coord_scale=float(cfg.model.image_size - 1),
        gather_impl=cfg.model.gather_impl)


def create_ssl_state(cfg: SSLConfig, seed: int,
                     device=CUDA) -> SSLTrainState:
    """Random student from ``seed`` (backbone on ``init_random_``'s scales,
    head on the JAX head's); the teacher is a copy of it
    (``lafs_train.py:377``); zero moments in ``moment_dtype``; zero
    center. On the card unless ``device`` says otherwise."""
    check_supported(cfg)
    device = resolve(device)
    bb = init_random_(_backbone(cfg), seed)
    hd = init_dino_head_(_head(cfg), seed + 1)
    student = {f"backbone.{k}": v for k, v in bb.state_dict().items()}
    student.update({f"head.{k}": v for k, v in hd.state_dict().items()})
    student = {k: v.to(device) for k, v in student.items()}
    return SSLTrainState(
        student=student,
        teacher={k: v.to(cfg.teacher_dtype, copy=True)
                 for k, v in student.items()},
        opt_state=adamw_init(student, cfg.moment_dtype),
        center=torch.zeros(1, cfg.out_dim, device=device),
        step=0, seed=int(seed))


def create_landmark_provider(cfg, seed: int, device=CUDA) -> Tree:
    """The frozen landmark CNN's state (``stn.*``, ``output_layer.*``,
    BatchNorm buffers), random from ``seed``, for any config with a
    ``model`` field (the SSL and SimMIM steps'); load real weights with
    ``train.checkpoint.state_dict_from_flax`` instead. On the card unless
    ``device`` says otherwise."""
    device = resolve(device)
    provider = init_random_(_provider(cfg), seed)
    return {k: v.to(device) for k, v in provider.state_dict().items()}


def assemble_crop_batches(crops):
    """The 20-array LAFSMultiCrop output → the 4 stacked step inputs
    (``ssl.py:779-790``): crops ordered [g1_clean, g1_aug, g2_clean,
    g2_aug, l1_clean, l1_aug, ...], each (B, H, W, 3)."""
    stack = torch.stack if isinstance(crops[0], torch.Tensor) else np.stack
    return (stack([crops[0], crops[2]]), stack([crops[1], crops[3]]),
            stack(crops[4::2]), stack(crops[5::2]))


def step_seeds(seed: int, step: int):
    """(landmark, global dropout, local dropout) seeds of one step."""
    return [int(s) for s in
            np.random.SeedSequence([int(seed), int(step)]).generate_state(3)]


def aug_seed(seed: int, step: int) -> int:
    """The seed of one step's device multi-crop (JAX: ``fold_in(rng,
    11)`` of the step key)."""
    return int(np.random.SeedSequence([int(seed), int(step), 11])
               .generate_state(1)[0])


def make_ssl_train_step(cfg: SSLConfig) -> Callable:
    """Build ``step(state, landmark, glob_clean, glob_aug, loc_clean,
    loc_aug, lr, wd, momentum, teacher_temp, freeze_last) -> (state,
    metrics)``.

    ``landmark`` is the landmark CNN's state (:func:`create_landmark_
    provider`); glob_*: (2, B, H, W, 3) and loc_*: (L, B, H, W, 3) float
    crops in [-1, 1] on the state's device; with ``cfg.fused_device_aug``
    ``glob_clean`` is the raw uint8 batch (B, H, W, 3) instead and the
    other three are ignored (pass None); the scalars are Python floats.
    Returns a new state (the input state is not written) and
    ``{"loss": 0-d tensor}``. The modules built here are templates on the
    meta device: every parameter comes from the state through
    ``functional_call``, so the step runs wherever the state lies."""
    check_supported(cfg)
    with torch.device("meta"):
        student_bb = _backbone(cfg).train()
        teacher_bb = _backbone(cfg).eval()
        head = _head(cfg)
        provider = _provider(cfg).eval()
    n_loc = cfg.local_crops_number
    cd, hdt = cfg.compute_dtype, cfg.head_dtype

    def make_tokens(landmark, glob_clean, glob_aug, loc_clean, loc_aug, gen):
        """Frozen landmark branch (no gradients, ``lafs_train.py:381-382``)."""
        b = glob_clean.shape[1]
        ld = cfg.landmark_dtype
        lstate = {k: v.to(ld) if v.is_floating_point() else v
                  for k, v in landmark.items()}

        def tokens(clean, aug, n, **kw):
            clean = clean.reshape(n * b, *clean.shape[2:]).to(ld)
            aug = aug.reshape(n * b, *aug.shape[2:]).to(ld)
            _, tok = functional_call(
                provider, lstate, (clean,),
                dict(x_aug=aug, generator=gen,
                     jitter_std=cfg.landmark_jitter_std, **kw), strict=True)
            return tok

        with torch.no_grad():
            return (tokens(glob_clean, glob_aug, 2),
                    tokens(loc_clean, loc_aug, n_loc,
                           ran_sample=cfg.local_keep_landmarks))

    def forward(bb, params, g_tokens, l_tokens, rngs):
        """Backbone on each crop group in ``compute_dtype``, the head in
        ``head_dtype`` on the concatenated embeddings; fp32 logits."""
        bbp = {k[len("backbone."):]: v.to(cd) for k, v in params.items()
               if k.startswith("backbone.")}
        hdp = {k[len("head."):]: v.to(hdt) for k, v in params.items()
               if k.startswith("head.")}
        outs = [functional_call(bb, bbp, (g_tokens.to(cd),),
                                {"rng": rngs[0]}, strict=True)]
        if l_tokens is not None:
            outs.append(functional_call(bb, bbp, (l_tokens.to(cd),),
                                        {"rng": rngs[1]}, strict=True))
        emb = torch.cat(outs).to(hdt)
        return functional_call(head, hdp, (emb,), strict=True).float()

    def gate(name: str) -> float:
        """1: the last layer, scaled by freeze_last; 2: the weight-norm
        gain, frozen by ``norm_last_layer`` (``ssl.py:623-629``)."""
        if cfg.norm_last_layer and name.endswith("last_layer.weight_g"):
            return 2.0
        return 1.0 if "last_layer" in name else 0.0

    def teacher_forward(state: SSLTrainState, g_in):
        """Deterministic teacher on the global tokens (``ssl.py:588-591``)."""
        with torch.no_grad():
            return forward(teacher_bb, state.teacher, g_in, None, (None, None))

    def student_loss_and_grads(state: SSLTrainState, g_in, l_in, teacher_out,
                               teacher_temp, seeds):
        """Student forward in training mode, DINO loss and backward:
        ``(loss, new_center, grads)`` with grads keyed like the student."""
        dev = state.center.device
        params = {n: p.detach().requires_grad_()
                  for n, p in state.student.items()}
        student_out = forward(student_bb, params, g_in, l_in,
                              tuple(DropoutRNG(s, dev) for s in seeds))
        loss, new_center = dino_loss(
            student_out, teacher_out, state.center, as_f32(teacher_temp),
            cfg.ncrops, student_temp=cfg.student_temp,
            center_momentum=cfg.center_momentum)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), new_center.detach(), dict(zip(params, grads))

    def tail(state: SSLTrainState, grads, lr, wd, momentum, freeze_last):
        """Gates, clip, AdamW and EMA: ``(student, opt_state, teacher)``."""
        wd_mask = dino_wd_mask(state.student)
        if cfg.fused_tail:
            return fused_adamw_ema_update(
                grads, state.opt_state, state.student, state.teacher, lr, wd,
                momentum, wd_scale=wd_mask,
                gate={n: gate(n) for n in state.student},
                gate_scalar=freeze_last, clip=cfg.clip_grad or 0.0)
        if cfg.clip_grad:
            grads = clip_grads_per_param(grads, cfg.clip_grad)
        grads = {n: g * as_f32(freeze_last) if "last_layer" in n else g
                 for n, g in grads.items()}
        if cfg.norm_last_layer:
            grads = zero_grads_by_path(
                grads, lambda n: n.endswith("last_layer.weight_g"))
        student, opt = adamw_update(grads, state.opt_state, state.student,
                                    lr, wd_scale=wd_mask, wd=wd)
        return student, opt, ema_update(state.teacher, student, momentum)

    def step(state: SSLTrainState, landmark: Tree, glob_clean, glob_aug,
             loc_clean, loc_aug, lr, wd, momentum, teacher_temp, freeze_last):
        k, dev = state.step, state.center.device
        span, dspan = tracing.span, tracing.device_span
        with span("ssl.step", step=k):
            s_land, s_glob, s_loc = step_seeds(state.seed, k)
            if cfg.fused_device_aug:
                with (span("ssl.multicrop", step=k),
                      dspan("ssl.multicrop", dev, step=k)):
                    gen = torch.Generator(device=dev).manual_seed(
                        aug_seed(state.seed, k))
                    glob_clean, glob_aug, loc_clean, loc_aug = (
                        lafs_multicrop_device(
                            glob_clean, gen, local_crops_number=n_loc,
                            out_size=cfg.model.image_size,
                            global_crops_scale=tuple(cfg.global_crops_scale)))
            with span("ssl.tokens", step=k), dspan("ssl.tokens", dev, step=k):
                g_in, l_in = make_tokens(
                    landmark, glob_clean, glob_aug, loc_clean, loc_aug,
                    torch.Generator(device=dev).manual_seed(s_land))
            with (span("ssl.teacher", step=k),
                  dspan("ssl.teacher", dev, step=k)):
                teacher_out = teacher_forward(state, g_in)
            with (span("ssl.student", step=k),
                  dspan("ssl.student", dev, step=k)):
                loss, new_center, grads = student_loss_and_grads(
                    state, g_in, l_in, teacher_out, teacher_temp,
                    (s_glob, s_loc))
            with span("ssl.tail", step=k), dspan("ssl.tail", dev, step=k):
                student, opt, teacher = tail(state, grads, lr, wd, momentum,
                                             freeze_last)
        return (SSLTrainState(student, teacher, opt, new_center,
                              k + 1, state.seed), {"loss": loss})

    # the parts, for callers that time or compare them one by one
    step.make_tokens = make_tokens
    step.teacher_forward = teacher_forward
    step.student_loss_and_grads = student_loss_and_grads
    step.tail = tail
    return step
