"""SimMIM masked-image-modeling pretraining step on one GPU (counterpart of
``lafs_cvpr2024_tpu/train/simmim.py``).

One step, split as the JAX step is split (``simmim.py:132-198``):

1. uint8 images are scaled on the device (``input_scale``);
2. patch tokens: the frozen landmark CNN predicts landmarks and 8×8
   patches are gathered there (``use_landmarks``, eval mode, no gradient),
   or the image is cut on the fixed grid (:func:`~..ops.patchify.patchify`);
3. a Bernoulli(``mask_ratio``) patch mask (:func:`draw_mask`);
4. Part-fViT with ``simmim=True`` in training mode on a ``compute_dtype``
   copy of the fp32 masters: masked patch embeddings become the learned
   ``mask_token``, and the output tokens come back (``return_tokens``);
5. a linear decoder (dim → patch pixels) in fp32 and the L1 loss on the
   masked patches only, normalised by their count;
6. the backward, the global-norm clip (``clip_grad``) and AdamW with DINO's
   weight-decay groups (``dino_wd_mask``; the 3-D ``mask_token``, like
   ``cls_token``, is decayed, as in JAX).

Mixed precision as the JAX step does it, not by autocast: the fp32 master
parameters are cast to ``compute_dtype`` and fed to the backbone through
``torch.func.functional_call``, so gradients flow back through the cast.
The step's randomness is a pure function of (state.seed, state.step): one
seed for the mask, one for the dropout (:func:`step_seeds`).

Not ported yet, and raising: ``zero1`` and more than one GPU (ROADMAP.md,
Open items 1.13). The SimMIM CLI waits for the jax-free host side (items
1.8-1.9).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..models.layers import DropoutRNG
from ..models.partfvit import (
    LandmarkProvider,
    PartFViT,
    PartFViTConfig,
    init_random_,
    truncated_normal,
)
from ..ops.augment_device import scale_uint8
from ..ops.patchify import patchify
from .device import CUDA, resolve
from .optim import (
    AdamWState,
    Tree,
    adamw_init,
    clip_grads_global,
    dino_wd_mask,
    fused_adamw_ema_update,
)


@dataclass(frozen=True)
class SimMIMConfig:
    """The JAX ``SimMIMConfig``'s fields and defaults (``simmim.py:38-57``);
    dtypes are torch dtypes. The model's impl defaults are the port's kernel
    configuration of this step: ``gather_impl='kernel'``,
    ``mlp_impl='fused'`` and ``attn_impl='lnqkv'`` (kernels 1, 4/5 and 8/9);
    ``'gather'``/``'dense'``/``'einsum'`` is the plain one."""

    model: PartFViTConfig = field(
        default_factory=lambda: PartFViTConfig(
            with_land=False, loss_type="None", num_classes=0, simmim=True,
            mlp_impl="fused", attn_impl="lnqkv"))
    mask_ratio: float = 0.6
    clip_grad: float = 5.0
    input_scale: Optional[str] = None
    compute_dtype: torch.dtype = torch.bfloat16
    moment_dtype: torch.dtype = torch.float32
    use_landmarks: bool = True
    zero1: bool = False


def check_supported(cfg: SimMIMConfig) -> None:
    """Raise for what the port's SimMIM step does not carry yet."""
    multi = (torch.distributed.is_available()
             and torch.distributed.is_initialized()
             and torch.distributed.get_world_size() > 1)
    for bad, what in ((cfg.zero1, "zero1"),
                      (multi, "more than one GPU (DDP)")):
        if bad:
            raise NotImplementedError(
                f"the port's SimMIM step does not carry {what} yet "
                "(ROADMAP.md, Open items 1.13)")


@dataclass
class SimMIMTrainState:
    """fp32 master ``params`` as one flat dict (``backbone.*`` under the
    reference ``state_dict`` names, ``decoder.weight`` (patch_dim, dim) and
    ``decoder.bias``), the AdamW state over them, the step count and the
    seed that the step's randomness derives from."""

    params: Tree
    opt_state: AdamWState
    step: int
    seed: int


def _backbone(cfg: SimMIMConfig) -> PartFViT:
    over = {"with_land": False, "loss_type": "None", "simmim": True}
    return PartFViT(PartFViTConfig(**{**cfg.model.__dict__, **over}))


def _patch_dim(cfg: SimMIMConfig) -> int:
    return cfg.model.channels * cfg.model.patch_size ** 2


def create_simmim_state(cfg: SimMIMConfig, seed: int,
                        device=CUDA) -> SimMIMTrainState:
    """Random backbone from ``seed`` (:func:`~..models.partfvit.
    init_random_`), the decoder weight from flax's ``truncated_normal(0.02)``
    and a zero bias (``simmim.py:93-99``), zero moments in
    ``moment_dtype``. On the card unless ``device`` says otherwise; load a
    JAX state with ``train.checkpoint.simmim_state_from_flax`` instead."""
    check_supported(cfg)
    device = resolve(device)
    bb = init_random_(_backbone(cfg), seed)
    params = {f"backbone.{k}": v for k, v in bb.state_dict().items()}
    rng = np.random.default_rng(seed + 1)
    params["decoder.weight"] = torch.from_numpy(
        truncated_normal(rng, (cfg.model.dim, _patch_dim(cfg)), 0.02).T.copy())
    params["decoder.bias"] = torch.zeros(_patch_dim(cfg))
    params = {k: v.to(device) for k, v in params.items()}
    return SimMIMTrainState(params=params,
                            opt_state=adamw_init(params, cfg.moment_dtype),
                            step=0, seed=int(seed))


def step_seeds(seed: int, step: int):
    """(mask seed, dropout seed) of one step."""
    return [int(s) for s in
            np.random.SeedSequence([int(seed), int(step)]).generate_state(2)]


def draw_mask(seed: int, b: int, n: int, ratio: float,
              device) -> torch.Tensor:
    """(B, N) float32 patch mask, 1 with probability ``ratio``
    (``jax.random.bernoulli``'s uniform < p), from a generator on
    ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return (torch.rand((b, n), generator=gen, device=device)
            < ratio).to(torch.float32)


def make_simmim_train_step(cfg: SimMIMConfig) -> Callable:
    """Build ``step(state, landmark, images, lr, wd) -> (state, metrics)``.

    ``landmark``: the frozen landmark CNN's state
    (``train.ssl.create_landmark_provider(cfg, seed)``; not read when
    ``use_landmarks`` is False); ``images`` (B, H, W, 3) on the state's
    device, uint8 when ``cfg.input_scale`` is set, else float in [-1, 1];
    ``lr``, ``wd`` Python floats. Returns a new state (the input state is
    not written) and ``{"loss": 0-d tensor}``. The modules built here are
    templates on the meta device (``step.backbone``): every parameter
    comes from the state through ``functional_call``."""
    check_supported(cfg)
    m = cfg.model
    with torch.device("meta"):
        backbone = _backbone(cfg).train()
        provider = LandmarkProvider(
            num_landmarks=m.num_patches, patch_size=m.patch_size,
            stn_mode=m.stn_mode, coord_scale=float(m.image_size - 1),
            gather_impl=m.gather_impl).eval()
    cd = cfg.compute_dtype

    def tokens_and_mask(landmark: Tree, images, mask_seed: int):
        """Patch tokens (B, N, P·P·C) in the images' float dtype, no
        gradient, and the step's mask."""
        if cfg.input_scale is not None:
            images = scale_uint8(images, cfg.input_scale)
        with torch.no_grad():
            if cfg.use_landmarks:
                _, tokens = functional_call(provider, landmark, (images,),
                                            strict=True)
            else:
                tokens = patchify(images, m.patch_size)
        b, n = tokens.shape[:2]
        return tokens, draw_mask(mask_seed, b, n, cfg.mask_ratio,
                                 images.device)

    def loss_and_grads(state: SimMIMTrainState, tokens, mask, drop_seed: int):
        """Backbone in ``compute_dtype``, fp32 decoder and masked L1:
        ``(loss, grads keyed like the params)``; a parameter the loss does
        not reach (the ``mlp_head`` norm) gets a zero gradient, as JAX's
        ``value_and_grad`` gives it."""
        leaves = {n: p.detach().requires_grad_()
                  for n, p in state.params.items()}
        bbp = {k[len("backbone."):]: v.to(cd) for k, v in leaves.items()
               if k.startswith("backbone.")}
        _, out, _ = functional_call(
            backbone, bbp, (tokens.to(cd),),
            dict(rng=DropoutRNG(drop_seed, tokens.device), mask=mask,
                 return_tokens=True), strict=True)
        rec = (torch.matmul(out.float(), leaves["decoder.weight"].t())
               + leaves["decoder.bias"])
        err = (rec - tokens.float()).abs().mean(-1)
        loss = (err * mask).sum() / mask.sum().clamp_min(1.0)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                               for (n, p), g in zip(leaves.items(), grads)}

    def update(state: SimMIMTrainState, grads, lr, wd):
        """The global clip and AdamW: ``(params, opt_state)``."""
        if cfg.clip_grad:
            grads = clip_grads_global(grads, cfg.clip_grad)
        params, opt, _ = fused_adamw_ema_update(
            grads, state.opt_state, state.params, None, lr, wd, 0.0,
            wd_scale=dino_wd_mask(state.params))
        return params, opt

    def step(state: SimMIMTrainState, landmark: Tree, images, lr, wd):
        s_mask, s_drop = step_seeds(state.seed, state.step)
        tokens, mask = tokens_and_mask(landmark, images, s_mask)
        loss, grads = loss_and_grads(state, tokens, mask, s_drop)
        params, opt = update(state, grads, lr, wd)
        return (SimMIMTrainState(params, opt, state.step + 1, state.seed),
                {"loss": loss})

    # the templates and the parts, for callers that compare or time them
    step.backbone = backbone
    step.tokens_and_mask = tokens_and_mask
    step.loss_and_grads = loss_and_grads
    step.update = update
    return step
