"""The optimizers of the two training steps (counterpart of part of
``lafs_cvpr2024_tpu/train/optim.py``): AdamW with torch semantics and
low-precision moment storage; for SSL, DINO's per-parameter gradient clip
and weight-decay mask, the last-layer freeze gates and the EMA teacher;
for supervised finetuning, BEiT's layer-wise lr decay and weight-decay
groups (:func:`param_groups_lrd`); for SimMIM, the global-norm clip
(:func:`clip_grads_global`).

Parameters, gradients and moments are flat dicts ``name → tensor`` (the
student's ``state_dict`` names). The update math runs in fp32 whatever the
storage dtype; results are cast back to storage by round-to-nearest-even,
as the JAX casts do. :func:`fused_adamw_ema_update` is the SSL step's tail;
:func:`clip_grads_per_param`, :func:`zero_grads_by_path`,
:func:`adamw_update` and :func:`ema_update` are the separate passes it must
equal. No function here writes into its arguments.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]
f32 = torch.float32


@dataclass
class AdamWState:
    """``count`` steps taken; first and second moments per parameter."""

    count: int
    mu: Tree
    nu: Tree


class FlatTree(dict):
    """Tensors keyed by name that are views of one buffer ``flat``: one
    pass over ``flat`` is a pass over every leaf."""

    def __init__(self, names, shapes, flat: torch.Tensor):
        self.shapes = [torch.Size(s) for s in shapes]
        sizes = [math.prod(s) for s in self.shapes]
        super().__init__(zip(names, (v.view(s) for v, s in
                                     zip(flat.split(sizes), self.shapes))))
        self.flat = flat

    @classmethod
    def copy_of(cls, tree: dict, dtype=None) -> "FlatTree":
        """A copy of ``tree`` (cast to ``dtype``) in one new buffer, made by
        one copy of a :class:`FlatTree`'s buffer, else a ``_foreach_copy_``
        over the leaves."""
        if isinstance(tree, FlatTree):
            return tree.like(tree.flat.to(dtype or tree.flat.dtype,
                                          copy=True))
        leaves = list(tree.values())
        flat = torch.empty(sum(t.numel() for t in leaves),
                           dtype=dtype or leaves[0].dtype,
                           device=leaves[0].device)
        out = cls(list(tree), [t.shape for t in leaves], flat)
        torch._foreach_copy_(list(out.values()), leaves)
        return out

    def like(self, flat: torch.Tensor) -> "FlatTree":
        """The same names and shapes over another buffer."""
        return FlatTree(list(self), self.shapes, flat)


def as_f32(x) -> float:
    """A Python float holding the float32 value of ``x``: the scalar the JAX
    step receives as a float32 array."""
    return float(np.float32(x))


def _bias_corrections(count: int, b1: float, b2: float) -> Tuple[float, float]:
    """1 − β^count in float32, as ``b ** count.astype(f32)`` computes it."""
    one, n = np.float32(1.0), np.float32(count)
    return (float(one - np.float32(b1) ** n), float(one - np.float32(b2) ** n))


def adamw_init(params: Tree, moment_dtype: Optional[torch.dtype] = None
               ) -> AdamWState:
    """Zero moments, stored in ``moment_dtype`` (default: each parameter's
    own dtype); bf16 halves the optimizer's memory traffic, the math stays
    fp32 (``optim.py:63-72``)."""
    def zeros():
        return {n: torch.zeros_like(p, dtype=moment_dtype or p.dtype)
                for n, p in params.items()}
    return AdamWState(count=0, mu=zeros(), nu=zeros())


def dino_wd_mask(params: Tree) -> Dict[str, float]:
    """DINO's parameter groups (``optim.py:396-402``): no weight decay for
    biases and parameters of at most one dimension. A 0/1 scale of the
    scheduled wd per parameter.

    Mirrors the JAX package where it differs from the reference: the
    weight-norm gain ``last_layer.weight_g`` is (K, 1), two-dimensional, so
    it is decayed, although its gradient is gated to 0; the reference
    instead takes it out of the optimizer (``requires_grad=False``)."""
    return {n: 0.0 if (p.ndim <= 1 or n.endswith("bias")) else 1.0
            for n, p in params.items()}


def clip_grads_per_param(grads: Tree, clip: float) -> Tree:
    """Scale each gradient whose 2-norm exceeds ``clip`` down to it
    (``optim.py:359-368``)."""
    return {n: g * torch.clamp(clip / (torch.linalg.vector_norm(g) + 1e-6),
                               max=1.0)
            for n, g in grads.items()}


def clip_grads_global(grads: Tree, max_norm: float) -> Tree:
    """``torch.nn.utils.clip_grad_norm_`` semantics (``optim.py:371-376``):
    the global 2-norm of all gradients in fp32, every gradient scaled by
    ``min(max_norm / (norm + 1e-6), 1)``."""
    names = list(grads)
    g32 = [grads[n].to(f32) for n in names]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g32)))
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {n: grads[n] * coef.to(grads[n].dtype) for n in names}


def zero_grads_by_path(grads: Tree, predicate: Callable[[str], bool]) -> Tree:
    """Zero the gradients whose name matches ``predicate``
    (``optim.py:379-389``)."""
    return {n: torch.zeros_like(g) if predicate(n) else g
            for n, g in grads.items()}


def adamw_update(grads: Tree, state: AdamWState, params: Tree, lr,
                 wd_scale: Optional[Dict[str, float]] = None, wd=0.0,
                 lr_scale: Optional[Dict[str, float]] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                 ) -> Tuple[Tree, AdamWState]:
    """torch.optim.AdamW: ``p -= lr·lr_leaf · (m̂ / (√v̂ + eps) + wd·wd_leaf
    · p)`` (``optim.py:75-124``), one parameter at a time; ``wd_scale`` and
    ``lr_scale`` hold the per-parameter factors (default 1), products taken
    in float32 as the JAX step takes them."""
    count = state.count + 1
    c1, c2 = _bias_corrections(count, b1, b2)
    lr, wd = as_f32(lr), as_f32(wd)
    new_p, mu, nu = {}, {}, {}
    for n, p in params.items():
        g = grads[n].to(f32)
        m = b1 * state.mu[n].to(f32) + (1 - b1) * g
        v = b2 * state.nu[n].to(f32) + (1 - b2) * torch.square(g)
        ws = as_f32(wd * as_f32((wd_scale or {}).get(n, 1.0)))
        ls = as_f32(lr * as_f32((lr_scale or {}).get(n, 1.0)))
        step = (m / c1) / (torch.sqrt(v / c2) + eps) + ws * p.to(f32)
        new_p[n] = (p.to(f32) - ls * step).to(p.dtype)
        mu[n] = m.to(state.mu[n].dtype)
        nu[n] = v.to(state.nu[n].dtype)
    return new_p, AdamWState(count, mu, nu)


def _vit_layer_id(name: str, num_layers: int) -> int:
    """``get_layer_id_for_vit`` (``optim.py:405-414``) on ``state_dict``
    names: 0 for the embeddings and the landmark branch, i + 1 for
    transformer layer i, ``num_layers`` for the rest (``mlp_head``, the
    margin head ``loss``)."""
    if name.startswith(("cls_token", "pos_embedding", "patch_to_embedding",
                        "stn.", "output_layer.")):
        return 0
    if name.startswith("transformer.layers."):
        return int(name.split(".")[2]) + 1
    return num_layers


def param_groups_lrd(params: Tree, depth: int, weight_decay: float = 0.1,
                     layer_decay: float = 0.58, stn_weight_decay: float = 5e-2
                     ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """BEiT layer-wise lr decay (``optim.py:417-439``) on ``state_dict``
    names: ``(lr_scale, wd_value)`` per parameter, the lr scale
    ``layer_decay ** (depth + 1 − layer_id)``, the weight decay 0 for biases
    and parameters of at most one dimension, ``stn_weight_decay`` for the
    landmark stem ``stn.*`` and ``weight_decay`` for the rest (the landmark
    head ``output_layer`` included). Use with ``adamw_update(..., wd=1.0,
    wd_scale=wd_value, lr_scale=lr_scale)``."""
    num_layers = depth + 1
    lr_scale, wd_value = {}, {}
    for n, p in params.items():
        lr_scale[n] = float(layer_decay ** (num_layers
                                            - _vit_layer_id(n, num_layers)))
        if p.ndim <= 1 or n.endswith("bias"):
            wd_value[n] = 0.0
        elif n.startswith("stn."):
            wd_value[n] = float(stn_weight_decay)
        else:
            wd_value[n] = float(weight_decay)
    return lr_scale, wd_value


def ema_update(teacher: Tree, student: Tree, momentum) -> Tree:
    """EMA teacher (``optim.py:651-660``): ``m · t + (1 − m) · s`` in fp32,
    stored in the teacher's dtype."""
    m = as_f32(momentum)
    return {n: (m * t.to(f32) + (1.0 - m) * student[n].to(f32)).to(t.dtype)
            for n, t in teacher.items()}


def _one_layout(*trees) -> bool:
    """Every tree a float32 :class:`FlatTree` of the same names and
    shapes."""
    return all(isinstance(t, FlatTree) and t.flat.dtype == f32
               and list(t) == list(trees[0]) and t.shapes == trees[0].shapes
               for t in trees)


def _adamw_flat(grads, state, params, count, c1, c2, wd, wd_scale, rates,
                keep, b1, b2, eps):
    """:func:`fused_adamw_ema_update`'s AdamW on float32 :class:`FlatTree`
    operands: each element-wise pass one launch over the whole buffer, the
    per-parameter weight decay and lr ``_foreach`` passes over its views.
    The same operations in the same order as the per-list form; the
    divisions by the bias corrections divide by a tensor, as the
    ``_foreach`` division does, rather than multiply by a reciprocal."""
    g, p = grads.flat, params.flat
    m = state.mu.flat * b1
    m += g * (1 - b1)
    v = state.nu.flat * b2
    v += g * g * (1 - b2)
    denom = (v / torch.full((), c2, device=v.device)).sqrt_().add_(eps)
    step = m / torch.full((), c1, device=m.device)
    step /= denom
    views, p_views = list(params.like(step).values()), list(params.values())
    names = list(params)
    for ws in sorted({wd_scale.get(n, 1.0) for n in names} - {0.0}):
        idx = [i for i, n in enumerate(names) if wd_scale.get(n, 1.0) == ws]
        torch._foreach_add_([views[i] for i in idx], torch._foreach_mul(
            [p_views[i] for i in idx], wd * ws))
    if keep is not None:
        step *= keep
    torch._foreach_mul_(views, rates)
    return (params.like(p - step),
            AdamWState(count, params.like(m), params.like(v)), None)


def fused_adamw_ema_update(
    grads: Tree, state: AdamWState, params: Tree, teacher: Optional[Tree],
    lr, wd, momentum, wd_scale: Optional[Dict[str, float]] = None,
    gate: Optional[Dict[str, float]] = None, gate_scalar=1.0,
    clip: float = 0.0, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    lr_scale: Optional[Dict[str, float]] = None,
    keep: Optional[torch.Tensor] = None,
) -> Tuple[Tree, AdamWState, Optional[Tree]]:
    """The whole SSL update tail in one pass over the parameters
    (``optim.py:442-529``): per-parameter gates (gate 1: gradient scaled by
    ``gate_scalar``, the last-layer freeze; gate 2: gradient zeroed, the
    weight-norm gain), the per-parameter norm clip, fp32 AdamW, the casts
    back to storage, and the EMA teacher from the new student. Equal to
    :func:`zero_grads_by_path` + gating + :func:`clip_grads_per_param` +
    :func:`adamw_update` + :func:`ema_update`.

    ``lr_scale`` holds per-parameter lr factors (default 1; BEiT's layer
    decay in the supervised step), multiplied into the lr in float32 as
    :func:`adamw_update` does. ``keep``, a 0-d 0/1 float32 tensor on the
    parameters' device, multiplies every parameter's step: 0 leaves the
    parameters as they were while the moments still move (the supervised
    step's non-finite guard, decided on the card without a wait). Where
    ``grads``, ``params`` and both moments are float32 :class:`FlatTree`
    of one layout and there is no teacher, gate or clip, each pass runs
    over the buffers (:func:`_adamw_flat`) and the results are
    :class:`FlatTree` too.

    The JAX tail is one XLA fusion; here each stage is a ``torch._foreach``
    call over all parameters at once, so the tail launches a few kernels
    per stage rather than a few per parameter. Returns
    ``(student, state, teacher)``, all new tensors; with ``teacher`` None
    (the SimMIM and supervised steps: AdamW alone, no gates, no clip) the
    teacher returned is None too."""
    names = list(params)
    count = state.count + 1
    c1, c2 = _bias_corrections(count, b1, b2)
    lr, wd, momentum = as_f32(lr), as_f32(wd), as_f32(momentum)
    gate, wd_scale, lr_scale = gate or {}, wd_scale or {}, lr_scale or {}
    rates = [as_f32(lr * as_f32(lr_scale.get(n, 1.0))) for n in names]
    if teacher is None and not gate and not clip and _one_layout(
            grads, params, state.mu, state.nu):
        return _adamw_flat(grads, state, params, count, c1, c2, wd,
                           wd_scale, rates, keep, b1, b2, eps)
    g = []
    for n in names:
        gn = grads[n].to(f32)
        if gate.get(n, 0.0) == 2.0:
            gn = torch.zeros_like(gn)
        elif gate.get(n, 0.0) == 1.0:
            gn = gn * as_f32(gate_scalar)
        g.append(gn)
    if clip:
        norms = torch.stack(torch._foreach_norm(g))
        coef = torch.clamp(clip / (norms + 1e-6), max=1.0)
        g = torch._foreach_mul(g, list(coef.unbind()))
    m = torch._foreach_mul([state.mu[n].to(f32) for n in names], b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    v = torch._foreach_mul([state.nu[n].to(f32) for n in names], b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
    denom = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    step = torch._foreach_div(m, c1)
    torch._foreach_div_(step, denom)
    p32 = [params[n].to(f32) for n in names]
    for ws in sorted({wd_scale.get(n, 1.0) for n in names} - {0.0}):
        idx = [i for i, n in enumerate(names) if wd_scale.get(n, 1.0) == ws]
        torch._foreach_add_([step[i] for i in idx],
                            torch._foreach_mul([p32[i] for i in idx], wd * ws))
    if keep is not None:
        torch._foreach_mul_(step, keep)
    torch._foreach_mul_(step, rates)
    p_new = torch._foreach_sub(p32, step)
    student = {n: p.to(params[n].dtype) for n, p in zip(names, p_new)}
    moments = AdamWState(
        count, {n: x.to(state.mu[n].dtype) for n, x in zip(names, m)},
        {n: x.to(state.nu[n].dtype) for n, x in zip(names, v)})
    if teacher is None:
        return student, moments, None
    t = torch._foreach_mul([teacher[n].to(f32) for n in names], momentum)
    torch._foreach_add_(t, torch._foreach_mul(
        [student[n].to(f32) for n in names], 1.0 - momentum))
    return (student, moments,
            {n: x.to(teacher[n].dtype) for n, x in zip(names, t)})
