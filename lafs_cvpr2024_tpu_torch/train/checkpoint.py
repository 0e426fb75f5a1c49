"""Checkpoint interop for the port (counterpart of part of
``lafs_cvpr2024_tpu/train/checkpoint.py``).

:func:`state_dict_from_flax` turns a JAX Part-fViT tree, given as nested
dicts of numpy arrays, into the reference ``state_dict`` dialect the port's
modules carry — the same keys, layouts and values as the JAX package's
``export_torch_state_dict`` (``train/checkpoint.py:1150-1247``), a DINO
head under ``head`` included. It is numpy-only; :func:`to_tensors` makes
``torch`` tensors of the result. :func:`ssl_state_from_flax`,
:func:`supervised_state_from_flax` and :func:`simmim_state_from_flax` turn
a whole JAX ``SSLTrainState``, supervised ``TrainState`` or
``SimMIMTrainState`` into the port's, so both packages can start from one
state; :func:`simmim_encoder_state_dict` exports a SimMIM state's encoder
for the port's server.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

# our module name → torch Sequential index inside MobileBottleneck.conv
# (reference mobilenet.py:96-109; JAX checkpoint.py:1016-1023)
_BOTTLENECK_INV = {
    "pw": ("0", "conv"),
    "pw_norm": ("1", "bn"),
    "dw": ("3", "conv"),
    "dw_norm": ("4", "bn"),
    "pw_linear": ("7", "conv"),
    "pw_linear_norm": ("8", "bn"),
}
_BN_LEAF = {"scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}
_DENSE_LEAF = {"kernel": "weight", "bias": "bias"}


def strip_prefixes(state_dict: Dict[str, Any],
                   prefixes=("module.", "backbone.", "encoder.")):
    """Reference prefix surgery (``train_largescale.py:639-648``)."""
    out = {}
    for k, v in state_dict.items():
        if "dummy_orthogonal_classifier" in k:
            continue
        for p in prefixes:
            k = k.replace(p, "")
        out[k] = v
    return out


def _np32(x) -> np.ndarray:
    v = np.asarray(x)
    # torch has no numpy-bfloat16 bridge; normalise all non-f32 floats
    if v.dtype.name in ("bfloat16", "float16", "float64"):
        v = v.astype(np.float32)
    return v


def _conv(arr: np.ndarray) -> np.ndarray:
    # flax (H, W, I, O) → torch (O, I, H, W); depthwise (H, W, 1, O) alike
    return arr.transpose(3, 2, 0, 1)


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _stn(rest: Tuple[str, ...], arr, out) -> bool:
    """(stem | block_i, …) under ``stn`` → ``stn.features.*``."""
    if rest[0] == "stem":
        if rest[1:] == ("conv", "kernel"):
            out["stn.features.0.0.weight"] = _conv(arr)
            return True
        if rest[1:3] == ("norm", "bn") and rest[3] in _BN_LEAF:
            out[f"stn.features.0.1.{_BN_LEAF[rest[3]]}"] = arr
            return True
        return False
    m = re.match(r"block_(\d+)$", rest[0])
    if not m:
        return False
    base = f"stn.features.{int(m.group(1)) + 1}.conv"
    if rest[1] == "se":
        fc = {"fc1": "0", "fc2": "2"}.get(rest[2])
        if fc is None or rest[3] != "kernel":
            return False
        out[f"{base}.5.fc.{fc}.weight"] = arr.T
        return True
    if rest[1] not in _BOTTLENECK_INV:
        return False
    idx, kind = _BOTTLENECK_INV[rest[1]]
    if kind == "conv":
        if rest[2] != "kernel":
            return False
        out[f"{base}.{idx}.weight"] = _conv(arr)
        return True
    if rest[2] != "bn" or rest[3] not in _BN_LEAF:
        return False
    out[f"{base}.{idx}.{_BN_LEAF[rest[3]]}"] = arr
    return True


def _transformer(rest: Tuple[str, ...], arr, out) -> bool:
    """(layers_i, …) under ``transformer`` → the reference
    ``Residual(PreNorm(fn))`` layout, ``transformer.layers.{i}.{0|1}.fn.*``."""
    m = re.match(r"layers_(\d+)$", rest[0])
    if not m or len(rest) < 3:
        return False
    pre = f"transformer.layers.{int(m.group(1))}"
    sub = rest[1:]
    if sub[0] in ("norm1", "norm2") and sub[1] in ("scale", "bias"):
        half = "0" if sub[0] == "norm1" else "1"
        out[f"{pre}.{half}.fn.norm.{_BN_LEAF[sub[1]]}"] = arr
        return True
    if sub[0] == "attn" and len(sub) == 3:
        if sub[1:] == ("to_qkv", "kernel"):
            out[f"{pre}.0.fn.fn.to_qkv.weight"] = arr.T
            return True
        if sub[1] == "to_out" and sub[2] in _DENSE_LEAF:
            leaf = _DENSE_LEAF[sub[2]]
            out[f"{pre}.0.fn.fn.to_out.0.{leaf}"] = (
                arr.T if leaf == "weight" else arr)
            return True
    if sub[0] == "mlp" and len(sub) == 3 and sub[2] in _DENSE_LEAF:
        idx = {"fc1": "0", "fc2": "3"}.get(sub[1])
        if idx is None:
            return False
        leaf = _DENSE_LEAF[sub[2]]
        out[f"{pre}.1.fn.fn.net.{idx}.{leaf}"] = (
            arr.T if leaf == "weight" else arr)
        return True
    return False


def _dino_head(rest: Tuple[str, ...], arr, out) -> bool:
    """(mlp_i | last_layer_g | last_layer_v, …) under ``head`` →
    ``head.mlp.{2i}.*`` (Linear layers at 0/2/4 with GELUs between) and the
    weight-norm ``head.last_layer.weight_{g,v}`` (JAX
    ``_export_dino_head``, ``train/checkpoint.py:1131-1147``)."""
    m = re.match(r"mlp_(\d+)$", rest[0])
    if m and len(rest) == 2 and rest[1] in _DENSE_LEAF:
        leaf = _DENSE_LEAF[rest[1]]
        out[f"head.mlp.{2 * int(m.group(1))}.{leaf}"] = (
            arr.T if leaf == "weight" else arr)
        return True
    if rest == ("last_layer_g",):
        out["head.last_layer.weight_g"] = arr.reshape(-1, 1)
        return True
    if rest == ("last_layer_v",):
        out["head.last_layer.weight_v"] = arr
        return True
    return False


def state_dict_from_flax(params: Dict[str, Any],
                         batch_stats: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, np.ndarray]:
    """JAX Part-fViT ``params``/``batch_stats`` (nested dicts of arrays) →
    reference ``state_dict`` of numpy arrays, with a zero
    ``num_batches_tracked`` beside every BatchNorm so a ``strict=True``
    load is satisfied. Paths the port's modules do not carry raise."""
    out: Dict[str, np.ndarray] = {}
    unmapped = []
    trees = [(params, "params")]
    if batch_stats:
        trees.append((batch_stats, "batch_stats"))
    for tree, col in trees:
        for path, val in sorted(_flatten(tree).items()):
            arr = _np32(val)
            ok = False
            if path[0] == "landmark" and len(path) > 2:
                if path[1] == "output_layer" and path[2] in _DENSE_LEAF:
                    leaf = _DENSE_LEAF[path[2]]
                    out[f"output_layer.{leaf}"] = (
                        arr.T if leaf == "weight" else arr)
                    ok = True
                elif path[1] == "stn":
                    ok = _stn(path[2:], arr, out)
            elif path in (("cls_token",), ("pos_embedding",),
                          ("mask_token",)):
                out[path[0]] = arr
                ok = True
            elif path[0] == "patch_to_embedding" and path[1] in _DENSE_LEAF:
                leaf = _DENSE_LEAF[path[1]]
                out[f"patch_to_embedding.{leaf}"] = (
                    arr.T if leaf == "weight" else arr)
                ok = True
            elif path[0] == "transformer":
                ok = _transformer(path[1:], arr, out)
            elif path[0] == "mlp_head" and path[1] in ("scale", "bias"):
                out[f"mlp_head.0.{_BN_LEAF[path[1]]}"] = arr
                ok = True
            elif path == ("loss", "weight"):  # CosFace (C, D), as torch's
                out["loss.weight"] = arr
                ok = True
            elif path[0] == "head" and len(path) > 1:
                ok = _dino_head(path[1:], arr, out)
            if not ok:
                unmapped.append(f"{col}/" + "/".join(path))
    if unmapped:
        raise ValueError(
            f"state_dict_from_flax: {len(unmapped)} paths have no place in "
            f"the port's Part-fViT: {unmapped[:12]}"
        )
    for k in [k for k in out if k.endswith("running_mean")]:
        out[k[: -len("running_mean")] + "num_batches_tracked"] = np.array(
            0, np.int64)
    return out


def _student_dict(tree, what: str):
    """JAX ``{"backbone": …, "head": …}`` → the port's flat
    ``backbone.*``/``head.*`` dict of tensors, in the leaves' own dtype
    (bfloat16 leaves stay bfloat16)."""
    import torch

    if set(tree) != {"backbone", "head"}:
        raise ValueError(f"ssl_state_from_flax: {what} has keys {sorted(tree)}"
                         ", not {'backbone', 'head'}")
    leaves = _flatten(tree)
    bf16 = {np.asarray(v).dtype.name == "bfloat16" for v in leaves.values()}
    if len(bf16) > 1:
        raise ValueError(f"ssl_state_from_flax: {what} mixes bfloat16 and "
                         "other leaves")
    sd = state_dict_from_flax({**tree["backbone"], "head": tree["head"]})
    out = {(k if k.startswith("head.") else f"backbone.{k}"): v
           for k, v in to_tensors(sd).items()}
    return {k: v.to(torch.bfloat16) if bf16 == {True} else v
            for k, v in out.items()}


def ssl_state_from_flax(state, seed: int = 0, device="cuda"):
    """A JAX ``SSLTrainState`` with numpy leaves → the port's
    ``train.ssl.SSLTrainState``: student and teacher (backbone + DINO
    head), the AdamW moments under the student's keys and layouts (the
    layout maps are permutations, so they move moments as they move
    weights), the count, the center and the step. The port's step derives
    its randomness from ``seed``, not from the JAX key. Unmapped paths
    raise; the step's ``functional_call(strict=True)`` checks the keys
    against its modules. On the card unless ``device`` says otherwise."""
    import torch

    from .device import resolve
    from .optim import AdamWState
    from .ssl import SSLTrainState

    device = resolve(device)

    if state.stats not in ((), None, {}):
        raise ValueError("ssl_state_from_flax: BatchNorm stats (BN archs, "
                         "use_bn_in_head) are not ported")

    def dev(tree):
        return {k: v.to(device) for k, v in tree.items()}

    opt = state.opt_state
    return SSLTrainState(
        student=dev(_student_dict(state.student, "student")),
        teacher=dev(_student_dict(state.teacher, "teacher")),
        opt_state=AdamWState(count=int(np.asarray(opt.count)),
                             mu=dev(_student_dict(opt.mu, "mu")),
                             nu=dev(_student_dict(opt.nu, "nu"))),
        center=torch.from_numpy(np.array(state.center, np.float32)).to(device),
        step=int(np.asarray(state.step)), seed=int(seed))


def supervised_state_from_flax(state, seed: int = 0, device="cuda"):
    """A JAX supervised ``TrainState`` with numpy leaves (in-model CosFace
    head) → the port's ``train.supervised.TrainState``: params, the
    landmark CNN's BatchNorm ``batch_stats``, both AdamW moments under the
    params' keys and layouts, the count and the step. bfloat16 moments stay
    bfloat16. The port's step derives its randomness from ``seed``, not
    from the JAX key. Unmapped paths raise. On the card unless ``device``
    says otherwise."""
    from .device import resolve
    from .optim import AdamWState
    from .supervised import TrainState

    device = resolve(device)

    def tree(t, stats=None):
        leaves = list(_flatten(t).values())
        bf16 = bool(leaves) and all(np.asarray(v).dtype.name == "bfloat16"
                                    for v in leaves)
        sd = to_tensors(state_dict_from_flax({} if stats else t, stats))
        return {k: (v.bfloat16() if bf16 else v).to(device)
                for k, v in sd.items()}

    opt = state.opt_state
    return TrainState(
        params=tree(state.params),
        batch_stats=tree({}, state.batch_stats) if state.batch_stats else {},
        opt_state=AdamWState(count=int(np.asarray(opt.count)),
                             mu=tree(opt.mu), nu=tree(opt.nu)),
        step=int(np.asarray(state.step)), seed=int(seed))


def simmim_state_from_flax(state, seed: int = 0, device="cuda"):
    """A JAX ``SimMIMTrainState`` with numpy leaves (``{"backbone": …,
    "decoder": {"kernel", "bias"}}`` params, dense AdamW moments) → the
    port's ``train.simmim.SimMIMTrainState``: ``backbone.*`` in the
    reference dialect and ``decoder.weight`` (192, dim), the transpose of
    the (dim, 192) kernel, with both moments under the same keys and
    layouts, the count and the step. bfloat16 moments stay bfloat16. The
    port's step derives its randomness from ``seed``, not from the JAX
    key. Unmapped paths raise. On the card unless ``device`` says
    otherwise."""
    import torch

    from .device import resolve
    from .optim import AdamWState
    from .simmim import SimMIMTrainState

    device = resolve(device)

    def tree(t):
        if set(t) != {"backbone", "decoder"}:
            raise ValueError(f"simmim_state_from_flax: keys {sorted(t)}, not "
                             "{'backbone', 'decoder'}")
        bf16 = {np.asarray(v).dtype.name == "bfloat16"
                for v in _flatten(t).values()}
        out = {f"backbone.{k}": v for k, v in
               to_tensors(state_dict_from_flax(t["backbone"])).items()}
        dec = t["decoder"]
        out["decoder.weight"] = torch.from_numpy(_np32(dec["kernel"]).T.copy())
        out["decoder.bias"] = torch.from_numpy(_np32(dec["bias"]).copy())
        return {k: (v.bfloat16() if bf16 == {True} else v).to(device)
                for k, v in out.items()}

    opt = state.opt_state
    params, mu, nu = tree(state.params), tree(opt.mu), tree(opt.nu)
    if any(m[k].shape != p.shape for m in (mu, nu) for k, p in params.items()):
        raise ValueError("simmim_state_from_flax: the moments are not laid "
                         "out as the params (ZeRO-1 chunks are not ported)")
    return SimMIMTrainState(
        params=params,
        opt_state=AdamWState(count=int(np.asarray(opt.count)), mu=mu, nu=nu),
        step=int(np.asarray(state.step)), seed=int(seed))


def simmim_encoder_state_dict(params) -> dict:
    """The encoder of a SimMIM state's ``params`` as a reference-dialect
    ``state_dict`` (``backbone.`` stripped, ``decoder.*`` dropped: the JAX
    package exports the backbone alone, ``train/checkpoint.py:316-325``),
    on the CPU, ready for ``torch.save`` and the port's ``.pth`` loader."""
    return {k[len("backbone."):]: v.detach().cpu() for k, v in params.items()
            if k.startswith("backbone.")}


def to_tensors(state_dict: Dict[str, np.ndarray]):
    """numpy ``state_dict`` → contiguous CPU ``torch`` tensors."""
    import torch

    return {k: torch.from_numpy(np.array(v)) for k, v in state_dict.items()}


# ----------------------------------------------------- training runs --
# (counterpart of make_training_checkpointer, PreemptionGuard and
# load_landmark_variables in lafs_cvpr2024_tpu/train/checkpoint.py; torch
# files in place of orbax directories)

def ssl_state_payload(state) -> dict:
    """An ``SSLTrainState`` as a dict of tensors and ints for ``torch.save``
    (student, teacher, AdamW count and moments, center, step, seed)."""
    return dict(student=state.student, teacher=state.teacher,
                opt_count=state.opt_state.count, opt_mu=state.opt_state.mu,
                opt_nu=state.opt_state.nu, center=state.center,
                step=state.step, seed=state.seed)


def ssl_state_from_payload(payload: dict):
    """Inverse of :func:`ssl_state_payload`."""
    from .optim import AdamWState
    from .ssl import SSLTrainState

    return SSLTrainState(
        student=payload["student"], teacher=payload["teacher"],
        opt_state=AdamWState(count=int(payload["opt_count"]),
                             mu=payload["opt_mu"], nu=payload["opt_nu"]),
        center=payload["center"], step=int(payload["step"]),
        seed=int(payload["seed"]))


class TrainingCheckpointer:
    """Rolling training checkpoints in one directory, ``step_<N>.pt``:
    ``save`` writes one atomically (a temporary file, then a rename) and
    keeps the latest ``keep`` plus, with ``keep_period``, every step that is
    a multiple of it (the reference's permanent ``checkpoint{epoch:04}.pth``
    every ``saveckp_freq`` epochs, ``lafs_train.py:459-463``), as the JAX
    ``CheckpointWriter`` retains them (``train/checkpoint.py:50-116``). The
    write is synchronous."""

    def __init__(self, path: str, keep: int = 3,
                 keep_period: Optional[int] = None):
        self.path = path
        self.keep = keep
        self.keep_period = keep_period

    def _file(self, step: int) -> str:
        import os

        return os.path.join(self.path, f"step_{step:09d}.pt")

    def steps(self) -> list:
        """Steps saved in the directory, ascending."""
        import os

        if not os.path.isdir(self.path):
            return []
        return sorted(int(f[5:-3]) for f in os.listdir(self.path)
                      if re.fullmatch(r"step_\d+\.pt", f))

    def save(self, step: int, payload: dict) -> None:
        import os

        import torch

        os.makedirs(self.path, exist_ok=True)
        tmp = self._file(step) + f".{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._file(step))
        steps = self.steps()
        latest = set(steps[-self.keep:])
        for s in steps:
            if s not in latest and not (self.keep_period
                                        and s % self.keep_period == 0):
                os.remove(self._file(s))

    def restore(self, device) -> Tuple[Optional[dict], Optional[int]]:
        """``(payload, step)`` of the latest checkpoint, its tensors on
        ``device``; ``(None, None)`` when there is none."""
        import torch

        steps = self.steps()
        if not steps:
            return None, None
        return (torch.load(self._file(steps[-1]), map_location=device,
                           weights_only=True), steps[-1])


class PreemptionGuard:
    """SIGTERM-aware training (``train/checkpoint.py:118-176``): the signal
    only sets a flag, which the train loop polls at step boundaries to
    write one exact-resume checkpoint and exit cleanly. The previous
    handler is chained and restored by ``uninstall()``. One process: the
    local flag is the answer."""

    def __init__(self, signals=None):
        import signal

        self._signal = signal
        self._requested = False
        self._prev = {}
        for s in signals or (signal.SIGTERM,):
            self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self._requested = True
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    @property
    def requested(self) -> bool:
        return self._requested

    def should_exit(self, step: int) -> bool:
        return self._requested

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            self._signal.signal(s, prev)
        self._prev = {}


def load_landmark_variables(path: str, landmark: dict, log=print) -> dict:
    """Pretrained landmark-CNN weights for the frozen provider state (the
    ``--landmark-path`` flag; reference ``load_part_checkpoint_landmark``,
    ``lafs_train.py:124-154``): a reference-dialect ``.pth`` (prefixes
    stripped, a ``state_dict``/``model`` wrapper opened), its ``stn.*`` and
    ``output_layer.*`` entries onto ``landmark``'s keys, each on its
    device and dtype. Every provider entry must be covered with its shape,
    or it raises: a silently random landmark CNN would poison the recipe.
    Orbax directories are not read by the port (``NotImplementedError``)."""
    import torch

    if not path.endswith(".pth"):
        raise NotImplementedError(
            f"--landmark-path {path!r}: the port loads reference-dialect "
            ".pth files; orbax checkpoint directories wait (ROADMAP.md, Open "
            "items 1.12) — convert with lafs_cvpr2024_tpu.cli.export_torch")
    raw = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):
        if isinstance(raw.get(wrapper), dict):
            raw = raw[wrapper]
    sd = strip_prefixes(raw)
    out, missing = {}, []
    for k, v in landmark.items():
        src = sd.get(k)
        if src is None or tuple(src.shape) != tuple(v.shape):
            missing.append(k)
            continue
        out[k] = src.to(device=v.device, dtype=v.dtype)
    if missing:
        raise ValueError(
            f"checkpoint {path}: {len(missing)} landmark-CNN entries are "
            f"missing or of another shape (stn_mode mismatch?); first few: "
            f"{missing[:5]}")
    log(f"[import landmark ckpt] {len(out)} stn/output_layer entries from "
        f"{path}")
    return out
