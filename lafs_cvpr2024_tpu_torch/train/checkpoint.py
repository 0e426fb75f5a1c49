"""Checkpoint interop for the port (counterpart of part of
``lafs_cvpr2024_tpu/train/checkpoint.py``).

:func:`state_dict_from_flax` turns a JAX Part-fViT tree, given as nested
dicts of numpy arrays, into the reference ``state_dict`` dialect the port's
modules carry — the same keys, layouts and values as the JAX package's
``export_torch_state_dict`` (``train/checkpoint.py:1150-1247``). It is
numpy-only; :func:`to_tensors` makes ``torch`` tensors of the result.
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
            elif path in (("cls_token",), ("pos_embedding",)):
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


def to_tensors(state_dict: Dict[str, np.ndarray]):
    """numpy ``state_dict`` → contiguous CPU ``torch`` tensors."""
    import torch

    return {k: torch.from_numpy(np.array(v)) for k, v in state_dict.items()}
