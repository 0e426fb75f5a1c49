"""Checkpoint loading for the eval/serving CLIs (counterpart of
``lafs_cvpr2024_tpu/eval/loading.py``), for ``.pth`` files of the Part-fViT
family.

The architecture is inferred from the reference ``state_dict`` keys by the
same shape rules as the JAX package's ``infer_partfvit_config``; explicit
CLI flags win over inference. Other families (DINO ``vit_*``, iResNet,
MobileDINO, OverlapViT) and orbax checkpoint directories raise: they are
queued in ROADMAP.md.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from .. import _build
from ..models.mobilenet import LARGE_SETTING, SMALL_SETTING
from ..models.partfvit import PartFViT, PartFViTConfig
from ..ops.augment_device import INPUT_SCALES, scale_uint8
from ..train.checkpoint import strip_prefixes

__all__ = [
    "add_arch_flags",
    "add_input_scale_flag",
    "arch_overrides_from_args",
    "infer_partfvit_config",
    "load_eval_model",
    "LoadedEvalModel",
    "make_model_embed",
    "print_launches",
    "resolve_input_scale",
    "EVAL_DTYPES",
]

#: the ``--eval-dtype`` choices of the eval and serving CLIs
EVAL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# PartFViTConfig fields a CLI may force explicitly (as in the JAX package)
_OVERRIDABLE = (
    "dim", "depth", "heads", "dim_head", "mlp_dim", "num_patches",
    "image_size", "patch_size", "stn_mode", "with_land", "pool",
    "use_standcoord",
)


def add_arch_flags(parser) -> None:
    """The standard architecture flag set; ``None`` = infer from the
    checkpoint, a value forces it. ``--image-size`` keeps a real default
    (112) because no parameter shape records it."""
    g = parser.add_argument_group(
        "architecture (inferred from the checkpoint; flags force a value)"
    )
    g.add_argument("--embedding-size", type=int, default=None, dest="dim")
    g.add_argument("--depth", type=int, default=None)
    g.add_argument("--heads", type=int, default=None,
                   help="the qkv shape only fixes heads*dim_head; with "
                        "neither flag, inference assumes 64-wide heads")
    g.add_argument("--dim-head", type=int, default=None)
    g.add_argument("--mlp-dim", type=int, default=None)
    g.add_argument("--num-patches", type=int, default=None)
    g.add_argument("--patch-size", type=int, default=None)
    g.add_argument("--image-size", type=int, default=112)
    g.add_argument("--stn-mode", default=None, choices=["large", "small"])
    g.add_argument("--pool", default=None, choices=["cls", "mean"])
    g.add_argument("--no-land", dest="with_land", action="store_false",
                   default=None)
    g.add_argument("--standcoord", dest="use_standcoord",
                   action="store_true", default=None)


def add_input_scale_flag(parser, default: str = "auto") -> None:
    """The shared ``--input-scale`` flag: the input convention of the
    checkpoint ('auto' resolves per family after loading)."""
    parser.add_argument(
        "--input-scale", default=default, choices=["auto", *INPUT_SCALES],
        help="'half' = x/255-0.5 (reference eval), 'unit' = x/255*2-1, "
             "'imagenet' = per-channel (x/255-mean)/std; 'auto' picks "
             "'half' for the Part-fViT family",
    )


def resolve_input_scale(value: str, family: str,
                        log: Callable[[str], None] = print) -> str:
    """``auto`` → 'half' (the reference eval convention) for the Part-fViT
    family, the only family the port loads; an explicit value wins."""
    if value == "auto":
        log(f"[load] input-scale auto -> 'half' (family {family})")
        return "half"
    return value


def arch_overrides_from_args(args) -> Dict[str, Any]:
    """The non-``None`` architecture overrides from parsed args."""
    return {name: getattr(args, name) for name in _OVERRIDABLE
            if getattr(args, name, None) is not None}


def _infer_heads(inner: int, heads, dim_head):
    """(heads, dim_head) from the qkv inner width and optional flags."""
    if heads and dim_head:
        if heads * dim_head != inner:
            raise ValueError(
                f"--heads {heads} x --dim-head {dim_head} != checkpoint's "
                f"qkv inner dim {inner}"
            )
    elif heads:
        if inner % heads:
            raise ValueError(f"checkpoint qkv inner dim {inner} not "
                             f"divisible by --heads {heads}")
        dim_head = inner // heads
    else:
        dim_head = dim_head or 64  # the reference's only head width
        if inner % dim_head:
            raise ValueError(
                f"checkpoint qkv inner dim {inner} not divisible by head "
                f"width {dim_head}; pass --heads/--dim-head explicitly"
            )
        heads = inner // dim_head
    return int(heads), int(dim_head)


def infer_partfvit_config(state_dict: Dict[str, Any], **overrides
                          ) -> PartFViTConfig:
    """Derive a :class:`PartFViTConfig` from reference ``state_dict`` keys
    (prefix-stripped). Keyword overrides win over inference. The eval
    models' attention is ``'fused'``: kernel 6 where the sequence and head
    width fit it (:class:`~..models.layers.Attention`), the einsum path
    elsewhere."""

    def need(key):
        if key not in state_dict:
            raise ValueError(
                f"infer_partfvit_config: checkpoint has no '{key}' — not a "
                "Part-fViT-family payload? Pass the architecture flags."
            )
        return state_dict[key]

    ov = dict(overrides)
    cfg: Dict[str, Any] = {}
    cfg["dim"] = ov.pop("dim", None) or int(need("cls_token").shape[-1])
    cfg["num_patches"] = (ov.pop("num_patches", None)
                          or int(need("pos_embedding").shape[1]) - 1)
    patch_in = int(need("patch_to_embedding.weight").shape[1])
    if "patch_size" in ov:
        cfg["patch_size"] = ov.pop("patch_size")
    else:
        ps = math.isqrt(patch_in // 3)
        if ps * ps * 3 != patch_in:
            raise ValueError(
                f"infer_partfvit_config: patch_to_embedding input dim "
                f"{patch_in} is not (p*p*3) — pass patch_size explicitly."
            )
        cfg["patch_size"] = ps
    layers = {int(m.group(1)) for k in state_dict
              if (m := re.match(r"transformer\.layers\.(\d+)\.", k))}
    cfg["depth"] = ov.pop("depth", None) or len(layers)
    inner = int(need("transformer.layers.0.0.fn.fn.to_qkv.weight").shape[0]) // 3
    cfg["heads"], cfg["dim_head"] = _infer_heads(
        inner, ov.pop("heads", None), ov.pop("dim_head", None))
    cfg["mlp_dim"] = (ov.pop("mlp_dim", None) or int(
        need("transformer.layers.0.1.fn.fn.net.0.weight").shape[0]))

    with_land = ov.pop("with_land", None)
    if with_land is None:
        with_land = any(k.startswith("stn.") for k in state_dict)
    cfg["with_land"] = bool(with_land)
    stn_mode = ov.pop("stn_mode", None)
    if cfg["with_land"] and stn_mode is None:
        nblocks = len({int(m.group(1)) for k in state_dict
                       if (m := re.match(r"stn\.features\.(\d+)\.", k))}) - 1
        if nblocks == len(LARGE_SETTING):
            stn_mode = "large"
        elif nblocks == len(SMALL_SETTING):
            stn_mode = "small"
        else:
            raise ValueError(
                f"landmark stem has {nblocks} blocks — neither MobileNetV3-"
                f"large ({len(LARGE_SETTING)}) nor -small "
                f"({len(SMALL_SETTING)}); pass --stn-mode"
            )
    cfg["stn_mode"] = stn_mode or "large"
    cfg["use_global_token"] = "global_token.weight" in state_dict
    cfg["simmim"] = "mask_token" in state_dict
    if ov.pop("use_standcoord", None):
        cfg["use_standcoord"] = True
    for key in ("image_size", "pool"):
        if ov.get(key) is not None:
            cfg[key] = ov.pop(key)
        else:
            ov.pop(key, None)
    if ov:
        raise TypeError(f"unknown config overrides: {sorted(ov)}")
    return PartFViTConfig(loss_type="None", num_classes=0, attn_impl="fused",
                          **cfg)


def _family(state_dict) -> str:
    """The backbone family a prefix-stripped reference state_dict names."""
    if any(k.startswith("blocks.") for k in state_dict):
        return "dino_vit"
    if any(k.startswith("layer1.") for k in state_dict):
        return "iresnet"
    if "cls_token" not in state_dict:
        return "mobile_dino" if "output_layer.weight" in state_dict else "unknown"
    if any(k.startswith("mlp_head.0.running_") for k in state_dict):
        return "overlap"
    return "partfvit"


@dataclass
class LoadedEvalModel:
    model: PartFViT     # on ``device``, in eval mode, float32
    cfg: PartFViTConfig
    family: str = "partfvit"


def load_eval_model(checkpoint: str,
                    overrides: Optional[Dict[str, Any]] = None,
                    device: str | torch.device = "cuda",
                    log: Callable[[str], None] = print) -> LoadedEvalModel:
    """Load a Part-fViT-family ``.pth`` (reference or exported dialect),
    infer the architecture, build the port's model and load the weights
    with ``strict=True``. The margin head (``loss.*``) is not part of the
    eval model and is dropped."""
    if not checkpoint.endswith(".pth"):
        raise ValueError(
            f"{checkpoint!r}: the PyTorch port loads .pth state_dicts only; "
            "orbax checkpoint directories are queued in ROADMAP.md (export "
            "with `python -m lafs_cvpr2024_tpu.cli.export_torch` first)"
        )
    raw = torch.load(checkpoint, map_location="cpu", weights_only=True)
    sd = strip_prefixes(raw)
    family = _family(sd)
    if family != "partfvit":
        raise ValueError(
            f"{checkpoint!r} is a {family} checkpoint; the PyTorch port "
            "loads the Part-fViT family only so far (ROADMAP.md, Open items "
            "1.12-1.14)"
        )
    sd = {k: v for k, v in sd.items() if not k.startswith("loss.")}
    cfg = infer_partfvit_config(sd, **(overrides or {}))
    model = PartFViT(cfg)
    model.load_state_dict(sd, strict=True)
    model.eval().to(device)
    log(f"[load] family: {family}; architecture: dim={cfg.dim}, "
        f"depth={cfg.depth}, heads={cfg.heads}, dim_head={cfg.dim_head}, "
        f"mlp_dim={cfg.mlp_dim}, num_patches={cfg.num_patches}, "
        f"stn_mode={cfg.stn_mode}, with_land={cfg.with_land}")
    return LoadedEvalModel(model=model, cfg=cfg, family=family)


def make_model_embed(model, input_scale: str, dtype: torch.dtype):
    """``embed(uint8 (B, S, S, 3) batch) -> fp32 (B, D)`` on the model's
    device, for the eval CLIs: the batch is scaled there and the model runs
    in ``dtype``. ``model`` is cast in place, every float tensor of it
    (BatchNorm statistics included), as the JAX CLIs cast every float
    leaf."""
    model = model.to(dtype)

    @torch.inference_mode()
    def embed(batch):
        return model(scale_uint8(batch, input_scale).to(dtype)).float()

    return embed


def print_launches(device) -> None:
    """On a CUDA device, one line with the kernel launches of this process
    (``_build.LAUNCHES``, as JSON): which kernels the run went through."""
    if torch.device(device).type == "cuda":
        print(f"[kernels] launches {json.dumps(dict(_build.LAUNCHES))}")
