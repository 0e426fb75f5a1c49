"""TOML presets for the CLIs (counterpart of
``lafs_cvpr2024_tpu/utils/config.py``): ``--config run.toml`` loads one
table of the file as argparse defaults, and explicit flags still win."""

from __future__ import annotations

import argparse
import tomllib
from typing import Optional

import torch


def apply_toml_defaults(parser: argparse.ArgumentParser,
                        argv: Optional[list] = None, table: str = "train"):
    """Parse args with optional ``--config file.toml`` defaults. TOML keys
    use underscores or dashes; unknown keys raise."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None)
    known, rest = pre.parse_known_args(argv)
    if known.config:
        with open(known.config, "rb") as f:
            data = tomllib.load(f)
        section = data.get(table, data)
        valid = {a.dest for a in parser._actions}  # noqa: SLF001
        defaults = {}
        for k, v in section.items():
            dest = k.replace("-", "_")
            if dest not in valid:
                raise ValueError(f"unknown config key {k!r} in {known.config}")
            defaults[dest] = v
        parser.set_defaults(**defaults)
    parser.add_argument("--config", default=known.config,
                        help="TOML file with flag defaults")
    return parser.parse_args(rest)


def resolve_mlp_impl(choice: str, device) -> str:
    """'auto' → the LN-fused MLP kernels (``fused_ln``) on the card and
    ``dense`` on the CPU: the JAX rule (``fused_ln`` on a TPU), with the
    card in place of the TPU."""
    if choice != "auto":
        return choice
    return "fused_ln" if torch.device(device).type == "cuda" else "dense"
