"""Standalone bin-pair verification CLI — LFW / CFP-FP / AgeDB-30 style
(counterpart of ``lafs_cvpr2024_tpu/cli/evaluate_bin.py``): any Part-fViT
``.pth`` against the ``.bin`` pair protocols, 10-fold KFold threshold
sweep, flip-fused embeddings, on one GPU.

The ``.bin`` JPEGs decode with nvJPEG straight into device memory; the
uint8 batches are scaled on the card inside the embed function. Same flags,
results dict and print lines as the JAX CLI, plus ``--device`` (the card
unless ``--device cpu`` is given; without a card the CLI raises).

Example:
  python -m lafs_cvpr2024_tpu_torch.cli.evaluate_bin \\
      --checkpoint ckpt.pth --eval-path /data/val --targets lfw cfp_fp agedb_30
"""

from __future__ import annotations

import argparse
import json

from ..eval.loading import (
    EVAL_DTYPES,
    add_arch_flags,
    add_input_scale_flag,
    arch_overrides_from_args,
    load_eval_model,
    make_model_embed,
    print_launches,
    resolve_input_scale,
)
from ..eval.verification import get_val_data, perform_val
from ..train.device import resolve


def get_args(argv=None):
    p = argparse.ArgumentParser("lafs bin-pair verification (PyTorch/CUDA)")
    p.add_argument("--checkpoint", required=True, help="Part-fViT .pth")
    p.add_argument("--eval-path", required=True,
                   help="dir with <target>.bin files")
    p.add_argument("--targets", nargs="+",
                   default=["lfw", "cfp_fp", "agedb_30"])
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--nrof-folds", type=int, default=10)
    p.add_argument("--eval-dtype", default="float32",
                   choices=list(EVAL_DTYPES), help="forward compute dtype. Default fp32: this is the "
                        "accuracy-protocol tool; bf16 embeddings agree with "
                        "fp32 to cosine >~ 1-1e-3, for quick sweeps")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write results to this JSON file")
    p.add_argument("--device", default="cuda",
                   help="torch device; CUDA unless 'cpu' is given explicitly")
    add_arch_flags(p)
    add_input_scale_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    device = resolve(args.device)
    loaded = load_eval_model(args.checkpoint, arch_overrides_from_args(args),
                             device=device)
    args.input_scale = resolve_input_scale(args.input_scale, loaded.family)
    embed = make_model_embed(loaded.model, args.input_scale,
                             EVAL_DTYPES[args.eval_dtype])

    results = {}
    for name, data, issame in get_val_data(args.eval_path, args.targets,
                                           device):
        res = perform_val(
            embed, data, issame,
            batch_size=args.batch_size, nrof_folds=args.nrof_folds,
            device_scale=True,
        )
        results[name] = {
            "accuracy": float(res.accuracy),
            "accuracy_std": float(res.accuracy_std),
            "xnorm": float(res.xnorm),
            "best_threshold": float(res.best_threshold),
        }
        print(f"[{name}] acc {res.accuracy:.5f}±{res.accuracy_std:.5f} "
              f"xnorm {res.xnorm:.3f} thr {res.best_threshold:.3f}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
    print_launches(device)
    return results


if __name__ == "__main__":
    main()
