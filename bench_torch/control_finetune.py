"""Readings of the supervised finetuning cell's control and of a planted
fault, on the card at the cell's own size, for ``limits/finetune_step.json``.
The benchmark's own runs do not run this.

    python bench_torch/control_finetune.py --workload finetune_step --seeds 11 12 13

The control is the plain reference put in the program's place, computed
one precision below what the configuration states: every product in
float8 (e4m3, one scale a tensor), since the configuration computes the
whole model in bfloat16. The fault is a step given half of its images,
read on the reference. Each seed prints one JSON line: the numbers the
check compares (and those it prints), for the control and the fault
against the float32 reference.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

LOWER = {"bfloat16": "fp8", "float32": "bf16"}


def readings(files: dict, seed: int, n_records: int, dev) -> dict:
    from bench_torch.runners.finetune_train import gaps, reference_readings

    m, traffic = files["model"], files["traffic"]
    low = LOWER[m["compute-dtype"]]
    prec = {"landmark": low, "backbone": low, "head": low}
    ref = reference_readings(m, traffic, seed, n_records, dev)
    out = {}
    for name, kw in (("control", dict(prec=prec)),
                     ("half_batch", dict(half_batch=True))):
        r = reference_readings(m, traffic, seed, n_records, dev, **kw)
        out[name] = gaps(r, r["loss"], ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", default="finetune_step")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    from bench_torch.run import ROOT, cell_files

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = cell_files(bench, args.workload)
    traffic = files["traffic"]
    n_records = traffic["rounds"] * len(json.loads(
        (HERE / "data" / "faces.json").read_text())["lengths"])
    dev = torch.device("cuda")
    for seed in args.seeds:
        r = readings(files, seed, n_records, dev)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
