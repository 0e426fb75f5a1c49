"""Readings of the output check's control and of the planted faults, on the
card at a cell's own size, for the limits in ``limits/<workload>.json``.
The benchmark's own runs do not run this.

    python bench_torch/control.py --workload ssl_cli --seeds 11 12 13

The control is the plain reference put in the program's place, computed
one precision below what the configuration states: the products of the
parts stated in bfloat16 in float8 (e4m3, one scale a tensor), those stated
in float32 in bfloat16. For the SSL cell, also the fault of a step that
leaves out half of its batch and averages the rest, read on the reference.
Each seed prints one JSON line: the numbers the check compares, for the
control (and the fault) against the float32 reference.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

LOWER = {"bfloat16": "fp8", "float32": "bf16"}


def ssl_readings(files: dict, seed: int, dev) -> dict:
    from bench_torch.runners.ssl_train import gaps, reference_readings

    m, traffic = files["model"], files["traffic"]
    prec = {"landmark": LOWER[m["landmark-dtype"]],
            "backbone": LOWER[m["compute-dtype"]],
            "head": LOWER[m["head-dtype"]]}
    ref = reference_readings(m, traffic, seed, dev)
    out = {}
    for name, kw in (("control", dict(prec=prec)),
                     ("half_batch", dict(half_batch=True))):
        r = reference_readings(m, traffic, seed, dev, **kw)
        out[name] = gaps(r, r["loss"], ref)
    return out


def serve_readings(files: dict, seed: int, dev, seconds: float) -> dict:
    import numpy as np

    from bench_torch import loadgen, records
    from bench_torch.runners.serve import reference_embeddings

    m, traffic = files["model"], files["traffic"]
    n_pool = len(records.faces_decoded())
    if traffic["loop"] == "open":
        faces = np.concatenate([r.faces for r in loadgen.open_schedule(
            traffic, seconds, seed, n_pool)])
    else:
        faces = np.concatenate(loadgen.closed_ring(traffic, seed, n_pool)[:8])
    low = LOWER[m["server-flags"]["eval-dtype"]]
    prec = {"landmark": low, "backbone": low, "head": low}
    ref = reference_embeddings(m, seed, faces, dev)
    ctl = reference_embeddings(m, seed, faces, dev, prec)
    return {"control": {"embed_err": float(
        np.linalg.norm(ctl - ref, axis=1).max())}, "faces": int(len(faces))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    import torch

    from bench_torch.run import ROOT, cell_files

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = cell_files(bench, args.workload)
    dev = torch.device("cuda")
    for seed in args.seeds:
        if files["model"]["runner"] == "ssl_train":
            r = ssl_readings(files, seed, dev)
        else:
            r = serve_readings(files, seed, dev,
                               args.seconds or bench["run_seconds"])
        print(json.dumps({"workload": args.workload, "seed": seed, **r}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
