"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python bench_torch/run.py --workload ssl_cli --seed 7 --seconds 10 --trace 0

Everything about a cell is data, found by name from ``BENCHMARK.json``:
the cell's configuration file (``configs/<config>.json``, which names the
runner in ``runners/`` that runs it), its traffic (``traffic/<traffic>
.json``), the limits of its output check (``limits/<workload>.json``) and,
with ``--trace 1``, one reader per per-layer metric (``metrics/<name>.py``).
The last line on standard output is the result as one JSON object; the
numbers compared for ``correct`` are the last lines on standard error.
Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))


def fail(msg: str, code: int = 3):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, workload: str) -> dict:
    """The cell's entries and files, by name."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        fail(f"no workload {workload!r} in BENCHMARK.json", 2)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    model = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return dict(cell=cell, model=model, traffic=traffic,
                limits=limits["limits"],
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    build = ROOT / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / "cache" / sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = cell_files(bench, args.workload)
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the port on the card")
    if torch.cuda.device_count() < files["cell"]["chips"]:
        fail(f"the cell needs {files['cell']['chips']} cards, "
             f"{torch.cuda.device_count()} found")
    try:
        import lafs_cvpr2024_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program is not in this checkout: {e}")
    runner = load_module(HERE / "runners" / f"{files['model']['runner']}.py",
                         f"bench_runner_{files['model']['runner']}")
    out = runner.run(args, files, ROOT, T_START)
    return report(args, files, out)


def report(args, files: dict, out: dict) -> int:
    """Print the compared numbers and the result line."""
    import torch

    checks = out["checks"]
    correct = bool(out["sound"]) and all(
        v is not None and v == v and v <= lim for _, v, lim in checks)
    for name, v, lim in checks:
        print(f"[check] {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    print(f"[check] correct = {correct} ({out['sound_note']})",
          file=sys.stderr, flush=True)
    if args.trace:
        metrics = {}
        for m in files["per_layer"]:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 "bench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(out["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]),
                               "unit": m["unit"]}
                   for m in files["end_to_end"]}
    cuda = torch.cuda.is_available()
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": files["cell"]["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": correct, "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": device}
    prof = out["ctx"].get("profile")
    if args.trace and prof:
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        line["breakdown"] = {"device_ops": prof["device_ops"],
                             "idle_gaps": prof["idle_gaps"]}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in checks}
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
