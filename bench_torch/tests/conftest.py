"""CPU tests of the benchmark at small sizes: its FLOP counts, its output
check against the planted faults, and its control.

    python -m pytest -p no:cacheprovider bench_torch/tests -q
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

TINY = {"dim": 128, "depth": 2, "heads": 2, "dim-head": 64, "mlp-dim": 256,
        "num-patches": 36}
TINY_SSL = {**TINY, "out-dim": 64, "head-hidden-dim": 96,
            "head-bottleneck-dim": 32, "local-crops-number": 2,
            "local-keep-landmarks": 8, "batch-size-per-chip": 4,
            "mlp-impl": "fused_ln"}


def tiny_files(workload: str) -> dict:
    """The cell's files with the model cut to a CPU test's size (widths,
    depth, batch and traffic; everything else as committed)."""
    from bench_torch.run import cell_files

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = cell_files(bench, workload)
    m = dict(files["model"])
    if m["runner"] == "ssl_train":
        m.update(TINY_SSL)
        files["traffic"] = dict(files["traffic"], rounds=1)
    else:
        m.update(TINY, **{"server-flags": dict(m["server-flags"],
                                              **{"batch-size": 8})})
        t = files["traffic"]
        files["traffic"] = (dict(t, sizes={"fixed": 8}, ring=4)
                            if t["loop"] == "closed" else dict(t, rate_per_s=3.0))
    files["model"] = m
    return files


@pytest.fixture
def tiny():
    return tiny_files
