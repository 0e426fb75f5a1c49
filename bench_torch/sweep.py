"""Find the highest request rate an open-loop serving cell sustains: one
server (as ``runners/serve.py`` starts it), one connection, and a window of
the cell's traffic at each rate in turn, with a pause between them for the
queue to drain. The benchmark's own runs do not run this; its result is
written into the cell's traffic file as a number.

    python bench_torch/sweep.py --workload serve_camera --seed 5 \\
        --seconds 20 --rates 8 10 11 12

Prints one JSON line a rate: requests, failures, the 50th and 95th
percentile latency (due → reply read), the served faces per second, and
whether the backlog grew: the median latency of the window's last quarter
of requests over that of its first quarter.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PAUSE = 3.0  # seconds between rates, for the queue to drain
sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    from bench_torch import loadgen, records
    from bench_torch.runners import serve
    from bench_torch.run import ROOT, cell_files

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = cell_files(bench, args.workload)
    work = serve.work_dir(ROOT)
    conf = work / "config.json"
    conf.write_text(json.dumps(files["model"]))
    sock_path = str(work / "server.sock")
    records.clear(sock_path)
    pool = records.faces_decoded()
    proc = serve.start_server(ROOT, conf, args.seed, sock_path,
                              work / "launcher.json", 0,
                              torch.device("cuda"), work / "no_plan.json")
    try:
        sock = loadgen.connect(sock_path, time.time() + serve.START_TIMEOUT,
                               lambda: proc.poll() is None)
        for _ in range(2):
            sock.sendall(loadgen.payload(pool[:3]))
            loadgen.read_response(sock)
        for rate in args.rates:
            traffic = dict(files["traffic"], rate_per_s=rate)
            reqs = loadgen.open_schedule(traffic, args.seconds, args.seed,
                                         len(pool), pool)
            t0 = time.time()
            done = loadgen.run_open(sock, reqs, args.seconds,
                                    serve.REPLY_TIMEOUT, t0)
            lat = [(r.done - t0 - r.due) * 1e3 if r.error is None
                   else float("inf") for r in done]
            q = max(1, len(lat) // 4)
            ok = [r for r in done if r.error is None]
            span = max(r.done for r in ok) - t0 if ok else float("nan")
            print(json.dumps({
                "rate_per_s": rate, "requests": len(done),
                "failed": len(done) - len(ok),
                "p50_ms": loadgen.nearest_rank(lat, 0.5),
                "p95_ms": loadgen.nearest_rank(lat, 0.95),
                "faces_per_s": sum(len(r.faces) for r in ok) / span,
                "backlog_growth": float(np.median(lat[-q:]) / np.median(lat[:q])),
            }), flush=True)
            if len(ok) < len(done):
                break
            time.sleep(PAUSE)
        sock.close()
    finally:
        serve.stop_server(proc)
        records.clear(sock_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
