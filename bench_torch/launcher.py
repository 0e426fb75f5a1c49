"""Start the port's embedding server as its users start it, on weights the
benchmark makes from a seed, for one connection.

    python bench_torch/launcher.py --config bench_torch/configs/X.json \\
        --seed N --socket PATH --out RESULT.json [--trace 1]

It writes the weights to a ``.pth`` at a fixed place in the checkout,
builds ``cli.serve_embeddings.EmbeddingServer`` from the server's own
argument parser (the configuration's flags, ``--max-requests 1``) and
serves until the client closes its connection, then writes RESULT.json
(the card's peak memory; with ``--trace 1`` the spans and counters below
and the profiled slice). With ``--trace 1`` it times the server's calls:
``read`` (one request off the socket), ``dispatch`` (pad, copy to the card,
launch the forward), ``collect`` (wait for it and fetch, flip-sum,
normalise) and ``send``, as host spans and as ``bench.*`` ranges in the
profiler's trace, counts the rows forwarded and the faces answered,
and profiles the requests between the two times (host clock) that the
benchmark writes to ``--profile-plan`` once the window is about to start.
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--socket", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--profile-plan", default=None)
    args = p.parse_args(argv)
    m = json.loads(Path(args.config).read_text())

    import torch

    from bench_torch.trace import ProfiledSlice, record, warm_up
    from bench_torch.weights import generate, served_spec
    from lafs_cvpr2024_tpu_torch.cli import serve_embeddings as srv

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    pth = ROOT / "build" / "bench" / "serve" / "model.pth"
    pth.parent.mkdir(parents=True, exist_ok=True)
    weights = generate(served_spec(m), args.seed, 0, dev, torch.bfloat16)
    torch.save({k: v.cpu() for k, v in weights.items()}, pth)
    del weights
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    flags = [f"--{k}={v}" for k, v in m["server-flags"].items()]
    sargs = srv.get_args(["--checkpoint", str(pth), "--socket", args.socket,
                          "--max-requests", "1", "--device", args.device,
                          *flags])
    server = srv.EmbeddingServer(sargs)
    spans = {"read": [], "dispatch": [], "collect": [], "send": []}
    counters = {"rows": 0, "faces": 0, "requests": 0, "profiled_requests": 0}
    prof = {"plan": None, "slice": None, "t": [None, None]}
    plan_file = Path(args.profile_plan) if args.profile_plan else None

    def planned(i: int) -> bool:
        """Whether the host clock has passed the plan's start (0) or end."""
        if prof["plan"] is None and plan_file is not None and plan_file.exists():
            prof["plan"] = json.loads(plan_file.read_text())
        return prof["plan"] is not None and time.time() >= prof["plan"][i]

    if args.trace:
        warm_up()
        in_slice = []  # handles dispatched while the slice records
        bs = sargs.batch_size * (2 if sargs.flip else 1)

        def timed(name, fn):
            def wrap(*a, **kw):
                t = time.perf_counter()
                with record(name):
                    out = fn(*a, **kw)
                spans[name].append(time.perf_counter() - t)
                return out
            return wrap

        read, dispatch, collect = (timed("read", server._read_request),
                                   timed("dispatch", server._dispatch),
                                   timed("collect", server._collect))

        def read_request(conn):
            if prof["slice"] is None and planned(0):
                prof["slice"] = ProfiledSlice().__enter__()
                prof["t"][0] = time.time()
            return read(conn)

        def dispatch_(imgs):
            handles = dispatch(imgs)
            counters["rows"] += len(handles) * bs
            counters["faces"] += len(imgs)
            counters["requests"] += 1
            if prof["slice"] is not None and prof["t"][1] is None:
                in_slice.append(handles)
            return handles

        def collect_(handles):
            out = collect(handles)
            if any(h is handles for h in in_slice):
                in_slice[:] = [h for h in in_slice if h is not handles]
                counters["profiled_requests"] += 1
            s = prof["slice"]
            if s is not None and prof["t"][1] is None and planned(1):
                if cuda:
                    torch.cuda.synchronize()
                s.__exit__(None, None, None)
                prof["t"][1] = time.time()
            return out

        server._read_request, server._dispatch = read_request, dispatch_
        server._collect = collect_
        socket.socket.sendall = timed("send", socket.socket.sendall)
    srv.serve(server, args.socket, 1)
    result = {"memory_peak_bytes":
              torch.cuda.max_memory_allocated() if cuda else 0}
    if args.trace:
        s = prof["slice"]
        if s is not None and prof["t"][1] is None:
            if cuda:
                torch.cuda.synchronize()
            s.__exit__(None, None, None)
            prof["t"][1] = time.time()
        result.update(spans=spans, counters=counters,
                      profile=s.summary() if s is not None else None,
                      profile_t=prof["t"])
    Path(args.out).write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
