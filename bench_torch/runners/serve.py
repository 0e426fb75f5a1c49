"""Runner of the serving cells: the port's embedding server in a process of
its own (``launcher.py``), the load generator (``loadgen.py``) in this one,
over the server's unix socket and wire protocol.

Set-up: the requests are made from the seed, the server is started on the
seed's weights and two requests of the traffic warm the connection up. The
window then runs the traffic's loop for ``--seconds``; the server is
stopped when the client closes, or killed, in every case. The output
check runs once the server has exited: the plain reference
(``reference/model.py::embed_faces``) embeds the faces of the checked
requests from the same weights, and the widest distance between a served
and a reference embedding (both unit vectors) is held to the limit. An
open loop checks every request, a closed loop a sample from the seed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bench_torch import loadgen, records
from bench_torch.weights import generate, served_spec

START_TIMEOUT = 900.0
REPLY_TIMEOUT = 60.0
CLOSED_SAMPLE = 8
PROFILE_AT = (0.6, 0.85)


def start_server(root, config_file, seed, sock_path, result, trace, dev,
                 plan):
    cmd = [sys.executable, str(Path(__file__).resolve().parent.parent
                               / "launcher.py"),
           "--config", str(config_file), "--seed", str(seed),
           "--socket", sock_path, "--out", str(result),
           "--trace", str(int(trace)), "--device", dev.type,
           "--profile-plan", str(plan)]
    return subprocess.Popen(cmd, cwd=root, stdout=sys.stderr,
                            stderr=sys.stderr)


def stop_server(proc, timeout=120.0):
    """Wait for the server to leave after the client closed; kill it if
    it does not."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def run(args, files: dict, root, t_start: float, dev=None) -> dict:
    m, traffic, limits = files["model"], files["traffic"], files["limits"]
    dev = dev or torch.device("cuda")
    work = work_dir(root)
    conf_file = work / "config.json"
    conf_file.write_text(json.dumps(m))
    pool = records.faces_decoded()
    sock_path = os.path.relpath(work / "server.sock", root)
    result = work / "launcher.json"
    plan = work / "profile_plan.json"
    for f in (result, plan, root / sock_path):
        records.clear(f)
    opened = traffic["loop"] == "open"
    if opened:
        reqs = loadgen.open_schedule(traffic, args.seconds, args.seed,
                                     len(pool), pool)
    else:
        ring = loadgen.closed_ring(traffic, args.seed, len(pool))
    proc = start_server(root, conf_file, args.seed, sock_path, result,
                        args.trace, dev, plan)
    ctx = {"model": m, "traffic": traffic, "spans": {}, "counters": {}}
    sock = None
    try:
        sock = loadgen.connect(str(root / sock_path), time.time() + START_TIMEOUT,
                               lambda: proc.poll() is None)
        warm = [pool[f] for f in (reqs[0].faces if opened else ring[0],)] * 2
        for faces in warm:
            sock.sendall(loadgen.payload(faces))
            loadgen.read_response(sock)
        setup_s = time.perf_counter() - t_start
        t0 = time.time()
        if args.trace:  # the server profiles from 0.6 to 0.85 of the window
            plan.write_text(json.dumps([t0 + f * args.seconds
                                        for f in PROFILE_AT]))
        if opened:
            done = loadgen.run_open(sock, reqs, args.seconds, REPLY_TIMEOUT,
                                    t0)
            t_end = max((r.done or 0.0) for r in done) or time.time()
        else:
            done, t0, t_end = loadgen.run_closed(sock, ring, pool, args.seconds,
                                                 REPLY_TIMEOUT)
    finally:
        if sock is not None:
            sock.close()
        stop_server(proc)
        records.clear(root / sock_path)
    launched = json.loads(result.read_text()) if result.exists() else {}
    ok = [r for r in done if r.error is None]
    failed = len(done) - len(ok)
    if opened:
        lat = [(r.done - t0 - r.due) * 1e3 if r.error is None else float("inf")
               for r in done]
        e2e = {"serve_p95_ms": loadgen.nearest_rank(lat, 0.95)}
        ctx["lags"] = [(r.sent - t0 - r.due) * 1e3 for r in done
                       if r.sent is not None]
        checked = ok
    else:
        faces = sum(len(r.faces) for r in ok)
        e2e = {"embed_faces_per_s": faces / (t_end - t0)}
        rng = np.random.default_rng(args.seed)
        checked = [ok[i] for i in sorted(rng.choice(
            len(ok), min(CLOSED_SAMPLE, len(ok)), replace=False))]
    e2e["setup_s"] = setup_s
    ctx["window"] = (t0, t_end)
    ctx["answered"] = [(r.done, len(r.faces)) for r in ok]
    if args.trace:
        ctx["spans"] = launched.get("spans", {})
        ctx["counters"] = launched.get("counters", {})
        ctx["profile"] = launched.get("profile")
        ctx["profile_t"] = launched.get("profile_t")
    checks = compare(m, args.seed, checked, limits, dev)
    sound = bool(launched) and proc.returncode == 0
    return {"e2e": e2e, "checks": checks, "sound": sound,
            "sound_note": "server exited cleanly" if sound else
            f"server exit code {proc.returncode}",
            "attempted": len(done), "failed": failed,
            "memory_peak_bytes": launched.get("memory_peak_bytes", 0),
            "ctx": ctx}


def work_dir(root) -> Path:
    work = Path(root) / "build" / "bench" / "serve"
    work.mkdir(parents=True, exist_ok=True)
    return work


def reference_embeddings(m, seed, faces: np.ndarray, dev, prec=None,
                         block: int = 256) -> np.ndarray:
    from bench_torch.reference.model import FP32, embed_faces

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = {k: v.float() for k, v in generate(served_spec(m), seed, 0, dev,
                                           torch.bfloat16).items()}
    pool = records.faces_decoded()
    out = []
    with torch.no_grad():
        for s in range(0, len(faces), block):
            x = torch.from_numpy(pool[faces[s:s + block]]).to(dev)
            out.append(embed_faces(w, x, m, prec or FP32).cpu().numpy())
    return np.concatenate(out)


def compare(m, seed, checked: list, limits: dict, dev) -> list:
    """The widest distance between a served embedding and the
    reference's, over the faces of the checked requests."""
    if not checked:
        return [("embed_err", float("inf"), limits["embed_err"])]
    faces = np.concatenate([r.faces for r in checked])
    served = np.concatenate([r.reply for r in checked])
    if served.shape[0] != faces.shape[0]:
        return [("embed_err", float("inf"), limits["embed_err"])]
    ref = reference_embeddings(m, seed, faces, dev)
    err = float(np.linalg.norm(served - ref, axis=1).max())
    return [("embed_err", err, limits["embed_err"])]
