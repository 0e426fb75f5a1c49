#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``lafs_cvpr2024_tpu_torch/csrc`` and
drives its serving path at the full width of Part-fViT-B (dim 768, depth 12,
11 heads × 64, mlp 2048, 196 landmarks, MobileNetV3-large stem, 112×112
input, bf16) with random weights from ``--seed``. Phases, one line each:

1. the device (and ``nvidia-smi``'s name and power limit);
2. kernel 1 (patch gather) against its plain PyTorch version at
   (128, 112, 112, 3) images and 196 landmarks, including landmarks at and
   beyond every edge, in fp32 and bf16;
3. kernel 2 (LN-fused MLP) against its plain version at T = 128·197 tokens,
   768 → 2048, in bf16 and fp32;
4. the full-width model: the kernel configuration against the plain one,
   per-row embedding cosine ≥ 1 − 1e-3;
5. the port's ``EmbeddingServer`` from a saved ``.pth`` (batch 64, flip on)
   on a unix socket in a thread, three requests (n = 1, 64, 71) through
   ``EmbeddingClient``, the kernels' launch counts on that path, and the
   served faces/s over a stream of requests of 64 lasting ``SERVE_S``
   seconds, for the kernel configuration and then, with the server's model
   swapped, for the plain one.

Any failure raises (non-zero exit); without CUDA it exits non-zero before
printing any result. The last lines are the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.

``--profile DIR`` adds a torch.profiler run of both configurations at the
served shape: one table of device time by kernel per configuration in DIR,
and a line with the wall and busy device time per forward.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from lafs_cvpr2024_tpu_torch import _build
from lafs_cvpr2024_tpu_torch.cli import serve_embeddings
from lafs_cvpr2024_tpu_torch.models.partfvit import (
    PartFViT,
    PartFViTConfig,
    init_random_,
)
from lafs_cvpr2024_tpu_torch.ops.augment_device import scale_uint8
from lafs_cvpr2024_tpu_torch.ops.fused_mlp import (
    fused_ln_mlp_cuda,
    fused_ln_mlp_plain,
)
from lafs_cvpr2024_tpu_torch.ops.patch_gather import patch_gather_plain
from lafs_cvpr2024_tpu_torch.ops.patch_gather_cuda import patch_gather_cuda

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join("build", "smoke")  # relative: short unix-socket paths
BATCH = 64                             # served batch; 128 images with flip
TOKENS = 2 * BATCH * 197               # MLP rows of one served forward
SERVE_S = 10.0                         # length of each timed serving window
CONFIGS = {"kernel": ("kernel", "fused_ln"), "plain": ("gather", "dense")}
KERNELS = {
    "patch_gather": dict(
        source="lafs_cvpr2024_tpu_torch/csrc/patch_gather.cu",
        replaces="lafs_cvpr2024_tpu/ops/patch_gather_pallas.py:36"),
    "fused_ln_mlp": dict(
        source="lafs_cvpr2024_tpu_torch/csrc/fused_ln_mlp.cu",
        replaces="lafs_cvpr2024_tpu/ops/fused_mlp.py:364"),
}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def require(ok, what: str) -> None:
    """Fail the run (an explicit raise: it holds under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def ulp_bf16(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of ``v`` (8-bit significand)."""
    _, e = torch.frexp(v.float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def phase_gather(dev, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(-0.5, 0.5, (2 * BATCH, 112, 112, 3)).astype(np.float32)
    lands = rng.uniform(-12.0, 124.0, (2 * BATCH, 196, 2)).astype(np.float32)
    edges = [(0, 0), (111, 111), (0, 111), (111, 0), (-9, 50), (120, 50),
             (50, -9), (50, 120), (-1e4, 5), (1e4, 5), (5, -1e4), (5, 1e4),
             (-1e9, 1e9), (111.5, 55.25), (-0.5, -0.5), (112, 112)]
    lands[:, : len(edges)] = np.asarray(edges, np.float32)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        ti = torch.from_numpy(imgs).to(dev, dtype)
        tl = torch.from_numpy(lands).to(dev, dtype)
        got = patch_gather_cuda(ti, tl, 8)
        want = patch_gather_plain(ti, tl, 8)
        torch.cuda.synchronize()
        require(got.shape == want.shape == (2 * BATCH, 196, 192)
                and got.dtype == dtype and bool(torch.isfinite(got).all()),
                f"patch_gather output {tuple(got.shape)} {got.dtype}")
        err = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            ok = err.max().item() <= 1e-5
        else:
            ok = bool((err <= ulp_bf16(want)).all())
        ms = cuda_ms(lambda: patch_gather_cuda(ti, tl, 8))
        plain_ms = cuda_ms(lambda: patch_gather_plain(ti, tl, 8))
        name = str(dtype).split(".")[-1]
        print(f"phase 2 patch_gather {name}: max_abs_err={err.max().item():.3e}"
              f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}"
              f" {'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"patch_gather kernel disagrees in {name}")
        out[name] = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms)
    return out


def phase_mlp(dev, seed: int) -> dict:
    rng = np.random.default_rng(seed + 1)
    d, h = 768, 2048
    arrs = (rng.standard_normal((TOKENS, d)) * 2.0 + 0.5,
            1.0 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
            rng.standard_normal((h, d)) / np.sqrt(d),  # nn.Linear layout
            0.1 * rng.standard_normal(h),
            rng.standard_normal((d, h)) / np.sqrt(h),
            0.1 * rng.standard_normal(d))
    out = {}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        x, g, bt, w1, b1, w2, b2 = (
            torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
            for a in arrs)
        ops = (x, g, bt, w1, b1, w2, b2)
        got = fused_ln_mlp_cuda(*ops)
        want = fused_ln_mlp_plain(*ops)
        torch.cuda.synchronize()
        require(got.shape == want.shape == (TOKENS, d) and got.dtype == dtype,
                f"fused_ln_mlp output {tuple(got.shape)} {got.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = cuda_ms(lambda: fused_ln_mlp_cuda(*ops), iters=10)
        plain_ms = cuda_ms(lambda: fused_ln_mlp_plain(*ops), iters=10)

        def dense_fwd():  # what mlp_impl='dense' runs (cuBLAS, unfused)
            xn = F.layer_norm(x, (d,), g, bt, 1e-5)
            return F.linear(F.gelu(F.linear(xn, w1, b1)), w2, b2)

        dense_ms = cuda_ms(dense_fwd, iters=10)
        name = str(dtype).split(".")[-1]
        ok = rel <= tol and bool(torch.isfinite(got).all())
        print(f"phase 3 fused_ln_mlp {name}: max_abs_err={err:.3e} "
              f"rel_err={rel:.3e} (tol {tol:g}) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} dense_ms={dense_ms:.4f} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"fused_ln_mlp kernel disagrees in {name}")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return out


def full_width(gather_impl: str, mlp_impl: str) -> PartFViT:
    return PartFViT(PartFViTConfig(loss_type="None", num_classes=0,
                                   gather_impl=gather_impl, mlp_impl=mlp_impl))


def build(config: str, state: dict, dev, dtype=torch.bfloat16) -> PartFViT:
    model = full_width(*CONFIGS[config])
    model.load_state_dict(state, strict=True)
    return model.eval().to(dev, dtype)


def served_input(dev, seed: int) -> torch.Tensor:
    """One served forward's input: 128 images, scaled as the server does."""
    imgs = np.random.default_rng(seed + 2).integers(
        0, 256, (2 * BATCH, 112, 112, 3), dtype=np.uint8)
    return scale_uint8(torch.from_numpy(imgs).to(dev), "half")


def phase_model(dev, seed: int, state: dict) -> None:
    kernel = build("kernel", state, dev)
    plain = build("plain", state, dev)
    plain_f32 = build("plain", state, dev, torch.float32)
    x = served_input(dev, seed)
    with torch.inference_mode():
        xb = x.to(torch.bfloat16)
        got = kernel(xb).float()
        want = plain(xb).float()
        ref32 = plain_f32(x)
        kernel_ms = cuda_ms(lambda: kernel(xb), iters=5, warmup=2)
        plain_ms = cuda_ms(lambda: plain(xb), iters=5, warmup=2)
    require(got.shape == (2 * BATCH, kernel.cfg.dim)
            and bool(torch.isfinite(got).all()),
            f"embeddings {tuple(got.shape)} not finite or misshapen")
    cos = F.cosine_similarity(got, want, dim=1)
    cos32 = F.cosine_similarity(got, ref32, dim=1)
    ok = cos.min().item() >= 1 - 1e-3
    print(f"phase 4 Part-fViT-B bf16 batch {2 * BATCH}: cosine kernel-vs-plain"
          f" min={cos.min().item():.6f} mean={cos.mean().item():.6f};"
          f" kernel-bf16-vs-plain-fp32 min={cos32.min().item():.6f};"
          f" forward kernel_ms={kernel_ms:.3f} plain_ms={plain_ms:.3f}"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, "kernel and plain configurations disagree")


def phase_profile(dev, seed: int, state: dict, path: str) -> None:
    """Device time by kernel over 5 forwards of each configuration; the
    busy time is the sum of the kernels' device time, the wall time is
    measured by CUDA events without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(path, exist_ok=True)
    xb = served_input(dev, seed).to(torch.bfloat16)
    for config in CONFIGS:
        model = build(config, state, dev)
        with torch.inference_mode():
            wall = cuda_ms(lambda: model(xb), iters=5, warmup=2)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    model(xb)
                torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 5 / 1e3
        with open(os.path.join(path, f"profile_{config}.txt"), "w") as f:
            f.write(events.table(sort_by="self_device_time_total",
                                 row_limit=100))
        require(busy > 0, f"the profiler saw no device time for {config}")
        print(f"phase P profile {config}: wall_ms={wall:.3f} "
              f"busy_ms={busy:.3f} idle={1 - busy / wall:.3f} "
              f"kernel_kinds={len(kernels)} -> {path}", flush=True)
        del model


def phase_serve(dev, seed: int, state: dict) -> dict:
    os.makedirs(WORK, exist_ok=True)
    pth = os.path.join(WORK, "partfvit_b.pth")
    torch.save(state, pth)
    sock = os.path.join(WORK, "serve.sock")
    args = serve_embeddings.get_args([
        "--checkpoint", pth, "--socket", sock, "--batch-size", str(BATCH),
        "--max-requests", "5"])
    server = serve_embeddings.EmbeddingServer(args)  # builds and warms up
    rng = np.random.default_rng(seed + 3)
    requests = [rng.integers(0, 256, (n, 112, 112, 3), dtype=np.uint8)
                for n in (1, 64, 71)]
    pool = [rng.integers(0, 256, (BATCH, 112, 112, 3), dtype=np.uint8)
            for _ in range(8)]
    errors = []

    def timed_stream():
        """Stream requests of 64 over one connection for ``SERVE_S``
        seconds; faces/s from the first send to the last reply."""
        t0 = time.perf_counter()

        def items():
            for i in itertools.count():
                if i and time.perf_counter() - t0 >= SERVE_S:
                    return
                yield pool[i % len(pool)]

        faces = sum(len(e) for e in client.embed_stream(items()))
        return faces, faces / (time.perf_counter() - t0)

    def run():
        try:
            serve_embeddings.serve(server, sock, max_requests=5)
        except BaseException as e:  # reported by the main thread
            errors.append(e)
            raise

    _build.LAUNCHES.clear()
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    deadline = time.time() + 60
    while not os.path.exists(sock):
        if errors or time.time() > deadline:
            raise RuntimeError(f"server did not start: {errors}")
        time.sleep(0.05)
    client = serve_embeddings.EmbeddingClient(sock)
    replies = [client.embed(r) for r in requests]
    launches = dict(_build.LAUNCHES)
    for req, emb in zip(requests, replies):
        require(emb.shape == (len(req), server.model.cfg.dim)
                and np.isfinite(emb).all(), f"reply {emb.shape} for {len(req)}")
        np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0,
                                   rtol=1e-5)
        np.testing.assert_allclose(emb, server.embed(req), rtol=0, atol=1e-6)
    served = {"kernel": timed_stream()}
    # the server is idle between connections: swap in the plain model
    server.model = build("plain", state, dev)
    server.embed(pool[0])  # warm-up of the plain configuration
    served["plain"] = timed_stream()
    thread.join(timeout=120)
    if thread.is_alive() or errors:
        raise RuntimeError(f"server thread did not finish cleanly: {errors}")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    rates = " ".join(f"{c}: {n} faces in a {SERVE_S:g} s stream, "
                     f"faces_per_s={r:.1f};" for c, (n, r) in served.items())
    print(f"phase 5 served {len(replies)} replies (n=1,64,71): "
          f"launches={launches}; {rates} "
          f"{'FAIL' if missing else 'ok'}", flush=True)
    require(not missing, f"the served path never launched {missing}")
    return launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="also profile both configurations into DIR")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — "
                         "this smoke run needs an NVIDIA GPU")
    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = card()
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}); nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 1 kernels built/loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)

    gather = phase_gather(dev, args.seed)
    mlp = phase_mlp(dev, args.seed)
    state = init_random_(full_width("kernel", "fused_ln"), args.seed).state_dict()
    phase_model(dev, args.seed, state)
    if args.profile:
        phase_profile(dev, args.seed, state, args.profile)
    launches = phase_serve(dev, args.seed, state)

    record = {"kernels": [
        dict(name=name, route="cuda", **KERNELS[name],
             launches=launches[name], max_abs_err=res["bfloat16"]["max_abs_err"],
             ms=res["bfloat16"]["ms"], plain_ms=res["bfloat16"]["plain_ms"])
        for name, res in (("patch_gather", gather), ("fused_ln_mlp", mlp))
    ]}
    print(json.dumps(record))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
