"""Time the fused MLP kernels (2-5) of the source tree it runs from, on
the card:

    python -m lafs_cvpr2024_tpu_torch.cli.time_mlp_kernels [--tag A]

Kernels 4 and 5 at the SimMIM step's shape (T = 25,216, 768 → 2,048,
bf16), rate 0.1 with u saved and rate 0; kernel 2 at the SSL global
crops' T = 12,608 (rate 0.1, u saved) and at the served T = 25,216 (rate
0); kernel 3 at T = 12,608, rate 0.1. Each time is the mean of 20
back-to-back calls by CUDA events after 3 warm-up calls, taken 3 times.
Kernels 4 and 5 are first held against their plain versions (max-norm
relative error, and whether the zeros of y and hd are the plain
version's). Prints one JSON line, then the card's name and power limit.

For an A/B of two source trees (two variants of ``csrc/``, or a parent
commit unpacked with ``git archive``), run it from each tree's root, each
in its own process, in the order A B B A: each tree builds its own
kernel library under its ``build/``.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..ops import fused_mlp as fm

SEED = 123456789  # the kernels' int dropout seed


def _ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tag", default="", help="a name for this tree's line")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_mlp_kernels needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    t, d, h = 25216, 768, 2048

    def card(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)

    x = card(rng.standard_normal((t, d)) * 2 + 0.5)
    w1 = card(rng.standard_normal((h, d)) / np.sqrt(d))
    b1 = card(0.1 * rng.standard_normal(h))
    w2 = card(rng.standard_normal((d, h)) / np.sqrt(h))
    b2 = card(0.1 * rng.standard_normal(d))
    g = card(1 + 0.1 * rng.standard_normal(d))
    bt = card(0.1 * rng.standard_normal(d))
    dy = card(rng.standard_normal((t, d)))
    kw = dict(rate=0.1, seed=SEED)
    fwd = (x, w1, b1, w2, b2)
    y, u = fm.fused_mlp_fwd_cuda(*fwd, save_u=True, **kw)
    y_want, u_want = fm.fused_mlp_fwd_plain(*fwd, save_u=True, **kw)
    got = fm.fused_mlp_bwd_cuda(u_want, dy, w2, **kw)
    want = fm.fused_mlp_bwd_plain(u_want, dy, w2, **kw)
    torch.cuda.synchronize()
    out = dict(
        tag=args.tag,
        k4_rel=[_rel(y, y_want), _rel(u, u_want)],
        k4_zeros_as_plain=torch.equal(y != 0, y_want != 0),
        k5_rel=[_rel(a, b) for a, b in zip(got, want)],
        k5_zeros_as_plain=torch.equal(got[1] != 0, want[1] != 0))
    t3 = 12608
    x3, dy3, u3 = x[:t3], dy[:t3], u_want[:t3]
    runs = {
        "k4_ms": lambda: fm.fused_mlp_fwd_cuda(*fwd, save_u=True, **kw),
        "k4_rate0_ms": lambda: fm.fused_mlp_fwd_cuda(*fwd),
        "k5_ms": lambda: fm.fused_mlp_bwd_cuda(u_want, dy, w2, **kw),
        "k5_rate0_ms": lambda: fm.fused_mlp_bwd_cuda(u_want, dy, w2),
        "k2_T12608_ms": lambda: fm.fused_ln_mlp_fwd_cuda(
            x3, g, bt, w1, b1, w2, b2, save_u=True, **kw),
        "k2_served_ms": lambda: fm.fused_ln_mlp_fwd_cuda(
            x, g, bt, w1, b1, w2, b2),
        "k3_T12608_ms": lambda: fm.fused_ln_mlp_bwd_cuda(
            x3, u3, dy3, g, bt, w1, w2, **kw),
    }
    for name, fn in runs.items():
        out[name] = [_ms(fn) for _ in range(3)]
    print(json.dumps(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
