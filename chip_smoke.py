#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``lafs_cvpr2024_tpu_torch/csrc`` and
drives its three paths at the full width of Part-fViT-B (dim 768, depth 12,
11 heads × 64, mlp 2048, 196 landmarks, MobileNetV3-large stem, 112×112
input, bf16) with random weights from ``--seed``: the embedding server, the
SSL training step and the supervised finetuning step. Phases, one line
each:

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
   swapped, for the plain one;
6. kernel 2 with dropout 0.1 and the pre-activation u saved, against its
   plain version at the SSL step's shapes (T = 2·32·197 global and
   8·32·37 local tokens), bf16 and fp32: output mask bit-identical, y and
   u within tolerance, kernel, plain and dense ms;
7. kernel 3 (LN-fused MLP backward) against its plain version at the same
   shapes, rates 0 and 0.1: do, hd, du, xn, dx, dγ, dβ within tolerance,
   hidden mask bit-identical, kernel, plain and cuBLAS dense-backward ms;
8. the SSL step (``train/ssl.py``) with a DINOHead of 100,000 outputs, 2
   global + 8 local crops of batch 32, 36 local landmarks, jitter 5,
   dropout/emb-dropout/drop-path 0.1, bf16 compute, fp32 head, landmark
   CNN and teacher, bf16 moments, on synthetic crops from ``--seed``: 3
   warm-up and 10 timed steps per configuration (imgs/s = 32 / step time),
   the three kernels' launch counts on the kernel configuration's steps,
   loss finite, teacher and center moved, the weight-norm gain moved by its
   weight decay alone; then one step of both configurations at every rate
   0 from the same state and tokens: loss within 1e-4 relative, every
   student gradient at cosine ≥ 0.9995;
9. kernel 6 (fused attention forward) against its plain version at the
   supervised step's (200, 11, 197, 64) and at S = 128, 130 and 512, on
   strided views of a ``to_qkv`` output, bf16 and fp32: kernel, plain and
   einsum-path (``torch.matmul`` + softmax) ms;
10. kernel 7 (its backward) the same way: dQ, dK, dV within tolerance,
    kernel, plain and einsum-autograd ms;
11. the supervised finetuning step (``train/supervised.py``) at the
    ``configs/finetune_webface4m.toml`` recipe: CosFace over 205,990
    classes (s 64, m 0.4), 3 microbatches of 200 uint8 images, mixup 0.2
    at probability 0.1, dropout/emb-dropout/drop-path 0.1, bf16 compute,
    fp32 moments, layer decay 0.58, from ``--seed``: 1 warm-up and
    ``SUP_TIMED`` timed steps per configuration (kernel: gather kernel,
    ``fused_ln`` MLP, ``fused`` attention; plain: ``gather``, ``dense``,
    ``einsum``; imgs/s = 600 / step time), the five kernels' launches per
    step (3 / 36 / 36 / 36 / 36), loss finite, weights and BatchNorm
    statistics moved; then one step of both configurations at every rate
    and the mixup probability 0 from the same state: loss within 1e-3
    relative, gradient cosine ≥ 0.999 on every transformer, embedding and
    head leaf and ≥ 0.99 on the landmark CNN and its head (its BatchNorm
    scales and biases moved off their init first); the BatchNorm biases
    whose exact gradient is zero are held to ≤ 5e-2 of the landmark CNN's
    largest gradient instead.

Any failure raises (non-zero exit); without CUDA it exits non-zero before
printing any result. The last lines are the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.

``--profile DIR`` adds a torch.profiler run of both configurations at the
served shape, of two SSL steps and of one supervised step of each
configuration: one table of device time by kernel per run in DIR, a line
with the wall and busy device time, device time summed by kind of kernel,
and one step timed part by part (SSL: tokens, teacher, student forward and
backward, tail; supervised: microbatches forward and backward, update).
"""

from __future__ import annotations

import argparse
import dataclasses
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
from lafs_cvpr2024_tpu_torch.models.layers import DropoutRNG, FeedForward
from lafs_cvpr2024_tpu_torch.models.mobilenet import FlaxBatchNorm2d
from lafs_cvpr2024_tpu_torch.models.partfvit import (
    PartFViT,
    PartFViTConfig,
    init_random_,
)
from lafs_cvpr2024_tpu_torch.ops.augment_device import scale_uint8
from lafs_cvpr2024_tpu_torch.ops.fused_attention import (
    fused_attention_bwd_cuda,
    fused_attention_bwd_plain,
    fused_attention_cuda,
    fused_attention_plain,
)
from lafs_cvpr2024_tpu_torch.ops.fused_mlp import (
    FusedLNMLP,
    dropout_mask,
    fused_ln_mlp_bwd_cuda,
    fused_ln_mlp_bwd_plain,
    fused_ln_mlp_fwd_cuda,
    fused_ln_mlp_fwd_plain,
)
from lafs_cvpr2024_tpu_torch.ops.mixup import MixupConfig
from lafs_cvpr2024_tpu_torch.ops.patch_gather import patch_gather_plain
from lafs_cvpr2024_tpu_torch.ops.patch_gather_cuda import patch_gather_cuda
from lafs_cvpr2024_tpu_torch.train.ssl import (
    SSLConfig,
    create_landmark_provider,
    create_ssl_state,
    make_ssl_train_step,
    step_seeds,
)
from lafs_cvpr2024_tpu_torch.train.supervised import (
    SupervisedConfig,
    create_state,
    make_train_step,
)

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
    "fused_ln_mlp_bwd": dict(
        source="lafs_cvpr2024_tpu_torch/csrc/fused_ln_mlp_bwd.cu",
        replaces="lafs_cvpr2024_tpu/ops/fused_mlp.py:391"),
    "fused_attention": dict(
        source="lafs_cvpr2024_tpu_torch/csrc/fused_attention.cu",
        replaces="lafs_cvpr2024_tpu/ops/fused_attention.py:78"),
    "fused_attention_bwd": dict(
        source="lafs_cvpr2024_tpu_torch/csrc/fused_attention_bwd.cu",
        replaces="lafs_cvpr2024_tpu/ops/fused_attention.py:92"),
}
SERVE_KERNELS = ("patch_gather", "fused_ln_mlp")
SSL_KERNELS = ("patch_gather", "fused_ln_mlp", "fused_ln_mlp_bwd")
SSL_BATCH = 32                         # images per SSL step (bench.py)
SSL_T = {"global": 2 * SSL_BATCH * 197, "local": 8 * SSL_BATCH * 37}
SSL_ARGS = dict(lr=5e-4, wd=0.04, momentum=0.996, teacher_temp=0.04,
                freeze_last=1.0)
TOLS = ((torch.bfloat16, 2e-2), (torch.float32, 1e-4))
DROP_SEED = 123456789                  # the kernels' int dropout seed
SUP_BATCH, SUP_ACC = 200, 3            # configs/finetune_webface4m.toml
SUP_CLASSES = 205990
SUP_LR = 3e-4
SUP_TIMED = 3                          # timed supervised steps per config
SUP_CONFIGS = {"kernel": ("kernel", "fused_ln", "fused"),
               "plain": ("gather", "dense", "einsum")}
# (B, H, S) of one attention call of the supervised step, and ragged S
ATTN_SHAPES = ((SUP_BATCH, 11, 197), (8, 11, 128), (8, 11, 130),
               (4, 11, 512))
ATTN_TOLS = ((torch.bfloat16, 2e-2), (torch.float32, 1e-5))
ATTN_SCALE = 768 ** -0.5               # the model-dim scale of Attention


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


def mlp_arrays(rng, t: int, d: int = 768, h: int = 2048):
    """Operands of one MLP call (x, g, bt, w1, b1, w2, b2), weights in the
    nn.Linear layout, as float64 numpy."""
    return (rng.standard_normal((t, d)) * 2.0 + 0.5,
            1.0 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
            rng.standard_normal((h, d)) / np.sqrt(d),
            0.1 * rng.standard_normal(h),
            rng.standard_normal((d, h)) / np.sqrt(h),
            0.1 * rng.standard_normal(d))


def on_card(arrs, dev, dtype):
    return [torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
            for a in arrs]


def rel_err(got, want):
    """(max abs error, max-norm relative error) of got against want."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def mask_matches(out, keep, undropped) -> bool:
    """The zeros of a dropped-out tensor are the mask's drops, bit for bit:
    dropped elements are 0, and a kept one is 0 only where the value
    before dropout is (GELU rounds to 0 far left of 0)."""
    return torch.equal(out != 0, keep & (undropped != 0))


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def dense_mlp(ops, rate: float, seed: int):
    """What mlp_impl='dense' runs (cuBLAS, unfused): LN, then the port's
    FeedForward with its FastDropout masks."""
    x, g, bt, w1, b1, w2, b2 = ops
    d, h = x.shape[1], w1.shape[0]
    ff = FeedForward(d, h, rate).to(x.device, x.dtype).train()
    with torch.no_grad():
        ff.net[0].weight.copy_(w1), ff.net[0].bias.copy_(b1)
        ff.net[3].weight.copy_(w2), ff.net[3].bias.copy_(b2)
    rng = DropoutRNG(seed, x.device)
    return ff, lambda: ff(F.layer_norm(x, (d,), g, bt, 1e-5), rng)


def phase_mlp(dev, seed: int) -> dict:
    rng = np.random.default_rng(seed + 1)
    d = 768
    arrs = mlp_arrays(rng, TOKENS)
    out = {}
    for dtype, tol in TOLS:
        ops = on_card(arrs, dev, dtype)
        got, _ = fused_ln_mlp_fwd_cuda(*ops)
        want, _ = fused_ln_mlp_fwd_plain(*ops)
        torch.cuda.synchronize()
        require(got.shape == want.shape == (TOKENS, d) and got.dtype == dtype,
                f"fused_ln_mlp output {tuple(got.shape)} {got.dtype}")
        err, rel = rel_err(got, want)
        ms = cuda_ms(lambda: fused_ln_mlp_fwd_cuda(*ops), iters=10)
        plain_ms = cuda_ms(lambda: fused_ln_mlp_fwd_plain(*ops), iters=10)
        with torch.no_grad():
            dense_ms = cuda_ms(dense_mlp(ops, 0.0, seed)[1], iters=10)
        name = dtype_name(dtype)
        ok = rel <= tol and bool(torch.isfinite(got).all())
        print(f"phase 3 fused_ln_mlp {name}: max_abs_err={err:.3e} "
              f"rel_err={rel:.3e} (tol {tol:g}) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} dense_ms={dense_ms:.4f} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"fused_ln_mlp kernel disagrees in {name}")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return out


def phase_mlp_train(dev, seed: int) -> dict:
    """Kernel 2 at rate 0.1 with u saved, at the SSL step's token counts."""
    rng = np.random.default_rng(seed + 4)
    out = {}
    for crops, t in SSL_T.items():
        arrs = mlp_arrays(rng, t)
        for dtype, tol in TOLS:
            ops = on_card(arrs, dev, dtype)
            kw = dict(rate=0.1, seed=DROP_SEED, save_u=True)
            got, u = fused_ln_mlp_fwd_cuda(*ops, **kw)
            want, u_want = fused_ln_mlp_fwd_plain(*ops, **kw)
            torch.cuda.synchronize()
            m2 = dropout_mask(t, 768, DROP_SEED, 0.1, 1, dtype, dev)
            y0, _ = fused_ln_mlp_fwd_plain(*ops)
            masks = mask_matches(got, m2, y0) and mask_matches(want, m2, y0)
            err, rel = rel_err(got, want)
            _, rel_u = rel_err(u, u_want)
            ms = cuda_ms(lambda: fused_ln_mlp_fwd_cuda(*ops, **kw), iters=10)
            plain_ms = cuda_ms(lambda: fused_ln_mlp_fwd_plain(*ops, **kw),
                               iters=5)
            with torch.no_grad():
                dense_ms = cuda_ms(dense_mlp(ops, 0.1, seed)[1], iters=10)
            name = dtype_name(dtype)
            ok = (masks and rel <= tol and rel_u <= tol
                  and bool(torch.isfinite(got).all()))
            print(f"phase 6 fused_ln_mlp dropout+u {crops} T={t} {name}: "
                  f"mask_bit_identical={masks} max_abs_err={err:.3e} "
                  f"rel_err={rel:.3e} u_rel_err={rel_u:.3e} (tol {tol:g}) "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"dense_ms={dense_ms:.4f} {'ok' if ok else 'FAIL'}",
                  flush=True)
            require(ok, f"kernel 2 with dropout disagrees ({crops}, {name})")
            out[(crops, name)] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, dense_ms=dense_ms)
    return out


def phase_mlp_bwd(dev, seed: int) -> dict:
    """Kernel 3 against its plain version, rates 0 and 0.1."""
    rng = np.random.default_rng(seed + 5)
    names = ("do", "hd", "du", "xn", "dx", "dg", "dbt")
    out = {}
    for crops, t in SSL_T.items():
        arrs = mlp_arrays(rng, t)
        dy_np = rng.standard_normal((t, 768))
        for dtype, tol in TOLS:
            x, g, bt, w1, b1, w2, b2 = ops = on_card(arrs, dev, dtype)
            dy = torch.from_numpy(dy_np.astype(np.float32)).to(dev, dtype)
            _, u = fused_ln_mlp_fwd_plain(*ops, save_u=True)
            for rate in (0.0, 0.1):
                bw = (x, u, dy, g, bt, w1, w2)
                kw = dict(rate=rate, seed=DROP_SEED)
                got = fused_ln_mlp_bwd_cuda(*bw, **kw)
                want = fused_ln_mlp_bwd_plain(*bw, **kw)
                torch.cuda.synchronize()
                errs = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
                masks = True
                if rate:
                    m1 = dropout_mask(t, 2048, DROP_SEED, rate, 0, dtype, dev)
                    m2 = dropout_mask(t, 768, DROP_SEED, rate, 1, dtype, dev)
                    h0 = F.gelu(u.float()).to(dtype)
                    masks = all(mask_matches(o[0], m2, dy)
                                and mask_matches(o[1], m1, h0)
                                for o in (got, want))
                ms = cuda_ms(lambda: fused_ln_mlp_bwd_cuda(*bw, **kw), iters=10)
                plain_ms = cuda_ms(lambda: fused_ln_mlp_bwd_plain(*bw, **kw),
                                   iters=5)
                # the whole fused backward: kernel 3 + dW1, dW2, db1, db2
                leaves = [a.detach().requires_grad_() for a in ops]
                y = FusedLNMLP.apply(*leaves, 1e-5, rate, DROP_SEED)
                fused_ms = cuda_ms(lambda: torch.autograd.grad(
                    y, leaves, dy, retain_graph=True), iters=10)
                ff, fwd = dense_mlp(leaves, rate, seed)
                xl = leaves[0]
                yd = fwd()
                dense_ms = cuda_ms(lambda: torch.autograd.grad(
                    yd, [xl, *leaves[1:3], *ff.parameters()], dy,
                    retain_graph=True), iters=10)
                del y, yd
                name = dtype_name(dtype)
                worst = max(r for _, r in errs.values())
                ok = (masks and worst <= tol
                      and all(bool(torch.isfinite(a).all()) for a in got))
                print(f"phase 7 fused_ln_mlp_bwd {crops} T={t} {name} "
                      f"rate={rate}: mask_bit_identical={masks} rel_err "
                      + " ".join(f"{n}={r:.2e}" for n, (_, r) in errs.items())
                      + f" (tol {tol:g}) kernel_ms={ms:.4f} "
                      f"kernel_plus_wgrad_ms={fused_ms:.4f} "
                      f"plain_ms={plain_ms:.4f} dense_bwd_ms={dense_ms:.4f} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                require(ok, f"kernel 3 disagrees ({crops}, {name}, {rate})")
                out[(crops, name, rate)] = dict(
                    max_abs_err=max(e for e, _ in errs.values()), ms=ms,
                    plain_ms=plain_ms, dense_ms=dense_ms, fused_ms=fused_ms)
    return out


def ssl_cfg(config: str, rate: float = 0.1) -> SSLConfig:
    """The SSL recipe at full width (bench.py's flagship cell; moments in
    bf16 as the CLI's default, the head and landmark CNN in fp32)."""
    gather_impl, mlp_impl = CONFIGS[config]
    model = PartFViTConfig(with_land=False, loss_type="None", num_classes=0,
                           gather_impl=gather_impl, mlp_impl=mlp_impl,
                           dropout=rate, emb_dropout=rate,
                           drop_path_rate=rate)
    return SSLConfig(model=model, compute_dtype=torch.bfloat16,
                     head_dtype=torch.float32, landmark_dtype=torch.float32,
                     moment_dtype=torch.bfloat16)


def ssl_crops(dev, seed: int):
    """Synthetic (clean, augmented) crops in [-1, 1], made on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed + 6)

    def crops(n):
        return torch.rand((n, SSL_BATCH, 112, 112, 3), generator=gen,
                          device=dev) * 2 - 1
    return crops(2), crops(2), crops(8), crops(8)


def phase_ssl(dev, seed: int) -> dict:
    state0 = create_ssl_state(ssl_cfg("kernel"), seed, dev)
    land = create_landmark_provider(ssl_cfg("kernel"), seed + 1, dev)
    batch = ssl_crops(dev, seed)
    n_params = sum(p.numel() for p in state0.student.values())
    g_key = "head.last_layer.weight_g"
    out = dict(state0=state0, land=land, batch=batch)
    for config in CONFIGS:
        step = make_ssl_train_step(ssl_cfg(config))
        state = state0
        torch.cuda.reset_peak_memory_stats()
        if config == "kernel":
            _build.LAUNCHES.clear()
        for _ in range(3):
            state, m = step(state, land, *batch, **SSL_ARGS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            state, m = step(state, land, *batch, **SSL_ARGS)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / 10
        if config == "kernel":
            out["launches"] = dict(_build.LAUNCHES)
        # the gated gain: AdamW sees a zero gradient, so it moves by
        # p - lr·(wd·p) per step alone (the JAX tail's decay of it)
        g_want = state0.student[g_key].clone()
        lr, wd = (float(np.float32(SSL_ARGS[k])) for k in ("lr", "wd"))
        for _ in range(13):
            g_want = g_want - lr * (wd * g_want)
        g_ok = torch.allclose(state.student[g_key], g_want, rtol=1e-6, atol=0)
        key = "backbone.transformer.layers.0.1.fn.fn.net.0.weight"
        moved = (not torch.equal(state.teacher[key], state0.teacher[key])
                 and state.center.abs().sum().item() > 0)
        ok = np.isfinite(loss) and moved and g_ok and state.step == 13
        out[config] = dict(step_ms=step_s * 1e3, imgs_per_s=SSL_BATCH / step_s,
                           loss=loss)
        print(f"phase 8 ssl {config}: {n_params / 1e6:.1f} M params, "
              f"step_ms={step_s * 1e3:.2f} imgs_per_s={SSL_BATCH / step_s:.1f}"
              f" loss_after_13_steps={loss:.5f} teacher_and_center_moved="
              f"{moved} weight_g_by_decay_only={g_ok} peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"SSL step checks failed ({config})")
        del state, m
    missing = [k for k in SSL_KERNELS if out["launches"].get(k, 0) == 0]
    print(f"phase 8 ssl launches on the kernel configuration's 13 steps: "
          f"{out['launches']} {'FAIL' if missing else 'ok'}", flush=True)
    require(not missing, f"the SSL path never launched {missing}")
    return out


def phase_ssl_agree(dev, ssl: dict) -> None:
    """One step's loss and gradients, both configurations at every rate 0,
    from the same state and the same tokens."""
    state0, land, batch = ssl["state0"], ssl["land"], ssl["batch"]
    steps = {c: make_ssl_train_step(ssl_cfg(c, 0.0)) for c in CONFIGS}
    s_land, s_glob, s_loc = step_seeds(state0.seed, state0.step)
    g_in, l_in = steps["kernel"].make_tokens(
        land, *batch, torch.Generator(device=dev).manual_seed(s_land))
    res = {}
    for c, st in steps.items():
        t_out = st.teacher_forward(state0, g_in)
        loss, _, grads = st.student_loss_and_grads(
            state0, g_in, l_in, t_out, SSL_ARGS["teacher_temp"],
            (s_glob, s_loc))
        res[c] = (loss.item(), grads)
    (lk, gk), (lp, gp) = res["kernel"], res["plain"]
    rel = abs(lk - lp) / abs(lp)
    cos = grad_cosines(gk, gp)
    worst = min(cos, key=cos.get)
    ok = rel <= 1e-4 and cos[worst] >= 0.9995
    print(f"phase 8 ssl kernel-vs-plain at rate 0: loss {lk:.6f} vs {lp:.6f} "
          f"(rel {rel:.2e}, tol 1e-4); gradient cosine min {cos[worst]:.6f} "
          f"({worst}) over {len(cos)} leaves (tol 0.9995) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, "SSL kernel and plain configurations disagree")


def grad_cosines(ga: dict, gb: dict) -> dict:
    """Cosine of each gradient leaf of ``ga`` with the same leaf of ``gb``
    (1 where both are zero), in float64."""
    cos = {}
    for n in ga:
        a, b = ga[n].double().flatten(), gb[n].double().flatten()
        na, nb = a.norm().item(), b.norm().item()
        cos[n] = 1.0 if na == nb == 0 else (a @ b).item() / max(na * nb, 1e-300)
    return cos


def attn_operands(dev, dtype, b: int, h: int, s: int, seed: int):
    """q, k, v as the Attention module makes them, strided (B, H, S, 64)
    views of one (B, S, 3·H·64) ``to_qkv`` output, and a contiguous dO;
    scaled so that the logits span a few units (a peaked softmax)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = (torch.randn((b, s, 3 * h * 64), generator=gen, device=dev)
           * 3.0).to(dtype)
    q, k, v = (t.reshape(b, s, h, 64).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    do = torch.randn((b, h, s, 64), generator=gen, device=dev).to(dtype)
    return q, k, v, do


def einsum_attention(q, k, v, scale: float):
    """What ``attn_impl='einsum'`` runs (cuBLAS batched products, softmax in
    the operands' dtype)."""
    return torch.matmul((torch.matmul(q, k.transpose(-1, -2)) * scale)
                        .softmax(-1), v)


def phase_attn(dev, seed: int) -> dict:
    """Kernel 6 against its plain version; times at the step's shape."""
    out = {}
    for i, (b, h, s) in enumerate(ATTN_SHAPES):
        for dtype, tol in ATTN_TOLS:
            q, k, v, _ = attn_operands(dev, dtype, b, h, s, seed + 8 + i)
            got = fused_attention_cuda(q, k, v, ATTN_SCALE)
            want = fused_attention_plain(q, k, v, ATTN_SCALE)
            torch.cuda.synchronize()
            require(got.shape == want.shape == (b, h, s, 64)
                    and got.dtype == dtype, f"fused_attention output "
                    f"{tuple(got.shape)} {got.dtype}")
            err, rel = rel_err(got, want)
            ok = rel <= tol and bool(torch.isfinite(got).all())
            name = dtype_name(dtype)
            times = ""
            if i == 0:
                res = dict(max_abs_err=err, rel_err=rel, ms=cuda_ms(
                    lambda: fused_attention_cuda(q, k, v, ATTN_SCALE)),
                    plain_ms=cuda_ms(lambda: fused_attention_plain(
                        q, k, v, ATTN_SCALE), iters=5),
                    einsum_ms=cuda_ms(lambda: einsum_attention(
                        q, k, v, ATTN_SCALE)))
                out[name] = res
                times = (f" kernel_ms={res['ms']:.4f} plain_ms="
                         f"{res['plain_ms']:.4f} einsum_ms="
                         f"{res['einsum_ms']:.4f}")
            print(f"phase 9 fused_attention ({b}, {h}, {s}, 64) {name}: "
                  f"max_abs_err={err:.3e} rel_err={rel:.3e} (tol {tol:g})"
                  f"{times} {'ok' if ok else 'FAIL'}", flush=True)
            require(ok, f"kernel 6 disagrees at S={s} in {name}")
    return out


def phase_attn_bwd(dev, seed: int) -> dict:
    """Kernel 7 against its plain version; times at the step's shape,
    beside autograd through the einsum path."""
    out = {}
    for i, (b, h, s) in enumerate(ATTN_SHAPES):
        for dtype, tol in ATTN_TOLS:
            q, k, v, do = attn_operands(dev, dtype, b, h, s, seed + 12 + i)
            got = fused_attention_bwd_cuda(q, k, v, do, ATTN_SCALE)
            want = fused_attention_bwd_plain(q, k, v, do, ATTN_SCALE)
            torch.cuda.synchronize()
            require(all(a.shape == (b, h, s, 64) and a.dtype == dtype
                        and bool(torch.isfinite(a).all()) for a in got),
                    f"fused_attention_bwd outputs at S={s} in {dtype}")
            errs = {n: rel_err(a, w) for n, a, w in zip("qkv", got, want)}
            worst = max(r for _, r in errs.values())
            ok = worst <= tol
            name = dtype_name(dtype)
            times = ""
            if i == 0:
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                o = einsum_attention(*leaves, ATTN_SCALE)
                res = dict(
                    max_abs_err=max(e for e, _ in errs.values()),
                    rel_err=worst,
                    ms=cuda_ms(lambda: fused_attention_bwd_cuda(
                        q, k, v, do, ATTN_SCALE)),
                    plain_ms=cuda_ms(lambda: fused_attention_bwd_plain(
                        q, k, v, do, ATTN_SCALE), iters=5),
                    einsum_ms=cuda_ms(lambda: torch.autograd.grad(
                        o, leaves, do, retain_graph=True)))
                del o
                out[name] = res
                times = (f" kernel_ms={res['ms']:.4f} plain_ms="
                         f"{res['plain_ms']:.4f} einsum_autograd_ms="
                         f"{res['einsum_ms']:.4f}")
            print(f"phase 10 fused_attention_bwd ({b}, {h}, {s}, 64) {name}: "
                  "rel_err " + " ".join(f"d{n}={r:.2e}"
                                        for n, (_, r) in errs.items())
                  + f" (tol {tol:g}){times} {'ok' if ok else 'FAIL'}",
                  flush=True)
            require(ok, f"kernel 7 disagrees at S={s} in {name}")
    return out


def sup_cfg(config: str, rate: float = 0.1,
            mix_prob: float = 0.1) -> SupervisedConfig:
    """The ``configs/finetune_webface4m.toml`` recipe on one GPU in either
    configuration; ``rate`` for dropout, embedding dropout and drop path."""
    gather_impl, mlp_impl, attn_impl = SUP_CONFIGS[config]
    model = PartFViTConfig(num_classes=SUP_CLASSES, gather_impl=gather_impl,
                           mlp_impl=mlp_impl, attn_impl=attn_impl,
                           dropout=rate, emb_dropout=rate,
                           drop_path_rate=rate)
    mixup = MixupConfig(mixup_alpha=0.2, prob=mix_prob,
                        num_classes=SUP_CLASSES)
    return SupervisedConfig(model=model, acc_step=SUP_ACC, mixup=mixup,
                            compute_dtype=torch.bfloat16, input_scale="unit")


def sup_batch(dev, seed: int, cfg: SupervisedConfig):
    """One step's uint8 images and int labels, made on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    n, size = SUP_BATCH * cfg.acc_step, cfg.model.image_size
    images = torch.randint(0, 256, (n, size, size, 3), generator=gen,
                           device=dev, dtype=torch.uint8)
    labels = torch.randint(0, cfg.model.num_classes, (n,), generator=gen,
                           device=dev)
    return images, labels


def phase_sup(dev, seed: int) -> dict:
    cfg = sup_cfg("kernel")
    state0 = create_state(cfg, seed, dev)
    batch = sup_batch(dev, seed, cfg)
    n_imgs = batch[0].shape[0]
    n_params = sum(p.numel() for p in state0.params.values())
    steps = 1 + SUP_TIMED
    qkv = "transformer.layers.0.0.fn.fn.to_qkv.weight"
    out = dict(state0=state0, batch=batch)
    # a launch per microbatch (gather) and per layer and microbatch
    per_layer = cfg.model.depth * cfg.acc_step
    want = {"patch_gather": cfg.acc_step, "fused_ln_mlp": per_layer,
            "fused_ln_mlp_bwd": per_layer, "fused_attention": per_layer,
            "fused_attention_bwd": per_layer}
    for config in SUP_CONFIGS:
        step = make_train_step(sup_cfg(config))
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        state, m = step(state0, *batch, SUP_LR)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SUP_TIMED):
            state, m = step(state, *batch, SUP_LR)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / SUP_TIMED
        launches = dict(_build.LAUNCHES)
        per_step = {k: v / steps for k, v in launches.items() if v}
        if config == "kernel":
            out["launches"] = launches
            launches_ok = per_step == want
        else:
            launches_ok = not per_step  # the plain configuration: none
        moved = (not torch.equal(state.params[qkv], state0.params[qkv])
                 and any(not torch.equal(state.batch_stats[k],
                                         state0.batch_stats[k])
                         for k in state.batch_stats
                         if k.endswith("running_var")))
        ok = (np.isfinite(loss) and m["skipped_nonfinite"].item() == 0
              and moved and launches_ok and state.step == steps)
        out[config] = dict(step_ms=step_s * 1e3, imgs_per_s=n_imgs / step_s,
                           loss=loss)
        print(f"phase 11 supervised {config}: {n_params / 1e6:.1f} M params, "
              f"{n_imgs} images a step, step_ms={step_s * 1e3:.2f} "
              f"imgs_per_s={n_imgs / step_s:.1f} loss_after_{steps}_steps="
              f"{loss:.5f} weights_and_bn_stats_moved={moved} peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"launches_per_step={per_step} {'ok' if ok else 'FAIL'}",
              flush=True)
        require(ok, f"supervised step checks failed ({config})")
        del state, m
    return out


def shift_bn(params: dict, model: PartFViT, seed: int) -> dict:
    """The landmark CNN's BatchNorm scales and biases moved by seeded
    amounts: at their init (1, 0) many of its gradients vanish in exact
    arithmetic (ReLU is homogeneous, a training-mode BatchNorm removes
    per-channel scale and mean), and two configurations' rounding noise
    there has no direction to compare."""
    rng = np.random.default_rng(seed)
    out = dict(params)
    for name, mod in model.named_modules():
        if isinstance(mod, FlaxBatchNorm2d):
            w, b = out[f"{name}.weight"], out[f"{name}.bias"]
            n = w.numel()
            out[f"{name}.weight"] = w * torch.from_numpy(
                rng.uniform(0.5, 1.5, n).astype(np.float32)).to(w.device)
            out[f"{name}.bias"] = b + torch.from_numpy(
                rng.uniform(-0.5, 0.5, n).astype(np.float32)).to(b.device)
    return out


def phase_sup_agree(dev, sup: dict, seed: int) -> None:
    """One step's loss and gradients, both configurations at every rate
    and the mixup probability 0, the landmark Dropout(0.5) set to 0, from
    the same state and images."""
    steps = {c: make_train_step(sup_cfg(c, 0.0, 0.0)) for c in SUP_CONFIGS}
    model = steps["kernel"].model
    state = dataclasses.replace(
        sup["state0"], params=shift_bn(sup["state0"].params, model, seed + 9))
    res = {}
    for c, step in steps.items():
        step.model.landmark_dropout.p = 0.0
        loss, grads, _ = step.loss_and_grads(state, *sup["batch"])
        res[c] = (loss.item(), grads)
    (lk, gk), (lp, gp) = res["kernel"], res["plain"]
    rel = abs(lk - lp) / abs(lp)
    # zero in exact arithmetic: rounding noise in both, no direction
    noise = {f"stn.{n}" for n in model.stn.shift_invariant_biases()}
    cos = grad_cosines({n: g for n, g in gk.items() if n not in noise}, gp)
    land = {n: c for n, c in cos.items()
            if n.startswith(("stn.", "output_layer."))}
    rest = {n: c for n, c in cos.items() if n not in land}
    w_land, w_rest = min(land, key=land.get), min(rest, key=rest.get)
    stn_max = max(g.abs().max().item() for n, g in gp.items()
                  if n.startswith("stn."))
    noise_rel = max(max(gk[n].abs().max().item(), gp[n].abs().max().item())
                    for n in noise) / stn_max
    ok = (rel <= 1e-3 and rest[w_rest] >= 0.999 and land[w_land] >= 0.99
          and noise_rel <= 5e-2 and np.isfinite(lk))
    print(f"phase 11 supervised kernel-vs-plain at rate 0: loss {lk:.6f} vs "
          f"{lp:.6f} (rel {rel:.2e}, tol 1e-3); gradient cosine min "
          f"{rest[w_rest]:.6f} ({w_rest}) over {len(rest)} transformer, "
          f"embedding and head leaves (tol 0.999), {land[w_land]:.6f} "
          f"({w_land}) over {len(land)} landmark-branch leaves (tol 0.99); "
          f"{len(noise)} BatchNorm biases with zero exact gradient left out, "
          f"their max |g| {noise_rel:.2e} of the landmark CNN's largest "
          f"(tol 5e-2) {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, "supervised kernel and plain configurations disagree")


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


# kinds of device kernels, matched in order against the profiler's names
KINDS = (
    ("kernel 7 fused attention backward", ("attn_bwd_",)),
    ("kernel 6 fused attention forward", ("attn_fwd_",)),
    ("kernel 3 fused MLP backward", ("ln_mlp_bwd_",)),
    ("kernel 2 fused MLP forward", ("ln_mlp_bf16_kernel", "ln_mlp_f32_kernel")),
    ("kernel 1 patch gather", ("patch_gather",)),
    ("cuBLAS/CUTLASS GEMM", ("gemm", "nvjet", "xmma", "cutlass", "s1688",
                             "s16816", "wgmma", "splitKreduce")),
    ("cuDNN convolution", ("conv", "implicit_convolve", "dgrad", "wgrad")),
    ("softmax", ("softmax",)),
    ("layer norm", ("layer_norm",)),
    ("batch norm", ("batch_norm", "bn_fw")),
    ("optimizer tail (foreach)", ("foreach", "multi_tensor")),
    ("reductions", ("reduce",)),
    ("random (dropout masks)", ("philox", "random", "distribution")),
    ("elementwise, copies", ("elementwise", "vectorized", "copy", "Memcpy",
                             "Memset", "unrolled", "cat", "index", "gather",
                             "scatter", "where")),
)


def by_kind(kernels, steps: int) -> dict:
    """Device ms per step summed by kind of kernel."""
    out = {}
    for e in kernels:
        kind = next((k for k, keys in KINDS
                     if any(key in e.key for key in keys)), "other")
        out[kind] = out.get(kind, 0.0) + e.self_device_time_total / steps / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def ssl_parts_ms(step, state, land, batch) -> dict:
    """One SSL step timed part by part with CUDA events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    s_land, s_glob, s_loc = step_seeds(state.seed, state.step)
    gen = torch.Generator(device=state.center.device).manual_seed(s_land)
    ev[0].record()
    g_in, l_in = step.make_tokens(land, *batch, gen)
    ev[1].record()
    t_out = step.teacher_forward(state, g_in)
    ev[2].record()
    _, _, grads = step.student_loss_and_grads(
        state, g_in, l_in, t_out, SSL_ARGS["teacher_temp"], (s_glob, s_loc))
    ev[3].record()
    step.tail(state, grads, SSL_ARGS["lr"], SSL_ARGS["wd"],
              SSL_ARGS["momentum"], SSL_ARGS["freeze_last"])
    ev[4].record()
    torch.cuda.synchronize()
    names = ("tokens", "teacher_fwd", "student_fwd_bwd", "tail")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def phase_ssl_profile(dev, ssl: dict, path: str) -> None:
    """Two profiled SSL steps per configuration after a warm-up step: the
    device time by kernel (table in DIR) and by kind, busy and idle share
    against the CUDA-event wall time, and one step timed part by part."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(path, exist_ok=True)
    state0, land, batch = ssl["state0"], ssl["land"], ssl["batch"]
    for config in CONFIGS:
        step = make_ssl_train_step(ssl_cfg(config))
        state, _ = step(state0, land, *batch, **SSL_ARGS)
        parts = ssl_parts_ms(step, state, land, batch)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        s = state
        for _ in range(2):
            s, _ = step(s, land, *batch, **SSL_ARGS)
        end.record()
        torch.cuda.synchronize()
        wall = start.elapsed_time(end) / 2
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s = state
            for _ in range(2):
                s, _ = step(s, land, *batch, **SSL_ARGS)
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 2 / 1e3
        with open(os.path.join(path, f"profile_ssl_{config}.txt"), "w") as f:
            f.write(events.table(sort_by="self_device_time_total",
                                 row_limit=120))
        require(busy > 0, f"the profiler saw no device time for SSL {config}")
        kinds = " ".join(f"{k}={v:.2f}" for k, v in by_kind(kernels, 2).items())
        part_txt = " ".join(f"{k}={v:.2f}" for k, v in parts.items())
        print(f"phase P profile ssl {config}: wall_ms={wall:.3f} "
              f"busy_ms={busy:.3f} idle={1 - busy / wall:.3f}; parts_ms "
              f"{part_txt}; device_ms_by_kind {kinds} -> {path}", flush=True)
        del s, state


def phase_sup_profile(dev, sup: dict, path: str) -> None:
    """One profiled supervised step per configuration after a warm-up
    step: device time by kernel (table in DIR) and by kind, busy and idle
    share against the CUDA-event wall time of an unprofiled step, and one
    step timed part by part (the microbatches' forward and backward, the
    update)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(path, exist_ok=True)
    state0, batch = sup["state0"], sup["batch"]
    for config in SUP_CONFIGS:
        step = make_train_step(sup_cfg(config))
        state, _ = step(state0, *batch, SUP_LR)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss, grads, stats = step.loss_and_grads(state, *batch)
        ev[1].record()
        step.update(state, loss, grads, stats, SUP_LR)
        ev[2].record()
        torch.cuda.synchronize()
        parts = {"micro_fwd_bwd": ev[0].elapsed_time(ev[1]),
                 "update": ev[1].elapsed_time(ev[2])}
        del loss, grads, stats
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, *batch, SUP_LR)
        end.record()
        torch.cuda.synchronize()
        wall = start.elapsed_time(end)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, *batch, SUP_LR)
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        with open(os.path.join(path, f"profile_sup_{config}.txt"), "w") as f:
            f.write(events.table(sort_by="self_device_time_total",
                                 row_limit=120))
        require(busy > 0, f"the profiler saw no device time for sup {config}")
        kinds = " ".join(f"{k}={v:.2f}" for k, v in by_kind(kernels, 1).items())
        part_txt = " ".join(f"{k}={v:.2f}" for k, v in parts.items())
        print(f"phase P profile supervised {config}: wall_ms={wall:.3f} "
              f"busy_ms={busy:.3f} idle={1 - busy / wall:.3f}; parts_ms "
              f"{part_txt}; device_ms_by_kind {kinds} -> {path}", flush=True)
        del state


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
    missing = [k for k in SERVE_KERNELS if launches.get(k, 0) == 0]
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
                   help="also profile both configurations (serving, SSL and "
                        "supervised) into DIR")
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
    phase_mlp(dev, args.seed)
    state = init_random_(full_width("kernel", "fused_ln"), args.seed).state_dict()
    phase_model(dev, args.seed, state)
    if args.profile:
        phase_profile(dev, args.seed, state, args.profile)
    served = phase_serve(dev, args.seed, state)
    del state
    train_fwd = phase_mlp_train(dev, args.seed)
    train_bwd = phase_mlp_bwd(dev, args.seed)
    ssl = phase_ssl(dev, args.seed)
    phase_ssl_agree(dev, ssl)
    if args.profile:
        phase_ssl_profile(dev, ssl, args.profile)
    ssl_launches = ssl["launches"]
    del ssl
    attn = phase_attn(dev, args.seed)
    attn_bwd = phase_attn_bwd(dev, args.seed)
    sup = phase_sup(dev, args.seed)
    phase_sup_agree(dev, sup, args.seed)
    if args.profile:
        phase_sup_profile(dev, sup, args.profile)

    # each kernel's numbers at its main-path shape in bf16: the gather at the
    # served batch, kernel 2 with dropout and u at the SSL global crops' T,
    # kernel 3 at rate 0.1 there, kernels 6 and 7 at one attention call of
    # the supervised step; launches counted on the supervised steps
    measured = {"patch_gather": gather["bfloat16"],
                "fused_ln_mlp": train_fwd[("global", "bfloat16")],
                "fused_ln_mlp_bwd": train_bwd[("global", "bfloat16", 0.1)],
                "fused_attention": attn["bfloat16"],
                "fused_attention_bwd": attn_bwd["bfloat16"]}
    record = {"kernels": [
        dict(name=name, route="cuda", **KERNELS[name],
             launches=sup["launches"][name],
             launches_by_path={"serve": served.get(name, 0),
                               "ssl": ssl_launches.get(name, 0),
                               "supervised": sup["launches"][name]},
             max_abs_err=res["max_abs_err"], ms=res["ms"],
             plain_ms=res["plain_ms"])
        for name, res in measured.items()
    ]}
    print(json.dumps(record))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
