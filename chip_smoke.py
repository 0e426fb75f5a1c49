#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``lafs_cvpr2024_tpu_torch/csrc`` and
drives its paths at the full width of Part-fViT-B (dim 768, depth 12,
11 heads × 64, mlp 2048, 196 landmarks, MobileNetV3-large stem, 112×112
input, bf16) with random weights from ``--seed``: the embedding server, the
SSL training step, the supervised finetuning step, the SimMIM
pretraining step, the SSL pretraining CLI on JPEG records, the TPU MLP
microbenchmark's fused kernel (row 10) and the evaluation CLIs. Phases,
one line each:

1. the device (and ``nvidia-smi``'s name and power limit), the kernels'
   build and ptxas's registers and spills of the Hopper kernels (2-5 at D
   768, each template instance, 6 and 7's two passes, 8 and 9 at D 768,
   11a-c, all bf16, and row 10; a spill, a missing kernel or a
   serialised wgmma, ptxas's warning C7520, fails the run);
2. kernel 1 (patch gather) against its plain PyTorch version at
   (128, 112, 112, 3) images and 196 landmarks, including landmarks at and
   beyond every edge, in fp32 and bf16; and its library yardstick, one
   ``F.grid_sample(align_corners=False, padding_mode='zeros')`` call on
   the same images in fp32 (NCHW, a (B, 196·8, 8, 2) grid made outside
   the timed call), its output reordered to (x_off, y_off, c) and held to
   1e-4 of the plain gather;
3. kernel 2 (LN-fused MLP) against its plain version at the served
   T = 128·197 tokens, 768 → 2048, rate 0, in bf16 and fp32: kernel ms by
   events and on the device (profiler), plain and dense ms, the bound;
4. the full-width model: the kernel configuration (kernels 1, 2 and 6, as
   the eval loader builds it) against the plain one, per-row embedding
   cosine ≥ 1 − 1e-3;
5. the port's ``EmbeddingServer`` from a saved ``.pth`` (batch 64, flip on)
   on a unix socket in a thread, three requests (n = 1, 64, 71) through
   ``EmbeddingClient``, the kernels' launch counts on that path, and the
   served faces/s over a stream of requests of 64 lasting ``SERVE_S``
   seconds, for the kernel configuration and then, with the server's model
   swapped, for the plain one;
6. kernel 2 with dropout 0.1 and the pre-activation u saved, against its
   plain version at the SSL step's shapes (T = 2·32·197 global and
   8·32·37 local tokens), bf16 and fp32: output mask bit-identical, y and
   u within tolerance, kernel (events and device), plain and dense ms;
   then at T = 1, 63, 64, 65, 127, 128, 129 and 333 (the edges of the
   64-row cluster and the 128-row hash tile), every (rate, u) instance;
7. kernel 3 (LN-fused MLP backward) against its plain version at the same
   shapes, rates 0 and 0.1: do, hd, du, xn, dx, dγ, dβ within tolerance,
   hidden mask bit-identical, kernel (events and device), kernel plus the
   weight gradients, plain and cuBLAS dense-backward ms; then the edges;
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
   supervised step's (200, 11, 197, 64), at S = 128, 130, 256, 257 and
   512, and at the served forward's (512, 11, 197, 64) (a request of 256
   faces and their flips), on strided views of a ``to_qkv`` output, bf16
   and fp32: at the supervised and the served shape kernel, plain,
   einsum-path (``torch.matmul`` + softmax) and SDPA ms beside the bound;
10. kernel 7 (its backward) the same way: dQ, dK, dV within tolerance and
    finite, kernel, plain, einsum-autograd and SDPA-autograd ms beside the
    bound;
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
    largest gradient instead;
12. kernels 4 and 5 (the fused MLP without the LayerNorm, forward and
    backward) against their plain versions at the SimMIM step's
    T = 128·197 tokens, 768 → 2048, rates 0 and 0.1, u saved, bf16 and
    fp32: y, u, do, hd and du within tolerance, both masks bit-identical;
    at rate 0.1 kernel ms by events and on the device, plain ms, the first
    design's ms at H = 1,920 (the nearest width it takes), the cuBLAS
    dense block forward and its autograd backward, and the whole
    ``FusedMLP`` backward (kernel 5, dx, dW1, dW2 and the bias sums, the
    like-for-like pair of that autograd backward); then T = 1 to 333 as in
    phase 6, every (rate, u) instance of kernel 4 and both rates of 5;
13. kernels 8 and 9 (LayerNorm + the bias-free ``to_qkv``, forward and
    backward) against their plain versions at T = 128·197, D 768,
    O = 2,112, at a ragged T = 130 with O = 192, at the Hopper designs'
    edges (T = 1, 65, 129; O = 8, 2,120) and in the first design at D 768
    (T = 333, O = 100), bf16 and fp32: y, xn, dx, dγ and dβ within
    tolerance; at the step's shape kernel ms by events and on the device,
    plain ms, the first design's ms at O = 2,111 (the nearest width it
    takes), ``F.linear(F.layer_norm(x), W)`` and its autograd backward,
    and the whole ``FusedLNLinear`` backward (kernel 9 + dW, the
    like-for-like pair of that autograd backward);
14. the SimMIM step (``train/simmim.py``) at the ``cli/train_simmim.py``
    defaults: 128 uint8 112² images scaled on the card, landmark patches
    from a random frozen landmark CNN, mask ratio 0.6, dropout/emb-dropout/
    drop-path 0.1, bf16 compute and moments, clip 5.0, lr 1e-4, wd 0.05:
    2 warm-up and ``SIM_TIMED`` timed steps per configuration (kernel:
    the port's ``SimMIMConfig`` default, gather kernel, ``fused`` MLP,
    ``lnqkv`` attention; jax_cli: what the JAX CLI's defaults resolve to on
    a TPU, gather kernel, ``fused_ln`` MLP, einsum attention; plain:
    ``gather``, ``dense``, ``einsum``; imgs/s = 128 / step time), peak
    memory, the kernels' launches per step (kernel: 1 / 12 / 12 / 12 / 12
    of kernels 1, 4, 5, 8, 9; jax_cli: 1 / 12 / 12 of kernels 1, 2, 3),
    loss finite, the weights and the mask token moved; then one step of
    each kernel configuration and the plain one at every rate 0 from the
    same state, tokens and mask: loss within 1e-3 relative, every gradient
    leaf at cosine ≥ 0.999; and one step of the grid variant
    (``use_landmarks=False``);
15. kernels 11a-c (flash attention forward, dK/dV, dQ) against their plain
    versions at the SSL step's flash calls, globals (64, 11, 197, 64) and
    locals (256, 11, 37, 64), and at N = 17, 49, 65 (the 64-row tiles'
    tail widths and the single-tile path), 128, 130 and 1,024, on strided
    ``to_qkv`` views, bf16 (2e-2) and fp32 (1e-5), the fp32 logsumexp and
    11c's statistics scratch to 1e-5 (its padded rows exactly +inf and 0)
    and ``scaled_dot_product_attention``'s output to the same bars; at
    the step's two shapes, kernel ms by events and by the profiler's
    device time, plain, SDPA forward and autograd-backward and bound ms,
    and 11c + 11b beside SDPA's whole backward on the device (events with
    the launches queued behind a spin kernel);
    ``flash_attention_bwd_cuda`` must run 11c and 11b and no other kernel;
16. the card's JPEG decoder (nvJPEG with libjpeg's chroma upsampling)
    against PIL's decode of the fixture ``tests/data/ssl_rec`` (4:2:0
    records, and one face each in 4:4:4, 4:2:2 and grayscale): mean
    absolute difference ≤ 1 level, the maximum printed, 64 images timed;
    and the prefetcher's batches over 3 epochs while the default stream is
    busy, each equal to a plain decode of its records;
17. the SSL step as ``cli/train_ssl.py --attn-impl flash --device-aug``
    runs it, on 32 decoded fixture images (the LAFS multi-crop inside the
    step): 2 warm-up and ``SSL_FLASH_TIMED`` timed steps of the kernel
    configuration (gather kernel, ``fused_ln``, flash) and the plain one
    (``gather``, ``dense``, einsum), imgs/s, 11a-c launches per step
    (36 / 24 / 24); then one step at every rate 0 from the same state and
    crops, the flash kernels against their plain versions in the same
    configuration: loss within 1e-4 relative, gradient cosine ≥ 0.9995;
18. ``python -m lafs_cvpr2024_tpu_torch.cli.train_ssl --config
    configs/ssl_ms1m.toml --attn-impl flash`` at full width on the fixture
    (batch 32, 2 epochs, ``--warmup-epochs 1 --saveckp-steps 3``) in
    subprocesses: a straight run (finite losses in ``log.txt``, imgs/s)
    and, beside it on the same card, a run stopped by SIGTERM during its
    first step and run again, whose final state must equal the straight
    run's (≤ 1e-6 relative);
19. row 10, the bias-free fused MLP of ``benchmarks/bench_mlp_fusion.py``
    (``ops/mlp_fusion.py``, ``csrc/mlp_fusion.cu``): its path, the
    microbenchmark's ``main`` (T = 22,016, 768 → 2048, bf16: 1 + 30
    chained calls at rate 0, then at rate 0.1), timed and counted; then at
    T = 22,016, 22,080 (the row's shape), a ragged 300 and the cluster's
    and the hash tile's edges 1, 65 and 257, against the plain version at
    rates 0 and 0.1 (≤ 2e-2 relative, output zeros where the plain
    version's are), both dropout masks bit-identical (a one-hot W2 on a
    constant hidden layer makes each output one hidden element, exactly:
    kernel and plain outputs equal bit for bit) with each draw's keep
    fraction within 0.9 ± 0.002 from T = 300; kernel, plain and
    ``mlp_fusion_dense`` (the ``xla_mlp`` yardstick) ms;
20. evaluation at full width from phase 5's ``.pth``, the three CLIs in
    subprocesses beside each other: ``cli/extract_embeddings.py`` on the
    fixture's 64 records (bf16, flip on), per-row cosine ≥ 1 − 1e-3
    against the plain configuration's embeddings of the same decoded
    images, kernels 1 and 2 launched; ``cli/evaluate_bin.py`` on a
    ``.bin`` of 32 fixture pairs (fp32): a finite accuracy equal to
    ``perform_val``'s in this process; ``cli/evaluate_ijb.py`` on
    ``tests/data/ijb_mini``: a finite TPR@FPR table, and the card's decode
    and warp within a mean of 1 level of the stored numpy ``norm_crop`` of
    PIL's decode; then faces/s of both configurations over batches of 256
    faces (the fixture's repeated), flip on.

Any failure raises (non-zero exit); without CUDA it exits non-zero before
printing any result. The last lines are the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.

``--profile DIR`` adds a torch.profiler run of both configurations at the
served shape, of two SSL steps (phase 8's and phase 17's) and of one
supervised and one SimMIM step of each configuration: one table of device time by kernel per run in DIR,
a line with the wall and busy device time, device time summed by kind of
kernel, and one step timed part by part (SSL: the multi-crop in phase
17's, tokens, teacher, student forward and backward, tail; supervised: microbatches forward and
backward, update; SimMIM: tokens and mask, forward and backward, clip and
AdamW).

The kernels' record gives each kernel's ``bound_ms``: the larger of the
FLOPs its call does over the card's peak rate for the dtype and the bytes
it must move (each input read once, each output written once) over the
memory rate, from the shapes this run measured (``bound``). Kernel 1's
``library_ms`` is phase 2's ``grid_sample``. Kernels 2-5, 8 and 9 also
carry their device time and their yardsticks: the dense block (kernels 2
and 4, and kernel 2's served shape from phase 3), a backward kernel plus
the products around it beside the dense block's autograd backward
(kernels 3 and 5), ``F.linear(F.layer_norm(x), W)`` (kernel 8) and kernel
9 plus dW beside that pair's autograd backward (kernel 9), 4 and 5 the
first design's time at H = 1,920 and 8 and 9 at O = 2,111. Kernel 6
carries phase 9's numbers at the served shape (``served``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import pickle
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from lafs_cvpr2024_tpu_torch import _build
from lafs_cvpr2024_tpu_torch.cli import serve_embeddings
from lafs_cvpr2024_tpu_torch.cli.evaluate_ijb import load_image_list
from lafs_cvpr2024_tpu_torch.eval.loading import (
    infer_partfvit_config,
    load_eval_model,
    make_model_embed,
)
from lafs_cvpr2024_tpu_torch.eval.ijb import ARCFACE_SRC, umeyama
from lafs_cvpr2024_tpu_torch.eval.verification import load_bin, perform_val
from lafs_cvpr2024_tpu_torch.data.dataset import FaceRecordDataset
from lafs_cvpr2024_tpu_torch.data.decode import DECODER, decode_batch
from lafs_cvpr2024_tpu_torch.data.decode import library as decode_lib
from lafs_cvpr2024_tpu_torch.data.pipeline import EpochSampler, Prefetcher
from lafs_cvpr2024_tpu_torch.models.layers import DropoutRNG, FeedForward
from lafs_cvpr2024_tpu_torch.models.mobilenet import FlaxBatchNorm2d
from lafs_cvpr2024_tpu_torch.models.partfvit import (
    PartFViT,
    PartFViTConfig,
    init_random_,
)
from lafs_cvpr2024_tpu_torch.ops import flash_attention as flash_ops
from lafs_cvpr2024_tpu_torch.ops.augment_device import (
    lafs_multicrop_device,
    scale_uint8,
)
from lafs_cvpr2024_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_cuda,
    flash_attention_bwd_dkv_cuda,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq_cuda,
    flash_attention_bwd_dq_plain,
    flash_attention_bwd_plain,
    flash_attention_fwd_cuda,
    flash_attention_plain,
    stats_tiles,
)
from lafs_cvpr2024_tpu_torch.ops.fused_attention import (
    fused_attention_bwd_cuda,
    fused_attention_bwd_plain,
    fused_attention_cuda,
    fused_attention_plain,
)
from lafs_cvpr2024_tpu_torch.ops.fused_ln_linear import (
    FusedLNLinear,
    fused_ln_linear_bwd_cuda,
    fused_ln_linear_bwd_plain,
    fused_ln_linear_fwd_cuda,
    fused_ln_linear_fwd_plain,
)
from lafs_cvpr2024_tpu_torch.ops.fused_mlp import (
    FusedLNMLP,
    FusedMLP,
    dropout_bits,
    dropout_mask,
    fused_ln_mlp_bwd_cuda,
    fused_ln_mlp_bwd_plain,
    fused_ln_mlp_fwd_cuda,
    fused_ln_mlp_fwd_plain,
    fused_mlp_bwd_cuda,
    fused_mlp_bwd_plain,
    fused_mlp_fwd_cuda,
    fused_mlp_fwd_plain,
    keep_threshold,
)
from lafs_cvpr2024_tpu_torch.ops.mixup import MixupConfig
from lafs_cvpr2024_tpu_torch.ops.mlp_fusion import TILE as MLP10_TILE
from lafs_cvpr2024_tpu_torch.ops.mlp_fusion import (
    mlp_fusion,
    mlp_fusion_cuda,
    mlp_fusion_dense,
    mlp_fusion_plain,
    mlp_fusion_weights_from_jax,
)
from lafs_cvpr2024_tpu_torch.ops.patch_gather import patch_gather_plain
from lafs_cvpr2024_tpu_torch.ops.patch_gather_cuda import patch_gather_cuda
from lafs_cvpr2024_tpu_torch.ops.warp import decode_warp_batch
from lafs_cvpr2024_tpu_torch.train.checkpoint import TrainingCheckpointer
from lafs_cvpr2024_tpu_torch.train.simmim import (
    SimMIMConfig,
    create_simmim_state,
    make_simmim_train_step,
)
from lafs_cvpr2024_tpu_torch.train.simmim import step_seeds as sim_seeds
from lafs_cvpr2024_tpu_torch.train.ssl import (
    SSLConfig,
    aug_seed,
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
SERVE_S = 5.0                          # length of each timed serving window
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
    "fused_mlp": dict(
        source="lafs_cvpr2024_tpu_torch/csrc/fused_mlp.cu",
        replaces="lafs_cvpr2024_tpu/ops/fused_mlp.py:94"),
    "fused_mlp_bwd": dict(
        source="lafs_cvpr2024_tpu_torch/csrc/fused_mlp_bwd.cu",
        replaces="lafs_cvpr2024_tpu/ops/fused_mlp.py:117"),
    "fused_ln_linear": dict(
        source="lafs_cvpr2024_tpu_torch/csrc/fused_ln_linear.cu",
        replaces="lafs_cvpr2024_tpu/ops/fused_ln_linear.py:53"),
    "fused_ln_linear_bwd": dict(
        source="lafs_cvpr2024_tpu_torch/csrc/fused_ln_linear_bwd.cu",
        replaces="lafs_cvpr2024_tpu/ops/fused_ln_linear.py:61"),
    # row 11: models/layers.py:254 (_flash_attention) calls JAX's TPU flash
    # attention; its three pallas_calls, in jax 0.9.0's
    # jax/experimental/pallas/ops/tpu/flash_attention.py
    "flash_attention": dict(
        source="lafs_cvpr2024_tpu_torch/csrc/flash_attention.cu",
        replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:331"),
    "flash_attention_bwd_dkv": dict(
        source="lafs_cvpr2024_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:796"),
    "flash_attention_bwd_dq": dict(
        source="lafs_cvpr2024_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:1146"),
    # row 10: the TPU MLP microbenchmark's fused kernel
    "mlp_fusion": dict(
        source="lafs_cvpr2024_tpu_torch/csrc/mlp_fusion.cu",
        replaces="benchmarks/bench_mlp_fusion.py:54"),
}
SERVE_KERNELS = ("patch_gather", "fused_ln_mlp", "fused_attention")
# the plain served model: the eval loader's config with every kernel off
SERVE_PLAIN = dict(gather_impl="gather", mlp_impl="dense", attn_impl="einsum")
SSL_KERNELS = ("patch_gather", "fused_ln_mlp", "fused_ln_mlp_bwd")
SSL_BATCH = 32                         # images per SSL step (bench.py)
SSL_T = {"global": 2 * SSL_BATCH * 197, "local": 8 * SSL_BATCH * 37}
SSL_ARGS = dict(lr=5e-4, wd=0.04, momentum=0.996, teacher_temp=0.04,
                freeze_last=1.0)
TOLS = ((torch.bfloat16, 2e-2), (torch.float32, 1e-4))
# kernels 2 and 3 at the edges of the 64-row cluster tile and of the hash's
# 128-row tile, and a ragged T; their kernels' names in the profiler (bf16
# at D 768: the Hopper design)
EDGE_T = (1, 63, 64, 65, 127, 128, 129, 333)
LN_MLP_KEYS = {torch.bfloat16: ("ln_mlp_fwd_sm90", "ln_mlp_bwd_sm90"),
               torch.float32: ("ln_mlp_f32_kernel", "ln_mlp_bwd_f32_kernel")}
# shared memory of a CTA of kernels 2-4 (csrc/fused_ln_mlp_sm90.cuh) and row
# 10: the row tile, h, two 48 KB stages, the barriers, 1 KB of alignment
LN_MLP_SMEM = 16 * 8192 + 2 * 49152 + 64 + 1024
DROP_SEED = 123456789                  # the kernels' int dropout seed
SUP_BATCH, SUP_ACC = 200, 3            # configs/finetune_webface4m.toml
SUP_CLASSES = 205990
SUP_LR = 3e-4
SUP_TIMED = 2                          # timed supervised steps per config
SUP_CONFIGS = {"kernel": ("kernel", "fused_ln", "fused"),
               "plain": ("gather", "dense", "einsum")}
# (B, H, S) of one attention call of the supervised step, ragged S, the
# edges of kernel 6's register-resident row (256, 257) and the longest S;
# kernel 6 also at one call of the served forward (bench_torch's serving
# cells: 256 faces a request and their flips)
ATTN_SHAPES = ((SUP_BATCH, 11, 197), (8, 11, 128), (8, 11, 130),
               (8, 11, 256), (8, 11, 257), (4, 11, 512))
SERVED_ATTN = (2 * 256, 11, 197)
ATTN_TOLS = ((torch.bfloat16, 2e-2), (torch.float32, 1e-5))
ATTN_SCALE = 768 ** -0.5               # the model-dim scale of Attention
SIM_BATCH = 128                        # cli/train_simmim.py's batch a chip
SIM_T = SIM_BATCH * 197                # MLP and QKV rows of one SimMIM step
SIM_TIMED = 5                          # timed SimMIM steps per config
# (gather, MLP, attention): the port's SimMIMConfig default (kernels 1, 4,
# 5, 8, 9), cli/train_simmim.py's defaults as the JAX CLI resolves them on
# a TPU (--mlp-impl auto → fused_ln, --attn-impl einsum: kernels 1-3;
# lafs_cvpr2024_tpu/utils/config.py:48-56), and plain PyTorch
SIM_CONFIGS = {"kernel": ("kernel", "fused", "lnqkv"),
               "jax_cli": ("kernel", "fused_ln", "einsum"),
               "plain": ("gather", "dense", "einsum")}
SIM_ARGS = dict(lr=1e-4, wd=0.05)      # cli/train_simmim.py's defaults
QKV_O = 3 * 11 * 64                    # to_qkv width of Part-fViT-B: 2,112
# kernels 8 and 9: the SimMIM step's (T, O), a ragged shape, the Hopper
# designs' edges (T across their 64-row tiles; O below, at and past kernel
# 8's 192-column tile and kernel 9's 64-wide chunk) and the first design at
# D 768 (O not a multiple of 8); their names in the profiler; the nearest
# width to 2,112 that the first design takes, timed beside the new ones
LN_LINEAR_SHAPES = ((SIM_T, QKV_O), (130, 192), (1, 8), (65, 2120),
                    (129, QKV_O), (333, 100))
LN_LINEAR_KEYS = {
    torch.bfloat16: ("ln_linear_fwd_sm90", "ln_linear_bwd_sm90"),
    torch.float32: ("ln_linear_fwd_f32_kernel", "ln_linear_bwd_f32_kernel")}
FIRST_O = QKV_O - 1
# kernels 4 and 5: their names in the profiler (bf16 at D 768: the Hopper
# design) and the nearest hidden width to 2,048 that the first design
# takes, timed beside the new one
MLP_NOL_KEYS = {torch.bfloat16: ("mlp_fwd_sm90", "mlp_bwd_sm90"),
                torch.float32: ("mlp_fwd_f32_kernel", "mlp_bwd_f32_kernel")}
FIRST_H = 2048 - 128
# the SSL CLI slice: (B, H, N) of the step's flash calls (2 globals of 197
# tokens, 8 locals of 37), 11a's tail widths (17, 49: one key block cut to
# 32 and 64; 65: a whole block and a tail of 16), ragged and long N, and
# the expected launches
FLASH_SHAPES = {"global": (2 * SSL_BATCH, 11, 197),
                "local": (8 * SSL_BATCH, 11, 37)}
FLASH_EXTRA = ((8, 11, 17), (8, 11, 49), (8, 11, 65), (8, 11, 128),
               (8, 11, 130), (4, 11, 1024))
FLASH_KERNELS = ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq")
# per step: the teacher's 12 layers on the globals, the student's 12 on
# the globals and 12 on the locals; backward on the student's 24
FLASH_PER_STEP = {"flash_attention": 36, "flash_attention_bwd_dkv": 24,
                  "flash_attention_bwd_dq": 24}
SSL_FLASH_CONFIGS = {"kernel": ("kernel", "fused_ln", "flash"),
                     "plain": ("gather", "dense", "einsum")}
SSL_FLASH_TIMED = 5                    # timed steps per configuration
FIXTURE = os.path.join("tests", "data", "ssl_rec")  # 64 JPEGs, 112x112
CLI_TIMEOUT_S = 300
# row 10 (benchmarks/bench_mlp_fusion.py): main's default T, the row's T in
# PERF.md, a ragged T and the edges of the 64-row cluster tile and the
# 256-row hash tile; the microbenchmark's chained calls per variant
MLP10_T = (22016, 22080, 300, 1, 65, 257)
MLP10_ITERS = 30
MLP10_KEEP_T = 300                     # least T whose keep fractions are held
IJB_MINI = os.path.join("tests", "data", "ijb_mini")
EVAL_BATCH = 256                       # faces per timed eval batch
# the card's peaks for the bounds: H100 SXM data sheet (dense bf16 tensor
# cores; fp32 outside the tensor cores, TF32 off), HBM3 rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12


def bound(flops: float, moved: float, dtype=torch.bfloat16) -> dict:
    """The least time the card could take for a call: the larger of its
    operations over the peak rate for ``dtype`` and its compulsory bytes
    over the memory rate, and which of the two it is."""
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    mem_ms = moved / PEAK_BYTES * 1e3
    return dict(bound_ms=max(ops_ms, mem_ms),
                bound_by="operations" if ops_ms >= mem_ms else "bytes")


def nbytes(*tensors) -> int:
    """Bytes of the tensors (each read or written once)."""
    return sum(t.numel() * t.element_size() for t in tensors)


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


# the kernels written for Hopper (TMA, wgmma): ptxas must report no spill
# and no serialised wgmma (warning C7520)
SM90_KERNELS = {"fused_ln_mlp (2, bf16, D 768)": "ln_mlp_fwd_sm90",
                "fused_ln_mlp_bwd (3, bf16, D 768)": "ln_mlp_bwd_sm90",
                # after kernels 2 and 3: their names hold these
                "fused_mlp (4, bf16, D 768)": "mlp_fwd_sm90",
                "fused_mlp_bwd (5, bf16, D 768)": "mlp_bwd_sm90",
                "fused_attention (6, bf16)": "attn_fwd_bf16",
                "fused_attention_bwd dq (7, bf16)": "attn_bwd_dq_bf16",
                "fused_attention_bwd dkv (7, bf16)": "attn_bwd_dkv_bf16",
                "flash_attention (11a, bf16)": "flash_fwd_bf16",
                "flash_attention_bwd dkv (11b, bf16)": "flash_bwd_dkv_bf16",
                "flash_attention_bwd dq (11c, bf16)": "flash_bwd_dq_bf16",
                "fused_ln_linear (8, bf16, D 768)": "ln_linear_fwd_sm90",
                "fused_ln_linear_bwd (9, bf16, D 768)": "ln_linear_bwd_sm90",
                "mlp_fusion (row 10)": "mlp_fusion_bf16_kernel"}
# the names of the kernels' template arguments, in order: a bool's (false,
# true) labels, or an int's prefix; a kernel not listed has (DROP,)
SM90_TEMPLATE = {"ln_mlp_fwd_sm90": (("rate 0", "dropout"), ("no u", "u")),
                 "mlp_fwd_sm90": (("rate 0", "dropout"), ("no u", "u")),
                 "attn_fwd_bf16": ("NT=",)}


def template_tag(symbol: str, mangled: str) -> str:
    """The instance's template arguments in words, from its mangled name
    (``...<symbol>ILb1ELb0EE...``: bools and ints in order)."""
    rest = mangled.split(symbol, 1)[1]
    if not rest.startswith("I"):
        return ""
    args, i = [], 1
    while rest[i:i + 1] == "L":
        j = rest.index("E", i)
        args.append(int(rest[i + 2:j]))
        i = j + 1
    names = SM90_TEMPLATE.get(symbol, (("rate 0", "dropout"),))
    return "".join(f" {n[a]}" if isinstance(n, tuple) else f" {n}{a}"
                   for n, a in zip(names, args))


def ptxas_report() -> dict:
    """Registers, static shared memory and spill bytes of every instance of
    the ``SM90_KERNELS``, from ``nvcc -Xptxas -v``'s report of the build."""
    out, cur = {}, None
    for line in _build.ptxas_log().read_text().splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            key = next((k for k, v in SM90_KERNELS.items() if v in mangled),
                       None)
            cur = key and key + template_tag(SM90_KERNELS[key], mangled)
            if cur:
                out[cur] = {}
        elif cur and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[cur].update(stack=nums[0], spill_stores=nums[1],
                            spill_loads=nums[2])
        elif cur and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            out[cur]["registers"] = int(words[words.index("registers") - 1])
            out[cur]["smem"] = (int(words[words.index("smem") - 2])
                                if "smem" in words else 0)
    return out


def serialised_wgmma() -> list:
    """ptxas's C7520 warnings (every wgmma of a kernel serialised), each
    with the ``SM90_KERNELS`` entry it names, if any."""
    lines = [line for line in _build.ptxas_log().read_text().splitlines()
             if "C7520" in line]
    return [(next((k for k, v in SM90_KERNELS.items() if v in line), "?"),
             line.strip()) for line in lines]


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


def sample_grid(lands: torch.Tensor, p: int, h: int, w: int) -> torch.Tensor:
    """The (B, N·P, P, 2) fp32 grid of ``F.grid_sample(align_corners=
    False)`` whose samples are the gather's: row n·P + i, column j holds
    (x, y) = (lx + i - P/2 - 0.5, ly + j - P/2 - 0.5), normalised."""
    offs = torch.arange(p, dtype=torch.float32, device=lands.device) - p / 2
    x = lands[..., 0:1].float() + offs - 0.5
    y = lands[..., 1:2].float() + offs - 0.5
    gx, gy = (2 * x + 1) / w - 1, (2 * y + 1) / h - 1
    grid = torch.stack(torch.broadcast_tensors(gx[..., :, None],
                                               gy[..., None, :]), -1)
    return grid.reshape(lands.shape[0], -1, p, 2)


def grid_sample_gather(images: torch.Tensor, lands: torch.Tensor):
    """The gather as one ``F.grid_sample(align_corners=False,
    padding_mode='zeros')`` call in fp32 (in bf16 its grid would place the
    samples up to a fifth of a pixel off), the output reordered to (x_off,
    y_off, c): the call to time and its check. Only the call is timed."""
    b, h, w, c = images.shape
    nchw = images.float().permute(0, 3, 1, 2)
    grid = sample_grid(lands, 8, h, w)

    def call():
        return F.grid_sample(nchw, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=False)
    out = call().permute(0, 2, 3, 1).reshape(b, lands.shape[1], 64 * c)
    return call, out


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
        # the library yardstick: grid_sample on the same images in fp32,
        # held against the plain gather in fp32
        call, lib_out = grid_sample_gather(ti, tl)
        lib_want = patch_gather_plain(ti.float(), tl.float(), 8)
        lib_err = (lib_out - lib_want).abs().max().item()
        library_ms = cuda_ms(call)
        name = str(dtype).split(".")[-1]
        print(f"phase 2 patch_gather {name}: max_abs_err={err.max().item():.3e}"
              f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} grid_sample "
              f"(fp32) ms={library_ms:.4f} its max_abs_err={lib_err:.3e} "
              f"(tol 1e-4) {'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"patch_gather kernel disagrees in {name}")
        require(lib_err <= 1e-4, f"grid_sample is not the gather ({lib_err})")
        out[name] = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms,
                         **bound(8 * got.numel(), nbytes(ti, tl, got), dtype))
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
        key = LN_MLP_KEYS[dtype][0]
        dev_ms, recorded = device_ms(lambda: fused_ln_mlp_fwd_cuda(*ops),
                                     [key])[key]
        plain_ms = cuda_ms(lambda: fused_ln_mlp_fwd_plain(*ops), iters=10)
        with torch.no_grad():
            dense_ms = cuda_ms(dense_mlp(ops, 0.0, seed)[1], iters=10)
        name = dtype_name(dtype)
        bnd = bound(4 * TOKENS * 768 * 2048, nbytes(*ops, got), dtype)
        ok = rel <= tol and bool(torch.isfinite(got).all())
        print(f"phase 3 fused_ln_mlp served T={TOKENS} {name}: "
              f"max_abs_err={err:.3e} rel_err={rel:.3e} (tol {tol:g}) "
              f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} ({recorded} "
              f"launches) plain_ms={plain_ms:.4f} dense_ms={dense_ms:.4f} "
              f"bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"fused_ln_mlp kernel disagrees in {name}")
        out[name] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, dense_ms=dense_ms, **bnd)
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
            key = LN_MLP_KEYS[dtype][0]
            dev_ms, recorded = device_ms(
                lambda: fused_ln_mlp_fwd_cuda(*ops, **kw), [key])[key]
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
                  f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} ({recorded} "
                  f"launches) plain_ms={plain_ms:.4f} dense_ms={dense_ms:.4f} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            require(ok, f"kernel 2 with dropout disagrees ({crops}, {name})")
            out[(crops, name)] = dict(
                max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                dense_ms=dense_ms, library_ms=None,
                **bound(4 * t * 768 * 2048, nbytes(*ops, got, u), dtype))
    phase_mlp_edges(dev, rng)
    return out


def phase_mlp_edges(dev, rng) -> None:
    """Kernel 2 in bf16 at the edges of its 64-row cluster tile and of the
    hash's 128-row tile (the Hopper design; fp32 the first design), every
    (rate, u saved) instance: y and u within tolerance, finite, the output
    mask bit-identical."""
    worst = 0.0
    for t, dtype in itertools.product(EDGE_T, (torch.bfloat16, torch.float32)):
        tol = dict(TOLS)[dtype]
        ops = on_card(mlp_arrays(rng, t), dev, dtype)
        y0, _ = fused_ln_mlp_fwd_plain(*ops)
        for rate, save_u in itertools.product((0.0, 0.1), (False, True)):
            kw = dict(rate=rate, seed=DROP_SEED, save_u=save_u)
            got, u = fused_ln_mlp_fwd_cuda(*ops, **kw)
            want, u_want = fused_ln_mlp_fwd_plain(*ops, **kw)
            torch.cuda.synchronize()
            _, rel = rel_err(got, want)
            rel_u = rel_err(u, u_want)[1] if save_u else 0.0
            masks = True
            if rate:
                m2 = dropout_mask(t, 768, DROP_SEED, rate, 1, dtype, dev)
                masks = (mask_matches(got, m2, y0)
                         and mask_matches(want, m2, y0))
            ok = (masks and rel <= tol and rel_u <= tol
                  and bool(torch.isfinite(got).all()))
            worst = max(worst, rel, rel_u) if dtype == torch.bfloat16 else worst
            require(ok, f"kernel 2 disagrees at T={t} {dtype_name(dtype)} "
                        f"rate={rate} u={save_u}: rel {rel:.3e} u {rel_u:.3e} "
                        f"masks {masks}")
    print(f"phase 6 fused_ln_mlp edges T={EDGE_T} x (rate 0, 0.1) x (u, no "
          f"u), bf16 and fp32: worst bf16 rel_err={worst:.3e} masks "
          f"bit-identical ok", flush=True)


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
                key = LN_MLP_KEYS[dtype][1]
                dev_ms, recorded = device_ms(
                    lambda: fused_ln_mlp_bwd_cuda(*bw, **kw), [key])[key]
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
                      f"device_ms={dev_ms:.4f} ({recorded} launches) "
                      f"kernel_plus_wgrad_ms={fused_ms:.4f} "
                      f"plain_ms={plain_ms:.4f} dense_bwd_ms={dense_ms:.4f} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                require(ok, f"kernel 3 disagrees ({crops}, {name}, {rate})")
                out[(crops, name, rate)] = dict(
                    max_abs_err=max(e for e, _ in errs.values()), ms=ms,
                    device_ms=dev_ms, plain_ms=plain_ms, dense_ms=dense_ms,
                    fused_ms=fused_ms, library_ms=None,
                    **bound(4 * t * 768 * 2048, nbytes(*bw, *got), dtype))
    phase_mlp_bwd_edges(dev, rng)
    return out


def phase_mlp_bwd_edges(dev, rng) -> None:
    """Kernel 3 at the edges of EDGE_T (bf16: the Hopper design, whose
    dγ/dβ partials are one row a 64-row cluster; fp32 the first design),
    rates 0 and 0.1: every output within tolerance and finite, both masks
    bit-identical."""
    names = ("do", "hd", "du", "xn", "dx", "dg", "dbt")
    worst = 0.0
    for t, dtype in itertools.product(EDGE_T, (torch.bfloat16, torch.float32)):
        tol = dict(TOLS)[dtype]
        x, g, bt, w1, b1, w2, b2 = ops = on_card(mlp_arrays(rng, t), dev,
                                                  dtype)
        dy = on_card([rng.standard_normal((t, 768))], dev, dtype)[0]
        _, u = fused_ln_mlp_fwd_plain(*ops, save_u=True)
        for rate in (0.0, 0.1):
            bw = (x, u, dy, g, bt, w1, w2)
            kw = dict(rate=rate, seed=DROP_SEED)
            got = fused_ln_mlp_bwd_cuda(*bw, **kw)
            want = fused_ln_mlp_bwd_plain(*bw, **kw)
            torch.cuda.synchronize()
            rels = {n: rel_err(a, b)[1] for n, a, b in zip(names, got, want)}
            masks = True
            if rate:
                m1 = dropout_mask(t, 2048, DROP_SEED, rate, 0, dtype, dev)
                m2 = dropout_mask(t, 768, DROP_SEED, rate, 1, dtype, dev)
                h0 = F.gelu(u.float()).to(dtype)
                masks = all(mask_matches(o[0], m2, dy)
                            and mask_matches(o[1], m1, h0)
                            for o in (got, want))
            ok = (masks and max(rels.values()) <= tol
                  and all(bool(torch.isfinite(a).all()) for a in got))
            if dtype == torch.bfloat16:
                worst = max(worst, *rels.values())
            require(ok, f"kernel 3 disagrees at T={t} {dtype_name(dtype)} "
                        f"rate={rate}: {rels} masks {masks}")
    print(f"phase 7 fused_ln_mlp_bwd edges T={EDGE_T} x rates (0, 0.1), "
          f"bf16 and fp32: worst bf16 rel_err={worst:.3e} masks "
          f"bit-identical ok", flush=True)


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
    """Kernel 6 against its plain version; times at the step's shape and
    at the served one (under ``"served"``)."""
    out = {"served": {}}
    for i, (b, h, s) in enumerate(ATTN_SHAPES + (SERVED_ATTN,)):
        timed = {ATTN_SHAPES[0]: out, SERVED_ATTN: out["served"]}.get(
            (b, h, s))
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
            if timed is not None:
                res = dict(max_abs_err=err, rel_err=rel, ms=cuda_ms(
                    lambda: fused_attention_cuda(q, k, v, ATTN_SCALE)),
                    plain_ms=cuda_ms(lambda: fused_attention_plain(
                        q, k, v, ATTN_SCALE), iters=5),
                    einsum_ms=cuda_ms(lambda: einsum_attention(
                        q, k, v, ATTN_SCALE)),
                    # the one PyTorch call that computes the same function
                    library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, scale=ATTN_SCALE)),
                    **bound(4 * b * h * s * s * 64, nbytes(q, k, v, got),
                            dtype))
                timed[name] = res
                times = (f" kernel_ms={res['ms']:.4f} plain_ms="
                         f"{res['plain_ms']:.4f} einsum_ms="
                         f"{res['einsum_ms']:.4f} sdpa_ms="
                         f"{res['library_ms']:.4f} bound_ms="
                         f"{res['bound_ms']:.4f} ({res['bound_by']})")
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
                o_sdpa = F.scaled_dot_product_attention(*leaves,
                                                        scale=ATTN_SCALE)
                res = dict(
                    max_abs_err=max(e for e, _ in errs.values()),
                    rel_err=worst,
                    ms=cuda_ms(lambda: fused_attention_bwd_cuda(
                        q, k, v, do, ATTN_SCALE)),
                    plain_ms=cuda_ms(lambda: fused_attention_bwd_plain(
                        q, k, v, do, ATTN_SCALE), iters=5),
                    einsum_ms=cuda_ms(lambda: torch.autograd.grad(
                        o, leaves, do, retain_graph=True)),
                    # the one PyTorch call that computes the same function
                    library_ms=cuda_ms(lambda: torch.autograd.grad(
                        o_sdpa, leaves, do, retain_graph=True)),
                    # recomputed scores, dV, dA, dQ, dK: five products
                    **bound(10 * b * h * s * s * 64, nbytes(q, k, v, do, *got),
                            dtype))
                del o, o_sdpa
                out[name] = res
                times = (f" kernel_ms={res['ms']:.4f} plain_ms="
                         f"{res['plain_ms']:.4f} einsum_autograd_ms="
                         f"{res['einsum_ms']:.4f} sdpa_autograd_ms="
                         f"{res['library_ms']:.4f} bound_ms="
                         f"{res['bound_ms']:.4f} ({res['bound_by']})")
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


def phase_mlp_nol(dev, seed: int) -> dict:
    """Kernels 4 and 5 (no LayerNorm) against their plain versions at the
    SimMIM step's T, rates 0 and 0.1, bf16 and fp32, then at the edges of
    EDGE_T; times at rate 0.1 (mlp_nol_times)."""
    rng = np.random.default_rng(seed + 20)
    t, d, h = SIM_T, 768, 2048
    arrs = mlp_arrays(rng, t)
    dy_np = rng.standard_normal((t, d))
    out = {}
    for dtype, tol in TOLS:
        x, g, bt, w1, b1, w2, b2 = on_card(arrs, dev, dtype)
        dy = torch.from_numpy(dy_np.astype(np.float32)).to(dev, dtype)
        name = dtype_name(dtype)
        for rate in (0.0, 0.1):
            kw = dict(rate=rate, seed=DROP_SEED)
            fwd = (x, w1, b1, w2, b2)
            y, u = fused_mlp_fwd_cuda(*fwd, save_u=True, **kw)
            y_want, u_want = fused_mlp_fwd_plain(*fwd, save_u=True, **kw)
            bwd = (u_want, dy, w2)
            got = fused_mlp_bwd_cuda(*bwd, **kw)
            want = fused_mlp_bwd_plain(*bwd, **kw)
            torch.cuda.synchronize()
            errs = {n: rel_err(a, b) for n, a, b in zip(
                ("y", "u", "do", "hd", "du"), (y, u, *got),
                (y_want, u_want, *want))}
            masks = True
            if rate:
                m1 = dropout_mask(t, h, DROP_SEED, rate, 0, dtype, dev)
                m2 = dropout_mask(t, d, DROP_SEED, rate, 1, dtype, dev)
                y0, _ = fused_mlp_fwd_plain(*fwd)
                h0 = F.gelu(u_want.float()).to(dtype)
                masks = (mask_matches(y, m2, y0) and mask_matches(y_want, m2, y0)
                         and all(mask_matches(o[0], m2, dy)
                                 and mask_matches(o[1], m1, h0)
                                 for o in (got, want)))
            worst = max(r for _, r in errs.values())
            ok = masks and worst <= tol and all(
                bool(torch.isfinite(a).all()) for a in (y, u, *got))
            times = ""
            if rate:
                out[name], times = mlp_nol_times(fwd, dy, y, u, got, errs,
                                                 seed)
            print(f"phase 12 fused_mlp T={t} {name} rate={rate}: "
                  f"mask_bit_identical={masks} rel_err "
                  + " ".join(f"{n}={r:.2e}" for n, (_, r) in errs.items())
                  + f" (tol {tol:g}){times} {'ok' if ok else 'FAIL'}",
                  flush=True)
            require(ok, f"kernel 4 or 5 disagrees ({name}, rate {rate})")
            del y, u, y_want, u_want, got, want
    phase_mlp_nol_edges(dev, rng)
    return out


def mlp_nol_times(fwd, dy, y, u, got, errs, seed: int):
    """Phase 12's times at the SimMIM step's shape and rate 0.1: kernels 4
    and 5 (events and device), their plain versions, the first design at H
    = 1,920 (the nearest width it takes), the dense block forward and its
    autograd backward, and the whole FusedMLP backward (kernel 5, dx, dW1,
    dW2 and the bias sums), the like-for-like pair of that backward; the
    kernels' record entries and the printed line."""
    x, w1, b1, w2, b2 = fwd
    t, d = x.shape
    h = w1.shape[0]
    dtype = x.dtype
    keys = MLP_NOL_KEYS[dtype]
    kw = dict(rate=0.1, seed=DROP_SEED)
    bwd = (u, dy, w2)
    ms = cuda_ms(lambda: fused_mlp_fwd_cuda(*fwd, save_u=True, **kw), iters=10)
    dev_ms = device_ms(lambda: fused_mlp_fwd_cuda(*fwd, save_u=True, **kw),
                       [keys[0]])[keys[0]][0]
    plain_ms = cuda_ms(lambda: fused_mlp_fwd_plain(*fwd, save_u=True, **kw),
                       iters=5)
    bwd_ms = cuda_ms(lambda: fused_mlp_bwd_cuda(*bwd, **kw), iters=10)
    bwd_dev_ms = device_ms(lambda: fused_mlp_bwd_cuda(*bwd, **kw),
                           [keys[1]])[keys[1]][0]
    bwd_plain_ms = cuda_ms(lambda: fused_mlp_bwd_plain(*bwd, **kw), iters=5)
    # the first design at the nearest hidden width it takes (H % 256 = 128)
    cut = (x, w1[:FIRST_H].contiguous(), b1[:FIRST_H].contiguous(),
           w2[:, :FIRST_H].contiguous(), b2)
    u_cut = u[:, :FIRST_H].contiguous()
    first_ms = cuda_ms(lambda: fused_mlp_fwd_cuda(*cut, save_u=True, **kw),
                       iters=10)
    first_bwd_ms = cuda_ms(lambda: fused_mlp_bwd_cuda(u_cut, dy, cut[3], **kw),
                           iters=10)
    del cut, u_cut
    # what mlp_impl='dense' runs on the LayerNorm's output
    ff, _ = dense_mlp((x, None, None, w1, b1, w2, b2), 0.1, seed)
    leaves = [x.detach().requires_grad_(), *ff.parameters()]
    drng = DropoutRNG(seed, x.device)
    with torch.no_grad():
        dense_ms = cuda_ms(lambda: ff(x, drng), iters=10)
    yd = ff(leaves[0], drng)
    dense_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        yd, leaves, dy, retain_graph=True), iters=10)
    # the whole fused backward: kernel 5 + dx, dW1, dW2, db1, db2
    fl = [a.detach().requires_grad_() for a in fwd]
    yf = FusedMLP.apply(*fl, 0.1, DROP_SEED)
    fused_ms = cuda_ms(lambda: torch.autograd.grad(
        yf, fl, dy, retain_graph=True), iters=10)
    del yd, yf
    rec = dict(
        fwd=dict(max_abs_err=max(errs["y"][0], errs["u"][0]), ms=ms,
                 device_ms=dev_ms, plain_ms=plain_ms, first_design_ms=first_ms,
                 first_design_h=FIRST_H, dense_ms=dense_ms, library_ms=None,
                 **bound(4 * t * d * h, nbytes(*fwd, y, u), dtype)),
        bwd=dict(max_abs_err=max(e for n, (e, _) in errs.items()
                                 if n in ("do", "hd", "du")),
                 ms=bwd_ms, device_ms=bwd_dev_ms, plain_ms=bwd_plain_ms,
                 first_design_ms=first_bwd_ms, first_design_h=FIRST_H,
                 kernel_plus_wgrad_ms=fused_ms, dense_ms=dense_bwd_ms,
                 library_ms=None,
                 **bound(2 * t * d * h, nbytes(*bwd, *got), dtype)))
    line = (f" fwd kernel_ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms="
            f"{plain_ms:.4f} first_design_ms(H={FIRST_H})={first_ms:.4f} "
            f"dense_ms={dense_ms:.4f} bound_ms={rec['fwd']['bound_ms']:.4f}; "
            f"bwd kernel_ms={bwd_ms:.4f} device_ms={bwd_dev_ms:.4f} "
            f"plain_ms={bwd_plain_ms:.4f} first_design_ms(H={FIRST_H})="
            f"{first_bwd_ms:.4f} kernel_plus_wgrad_ms={fused_ms:.4f} "
            f"dense_autograd_ms={dense_bwd_ms:.4f} bound_ms="
            f"{rec['bwd']['bound_ms']:.4f}")
    return rec, line


def phase_mlp_nol_edges(dev, rng) -> None:
    """Kernels 4 and 5 at the edges of EDGE_T (bf16: the Hopper designs,
    64-row tiles; fp32 the first design), every (rate, u saved) instance of
    4 and both rates of 5: every output within tolerance and finite, the
    masks bit-identical."""
    worst = 0.0
    for t, dtype in itertools.product(EDGE_T, (torch.bfloat16, torch.float32)):
        tol = dict(TOLS)[dtype]
        x, _, _, w1, b1, w2, b2 = on_card(mlp_arrays(rng, t), dev, dtype)
        fwd = (x, w1, b1, w2, b2)
        dy = on_card([rng.standard_normal((t, 768))], dev, dtype)[0]
        y0, u0 = fused_mlp_fwd_plain(*fwd, save_u=True)
        h0 = F.gelu(u0.float()).to(dtype)
        for rate, save_u in itertools.product((0.0, 0.1), (False, True)):
            kw = dict(rate=rate, seed=DROP_SEED)
            y, u = fused_mlp_fwd_cuda(*fwd, save_u=save_u, **kw)
            y_want, u_want = fused_mlp_fwd_plain(*fwd, save_u=save_u, **kw)
            got, want = [y], [y_want]
            if save_u:
                got.append(u), want.append(u_want)
            if save_u == bool(rate):  # kernel 5 once a rate
                got += fused_mlp_bwd_cuda(u0, dy, w2, **kw)
                want += fused_mlp_bwd_plain(u0, dy, w2, **kw)
            torch.cuda.synchronize()
            rels = [rel_err(a, b)[1] for a, b in zip(got, want)]
            masks = True
            if rate:
                m1 = dropout_mask(t, 2048, DROP_SEED, rate, 0, dtype, dev)
                m2 = dropout_mask(t, 768, DROP_SEED, rate, 1, dtype, dev)
                masks = mask_matches(y, m2, y0) and (
                    len(got) < 3 or (mask_matches(got[-3], m2, dy)
                                     and mask_matches(got[-2], m1, h0)))
            ok = (masks and max(rels) <= tol
                  and all(bool(torch.isfinite(a).all()) for a in got))
            if dtype == torch.bfloat16:
                worst = max(worst, *rels)
            require(ok, f"kernel 4 or 5 disagrees at T={t} {dtype_name(dtype)}"
                        f" rate={rate} u={save_u}: {rels} masks {masks}")
    print(f"phase 12 fused_mlp edges T={EDGE_T} x (rate 0, 0.1) x (u, no u), "
          f"kernel 5 at both rates, bf16 and fp32: worst bf16 rel_err="
          f"{worst:.3e} masks bit-identical ok", flush=True)


def ln_linear_arrays(rng, t: int, d: int, o: int):
    """Operands of one LN + linear call (x, g, bt, w, dy), w in the
    nn.Linear layout, as float64 numpy."""
    return (rng.standard_normal((t, d)) * 2.0 + 0.5,
            1.0 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
            rng.standard_normal((o, d)) / np.sqrt(d),
            rng.standard_normal((t, o)))


def phase_ln_linear(dev, seed: int) -> dict:
    """Kernels 8 and 9 against their plain versions at the SimMIM step's
    T and to_qkv width, at a ragged shape, at the Hopper designs' edges and
    in the first design at D 768; times at the step's shape: kernel (events
    and device), plain, the first design at O = 2,111 (the nearest width it
    takes), F.linear(F.layer_norm(x), W) and, for kernel 9, the whole
    FusedLNLinear backward (kernel 9 + dW) beside that pair's autograd
    backward."""
    rng = np.random.default_rng(seed + 21)
    out = {}
    for t, o in LN_LINEAR_SHAPES:
        arrs = ln_linear_arrays(rng, t, 768, o)
        for dtype, tol in TOLS:
            x, g, bt, w, dy = on_card(arrs, dev, dtype)
            y = fused_ln_linear_fwd_cuda(x, g, bt, w)
            y_want = fused_ln_linear_fwd_plain(x, g, bt, w)
            got = fused_ln_linear_bwd_cuda(x, dy, g, bt, w)
            want = fused_ln_linear_bwd_plain(x, dy, g, bt, w)
            torch.cuda.synchronize()
            errs = {n: rel_err(a, b) for n, a, b in zip(
                ("y", "xn", "dx", "dg", "dbt"), (y, *got), (y_want, *want))}
            worst = max(r for _, r in errs.values())
            ok = worst <= tol and y.shape == (t, o) and all(
                bool(torch.isfinite(a).all()) for a in (y, *got))
            name = dtype_name(dtype)
            times = ""
            if t == SIM_T:
                out[name], times = ln_linear_times(x, g, bt, w, dy, y, got,
                                                   errs, dtype)
            print(f"phase 13 fused_ln_linear T={t} D=768 O={o} {name}: rel_err "
                  + " ".join(f"{n}={r:.2e}" for n, (_, r) in errs.items())
                  + f" (tol {tol:g}){times} {'ok' if ok else 'FAIL'}",
                  flush=True)
            require(ok, f"kernel 8 or 9 disagrees (T={t}, O={o}, {name})")
            del y, y_want, got, want
    return out


def ln_linear_times(x, g, bt, w, dy, y, got, errs, dtype):
    """Phase 13's times at the SimMIM step's shape: the kernels' record
    entries and the printed line."""
    t, o = dy.shape
    ops = (x, g, bt, w)
    keys = LN_LINEAR_KEYS[dtype]
    ms = cuda_ms(lambda: fused_ln_linear_fwd_cuda(*ops), iters=10)
    dev_ms = device_ms(lambda: fused_ln_linear_fwd_cuda(*ops),
                       [keys[0]])[keys[0]][0]
    plain_ms = cuda_ms(lambda: fused_ln_linear_fwd_plain(*ops), iters=5)
    bwd_ms = cuda_ms(lambda: fused_ln_linear_bwd_cuda(x, dy, g, bt, w),
                     iters=10)
    bwd_dev_ms = device_ms(lambda: fused_ln_linear_bwd_cuda(x, dy, g, bt, w),
                           [keys[1]])[keys[1]][0]
    bwd_plain_ms = cuda_ms(lambda: fused_ln_linear_bwd_plain(x, dy, g, bt, w),
                           iters=5)
    # the first design at the nearest width it takes (O % 8 != 0)
    w1, dy1 = w[:FIRST_O].contiguous(), dy[:, :FIRST_O].contiguous()
    first_ms = cuda_ms(lambda: fused_ln_linear_fwd_cuda(x, g, bt, w1),
                       iters=10)
    first_bwd_ms = cuda_ms(lambda: fused_ln_linear_bwd_cuda(
        x, dy1, g, bt, w1), iters=10)
    leaves = [a.detach().requires_grad_() for a in ops]

    def dense(xx, gg, bb, ww):
        return F.linear(F.layer_norm(xx, (768,), gg, bb, 1e-5), ww)
    with torch.no_grad():
        dense_ms = cuda_ms(lambda: dense(*ops), iters=10)
    yd = dense(*leaves)
    dense_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        yd, leaves, dy, retain_graph=True), iters=10)
    # the whole fused backward: kernel 9 + dW = dyᵀ·xn
    yf = FusedLNLinear.apply(*leaves, 1e-5)
    fused_ms = cuda_ms(lambda: torch.autograd.grad(
        yf, leaves, dy, retain_graph=True), iters=10)
    del yd, yf
    rec = dict(
        fwd=dict(max_abs_err=errs["y"][0], ms=ms, device_ms=dev_ms,
                 plain_ms=plain_ms, first_design_ms=first_ms,
                 dense_ms=dense_ms, library_ms=None,
                 **bound(2 * t * 768 * o, nbytes(*ops, y), dtype)),
        bwd=dict(max_abs_err=max(e for n, (e, _) in errs.items() if n != "y"),
                 ms=bwd_ms, device_ms=bwd_dev_ms, plain_ms=bwd_plain_ms,
                 first_design_ms=first_bwd_ms, kernel_plus_wgrad_ms=fused_ms,
                 dense_ms=dense_bwd_ms, library_ms=None,
                 **bound(2 * t * o * 768, nbytes(x, dy, g, bt, w, *got),
                         dtype)))
    line = (f" fwd kernel_ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms="
            f"{plain_ms:.4f} first_design_ms(O={FIRST_O})={first_ms:.4f} "
            f"layer_norm+linear_ms={dense_ms:.4f} bound_ms="
            f"{rec['fwd']['bound_ms']:.4f}; bwd kernel_ms={bwd_ms:.4f} "
            f"device_ms={bwd_dev_ms:.4f} plain_ms={bwd_plain_ms:.4f} "
            f"first_design_ms(O={FIRST_O})={first_bwd_ms:.4f} "
            f"kernel_plus_wgrad_ms={fused_ms:.4f} "
            f"layer_norm+linear_autograd_ms={dense_bwd_ms:.4f} bound_ms="
            f"{rec['bwd']['bound_ms']:.4f}")
    return rec, line


def sim_cfg(config: str, rate: float = 0.1,
            use_landmarks: bool = True) -> SimMIMConfig:
    """``cli/train_simmim.py``'s defaults on one GPU in one of
    ``SIM_CONFIGS``; ``rate`` for dropout, embedding dropout and drop
    path."""
    gather_impl, mlp_impl, attn_impl = SIM_CONFIGS[config]
    model = PartFViTConfig(with_land=False, loss_type="None", num_classes=0,
                           simmim=True, gather_impl=gather_impl,
                           mlp_impl=mlp_impl, attn_impl=attn_impl,
                           dropout=rate, emb_dropout=rate,
                           drop_path_rate=rate)
    return SimMIMConfig(model=model, input_scale="unit",
                        compute_dtype=torch.bfloat16,
                        moment_dtype=torch.bfloat16,
                        use_landmarks=use_landmarks)


def sim_batch(dev, seed: int) -> torch.Tensor:
    """One SimMIM step's uint8 images, made on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed + 22)
    return torch.randint(0, 256, (SIM_BATCH, 112, 112, 3), generator=gen,
                         device=dev, dtype=torch.uint8)


def phase_simmim(dev, seed: int) -> dict:
    cfg = sim_cfg("kernel")
    state0 = create_simmim_state(cfg, seed, dev)
    land = create_landmark_provider(cfg, seed + 1, dev)
    images = sim_batch(dev, seed)
    n_params = sum(p.numel() for p in state0.params.values())
    steps = 2 + SIM_TIMED
    depth = cfg.model.depth
    want = {"kernel": {"patch_gather": 1, "fused_mlp": depth,
                       "fused_mlp_bwd": depth, "fused_ln_linear": depth,
                       "fused_ln_linear_bwd": depth},
            "jax_cli": {"patch_gather": 1, "fused_ln_mlp": depth,
                        "fused_ln_mlp_bwd": depth},
            "plain": {}}
    keys = ("backbone.mask_token",
            "backbone.transformer.layers.0.0.fn.fn.to_qkv.weight")
    out = dict(state0=state0, land=land, images=images)
    for config in SIM_CONFIGS:
        step = make_simmim_train_step(sim_cfg(config))
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        state = state0
        for _ in range(2):  # warm-up
            state, m = step(state, land, images, **SIM_ARGS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SIM_TIMED):
            state, m = step(state, land, images, **SIM_ARGS)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / SIM_TIMED
        launches = dict(_build.LAUNCHES)
        per_step = {k: v / steps for k, v in launches.items() if v}
        if config == "kernel":
            out["launches"] = launches
        launches_ok = per_step == want[config]
        moved = all(not torch.equal(state.params[k], state0.params[k])
                    for k in keys)
        ok = (np.isfinite(loss) and moved and launches_ok
              and state.step == steps)
        out[config] = dict(step_ms=step_s * 1e3,
                           imgs_per_s=SIM_BATCH / step_s, loss=loss)
        print(f"phase 14 simmim {config} {'/'.join(SIM_CONFIGS[config])}: "
              f"{n_params / 1e6:.1f} M params, "
              f"{SIM_BATCH} images a step, step_ms={step_s * 1e3:.2f} "
              f"imgs_per_s={SIM_BATCH / step_s:.1f} loss_after_{steps}_steps="
              f"{loss:.5f} mask_token_and_weights_moved={moved} peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"launches_per_step={per_step} {'ok' if ok else 'FAIL'}",
              flush=True)
        require(ok, f"SimMIM step checks failed ({config})")
        del state, m
    return out


def phase_simmim_agree(dev, sim: dict) -> None:
    """One step's loss and gradients, each kernel configuration against the
    plain one at every rate 0, from the same state, tokens and mask; then
    one step of the grid variant."""
    state0, land, images = sim["state0"], sim["land"], sim["images"]
    steps = {c: make_simmim_train_step(sim_cfg(c, 0.0)) for c in SIM_CONFIGS}
    s_mask, s_drop = sim_seeds(state0.seed, state0.step)
    tokens, mask = steps["kernel"].tokens_and_mask(land, images, s_mask)
    lp, gp = steps["plain"].loss_and_grads(state0, tokens, mask, s_drop)
    for config in ("kernel", "jax_cli"):
        lk, gk = steps[config].loss_and_grads(state0, tokens, mask, s_drop)
        rel = abs(lk.item() - lp.item()) / abs(lp.item())
        cos = grad_cosines(gk, gp)
        worst = min(cos, key=cos.get)
        ok = rel <= 1e-3 and cos[worst] >= 0.999 and np.isfinite(lk.item())
        print(f"phase 14 simmim {config}-vs-plain at rate 0: loss "
              f"{lk.item():.6f} vs {lp.item():.6f} (rel {rel:.2e}, tol 1e-3);"
              f" gradient cosine min {cos[worst]:.6f} ({worst}) over "
              f"{len(cos)} leaves (tol 0.999) {'ok' if ok else 'FAIL'}",
              flush=True)
        require(ok, f"SimMIM {config} and plain configurations disagree")
        del gk
    del gp
    grid = make_simmim_train_step(sim_cfg("kernel", use_landmarks=False))
    _build.LAUNCHES.clear()
    state, m = grid(state0, land, images, **SIM_ARGS)
    loss = m["loss"].item()
    launches = dict(_build.LAUNCHES)
    ok = (np.isfinite(loss) and launches.get("patch_gather", 0) == 0
          and launches.get("fused_ln_linear", 0) == grid.backbone.cfg.depth)
    print(f"phase 14 simmim grid variant (use_landmarks=False): loss={loss:.5f}"
          f" launches={launches} {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, "SimMIM grid step checks failed")


def phase_simmim_profile(dev, sim: dict, path: str) -> None:
    """One profiled SimMIM step per configuration after a warm-up step:
    device time by kernel (table in DIR) and by kind, busy and idle share
    against the CUDA-event wall time of an unprofiled step, and one step
    timed part by part (tokens and mask, forward and backward, update)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(path, exist_ok=True)
    state0, land, images = sim["state0"], sim["land"], sim["images"]
    for config in SIM_CONFIGS:
        step = make_simmim_train_step(sim_cfg(config))
        state, _ = step(state0, land, images, **SIM_ARGS)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        s_mask, s_drop = sim_seeds(state.seed, state.step)
        ev[0].record()
        tokens, mask = step.tokens_and_mask(land, images, s_mask)
        ev[1].record()
        _, grads = step.loss_and_grads(state, tokens, mask, s_drop)
        ev[2].record()
        step.update(state, grads, **SIM_ARGS)
        ev[3].record()
        torch.cuda.synchronize()
        names = ("tokens_mask", "fwd_bwd", "update")
        parts = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
        del grads
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, land, images, **SIM_ARGS)
        end.record()
        torch.cuda.synchronize()
        wall = start.elapsed_time(end)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, land, images, **SIM_ARGS)
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        with open(os.path.join(path, f"profile_simmim_{config}.txt"), "w") as f:
            f.write(events.table(sort_by="self_device_time_total",
                                 row_limit=120))
        require(busy > 0, f"the profiler saw no device time for SimMIM {config}")
        kinds = " ".join(f"{k}={v:.2f}" for k, v in by_kind(kernels, 1).items())
        part_txt = " ".join(f"{k}={v:.2f}" for k, v in parts.items())
        print(f"phase P profile simmim {config} "
              f"{'/'.join(SIM_CONFIGS[config])}: wall_ms={wall:.3f} "
              f"busy_ms={busy:.3f} idle={1 - busy / wall:.3f}; parts_ms "
              f"{part_txt}; device_ms_by_kind {kinds} -> {path}", flush=True)
        del state


def full_width(gather_impl: str, mlp_impl: str) -> PartFViT:
    return PartFViT(PartFViTConfig(loss_type="None", num_classes=0,
                                   gather_impl=gather_impl, mlp_impl=mlp_impl))


def served_cfg(cfg: PartFViTConfig, config: str) -> PartFViTConfig:
    """The eval loader's ``cfg`` (the kernel configuration), or the plain
    one on the same architecture."""
    return cfg if config == "kernel" else dataclasses.replace(cfg,
                                                              **SERVE_PLAIN)


def build(config: str, state: dict, dev, dtype=torch.bfloat16) -> PartFViT:
    """The served model on ``state`` as the eval loader builds it, or the
    plain one."""
    model = PartFViT(served_cfg(infer_partfvit_config(state), config))
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
    ("kernel 11b flash dK dV", ("flash_bwd_dkv",)),
    ("kernel 11c flash dQ", ("flash_bwd_dq",)),
    ("kernel 11a flash forward", ("flash_fwd_",)),
    ("kernel 7 fused attention backward", ("attn_bwd_",)),
    ("kernel 6 fused attention forward", ("attn_fwd_",)),
    ("kernel 3 fused MLP backward", ("ln_mlp_bwd_",)),
    ("kernel 2 fused MLP forward", ("ln_mlp_fwd_sm90", "ln_mlp_bf16_kernel",
                                    "ln_mlp_f32_kernel")),
    ("kernel 5 fused MLP (no LN) backward", ("mlp_bwd_",)),
    ("kernel 4 fused MLP (no LN) forward", ("mlp_fwd_",)),
    ("kernel 9 LN + linear backward", ("ln_linear_bwd_",)),
    ("kernel 8 LN + linear forward", ("ln_linear_fwd_",)),
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


def ssl_parts_ms(step, state, land, batch, images=None) -> dict:
    """One SSL step timed part by part with CUDA events; with ``images``
    (a raw uint8 batch) the device multi-crop first, as its own part."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    s_land, s_glob, s_loc = step_seeds(state.seed, state.step)
    gen = torch.Generator(device=state.center.device).manual_seed(s_land)
    crop = {}
    if images is not None:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        batch = lafs_multicrop_device(images, torch.Generator(
            device=state.center.device).manual_seed(
                aug_seed(state.seed, state.step)))
        ev[0].record()
        torch.cuda.synchronize()
        crop = {"multicrop": start.elapsed_time(ev[0])}
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
    return {**crop, **{n: ev[i].elapsed_time(ev[i + 1])
                       for i, n in enumerate(names)}}


def phase_ssl_profile(dev, ssl: dict, path: str, flash: bool = False) -> None:
    """Two profiled SSL steps per configuration after a warm-up step: the
    device time by kernel (table in DIR) and by kind, busy and idle share
    against the CUDA-event wall time, and one step timed part by part.
    ``flash``: the configurations of phase 17 on its raw uint8 batch (the
    device multi-crop inside the step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(path, exist_ok=True)
    state0, land, batch = ssl["state0"], ssl["land"], ssl["batch"]
    configs = SSL_FLASH_CONFIGS if flash else CONFIGS
    tag = "ssl_flash" if flash else "ssl"
    for config in configs:
        step = make_ssl_train_step(ssl_flash_cfg(config) if flash
                                   else ssl_cfg(config))
        state, _ = step(state0, land, *batch, **SSL_ARGS)
        parts = (ssl_parts_ms(step, state, land, None, batch[0]) if flash
                 else ssl_parts_ms(step, state, land, batch))
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
        with open(os.path.join(path, f"profile_{tag}_{config}.txt"), "w") as f:
            f.write(events.table(sort_by="self_device_time_total",
                                 row_limit=120))
        require(busy > 0, f"the profiler saw no device time for {tag} {config}")
        kinds = " ".join(f"{k}={v:.2f}" for k, v in by_kind(kernels, 2).items())
        part_txt = " ".join(f"{k}={v:.2f}" for k, v in parts.items())
        print(f"phase P profile {tag} {config}: wall_ms={wall:.3f} "
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


# ------------------------------------------ the SSL CLI slice (15-18) --

def flash_operands(dev, dtype, b: int, h: int, n: int, seed: int):
    """q, k, v as strided views of one ``to_qkv`` output and a dO, as
    :func:`attn_operands` makes them, with the plain forward's O and lse
    (the backward kernels' other inputs)."""
    q, k, v, do = attn_operands(dev, dtype, b, h, n, seed)
    o, lse = flash_attention_plain(q, k, v, ATTN_SCALE)
    return q, k, v, do, o, lse


def flash_bounds(q, k, v, do, o, lse, dtype) -> dict:
    """Bounds of 11a (2 products), 11c (3: s, dp, dQ; reads O and lse,
    writes the statistics scratch) and 11b (4: s, dp, dV, dK; reads the
    scratch) on the real rows, each input read once, each output written
    once."""
    b, h, n, d = q.shape
    mm = 2 * b * h * n * n * d
    scratch = b * h * stats_tiles(n) * 2 * 64 * 4  # bytes
    return {"flash_attention": bound(2 * mm, nbytes(q, k, v, o, lse), dtype),
            "flash_attention_bwd_dkv": bound(
                4 * mm, nbytes(q, k, v, do, k, v) + scratch, dtype),
            "flash_attention_bwd_dq": bound(
                3 * mm, nbytes(q, k, v, o, do, lse, q) + scratch, dtype)}


def device_ms(fn, keys, iters: int = 10, sessions: int = 3) -> dict:
    """Device time of ``fn``'s kernels by the profiler: for each of
    ``keys``, the mean ms of one launch of the kernels whose names hold it
    and how many launches were recorded; and the launches of any other
    kernel (``"other"``). A session that recorded no device event at all
    (seen once on the H100 after many sessions in one process, while the
    kernels' outputs checked out) is taken again, up to ``sessions`` in
    all; an empty last one is returned as it is, and the callers' checks
    fail on its zero counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in kernels):
            break
    out = {}
    for key in keys:
        mine = [e for e in kernels if key in e.key]
        n = sum(e.count for e in mine)
        out[key] = (sum(e.self_device_time_total for e in mine)
                    / max(n, 1) / 1e3, n)
    out["other"] = sum(e.count for e in kernels
                       if not any(key in e.key for key in keys))
    return out


def queued_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn`` by CUDA events, with the host's
    launches queued behind a spin kernel, so that the calls run back to
    back on the card and no host time falls between them."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~30 ms of cycles: the host gets ahead
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stats_err(stats, want, n: int):
    """The larger (max abs, relative) error of the real rows of 11c's
    scratch against the plain twin's, lse·log2 e and di each relative to
    itself, and whether every padded row holds +inf and 0."""
    got, ref = (t.permute(0, 2, 1, 3).flatten(2) for t in (stats, want))
    pad_ok = bool((got[:, 0, n:] == float("inf")).all()
                  and (got[:, 1, n:] == 0).all())
    errs = [rel_err(got[:, i, :n], ref[:, i, :n]) for i in (0, 1)]
    return max(errs, key=lambda e: e[1]), pad_ok


def phase_flash(dev, seed: int) -> dict:
    """Kernels 11a-c against their plain versions at the SSL step's global
    and local shapes and at ``FLASH_EXTRA``'s N, on strided ``to_qkv``
    views, bf16 and fp32: 11c's dQ and statistics scratch, 11b's dK and dV
    on it; SDPA's output held to the same bar. At the step's two shapes in
    bf16: kernel ms by events and by the profiler's device time per
    launch, plain, SDPA forward and autograd backward and bound ms, and
    the whole backward of 11c + 11b beside SDPA's, both by events with the
    launches queued (device time)."""
    out = {}
    shapes = [("global", FLASH_SHAPES["global"]),
              ("local", FLASH_SHAPES["local"])]
    shapes += [(f"N={s[2]}", s) for s in FLASH_EXTRA]
    for i, (name, (b, h, n)) in enumerate(shapes):
        for dtype, tol in ATTN_TOLS:
            ops = flash_operands(dev, dtype, b, h, n, seed + 40 + i)
            q, k, v, do, o_p, lse_p = ops
            o, lse = flash_attention_fwd_cuda(q, k, v, ATTN_SCALE)
            dq, stats = flash_attention_bwd_dq_cuda(q, k, v, o_p, do, lse_p,
                                                    ATTN_SCALE)
            dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, stats,
                                                  ATTN_SCALE)
            want = flash_attention_bwd_plain(q, k, v, o_p, lse_p, do,
                                             ATTN_SCALE)
            _, stats_p = flash_attention_bwd_dq_plain(q, k, v, o_p, do, lse_p,
                                                      ATTN_SCALE)
            sdpa = F.scaled_dot_product_attention(q, k, v, scale=ATTN_SCALE)
            torch.cuda.synchronize()
            got = (o, dq, dk, dv)
            require(all(t.shape == (b, h, n, 64) and t.dtype == dtype
                        and bool(torch.isfinite(t).all()) for t in got),
                    f"flash outputs at {name} in {dtype}")
            st_err, pad_ok = stats_err(stats, stats_p, n)
            errs = {"o": rel_err(o, o_p), "lse": rel_err(lse, lse_p),
                    "stats": st_err,
                    "dq": rel_err(dq, want[0]), "dk": rel_err(dk, want[1]),
                    "dv": rel_err(dv, want[2]), "sdpa": rel_err(sdpa, o_p)}
            ok = (pad_ok and errs["lse"][1] <= 1e-5 and st_err[1] <= 1e-5
                  and all(r <= tol for key, (_, r) in errs.items()
                          if key not in ("lse", "stats")))
            dt = dtype_name(dtype)
            times = ""
            if dtype == torch.bfloat16 and name in FLASH_SHAPES:
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                o_sdpa = F.scaled_dot_product_attention(*leaves,
                                                        scale=ATTN_SCALE)
                sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
                    o_sdpa, leaves, do, retain_graph=True)
                bwd = lambda: flash_attention_bwd_cuda(  # noqa: E731
                    q, k, v, o_p, lse_p, do, ATTN_SCALE)
                dev_ms = device_ms(bwd, ("flash_bwd_dq", "flash_bwd_dkv"))
                # the backward wrapper runs 11c and 11b and nothing else
                require(dev_ms["other"] == 0 and dev_ms["flash_bwd_dq"][1]
                        and dev_ms["flash_bwd_dkv"][1],
                        f"flash_attention_bwd_cuda ran other kernels: "
                        f"{dev_ms}")
                dev_ms.update(device_ms(lambda: flash_attention_fwd_cuda(
                    q, k, v, ATTN_SCALE), ("flash_fwd_",)))
                res = dict(
                    errs=errs,
                    ms={"flash_attention": cuda_ms(
                            lambda: flash_attention_fwd_cuda(q, k, v,
                                                             ATTN_SCALE)),
                        "flash_attention_bwd_dkv": cuda_ms(
                            lambda: flash_attention_bwd_dkv_cuda(
                                q, k, v, do, stats, ATTN_SCALE)),
                        "flash_attention_bwd_dq": cuda_ms(
                            lambda: flash_attention_bwd_dq_cuda(
                                q, k, v, o_p, do, lse_p, ATTN_SCALE))},
                    device_ms={kern: dev_ms[key] for kern, key in zip(
                        FLASH_KERNELS,
                        ("flash_fwd_", "flash_bwd_dkv", "flash_bwd_dq"))},
                    bwd_queued_ms=queued_ms(bwd),
                    plain_fwd_ms=cuda_ms(lambda: flash_attention_plain(
                        q, k, v, ATTN_SCALE), iters=5),
                    plain_bwd_ms=cuda_ms(lambda: flash_attention_bwd_plain(
                        q, k, v, o_p, lse_p, do, ATTN_SCALE), iters=5),
                    sdpa_fwd_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, scale=ATTN_SCALE)),
                    sdpa_bwd_ms=cuda_ms(sdpa_bwd),
                    sdpa_bwd_queued_ms=queued_ms(sdpa_bwd),
                    bounds=flash_bounds(*ops, dtype))
                del o_sdpa, sdpa_bwd, bwd
                out[name] = res
                dv_ = res["device_ms"]
                bwd_sum = (dv_["flash_attention_bwd_dkv"][0]
                           + dv_["flash_attention_bwd_dq"][0])
                times = (" ms (events; device by the profiler, launches "
                         "recorded): " + " ".join(
                    f"{k_}={v_:.4f}; {dv_[k_][0]:.4f} x{dv_[k_][1]} (bound "
                    f"{res['bounds'][k_]['bound_ms']:.4f} "
                    f"{res['bounds'][k_]['bound_by']})"
                    for k_, v_ in res["ms"].items())
                    + f" plain_fwd={res['plain_fwd_ms']:.4f} plain_bwd="
                    f"{res['plain_bwd_ms']:.4f} sdpa_fwd="
                    f"{res['sdpa_fwd_ms']:.4f} sdpa_bwd="
                    f"{res['sdpa_bwd_ms']:.4f}; 11b+11c device "
                    f"{bwd_sum:.4f}, whole backward queued "
                    f"{res['bwd_queued_ms']:.4f} vs SDPA whole backward "
                    f"queued {res['sdpa_bwd_queued_ms']:.4f}")
            print(f"phase 15 flash ({b}, {h}, {n}, 64) {name} {dt}: rel_err "
                  + " ".join(f"{k_}={r:.2e}" for k_, (_, r) in errs.items())
                  + f" padded_stats={'ok' if pad_ok else 'BAD'}"
                  + f" (tol {tol:g}, lse and stats 1e-5){times} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            require(ok, f"kernels 11a-c or SDPA disagree at {name} in {dt}")
    return out


def fixture_batch(dev, n: int):
    """The first ``n`` JPEGs of the fixture, decoded on the card."""
    ds = FaceRecordDataset(os.path.join(FIXTURE, "train.rec"))
    jpegs, _ = ds.fetch_batch(range(n))
    return decode_batch(jpegs, dev, ds.bgr)


def level_diff(got: torch.Tensor, ref: np.ndarray):
    """(mean, max) absolute difference in levels of two uint8 batches."""
    d = np.abs(got.cpu().numpy().astype(np.int32) - ref.astype(np.int32))
    return float(d.mean()), int(d.max())


def prefetch_under_load(ds, ref: torch.Tensor, dev) -> int:
    """Batches the ``Prefetcher`` hands out over 3 epochs while the default
    stream is kept busy (as a training step keeps it) that differ from the
    plain decode ``ref`` of the same records."""
    sampler = EpochSampler(len(ds), SSL_BATCH, seed=0)
    pre = Prefetcher(ds, sampler, dev)
    busy = torch.randn(8192, 8192, device=dev)
    bad = 0
    for epoch in range(3):
        idx = sampler.epoch_indices(epoch)
        for it, (imgs, _) in enumerate(pre.epoch(epoch)):
            for _ in range(2):
                busy = busy @ busy
                busy = busy / busy.norm()
            rows = torch.as_tensor(idx[it * SSL_BATCH:(it + 1) * SSL_BATCH],
                                   device=dev)
            bad += not torch.equal(imgs, ref[rows])
    torch.cuda.synchronize()
    return bad


def phase_decode(dev) -> torch.Tensor:
    """The card's decoder against PIL's decode: the fixture's first 4
    records (4:2:0) and one face each in 4:4:4, 4:2:2 and grayscale, mean
    absolute difference ≤ 1 level; the decoder's build and a batch of 64
    timed. Returns the decoded batch of 32 the SSL phases train on."""
    t0 = time.perf_counter()
    decode_lib()
    built_s = time.perf_counter() - t0
    ref = np.load(os.path.join(FIXTURE, "decoded_ref.npy"))
    got = fixture_batch(dev, 4)
    diffs = {"4:2:0 records": level_diff(got, ref)}
    layouts = np.load(os.path.join(FIXTURE, "layouts_ref.npy"))
    for i, name in enumerate(("444", "422", "gray")):
        with open(os.path.join(FIXTURE, f"layout_{name}.jpg"), "rb") as f:
            one = decode_batch([f.read()], dev)
        diffs[name] = level_diff(one, layouts[i:i + 1])
    ds = FaceRecordDataset(os.path.join(FIXTURE, "train.rec"))
    jpegs, _ = ds.fetch_batch(range(64))
    ms = cuda_ms(lambda: decode_batch(jpegs, dev), iters=5, warmup=1)
    bad = prefetch_under_load(ds, decode_batch(jpegs, dev), dev)
    ok = (got.shape == ref.shape and bad == 0
          and all(m <= 1.0 for m, _ in diffs.values()))
    print(f"phase 16 decode: decoder {DECODER} (libnvjpeg + libjpeg's "
          f"upsampling) built/loaded in {built_s:.1f} s; vs PIL, mean/max abs"
          " diff in levels (tol mean 1): " + "; ".join(
              f"{k} {m:.4f}/{x}" for k, (m, x) in diffs.items())
          + f"; 64 images of 112x112 in {ms:.3f} ms; prefetched batches "
          f"under a busy default stream unlike the plain decode: {bad} of 6 "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, "the card's JPEG decode disagrees with PIL's")
    return fixture_batch(dev, SSL_BATCH)


def ssl_flash_cfg(config: str, rate: float = 0.1) -> SSLConfig:
    """The SSL recipe of phase 8 with attention and the device multi-crop
    of the CLI's ``--attn-impl flash --device-aug``."""
    gather_impl, mlp_impl, attn_impl = SSL_FLASH_CONFIGS[config]
    cfg = ssl_cfg("kernel", rate)
    model = dataclasses.replace(cfg.model, gather_impl=gather_impl,
                                mlp_impl=mlp_impl, attn_impl=attn_impl)
    return dataclasses.replace(cfg, model=model, fused_device_aug=True)


@contextlib.contextmanager
def flash_plain_on_card():
    """Route ``ops.flash_attention`` on CUDA tensors to its plain versions
    (the oracle configuration of the rate-0 comparison)."""
    saved = (flash_ops.flash_attention_fwd_cuda,
             flash_ops.flash_attention_bwd_cuda)
    flash_ops.flash_attention_fwd_cuda = flash_attention_plain
    flash_ops.flash_attention_bwd_cuda = flash_attention_bwd_plain
    try:
        yield
    finally:
        (flash_ops.flash_attention_fwd_cuda,
         flash_ops.flash_attention_bwd_cuda) = saved


def phase_ssl_flash(dev, seed: int, images: torch.Tensor) -> dict:
    """The SSL step as the CLI runs it: the raw uint8 batch of 32 decoded
    images, the device multi-crop inside the step, flash attention."""
    state0 = create_ssl_state(ssl_flash_cfg("kernel"), seed, dev)
    land = create_landmark_provider(ssl_flash_cfg("kernel"), seed + 1, dev)
    out = {}
    for config in SSL_FLASH_CONFIGS:
        step = make_ssl_train_step(ssl_flash_cfg(config))
        state = state0
        for _ in range(2):
            state, m = step(state, land, images, None, None, None, **SSL_ARGS)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        for _ in range(SSL_FLASH_TIMED):
            state, m = step(state, land, images, None, None, None, **SSL_ARGS)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / SSL_FLASH_TIMED
        launches = dict(_build.LAUNCHES)
        per_step = {k: launches.get(k, 0) / SSL_FLASH_TIMED
                    for k in FLASH_KERNELS}
        ok = np.isfinite(loss) and state.step == 2 + SSL_FLASH_TIMED
        if config == "kernel":
            out["launches"] = launches
            ok = ok and per_step == FLASH_PER_STEP
        else:
            ok = ok and not any(launches.values())
        out[config] = dict(step_ms=step_s * 1e3,
                           imgs_per_s=SSL_BATCH / step_s, loss=loss)
        print(f"phase 17 ssl flash+device-aug {config} "
              f"{SSL_FLASH_CONFIGS[config]}: step_ms={step_s * 1e3:.2f} "
              f"imgs_per_s={SSL_BATCH / step_s:.1f} loss_after_"
              f"{2 + SSL_FLASH_TIMED}_steps={loss:.5f} flash launches per step"
              f" {per_step} (want {FLASH_PER_STEP if config == 'kernel' else 0})"
              f" {'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"SSL flash step checks failed ({config})")
        del state, m
    # rate 0, one step from the same state and crops: the kernels against
    # the same configuration with flash attention's plain versions
    cfg0 = ssl_flash_cfg("kernel", 0.0)
    steps = {c: make_ssl_train_step(cfg0) for c in ("kernel", "plain")}
    s_land, s_glob, s_loc = step_seeds(state0.seed, state0.step)
    crops = lafs_multicrop_device(
        images, torch.Generator(device=dev).manual_seed(
            aug_seed(state0.seed, state0.step)),
        local_crops_number=cfg0.local_crops_number,
        out_size=cfg0.model.image_size,
        global_crops_scale=cfg0.global_crops_scale)
    g_in, l_in = steps["kernel"].make_tokens(
        land, *crops, torch.Generator(device=dev).manual_seed(s_land))
    res = {}
    for c, st in steps.items():
        with (flash_plain_on_card() if c == "plain"
              else contextlib.nullcontext()):
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
    print(f"phase 17 ssl flash kernels vs their plain versions at rate 0: "
          f"loss {lk:.6f} vs {lp:.6f} (rel {rel:.2e}, tol 1e-4); gradient "
          f"cosine min {cos[worst]:.6f} ({worst}) over {len(cos)} leaves "
          f"(tol 0.9995) {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, "the flash kernels change the SSL step")
    out.update(state0=state0, land=land, batch=(images, None, None, None))
    return out


def cli_cmd(out: str, seed: int):
    """The port's SSL CLI at full width on the fixture (--warmup-epochs 1:
    the preset's 10 warm-up epochs do not fit in 2)."""
    return [sys.executable, "-u", "-m", "lafs_cvpr2024_tpu_torch.cli.train_ssl",
            "--config", "configs/ssl_ms1m.toml", "--attn-impl", "flash",
            "--data-path", FIXTURE, "--output-dir", out,
            "--batch-size-per-chip", str(SSL_BATCH), "--random-subset", "1.0",
            "--epochs", "2", "--warmup-epochs", "1", "--saveckp-steps", "3",
            "--seed", str(seed)]


def start_cli(out: str, seed: int) -> subprocess.Popen:
    return subprocess.Popen(cli_cmd(out, seed), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_cli(proc: subprocess.Popen, sigterm_at_start: bool = False) -> str:
    """Wait for a CLI run (after a SIGTERM right when it starts training,
    if asked); its stdout. The process never outlives the call."""
    try:
        head = []
        if sigterm_at_start:
            for line in proc.stdout:
                head.append(line)
                if line.startswith("[train_ssl] start:"):
                    proc.send_signal(signal.SIGTERM)  # during the first step
                    break
        rest, err = proc.communicate(timeout=CLI_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(head) + rest
    require(proc.returncode == 0,
            f"the SSL CLI failed ({proc.returncode}):\n{text[-2000:]}\n"
            f"{err[-3000:]}")
    return text


def final_state(out: str) -> dict:
    ck = TrainingCheckpointer(os.path.join(out, "ckpt"))
    payload, step = ck.restore("cpu")
    require(step == 4, f"{out}: the last checkpoint is step {step}, not 4")
    return payload


def phase_cli(seed: int) -> dict:
    """``python -m lafs_cvpr2024_tpu_torch.cli.train_ssl`` at full width on
    the fixture: 2 epochs straight; then a run stopped by SIGTERM in its
    first step and run again, which must end with the straight run's state
    (≤ 1e-6 relative per tensor)."""
    torch.cuda.empty_cache()
    base = os.path.join(WORK, "cli")
    shutil.rmtree(base, ignore_errors=True)
    straight, preempted = (os.path.join(base, s) for s in ("a", "b"))
    # the straight run beside the stopped-and-resumed one, on the same card
    t0 = time.perf_counter()
    runs = [start_cli(straight, seed), start_cli(preempted, seed)]
    try:
        stopped = finish_cli(runs[1], sigterm_at_start=True)
        resumed = finish_cli(start_cli(preempted, seed))
        text = finish_cli(runs[0])
    finally:
        for proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    both_s = time.perf_counter() - t0
    rates = [float(x.split("imgs_per_s=")[1].split()[0])
             for x in text.splitlines() if "imgs_per_s=" in x]
    with open(os.path.join(straight, "log.txt")) as f:
        log = [json.loads(line) for line in f if line.strip()]
    logged = [r["train_loss"] for r in log]
    want, got = final_state(straight), final_state(preempted)
    pairs = [(f"{tree}.{k}", w, got[tree][k])
             for tree in ("student", "teacher", "opt_mu", "opt_nu")
             for k, w in want[tree].items()]
    pairs.append(("center", want["center"], got["center"]))
    worst, worst_key = max((rel_err(g, w)[1], name) for name, w, g in pairs)
    ok = (len(logged) == 2 and all(np.isfinite(logged)) and len(rates) == 2
          and "[preempt] SIGTERM: saved step" in stopped
          and "[resume] step" in resumed and worst <= 1e-6)
    stop_line = next((x for x in stopped.splitlines() if "[preempt]" in x), "")
    print(f"phase 18 cli train_ssl --config configs/ssl_ms1m.toml --attn-impl "
          f"flash, 2 epochs of 2 steps of {SSL_BATCH}, the straight run "
          f"beside the stopped and resumed one: {both_s:.1f} s; straight "
          f"log.txt losses {logged}, imgs_per_s {rates}; stopped: "
          f"{stop_line.strip()!r}; resumed to step 4: max rel diff to the "
          f"straight run {worst:.2e} ({worst_key}, tol 1e-6) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, "the SSL CLI run, its log or its exact resume failed")
    shutil.rmtree(base, ignore_errors=True)  # ~1 GB a checkpoint
    return dict(imgs_per_s=rates, losses=logged, seconds=both_s)


# ---------------------------------- row 10 and the evaluation CLIs (19-20) --

def mlp10_operands(dev, t: int, seed: int):
    """x (t, 768) and the microbenchmark's weights (N(0, 1) · 0.02, the
    JAX layout), bf16."""
    rng = np.random.default_rng(seed + 19)
    w1, w2 = mlp_fusion_weights_from_jax(
        rng.standard_normal((768, 2048)) * 0.02,
        rng.standard_normal((2048, 768)) * 0.02, dev)
    x = np.random.default_rng(seed + t).standard_normal((t, 768))
    return torch.from_numpy(x.astype(np.float32)).to(dev, torch.bfloat16), w1, w2


def mlp10_bench(x, w1, w2) -> dict:
    """The microbenchmark's ``main`` on the port: per rate, one call, then
    ``MLP10_ITERS`` calls each fed the last one's output (``time_fn``);
    ms per call by CUDA events."""
    out = {}
    for rate in (0.0, 0.1):
        y = mlp_fusion(x, w1, w2, rate, DROP_SEED)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(MLP10_ITERS):
            y = mlp_fusion(y, w1, w2, rate, DROP_SEED)
        end.record()
        torch.cuda.synchronize()
        require(bool(torch.isfinite(y).all()), "row 10's chained output")
        out[rate] = start.elapsed_time(end) / MLP10_ITERS
    return out


def mlp10_masks(dev, t: int):
    """Both dropout masks of the kernel against the plain version's, bit
    for bit: x = 1 and W1 = 1/16 make every hidden value GELU(48) = 48,
    and a one-hot W2 routes hidden unit off + c to output column c, so
    each output element is one hidden element, kept and scaled or dropped,
    with no rounding between the two versions (the hidden mask is seen
    wherever the output draw keeps; three offsets cover the 2,048 units).
    Returns (equal, the kernel's hidden keep fraction where seen)."""
    x = torch.ones(t, 768, device=dev, dtype=torch.bfloat16)
    w1 = torch.full((768, 2048), 1 / 16, device=dev, dtype=torch.bfloat16)
    cols = torch.arange(768, device=dev)
    keep_y = dropout_bits(t, 768, DROP_SEED, 1, MLP10_TILE, dev) \
        < keep_threshold(0.1)
    equal, kept, seen = True, 0, 0
    for off in (0, 768, 1280):
        w2 = torch.zeros(2048, 768, device=dev, dtype=torch.bfloat16)
        w2[cols + off, cols] = 1.0
        got = mlp_fusion_cuda(x, w1, w2, rate=0.1, seed=DROP_SEED)
        want = mlp_fusion_plain(x, w1, w2, rate=0.1, seed=DROP_SEED)
        equal = equal and torch.equal(got, want)
        kept += int((got != 0).sum())
        seen += int(keep_y.sum())
    return equal, kept / seen


def phase_mlp_fusion(dev, seed: int) -> dict:
    """Row 10: the microbenchmark's path (launches counted), then the
    kernel against its plain version at each of ``MLP10_T``."""
    t0 = time.perf_counter()
    x, w1, w2 = mlp10_operands(dev, MLP10_T[0], seed)
    _build.LAUNCHES.clear()
    bench_ms = mlp10_bench(x, w1, w2)
    launches = dict(_build.LAUNCHES)
    require(launches.get("mlp_fusion", 0) == 2 * (1 + MLP10_ITERS),
            f"row 10's path launched {launches}")
    print(f"phase 19 mlp_fusion path: benchmarks/bench_mlp_fusion.py main at "
          f"T={MLP10_T[0]}, {MLP10_ITERS} chained calls: pallas_nodrop "
          f"{bench_ms[0.0]:.4f} ms, pallas_drop {bench_ms[0.1]:.4f} ms per "
          f"call; launches {launches} ok", flush=True)
    out = {"launches": launches, "bench_ms": bench_ms}
    for t in MLP10_T:
        x, w1, w2 = mlp10_operands(dev, t, seed)
        res = {}
        for rate in (0.0, 0.1):
            kw = dict(rate=rate, seed=DROP_SEED)
            got = mlp_fusion_cuda(x, w1, w2, **kw)
            want = mlp_fusion_plain(x, w1, w2, **kw)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            res[rate] = dict(
                err=err, rel=rel, zeros=torch.equal(got == 0, want == 0),
                keep=(got != 0).float().mean().item(),
                finite=bool(torch.isfinite(got).all()),
                ms=cuda_ms(lambda: mlp_fusion_cuda(x, w1, w2, **kw), iters=10),
                plain_ms=cuda_ms(lambda: mlp_fusion_plain(x, w1, w2, **kw),
                                 iters=3, warmup=1))
        equal, keep_h = mlp10_masks(dev, t)
        with torch.no_grad():
            dense_ms = cuda_ms(lambda: mlp_fusion_dense(x, w1, w2), iters=10)
        keep_y = res[0.1]["keep"]
        # the keep fractions' bar needs enough draws: 0.002 is 3 sigma at
        # T = 300 (230,400 outputs), 0.011 is one at T = 1
        keep_ok = t < MLP10_KEEP_T or (abs(keep_h - 0.9) <= 0.002
                                       and abs(keep_y - 0.9) <= 0.002)
        ok = (all(r["rel"] <= 2e-2 and r["zeros"] and r["finite"]
                  for r in res.values()) and equal and keep_ok)
        b = bound(4 * t * 768 * 2048, nbytes(x, w1, w2, x))
        print(f"phase 19 mlp_fusion T={t} bf16: rate 0 rel_err="
              f"{res[0.0]['rel']:.3e}, rate 0.1 rel_err={res[0.1]['rel']:.3e}"
              f" (tol 2e-2), output zeros as plain {res[0.1]['zeros']}, "
              f"masks bit-identical {equal}, keep fraction hidden "
              f"{keep_h:.5f} output {keep_y:.5f} (tol 0.9 +- 0.002 at T >= "
              f"{MLP10_KEEP_T}); "
              f"kernel_ms={res[0.0]['ms']:.4f} (rate 0.1 "
              f"{res[0.1]['ms']:.4f}) plain_ms={res[0.0]['plain_ms']:.4f} "
              f"(rate 0.1 {res[0.1]['plain_ms']:.4f}) dense_ms={dense_ms:.4f}"
              f" bound_ms={b['bound_ms']:.4f} ({b['bound_by']}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"the row-10 kernel disagrees at T={t}")
        out[t] = dict(max_abs_err=max(r["err"] for r in res.values()),
                      ms=res[0.0]["ms"], ms_drop=res[0.1]["ms"],
                      plain_ms=res[0.0]["plain_ms"], library_ms=dense_ms, **b)
    print(f"phase 19 took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def eval_model(loaded, config: str, dev) -> PartFViT:
    """A fresh copy on ``dev`` of the model the eval CLIs load from phase
    5's ``.pth`` (``loaded``, on the CPU): the kernel configuration, or
    the plain one (``gather``, ``dense``, ``einsum``)."""
    model = PartFViT(served_cfg(loaded.cfg, config))
    model.load_state_dict(loaded.model.state_dict(), strict=True)
    return model.eval().to(dev)


def make_pairs_bin(path: str) -> None:
    """A verification ``.bin`` of 32 pairs of the fixture's faces (8
    identities of 8): even pairs within an identity, odd ones across two."""
    ds = FaceRecordDataset(os.path.join(FIXTURE, "train.rec"))
    jpegs, labels = ds.fetch_batch(range(64))
    bins, issame = [], []
    for k in range(32):
        a, b = 2 * k, (2 * k + 1 if k % 2 == 0 else (2 * k + 9) % 64)
        bins += [jpegs[a], jpegs[b]]
        issame.append(bool(labels[a] == labels[b]))
    with open(path, "wb") as f:
        pickle.dump((bins, issame), f)


def eval_cmds(pth: str, out: str) -> dict:
    """The three eval CLIs at their defaults on the fixtures."""

    def cli(name, *args):
        return [sys.executable, "-u", "-m",
                f"lafs_cvpr2024_tpu_torch.cli.{name}", *args]

    return {
        "extract": cli("extract_embeddings", "--checkpoint", pth, "--input",
                       FIXTURE, "--output", os.path.join(out, "extract")),
        "bin": cli("evaluate_bin", "--checkpoint", pth, "--eval-path", out,
                   "--targets", "pairs", "--json",
                   os.path.join(out, "bin.json")),
        "ijb": cli("evaluate_ijb", "--model-checkpoint", pth, "--image-path",
                   os.path.join(IJB_MINI, "loose_crop"), "--meta-path",
                   os.path.join(IJB_MINI, "meta")),
    }


def cli_launches(text: str) -> dict:
    lines = [x for x in text.splitlines() if x.startswith("[kernels] ")]
    require(len(lines) == 1, "an eval CLI printed no launch counts")
    return json.loads(lines[0].split("launches ", 1)[1])


def phase_eval(dev, pth: str) -> dict:
    """The evaluation path at full width: the three CLIs in subprocesses,
    beside each other, while this process computes their references."""
    out = os.path.join(WORK, "eval")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    make_pairs_bin(os.path.join(out, "pairs.bin"))
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, cmd in eval_cmds(pth, out).items()}
    try:
        loaded = load_eval_model(pth, device="cpu", log=lambda _: None)
        images = fixture_batch(dev, 64)
        plain = make_model_embed(eval_model(loaded, "plain", dev), "half",
                                 torch.bfloat16)
        e = plain(torch.cat([images, images.flip(2)])).cpu().numpy()
        want = e[:64] + e[64:]  # flip fusion by addition, then L2 norm
        want /= np.linalg.norm(want, axis=1, keepdims=True)
        data, issame = load_bin(os.path.join(out, "pairs.bin"), device=dev)
        val = perform_val(make_model_embed(eval_model(loaded, "kernel", dev),
                                           "half", torch.float32),
                          data, issame, device_scale=True)
        names, lms, _ = load_image_list(os.path.join(IJB_MINI, "meta"), "IJBC")
        ref = np.load(os.path.join(IJB_MINI, "aligned_ref.npz"))["aligned"]
        jpegs = []
        for name in names[: len(ref)]:
            with open(os.path.join(IJB_MINI, "loose_crop", name), "rb") as f:
                jpegs.append(f.read())
        mats = np.stack([umeyama(lm, ARCFACE_SRC)[:2] for lm in lms[: len(ref)]])
        warp_diff = level_diff(decode_warp_batch(jpegs, mats, dev), ref)
        texts = {}
        for k, proc in procs.items():
            stdout, err = proc.communicate(timeout=CLI_TIMEOUT_S)
            require(proc.returncode == 0, f"the {k} CLI failed "
                    f"({proc.returncode}):\n{stdout[-2000:]}\n{err[-3000:]}")
            texts[k] = stdout
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cli_s = time.perf_counter() - t0
    launches = {k: cli_launches(t) for k, t in texts.items()}
    got = np.load(os.path.join(out, "extract", "embeddings.npy"))
    with open(os.path.join(out, "extract", "names.json")) as f:
        names_ok = json.load(f) == [str(i) for i in range(64)]
    cos = (got * want).sum(1)
    with open(os.path.join(out, "bin.json")) as f:
        acc = json.load(f)["pairs"]["accuracy"]
    table = [float(x.split("TPR=")[1].rstrip("%"))
             for x in texts["ijb"].splitlines() if "TPR=" in x]
    # faces/s of both configurations, batches of 256 faces with their flips
    batch = images.repeat(EVAL_BATCH // 64, 1, 1, 1)
    both = torch.cat([batch, batch.flip(2)])
    rates = {}
    for config in ("kernel", "plain"):
        embed = make_model_embed(eval_model(loaded, config, dev), "half",
                                 torch.bfloat16)
        rates[config] = EVAL_BATCH / cuda_ms(lambda: embed(both), iters=5,
                                             warmup=2) * 1e3
    ok = (got.shape == want.shape and got.shape[0] == 64 and names_ok and cos.min() >= 1 - 1e-3
          and launches["extract"].get("patch_gather", 0) > 0
          and launches["extract"].get("fused_ln_mlp", 0) > 0
          and launches["extract"].get("fused_attention", 0) > 0
          and np.isfinite(acc) and acc == val.accuracy
          and len(table) == 6 and np.isfinite(table).all()
          and warp_diff[0] <= 1.0)
    print(f"phase 20 eval CLIs at full width ({cli_s:.1f} s, side by side): "
          f"extract_embeddings 64 records bf16 cosine vs plain configuration "
          f"min {cos.min():.6f} (tol 1 - 1e-3), launches {launches['extract']}"
          f"; evaluate_bin fp32 accuracy {acc:.5f} vs perform_val in process "
          f"{val.accuracy:.5f}; evaluate_ijb TPR@FPR {table} (%), decode+warp"
          f" vs numpy norm_crop of PIL mean/max {warp_diff[0]:.4f}/"
          f"{warp_diff[1]} levels (tol mean 1); faces_per_s batch "
          f"{EVAL_BATCH} flip on: kernel {rates['kernel']:.1f} plain "
          f"{rates['plain']:.1f}; phase {time.perf_counter() - t0:.1f} s "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, "the evaluation path failed its checks")
    return dict(launches=launches["extract"], faces_per_s=rates)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="also profile both configurations (serving, SSL, "
                        "supervised and SimMIM) into DIR")
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
    ptxas = ptxas_report()
    spills = {k: v for k, v in ptxas.items()
              if v.get("spill_stores", 1) or v.get("spill_loads", 1)}
    serial = serialised_wgmma()
    ok = (not spills and not serial
          and all(any(name in k for k in ptxas) for name in SM90_KERNELS))
    print(f"phase 1 ptxas (registers, static smem bytes, spill store/load "
          f"bytes) of the Hopper kernels: {json.dumps(ptxas)}; C7520 "
          f"(serialised wgmma): {serial or 'none'} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"a Hopper kernel spills, serialises its wgmmas or is "
                f"missing: {ptxas} {serial}")
    lib = _build.library()
    clusters = {n: lib.lafs_max_active_clusters(n, 384, LN_MLP_SMEM)
                for n in (2, 4)}
    print(f"phase 1 clusters of 2 and 4 CTAs of 384 threads and "
          f"{LN_MLP_SMEM} bytes of shared memory (kernels 2-4 and row 10) "
          f"the card co-schedules: {clusters}", flush=True)
    require(all(v > 0 for v in clusters.values()),
            f"cluster occupancy query failed: {clusters}")

    gather = phase_gather(dev, args.seed)
    served_mlp = phase_mlp(dev, args.seed)
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
    sup_launches = sup["launches"]
    del sup
    mlp_nol = phase_mlp_nol(dev, args.seed)
    ln_linear = phase_ln_linear(dev, args.seed)
    sim = phase_simmim(dev, args.seed)
    phase_simmim_agree(dev, sim)
    if args.profile:
        phase_simmim_profile(dev, sim, args.profile)
    sim = {"launches": sim["launches"]}  # frees the SimMIM state
    flash = phase_flash(dev, args.seed)
    images = phase_decode(dev)
    ssl_flash = phase_ssl_flash(dev, args.seed, images)
    if args.profile:
        phase_ssl_profile(dev, ssl_flash, args.profile, flash=True)
    ssl_flash = {"launches": ssl_flash["launches"]}
    del images
    phase_cli(args.seed)
    mlp10 = phase_mlp_fusion(dev, args.seed)
    evaluation = phase_eval(dev, os.path.join(WORK, "partfvit_b.pth"))

    # each kernel's numbers at its main-path shape in bf16: the gather at the
    # served batch, kernel 2 with dropout and u at the SSL global crops' T,
    # kernel 3 at rate 0.1 there, kernels 6 and 7 at one attention call of
    # the supervised step, kernels 4, 5, 8 and 9 at the SimMIM step's T
    # (rate 0.1 for 4 and 5), row 10 at the row's T = 22,080 at rate 0 (its
    # yardstick's rate); launches counted on the last path that runs each
    # kernel: the SimMIM steps, else the supervised ones, else the SSL CLI
    # step, else row 10's microbenchmark path
    flash_g = flash["global"]
    measured_flash = {
        name: dict(max_abs_err=max(flash_g["errs"][k][0] for k in keys),
                   ms=flash_g["ms"][name],
                   plain_ms=flash_g["plain_fwd_ms" if name == FLASH_KERNELS[0]
                                    else "plain_bwd_ms"],
                   library_ms=flash_g["sdpa_fwd_ms" if name == FLASH_KERNELS[0]
                                      else "sdpa_bwd_ms"],
                   **flash_g["bounds"][name])
        for name, keys in zip(FLASH_KERNELS, (("o",), ("dk", "dv"), ("dq",)))}
    measured = {"patch_gather": gather["bfloat16"],
                "fused_ln_mlp": train_fwd[("global", "bfloat16")],
                "fused_ln_mlp_bwd": train_bwd[("global", "bfloat16", 0.1)],
                "fused_attention": attn["bfloat16"],
                "fused_attention_bwd": attn_bwd["bfloat16"],
                "fused_mlp": mlp_nol["bfloat16"]["fwd"],
                "fused_mlp_bwd": mlp_nol["bfloat16"]["bwd"],
                "fused_ln_linear": ln_linear["bfloat16"]["fwd"],
                "fused_ln_linear_bwd": ln_linear["bfloat16"]["bwd"],
                **measured_flash,
                "mlp_fusion": mlp10[22080]}
    paths = {"serve": served, "ssl": ssl_launches,
             "supervised": sup_launches, "simmim": sim["launches"],
             "ssl_flash": ssl_flash["launches"],
             "mlp_fusion_bench": mlp10["launches"],
             "eval": evaluation["launches"]}
    # kernels 2-5, 8 and 9 also carry their yardsticks (the dense block;
    # a backward kernel plus the products around it beside the dense
    # autograd backward, the like-for-like pair), their device time, 4, 5,
    # 8 and 9 the first design's time at the nearest width it takes, and
    # kernels 2 and 6 their served shapes
    bwd = measured["fused_ln_mlp_bwd"]
    yardsticks = {
        "fused_attention": dict(served={
            k: attn["served"]["bfloat16"][k]
            for k in ("ms", "rel_err", "plain_ms", "einsum_ms", "library_ms",
                      "bound_ms", "bound_by")}),
        "fused_ln_mlp": dict(
            device_ms=measured["fused_ln_mlp"]["device_ms"],
            dense_ms=measured["fused_ln_mlp"]["dense_ms"],
            served={k: served_mlp["bfloat16"][k]
                    for k in ("ms", "device_ms", "dense_ms", "plain_ms",
                              "bound_ms", "bound_by")}),
        "fused_ln_mlp_bwd": dict(
            device_ms=bwd["device_ms"], kernel_plus_wgrad_ms=bwd["fused_ms"],
            dense_autograd_ms=bwd["dense_ms"]),
        "fused_mlp": {k: mlp_nol["bfloat16"]["fwd"][k] for k in (
            "device_ms", "first_design_ms", "first_design_h", "dense_ms")},
        "fused_mlp_bwd": dict(
            **{k: mlp_nol["bfloat16"]["bwd"][k] for k in (
                "device_ms", "first_design_ms", "first_design_h",
                "kernel_plus_wgrad_ms")},
            dense_autograd_ms=mlp_nol["bfloat16"]["bwd"]["dense_ms"]),
        "fused_ln_linear": {k: ln_linear["bfloat16"]["fwd"][k] for k in (
            "device_ms", "first_design_ms", "dense_ms")},
        "fused_ln_linear_bwd": {k: ln_linear["bfloat16"]["bwd"][k] for k in (
            "device_ms", "first_design_ms", "kernel_plus_wgrad_ms",
            "dense_ms")}}
    record = {"kernels": [
        dict(name=name, route="cuda", **KERNELS[name],
             launches=(sim["launches"].get(name)
                       or sup_launches.get(name)
                       or ssl_flash["launches"].get(name)
                       or mlp10["launches"].get(name, 0)),
             launches_by_path={p: n.get(name, 0) for p, n in paths.items()},
             max_abs_err=res["max_abs_err"], ms=res["ms"],
             plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
             bound_by=res["bound_by"], library_ms=res["library_ms"],
             **yardsticks.get(name, {}))
        for name, res in measured.items()
    ]}
    missing = [r["name"] for r in record["kernels"] if not r["launches"]]
    require(not missing, f"no path launched {missing}")
    print(json.dumps(record))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
