"""LAFS SSL pretraining CLI on one GPU (counterpart of
``lafs_cvpr2024_tpu/cli/train_ssl.py``: the same flags and TOML presets).

Example:
  python -m lafs_cvpr2024_tpu_torch.cli.train_ssl \\
      --config configs/ssl_ms1m.toml --attn-impl flash \\
      --data-path /data/ms1m --landmark-path /ckpt/landmark.pth \\
      --output-dir /out/ssl

It reads ``train.rec``, draws each epoch's batches as the JAX sampler
does, decodes each batch on the card (nvJPEG, a step ahead on a side
stream), runs the 2 + L crop LAFS multi-crop inside the SSL step
(``--device-aug``), trains, writes ``config.txt`` and the per-epoch
``log.txt``, checkpoints at ``--saveckp-steps``, at each epoch's end and on
SIGTERM under ``<output-dir>/ckpt``, and resumes exactly from the latest
checkpoint when run again. It runs on the card unless ``--device cpu``
(the tests) and raises without CUDA. ``--profile-steps N`` runs the run's
steps 3 to N + 2 under ``torch.profiler`` with the program's spans on
(``utils/tracing.py``) and writes both, on one timeline, as a Chrome trace
to ``<output-dir>/profile/``.

Not ported yet, and raising ``NotImplementedError`` (ROADMAP.md, Open
items): the host PIL multi-crop (running without ``--device-aug``, 1.8),
the vanilla, overlap and mobile_dino archs (1.13), more than one GPU
(``--slices``, 1.7), ``--zero1``, ``--optimizer sgd|lars``, a bf16 teacher
and ``--glo-diff`` (1.13), ``--random-coor`` (1.4), ``--use-bn-in-head``
(1.5) and orbax ``--landmark-path`` directories (1.12).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..utils import tracing


def get_args(argv=None):
    p = argparse.ArgumentParser("lafs SSL pretrain (PyTorch, one GPU)")
    p.add_argument("--arch", default="partfvit",
                   choices=["partfvit", "vit_tiny", "vit_small", "vit_base",
                            "overlap", "mobile_dino"],
                   help="SSL backbone; the port trains 'partfvit' (the LAFS "
                        "landmark-token path)")
    p.add_argument("--local-crop-size", type=int, default=48,
                   help="vanilla-arch local crop resolution "
                        "(lafs_train.py:775)")
    p.add_argument("--data-path", required=True, help="dir with train.rec")
    p.add_argument("--landmark-path", default=None,
                   help="pretrained landmark CNN (reference-dialect .pth)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--batch-size-per-chip", type=int, default=82)
    p.add_argument("--epochs", type=int, default=41)
    p.add_argument("--warmup-epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--min-lr", type=float, default=1e-6)
    p.add_argument("--weight-decay", type=float, default=0.04)
    p.add_argument("--weight-decay-end", type=float, default=0.4)
    p.add_argument("--momentum-teacher", type=float, default=0.996)
    p.add_argument("--warmup-teacher-temp", type=float, default=0.07)
    p.add_argument("--teacher-temp", type=float, default=0.04)
    p.add_argument("--warmup-teacher-temp-epochs", type=int, default=30)
    p.add_argument("--out-dim", type=int, default=100000)
    p.add_argument("--local-crops-number", type=int, default=8)
    p.add_argument("--global-crops-scale", type=float, nargs=2,
                   default=(0.4, 1.0))
    p.add_argument("--local-crops-scale", type=float, nargs=2,
                   default=(0.05, 0.4))
    p.add_argument("--clip-grad", type=float, default=3.0)
    p.add_argument("--freeze-last-layer", type=int, default=1,
                   help="epochs to freeze the DINO head's last layer")
    p.add_argument("--landmark-jitter-std", type=float, default=5.0,
                   help="N(0, std^2) px jitter on predicted landmarks")
    p.add_argument("--local-keep-landmarks", type=int, default=36,
                   help="landmarks kept per local crop (ran_sample)")
    p.add_argument("--glo-diff", action="store_true",
                   help="differentiated global-crop landmarks (not ported)")
    p.add_argument("--random-coor", action="store_true",
                   help="uniform-random landmark coordinates (not ported)")
    p.add_argument("--head-hidden-dim", type=int, default=2048)
    p.add_argument("--head-bottleneck-dim", type=int, default=256)
    p.add_argument("--use-bn-in-head", action="store_true",
                   help="BatchNorm in the DINO head (not ported)")
    p.add_argument("--no-norm-last-layer", dest="norm_last_layer",
                   action="store_false", default=True,
                   help="train the weight-norm g of the head's last layer")
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--heads", type=int, default=11)
    p.add_argument("--dim-head", type=int, default=64)
    p.add_argument("--moment-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="AdamW moment storage dtype (the math is fp32)")
    p.add_argument("--teacher-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="EMA teacher storage dtype (bf16 not ported)")
    p.add_argument("--mlp-dim", type=int, default=2048)
    p.add_argument("--num-patches", type=int, default=196)
    p.add_argument("--patch-size", type=int, default=8,
                   help="landmark patch size in px")
    p.add_argument("--drop-path-rate", type=float, default=0.1)
    p.add_argument("--image-size", type=int, default=112)
    p.add_argument("--stn-mode", default="large", choices=["large", "small"])
    p.add_argument("--random-subset", type=float, default=0.4,
                   help="'sifenzhiyi' random subset fraction")
    p.add_argument("--saveckp-freq", type=int, default=10,
                   help="keep every N-th epoch's checkpoint for good")
    p.add_argument("--saveckp-steps", type=int, default=0,
                   help="also checkpoint every N global steps (0 = per-epoch "
                        "only); resume is exact mid-epoch")
    p.add_argument("--workers", type=int, default=8,
                   help="accepted for preset parity: records are read by one "
                        "thread and decoded on the card")
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "sgd", "lars"])
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1 optimizer-state sharding (not ported)")
    p.add_argument("--slices", type=int, default=None,
                   help="multi-slice topology (not ported: one GPU)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--attn-impl", default="einsum",
                   choices=["einsum", "fused", "flash"],
                   help="attention: einsum (cuBLAS), fused (kernels 6-7, "
                        "128-512 tokens), flash (kernels 11a-c, any length)")
    p.add_argument("--mlp-impl", default="auto",
                   choices=["auto", "dense", "fused", "fused_ln"],
                   help="transformer MLP (auto: fused_ln on the card, dense "
                        "on the CPU)")
    p.add_argument("--device-aug", action="store_true",
                   help="run the 20-crop LAFS augmentation on the card (the "
                        "port's only input path)")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="trace N steps (from the run's third) with "
                        "torch.profiler and the program's spans into "
                        "<output-dir>/profile as a Chrome trace")
    p.add_argument("--device", default="cuda",
                   help="where to train; 'cpu' only for tests")
    from ..utils.config import apply_toml_defaults

    return apply_toml_defaults(p, argv, table="ssl")


def check_ported(args) -> None:
    """Raise for every option of the CLI itself that the port does not
    carry yet; the step's own options are checked by
    ``train.ssl.check_supported``."""
    unported = [
        (not args.device_aug,
         "running without --device-aug (the host PIL multi-crop)", "1.8"),
        (args.slices is not None, "--slices (more than one GPU)", "1.7"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(
                f"the port's SSL CLI does not carry {what} yet (ROADMAP.md, "
                f"Open items {item})")
    if tuple(args.local_crops_scale) != (0.05, 0.4):
        # as the JAX CLI: LAFS draws local crops from the GLOBAL scale
        raise SystemExit(
            "--local-crops-scale has no effect in the LAFS recipe (local "
            "crops draw the GLOBAL scale, lafs_train.py:852-858); set "
            "--global-crops-scale instead")


def build_config(args, device):
    from ..models.partfvit import PartFViTConfig
    from ..train.ssl import SSLConfig
    from ..utils.config import resolve_mlp_impl

    return SSLConfig(
        model=PartFViTConfig(
            dim=args.dim, depth=args.depth, heads=args.heads,
            dim_head=args.dim_head, mlp_dim=args.mlp_dim,
            num_patches=args.num_patches, with_land=False, loss_type="None",
            num_classes=0, image_size=args.image_size,
            stn_mode=args.stn_mode, patch_size=args.patch_size,
            drop_path_rate=args.drop_path_rate,
            mlp_impl=resolve_mlp_impl(args.mlp_impl, device),
            attn_impl=args.attn_impl),
        arch=args.arch, local_crop_size=args.local_crop_size,
        out_dim=args.out_dim,
        head_hidden_dim=args.head_hidden_dim,
        head_bottleneck_dim=args.head_bottleneck_dim,
        use_bn_in_head=args.use_bn_in_head,
        norm_last_layer=args.norm_last_layer,
        local_crops_number=args.local_crops_number,
        local_keep_landmarks=args.local_keep_landmarks,
        landmark_jitter_std=args.landmark_jitter_std,
        glo_diff=args.glo_diff, random_coor=args.random_coor,
        global_crops_scale=tuple(args.global_crops_scale),
        local_crops_scale=tuple(args.local_crops_scale),
        clip_grad=args.clip_grad,
        freeze_last_layer_epochs=args.freeze_last_layer,
        fused_device_aug=True,
        moment_dtype=(torch.bfloat16 if args.moment_dtype == "bfloat16"
                      else torch.float32),
        teacher_dtype=(torch.bfloat16 if args.teacher_dtype == "bfloat16"
                       else torch.float32),
        optimizer=args.optimizer, zero1=args.zero1)


class ProfileWindow:
    """``--profile-steps``: ``torch.profiler`` over ``steps`` steps from the
    run's third (the first two build and warm up), with the program's spans
    on; :meth:`close` writes one Chrome trace of both into ``out_dir``."""

    def __init__(self, out_dir: str, steps: int, device):
        self.dir, self.steps, self.device = out_dir, steps, device
        self.prof = None

    def before_step(self, ran: int, gstep: int) -> None:
        """Called before each step; ``ran`` steps of this run came before."""
        if ran == 2:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.first, self.was_on = gstep, tracing.ON
            tracing.enable(True)
            tracing.reset()
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        elif ran == 2 + self.steps:
            self.close()

    def close(self) -> None:
        """Stop the profiler, if it runs, and write the trace."""
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        record = tracing.export()
        tracing.enable(self.was_on)
        last = max((s["ids"]["step"] for s in record["spans"]
                    if s["name"] == "ssl.step"), default=self.first)
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"ssl_steps_{self.first}-{last}.json")
        tracing.write_chrome_trace(path, record, self.prof)
        self.prof = None
        print(f"[train_ssl] profile of steps {self.first}-{last}: {path}",
              flush=True)


def main(argv=None) -> int:
    args = get_args(argv)
    check_ported(args)
    cfg = build_config(args, args.device)
    from ..data.dataset import FaceRecordDataset
    from ..data.pipeline import EpochSampler, Prefetcher
    from ..ops.schedules import (
        cosine_scheduler,
        dino_lr_scaling,
        teacher_temp_schedule,
    )
    from ..train.checkpoint import (
        PreemptionGuard,
        TrainingCheckpointer,
        load_landmark_variables,
        ssl_state_from_payload,
        ssl_state_payload,
    )
    from ..train.device import resolve
    from ..train.ssl import (
        check_supported,
        create_landmark_provider,
        create_ssl_state,
        make_ssl_train_step,
    )
    from ..utils.logging import (
        DeferredLossFetcher,
        JSONLLogger,
        MetricLogger,
        dump_config,
    )

    check_supported(cfg)
    device = resolve(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.output_dir, exist_ok=True)
    dump_config(os.path.join(args.output_dir, "config.txt"), args)
    dataset = FaceRecordDataset(
        os.path.join(args.data_path, "train.rec"),
        random_subset=args.random_subset,
        subset_cache_path=os.path.join(args.output_dir, "random_index.json"),
        seed=args.seed)
    batch = args.batch_size_per_chip
    sampler = EpochSampler(len(dataset), batch, seed=args.seed)
    prefetcher = Prefetcher(dataset, sampler, device)
    state = create_ssl_state(cfg, args.seed, device)
    landmark = create_landmark_provider(cfg, args.seed + 1, device)
    if args.landmark_path:
        landmark = load_landmark_variables(args.landmark_path, landmark)

    steps_per_epoch = sampler.steps_per_epoch()
    lr_sched = cosine_scheduler(dino_lr_scaling(args.lr, batch, 1),
                                args.min_lr, args.epochs, steps_per_epoch,
                                args.warmup_epochs)
    wd_sched = cosine_scheduler(args.weight_decay, args.weight_decay_end,
                                args.epochs, steps_per_epoch)
    mom_sched = cosine_scheduler(args.momentum_teacher, 1.0, args.epochs,
                                 steps_per_epoch)
    temp_sched = teacher_temp_schedule(
        args.warmup_teacher_temp, args.teacher_temp,
        args.warmup_teacher_temp_epochs, args.epochs)

    ckpt = TrainingCheckpointer(
        os.path.join(args.output_dir, "ckpt"),
        keep_period=(args.saveckp_freq * steps_per_epoch
                     if args.saveckp_freq else None))
    guard = PreemptionGuard()
    payload, restored_step = ckpt.restore(device)
    start_epoch = start_it = 0
    if payload is not None:
        state = ssl_state_from_payload(payload)
        start_epoch, start_it = divmod(restored_step, max(steps_per_epoch, 1))
        print(f"[resume] step {restored_step}: epoch {start_epoch} step "
              f"{start_it}", flush=True)
    step_fn = make_ssl_train_step(cfg)
    logger = MetricLogger()
    jsonl = JSONLLogger(os.path.join(args.output_dir, "log.txt"))
    losses = DeferredLossFetcher(logger, nan_exit=True)
    window = ProfileWindow(os.path.join(args.output_dir, "profile"),
                           args.profile_steps, device)
    ran = 0
    print(f"[train_ssl] start: epoch {start_epoch} step {start_it}, "
          f"{steps_per_epoch} steps of {batch} images an epoch on {device}",
          flush=True)

    for epoch in range(start_epoch, args.epochs):
        t_epoch = time.perf_counter()
        skip = start_it if epoch == start_epoch else 0
        images_seen, saving = 0, 0.0
        for it, (images, _) in enumerate(logger.log_every(
                prefetcher.epoch(epoch, start_step=skip), 100,
                f"Epoch [{epoch}/{args.epochs}]",
                total=steps_per_epoch - skip)):
            gstep = epoch * steps_per_epoch + skip + it
            if args.profile_steps:
                window.before_step(ran, gstep)
            ran += 1
            state, metrics = step_fn(
                state, landmark, images, None, None, None,
                lr=float(lr_sched[gstep]), wd=float(wd_sched[gstep]),
                momentum=float(mom_sched[gstep]),
                teacher_temp=float(temp_sched[epoch]),
                freeze_last=0.0 if epoch < cfg.freeze_last_layer_epochs
                else 1.0)
            images_seen += images.shape[0]
            losses.append(gstep, metrics["loss"])
            logger.update(lr=lr_sched[gstep], wd=wd_sched[gstep])
            losses.maybe_flush(it)
            if args.saveckp_steps and (gstep + 1) % args.saveckp_steps == 0:
                t_save = time.perf_counter()
                losses.flush()
                ckpt.save(gstep + 1, ssl_state_payload(state))
                saving += time.perf_counter() - t_save
            if guard.should_exit(gstep):
                window.close()
                losses.flush()
                ckpt.save(gstep + 1, ssl_state_payload(state))
                print(f"[preempt] SIGTERM: saved step {gstep + 1}; exiting "
                      "cleanly — rerun the same command to resume exactly",
                      flush=True)
                return 0
        losses.flush()  # reads the epoch's last loss: the card is done
        seconds = time.perf_counter() - t_epoch - saving
        ckpt.save((epoch + 1) * steps_per_epoch, ssl_state_payload(state))
        record = {"epoch": epoch,
                  "train_loss": logger.meters["loss"].global_avg,
                  "epoch_time_s": seconds,
                  "imgs_per_s": images_seen / seconds}
        jsonl.write(record)
        print(f"[train_ssl] epoch {epoch}: loss "
              f"{record['train_loss']:.5f}, {images_seen} images in "
              f"{seconds:.2f} s, imgs_per_s={record['imgs_per_s']:.1f} "
              f"(decode, multi-crop and step; checkpoints excluded)",
              flush=True)
    window.close()  # a run shorter than its profile writes what it ran
    return 0


if __name__ == "__main__":
    sys.exit(main())
