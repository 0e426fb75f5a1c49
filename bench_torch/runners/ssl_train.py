"""Runner of the SSL pretraining cells: the loop of
``lafs_cvpr2024_tpu_torch.cli.train_ssl.main`` (the CLI's argument parser,
configuration, dataset, epoch sampler, prefetcher with nvJPEG on a side
stream, the SSL step with the device multi-crop, the CLI's schedules and
``DeferredLossFetcher``), run for a fixed number of seconds with no
checkpoint writes, on weights the benchmark makes from the seed.

Set-up builds the records (once per checkout), the state and the step, and
drives the first three steps through the window's own call and feed: the
output check holds them against the plain reference (``reference/ssl.py``)
once the window has closed. Two more steps warm up, then the window runs.
With ``--trace 1`` the window is three stretches: plain steps with host
spans around the wait for the next batch (``input_wait``, and the rates),
steps assembled from the step's parts with CUDA events between them (the
parts' times), and a profiled slice of a few steps (kernels, busy time,
idle gaps).
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from bench_torch import records
from bench_torch.trace import profile_slice, record, warm_up
from bench_torch.weights import generate, mobilenet_spec, ssl_student_spec

CHECK_STEPS = 3
WARM_STEPS = 2
PROFILED_STEPS = 3


def cli_argv(m: dict, data: str, out: str, seed: int) -> list:
    argv = ["--data-path", data, "--output-dir", out, "--seed", str(seed)]
    for key in m["cli"]:
        v = m[key]
        if v is True:
            argv.append(f"--{key}")
        elif isinstance(v, list):
            argv += [f"--{key}", *map(str, v)]
        else:
            argv += [f"--{key}", str(v)]
    return argv


def check_program(cfg, m: dict) -> list:
    """What the program runs, held against what the configuration states:
    departures make the run unsound."""
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    bad = []
    for attr, key in (("compute_dtype", "compute-dtype"),
                      ("head_dtype", "head-dtype"),
                      ("landmark_dtype", "landmark-dtype"),
                      ("moment_dtype", "moment-dtype")):
        if getattr(cfg, attr) != dt[m[key]]:
            bad.append(f"{attr}={getattr(cfg, attr)}")
    mc = cfg.model
    for attr, key in (("dropout", "dropout"), ("emb_dropout", "emb-dropout"),
                      ("drop_path_rate", "drop-path-rate"),
                      ("mlp_impl", "mlp-impl-resolved"),
                      ("attn_impl", "attn-impl")):
        if getattr(mc, attr) != m[key]:
            bad.append(f"{attr}={getattr(mc, attr)}")
    for attr, key in (("student_temp", "student-temp"),
                      ("center_momentum", "center-momentum"),
                      ("local_keep_landmarks", "local-keep-landmarks"),
                      ("landmark_jitter_std", "landmark-jitter-std")):
        if getattr(cfg, attr) != m[key]:
            bad.append(f"{attr}={getattr(cfg, attr)}")
    return bad


class Trainer:
    """The CLI's pieces for one run, on weights from ``seed``."""

    def __init__(self, m: dict, traffic: dict, root, seed: int, device):
        from lafs_cvpr2024_tpu_torch.cli import train_ssl
        from lafs_cvpr2024_tpu_torch.data.dataset import FaceRecordDataset
        from lafs_cvpr2024_tpu_torch.data.pipeline import (
            EpochSampler,
            Prefetcher,
        )
        from lafs_cvpr2024_tpu_torch.ops.schedules import (
            cosine_scheduler,
            dino_lr_scaling,
            teacher_temp_schedule,
        )
        from lafs_cvpr2024_tpu_torch.train.optim import adamw_init
        from lafs_cvpr2024_tpu_torch.train.ssl import (
            SSLTrainState,
            check_supported,
            make_ssl_train_step,
        )
        from lafs_cvpr2024_tpu_torch.utils.logging import (
            DeferredLossFetcher,
            MetricLogger,
        )

        data = records.ensure_records(root, traffic)
        out = root / "build" / "bench" / "ssl_out"
        out.mkdir(parents=True, exist_ok=True)
        records.clear(out / "random_index.json")
        args = train_ssl.get_args(cli_argv(m, str(data), str(out), seed))
        train_ssl.check_ported(args)
        self.cfg = train_ssl.build_config(args, device.type)
        check_supported(self.cfg)
        self.unsound = check_program(self.cfg, m)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dataset = FaceRecordDataset(
            str(data / "train.rec"), random_subset=args.random_subset,
            subset_cache_path=str(out / "random_index.json"), seed=args.seed)
        self.batch = args.batch_size_per_chip
        sampler = EpochSampler(len(dataset), self.batch, seed=args.seed)
        self.steps_per_epoch = sampler.steps_per_epoch()
        self.prefetcher = Prefetcher(dataset, sampler, device)
        student = generate(ssl_student_spec(m), seed, 0, device)
        self.student0 = student
        self.landmark = generate(mobilenet_spec(m), seed, 1, device)
        self.state = SSLTrainState(
            student=student,
            teacher={k: v.clone() for k, v in student.items()},
            opt_state=adamw_init(student, self.cfg.moment_dtype),
            center=torch.zeros(1, self.cfg.out_dim, device=device),
            step=0, seed=int(seed))
        spe = self.steps_per_epoch
        self.lr = cosine_scheduler(dino_lr_scaling(args.lr, self.batch, 1),
                                   args.min_lr, args.epochs, spe,
                                   args.warmup_epochs)
        self.wd = cosine_scheduler(args.weight_decay, args.weight_decay_end,
                                   args.epochs, spe)
        self.mom = cosine_scheduler(args.momentum_teacher, 1.0, args.epochs,
                                    spe)
        self.temp = teacher_temp_schedule(
            args.warmup_teacher_temp, args.teacher_temp,
            args.warmup_teacher_temp_epochs, args.epochs)
        self.freeze = self.cfg.freeze_last_layer_epochs
        self.step_fn = make_ssl_train_step(self.cfg)
        self.values = []

        class Logger(MetricLogger):
            def update(inner, **kw):  # noqa: N805
                if "loss" in kw:
                    self.values.append(kw["loss"])
                super().update(**kw)

        self.logger = Logger(print_fn=lambda *a: print(*a, file=sys.stderr))
        self.losses = DeferredLossFetcher(self.logger, nan_exit=False)
        self._epoch = self.prefetcher.epoch(0)
        self.batches = iter(self.logger.log_every(
            self._epoch, 100, "Epoch [0]", total=self.steps_per_epoch))
        self.gstep = 0

    def next_batch(self):
        return next(self.batches)[0]

    def scalars(self):
        g = self.gstep
        return dict(lr=float(self.lr[g]), wd=float(self.wd[g]),
                    momentum=float(self.mom[g]),
                    teacher_temp=float(self.temp[0]),
                    freeze_last=0.0 if 0 < self.freeze else 1.0)

    def after(self, loss):
        g = self.gstep
        self.losses.append(g, loss)
        self.logger.update(lr=self.lr[g], wd=self.wd[g])
        self.losses.maybe_flush(g)
        self.gstep += 1

    def step(self, images):
        """One step as the CLI's loop takes it."""
        self.state, metrics = self.step_fn(self.state, self.landmark, images,
                                           None, None, None, **self.scalars())
        self.after(metrics["loss"])
        return metrics["loss"]

    def step_in_parts(self, images, events):
        """The same step assembled from its parts (the step's own
        functions and seeds), a CUDA event recorded between them."""
        from lafs_cvpr2024_tpu_torch.ops.augment_device import (
            lafs_multicrop_device,
        )
        from lafs_cvpr2024_tpu_torch.train.ssl import (
            SSLTrainState,
            aug_seed,
            step_seeds,
        )

        st, f, cfg, sc = self.state, self.step_fn, self.cfg, self.scalars()
        dev = st.center.device
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        s_land, s_glob, s_loc = step_seeds(st.seed, st.step)
        ev[0].record()
        gen = torch.Generator(device=dev).manual_seed(aug_seed(st.seed, st.step))
        crops = lafs_multicrop_device(
            images, gen, local_crops_number=cfg.local_crops_number,
            out_size=cfg.model.image_size,
            global_crops_scale=tuple(cfg.global_crops_scale))
        ev[1].record()
        g_in, l_in = f.make_tokens(
            self.landmark, *crops,
            torch.Generator(device=dev).manual_seed(s_land))
        ev[2].record()
        t_out = f.teacher_forward(st, g_in)
        ev[3].record()
        loss, center, grads = f.student_loss_and_grads(
            st, g_in, l_in, t_out, sc["teacher_temp"], (s_glob, s_loc))
        ev[4].record()
        student, opt, teacher = f.tail(st, grads, sc["lr"], sc["wd"],
                                       sc["momentum"], sc["freeze_last"])
        ev[5].record()
        self.state = SSLTrainState(student, teacher, opt, center, st.step + 1,
                                   st.seed)
        self.after(loss)
        events.append(ev)

    def close(self):
        self.batches.close()
        self._epoch.close()


def _leaf_norms(tree: dict) -> dict:
    return {k: float(v.float().norm()) for k, v in tree.items()}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, files: dict, root, t_start: float, dev=None) -> dict:
    m, traffic, limits = files["model"], files["traffic"], files["limits"]
    dev = dev or torch.device("cuda")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tr = Trainer(m, traffic, root, args.seed, dev)
    b1 = 0.9
    prog = {"loss": []}
    for t in range(CHECK_STEPS):
        images = tr.next_batch()
        prog["loss"].append(tr.step(images))
        if t == 0:
            prog["grad"] = {k: float(v.float().norm()) / (1 - b1)
                            for k, v in tr.state.opt_state.mu.items()}
    prog["change"] = {k: float((tr.state.student[k] - v).norm())
                      for k, v in tr.student0.items()}
    tr.student0 = None
    for _ in range(WARM_STEPS):
        tr.step(tr.next_batch())
    sync(dev)
    setup_s = time.perf_counter() - t_start
    ctx = {"model": m, "batch": tr.batch, "spans": {}, "stretch": {}}
    steps = 0

    def timed(seconds, spans=None):
        """Steps for ``seconds``, ending in a synchronise; (steps, seconds)."""
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            w0 = time.perf_counter()
            images = tr.next_batch()
            if spans is not None:
                spans.append(time.perf_counter() - w0)
            tr.step(images)
            n += 1
        sync(dev)
        return n, time.perf_counter() - t0

    if not args.trace:
        steps, window = timed(args.seconds)
        e2e = {"train_imgs_per_s": steps * tr.batch / window}
    else:
        waits = []
        n_a, s_a = timed(0.5 * args.seconds, waits)
        ctx["stretch"] = {"steps": n_a, "seconds": s_a}
        ctx["spans"]["input_wait"] = waits
        events, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < 0.3 * args.seconds:
            tr.step_in_parts(tr.next_batch(), events)
        sync(dev)
        parts = np.array([[a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
                          for ev in events])
        for i, name in enumerate(("multicrop", "tokens", "teacher", "student",
                                  "tail")):
            ctx["spans"][name] = parts[:, i].tolist()

        def profiled():
            for _ in range(PROFILED_STEPS):
                with record("next_batch"):
                    images = tr.next_batch()
                with record("step"):
                    tr.step(images)
            sync(dev)

        warm_up()
        ctx["profile"], _ = profile_slice(profiled)
        ctx["profiled_steps"] = PROFILED_STEPS
        steps = n_a + len(events) + PROFILED_STEPS
        e2e = {}
    tr.losses.flush()
    vals = np.array(tr.values)
    failed = int((~np.isfinite(vals)).sum())
    e2e["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    loss_prog = [float(x) for x in prog["loss"]]
    unsound = tr.unsound
    tr.close()
    del tr
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(m, traffic, args.seed, prog, loss_prog, limits, dev)
    return {"e2e": e2e, "checks": checks, "sound": not unsound,
            "sound_note": "; ".join(unsound) or "as configured",
            "attempted": CHECK_STEPS + WARM_STEPS + steps,
            "failed": failed, "memory_peak_bytes": peak, "ctx": ctx}


def reference_readings(m, traffic, seed, dev, prec=None, half_batch=False):
    """The plain reference's three steps from the benchmark's weights on
    libjpeg's pixels of the records the CLI's sampler draws."""
    from bench_torch.reference import ssl as ref
    from bench_torch.reference.model import FP32

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    faces = records.faces_decoded()
    batch = m["batch-size-per-chip"]
    srcs = records.epoch_sources(traffic, len(faces), seed, batch,
                                 m["random-subset"], CHECK_STEPS)
    n_rec = len(records.source_map(traffic, len(faces)))
    spe = int(n_rec * m["random-subset"]) // batch
    batches = [torch.from_numpy(faces[s]).to(dev) for s in srcs]
    student = generate(ssl_student_spec(m), seed, 0, dev)
    land = generate(mobilenet_spec(m), seed, 1, dev)
    losses, first, params = ref.run_steps(student, land, batches, m, seed,
                                          spe, prec or FP32, half_batch)
    return {"loss": losses, "grad": _leaf_norms(first),
            "change": {k: float((params[k] - student[k]).norm())
                       for k in params}}


def gaps(prog: dict, loss_prog: list, ref: dict) -> dict:
    """The compared numbers: the largest relative gap of a step's loss; by
    the worst leaf, the gap between the program's and the reference's norm
    of the first gradient and of the change after the three steps, each
    over the larger of that leaf's reference norm and the median leaf's.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(loss_prog, ref["loss"]))
    g_ref = ref["grad"]
    med_g = float(np.median(list(g_ref.values())))
    grad = max(abs(prog["grad"][k] - g) / max(g, med_g)
               for k, g in g_ref.items())
    moving = [k for k, g in g_ref.items() if g >= 1e-3 * med_g]
    c_ref = ref["change"]
    med_c = float(np.median([c_ref[k] for k in moving]))
    change = max(abs(prog["change"][k] - c_ref[k]) / max(c_ref[k], med_c)
                 for k in moving)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def compare(m, traffic, seed, prog, loss_prog, limits, dev) -> list:
    """The numbers that ``limits`` holds (``loss_gap`` has no control or
    fault that separates it from sound runs, so it is not compared; it
    is printed)."""
    ref = reference_readings(m, traffic, seed, dev)
    g = gaps(prog, loss_prog, ref)
    print(f"[bench] loss_gap = {g['loss_gap']!r} (not compared)",
          file=sys.stderr)
    return [(k, g[k], limits[k]) for k in sorted(limits)]
