"""Runner of the supervised finetuning cells: the port's supervised step
(``train/supervised.py::make_train_step``) fed by its data path
(``FaceRecordDataset``, ``EpochSampler``, ``Prefetcher`` with nvJPEG on a
side stream, uint8 images scaled on the card), at the configuration's
recipe and a constant lr, on weights the benchmark makes from the seed.

The traffic is JPEG records of the benchmark's faces, each with a class
label drawn uniformly from the traffic's ``label_seed``, built once per
checkout in a directory of their own; ``rounds`` passes over the faces
make one epoch outlast a run, so no epoch boundary (a prefetcher restart
and a reshuffle) falls inside the window.

Set-up builds the records, the state and the step, and drives the first
three steps through the window's own call and feed: the output check holds
them against the plain reference (``reference/supervised.py``) once the
window has closed. Two more steps warm up, then the window runs. With
``--trace 1`` the window is an unprofiled stretch with the program's
tracer on (its record goes to ``ctx["program"]``), then a profiled slice
of a few steps (kernels, busy time, idle gaps).
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from bench_torch import records
from bench_torch.runners.ssl_train import sync
from bench_torch.trace import profile_slice, record, warm_up
from bench_torch.weights import generate, served_spec

CHECK_STEPS = 3
WARM_STEPS = 2
PROFILED_STEPS = 3
STRETCH = 0.6  # of --seconds: the traced run's unprofiled stretch
B1 = 0.9
LANDMARK = ("stn.", "output_layer.")


def spec(m: dict) -> list:
    """(name, shape, kind) of Part-fViT with its landmark CNN and the
    CosFace head's class centres."""
    return served_spec(m) + [("loss.weight", (m["num-classes"], m["dim"]),
                              "w")]


def record_labels(traffic: dict, n: int) -> np.ndarray:
    """The class of every record, uniform over the traffic's classes."""
    return np.random.default_rng(traffic["label_seed"]).integers(
        0, traffic["classes"], n)


def ensure_records(root, traffic: dict):
    """The record directory of this traffic (built if missing or stale):
    ``rounds`` passes over the benchmark's faces, each face's JPEG with its
    record's label."""
    jpegs = records.faces_jpeg()
    src = records.source_map(traffic, len(jpegs))
    labels = record_labels(traffic, len(src))
    key = hashlib.sha256((records.DATA / "faces.bin").read_bytes()
                         + json.dumps(traffic, sort_keys=True).encode()
                         ).hexdigest()[:16]
    out = root / "build" / "bench" / traffic["dir"]
    stamp = out / "complete.json"
    if stamp.exists() and json.loads(stamp.read_text()).get("key") == key:
        return out
    from lafs_cvpr2024_tpu_torch.data.recordio import RecBuilder

    out.mkdir(parents=True, exist_ok=True)
    stamp.unlink(missing_ok=True)
    builder = RecBuilder(str(out), (112, 112))
    for f, lab in zip(src, labels):
        builder.add_image(jpegs[f], float(lab))
    builder.close()
    stamp.write_text(json.dumps({"key": key, "records": len(src)}))
    os.sync()  # written back now, in set-up, not during the window
    return out


def batch_records(n: int, seed: int, batch: int, steps: int) -> list:
    """Records of the first ``steps`` batches of epoch 0, as the port's
    ``EpochSampler`` draws them (``numpy.random.default_rng(seed)
    .shuffle``, one process, last partial batch dropped)."""
    idx = np.arange(n)
    np.random.default_rng(seed).shuffle(idx)
    return [idx[t * batch:(t + 1) * batch] for t in range(steps)]


def thread_cpu() -> dict:
    """CPU seconds of each thread of this process by (id, name), from
    ``/proc`` (empty where there is none)."""
    out = {}
    task = "/proc/self/task"
    for tid in (os.listdir(task) if os.path.isdir(task) else []):
        try:
            with open(f"{task}/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"{task}/{tid}/comm") as f:
                name = f.read().strip()
        except OSError:
            continue
        out[(tid, name)] = ((int(fields[11]) + int(fields[12]))
                            / os.sysconf("SC_CLK_TCK"))
    return out


def supervised_config(m: dict):
    """The port's ``SupervisedConfig`` for the configuration: the widths,
    classes, head, mixup and acc-step it states; every other field (the
    kernels, dtypes, rates, decays) the port's default, which
    :func:`check_program` holds against the file."""
    from lafs_cvpr2024_tpu_torch.models.partfvit import PartFViTConfig
    from lafs_cvpr2024_tpu_torch.ops.mixup import MixupConfig
    from lafs_cvpr2024_tpu_torch.train.supervised import SupervisedConfig

    model = PartFViTConfig(
        image_size=m["image-size"], patch_size=m["patch-size"],
        num_patches=m["num-patches"], dim=m["dim"], depth=m["depth"],
        heads=m["heads"], dim_head=m["dim-head"], mlp_dim=m["mlp-dim"],
        num_classes=m["num-classes"], cosface_m=m["cosface-m"],
        cosface_s=m["cosface-s"], stn_mode=m["stn-mode"],
        attn_impl="fused")
    mixup = MixupConfig(mixup_alpha=m["mixup"], cutmix_alpha=m["cutmix"],
                        prob=m["mixup-prob"], num_classes=m["num-classes"])
    return SupervisedConfig(model=model, acc_step=m["acc-step"], mixup=mixup,
                            input_scale=m["input-scale"])


def check_program(cfg, m: dict, traffic: dict) -> list:
    """What the program runs, held against what the configuration states:
    departures make the run unsound."""
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    bad = []
    for attr, key in (("compute_dtype", "compute-dtype"),
                      ("moment_dtype", "moment-dtype")):
        if getattr(cfg, attr) != dt[m[key]]:
            bad.append(f"{attr}={getattr(cfg, attr)}")
    for attr, key in (("weight_decay", "weight-decay"),
                      ("layer_decay", "layer-decay"),
                      ("stn_weight_decay", "stn-weight-decay")):
        if getattr(cfg, attr) != m[key]:
            bad.append(f"{attr}={getattr(cfg, attr)}")
    mc = cfg.model
    for attr, key in (("dropout", "dropout"), ("emb_dropout", "emb-dropout"),
                      ("drop_path_rate", "drop-path-rate"),
                      ("gather_impl", "gather-impl"),
                      ("mlp_impl", "mlp-impl"), ("attn_impl", "attn-impl"),
                      ("loss_type", "head-name")):
        if getattr(mc, attr) != m[key]:
            bad.append(f"{attr}={getattr(mc, attr)}")
    if cfg.mixup.switch_prob != 0.5 or cfg.mixup.label_smoothing != 0.0:
        bad.append("mixup switch or smoothing")
    if traffic["classes"] != m["num-classes"]:
        bad.append(f"labels over {traffic['classes']} classes")
    return bad


class Finetune:
    """The port's data path and step for one run, on weights from
    ``seed``."""

    def __init__(self, m: dict, traffic: dict, root, seed: int, device):
        from lafs_cvpr2024_tpu_torch.data.dataset import FaceRecordDataset
        from lafs_cvpr2024_tpu_torch.data.pipeline import (
            EpochSampler,
            Prefetcher,
        )
        from lafs_cvpr2024_tpu_torch.train.optim import adamw_init
        from lafs_cvpr2024_tpu_torch.train.supervised import (
            TrainState,
            check_supported,
            make_train_step,
        )

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        data = ensure_records(root, traffic)
        self.cfg = supervised_config(m)
        check_supported(self.cfg)
        self.unsound = check_program(self.cfg, m, traffic)
        self.step_fn = make_train_step(self.cfg)
        dataset = FaceRecordDataset(str(data / "train.rec"))
        self.n_records = len(dataset)
        self.batch = m["batch-size"] * m["acc-step"]
        sampler = EpochSampler(len(dataset), self.batch, seed=seed)
        self.prefetcher = Prefetcher(dataset, sampler, device)
        self.device = device
        weights = generate(spec(m), seed, 0, device)
        names = {n for n, _ in self.step_fn.model.named_parameters()}
        self.params0 = {n: t for n, t in weights.items() if n in names}
        self.state = TrainState(
            params=self.params0,
            batch_stats={n: t for n, t in weights.items() if n not in names},
            opt_state=adamw_init(self.params0, self.cfg.moment_dtype),
            step=0, seed=int(seed))
        self.lr = m["lr"]
        self.losses = []
        self._epoch = self.prefetcher.epoch(0)

    def next_batch(self):
        """The next batch's uint8 images and int labels on the card."""
        images, labels = next(self._epoch)
        labels = torch.from_numpy(labels)
        if self.device.type == "cuda":  # no wait for the card's queue
            labels = labels.pin_memory()
        return images, labels.to(self.device, non_blocking=True).long()

    def step(self, images, labels):
        self.state, metrics = self.step_fn(self.state, images, labels,
                                           self.lr)
        self.losses.append(metrics["loss"])

    def close(self):
        self._epoch.close()


def run(args, files: dict, root, t_start: float, dev=None) -> dict:
    from lafs_cvpr2024_tpu_torch.utils import tracing

    m, traffic, limits = files["model"], files["traffic"], files["limits"]
    dev = dev or torch.device("cuda")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tr = Finetune(m, traffic, root, args.seed, dev)
    prog = {}
    for t in range(CHECK_STEPS):
        tr.step(*tr.next_batch())
        if t == 0:
            prog["grad"] = {k: v.float() / (1 - B1)
                            for k, v in tr.state.opt_state.mu.items()}
    prog["change"] = {k: float((tr.state.params[k] - v).norm())
                      for k, v in tr.params0.items()}
    tr.params0 = None
    for _ in range(WARM_STEPS):
        tr.step(*tr.next_batch())
    sync(dev)
    setup_s = time.perf_counter() - t_start
    ctx = {"model": m, "batch": tr.batch, "stretch": {}}

    def timed(seconds):
        """Steps for ``seconds``, ending in a synchronise; (steps, seconds).
        Prints the host's step times (the pace once the card's queue is
        full) and the CPU time a step of the busiest threads to standard
        error: the host sets this cell's pace (``PERF.md`` §5)."""
        n, t0 = 0, time.perf_counter()
        threads0 = thread_cpu()
        ends = [t0]
        while ends[-1] - t0 < seconds:
            tr.step(*tr.next_batch())
            n += 1
            ends.append(time.perf_counter())
        sync(dev)
        ms = np.diff(ends) * 1e3
        busy = sorted(((v - threads0.get(k, 0.0)) / n * 1e3, k[1])
                      for k, v in thread_cpu().items())[::-1][:3]
        print(f"[bench] host step ms: median {np.median(ms):.1f}, "
              f"p10 {np.percentile(ms, 10):.1f}, p90 "
              f"{np.percentile(ms, 90):.1f}, max {ms.max():.1f}; halves "
              f"{ms[:n // 2].mean():.1f} {ms[n // 2:].mean():.1f}; CPU ms "
              f"a step of the busiest threads "
              f"{[(name, round(t, 1)) for t, name in busy]}",
              file=sys.stderr)
        return n, time.perf_counter() - t0

    if not args.trace:
        steps, window = timed(args.seconds)
        e2e = {"train_imgs_per_s": steps * tr.batch / window}
    else:
        tracing.reset()
        tracing.enable(True)
        n_a, s_a = timed(STRETCH * args.seconds)
        ctx["stretch"] = {"steps": n_a, "seconds": s_a}
        ctx["program"] = tracing.export()
        print(f"[bench] program counters {ctx['program']['counters']}",
              file=sys.stderr)

        def profiled():
            for _ in range(PROFILED_STEPS):
                with record("next_batch"):
                    batch = tr.next_batch()
                with record("step"):
                    tr.step(*batch)
            sync(dev)

        warm_up()
        ctx["profile"], _ = profile_slice(profiled)
        tracing.enable(False)
        ctx["profiled_steps"] = PROFILED_STEPS
        steps = n_a + PROFILED_STEPS
        e2e = {}
    losses = torch.stack(tr.losses).float().cpu().numpy()
    failed = int((~np.isfinite(losses)).sum())
    e2e["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    loss_prog = [float(x) for x in losses[:CHECK_STEPS]]
    unsound, n_records = tr.unsound, tr.n_records
    tr.close()
    del tr
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(m, traffic, args.seed, n_records, prog, loss_prog,
                     limits, dev)
    return {"e2e": e2e, "checks": checks, "sound": not unsound,
            "sound_note": "; ".join(unsound) or "as configured",
            "attempted": CHECK_STEPS + WARM_STEPS + steps,
            "failed": failed, "memory_peak_bytes": peak, "ctx": ctx}


def reference_readings(m, traffic, seed, n_records, dev, prec=None,
                       half_batch=False):
    """The plain reference's three steps from the benchmark's weights on
    libjpeg's pixels and the labels of the records the port's sampler
    draws."""
    from bench_torch.reference import supervised as ref
    from bench_torch.reference.model import FP32

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    faces = records.faces_decoded()
    src = records.source_map(traffic, len(faces))
    labels = record_labels(traffic, len(src))
    batch = m["batch-size"] * m["acc-step"]
    batches = [(torch.from_numpy(faces[src[r]]).to(dev),
                torch.from_numpy(labels[r]).to(dev))
               for r in batch_records(n_records, seed, batch, CHECK_STEPS)]
    weights = generate(spec(m), seed, 0, dev)
    stats = {k: v for k, v in weights.items()
             if "running_" in k}
    params = {k: v for k, v in weights.items()
              if k not in stats and not k.endswith("num_batches_tracked")}
    losses, first, after = ref.run_steps(params, stats, batches, m, seed,
                                         prec or FP32, half_batch)
    return {"loss": losses, "grad": first,
            "change": {k: float((after[k] - params[k]).norm())
                       for k in after}}


def _worst(gap: dict) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in
                     sorted(gap.items(), key=lambda kv: -kv[1])[:3])


def gaps(prog: dict, loss_prog: list, ref: dict, log=None) -> dict:
    """The compared numbers. ``grad_gap``: by the worst leaf outside the
    landmark branch, the distance between the program's and the
    reference's first gradient, over the larger of that leaf's reference
    norm and the median leaf's. ``change_gap``: by the worst leaf, the gap
    between the norms of the program's and the reference's change after
    the three steps, over the larger of the leaf's and the median leaf's
    reference norm, among the leaves whose reference gradient is at least
    a thousandth of the median leaf's (the others move by round-off
    alone). Printed, not compared: ``loss_gap``, the largest relative gap
    of a step's loss, and ``land_grad_gap``, ``grad_gap`` over the
    landmark branch (``stn.*``, ``output_layer.*``), whose first gradient
    is mostly round-off at the step's precision (``PERF.md`` §2)."""
    g_ref = {k: float(g.norm()) for k, g in ref["grad"].items()}
    med_g = float(np.median(list(g_ref.values())))
    grad = {k: float((prog["grad"][k] - ref["grad"][k]).norm())
            / max(g, med_g) for k, g in g_ref.items()}
    moving = [k for k, g in g_ref.items() if g >= 1e-3 * med_g]
    c_ref = ref["change"]
    med_c = float(np.median([c_ref[k] for k in moving]))
    change = {k: abs(prog["change"][k] - c_ref[k]) / max(c_ref[k], med_c)
              for k in moving}
    land = {k: v for k, v in grad.items() if k.startswith(LANDMARK)}
    rest = {k: v for k, v in grad.items() if k not in land}
    if log:
        log(f"[bench] worst leaves: grad {_worst(rest)}; landmark grad "
            f"{_worst(land)}; change {_worst(change)}")
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(loss_prog, ref["loss"])),
            "grad_gap": max(rest.values()), "change_gap": max(change.values()),
            "land_grad_gap": max(land.values())}


def compare(m, traffic, seed, n_records, prog, loss_prog, limits,
            dev) -> list:
    """The numbers that ``limits`` holds (``loss_gap`` and
    ``land_grad_gap`` are printed, not compared)."""
    ref = reference_readings(m, traffic, seed, n_records, dev)
    g = gaps(prog, loss_prog, ref,
             log=lambda msg: print(msg, file=sys.stderr))
    for k in ("loss_gap", "land_grad_gap"):
        print(f"[bench] {k} = {g[k]!r} (not compared)", file=sys.stderr)
    return [(k, g[k], limits[k]) for k in sorted(limits)]
