"""Device traces of a short slice of a run, by ``torch.profiler``: what ran
on the card and when, reduced to busy time, kernel time by name pattern,
the operations that took the most time and the longest idle gaps labelled
by what the host was doing (the benchmark's own ``bench.*`` spans and the
host operation in progress)."""

from __future__ import annotations

import time

import torch


class ProfiledSlice:
    """``with ProfiledSlice() as s: ...`` profiles the block, which must end
    in a ``torch.cuda.synchronize()``; afterwards ``s.summary()`` holds
    the reduction. A session that recorded no device event is reported
    as empty (``summary()`` returns None): the caller takes another."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.wall = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def summary(self):
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in self.prof.events():
            tr = e.time_range
            if e.name.startswith("bench.") or getattr(
                    e, "is_user_annotation", False):
                if e.device_type == DeviceType.CPU:
                    host.append((tr.start, tr.end, e.name))
                continue
            if e.device_type == DeviceType.CUDA:
                dev.append((tr.start, tr.end, e.name))
            elif e.device_type == DeviceType.CPU:
                host.append((tr.start, tr.end, e.name))
        if not dev:
            return None
        dev.sort()
        merged = []
        for s, t, _ in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy = sum(t - s for s, t in merged) / 1e6
        by_name = {}
        for s, t, n in dev:
            by_name[n] = by_name.get(n, 0.0) + (t - s) / 1e6
        spans = [h for h in host if h[2].startswith("bench.")]
        ops = [h for h in host if not h[2].startswith(("bench.", "ProfilerStep",
                                                       "<built-in"))]
        gaps = sorted(((b - a, a, b) for (_, a), (b, _) in zip(merged, merged[1:])),
                      reverse=True)[:10]
        labelled = []
        for length, a, b in gaps:
            mid = (a + b) / 2
            span = min((h for h in spans if h[0] <= mid <= h[1]),
                       key=lambda h: h[1] - h[0], default=None)
            op = min((h for h in ops if h[0] <= mid <= h[1]),
                     key=lambda h: h[1] - h[0], default=None)
            label = " > ".join(x[2] for x in (span, op) if x) or "host idle"
            labelled.append([label, length / 1e6])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy, "window_s": self.wall, "kernels": dev,
                "device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": labelled}


def profile_slice(run, tries: int = 3):
    """Profile ``run()`` (which ends in a synchronise); retake a session
    that recorded no device event, up to ``tries`` sessions in all."""
    for _ in range(tries):
        with ProfiledSlice() as s:
            out = run()
        summ = s.summary()
        if summ is not None:
            return summ, out
    return None, out


def kernel_seconds(summary, patterns) -> tuple:
    """(seconds, launches) of the device kernels whose names hold any of
    ``patterns``."""
    hits = [(t - s) for s, t, n in summary["kernels"]
            if any(p in n for p in patterns)]
    return sum(hits) / 1e6, len(hits)


def warm_up() -> None:
    """One empty profiler session: the first start of the profiler in a
    process takes seconds, which a slice must not."""
    with ProfiledSlice():
        pass


def idle_pct(busy_per_unit: float, units: int, seconds: float):
    """The card's idle share over ``seconds`` of a stretch without the
    profiler, in which ``units`` steps or requests completed, each taking
    ``busy_per_unit`` seconds of device time by the profiled slice (whose
    own wall the profiler's host overhead stretches), %."""
    if seconds <= 0 or units <= 0:
        return None
    return 100.0 * (1.0 - busy_per_unit * units / seconds)


def record(name: str):
    """A host span in the trace (``bench.<name>``)."""
    return torch.profiler.record_function("bench." + name)
