"""Metrics and logging of the training CLIs (counterpart of
``SmoothedValue``, ``MetricLogger``, ``JSONLLogger``,
``DeferredLossFetcher`` and ``dump_config`` in
``lafs_cvpr2024_tpu/utils/logging.py``; the reference's ``utils.py:
202-400``).

The loss of a step stays a tensor on the card until a flush boundary, when
:class:`DeferredLossFetcher` reads all pending losses in one copy: reading
it every step would make the host wait for the card each step (the
reference reads ``loss.item()`` every iteration, ``lafs_train.py:585``).
One process: nothing is reduced across processes.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np
import torch


class SmoothedValue:
    """Windowed median/avg meter (reference ``utils.py:202-253``)."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return float(np.max(self.deque)) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Iteration logger with ETA and throughput (``utils.py:313-400``)."""

    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_fn = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def log_every(self, iterable, print_freq: int, header: str = "",
                  total: Optional[int] = None):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        n = total if total is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None)
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                eta = ""
                if n:
                    eta_s = iter_time.global_avg * (n - i)
                    eta = (f"eta: {int(eta_s // 3600)}:"
                           f"{int(eta_s % 3600 // 60):02d}:"
                           f"{int(eta_s % 60):02d}  ")
                meters = self.delimiter.join(f"{k}: {v}"
                                             for k, v in self.meters.items())
                self.print_fn(f"{header} [{i}{'/' + str(n) if n else ''}]  "
                              f"{eta}{meters}  time: {iter_time}")
            i += 1
            end = time.time()
        self.print_fn(f"{header} Total time: {time.time() - start:.1f}s")

    def __str__(self):
        return self.delimiter.join(f"{k}: {v}" for k, v in self.meters.items())


class JSONLLogger:
    """Per-epoch JSONL log (reference ``lafs_train.py:464-468`` log.txt)."""

    def __init__(self, path: str, enabled: bool = True):
        self.path = path
        self.enabled = enabled
        if enabled:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def write(self, record: dict):
        if self.enabled:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")


def get_sha(repo_root: Optional[str] = None) -> str:
    """Git SHA + dirty flag stamp (reference ``utils.py:403-420``)."""
    cwd = repo_root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    def run(cmd):
        return subprocess.check_output(cmd, cwd=cwd,
                                       stderr=subprocess.DEVNULL
                                       ).decode("ascii").strip()

    try:
        sha = run(["git", "rev-parse", "HEAD"])
        status = ("has uncommitted changes" if run(["git", "diff-index", "HEAD"])
                  else "clean")
        branch = run(["git", "rev-parse", "--abbrev-ref", "HEAD"])
        return f"sha: {sha}, status: {status}, branch: {branch}"
    except (OSError, subprocess.CalledProcessError):  # no git, or no repo
        return "sha: N/A"


def dump_config(path: str, args) -> None:
    """Write the run configuration (``config.txt``,
    ``train_largescale.py:490-491``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(get_sha() + "\n")
        for k, v in sorted(vars(args).items()):
            f.write(f"{k}: {v}\n")


class DeferredLossFetcher:
    """Buffer per-step loss tensors and read them in ONE device-to-host copy
    at flush boundaries. ``nan_exit``: a non-finite loss stops the run with
    ``SystemExit`` at the flush that reads it (``lafs_train.py:585`` at log
    granularity)."""

    def __init__(self, logger: MetricLogger, nan_exit: bool = False,
                 key: str = "loss"):
        self._logger = logger
        self._nan_exit = nan_exit
        self._key = key
        self._pending: list = []

    def append(self, gstep: int, loss: torch.Tensor) -> None:
        self._pending.append((gstep, loss.detach()))

    def maybe_flush(self, it: int, every: int = 100) -> None:
        if (it + 1) % every == 0:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        vals = torch.stack([v.float().reshape(()) for _, v in pending]).cpu()
        for (gs, _), v in zip(pending, vals.tolist()):
            if self._nan_exit and not np.isfinite(v):
                raise SystemExit(f"Loss is {v} at step {gs}, stopping training")
            self._logger.update(**{self._key: v})
