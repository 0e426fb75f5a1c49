"""SSL training schedules as per-iteration numpy arrays (the port's own
copy of ``cosine_scheduler``, ``teacher_temp_schedule`` and
``dino_lr_scaling`` from ``lafs_cvpr2024_tpu/ops/schedules.py``, whose
package imports jax).

Computed once on the host; the training loop hands one Python float per
step to the step function (the reference mutates optimizer param groups
per step, ``utils.py:187-198``, ``lafs_train.py:513-517``).
"""

from __future__ import annotations

import numpy as np


def cosine_scheduler(
    base_value: float,
    final_value: float,
    epochs: int,
    niter_per_ep: int,
    warmup_epochs: int = 0,
    start_warmup_value: float = 0.0,
) -> np.ndarray:
    """Linear warmup to ``base_value`` then cosine decay to ``final_value``.

    Mirrors reference ``utils.py:187-198`` (one value per training iteration).
    """
    warmup_iters = warmup_epochs * niter_per_ep
    warmup = (
        np.linspace(start_warmup_value, base_value, warmup_iters)
        if warmup_epochs > 0
        else np.array([])
    )
    iters = np.arange(epochs * niter_per_ep - warmup_iters)
    n = max(len(iters), 1)
    sched = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * iters / n)
    )
    out = np.concatenate((warmup, sched))
    assert len(out) == epochs * niter_per_ep
    return out


def teacher_temp_schedule(
    warmup_teacher_temp: float,
    teacher_temp: float,
    warmup_teacher_temp_epochs: int,
    nepochs: int,
) -> np.ndarray:
    """Per-epoch teacher temperature (reference ``lafs_train.py:637-641``)."""
    return np.concatenate(
        (
            np.linspace(warmup_teacher_temp, teacher_temp, warmup_teacher_temp_epochs),
            np.ones(max(nepochs - warmup_teacher_temp_epochs, 0)) * teacher_temp,
        )
    )


def dino_lr_scaling(base_lr: float, batch_size_per_device: int, n_devices: int) -> float:
    """DINO linear LR scaling rule (reference ``lafs_train.py:411-412``)."""
    return base_lr * (batch_size_per_device * n_devices) / 256.0
