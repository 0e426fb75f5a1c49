"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W) and the
least time an operation can take on it."""

PEAK_FLOPS = 989e12   # bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12  # HBM3 bytes/s


def bound_s(flops: float, moved: float) -> float:
    """The larger of the compute and the memory time of the work."""
    return max(flops / PEAK_FLOPS, moved / PEAK_BYTES)


def share_pct(flops: float, moved: float, seconds: float):
    """The work's least time as a percentage of ``seconds``; None when
    nothing was timed."""
    if seconds <= 0:
        return None
    return 100.0 * bound_s(flops, moved) / seconds


def mfu_pct(flops: float, seconds: float):
    """Model FLOPs over ``seconds`` as a percentage of the bf16 peak."""
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / PEAK_FLOPS
