"""Attention's least time on the card (flops/attention.py: the forward of
the teacher and the student and the student's backward, from the step's
shapes) over the device time of the kernels that ran it (11a-c) in the
profiled steps, %."""

from bench_torch.flops import attention
from bench_torch.roofline import share_pct
from bench_torch.trace import kernel_seconds

PATTERNS = ("flash_fwd", "flash_bwd")
LAUNCHES_PER_STEP_PER_BLOCK = 7


def read(ctx):
    prof, m = ctx.get("profile"), ctx["model"]
    if not prof:
        return None
    secs, n = kernel_seconds(prof, PATTERNS)
    steps = ctx["profiled_steps"]
    if n != steps * m["depth"] * LAUNCHES_PER_STEP_PER_BLOCK:
        return None
    flops, moved = attention.ssl_step(m, ctx["batch"])
    return share_pct(steps * flops, steps * moved, secs)
