"""The transformer MLP's least time on the card (flops/mlp.py: kernel 2's
forward and kernel 3's data-path backward, from the step's shapes) over
the device time of the kernels that ran it in the profiled steps, %."""

from bench_torch.flops import mlp
from bench_torch.roofline import share_pct
from bench_torch.trace import kernel_seconds

PATTERNS = ("ln_mlp_fwd", "ln_mlp_bwd")
LAUNCHES_PER_STEP_PER_BLOCK = 5


def read(ctx):
    prof, m = ctx.get("profile"), ctx["model"]
    if not prof:
        return None
    secs, n = kernel_seconds(prof, PATTERNS)
    steps = ctx["profiled_steps"]
    if n != steps * m["depth"] * LAUNCHES_PER_STEP_PER_BLOCK:
        return None
    flops, moved = mlp.ssl_step(m, ctx["batch"])
    return share_pct(steps * flops, steps * moved, secs)
