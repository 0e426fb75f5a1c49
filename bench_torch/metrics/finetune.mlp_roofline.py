"""The transformer MLP's least time on the card (flops/mlp.py: kernel 2's
forward with u saved and kernel 3's data-path backward at T = 39,400 rows
a microbatch) over the device time of the kernels that ran it in the
profiled steps, %."""

from bench_torch.flops.finetune_step import mlp_work
from bench_torch.roofline import share_pct
from bench_torch.trace import kernel_seconds

PATTERNS = ("ln_mlp_fwd", "ln_mlp_bwd")
LAUNCHES_PER_MICROBATCH_PER_BLOCK = 2


def read(ctx):
    prof, m = ctx.get("profile"), ctx["model"]
    if not prof:
        return None
    secs, n = kernel_seconds(prof, PATTERNS)
    steps = ctx["profiled_steps"]
    if n != (steps * m["acc-step"] * m["depth"]
             * LAUNCHES_PER_MICROBATCH_PER_BLOCK):
        return None
    flops, moved = mlp_work(m)
    return share_pct(steps * flops, steps * moved, secs)
