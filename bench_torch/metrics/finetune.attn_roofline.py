"""Attention's least time on the card (flops/attention.py at the
supervised step's (200·11, 197, 64): every microbatch's forward and
backward in every block) over the device time of the kernels that ran it
(6 and 7) in the profiled steps, %. None unless kernel 6 and kernel 7's
two passes ran in every block of every microbatch."""

from bench_torch.flops.finetune_step import attention_work
from bench_torch.roofline import share_pct
from bench_torch.trace import kernel_seconds

PATTERNS = ("attn_fwd", "attn_bwd")
LAUNCHES_PER_MICROBATCH_PER_BLOCK = 3


def read(ctx):
    prof, m = ctx.get("profile"), ctx["model"]
    if not prof:
        return None
    secs, n = kernel_seconds(prof, PATTERNS)
    steps = ctx["profiled_steps"]
    if n != (steps * m["acc-step"] * m["depth"]
             * LAUNCHES_PER_MICROBATCH_PER_BLOCK):
        return None
    flops, moved = attention_work(m)
    return share_pct(steps * flops, steps * moved, secs)
