"""Model FLOPs of the supervised step (flops/finetune_step.py) times the
steps of the traced run's unprofiled stretch over its seconds, as a share
of the card's bf16 peak, %."""

from bench_torch.flops.finetune_step import step_flops
from bench_torch.roofline import mfu_pct


def read(ctx):
    st = ctx.get("stretch")
    if not st or not st.get("steps"):
        return None
    return mfu_pct(st["steps"] * step_flops(ctx["model"]), st["seconds"])
