"""Model FLOPs of the SSL step (flops/ssl_step.py) times the steps of the
traced run's first stretch (no profiler, no added synchronisation) over
its seconds, as a share of the card's bf16 peak, %."""

from bench_torch.flops.ssl_step import step_flops
from bench_torch.roofline import mfu_pct


def read(ctx):
    st = ctx.get("stretch")
    if not st or not st.get("steps"):
        return None
    return mfu_pct(st["steps"] * step_flops(ctx["model"], ctx["batch"]),
                   st["seconds"])
