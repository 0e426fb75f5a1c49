"""Model FLOPs of the faces answered (two views each with the flip,
flops/served_forward.py) between the window's start and the server's
profiled slice, over those seconds, as a share of the bf16 peak, %."""

from bench_torch.flops.served_forward import view_flops
from bench_torch.roofline import mfu_pct


def read(ctx):
    t = ctx.get("profile_t") or [None]
    t0, t1 = ctx["window"][0], t[0]
    if t1 is None or t1 <= t0:
        return None
    faces = sum(n for done, n in ctx["answered"] if t0 <= done <= t1)
    return mfu_pct(faces * 2 * view_flops(ctx["model"]), t1 - t0)
