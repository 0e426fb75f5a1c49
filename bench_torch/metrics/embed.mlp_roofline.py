"""The served forward's MLP least time (flops/mlp.py, kernel 2 at rate 0
on the fixed batch with flip) over the device time of kernel 2 in the
server's profiled slice, %."""

from bench_torch.flops import mlp
from bench_torch.roofline import share_pct
from bench_torch.trace import kernel_seconds

PATTERNS = ("ln_mlp_fwd",)
ROWS = 512


def read(ctx):
    prof, m = ctx.get("profile"), ctx["model"]
    if not prof:
        return None
    secs, n = kernel_seconds(prof, PATTERNS)
    if not n or n % m["depth"]:
        return None
    flops, moved = mlp.served(m, ROWS)
    forwards = n // m["depth"]
    return share_pct(forwards * flops, forwards * moved, secs)
