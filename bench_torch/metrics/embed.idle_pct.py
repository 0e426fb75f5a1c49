"""Share of the window before the server's profiled slice in which no
operation ran on the card: the requests answered then times the device
time of a request in the profiled slice, over those seconds, %."""

from bench_torch.trace import idle_pct


def read(ctx):
    prof, t = ctx.get("profile"), ctx.get("profile_t") or [None]
    n = ctx["counters"].get("profiled_requests", 0)
    if not prof or not n or t[0] is None:
        return None
    t0 = ctx["window"][0]
    done = sum(1 for d, _ in ctx["answered"] if t0 <= d <= t[0])
    return idle_pct(prof["busy_s"] / n, done, t[0] - t0)
