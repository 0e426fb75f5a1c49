"""How late the load generator sent requests behind their schedule: the
99th percentile over the window's requests, ms."""

from bench_torch.loadgen import nearest_rank


def read(ctx):
    lags = ctx.get("lags")
    return nearest_rank(lags, 0.99) if lags else None
