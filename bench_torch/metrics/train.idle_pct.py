"""Share of the traced run's first stretch (no profiler, no added
synchronisation) in which no operation ran on the card: its steps times
the device time of a step in the profiled slice, over its seconds, %."""

from bench_torch.trace import idle_pct


def read(ctx):
    prof, st = ctx.get("profile"), ctx.get("stretch")
    if not prof or not st:
        return None
    return idle_pct(prof["busy_s"] / ctx["profiled_steps"], st["steps"],
                    st["seconds"])
