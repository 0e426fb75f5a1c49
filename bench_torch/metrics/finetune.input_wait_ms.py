"""Host time the consumer waited for its next batch from the prefetcher
(the program's ``input.wait`` span, nvJPEG decode on the side stream
behind it) in the traced run's unprofiled stretch, ms/step."""


def read(ctx):
    spans = ctx.get("program", {}).get("spans", [])
    waits = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in spans
             if s["name"] == "input.wait"]
    return sum(waits) / len(waits) if waits else None
