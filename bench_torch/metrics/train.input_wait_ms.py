"""Host time a step of the traced run's first stretch waited for its next
batch from the prefetcher (decode on the side stream included), ms/step."""


def read(ctx):
    waits = ctx["spans"].get("input_wait")
    return 1e3 * sum(waits) / len(waits) if waits else None
