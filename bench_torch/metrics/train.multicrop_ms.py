"""Time between CUDA events around the device multi-crop of a step (its
launches and its device work as the card's timeline sees them), ms/step."""


def read(ctx):
    v = ctx["spans"].get("multicrop")
    return sum(v) / len(v) if v else None
