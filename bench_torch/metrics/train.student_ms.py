"""Time between CUDA events around the student's forward, DINO loss and
backward of a step, ms/step."""


def read(ctx):
    v = ctx["spans"].get("student")
    return sum(v) / len(v) if v else None
