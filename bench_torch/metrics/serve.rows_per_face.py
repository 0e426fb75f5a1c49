"""Rows the server's model forwarded (padding to the fixed batch and the
flipped views included) per face answered."""


def read(ctx):
    c = ctx["counters"]
    return c["rows"] / c["faces"] if c.get("faces") else None
