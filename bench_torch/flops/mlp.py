"""Work of the transformer MLP (LayerNorm, Linear D→H, GELU, Linear H→D,
dropout) from its shapes: what kernels 2 (forward) and 3 (the backward's
data path: do·W2 → du, du·W1 → dx, the LayerNorm backward) have to do. The
weight gradients are products of their own (cuBLAS) and are not counted.
Bytes: each operand read once and each result written once, bf16."""

B16 = 2


def fwd(t: int, d: int, h: int, save_u: bool) -> tuple:
    flops = 4 * t * d * h
    moved = B16 * (2 * t * d + 2 * d * h + h + 3 * d + (t * h if save_u else 0))
    return flops, moved


def bwd(t: int, d: int, h: int) -> tuple:
    """Reads x, u, dy, W1, W2; writes dx, do, hd, du, xn."""
    flops = 4 * t * d * h
    moved = B16 * (3 * t * d + t * h + 2 * d * h + 3 * t * d + 2 * t * h)
    return flops, moved


def ssl_step(m: dict, batch: int) -> tuple:
    """(FLOPs, bytes) of kernels 2 and 3 in one SSL step: the teacher's
    forward of the globals, the student's forward (u saved) and backward of
    the globals and the locals, in every block."""
    d, h = m["dim"], m["mlp-dim"]
    tg = 2 * batch * (m["num-patches"] + 1)
    tl = m["local-crops-number"] * batch * (m["local-keep-landmarks"] + 1)
    parts = [fwd(tg, d, h, False), fwd(tg, d, h, True), fwd(tl, d, h, True),
             bwd(tg, d, h), bwd(tl, d, h)]
    return (m["depth"] * sum(p[0] for p in parts),
            m["depth"] * sum(p[1] for p in parts))


def served(m: dict, rows: int) -> tuple:
    """(FLOPs, bytes) of kernel 2 at rate 0 in one forward of ``rows``
    images (every block)."""
    f, b = fwd(rows * (m["num-patches"] + 1), m["dim"], m["mlp-dim"], False)
    return m["depth"] * f, m["depth"] * b
