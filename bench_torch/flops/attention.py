"""Work of softmax attention O = softmax(s·QKᵀ)V on (BH, N, d) operands
from its shapes: the forward's two products, the backward's five (S
recomputed from the saved row statistics, dP = dO·Vᵀ, dV = Pᵀ·dO,
dQ = dS·K, dK = dSᵀ·Q). Bytes: Q, K, V (and O, dO, the fp32 row
statistics) read once, O (dQ, dK, dV) written once, bf16."""

B16 = 2


def fwd(bh: int, n: int, d: int) -> tuple:
    return 4 * bh * n * n * d, B16 * 4 * bh * n * d + 4 * bh * n


def bwd(bh: int, n: int, d: int) -> tuple:
    return 10 * bh * n * n * d, B16 * 8 * bh * n * d + 4 * bh * n


def ssl_step(m: dict, batch: int) -> tuple:
    """(FLOPs, bytes) of kernels 11a-c in one SSL step: the teacher's
    forward of the globals, the student's forward and backward of the
    globals and the locals, in every block."""
    hd, d = m["heads"], m["dim-head"]
    g = (2 * batch * hd, m["num-patches"] + 1)
    lo = (m["local-crops-number"] * batch * hd, m["local-keep-landmarks"] + 1)
    parts = [fwd(*g, d), fwd(*g, d), bwd(*g, d), fwd(*lo, d), bwd(*lo, d)]
    return (m["depth"] * sum(p[0] for p in parts),
            m["depth"] * sum(p[1] for p in parts))
