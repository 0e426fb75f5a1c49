"""Model FLOPs of one LAFS SSL step (the products of the student's forward
and backward over all crops and the teacher's forward over the globals:
linear layers, attention, patch embedding, DINO head), after the JAX
package's analytic count of the SSL step, written for the reference's
graph: the patch embedding's backward forms only its weight gradient (the
tokens need none), and the embedding counts the patches without the CLS
token. The landmark CNN, the gather, the multi-crop and the loss are not
model FLOPs and are not counted."""


def _per_row(m: dict, n: int) -> tuple:
    """(products of the encoder on one crop of ``n`` patches, of its patch
    embedding alone)."""
    d, inner, hid = m["dim"], m["heads"] * m["dim-head"], m["mlp-dim"]
    s = n + 1
    lin = 2 * s * (d * 3 * inner + inner * d + 2 * d * hid)
    attn = 4 * s * s * m["dim-head"] * m["heads"]
    emb = 2 * n * m["patch-size"] ** 2 * 3 * d
    return m["depth"] * (lin + attn) + emb, emb


def head_per_row(m: dict) -> int:
    d, hid, b = m["dim"], m["head-hidden-dim"], m["head-bottleneck-dim"]
    return 2 * (d * hid + hid * hid + hid * b + b * m["out-dim"])


def step_flops(m: dict, batch: int) -> int:
    g, g_emb = _per_row(m, m["num-patches"])
    lo, l_emb = _per_row(m, m["local-keep-landmarks"])
    rows_g, rows_l = 2 * batch, m["local-crops-number"] * batch
    hr = head_per_row(m)
    student = rows_g * g + rows_l * lo + (rows_g + rows_l) * hr
    student_emb = rows_g * g_emb + rows_l * l_emb
    teacher = rows_g * (g + hr)
    return 3 * student - student_emb + teacher
