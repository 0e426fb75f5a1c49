"""Model FLOPs of the served forward of one image (one view): the landmark
CNN (MobileNetV3-large convolutions, squeeze-excite and the landmark
head) and Part-fViT's encoder (patch embedding, linear layers, attention).
A served face costs two views with the flip."""

from ..weights import LARGE


def landmark_flops(m: dict) -> int:
    s = m["image-size"] // 2
    f = 2 * 16 * 3 * 9 * s * s                      # stem, stride 2
    cin = 16
    for k, exp, c, se, _, st in LARGE:
        f += 2 * exp * cin * s * s                   # expand 1x1
        s = (s + st - 1) // st
        f += 2 * exp * k * k * s * s                 # depthwise
        if se:
            f += 2 * 2 * exp * (exp // 4)
        f += 2 * c * exp * s * s                     # project 1x1
        cin = c
    return f + 2 * cin * 2 * m["num-patches"]


def encoder_flops(m: dict) -> int:
    n = m["num-patches"]
    s = n + 1
    d, inner, hid = m["dim"], m["heads"] * m["dim-head"], m["mlp-dim"]
    lin = 2 * s * (d * 3 * inner + inner * d + 2 * d * hid)
    attn = 4 * s * s * m["dim-head"] * m["heads"]
    return m["depth"] * (lin + attn) + 2 * n * m["patch-size"] ** 2 * 3 * d


def view_flops(m: dict) -> int:
    return landmark_flops(m) + encoder_flops(m)
