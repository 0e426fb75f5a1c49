"""Random weights of Part-fViT, its landmark CNN and the DINO head, made by
the benchmark from a seed on the card: one ``torch.Generator`` there, one
normal draw for all leaves of a model, sliced and scaled leaf by leaf.
Both the program under test and the plain reference get these weights, so
the reference takes nothing that the program has made.

Names and shapes are the reference ``state_dict``'s (``ViT_face.py``,
``mobilenet.py``, the DINO head of ``lafs_train.py``), which the port keeps;
loading into the port with ``strict=True`` checks that they agree.
"""

from __future__ import annotations

import math

import torch

# MobileNetV3-large: (kernel, expansion, out, squeeze-excite, activation,
# stride), the table of Howard et al. 2019 as the reference mobilenet.py has it
LARGE = [
    (3, 16, 16, False, "RE", 1), (3, 64, 24, False, "RE", 2),
    (3, 72, 24, False, "RE", 1), (5, 72, 40, True, "RE", 2),
    (5, 120, 40, True, "RE", 1), (5, 120, 40, True, "RE", 1),
    (3, 240, 80, False, "HS", 2), (3, 200, 80, False, "HS", 1),
    (3, 184, 80, False, "HS", 1), (3, 184, 80, False, "HS", 1),
    (3, 480, 112, True, "HS", 1), (3, 672, 112, True, "HS", 1),
    (5, 672, 160, True, "HS", 2), (5, 960, 160, True, "HS", 1),
    (5, 960, 160, True, "HS", 1),
]


def _bn(pre: str, c: int) -> list:
    return [(pre + "weight", (c,), "one"), (pre + "bias", (c,), "small"),
            (pre + "running_mean", (c,), "small"),
            (pre + "running_var", (c,), "var"),
            (pre + "num_batches_tracked", (), "count")]


def mobilenet_spec(m: dict) -> list:
    """(name, shape, kind) of the landmark CNN and its landmark head."""
    prefix = "stn."
    spec = [(prefix + "features.0.0.weight", (16, 3, 3, 3), "w"),
            *_bn(prefix + "features.0.1.", 16)]
    cin = 16
    for i, (k, exp, c, se, _, _) in enumerate(LARGE, 1):
        pre = f"{prefix}features.{i}.conv."
        spec += [(pre + "0.weight", (exp, cin, 1, 1), "w"), *_bn(pre + "1.", exp),
                 (pre + "3.weight", (exp, 1, k, k), "w"), *_bn(pre + "4.", exp)]
        if se:
            spec += [(pre + "5.fc.0.weight", (exp // 4, exp), "w"),
                     (pre + "5.fc.2.weight", (exp, exp // 4), "w")]
        spec += [(pre + "7.weight", (c, exp, 1, 1), "w"), *_bn(pre + "8.", c)]
        cin = c
    n2 = 2 * m["num-patches"]
    return spec + [("output_layer.weight", (n2, cin), "w"),
                   ("output_layer.bias", (n2,), "bias")]


def vit_spec(m: dict, prefix: str = "") -> list:
    """(name, shape, kind) of the token path of Part-fViT: patch embedding,
    CLS token, positions, the pre-norm blocks and the final LayerNorm."""
    d, inner, h = m["dim"], m["heads"] * m["dim-head"], m["mlp-dim"]
    pdim = m["patch-size"] ** 2 * 3
    spec = [(prefix + "cls_token", (1, 1, d), "tok"),
            (prefix + "pos_embedding", (1, m["num-patches"] + 1, d), "tok"),
            (prefix + "patch_to_embedding.weight", (d, pdim), "w"),
            (prefix + "patch_to_embedding.bias", (d,), "bias")]
    for i in range(m["depth"]):
        a = f"{prefix}transformer.layers.{i}.0.fn."
        f = f"{prefix}transformer.layers.{i}.1.fn."
        spec += [(a + "norm.weight", (d,), "one"), (a + "norm.bias", (d,), "small"),
                 (a + "fn.to_qkv.weight", (3 * inner, d), "w"),
                 (a + "fn.to_out.0.weight", (d, inner), "w"),
                 (a + "fn.to_out.0.bias", (d,), "bias"),
                 (f + "norm.weight", (d,), "one"), (f + "norm.bias", (d,), "small"),
                 (f + "fn.net.0.weight", (h, d), "w"),
                 (f + "fn.net.0.bias", (h,), "bias"),
                 (f + "fn.net.3.weight", (d, h), "w"),
                 (f + "fn.net.3.bias", (d,), "bias")]
    spec += [(prefix + "mlp_head.0.weight", (d,), "one"),
             (prefix + "mlp_head.0.bias", (d,), "small")]
    return spec


def dino_head_spec(m: dict, prefix: str = "head.") -> list:
    d, hid, bott = m["dim"], m["head-hidden-dim"], m["head-bottleneck-dim"]
    return [(prefix + "mlp.0.weight", (hid, d), "t02"),
            (prefix + "mlp.0.bias", (hid,), "bias"),
            (prefix + "mlp.2.weight", (hid, hid), "t02"),
            (prefix + "mlp.2.bias", (hid,), "bias"),
            (prefix + "mlp.4.weight", (bott, hid), "t02"),
            (prefix + "mlp.4.bias", (bott,), "bias"),
            (prefix + "last_layer.weight_g", (m["out-dim"], 1), "g1"),
            (prefix + "last_layer.weight_v", (m["out-dim"], bott), "t02")]


def served_spec(m: dict) -> list:
    """The served model: landmark CNN (``stn.*``, ``output_layer.*``) and
    the token path, in one flat state dict."""
    return mobilenet_spec(m) + vit_spec(m)


def ssl_student_spec(m: dict) -> list:
    """The SSL student: ``backbone.*`` (the token path) and ``head.*``."""
    return vit_spec(m, "backbone.") + dino_head_spec(m)


def generate(spec: list, seed: int, stream: int, device,
             dtype=torch.float32) -> dict:
    """Leaves of ``spec`` from one normal draw of a generator seeded by
    (``seed``, ``stream``): weights N(0, 1/fan_in), tokens N(0, 1), the
    head's truncated N(0, 0.02²), norm scales 1 + N(0, 0.1²), norm shifts
    and running means N(0, 0.1²), running variances 1 + |N(0, 0.1²)|,
    biases N(0, 0.02²), the weight-norm gain 1; in ``dtype`` (counts int64)."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 8 + int(stream)) % (2 ** 63))
    sizes = [math.prod(s) for _, s, k in spec if k != "count"]
    z = torch.randn(sum(sizes), generator=gen, device=device,
                    dtype=torch.float32)
    out, off = {}, 0
    for name, shape, kind in spec:
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        n = math.prod(shape)
        v = z[off:off + n].view(shape)
        off += n
        if kind == "tok":
            v = v.clone()
        elif kind == "w":
            v = v * math.prod(shape[1:]) ** -0.5
        elif kind == "t02":
            v = v.clamp(-2.0, 2.0) * 0.02
        elif kind == "one":
            v = 1.0 + 0.1 * v
        elif kind == "small":
            v = 0.1 * v
        elif kind == "var":
            v = 1.0 + 0.1 * v.abs()
        elif kind == "bias":
            v = 0.02 * v
        elif kind == "g1":
            v = torch.ones_like(v)
        out[name] = v.to(dtype)
    return out
