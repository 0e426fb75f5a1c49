"""The analytic FLOP counts behind ``train.mfu`` and ``embed.mfu`` agree
with ``torch.utils.flop_counter.FlopCounterMode`` on the reference at
depth 2 (products only: matrix products, convolutions)."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_torch.flops.served_forward import view_flops
from bench_torch.flops.ssl_step import step_flops
from bench_torch.reference.model import embed_faces, vit
from bench_torch.reference.ssl import _backbone, head
from bench_torch.weights import generate, served_spec, ssl_student_spec


def test_ssl_step_flops_match_the_counter(tiny):
    m = tiny("ssl_cli")["model"]
    b, cpu = 2, torch.device("cpu")
    w = generate(ssl_student_spec(m), 3, 0, cpu)
    pd = m["patch-size"] ** 2 * 3
    g_tok = torch.randn(2 * b, m["num-patches"], pd)
    l_tok = torch.randn(m["local-crops-number"] * b, m["local-keep-landmarks"], pd)
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            head(w, vit(_backbone(w), g_tok, m), "fp32")
        leaves = {k: v.requires_grad_() for k, v in w.items()}
        bb = _backbone(leaves)
        out = head(leaves, torch.cat([vit(bb, g_tok, m), vit(bb, l_tok, m)]),
                   "fp32")
        torch.autograd.grad(out.square().mean(), list(leaves.values()))
    assert fc.get_total_flops() == step_flops(m, b)


def test_served_forward_flops_match_the_counter(tiny):
    m = tiny("serve_gallery")["model"]
    w = generate(served_spec(m), 5, 0, torch.device("cpu"))
    faces = torch.randint(0, 256, (3, 112, 112, 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        embed_faces(w, faces, m, flip=True)
    assert fc.get_total_flops() == 2 * 3 * view_flops(m)
