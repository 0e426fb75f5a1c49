"""Model FLOPs and kernel work of one supervised finetuning step of
Part-fViT: ``acc-step`` microbatches of ``batch-size`` images, each through
the encoder's forward and backward at 197 tokens and the CosFace product
against every class centre. Unlike the SSL step's patch embedding, this
one's backward forms the tokens' gradient too (the gather is
differentiable into the landmark CNN), so the whole encoder counts three
times. The landmark CNN, the gather, mixup and the loss are not model
FLOPs and are not counted."""

from bench_torch.flops import attention, mlp
from bench_torch.flops.ssl_step import _per_row


def rows(m: dict) -> int:
    return m["batch-size"] * m["acc-step"]


def step_flops(m: dict) -> int:
    """Encoder forward and backward of every image, and the head's product
    (B·D·C) forward, for the embeddings' gradient and for the centres'."""
    enc, _ = _per_row(m, m["num-patches"])
    head = 2 * m["dim"] * m["num-classes"]
    return 3 * rows(m) * (enc + head)


def attention_work(m: dict) -> tuple:
    """(FLOPs, bytes) of kernels 6 and 7 in one step: forward and backward
    of every microbatch, in every block."""
    bh, n = m["batch-size"] * m["heads"], m["num-patches"] + 1
    f = attention.fwd(bh, n, m["dim-head"])
    b = attention.bwd(bh, n, m["dim-head"])
    k = m["depth"] * m["acc-step"]
    return k * (f[0] + b[0]), k * (f[1] + b[1])


def mlp_work(m: dict) -> tuple:
    """(FLOPs, bytes) of kernels 2 (u saved) and 3 in one step, at
    T = batch-size · 197 rows, every microbatch and block."""
    t = m["batch-size"] * (m["num-patches"] + 1)
    f = mlp.fwd(t, m["dim"], m["mlp-dim"], True)
    b = mlp.bwd(t, m["dim"], m["mlp-dim"])
    k = m["depth"] * m["acc-step"]
    return k * (f[0] + b[0]), k * (f[1] + b[1])
