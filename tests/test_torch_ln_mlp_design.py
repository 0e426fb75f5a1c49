"""PyTorch port: what the wrapper hands kernels 2 and 3 (CPU; the kernels
themselves are held against their plain versions on the card in
``tests/test_torch_cuda_kernels.py``).

The C entry points choose kernels 2 and 3's Hopper design
(``csrc/fused_ln_mlp_sm90.cuh``) for bf16 at D = 768 with H a multiple of
256. It reads its operands through TMA and 16-byte loads, so the wrapper
hands both kernels 16-byte-aligned tensors: a misaligned one is copied, an
aligned one passes as it is. The wrapper repeats that choice in Python
(``hopper_design``) to hand the Hopper forward its scratch and to count a
CUDA forward off it as ``mlp.first_design``.
"""

from pathlib import Path

import pytest
import torch

from lafs_cvpr2024_tpu_torch import _build
from lafs_cvpr2024_tpu_torch._build import aligned
from lafs_cvpr2024_tpu_torch.ops import fused_mlp
from lafs_cvpr2024_tpu_torch.utils import tracing


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("offset", [0, 1, 3, 4, 8])
def test_aligned_copies_only_a_misaligned_tensor(dtype, offset):
    base = torch.arange(64, dtype=dtype)
    base = base if base.data_ptr() % 16 == 0 else base.clone()
    t = base[offset:offset + 24]
    got = aligned(t)
    assert torch.equal(got, t) and got.data_ptr() % 16 == 0
    assert (got.data_ptr() == t.data_ptr()) is (t.data_ptr() % 16 == 0)


# The widths the C entry points give the Hopper design
# (csrc/fused_ln_mlp_sm90.cuh::takes: D = 768, H a positive multiple of
# 256), in bf16; everything else runs the first design.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [128, 384, 640, 768])
@pytest.mark.parametrize("h", [128, 256, 384, 512, 1920, 2048])
def test_hopper_design_predicate_is_the_c_entry_points_choice(dtype, d, h):
    want = dtype == torch.bfloat16 and d == 768 and h % 256 == 0
    assert fused_mlp.hopper_design(dtype, d, h) is want


def test_takes_is_the_widths_the_predicate_documents():
    """The C predicate the Python one repeats, as the header states it."""
    src = (Path(_build.CSRC) / "fused_ln_mlp_sm90.cuh").read_text()
    assert "inline bool takes(int Dm, int H) { return Dm == D && H > 0 && " \
           "H % HC == 0; }" in src
    assert "constexpr int D = 768;" in src and "constexpr int HC = 256;" in src


@pytest.mark.parametrize("dtype,d,h,counted", [
    (torch.bfloat16, 768, 2048, 0),   # every path the cells run
    (torch.bfloat16, 768, 1920, 1),   # H % 256 = 128
    (torch.bfloat16, 384, 1536, 1),   # D 384 (ViT-S)
    (torch.float32, 768, 2048, 1),    # --eval-dtype float32
])
def test_first_design_counter(dtype, d, h, counted):
    """With the tracer on, a forward off the Hopper design counts
    ``mlp.first_design`` once; off, nothing is counted."""
    tracing.reset()
    tracing.enable(True)
    try:
        assert fused_mlp.count_first_design(dtype, d, h) is (counted == 0)
        got = tracing.export()["counters"].get("mlp.first_design", 0)
    finally:
        tracing.enable(False)
    assert got == counted
    fused_mlp.count_first_design(dtype, d, h)
    assert tracing.export()["counters"].get("mlp.first_design", 0) == counted
    tracing.reset()
