"""PyTorch port: what the wrapper hands kernels 2 and 3 (CPU; the kernels
themselves are held against their plain versions on the card in
``tests/test_torch_cuda_kernels.py``).

The C entry points choose kernels 2 and 3's Hopper design
(``csrc/fused_ln_mlp_sm90.cuh``) for bf16 at D = 768 with H a multiple of
256. It reads its operands through TMA and 16-byte loads, so the wrapper
hands both kernels 16-byte-aligned tensors: a misaligned one is copied, an
aligned one passes as it is.
"""

import pytest
import torch

from lafs_cvpr2024_tpu_torch._build import aligned


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("offset", [0, 1, 3, 4, 8])
def test_aligned_copies_only_a_misaligned_tensor(dtype, offset):
    base = torch.arange(64, dtype=dtype)
    base = base if base.data_ptr() % 16 == 0 else base.clone()
    t = base[offset:offset + 24]
    got = aligned(t)
    assert torch.equal(got, t) and got.data_ptr() % 16 == 0
    assert (got.data_ptr() == t.data_ptr()) is (t.data_ptr() % 16 == 0)
