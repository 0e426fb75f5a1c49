"""Where the training entry points build their state: on the card unless
the caller asks for the CPU (``device="cpu"``, as the tests do)."""

from __future__ import annotations

import torch

CUDA = torch.device("cuda")


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and this
    machine has no CUDA device, rather than building on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the training entry points build "
            "their state on the card; pass device='cpu' to build it on the "
            "CPU")
    return device
