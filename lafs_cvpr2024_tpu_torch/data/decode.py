"""JPEG decode of a batch (the port's counterpart of the host decode in
``lafs_cvpr2024_tpu/data/dataset.py::decode_jpeg`` and
``native/lafs_dataplane.cc::decode_jpeg``).

On the card the batch decodes with nvJPEG from the CUDA toolkit
(``csrc/jpeg_decode.cpp``: nvJPEG's planes, then libjpeg's fancy chroma
upsampling and fixed-point colour conversion in one small kernel, so the
pixels are libjpeg's but for the inverse DCT's rounding) straight into a
(B, H, W, 3) uint8 RGB tensor in device memory, on the current stream:
the device multi-crop consumes it there. The decoder is its own shared
library, built by ``nvcc`` at the first use into ``build/jpeg/`` and
linked against ``libnvjpeg``, apart from the kernels' library, so a
missing nvJPEG cannot take the kernels down. A failed build or decode
raises; nothing falls back to another decoder.

On the CPU (the tests only) the batch decodes with PIL, imported inside
that branch: the machine with the card needs no PIL.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from .. import _build

#: the decoder the card path runs
DECODER = "nvjpeg"
SOURCE = _build.CSRC / "jpeg_decode.cpp"
BUILD_DIR = _build.BUILD_DIR.parent / "jpeg"
FLAGS = ("-x", "cu", *_build.NVCC_FLAGS)  # a .cpp source with a kernel


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built nvJPEG decoder (built on the first call of a process)."""
    lib = ctypes.CDLL(str(_build.shared_library(
        BUILD_DIR, "liblafs_jpeg", [SOURCE], FLAGS, libs=("-lnvjpeg",))))
    lib.lafs_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.lafs_jpeg_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.lafs_jpeg_info.restype = ctypes.c_int
    lib.lafs_jpeg_decode_batch.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err == -1:
        raise ValueError(f"{what}: the JPEGs of a batch differ in size")
    if err == -2:
        raise ValueError(f"{what}: a chroma layout other than 4:4:4, 4:2:2, "
                         "4:2:0 or grayscale")
    if err >= 1000:
        raise RuntimeError(f"{what}: CUDA error {err - 1000}")
    if err != 0:
        raise RuntimeError(f"{what}: nvJPEG status {err}")


def jpeg_size(data: bytes):
    """(height, width) of a JPEG, read by nvJPEG from its header."""
    h, w = ctypes.c_int(), ctypes.c_int()
    _check(library().lafs_jpeg_info(data, len(data), ctypes.byref(h),
                                    ctypes.byref(w)), "jpeg_size")
    return h.value, w.value


def jpeg_dims(data: bytes, device) -> tuple:
    """(height, width) of a JPEG from its header, read by the decoder of
    ``device`` (nvJPEG on a CUDA device, PIL on the CPU). Bytes that do not
    start with a JPEG's SOI marker raise, on either device (nvJPEG decodes
    JPEG alone)."""
    if bytes(data[:2]) != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI marker): the port decodes JPEG "
                         "only (ROADMAP.md §3)")
    if torch.device(device).type == "cuda":
        return jpeg_size(data)
    import io

    from PIL import Image

    w, h = Image.open(io.BytesIO(data)).size
    return h, w


def read_jpeg(path: str, device):
    """A JPEG file's bytes and (height, width), its header read by the
    decoder of ``device``; a file that is not a JPEG the decoder reads
    raises with its path."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return data, jpeg_dims(data, device)
    except (RuntimeError, ValueError, OSError) as e:
        raise ValueError(f"{path}: not decodable ({e})") from e


def decode_batch_cuda(jpegs: Sequence[bytes], device) -> torch.Tensor:
    """nvJPEG decode of equally sized JPEGs into a (B, H, W, 3) uint8 RGB
    tensor on ``device``, on its current stream."""
    device = torch.device(device)
    if not jpegs:
        raise ValueError("decode_batch_cuda: an empty batch")
    h, w = jpeg_size(jpegs[0])
    n = len(jpegs)
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    scratch = torch.empty(3 * h * w, dtype=torch.uint8, device=device)
    ptrs = (ctypes.c_char_p * n)(*jpegs)
    lengths = (ctypes.c_size_t * n)(*map(len, jpegs))
    with torch.cuda.device(device):
        err = library().lafs_jpeg_decode_batch(
            ctypes.cast(ptrs, ctypes.c_void_p), ctypes.addressof(lengths), n,
            out.data_ptr(), scratch.data_ptr(), h, w, _build.stream_ptr(out))
    _check(err, "decode_batch_cuda")
    return out


def decode_batch_plain(jpegs: Sequence[bytes]) -> torch.Tensor:
    """PIL decode to a (B, H, W, 3) uint8 RGB CPU tensor (the tests' path;
    the JAX package's ``decode_jpeg``)."""
    import io

    from PIL import Image

    return torch.from_numpy(np.stack([
        np.asarray(Image.open(io.BytesIO(b)).convert("RGB")) for b in jpegs]))


def decode_batch(jpegs: Sequence[bytes], device, bgr: bool = False
                 ) -> torch.Tensor:
    """A batch of JPEGs as (B, H, W, 3) uint8 on ``device``: nvJPEG on a
    CUDA device, PIL on the CPU. ``bgr``: the records hold BGR, flipped to
    RGB as the JAX dataset flips them."""
    device = torch.device(device)
    out = (decode_batch_cuda(jpegs, device) if device.type == "cuda"
           else decode_batch_plain(jpegs))
    return out.flip(-1) if bgr else out
