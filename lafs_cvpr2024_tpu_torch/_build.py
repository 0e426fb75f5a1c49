"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ONE shared library with a plain C interface, at the first CUDA use in
a process, and loaded through ``ctypes``. Pointers and the CUDA stream go
in as ``c_void_p``; every exported function returns the ``cudaError_t`` of
its launch, which :func:`check` turns into an exception.

The library lands in ``build/kernels/`` at the repository root (listed in
``.gitignore``) under a file name keyed by a hash of the sources and the
compiler flags, so an edited kernel is rebuilt and an unchanged one is
loaded as is. A failed build raises: nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches of each kernel, counted by its wrapper right after the launch
#: (and nowhere else): a run reads these to show that its path went
#: through the kernels.
LAUNCHES: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# exported C functions → their argument types (all return cudaError_t)
_SIGNATURES = {
    # img, landmarks, out, B, H, W, C, N, P, img_bf16, lm_bf16, stream
    "lafs_patch_gather": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, g, bt, w1t, b1, w2t, b2, y, T, D, H, eps, stream
    "lafs_fused_ln_mlp_bf16": (_P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _F, _P),
    "lafs_fused_ln_mlp_f32": (_P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _F, _P),
    "lafs_cuda_error_string": (_I,),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found (PATH, or {home}/bin): the CUDA kernels are "
            "built from source at first use and need the CUDA toolkit"
        )
    return path


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library (built on the first call of a process)."""
    sources = sorted(CSRC.glob("*.cu"))
    out = BUILD_DIR / f"liblafs_kernels-{_digest(sources)}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        # ptxas -v: registers, shared memory and spills of every kernel
        (BUILD_DIR / f"{out.stem}.ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent build loses nothing
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_char_p if name == "lafs_cuda_error_string" else _I
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        msg = library().lafs_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(tensor) -> int:
    """The raw handle of PyTorch's current stream on ``tensor``'s device."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
