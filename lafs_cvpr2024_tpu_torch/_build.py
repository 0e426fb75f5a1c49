"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all of them at once, and the objects are linked into ONE
shared library with a plain C interface, at the first CUDA use in a
process, and loaded through ``ctypes``. Pointers and the CUDA stream go
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches of each kernel, counted by its wrapper right after the launch
#: (and nowhere else): a run reads these to show that its path went
#: through the kernels.
LAUNCHES: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# the dropout arguments of kernels 2-5: seed, keep threshold, 1/keep, on
_DROP = (_U, _U, _F, _I)
# exported C functions → their argument types (all return cudaError_t but
# the block count and the error string)
_SIGNATURES = {
    # img, landmarks, out, B, H, W, C, N, P, img_bf16, lm_bf16, stream
    "lafs_patch_gather": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, g, bt, w1t, b1, w2t, b2, y, u (or null), T, D, H, eps, *_DROP, stream
    "lafs_fused_ln_mlp_bf16": (_P,) * 9 + (_I, _I, _I, _F) + _DROP + (_P,),
    "lafs_fused_ln_mlp_f32": (_P,) * 9 + (_I, _I, _I, _F) + _DROP + (_P,),
    # x, u, dy, g, bt, w1t, w2t, do, hd, du, xn, dx, dg_part, db_part,
    # T, D, H, eps, *_DROP, stream
    "lafs_fused_ln_mlp_bwd_bf16": (_P,) * 14 + (_I, _I, _I, _F) + _DROP + (_P,),
    "lafs_fused_ln_mlp_bwd_f32": (_P,) * 14 + (_I, _I, _I, _F) + _DROP + (_P,),
    # T → rows of the (blocks, D) dγ/dβ partial buffers of kernels 3 and 9
    "lafs_row_blocks": (_I,),
    # x, w1t, b1, w2t, b2, y, u (or null), T, D, H, *_DROP, stream
    "lafs_fused_mlp_bf16": (_P,) * 7 + (_I,) * 3 + _DROP + (_P,),
    "lafs_fused_mlp_f32": (_P,) * 7 + (_I,) * 3 + _DROP + (_P,),
    # u, dy, w2t, do, hd, du, T, D, H, *_DROP, stream
    "lafs_fused_mlp_bwd_bf16": (_P,) * 6 + (_I,) * 3 + _DROP + (_P,),
    "lafs_fused_mlp_bwd_f32": (_P,) * 6 + (_I,) * 3 + _DROP + (_P,),
    # x, g, bt, w, y, T, D, O, eps, stream
    "lafs_fused_ln_linear_bf16": (_P,) * 5 + (_I,) * 3 + (_F, _P),
    "lafs_fused_ln_linear_f32": (_P,) * 5 + (_I,) * 3 + (_F, _P),
    # x, dy, g, bt, w, xn, dx, dg_part, db_part, T, D, O, eps, stream
    "lafs_fused_ln_linear_bwd_bf16": (_P,) * 9 + (_I,) * 3 + (_F, _P),
    "lafs_fused_ln_linear_bwd_f32": (_P,) * 9 + (_I,) * 3 + (_F, _P),
    # q, k, v, o, strides (12 int64), B, H, S, D, scale, stream
    "lafs_fused_attention_bf16": (_P,) * 5 + (_I,) * 4 + (_F, _P),
    "lafs_fused_attention_f32": (_P,) * 5 + (_I,) * 4 + (_F, _P),
    # q, k, v, do, dq, dk, dv, stats, strides (21 int64), B, H, S, D, scale,
    # stream
    "lafs_fused_attention_bwd_bf16": (_P,) * 9 + (_I,) * 4 + (_F, _P),
    "lafs_fused_attention_bwd_f32": (_P,) * 9 + (_I,) * 4 + (_F, _P),
    # q, k, v, o, lse, strides (12 int64), B, H, N, D, scale, stream
    "lafs_flash_attention_bf16": (_P,) * 6 + (_I,) * 4 + (_F, _P),
    "lafs_flash_attention_f32": (_P,) * 6 + (_I,) * 4 + (_F, _P),
    # q, k, v, do, lse, di, dk, dv, strides (18 int64), B, H, N, D, scale,
    # stream
    "lafs_flash_attention_bwd_dkv_bf16": (_P,) * 9 + (_I,) * 4 + (_F, _P),
    "lafs_flash_attention_bwd_dkv_f32": (_P,) * 9 + (_I,) * 4 + (_F, _P),
    # q, k, v, do, lse, di, dq, strides (15 int64), B, H, N, D, scale, stream
    "lafs_flash_attention_bwd_dq_bf16": (_P,) * 8 + (_I,) * 4 + (_F, _P),
    "lafs_flash_attention_bwd_dq_f32": (_P,) * 8 + (_I,) * 4 + (_F, _P),
    # x, w1 (D, H), w2 (H, D), y, T, D, H, *_DROP, stream (row 10, bf16)
    "lafs_mlp_fusion_bf16": (_P,) * 4 + (_I,) * 3 + _DROP + (_P,),
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


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _wait(job) -> str:
    """Wait for one ``nvcc`` from :func:`_start`; its stderr."""
    cmd, proc = job
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}\n{err}")
    return err


def _compile(sources, out: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    jobs = [_start([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
            for src, obj in zip(sources, objs)]
    try:
        logs = [_wait(job) for job in jobs]
    finally:
        for _, proc in jobs:  # a failed build leaves no compiler running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = out.with_name(f"{tag}.tmp")
    _wait(_start([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]))
    for obj in objs:
        obj.unlink()
    # ptxas -v: registers, shared memory and spills of every kernel
    (BUILD_DIR / f"{out.stem}.ptxas.txt").write_text("".join(logs))
    os.replace(tmp, out)  # atomic: a concurrent build loses nothing


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library (built on the first call of a process)."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    out = BUILD_DIR / f"liblafs_kernels-{_digest(sources + headers)}.so"
    if not out.exists():
        _compile(sources, out)
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
