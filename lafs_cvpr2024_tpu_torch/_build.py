"""Build, load and launch the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all of them at once, and the objects are linked into ONE
shared library with a plain C interface, at the first CUDA use in a
process, and loaded through ``ctypes``. This module is the one that knows
that interface: :func:`launch` calls a kernel's export for the operands'
dtype (``lafs_<kernel>_bf16`` or ``_f32``, or the one ``lafs_<kernel>``)
with pointers and the CUDA stream as ``c_void_p``, turns the
``cudaError_t`` that every export returns into an exception and counts the
launch in :data:`LAUNCHES`; :func:`check_operands` and :func:`aligned` are
the operand contract the wrappers in ``ops/`` share.

The library lands in ``build/kernels/`` at the repository root (listed in
``.gitignore``) under a file name keyed by a hash of the sources and the
compiler flags, so an edited kernel is rebuilt and an unchanged one is
loaded as is (:func:`shared_library`, which also builds the JPEG decoder's
own library). A failed build raises: nothing falls back to another path.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches of each kernel, counted by :func:`launch` right after the
#: launch (and nowhere else): a run reads these to show that its path went
#: through the kernels.
LAUNCHES: Counter = Counter()
_FLOATS = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# the dropout arguments of kernels 2-5: seed, keep threshold, 1/keep, on
_DROP = (_U, _U, _F, _I)
# exported C functions → their argument types (all return cudaError_t but
# the counts and the error string)
_SIGNATURES = {
    # img, landmarks, out, B, H, W, C, N, P, img_bf16, lm_bf16, stream
    "lafs_patch_gather": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, g, bt, w1t, b1, w2t, b2, y, u (or null), xn, h and sched scratch
    # (the Hopper design's; null for the others), T, D, H, eps, *_DROP,
    # stream
    "lafs_fused_ln_mlp_bf16": (_P,) * 12 + (_I, _I, _I, _F) + _DROP + (_P,),
    "lafs_fused_ln_mlp_f32": (_P,) * 12 + (_I, _I, _I, _F) + _DROP + (_P,),
    # x, u, dy, g, bt, w1t, w2t, do, hd, du, xn, dx, dg_part, db_part,
    # T, D, H, eps, *_DROP, stream
    "lafs_fused_ln_mlp_bwd_bf16": (_P,) * 14 + (_I, _I, _I, _F) + _DROP + (_P,),
    "lafs_fused_ln_mlp_bwd_f32": (_P,) * 14 + (_I, _I, _I, _F) + _DROP + (_P,),
    # T, D, H, bf16 → rows of kernel 3's dγ/dβ partial buffers
    "lafs_ln_mlp_bwd_partial_rows": (_I,) * 4,
    # T, D, O, bf16 → rows of kernel 9's dγ/dβ partial buffers
    "lafs_ln_linear_bwd_partial_rows": (_I,) * 4,
    # cluster size, threads, shared memory → clusters the card co-schedules
    "lafs_max_active_clusters": (_I,) * 3,
    # x, w1t, b1, w2t, b2, y, u (or null), h and sched scratch (as kernel
    # 2's), T, D, H, *_DROP, stream
    "lafs_fused_mlp_bf16": (_P,) * 9 + (_I,) * 3 + _DROP + (_P,),
    "lafs_fused_mlp_f32": (_P,) * 9 + (_I,) * 3 + _DROP + (_P,),
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
    # q, k, v, do, stats, dk, dv, strides (18 int64), B, H, N, D, scale,
    # stream
    "lafs_flash_attention_bwd_dkv_bf16": (_P,) * 8 + (_I,) * 4 + (_F, _P),
    "lafs_flash_attention_bwd_dkv_f32": (_P,) * 8 + (_I,) * 4 + (_F, _P),
    # q, k, v, o, do, lse, dq, stats, strides (21 int64), B, H, N, D, scale,
    # stream
    "lafs_flash_attention_bwd_dq_bf16": (_P,) * 9 + (_I,) * 4 + (_F, _P),
    "lafs_flash_attention_bwd_dq_f32": (_P,) * 9 + (_I,) * 4 + (_F, _P),
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


def _digest(files, flags=NVCC_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in files:
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


def shared_library(out_dir: Path, stem: str, sources, flags, *,
                   headers=(), libs=()) -> Path:
    """``out_dir/<stem>-<hash>.so`` built from ``sources`` with ``flags``
    and linked against ``libs``, the hash covering the sources, the
    ``headers`` they include, the flags and the libraries: one ``nvcc -c``
    per source, all started together, then one link, unless the file is
    there already. ``nvcc``'s report of each compile lands beside it as
    ``<stem>-<hash>.ptxas.txt`` (with ``-Xptxas -v``: registers, shared
    memory and spills of every kernel)."""
    out = out_dir / (f"{stem}-{_digest([*sources, *headers], (*flags, *libs))}"
                     ".so")
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out_dir / f"{tag}.{src.stem}.o" for src in sources]
    jobs = [_start([_nvcc(), *flags, "-c", "-o", str(obj), str(src)])
            for src, obj in zip(sources, objs)]
    try:
        logs = [_wait(job) for job in jobs]
    finally:
        for _, proc in jobs:  # a failed build leaves no compiler running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = out.with_name(f"{tag}.tmp")
    _wait(_start([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs),
                  *libs]))
    for obj in objs:
        obj.unlink()
    out.with_suffix(".ptxas.txt").write_text("".join(logs))
    os.replace(tmp, out)  # atomic: a concurrent build loses nothing
    return out


def ptxas_log() -> Path:
    """``nvcc -Xptxas -v``'s report (registers, shared memory and spills of
    every kernel) of the library that :func:`library` builds."""
    return Path(library()._name).with_suffix(".ptxas.txt")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library (built on the first call of a process)."""
    lib = ctypes.CDLL(str(shared_library(
        BUILD_DIR, "liblafs_kernels", sorted(CSRC.glob("*.cu")), NVCC_FLAGS,
        headers=sorted(CSRC.glob("*.cuh")))))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_char_p if name == "lafs_cuda_error_string" else _I
    return lib


def device_guard(tensor):
    """``torch.cuda.device(tensor.device)``, or no context at all when that
    device is current already (the usual case): entering the context takes
    more host time than the launch of a small kernel."""
    if tensor.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(tensor.device)


def stream_ptr(tensor) -> int:
    """The raw handle of PyTorch's current stream on ``tensor``'s device
    (the binding under ``torch.cuda.current_stream(device).cuda_stream``,
    without building a Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(tensor.device.index)


def export(kernel: str, dtype: torch.dtype) -> str:
    """The C function that runs ``kernel`` on operands of ``dtype``:
    ``lafs_<kernel>_bf16`` or ``lafs_<kernel>_f32`` where the library
    exports one for that dtype, else the kernel's one ``lafs_<kernel>``
    (kernel 1, which takes its dtypes as arguments)."""
    name = f"lafs_{kernel}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
    if name in _SIGNATURES:
        return name
    if f"lafs_{kernel}" in _SIGNATURES:
        return f"lafs_{kernel}"
    raise ValueError(f"the kernel library exports no {kernel} for {dtype}")


_exports: dict = {}  # (kernel, dtype) → the library's function


def launch(kernel: str, like: torch.Tensor, *args) -> None:
    """Call ``kernel``'s export for ``like``'s dtype with ``args`` and the
    current stream of ``like``'s device, on that device; raise on the CUDA
    error it returns, else count the launch in :data:`LAUNCHES`."""
    fn = _exports.get((kernel, like.dtype))
    if fn is None:
        fn = _exports[kernel, like.dtype] = getattr(
            library(), export(kernel, like.dtype))
    with device_guard(like):
        err = fn(*args, stream_ptr(like))
    if err != 0:
        msg = library().lafs_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel: CUDA error {err} ({msg})")
    LAUNCHES[kernel] += 1


def check_operands(what: str, lead: torch.Tensor, *others,
                   one_dtype: bool = True) -> None:
    """The operand contract the kernels share: every operand on ``lead``'s
    CUDA device, in float32 or bfloat16, and with ``one_dtype`` all in
    ``lead``'s dtype. Shapes are each kernel's own."""
    ops = (lead, *others)
    if not lead.is_cuda or any(t.device != lead.device for t in others):
        raise ValueError(f"{what}: every operand must be on one CUDA device, "
                         f"got {[str(t.device) for t in ops]}")
    if one_dtype:
        bad = lead.dtype not in _FLOATS \
            or any(t.dtype != lead.dtype for t in others)
    else:
        bad = any(t.dtype not in _FLOATS for t in ops)
    if bad:
        raise TypeError(
            f"{what} takes float32 or bfloat16"
            f"{' with every operand in one dtype' if one_dtype else ''}, "
            f"got {[str(t.dtype) for t in ops]}")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte-aligned address, as the kernels' TMA
    tiles and 16-byte loads read it: ``t`` itself, or a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
