"""PyTorch port: the ctypes contract of the kernel library.

``_build._SIGNATURES`` gives ctypes the argument types of every C function
that ``csrc/*.cu`` exports. A function without an entry is called with
ctypes' defaults, which pass a pointer as a 32-bit int; an entry with the
wrong count or kind of arguments shifts every argument after it. Neither
shows until the card runs the kernel. Here, on the CPU, each ``extern "C"``
function of the sources (parsed from the text) is held against its entry:
same argument count, and each argument of the same kind (pointer, int,
unsigned, float), and no entry names a function that no source defines.
"""

import ctypes
import re
from pathlib import Path

import pytest

from lafs_cvpr2024_tpu_torch import _build

_EXTERN = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(lafs_\w+)\s*\(([^)]*)\)')


def _exported() -> dict:
    """name → the parameter list of every ``extern "C"`` function."""
    out = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in _EXTERN.findall(src.read_text()):
            out[name] = [p.strip() for p in params.split(",") if p.strip()]
    return out


def _kind(param: str):
    """The ctypes type a C parameter declaration needs."""
    if "*" in param:
        return ctypes.c_void_p
    if param.startswith("unsigned"):
        return ctypes.c_uint
    if param.startswith("float"):
        return ctypes.c_float
    if param.startswith("int"):
        return ctypes.c_int
    raise AssertionError(f"no ctypes kind for parameter {param!r}")


EXPORTED = _exported()


def test_sources_export_the_kernels():
    assert len(EXPORTED) >= 26
    assert {"lafs_flash_attention_bf16", "lafs_mlp_fusion_bf16",
            "lafs_cuda_error_string"} <= set(EXPORTED)


@pytest.mark.parametrize("name", sorted(EXPORTED))
def test_exported_function_has_its_signature(name):
    assert name in _build._SIGNATURES, f"{name} has no _SIGNATURES entry"
    want = [_kind(p) for p in EXPORTED[name]]
    got = list(_build._SIGNATURES[name])
    assert len(got) == len(want), (name, len(got), len(want))
    assert got == want, name


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_entry_has_a_source(name):
    assert name in EXPORTED, f"_SIGNATURES names {name}, which no csrc/*.cu defines"


def test_csrc_headers_are_hashed_into_the_library_name():
    """An edit of a header (sm90.cuh included) rebuilds the library."""
    headers = sorted(Path(_build.CSRC).glob("*.cuh"))
    assert any(h.name == "sm90.cuh" for h in headers)
    sources = sorted(Path(_build.CSRC).glob("*.cu"))
    assert _build._digest(sources + headers) != _build._digest(sources)
