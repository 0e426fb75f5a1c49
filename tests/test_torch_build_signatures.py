"""PyTorch port: the ctypes contract of the kernel library, and the one
seam through which the ``ops/`` wrappers launch it.

``_build._SIGNATURES`` gives ctypes the argument types of every C function
that ``csrc/*.cu`` exports. A function without an entry is called with
ctypes' defaults, which pass a pointer as a 32-bit int; an entry with the
wrong count or kind of arguments shifts every argument after it. Neither
shows until the card runs the kernel. Here, on the CPU, each ``extern "C"``
function of the sources (parsed from the text) is held against its entry:
same argument count, and each argument of the same kind (pointer, int,
unsigned, float), and no entry names a function that no source defines.

Every wrapper launches through ``_build.launch``, which resolves the export
for the operands' dtype, passes the stream last, raises on a CUDA error and
counts the launch. The kernel names the wrappers launch (parsed from
``ops/*.py``) are held here against ``_SIGNATURES``, and the seam itself
runs against a stub library on the CPU.
"""

import contextlib
import ctypes
import re
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

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


_LAUNCH = re.compile(r'_build\.launch\(\s*"(\w+)"')
OPS = Path(_build.__file__).parent / "ops"
#: kernel name → the modules under ops/ that launch it
LAUNCHED = {}
for _src in sorted(OPS.glob("*.py")):
    for _name in _LAUNCH.findall(_src.read_text()):
        LAUNCHED.setdefault(_name, []).append(_src.name)
#: row 10's kernel takes bf16 only (its wrapper refuses the rest first)
_BF16_ONLY = {"mlp_fusion"}


def test_ops_launch_each_kernel_through_the_seam_once():
    """The launch counters a run reads: one key per kernel, each launched
    from one place."""
    assert set(LAUNCHED) == {
        "patch_gather", "fused_ln_mlp", "fused_ln_mlp_bwd", "fused_mlp",
        "fused_mlp_bwd", "fused_ln_linear", "fused_ln_linear_bwd",
        "fused_attention", "fused_attention_bwd", "flash_attention",
        "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "mlp_fusion"}
    assert all(len(v) == 1 for v in LAUNCHED.values()), LAUNCHED


@pytest.mark.parametrize("kernel,dtype", [
    (k, dt) for k in sorted(LAUNCHED)
    for dt in (torch.bfloat16,) + (() if k in _BF16_ONLY else (torch.float32,))
])
def test_launched_kernel_resolves_to_an_export(kernel, dtype):
    name = _build.export(kernel, dtype)
    assert name in _build._SIGNATURES and name.startswith(f"lafs_{kernel}")
    assert name in EXPORTED


def test_export_picks_the_dtype_and_refuses_what_is_missing():
    assert _build.export("fused_ln_mlp", torch.bfloat16) == \
        "lafs_fused_ln_mlp_bf16"
    assert _build.export("fused_ln_mlp", torch.float32) == \
        "lafs_fused_ln_mlp_f32"
    assert _build.export("patch_gather", torch.bfloat16) == \
        "lafs_patch_gather"
    with pytest.raises(ValueError, match="mlp_fusion"):
        _build.export("mlp_fusion", torch.float32)


class _StubLibrary:
    """Every export returns ``err`` and records its name and arguments."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def lafs_cuda_error_string(self, err):
        return b"stub error"

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return self.err
        return fn


@pytest.fixture
def stub(monkeypatch):
    """The seam on the CPU: a stub library, no device context, stream 77,
    fresh counters and an empty export cache."""
    def use(err):
        lib = _StubLibrary(err)
        monkeypatch.setattr(_build, "library", lambda: lib)
        return lib
    monkeypatch.setattr(_build, "_exports", {})
    monkeypatch.setattr(_build, "device_guard",
                        lambda t: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 77)
    monkeypatch.setattr(_build, "LAUNCHES", Counter())
    return use


@pytest.mark.parametrize("dtype,name", [
    (torch.bfloat16, "lafs_fused_ln_mlp_bf16"),
    (torch.float32, "lafs_fused_ln_mlp_f32"),
])
def test_launch_counts_a_launch_that_returns_zero(stub, dtype, name):
    lib = stub(0)
    like = torch.zeros(2, dtype=dtype)
    _build.launch("fused_ln_mlp", like, 1, 2, 3.0)
    assert lib.calls == [(name, (1, 2, 3.0, 77))]
    assert _build.LAUNCHES == Counter({"fused_ln_mlp": 1})
    _build.launch("fused_ln_mlp", like, 4)
    assert _build.LAUNCHES == Counter({"fused_ln_mlp": 2})
    assert lib.calls[-1] == (name, (4, 77))


def test_launch_raises_on_a_cuda_error_and_counts_nothing(stub):
    stub(700)
    with pytest.raises(RuntimeError,
                       match=r"flash_attention_bwd_dq kernel: CUDA error 700 "
                             r"\(stub error\)"):
        _build.launch("flash_attention_bwd_dq", torch.zeros(1), 0)
    assert _build.LAUNCHES == Counter()


def _fake(device="cuda:0", dtype=torch.bfloat16):
    """What check_operands reads of a tensor on a device the CPU lacks."""
    return SimpleNamespace(is_cuda=device.startswith("cuda"),
                           device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize("ops,kw,error,match", [
    ((_fake("cpu"), _fake("cpu")), {}, ValueError, "CUDA device"),
    ((_fake(), _fake("cuda:1")), {}, ValueError, "CUDA device"),
    ((_fake(), _fake("cpu")), {}, ValueError, "CUDA device"),
    ((_fake(dtype=torch.float16),), {}, TypeError, "bfloat16"),
    ((_fake(), _fake(dtype=torch.float32)), {}, TypeError, "one dtype"),
    ((_fake(), _fake(dtype=torch.float16)), {"one_dtype": False},
     TypeError, "bfloat16"),
])
def test_check_operands_refuses_what_no_kernel_takes(ops, kw, error, match):
    with pytest.raises(error, match=match):
        _build.check_operands("k", *ops, **kw)


@pytest.mark.parametrize("ops,kw", [
    ((_fake(), _fake(), _fake()), {}),
    ((_fake(dtype=torch.float32), _fake(dtype=torch.float32)), {}),
    ((_fake(), _fake(dtype=torch.float32)), {"one_dtype": False}),
])
def test_check_operands_passes_what_the_kernels_take(ops, kw):
    _build.check_operands("k", *ops, **kw)


@pytest.mark.parametrize("name,pointers,ints", [
    ("lafs_fused_ln_mlp_bf16", 12, 3),  # x .. b2, y, u, xn, h, sched
    ("lafs_fused_ln_mlp_f32", 12, 3),
    ("lafs_fused_mlp_bf16", 9, 3),      # x .. b2, y, u, h, sched
    ("lafs_fused_mlp_f32", 9, 3),
])
def test_forward_entry_points_take_their_scratch(name, pointers, ints):
    """Kernels 2 and 4 take the Hopper forward's scratch pointers after u
    and before T, D, H: every dtype's export, so one wrapper call serves
    both."""
    sig = _build._SIGNATURES[name]
    assert sig[:pointers] == (ctypes.c_void_p,) * pointers
    assert sig[pointers:pointers + ints] == (ctypes.c_int,) * ints
    params = EXPORTED[name]
    assert [p.split()[-1].lstrip("*") for p in params[7:pointers]] == (
        ["y", "u", "xn", "h", "sched"] if "ln_mlp" in name
        else ["y", "u", "h", "sched"])[-(pointers - 7):]
