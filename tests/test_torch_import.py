"""PyTorch port: the package loads where there is no JAX.

A machine with the GPU has no jax, flax or orbax (and need not have PIL).
A subprocess blocks them (and the JAX package) in ``sys.modules`` and
imports every module of ``lafs_cvpr2024_tpu_torch``; any import of them
fails the test. PIL is imported only inside the CPU branch of
``data/decode.py``, which the tests alone run.
"""

import subprocess
import sys
from pathlib import Path

_SCRIPT = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "orbax", "lafs_cvpr2024_tpu", "PIL"):
    sys.modules[name] = None  # any import of these raises ImportError
import lafs_cvpr2024_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(" ".join(names))
"""


def test_package_imports_without_jax():
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    visited = set(proc.stdout.split())
    assert len(visited) >= 31  # every module was visited
    assert {f"lafs_cvpr2024_tpu_torch.{m}" for m in (
        "ops.fused_attention", "ops.mixup", "train.supervised",
        "train.ssl", "cli.serve_embeddings", "ops.fused_ln_linear",
        "ops.patchify", "train.simmim", "train.device", "cli.train_ssl",
        "data.recordio", "data.dataset", "data.decode", "data.pipeline",
        "ops.flash_attention", "ops.schedules", "utils.config",
        "utils.logging", "ops.mlp_fusion", "ops.warp", "eval.verification",
        "eval.ijb", "cli.evaluate_bin", "cli.extract_embeddings",
        "cli.evaluate_ijb")} <= visited


def test_simmim_slice_and_chip_smoke_import_without_jax():
    """The SimMIM slice's modules and ``chip_smoke.py`` (which drives them
    on the card) import with jax and the JAX package blocked."""
    root = Path(__file__).resolve().parent.parent
    script = _SCRIPT.split("import lafs_cvpr2024_tpu_torch as pkg")[0] + (
        "import chip_smoke\n"
        "from lafs_cvpr2024_tpu_torch.ops import fused_ln_linear, fused_mlp\n"
        "from lafs_cvpr2024_tpu_torch.train import simmim\n"
        "assert callable(fused_mlp.fused_mlp) and "
        "callable(fused_ln_linear.fused_ln_linear)\n"
        "print(sorted(chip_smoke.KERNELS))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "fused_ln_linear_bwd" in proc.stdout and "fused_mlp" in proc.stdout


def test_ssl_cli_slice_imports_without_jax_or_pil():
    """The SSL CLI's modules (CLI, data path, flash attention, device
    multi-crop, schedules, logging, presets) and ``chip_smoke.py`` import
    with jax, the JAX package and PIL blocked, and the CLI parses the
    shipped preset."""
    root = Path(__file__).resolve().parent.parent
    script = _SCRIPT.split("import lafs_cvpr2024_tpu_torch as pkg")[0] + (
        "import chip_smoke\n"
        "from lafs_cvpr2024_tpu_torch.cli import train_ssl\n"
        "from lafs_cvpr2024_tpu_torch.data import dataset, decode, pipeline\n"
        "from lafs_cvpr2024_tpu_torch.data import recordio\n"
        "from lafs_cvpr2024_tpu_torch.ops import flash_attention, schedules\n"
        "from lafs_cvpr2024_tpu_torch.ops import augment_device\n"
        "from lafs_cvpr2024_tpu_torch.utils import config, logging\n"
        "a = train_ssl.get_args(['--config', 'configs/ssl_ms1m.toml',\n"
        "    '--data-path', 'd', '--output-dir', 'o'])\n"
        "assert a.device_aug and a.device == 'cuda'\n"
        "print(sorted(chip_smoke.KERNELS))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for name in ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert f"'{name}'" in proc.stdout


def test_eval_slice_imports_without_jax_or_pil():
    """The evaluation slice (the three eval CLIs, verification, the IJB
    protocol, the card's warp, row 10's op) and ``chip_smoke.py`` import
    with jax, the JAX package and PIL blocked, and the CLIs parse their
    command lines with the card as the default device."""
    root = Path(__file__).resolve().parent.parent
    script = _SCRIPT.split("import lafs_cvpr2024_tpu_torch as pkg")[0] + (
        "import chip_smoke\n"
        "from lafs_cvpr2024_tpu_torch.cli import evaluate_bin, evaluate_ijb\n"
        "from lafs_cvpr2024_tpu_torch.cli import extract_embeddings\n"
        "from lafs_cvpr2024_tpu_torch.eval import ijb, verification\n"
        "from lafs_cvpr2024_tpu_torch.ops import mlp_fusion, warp\n"
        "from lafs_cvpr2024_tpu_torch.train.supervised import make_embed_fn\n"
        "for a in (evaluate_bin.get_args(['--checkpoint', 'm.pth',\n"
        "                                 '--eval-path', 'v']),\n"
        "          extract_embeddings.get_args(['--checkpoint', 'm.pth',\n"
        "              '--input', 'i', '--output', 'o']),\n"
        "          evaluate_ijb.get_args(['--model-checkpoint', 'm.pth',\n"
        "              '--image-path', 'i', '--meta-path', 'm'])):\n"
        "    assert a.device == 'cuda'\n"
        "print(sorted(chip_smoke.KERNELS))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "'mlp_fusion'" in proc.stdout
