"""PyTorch port: the package loads where there is no JAX.

A machine with the GPU has no jax, flax or orbax. A subprocess blocks them
(and the JAX package) in ``sys.modules`` and imports every module of
``lafs_cvpr2024_tpu_torch``; any import of them fails the test.
"""

import subprocess
import sys
from pathlib import Path

_SCRIPT = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "orbax", "lafs_cvpr2024_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
import lafs_cvpr2024_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def test_package_imports_without_jax():
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 16  # every module was visited
