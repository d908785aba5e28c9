"""The port stands alone: importing every module of
``fish_diffusion_tpu_torch`` loads no JAX, flax or ``fish_diffusion_tpu``
module (checked in a fresh interpreter)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
import fish_diffusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "fish_diffusion_tpu"))
assert len(names) >= 15, names
assert not bad, bad
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
