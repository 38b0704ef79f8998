"""The port imports no JAX and nothing of the JAX package.

tests/conftest.py has already imported JAX in this process, so the check runs
in a subprocess whose import hook raises on jax, flax, optax, novic_tpu and
novic_tpu.* (not novic_tpu_torch), then imports every module of
novic_tpu_torch and chip_smoke.
"""

import os
import subprocess
import sys

import pytest
import torch

from novic_tpu_torch import device

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_GUARD = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "novic_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import novic_tpu_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(novic_tpu_torch.__path__,
                                                                "novic_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 20


def test_guard_blocks_the_jax_package():
    """The hook itself rejects novic_tpu but not novic_tpu_torch."""
    code = _GUARD.split("import novic_tpu_torch")[0] + (
        "import novic_tpu_torch.device\n"
        "try:\n    import novic_tpu.text\nexcept ImportError:\n    print('blocked')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "blocked"


def test_resolve_cuda_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve("cuda")
    with pytest.raises(RuntimeError):
        device.resolve("cuda:0")
    assert device.resolve("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_gpu():
    """chip_smoke.py exits nonzero and prints no result line without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
