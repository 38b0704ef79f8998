"""The port imports no JAX and nothing of the JAX package.

tests/conftest.py has already imported JAX in this process, so the check runs
in a subprocess whose import hook raises on jax, flax, optax, novic_tpu and
novic_tpu.* (not novic_tpu_torch), and on tabulate (the port renders its
tables itself: the card's machine has no tabulate), then imports every module of
novic_tpu_torch (the serving modules, the int8 and text-tower modules:
ops.int8_matmul, embedders.vit/base, bridge; and the training path's:
ops.dropout, data.*, train.*, cli.*, utils.config/metrics; the DFN5B slice's
ops.attention_bf16, ops.tiled_matmul and the exp.* harnesses, which import
nothing of the root exp/ either; the flash-attention slice's
ops.flash_attention, exp.attn_variants and the text.clip_bpe / sentencepiece /
wordpiece tokenizers; the exhaustive-decode slice's models.precompute_store and
models.dud; the released-weight slice's embedders.convert/registry,
cli.actions_misc and train.checkpoint/optim; the noun-data slice's
data.noun_dataset, data.cache_writers, data.classification, cli.actions_cache
and cli.actions_eval; the eval slice's cli.actions_eval (every action),
cli.actions_misc and utils.metrics; the tower-family slice's embedders.eva,
embedders.align and embedders.structured; the tools-and-parallel slice's
tools.* (demo server, caption and annotation tools, specificity), parallel.*
and utils.debug; the orbax slice's train.zstd, train.ocdbt and
train.orbax_format) and chip_smoke. The hook also raises on openai and cv2,
which the tools import only when they run, and on orbax, tensorstore and
zstandard: the port reads and writes orbax checkpoints with its own code, and
the committed orbax fixture loads with them blocked.
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

BLOCKED = ("jax", "jaxlib", "flax", "optax", "novic_tpu", "exp", "tabulate", "openai", "cv2",
           "orbax", "tensorstore", "zstandard")

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
print(" ".join(names))
print(len(names))
"""

TRAINING_MODULES = [
    "novic_tpu_torch.ops.dropout", "novic_tpu_torch.ops.build", "novic_tpu_torch.models.base",
    "novic_tpu_torch.data.noise", "novic_tpu_torch.data.config", "novic_tpu_torch.data.dataset",
    "novic_tpu_torch.data.cache", "novic_tpu_torch.data.loader", "novic_tpu_torch.data.grad_accum",
    "novic_tpu_torch.train.optim", "novic_tpu_torch.train.step", "novic_tpu_torch.train.loop",
    "novic_tpu_torch.train.checkpoint", "novic_tpu_torch.utils.config",
    "novic_tpu_torch.utils.metrics", "novic_tpu_torch.cli.common",
    "novic_tpu_torch.cli.actions_train", "novic_tpu_torch.cli.train",
]

INT8_AND_TEXT_MODULES = ["novic_tpu_torch.ops.int8_matmul", "novic_tpu_torch.embedders.vit",
                         "novic_tpu_torch.embedders.base", "novic_tpu_torch.bridge"]

DFN5B_SLICE_MODULES = ["novic_tpu_torch.ops.attention_bf16", "novic_tpu_torch.ops.tiled_matmul",
                       "novic_tpu_torch.exp", "novic_tpu_torch.exp.dfn5b_attention",
                       "novic_tpu_torch.exp.attn_v2", "novic_tpu_torch.exp.int8_matmul_probe"]
FLASH_SLICE_MODULES = ["novic_tpu_torch.ops.flash_attention", "novic_tpu_torch.exp.attn_variants",
                       "novic_tpu_torch.text.clip_bpe", "novic_tpu_torch.text.sentencepiece",
                       "novic_tpu_torch.text.wordpiece"]
ALL_SLICE_MODULES = ["novic_tpu_torch.models.generate", "novic_tpu_torch.models.precompute_store",
                     "novic_tpu_torch.models.dud", "novic_tpu_torch.infer"]
REFERENCE_SLICE_MODULES = ["novic_tpu_torch.embedders.convert",
                           "novic_tpu_torch.embedders.registry",
                           "novic_tpu_torch.cli.actions_misc",
                           "novic_tpu_torch.train.checkpoint", "novic_tpu_torch.train.optim"]
NOUN_DATA_SLICE_MODULES = ["novic_tpu_torch.data.noun_dataset",
                           "novic_tpu_torch.data.cache_writers",
                           "novic_tpu_torch.data.classification",
                           "novic_tpu_torch.cli.actions_cache", "novic_tpu_torch.cli.actions_eval"]


TOWER_FAMILY_SLICE_MODULES = ["novic_tpu_torch.embedders.eva", "novic_tpu_torch.embedders.align",
                              "novic_tpu_torch.embedders.structured"]
TOOLS_PARALLEL_SLICE_MODULES = [
    "novic_tpu_torch.tools", "novic_tpu_torch.tools.demo_server",
    "novic_tpu_torch.tools.specificity", "novic_tpu_torch.tools.caption_check",
    "novic_tpu_torch.tools.caption_generation", "novic_tpu_torch.tools.gpt_annotation",
    "novic_tpu_torch.tools.annotate_gui", "novic_tpu_torch.parallel",
    "novic_tpu_torch.parallel.mesh", "novic_tpu_torch.parallel.tp",
    "novic_tpu_torch.utils.debug"]
ORBAX_SLICE_MODULES = ["novic_tpu_torch.train.zstd", "novic_tpu_torch.train.ocdbt",
                       "novic_tpu_torch.train.orbax_format"]


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert int(lines[-1]) >= 64
    assert set(TRAINING_MODULES + INT8_AND_TEXT_MODULES + DFN5B_SLICE_MODULES
               + FLASH_SLICE_MODULES + ALL_SLICE_MODULES + REFERENCE_SLICE_MODULES
               + NOUN_DATA_SLICE_MODULES + TOWER_FAMILY_SLICE_MODULES
               + TOOLS_PARALLEL_SLICE_MODULES + ORBAX_SLICE_MODULES) <= set(lines[-2].split())


def test_orbax_fixture_loads_without_orbax_tensorstore_or_zstandard():
    """The committed orbax checkpoint (real orbax bytes: zstd-compressed chunks,
    per-process OCDBT stores) loads with the port's own code, bit for bit as its
    .npz twin, with orbax, tensorstore, zstandard and JAX blocked."""
    code = _GUARD.split("import novic_tpu_torch")[0] + (
        "import numpy as np\n"
        "from novic_tpu_torch.train.checkpoint import load_checkpoint\n"
        "a = load_checkpoint('tests/data/orbax_small.orbax')\n"
        "b = load_checkpoint('tests/data/orbax_small.npz')\n"
        "from novic_tpu_torch.utils.misc import flatten_dict\n"
        "pa, pb = flatten_dict(a['params']), flatten_dict(b['params'])\n"
        "assert sorted(pa) == sorted(pb) and len(a['opt_arrays']) == len(b['opt_arrays'])\n"
        "for x, y in list(zip([pa[k] for k in sorted(pa)], [pb[k] for k in sorted(pb)]))"
        " + list(zip(a['opt_arrays'], b['opt_arrays'])):\n"
        "    assert x.shape == y.shape and x.tobytes() == y.tobytes()\n"
        "assert a['cfg_flat'] == b['cfg_flat'] and a['target_nouns'] == b['target_nouns']\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)\n"
        "assert not leaked, leaked\n"
        "print(len(pa) + len(a['opt_arrays']))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) == 11  # 8 params, 3 optimizer leaves


def test_train_cli_runs_without_jax():
    """The training entry point starts (--help) with JAX blocked."""
    code = _GUARD.split("import novic_tpu_torch")[0] + (
        "import runpy, sys\nsys.argv = ['train', '--help']\n"
        "runpy.run_module('novic_tpu_torch.cli.train', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "action=train" in res.stdout and "--device" in res.stdout


def test_guard_blocks_the_jax_package():
    """The hook itself rejects novic_tpu and the root exp/ harnesses, but not
    novic_tpu_torch or its exp subpackage."""
    code = _GUARD.split("import novic_tpu_torch")[0] + (
        "import novic_tpu_torch.device\n"
        "try:\n    import novic_tpu.text\nexcept ImportError:\n    print('blocked')\n"
        "try:\n    import exp.dfn5b_attention\nexcept ImportError:\n    print('blocked')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["blocked", "blocked"]


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
