"""Debugging utilities (the port's copy of novic_tpu.utils.debug; reference
utils.py NaN hooks :201-233 and tensor-stats show :276-291).

`enable_nan_debugging` switches on torch's autograd anomaly mode, the
counterpart of `jax_debug_nans`; `check_finite` and `show` inspect nested
dicts, lists and tuples of tensors and arrays from host code, with the same
results and lines as the JAX package's.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

from novic_tpu_torch.utils.logger import log


def enable_nan_debugging():
    """Trap the first NaN that a backward pass produces.

    torch.autograd.set_detect_anomaly(True) makes every backward function check
    its outputs and raise on a NaN, naming the forward op that made it. It
    traps NaNs in backward only: a NaN made by a forward op that no gradient
    flows through passes (check_finite finds it). It slows autograd down."""
    torch.autograd.set_detect_anomaly(True)
    log.info("autograd anomaly mode enabled: backward passes will error on the first NaN")


def _leaves_with_path(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs in the JAX package's order and key strings: dict keys
    sorted, written ['key']; list and tuple items written [i]; None holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves_with_path(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves_with_path(item, f"{path}[{i}]")
    else:
        yield path, tree


def _host(leaf: Any) -> np.ndarray:
    """A leaf as a host numpy array; a bf16 or fp16 tensor comes out as float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def check_finite(tree: Any, name: str = "tree", raise_error: bool = True) -> bool:
    """Host-side finite check over nested dicts/lists/tuples of tensors and arrays.

    Raises FloatingPointError (or, with raise_error=False, logs a warning and
    returns False) naming every floating leaf that holds non-finite values,
    with their count."""
    bad = []
    for path, leaf in _leaves_with_path(tree):
        arr = _host(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            n_bad = int((~np.isfinite(arr)).sum())
            bad.append((path, n_bad, arr.size))
    if bad:
        detail = ", ".join(f"{p}: {n}/{t} non-finite" for p, n, t in bad)
        if raise_error:
            raise FloatingPointError(f"Non-finite values in {name}: {detail}")
        log.warning(f"Non-finite values in {name}: {detail}")
        return False
    return True


def show(array: Any, prefix: str = "") -> str:
    """Tensor statistics line (ref utils.py:276-291)."""
    arr = _host(array)
    if np.issubdtype(arr.dtype, np.floating):
        stats = (f"mean {arr.mean():.4g} std {arr.std():.4g} "
                 f"min {arr.min():.4g} max {arr.max():.4g} "
                 f"norm {np.linalg.norm(arr):.4g}")
    else:
        stats = f"min {arr.min()} max {arr.max()}"
    line = f"{prefix + ': ' if prefix else ''}{arr.shape} {arr.dtype} {stats}"
    log.info(line)
    return line
