"""Device and compute-dtype resolution for the port's entry points.

Every entry point takes an explicit device and defaults to "cuda". Asking for
CUDA on a machine without it raises; nothing falls back to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve(device: Union[str, torch.device] = "cuda") -> torch.device:
    """torch.device for `device`; raises if it is a CUDA device and CUDA is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"Device {str(device)!r} requested but CUDA is not available "
                           "(pass device='cpu' to run on the CPU)")
    return dev


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    """torch dtype for a config's compute-dtype name (float32 | bfloat16)."""
    if name not in _DTYPES:
        raise ValueError(f"Unsupported compute dtype: {name}")
    return _DTYPES[name]
