"""Compile the port's CUDA sources with nvcc into shared libraries, and bind
them: the one place that decides how a library is built and loaded, how its C
entries are typed, and on which device and stream a kernel launches.

Each source in ops/csrc/ has a plain C interface (device helpers shared between
sources live in csrc/*.cuh headers) and is built for sm_90a into
build/novic_tpu_torch/ at the root of the checkout at first use, then loaded
through ctypes by its wrapper module's `Library` handle. `build_all` starts one
nvcc per source at once, so a cold start pays the slowest compile rather than
the sum, and each nvcc splits its compilation over the host's cores
(`-split-compile=0`): the backward flash kernels' 192 instances build in about
half the time so.

Host C++ (the checkpoint codecs under train/csrc/) takes `build_host`: the host
compiler (g++, else c++) with -O2 -shared -fPIC, into the same directory, a
temporary name renamed into place so that concurrent builds never load a
half-written library.

`launch` runs one C entry that launches kernels: on the tensors' device, on
that device's current stream as of the call, raising on a nonzero CUDA error.
`longs` passes a list of ints as a C int64 array (the tensor-map plans).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "novic_tpu_torch"


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(source: Path) -> Path:
    return BUILD_DIR / f"libnovic_{source.stem}.so"


def ptxas_path(source: Path) -> Path:
    return BUILD_DIR / f"{source.stem}.ptxas.txt"


def _fresh(source: Path) -> bool:
    """The library is newer than its source and every shared header in csrc/."""
    out = library_path(source)
    newest = max(p.stat().st_mtime for p in [source, *CSRC.glob("*.cuh")])
    return out.is_file() and out.stat().st_mtime >= newest


def _start(source: Path) -> tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = library_path(source).with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-split-compile=0", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           str(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), tmp


def _finish(source: Path, proc: subprocess.Popen, tmp: Path) -> Path:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{out}\n{err}")
    ptxas_path(source).write_text(err)
    os.replace(tmp, library_path(source))
    return library_path(source)


def build(source: Path, force: bool = False) -> Path:
    """Compile one source (if stale); return the .so path."""
    if not force and _fresh(source):
        return library_path(source)
    return _finish(source, *_start(source))


def build_all(sources: list[Path], force: bool = False) -> list[Path]:
    """Compile several sources concurrently, one nvcc each; return their .so paths."""
    jobs = [(s, *_start(s)) for s in sources if force or not _fresh(s)]
    try:
        for source, proc, tmp in jobs:
            _finish(source, proc, tmp)
    finally:
        for _, proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [library_path(s) for s in sources]


def host_compiler() -> str:
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (g++ or c++) found: the host library cannot be built")


def build_host(source: Path, force: bool = False) -> Path:
    """Compile one host C++ source (if its library is older, or `force`) into
    build/novic_tpu_torch/libnovic_<stem>.so; raise with the compiler's output."""
    out = library_path(source)
    if not force and out.is_file() and out.stat().st_mtime >= source.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [host_compiler(), "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} failed on {source.name} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


class Library:
    """A lazy handle on the library of one source: calling it builds the
    library if stale (`build_host` where `host`, else nvcc's `build`) and
    loads it at the first call, once per process under the handle's lock,
    with each C entry of `entries` ({name: (argtypes, restype)}) typed; every
    call returns that ctypes.CDLL. Nothing is built or loaded at import."""

    def __init__(self, source: Path, entries: dict[str, tuple[list, object]],
                 host: bool = False):
        self.source, self.entries, self.host = source, entries, host
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def __call__(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str((build_host if self.host else build)(self.source)))
                for name, (argtypes, restype) in self.entries.items():
                    entry = getattr(lib, name)
                    entry.argtypes, entry.restype = argtypes, restype
                self._lib = lib
        return self._lib


def launch(kernel: str, device: torch.device, call: Callable[[int], int],
           detail: str = "") -> None:
    """`call(stream)` (a C entry that launches `kernel` on `stream` and returns
    a CUDA error) with `device` current and `stream` that device's current
    stream, looked up at this call and never kept: a launch under CUDA graph
    capture lands on the capturing stream. A nonzero return raises
    RuntimeError naming the kernel, the error and `detail` where given."""
    with torch.cuda.device(device):
        err = call(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        detail = f" ({detail})" if detail else ""
        raise RuntimeError(f"{kernel} kernel launch failed{detail}: CUDA error {err}")


def longs(values: Sequence[int]) -> ctypes.c_void_p:
    """`values` as a C int64 array, passed by pointer; the pointer keeps the
    array alive."""
    return ctypes.cast((ctypes.c_longlong * len(values))(*values), ctypes.c_void_p)
