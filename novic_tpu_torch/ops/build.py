"""Compile the port's CUDA sources with nvcc into shared libraries.

Each source in ops/csrc/ has a plain C interface (device helpers shared between
sources live in csrc/*.cuh headers) and is built for sm_90a into
build/novic_tpu_torch/ at the root of the checkout at first use, then loaded
through ctypes by its wrapper module. `build_all` starts one nvcc per source at
once, so a cold start pays the slowest compile rather than the sum, and each
nvcc splits its compilation over the host's cores (`-split-compile=0`): the
backward flash kernels' 192 instances build in about half the time so.

Host C++ (the checkpoint codecs under train/csrc/) takes `build_host`: the host
compiler (g++, else c++) with -O2 -shared -fPIC, into the same directory, a
temporary name renamed into place so that concurrent builds never load a
half-written library.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

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
