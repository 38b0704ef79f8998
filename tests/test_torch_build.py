"""The port's one kernel binding (novic_tpu_torch/ops/build.py): the lazy
`Library` handle, the `launch` helper and the `longs` int64 array, on the CPU
with a fake ctypes.CDLL, a fake build and a fake stream lookup."""

from __future__ import annotations

import contextlib
import ctypes
import sys
import threading
import time
import types
from pathlib import Path

import pytest
import torch

from novic_tpu_torch.ops import build

ENTRIES = {"novic_a": ([ctypes.c_void_p, ctypes.c_int], ctypes.c_int),
           "novic_b": ([ctypes.c_size_t], None)}


class _FakeCDLL:
    """Stands in for ctypes.CDLL: records the path it loads and offers any
    entry as an object whose argtypes and restype can be set."""

    loads: list = []

    def __init__(self, path: str):
        time.sleep(0.01)  # a slow load widens the window a second loader could enter
        type(self).loads.append(path)
        self.path = path

    def __getattr__(self, name):
        entry = types.SimpleNamespace(argtypes=None, restype="unset")
        setattr(self, name, entry)
        return entry


@pytest.fixture
def fake_load(monkeypatch):
    """ctypes.CDLL replaced by _FakeCDLL, nvcc's build and the host build by
    recorders that return a path named after the builder."""
    builds = []
    monkeypatch.setattr(_FakeCDLL, "loads", [])
    monkeypatch.setattr(build.ctypes, "CDLL", _FakeCDLL)
    monkeypatch.setattr(build, "build", lambda src: builds.append(("nvcc", src)) or Path("nvcc.so"))
    monkeypatch.setattr(build, "build_host",
                        lambda src: builds.append(("host", src)) or Path("host.so"))
    return builds


def test_library_loads_once_when_eight_threads_ask_at_once(fake_load):
    """Eight threads released together on one fresh handle get one library:
    one build, one load."""
    lib = build.Library(Path("k.cu"), ENTRIES)
    barrier = threading.Barrier(8)
    got = []

    def ask():
        barrier.wait(timeout=10)
        got.append(lib())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(g is got[0] for g in got)
    assert fake_load == [("nvcc", Path("k.cu"))]
    assert _FakeCDLL.loads == ["nvcc.so"]
    assert lib() is got[0] and len(_FakeCDLL.loads) == 1


def test_library_types_every_named_entry_and_builds_nothing_before_its_first_call(fake_load):
    """No build or load when the handle is made; at its first call every entry
    of the table gets its argtypes and restype."""
    handle = build.Library(Path("k.cu"), ENTRIES)
    assert fake_load == [] and _FakeCDLL.loads == []
    lib = handle()
    for name, (argtypes, restype) in ENTRIES.items():
        assert getattr(lib, name).argtypes == argtypes
        assert getattr(lib, name).restype is restype


@pytest.mark.parametrize("host,builder", [(True, "host"), (False, "nvcc")])
def test_library_builds_with_the_compiler_its_kind_takes(fake_load, host, builder):
    """A host library goes through build_host, a kernel library through nvcc's
    build, each from its own source."""
    lib = build.Library(Path("codec.cpp"), ENTRIES, host=host)()
    assert fake_load == [(builder, Path("codec.cpp"))]
    assert lib.path == f"{builder}.so"


@pytest.fixture
def fake_device(monkeypatch):
    """torch.cuda.device and torch.cuda.current_stream replaced by recorders:
    the stream lookup hands out a new stream each time it is called."""
    seen = {"entered": [], "looked_up": []}

    @contextlib.contextmanager
    def device(dev):
        seen["entered"].append(dev)
        yield

    def current_stream(dev):
        seen["looked_up"].append(dev)
        return types.SimpleNamespace(cuda_stream=1000 + len(seen["looked_up"]))

    monkeypatch.setattr(build.torch.cuda, "device", device)
    monkeypatch.setattr(build.torch.cuda, "current_stream", current_stream)
    return seen


def test_launch_looks_up_the_stream_at_every_call(fake_device):
    """Each launch enters the tensor's device and passes the stream current at
    that call: three launches, three lookups, three different streams (a
    launch under CUDA graph capture must land on the capturing stream)."""
    dev = torch.device("cpu")
    streams = []
    for _ in range(3):
        build.launch("k", dev, lambda stream: streams.append(stream) or 0)
    assert streams == [1001, 1002, 1003]
    assert fake_device["looked_up"] == [dev] * 3 and fake_device["entered"] == [dev] * 3


@pytest.mark.parametrize("err,detail,message", [
    (1, "", "^k kernel launch failed: CUDA error 1$"),
    (700, "wgmma instance", r"^k kernel launch failed \(wgmma instance\): CUDA error 700$")])
def test_launch_raises_on_a_nonzero_return(fake_device, err, detail, message):
    """A nonzero CUDA error raises RuntimeError with the kernel's name, the
    detail where given, and the code."""
    with pytest.raises(RuntimeError, match=message):
        build.launch("k", torch.device("cpu"), lambda stream: err, detail=detail)


@pytest.mark.parametrize("values", [[], [0], [1, -2, 2 ** 40, -(2 ** 63), 2 ** 63 - 1],
                                    list(range(66))])
def test_longs_is_an_int64_array_the_pointer_keeps_alive(values):
    """longs(values) points at the values as C int64, in order, for as long as
    the pointer lives."""
    ptr = build.longs(values)
    assert isinstance(ptr, ctypes.c_void_p)
    if values:
        assert list((ctypes.c_longlong * len(values)).from_address(ptr.value)) == values
