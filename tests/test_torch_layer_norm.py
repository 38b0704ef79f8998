"""The towers' LayerNorm (novic_tpu_torch.ops.layer_norm) on the CPU.

* On CPU tensors `f32_layer_norm` and the wrapper give the bits of the plain
  float32 form (the expression the towers ran before the kernel), for float32
  and bfloat16 inputs and outputs and strided rows, and launch nothing; the
  plain version agrees with the JAX package's `f32_layer_norm`.
* The wrapper refuses what the kernel does not take: float16 or float64 x, a
  weight or bias of another length or type, operands on two devices, rows
  wider than the kernel's, a device that is neither CPU nor CUDA, an operand
  that requires grad.
* The launch path, with the kernel's library replaced by a recorder and CPU
  tensors standing in for CUDA ones: the row view and its stride (x[:, 0, :]
  read in place), the 16-byte path's choice, the dtype ids; a refused launch
  raises and never reaches the plain version; each launch counts
  `tower.layer_norm` only while a profiler session runs, and the
  benchmark's `ln_launches.offline` reads that counter per batch.

The kernel itself runs on the card (chip_smoke.py phase 3h).
"""

import contextlib
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp

from novic_tpu.embedders.vit import f32_layer_norm as jax_layer_norm
from novic_tpu_torch.embedders.vit import f32_layer_norm
from novic_tpu_torch.ops import layer_norm as port
from novic_tpu_torch.utils import trace

torch.set_num_threads(2)
EPS = 1e-6
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def cleared():
    trace.clear()
    yield
    trace.clear()


def plain_form(x, weight, bias, eps, out_dtype=torch.float32):
    """The towers' LayerNorm as plain torch, verbatim."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * weight + bias).to(out_dtype)


def operands(shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    D = shape[-1]
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(D, generator=g)
    b = 0.1 * torch.randn(D, generator=g)
    return x, w, b


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 77), (4, 768), (2, 3, 2730)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_path_is_the_plain_form_bit_for_bit(shape, dtype, out_dtype):
    x, w, b = operands(shape, dtype)
    launches = port.LAUNCHES
    want = plain_form(x, w, b, EPS, out_dtype)
    for got in (f32_layer_norm(x, w, b, EPS, out_dtype=out_dtype),
                port.layer_norm(x, w, b, EPS, out_dtype)):
        assert got.dtype == out_dtype and got.shape == x.shape
        assert torch.equal(got, want)
    # Strided rows (EVA's class token), as the towers pass them
    rows = x.reshape(-1, shape[-1])[::2]
    assert torch.equal(f32_layer_norm(rows, w, b, EPS, out_dtype=out_dtype),
                       plain_form(rows, w, b, EPS, out_dtype))
    assert port.LAUNCHES == launches


@pytest.mark.parametrize("shape", [(4, 7, 64), (3, 768), (2, 2730)])
def test_plain_version_matches_the_jax_package(shape):
    x, w, b = operands(shape, seed=1)
    want = np.asarray(jax_layer_norm(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                                     jnp.asarray(b.numpy()), EPS))
    got = port.layer_norm_reference(x, w, b, EPS).numpy()
    # float32 throughout; the two frameworks sum in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case,match", [
    ("x_float16", "input dtype"), ("x_float64", "input dtype"), ("out_float16", "output dtype"),
    ("weight_length", "weight must be"), ("bias_length", "bias must be"),
    ("weight_bf16", "weight must be"), ("mixed_devices", "different devices"),
    ("too_wide", "D <= "), ("scalar", "D <= "), ("meta_device", "unsupported device")])
def test_wrapper_refuses(case, match):
    x, w, b = operands((2, 16))
    out_dtype = torch.float32
    if case == "x_float16":
        x = x.half()
    elif case == "x_float64":
        x = x.double()
    elif case == "out_float16":
        out_dtype = torch.float16
    elif case == "weight_length":
        w = w[:8]
    elif case == "bias_length":
        b = torch.zeros(17)
    elif case == "weight_bf16":
        w = w.bfloat16()
    elif case == "mixed_devices":  # a device other than x's (the card's stand-in here)
        w = w.to("meta")
    elif case == "too_wide":
        x, w, b = operands((1, port.MAX_D + 1))
    elif case == "scalar":
        x = torch.tensor(1.0)
    elif case == "meta_device":
        x, w, b = x.to("meta"), w.to("meta"), b.to("meta")
    with pytest.raises(ValueError, match=match):
        port.layer_norm(x, w, b, EPS, out_dtype)


class _FakeLibrary:
    """Records each launch's arguments and returns a CUDA error code."""

    def __init__(self, err: int = 0):
        self.err, self.calls = err, []

    def novic_layer_norm(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def fake_launch(monkeypatch):
    """The kernel's library replaced by a recorder, CPU tensors standing in
    for CUDA ones, and the plain version made to fail if reached."""
    lib = _FakeLibrary()
    monkeypatch.setattr(port, "_library", lambda: lib)
    monkeypatch.setattr(port.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(port.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))

    def plain(*args):
        raise AssertionError("a kernel launch reached the plain version")

    monkeypatch.setattr(port, "layer_norm_reference", plain)
    monkeypatch.setattr(port, "LAUNCHES", 0)
    return lib


def _at_offset(shape, dtype, offset: int) -> torch.Tensor:
    """A contiguous tensor whose base lies `offset` elements past a 16-byte boundary."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 64, dtype=dtype)
    start = (-flat.data_ptr()) % 16 // flat.element_size() + offset
    return flat[start:start + n].view(shape)


@pytest.mark.parametrize("case,rows,D,vector", [
    ("aligned_768", 6, 768, True), ("class_token_view", 4, 1024, True),
    ("unaligned_base", 6, 768, False), ("ragged_2730", 3, 2730, False),
    ("ragged_77", 5, 77, False), ("permuted_copy", 8, 64, True)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_arguments(fake_launch, case, rows, D, vector, dtype, out_dtype):
    """One launch with x's rows (a view in place where one row stride steps
    over them), D, the row stride, eps, the dtype ids and the 16-byte path
    where D and every base allow it; the output is contiguous, of x's shape."""
    w, b = torch.ones(D), torch.zeros(D)
    if case == "class_token_view":
        full = _at_offset((rows, 5, D), dtype, 0)
        x, base, ldx = full[:, 0, :], full.data_ptr(), 5 * D
    elif case == "permuted_copy":  # (2, 4, D) seen as (4, 2, D): no single row stride
        x = _at_offset((2, 4, D), dtype, 0).transpose(0, 1)
        base, ldx = None, D
    else:
        x = _at_offset((rows, D), dtype, 1 if case == "unaligned_base" else 0)
        base, ldx = x.data_ptr(), D
    y = port._launch(x, w, b, EPS, out_dtype)
    assert y.shape == x.shape and y.dtype == out_dtype and y.is_contiguous()
    (args,) = fake_launch.calls
    ids = {torch.float32: 0, torch.bfloat16: 1}
    assert args[1] == y.data_ptr() and args[2] == w.data_ptr() and args[3] == b.data_ptr()
    assert args[4:7] == (rows, D, ldx)
    assert args[7] == pytest.approx(EPS)
    assert args[8:11] == (ids[dtype], ids[out_dtype], int(vector))
    if base is None:
        assert args[0] != x.data_ptr()
    else:
        assert args[0] == base
    assert port.LAUNCHES == 1


def test_refused_launch_raises_and_never_falls_back(fake_launch):
    """A launch the kernel refuses (a nonzero CUDA error) raises, counts
    nothing and never reaches the plain version."""
    fake_launch.err = 1  # cudaErrorInvalidValue
    x, w, b = operands((4, 768))
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            port._launch(x, w, b, EPS, torch.bfloat16)
        assert trace.counters() == {}
    assert port.LAUNCHES == 0


def test_empty_rows_launch_nothing(fake_launch):
    x, w, b = operands((0, 768))
    assert port._launch(x, w, b, EPS, torch.float32).shape == (0, 768)
    assert fake_launch.calls == [] and port.LAUNCHES == 0


def test_counter_only_while_a_profiler_runs(fake_launch):
    """Each launch counts `tower.layer_norm` in the program's trace while a
    profiler session runs, and nothing without one; LAUNCHES counts both."""
    x, w, b = operands((4, 768))
    for _ in range(2):
        port._launch(x, w, b, EPS, torch.float32)
    assert trace.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            port._launch(x, w, b, EPS, torch.bfloat16)
        assert trace.counters() == {"tower.layer_norm": 3}
    assert port.LAUNCHES == 5


def test_cpu_calls_count_nothing_under_a_profiler():
    x, w, b = operands((4, 768))
    launches = port.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU]):
        f32_layer_norm(x, w, b, EPS)
        port.layer_norm(x, w, b, EPS)
        assert trace.counters() == {}
    assert port.LAUNCHES == launches


def test_no_backward_refused_under_grad(fake_launch):
    """The kernel has no backward: an operand that requires grad is refused
    while grad mode is on, and launched under no_grad."""
    x, w, b = operands((4, 64))
    x.requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        port._launch(x, w, b, EPS, torch.float32)
    with torch.no_grad():
        port._launch(x, w, b, EPS, torch.float32)
    assert len(fake_launch.calls) == 1


@pytest.mark.parametrize("per_batch", [26, 97, 0])
def test_benchmark_reads_the_launches_per_batch(fake_launch, per_batch):
    """port_bench's ln_launches.offline reads the counter that the launches
    add, per `embed` span of the traced segment; with no launch (the CPU
    path, or a program without the kernel) the counter is absent and the
    metric is left out."""
    from port_bench import harness

    x, w, b = operands((4, 64))
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with trace.span("embed", images=4):
                for _ in range(per_batch):
                    port._launch(x, w, b, EPS, torch.bfloat16)
    spans = [{"name": "tower", "phase": "traced", "t0": t0, "t1": time.perf_counter()}]
    reader = harness.metric_reader(ROOT, "ln_launches.offline")
    value = reader.read(types.SimpleNamespace(spans=spans), "ln_launches.offline")
    assert value == (per_batch or None)
