"""Port tiled GEMM (novic_tpu_torch.ops.tiled_matmul, the counterpart of X3)
against the Pallas kernels of exp/pallas_int8_matmul.py (`make_matmul`) and
exp/pallas_int8_rate_pin.py (`make_mm`) themselves, run in TPU interpret mode
on the CPU with each module's M, K, N set small (256, 256, 512).

On the CPU the port takes the kernel's plain version. Bars: int8 products and
int8 checksums equal the JAX ones exactly (int32 arithmetic); bf16 and float32
products, and their checksums, are within 1e-5 of a float64 product relative
to the sum of |x·w| over the same terms (float32 sums of K terms in any order
stay far inside that), on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import exp.pallas_int8_matmul as jmatmul
import exp.pallas_int8_rate_pin as jrate
from novic_tpu_torch.exp import int8_matmul_probe as probe
from novic_tpu_torch.ops import tiled_matmul as port

torch.set_num_threads(2)
M, K, N = 256, 256, 512
REL = 1e-5
JAX_DTYPES = {"int8": (jnp.int8, jnp.int32), "bf16": (jnp.bfloat16, jnp.float32),
              "f32": (jnp.float32, jnp.float32)}


@pytest.fixture
def small(monkeypatch):
    for mod in (jmatmul, jrate):
        monkeypatch.setattr(mod, "M", M)
        monkeypatch.setattr(mod, "K", K)
        monkeypatch.setattr(mod, "N", N)


def _operands(kind: str, seed: int):
    """The probes' operands as numpy: normal, cast to bf16, or x * 10 truncated to int8."""
    ops = probe.inputs(M, K, N, seed=seed, device="cpu")[kind]
    return [t.float().numpy() if kind == "bf16" else t.numpy() for t in ops], ops


def _rel_err(got: np.ndarray, x: np.ndarray, w: np.ndarray, bn=None) -> float:
    """max |got - x·w| / sum |x·w| over the same terms, in float64."""
    x, w = x.astype(np.float64), w.astype(np.float64)
    y, a = x @ w, np.abs(x) @ np.abs(w)
    if bn:
        y, a = y.reshape(M, -1, bn).sum(-1), a.reshape(M, -1, bn).sum(-1)
    return float((np.abs(got.astype(np.float64) - y) / a).max())


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("bm,bn,bk", [(128, 256, 128), (256, 128, 256)])
def test_make_matmul_matches_pallas(small, kind, bm, bn, bk):
    (x, w), (xt, wt) = _operands(kind, 1)
    in_dt, acc_dt = JAX_DTYPES[kind]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jmatmul.make_matmul(bm, bn, bk, in_dt, acc_dt, acc_dt)(
            jnp.asarray(x).astype(in_dt), jnp.asarray(w).astype(in_dt)))
    launches = port.LAUNCHES
    out = probe.make_matmul(bm, bn, bk, xt.dtype, port.out_dtype(xt.dtype),
                            port.out_dtype(xt.dtype))(xt, wt)
    assert port.LAUNCHES == launches  # the CPU path launches no kernel
    assert out.shape == ref.shape == (M, N)
    if kind == "int8":
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        assert out.dtype == torch.float32
        assert _rel_err(out.numpy(), x, w) <= REL and _rel_err(ref, x, w) <= REL


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bm,bn,bk", [(128, 128, 256), (256, 256, 128), (128, 16, 256),
                                      (256, 512, 128)])
def test_make_mm_checksum_matches_pallas(small, kind, bm, bn, bk):
    (x, w), (xt, wt) = _operands(kind, 2)
    in_dt, acc_dt = JAX_DTYPES[kind]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrate.make_mm(bm, bn, bk, acc_dt)(jnp.asarray(x).astype(in_dt),
                                                            jnp.asarray(w).astype(in_dt)))
    out = probe.make_mm(bm, bn, bk, port.out_dtype(xt.dtype))(xt, wt)
    assert out.dtype == torch.float32 and out.shape == ref.shape == (M, N // bn)
    if kind == "int8":
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        assert _rel_err(out.numpy(), x, w, bn) <= REL and _rel_err(ref, x, w, bn) <= REL


def test_int8_checksum_wraps_as_int32():
    """Block sums past 2^31 wrap as the probe's int32 scratch does."""
    x = torch.full((2, 32), 127, dtype=torch.int8)
    w = torch.full((32, 8192), 127, dtype=torch.int8)
    out = port.tiled_matmul(x, w, bn=8192)
    total = 32 * 127 * 127 * 8192
    want = np.array([total], dtype=np.int64).astype(np.int32).astype(np.float32)
    assert total > 2 ** 31
    np.testing.assert_array_equal(out.numpy(), np.full((2, 1), want[0], np.float32))


def test_probe_dtype_forms_are_checked():
    with pytest.raises(ValueError, match="not a form"):
        probe.make_matmul(128, 128, 128, torch.int8, torch.float32, torch.float32)
    x, w = torch.zeros(16, 16, dtype=torch.int8), torch.zeros(16, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="does not fit"):
        probe.make_mm(128, 16, 128, torch.float32)(x, w)


def test_checks_raise():
    x = torch.zeros(32, 16)
    with pytest.raises(ValueError, match="x \\(M, K\\) and w \\(K, N\\)"):
        port.tiled_matmul(x, torch.zeros(32, 16))
    with pytest.raises(ValueError, match="share one of"):
        port.tiled_matmul(x, torch.zeros(16, 32, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bn=24"):
        port.tiled_matmul(x, torch.zeros(16, 32), bn=24)


def test_non_cpu_tensors_never_take_the_plain_path(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises: with the kernel's
    library made unloadable, the launch raises instead of running the plain
    version, and a device that is neither CPU nor CUDA is refused."""
    called = []
    monkeypatch.setattr(port, "tiled_matmul_reference", lambda *a: called.append(a))

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(port, "_library", no_library)
    x = torch.zeros(32, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.tiled_matmul(x, torch.zeros(16, 32, device="meta"))
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        port._launch(torch.zeros(32, 16), torch.zeros(16, 32), None)
    assert not called


@pytest.mark.parametrize("M,K,N", [(16384, 1280, 5120), (8192, 1280, 5120), (1000, 272, 400),
                                   (129, 1040, 272), (1, 16, 16)])
def test_bf16_tma_plan(M, K, N):
    """x (M, K) K-major: dims (K, M), row stride K*2 bytes, box 64 k by 128
    rows; w (K, N) read as the MN-major operand: dims (N, K), row stride N*2
    bytes, box 64 columns by 64 k-rows. The extents zero-fill ragged edges."""
    x = torch.empty(M, K, dtype=torch.bfloat16, device="meta")
    w = torch.empty(K, N, dtype=torch.bfloat16, device="meta")
    assert port._tma_plan(x, w) == [K, M, 2 * K, 64, 128, N, K, 2 * N, 64, 64]


@pytest.mark.parametrize("bad", ["x_base", "w_base", "x_strided"])
def test_launch_refuses_what_a_tensor_map_cannot_take(monkeypatch, bad):
    """A base that is not 16-byte aligned or a row stride other than the
    row's own raises before the kernel's library is touched."""
    def no_library():
        raise AssertionError("the launch went past the checks")

    monkeypatch.setattr(port, "_library", no_library)
    flat = torch.zeros(4096, dtype=torch.bfloat16)
    x, w = torch.zeros(32, 64, dtype=torch.bfloat16), torch.zeros(64, 48, dtype=torch.bfloat16)
    if bad == "x_base":
        x = flat[1:1 + 32 * 64].view(32, 64)
    elif bad == "w_base":
        w = flat[3:3 + 64 * 48].view(64, 48)
    else:
        x = flat.view(32, 128)[:, :64]
    with pytest.raises(ValueError, match="contiguous and 16-byte aligned"):
        port._launch(x, w, None)


@pytest.mark.parametrize("M,K,N", [(8192, 1280, 5120), (16384, 1280, 5120), (1000, 272, 400),
                                   (129, 1040, 272), (1, 16, 16)])
def test_f32_tma_plan(M, K, N):
    """The float32 kernel's maps: x (M, K) K-major, dims (K, M), row stride
    K*4 bytes, box 32 k (one 128-byte row) by 128 rows; w (K, N) row-major,
    dims (N, K), row stride N*4 bytes, box 32 columns by 32 k-rows (four
    such boxes make a 128-column stage). The extents zero-fill ragged edges."""
    x = torch.empty(M, K, dtype=torch.float32, device="meta")
    w = torch.empty(K, N, dtype=torch.float32, device="meta")
    assert port._tma_plan(x, w) == [K, M, 4 * K, 32, 128, N, K, 4 * N, 32, 32]


@pytest.mark.parametrize("bad", ["x_base", "w_base", "x_strided", "k_not_16", "n_not_16"])
def test_f32_launch_refuses_what_a_tensor_map_cannot_take(monkeypatch, bad):
    """For float32 as for bf16: a base that is not 16-byte aligned, a row
    stride other than the row's own, or K or N not a multiple of 16 raises
    before the kernel's library is touched."""
    def no_library():
        raise AssertionError("the launch went past the checks")

    monkeypatch.setattr(port, "_library", no_library)
    flat = torch.zeros(8192, dtype=torch.float32)
    x, w = torch.zeros(32, 64), torch.zeros(64, 48)
    if bad == "x_base":
        x = flat[1:1 + 32 * 64].view(32, 64)
    elif bad == "w_base":
        w = flat[2:2 + 64 * 48].view(64, 48)
    elif bad == "x_strided":
        x = flat.view(32, 256)[:, :64]
    elif bad == "k_not_16":
        x, w = torch.zeros(32, 40), torch.zeros(40, 48)
    else:
        w = torch.zeros(64, 40)
    match = "multiples of 16" if bad in ("k_not_16", "n_not_16") else "contiguous and 16-byte aligned"
    with pytest.raises(ValueError, match=match):
        port._launch(x, w, None)


S8_PLAN_BN16 = [256, 32, 256, 128, 64, 256, 48, 256, 128, 64]


class RecordingLib:
    """A fake kernel library that records each entry point's arguments; the
    tiled GEMM's calls after the first `ok_calls` return a CUDA error."""

    def __init__(self, ok_calls: int = 1):
        self.calls, self.transposes, self.ok_calls = [], [], ok_calls

    def novic_tiled_matmul(self, *args):
        self.calls.append(args)
        return 1 if len(self.calls) > self.ok_calls else 0

    def novic_transpose_s8(self, *args):
        self.transposes.append(args)
        return 0


@pytest.fixture
def fake_cuda(monkeypatch):
    """The wrapper's launch path on CPU tensors: a recording library, no
    device switch, stream 0, and every plain version or library product
    made to fail the test if called."""
    import contextlib
    import types

    lib = RecordingLib()
    monkeypatch.setattr(port, "_library", lambda: lib)
    monkeypatch.setattr(port.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(port.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    for mod, name in ((port, "tiled_matmul_reference"), (port, "transpose_s8_reference"),
                      (torch, "_int_mm"), (torch, "mm"), (torch, "matmul")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: pytest.fail(f"{_n} was called"))
    return lib


def _plan(arg, n: int) -> list:
    import ctypes

    return list((ctypes.c_longlong * n).from_address(arg.value))


@pytest.mark.parametrize("dtype,plan", [(torch.int8, S8_PLAN_BN16),
                                        (torch.bfloat16, [256, 32, 512, 64, 128, 48, 256, 96, 64, 64]),
                                        (torch.float32, [256, 32, 1024, 32, 128, 48, 256, 192, 32, 32])])
def test_launch_passes_each_form_its_plan(fake_cuda, dtype, plan):
    """Each form reaches the library with its tensor-map plan (s8: x's and
    wᵀ's maps, and no out map for a checksum); a refused launch raises and
    counts nothing."""
    x, w = torch.zeros(32, 256, dtype=dtype), torch.zeros(256, 48, dtype=dtype)
    launches, instances = port.LAUNCHES, dict(port.INSTANCE_LAUNCHES)
    port._launch(x, w, 16)
    got = fake_cuda.calls[0]
    assert _plan(got[3], len(plan)) == plan
    assert got[5:10] == (32, 48, 256, port._KINDS[dtype], 16)
    assert port.LAUNCHES == launches + 1
    instance = {torch.int8: "s8_wgmma", torch.bfloat16: "bf16_wgmma",
                torch.float32: "f32_fma"}[dtype]
    assert port.INSTANCE_LAUNCHES == {**instances, instance: instances[instance] + 1}
    with pytest.raises(RuntimeError, match="launch failed"):
        port._launch(x, w, None)
    assert port.LAUNCHES == launches + 1


@pytest.mark.parametrize("M,K,N", [(16384, 1280, 5120), (8192, 1280, 5120), (1000, 272, 400),
                                   (129, 1040, 272), (1, 16, 16), (300, 16, 400)])
@pytest.mark.parametrize("bn", [None, 16])
def test_s8_tma_plan(M, K, N, bn):
    """The s8 engine's maps (K2's Hopper instance): x (M, K) and wᵀ (N, K),
    both K-major, dims (K, rows), rows K bytes apart, box 128 K bytes by 64
    rows; the int32 out store map only without bn: dims (N, M), rows 4 N
    bytes apart, box 32 columns (128 bytes) by 16 rows, one consumer warp's
    staged piece. The extents zero-fill ragged loads and drop ragged stores."""
    x = torch.empty(M, K, dtype=torch.int8, device="meta")
    wt = torch.empty(N, K, dtype=torch.int8, device="meta")
    want = [K, M, K, 128, 64, K, N, K, 128, 64] + ([] if bn else [N, M, 4 * N, 32, 16])
    assert port._s8_plan(x, wt, bn) == want


@pytest.mark.parametrize("bn", [None, 16])
def test_s8_launch_transposes_then_runs_the_engine(fake_cuda, bn):
    """An int8 product is one call of the library's entry point, which is
    handed w as given and this call's own (N, K) scratch for wᵀ, the 15-value
    plan whose wᵀ map is that scratch's, and counts one transpose and one s8
    engine launch; nothing calls torch._int_mm, torch.mm or a plain version.
    In the entry point the transpose is launched before the engine, on the
    same stream (read from the source)."""
    x, w = torch.zeros(48, 272, dtype=torch.int8), torch.zeros(272, 400, dtype=torch.int8)
    counts = (port.LAUNCHES, port.TRANSPOSE_LAUNCHES, port.INSTANCE_LAUNCHES["s8_wgmma"])
    out = port._launch(x, w, bn)
    (call,) = fake_cuda.calls
    assert not fake_cuda.transposes  # not a second library call
    assert call[0] == x.data_ptr() and call[1] == w.data_ptr()
    assert call[2] not in (None, w.data_ptr(), x.data_ptr())
    assert call[5:11] == (48, 400, 272, 0, bn or 0, x.device.index)  # the card, made current in C
    assert _plan(call[3], 10 if bn else 15)[5:7] == [272, 400]
    assert (port.LAUNCHES, port.TRANSPOSE_LAUNCHES, port.INSTANCE_LAUNCHES["s8_wgmma"]) == tuple(
        c + 1 for c in counts)
    assert out.shape == ((48, 400 // bn) if bn else (48, 400))
    assert out.dtype == (torch.float32 if bn else torch.int32)
    src = port.SOURCE.read_text()
    entry = src[src.index("int novic_tiled_matmul("):src.index("int novic_transpose_s8(")]
    s8 = entry[entry.index("case kS8:"):entry.index("case kBF16:")]
    assert s8.index("launch_transpose(w, wt") < s8.index("launch_s8(x, wt")


@pytest.mark.parametrize("K,N", [(272, 400), (16, 16), (1040, 48), (128, 4096), (48, 144)])
def test_transpose_s8_plain_version(K, N):
    """The transpose's plain version is wᵀ, contiguous, at K and N that are not
    multiples of the kernel's 128-byte tile (and some that are)."""
    w = np.random.default_rng(K * N).integers(-128, 128, size=(K, N), dtype=np.int8)
    got = port.transpose_s8(torch.from_numpy(w))
    assert got.dtype == torch.int8 and got.shape == (N, K) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.ascontiguousarray(w.T))


def test_transpose_s8_launch_and_refusals(fake_cuda):
    """`transpose_s8` alone launches its own entry point with w, an (N, K)
    scratch and (K, N), counted; it refuses what its kernel does not take."""
    w = torch.zeros(272, 400, dtype=torch.int8)
    before = port.TRANSPOSE_LAUNCHES
    wt = port._launch_transpose(w)
    (call,) = fake_cuda.transposes
    assert call[0] == w.data_ptr() and call[1] == wt.data_ptr() and call[2:4] == (272, 400)
    assert wt.shape == (400, 272) and port.TRANSPOSE_LAUNCHES == before + 1
    with pytest.raises(ValueError, match="2-D int8"):
        port.transpose_s8(torch.zeros(16, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        port.transpose_s8(torch.zeros(16, 16, dtype=torch.int8, device="meta"))
