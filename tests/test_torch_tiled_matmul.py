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
@pytest.mark.parametrize("bm,bn,bk", [(128, 128, 256), (256, 256, 128)])
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
