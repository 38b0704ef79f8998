"""Port int8 W8A8 dense (novic_tpu_torch.ops.int8_matmul) against the JAX package.

On the CPU the port's GEMMs take their plain versions (a float64 product of
the int8 values, exact, then the dequant as separate float32 torch ops); the
JAX side runs XLA's int8 dot or the Pallas kernel in interpret mode. Both
compute the same integers and round the same float32 ops in the same order, so
every comparison here is exact equality, not a tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import novic_tpu.ops.int8_matmul as jint8
from novic_tpu.embedders import vit as jvit
from novic_tpu_torch.embedders import vit
from novic_tpu_torch.ops import int8_matmul as port

torch.set_num_threads(2)


@pytest.fixture
def interpreted_pallas(monkeypatch):
    orig = jint8.int8_matmul_pallas
    monkeypatch.setattr(jint8, "int8_matmul_pallas",
                        lambda xq, wq_t, **kw: orig(xq, wq_t, **{**kw, "interpret": True}))


def _equal(port_tensor: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    out = port_tensor.float().numpy() if port_tensor.dtype == torch.bfloat16 else port_tensor.numpy()
    if ref.dtype == jnp.bfloat16:
        ref = ref.astype(np.float32)
    assert out.shape == ref.shape and out.dtype == ref.dtype, (out.shape, ref.shape, out.dtype)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("scale,dtype,shape", [(0.01, "float32", (64, 96)), (1.0, "float32", (3, 7, 96)),
                                               (5.0, "float32", (64, 96)), (1.0, "bfloat16", (64, 96)),
                                               (0.3, "bfloat16", (2, 5, 768))])
def test_quantize_rows_equals_jax(scale, dtype, shape):
    rng = np.random.default_rng(int(scale * 100) + len(shape))
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    x.reshape(-1, shape[-1])[1] = 0.0  # an all-zero row: the 1e-12 floor
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jq, js = jint8.quantize_rows(jx)
    tq, ts = port.quantize_rows(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == shape[:-1] + (1,)
    _equal(tq, jq)
    _equal(ts, js)
    assert float(ts.reshape(-1)[1]) == np.float32(1e-12)


def test_quantize_weight_equals_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3072, 96)).astype(np.float32) * rng.uniform(0.01, 5.0, size=(3072, 1))
    w[5] = 0.0
    wq, sw = port.quantize_weight(torch.from_numpy(w))
    jq, js = jint8.quantize_weight(jnp.asarray(w))
    _equal(wq, jq)
    _equal(sw, js)


@pytest.mark.parametrize("m,k,n,bk", [(64, 128, 256, 0), (40, 70, 200, 0), (512, 1280, 640, 0),
                                      (128, 1280, 256, 512), (257, 384, 256, 0)])
def test_int8_matmul_equals_pallas(m, k, n, bk):
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(n, k)).astype(np.int8)  # torch layout (N, K)
    want = jint8.int8_matmul_pallas(jnp.asarray(xq), jnp.asarray(wq.T), bm=64, bn=128, bk=bk,
                                    interpret=True)
    launches = port.LAUNCHES
    got = port.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq))
    assert port.LAUNCHES == launches  # the CPU path launches no kernel
    assert got.dtype == torch.int32
    _equal(got, want)


def test_int8_matmul_reference_is_exact_at_the_largest_sums():
    """|acc| near K * 127^2 at K = 3072 (past 2^24): the float64 product is exact."""
    xq = torch.full((4, 3072), 127, dtype=torch.int8)
    xq[1] = -127
    wq = torch.full((3, 3072), 127, dtype=torch.int8)
    wq[2, ::2] = -127
    got = port.int8_matmul(xq, wq)
    want = xq.long() @ wq.long().t()
    assert torch.equal(got.long(), want) and int(want.abs().max()) == 3072 * 127 * 127


@pytest.mark.parametrize("impl,with_bias", [("xla", False), ("xla", True), ("pallas", False),
                                            ("pallas", True)])
def test_int8_dense_equals_jax(impl, with_bias):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 33, 96)).astype(np.float32)
    w = rng.normal(size=(200, 96)).astype(np.float32)
    b = rng.normal(size=(200,)).astype(np.float32) if with_bias else None
    jq, js = jint8.quantize_weight(jnp.asarray(w))
    want = jint8.int8_dense(jnp.asarray(x), jq, js, None if b is None else jnp.asarray(b),
                            impl=impl, interpret=True)
    wq, sw = port.quantize_weight(torch.from_numpy(w))
    got = port.int8_dense(torch.from_numpy(x), wq, sw, None if b is None else torch.from_numpy(b))
    _equal(got, want)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_dequant_epilogues_equal_the_jax_expressions(out_dtype):
    """float32 (+ bias): int8_dense's (acc * sx) * sw + b; bfloat16: the fused
    dequant of exp/pallas_int8_mlp_chain.py, bf16(acc * sx * sw), in JAX."""
    rng = np.random.default_rng(6)
    xq = rng.integers(-127, 128, size=(48, 3072)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(80, 3072)).astype(np.int8)
    sx = rng.uniform(1e-4, 0.05, size=(48, 1)).astype(np.float32)
    sw = rng.uniform(1e-4, 0.05, size=(80,)).astype(np.float32)
    b = rng.normal(size=(80,)).astype(np.float32)
    acc = jax.lax.dot_general(jnp.asarray(xq), jnp.asarray(wq), (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * jnp.asarray(sx) * jnp.asarray(sw)[None, :]
    tdt = getattr(torch, out_dtype)
    if out_dtype == "float32":
        want, bias = y + jnp.asarray(b), torch.from_numpy(b)
    else:
        want, bias = y.astype(jnp.bfloat16), None
    got = port.int8_matmul_dequant(torch.from_numpy(xq), torch.from_numpy(sx), torch.from_numpy(wq),
                                   torch.from_numpy(sw), bias, tdt)
    assert got.dtype == tdt
    _equal(got, want)


@pytest.mark.parametrize("quant", ["int8", "int8:pallas"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_quantized_tower_dense_equals_jax(interpreted_pallas, quant, in_dtype):
    """One quantized tower_dense layer, fed the same inputs: bit-identical."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 17, 64)).astype(np.float32)
    w = rng.normal(size=(256, 64)).astype(np.float32) * 0.125
    b = rng.normal(size=(256,)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if in_dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = jvit.tower_dense(jx, jnp.asarray(w), jnp.asarray(b), "bfloat16", quant)
    got = vit.tower_dense(tx, torch.from_numpy(w), torch.from_numpy(b), "bfloat16", quant)
    _equal(got, want)
    # The unquantized layer is a different function
    plain = vit.tower_dense(tx, torch.from_numpy(w), torch.from_numpy(b), "bfloat16")
    assert not torch.equal(plain, got)


@pytest.mark.parametrize("quant", ["int4", "fp8:pallas", "int8:triton"])
def test_unknown_quant_modes_raise_like_jax(quant):
    x, w = np.zeros((2, 8), np.float32), np.ones((4, 8), np.float32)
    with pytest.raises(ValueError):
        jvit.tower_dense(jnp.asarray(x), jnp.asarray(w), None, "float32", quant)
    with pytest.raises(ValueError):
        vit.tower_dense(torch.from_numpy(x), torch.from_numpy(w), None, "float32", quant)
    with pytest.raises(ValueError):
        vit.TowerBlock(8, 2, 16, "gelu", 1e-6, "float32", quant)


def test_wrappers_raise_off_the_cpu_and_never_fall_back(monkeypatch):
    """Off the CPU the wrappers launch the kernel or raise: with the kernel's
    library made unloadable the launch raises instead of running the plain
    version; a device that is neither CPU nor CUDA, mixed devices and operands
    the kernel does not take are refused."""
    called = []
    monkeypatch.setattr(port, "int8_matmul_reference", lambda *a: called.append(a))
    monkeypatch.setattr(port, "int8_matmul_dequant_reference", lambda *a: called.append(a))

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(port, "_library", no_library)
    xq = torch.zeros(4, 32, dtype=torch.int8, device="meta")
    wq = torch.zeros(8, 32, dtype=torch.int8, device="meta")
    sx, sw = torch.ones(4, device="meta"), torch.ones(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.int8_matmul(xq, wq)
    with pytest.raises(ValueError, match="unsupported device"):
        port.int8_matmul_dequant(xq, sx, wq, sw)
    with pytest.raises(ValueError, match="unsupported device"):
        port.int8_dense(torch.zeros(4, 32, device="meta"), wq, sw, None)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        port._launch(xq, wq, None, None, None, torch.int32)
    with pytest.raises(ValueError, match="mixed devices"):
        port.int8_matmul(xq, torch.zeros(8, 32, dtype=torch.int8))
    with pytest.raises(ValueError, match="differ in K"):
        port._launch(xq, wq[:, :16], None, None, None, torch.int32)
    with pytest.raises(ValueError, match="float32"):
        port._launch(xq, wq, sx.double(), sw, None, torch.float32)
    with pytest.raises(ValueError, match="no bias"):
        port.int8_matmul_dequant(xq, sx, wq, sw, torch.ones(8), torch.bfloat16)
    with pytest.raises(ValueError, match="out_dtype"):
        port.int8_matmul_dequant(xq, sx, wq, sw, None, torch.int32)
    assert not called


@pytest.mark.parametrize("M,K,N", [(12544, 768, 3072), (12544, 3072, 768), (16384, 1280, 5120),
                                   (1, 16, 16), (129, 768, 200), (300, 1040, 199)])
def test_k2_tma_plan(M, K, N):
    """xq (M, K) and wq (N, K), both K-major: dims (K, rows), rows K bytes
    apart, a box of 128 K bytes (one swizzled row) by 64 rows (half a tile,
    multicast into the blocks of a cluster that share it); the extents
    zero-fill the ragged edges."""
    xq = torch.empty(M, K, dtype=torch.int8, device="meta")
    wq = torch.empty(N, K, dtype=torch.int8, device="meta")
    assert port._tma_plan(xq, wq) == [K, M, K, 128, 64, K, N, K, 128, 64]


class _FakeLibrary:
    """Records each launch's arguments and returns a CUDA error code."""

    def __init__(self, err: int = 0):
        self.err, self.calls = err, []

    def novic_int8_matmul(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def fake_launch(monkeypatch):
    """The kernel's library replaced by a recorder, CPU tensors standing in
    for CUDA ones, and the plain versions made to fail if reached."""
    import contextlib
    import types

    lib = _FakeLibrary()
    monkeypatch.setattr(port, "_library", lambda: lib)
    monkeypatch.setattr(port.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(port.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))

    def plain(*args):
        raise AssertionError("a kernel launch reached the plain version")

    monkeypatch.setattr(port, "int8_matmul_reference", plain)
    monkeypatch.setattr(port, "int8_matmul_dequant_reference", plain)
    monkeypatch.setattr(port, "INSTANCE_LAUNCHES", {"wgmma": 0, "mma_sync": 0})
    return lib


def _aligned_int8(rows: int, K: int, offset: int = 0) -> torch.Tensor:
    """A contiguous (rows, K) int8 tensor whose base lies `offset` bytes past a
    16-byte boundary."""
    flat = torch.zeros(rows * K + 32, dtype=torch.int8)
    start = (-flat.data_ptr()) % 16 + offset
    return flat[start:start + rows * K].view(rows, K)


@pytest.mark.parametrize("case,want", [("aligned", "wgmma"), ("k16", "wgmma"), ("k70", "mma_sync"),
                                       ("k0", "mma_sync"), ("x_unaligned", "mma_sync"),
                                       ("w_unaligned", "mma_sync")])
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.float32, torch.bfloat16])
def test_k2_instance_by_shape(fake_launch, case, want, out_dtype):
    """The wrapper picks K2's instance by shape and alignment alone: the
    Hopper (wgmma) instance, with its tensor-map plan, where K is a positive
    multiple of 16 and both bases are 16-byte aligned; else the mma.sync
    instance, with no plan. Each launch is counted under its instance."""
    import ctypes

    M, N = 40, 24
    K = {"k16": 16, "k70": 70, "k0": 0}.get(case, 768)
    xq = _aligned_int8(M, K, 1 if case == "x_unaligned" else 0)
    wq = _aligned_int8(N, K, 3 if case == "w_unaligned" else 0)
    assert port._instance(xq, wq) == want
    sx, sw = torch.ones(M), torch.ones(N)
    if out_dtype == torch.int32:
        out = port._launch(xq, wq, None, None, None, out_dtype)
    else:
        out = port._launch(xq, wq, sx, sw, None, out_dtype)
    assert out.shape == (M, N) and out.dtype == out_dtype
    (args,) = fake_launch.calls
    plan = args[2]
    if want == "wgmma":
        assert list((ctypes.c_longlong * 10).from_address(plan.value)) == port._tma_plan(xq, wq)
    else:
        assert plan is None
    assert args[7:11] == (M, N, K, {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}[out_dtype])
    assert port.INSTANCE_LAUNCHES == {"wgmma": int(want == "wgmma"), "mma_sync": int(want != "wgmma")}


@pytest.mark.parametrize("case", ["aligned", "k70"])
def test_k2_refused_launch_raises_and_never_falls_back(fake_launch, case):
    """A launch that the chosen instance refuses (a nonzero CUDA error) raises,
    names the instance, counts nothing and never reaches the plain version."""
    fake_launch.err = 1  # cudaErrorInvalidValue
    K = 70 if case == "k70" else 768
    xq, wq = _aligned_int8(8, K), _aligned_int8(16, K)
    launches = port.LAUNCHES
    instance = "mma_sync" if case == "k70" else "wgmma"
    with pytest.raises(RuntimeError, match=f"{instance} instance"):
        port._launch(xq, wq, None, None, None, torch.int32)
    assert port.LAUNCHES == launches and port.INSTANCE_LAUNCHES == {"wgmma": 0, "mma_sync": 0}


def test_k2_and_x3_share_one_s8_wgmma_engine():
    """K2's Hopper instance and X3's s8 path are one engine: int8_matmul.cu and
    tiled_matmul.cu both include int8_wgmma.cuh, which alone defines the
    wgmma kernel; each .cu launches its own epilogues of it (K2 the register
    ones, X3 the TMA-store int32 and the checksum), and K2's library still
    builds from its own source and the headers (read from the source text)."""
    from novic_tpu_torch.ops import build, tiled_matmul

    header = (build.CSRC / "int8_wgmma.cuh").read_text()
    k2_src, x3_src = port.SOURCE.read_text(), tiled_matmul.SOURCE.read_text()
    assert header.count("int8_wgmma_kernel(") == 1
    for src in (k2_src, x3_src):
        assert '#include "int8_wgmma.cuh"' in src
        assert "int8_wgmma_kernel" not in src
    for epi in ("kInt32", "kF32", "kBF16"):
        assert f"q8::launch_wgmma<{epi}>" in k2_src and f"launch_wgmma<q8::{epi}>" not in x3_src
    for epi in ("kInt32Tma", "kChecksum"):
        assert f"q8::launch_wgmma<q8::{epi}>" in x3_src and epi not in k2_src
    assert "mma_s8(" not in x3_src and "mma_common.cuh" not in x3_src
