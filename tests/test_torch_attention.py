"""Port attention (novic_tpu_torch.ops.attention) against the JAX Pallas kernel.

On the CPU the port's `fused_attention` takes its plain version; the JAX side
runs the Pallas kernel in interpret mode. Tolerance 2e-4 (abs and rel), the bar
of tests/test_pallas_attention.py: both round the same operands to bf16 and
differ only in the order of float32 sums.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from novic_tpu.ops.attention import fused_attention as jax_fused_attention
from novic_tpu_torch.ops import attention as port

torch.set_num_threads(2)
TOL = 2e-4


def _qkv(seed, B, S, H, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(3)]


def _causal(S):
    i = np.arange(S)
    return np.where(i[None, :] <= i[:, None], 0.0, -1e30).astype(np.float32)


@pytest.mark.parametrize("S,hd,causal", [(64, 64, False), (100, 64, False), (196, 64, False),
                                         (50, 72, False), (48, 32, True)])
def test_fused_attention_matches_pallas(S, hd, causal):
    q, k, v = _qkv(S + hd, 2, S, 4, hd)
    bias = _causal(S) if causal else None
    ref = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         None if bias is None else jnp.asarray(bias),
                                         interpret=True))
    launches = port.LAUNCHES
    out = port.fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               None if bias is None else torch.from_numpy(bias))
    assert port.LAUNCHES == launches  # the CPU path launches no kernel
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_causal_bias_enforced():
    q, k, v = _qkv(1, 2, 24, 2, 16)
    bias = torch.from_numpy(_causal(24))
    out = port.fused_attention(*(torch.from_numpy(x) for x in (q, k, v)), bias)
    v2 = v.copy()
    v2[:, 1:] = 0.0
    out2 = port.fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v2), bias)
    np.testing.assert_allclose(out[:, 0].numpy(), out2[:, 0].numpy(), atol=1e-6)


def test_non_cpu_tensors_never_take_the_plain_path(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises: with the kernel's
    library made unloadable, the launch raises instead of running the plain
    version, and a device that is neither CPU nor CUDA is refused."""
    called = []
    monkeypatch.setattr(port, "attention_reference", lambda *a: called.append(a))

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(port, "_library", no_library)
    q = torch.zeros(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.fused_attention(q, q, q)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        port._launch(q, q, q, None)
    assert not called


# Ragged S (a single key; one key past a 64-key tile; one query past a
# 128-query block) at hd 8 (one k-step, zero-filled past hd), 80 (two atoms,
# three consumer warpgroups) and 128, without and with the causal bias
RAGGED = [(S, hd, False) for S in (1, 65, 129) for hd in (8, 80, 128)]
RAGGED += [(S, 80, True) for S in (1, 65, 129)]


@pytest.mark.parametrize("S,hd,causal", RAGGED, ids=[f"S{s}-hd{h}-{'causal' if c else 'none'}"
                                                     for s, h, c in RAGGED])
def test_plain_version_matches_pallas_at_ragged_shapes(S, hd, causal):
    """Bar: the kernel's on the card (chip_smoke.py phase 3). Where two row
    sums differ in their last bit, a normalised p can round to bf16 one ulp
    (<= 2^-7 p) apart, which moves an output by up to 2^-7 * max|v| over the
    keys; elementwise |out - ref| <= TOL + 2^-7 * max|v|."""
    q, k, v = _qkv(7 * S + hd, 2, S, 3, hd)
    bias = _causal(S) if causal else None
    ref = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         None if bias is None else jnp.asarray(bias),
                                         interpret=True))
    out = port.fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               None if bias is None else torch.from_numpy(bias))
    vmax = np.abs(v.astype(np.float32)).max(axis=1, keepdims=True)  # over keys
    assert np.isfinite(out.numpy()).all()
    assert (np.abs(out.numpy() - ref) <= TOL + 2.0 ** -7 * vmax).all()


def _expected_plan(B, S, H, hd):
    """K1's maps of the pre-pass's contiguous bf16 (B, S, H, hd) copies: dims
    (hd, S, H, B), byte strides of S, H and B (a size-1 S is never stepped and
    gets the span of a head row), a box of one 64-wide atom by the query block
    (128 rows where hd <= 64, else 192) for q and by 64 keys for k and v."""
    strides = [H * hd * 2 if S > 1 else hd * 2, hd * 2, S * H * hd * 2]
    plan = []
    for rows in (128 if hd <= 64 else 192, 64, 64):
        plan += [hd, S, H, B] + strides + [64, rows, 1, 1]
    return plan


TOWER_SHAPES = [(64, 196, 12, 64), (32, 730, 16, 80), (8, 729, 16, 72), (8, 77, 8, 64),
                (2, 1, 3, 128), (2, 65, 3, 8)]


@pytest.mark.parametrize("B,S,H,hd", TOWER_SHAPES)
def test_k1_tma_plan(B, S, H, hd):
    scratch = torch.empty(3, B, S, H, hd, dtype=torch.bfloat16, device="meta")
    assert port._tma_plans(scratch) == _expected_plan(B, S, H, hd)


class _FakeLibrary:
    """Records each launch's arguments, and the plan they point at, and
    returns a CUDA error code."""

    def __init__(self, err: int = 0):
        self.err, self.calls, self.plans = err, [], []

    def novic_attention(self, *args):
        import ctypes

        self.calls.append(args)
        self.plans.append(list((ctypes.c_longlong * 33).from_address(args[6].value)))
        return self.err


@pytest.fixture
def fake_launch(monkeypatch):
    """The kernel's library replaced by a recorder, CPU tensors standing in
    for CUDA ones, and the plain version made to fail if reached."""
    import contextlib
    import types

    lib = _FakeLibrary()
    monkeypatch.setattr(port, "_library", lambda: lib)
    monkeypatch.setattr(port.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(port.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))

    def plain(*args):
        raise AssertionError("a kernel launch reached the plain version")

    monkeypatch.setattr(port, "attention_reference", plain)
    return lib


def _aligned_f32(shape, offset: int = 0) -> torch.Tensor:
    """A contiguous float32 tensor whose base lies `offset` elements past a
    16-byte boundary."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 8)
    start = (-flat.data_ptr() // 4) % 4 + offset
    return flat[start:start + n].view(shape)


@pytest.mark.parametrize("B,S,H,hd", [(2, 196, 3, 64), (2, 730, 2, 80), (2, 1, 3, 128),
                                      (2, 65, 3, 8)])
@pytest.mark.parametrize("causal", [False, True])
def test_k1_instance_every_shape_launches_the_wgmma_kernel(fake_launch, B, S, H, hd, causal):
    """K1 has one instance, the TMA + wgmma kernel behind its bf16 pre-pass:
    every shape the wrapper takes launches it once, with a bf16 scratch
    buffer for the pre-pass, the maps of that buffer, the shape, the scale
    1/sqrt(hd) and the bias; the launch is counted."""
    q, k, v = (_aligned_f32((B, S, H, hd)) for _ in range(3))
    bias = torch.from_numpy(_causal(S)) if causal else None
    launches = port.LAUNCHES
    out = port._launch(q, k, v, bias)
    assert out.shape == q.shape and out.dtype == torch.float32
    (args,) = fake_launch.calls
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[3] == (bias.data_ptr() if causal else None) and args[4] == out.data_ptr()
    assert args[5] is not None and args[5] % 16 == 0  # the scratch buffer
    assert fake_launch.plans == [_expected_plan(B, S, H, hd)]
    assert args[7:11] == (B, S, H, hd) and args[11] == pytest.approx(1 / np.sqrt(hd))
    assert port.LAUNCHES == launches + 1


@pytest.mark.parametrize("bad", ["unaligned", "hd12", "hd136", "bias_shape", "strided", "dtype"])
def test_k1_refuses_what_the_kernel_cannot_take(fake_launch, bad):
    """What the kernel cannot take is refused before any launch: a base off a
    16-byte boundary (TMA and the pre-pass's 16-byte loads), hd not a multiple
    of 8 or above 128, a bias that is not (S, S), a non-contiguous or a
    non-float32 tensor."""
    shape = {"hd12": (2, 10, 2, 12), "hd136": (2, 10, 2, 136)}.get(bad, (2, 10, 2, 16))
    q = _aligned_f32(shape, 1 if bad == "unaligned" else 0)
    k = v = _aligned_f32(shape)
    bias = torch.zeros(10, 9) if bad == "bias_shape" else None
    if bad == "strided":
        q = torch.zeros(2, 10, 4, 16)[:, :, ::2]
    if bad == "dtype":
        q = q.double()
    with pytest.raises(ValueError):
        port._launch(q, k, v, bias)
    assert not fake_launch.calls


def test_k1_refused_launch_raises_and_never_falls_back(fake_launch):
    """A launch the kernel refuses (a nonzero CUDA error) raises, counts
    nothing and never reaches the plain version."""
    fake_launch.err = 1  # cudaErrorInvalidValue
    q = _aligned_f32((2, 10, 2, 16))
    launches = port.LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        port._launch(q, q, q, None)
    assert port.LAUNCHES == launches


# -- the per-row key bias (ALIGN's BERT pad mask) --------------------------------


def _pad_key_bias(B, S, seed):
    """BERT's additive pad mask: key 0 ([CLS]) and a ragged prefix kept, the
    rest -1e30, as novic_tpu's BertTextTower derives it from ids == pad."""
    lengths = np.random.default_rng(seed).integers(1, S + 1, size=B)
    lengths[0] = 1  # a row that keeps only [CLS]
    keep = np.arange(S)[None, :] < lengths[:, None]
    return np.where(keep, 0.0, -1e30).astype(np.float32)


@pytest.mark.parametrize("B,S,hd", [(3, 10, 16), (4, 129, 64), (2, 64, 112)])
def test_key_bias_matches_pallas_per_row(B, S, hd):
    """The (B, S) key bias against novic_tpu's Pallas kernel given, batch row
    by batch row, that row's mask broadcast over the queries (the (B, 1, 1, S)
    bias novic_tpu's BERT adds); the kernel's bar."""
    q, k, v = _qkv(B * S + hd, B, S, 3, hd)
    key_bias = _pad_key_bias(B, S, seed=S)
    ref = np.concatenate([np.asarray(jax_fused_attention(
        jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]), jnp.asarray(v[b:b + 1]),
        jnp.asarray(np.broadcast_to(key_bias[b], (S, S)).copy()), interpret=True))
        for b in range(B)])
    launches = port.LAUNCHES
    out = port.fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               key_bias=torch.from_numpy(key_bias))
    assert port.LAUNCHES == launches
    vmax = np.abs(v).max(axis=1, keepdims=True)
    assert np.isfinite(out.numpy()).all()
    assert (np.abs(out.numpy() - ref) <= TOL + 2.0 ** -7 * vmax).all()


def test_key_bias_masked_tile_adds_exactly_zero():
    """A whole 64-key tile masked with -1e30 contributes exactly 0: changing
    v there changes no output bit (every row keeps key 0)."""
    B, S, hd = 2, 150, 64
    q, k, v = _qkv(11, B, S, 2, hd)
    key_bias = np.zeros((B, S), np.float32)
    key_bias[:, 64:128] = -1e30
    out = port.fused_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               key_bias=torch.from_numpy(key_bias))
    v2 = v.copy()
    v2[:, 64:128] = 1e3
    out2 = port.fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v2),
                                key_bias=torch.from_numpy(key_bias))
    assert torch.equal(out, out2)


def test_key_bias_with_bias_is_refused():
    q = torch.zeros(2, 8, 1, 16)
    with pytest.raises(ValueError, match="not both"):
        port.fused_attention(q, q, q, torch.zeros(8, 8), torch.zeros(2, 8))


@pytest.mark.parametrize("B,S,H,hd", [(2, 64, 3, 64), (3, 65, 2, 112), (4, 1, 2, 8)])
def test_k1_key_bias_launch_arguments(fake_launch, B, S, H, hd):
    """A (B, S) key bias launches the same kernel with the bias pointer, the
    same plan, shape and scale, and the key-bias flag (the last argument) set;
    an (S, S) bias or none leaves the flag 0."""
    q, k, v = (_aligned_f32((B, S, H, hd)) for _ in range(3))
    key_bias = torch.from_numpy(_pad_key_bias(B, S, seed=1))
    launches = port.LAUNCHES
    out = port._launch(q, k, v, None, key_bias)
    port._launch(q, k, v, torch.from_numpy(_causal(S)))
    port._launch(q, k, v, None)
    (args, shared, none) = fake_launch.calls
    assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
                        out.data_ptr())
    assert fake_launch.plans[0] == _expected_plan(B, S, H, hd)
    assert args[7:11] == (B, S, H, hd) and args[11] == pytest.approx(1 / np.sqrt(hd))
    assert (args[13], shared[13], none[13]) == (1, 0, 0)
    assert port.LAUNCHES == launches + 3


@pytest.mark.parametrize("bad", ["both", "shape", "dtype", "strided"])
def test_k1_key_bias_refusals(fake_launch, bad):
    """Both biases at once, a key bias that is not (B, S), not float32 or not
    contiguous: refused before any launch."""
    q = _aligned_f32((2, 10, 2, 16))
    key_bias = {"shape": torch.zeros(10, 10), "dtype": torch.zeros(2, 10, dtype=torch.float64),
                "strided": torch.zeros(2, 20)[:, ::2]}.get(bad, torch.zeros(2, 10))
    bias = torch.zeros(10, 10) if bad == "both" else None
    with pytest.raises(ValueError):
        port._launch(q, q, q, bias, key_bias)
    assert not fake_launch.calls
