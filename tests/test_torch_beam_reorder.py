"""Beam KV-cache permutation (novic_tpu_torch.ops.beam_reorder) against the JAX package.

The plain version and the CPU wrappers equal the one-hot reorder of
novic_tpu.models.generate (reorder mode) in value, float32 and bfloat16, with
repeated candidates; the many form equals the per-cache form; off the CPU the
wrappers launch the kernel or raise. The kernel itself runs on the card
(chip_smoke.py phase 3d).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from novic_tpu_torch.ops import beam_reorder as port

torch.set_num_threads(2)


def jax_reorder(x: np.ndarray, cand: np.ndarray, dtype) -> np.ndarray:
    """novic_tpu/models/generate.py's reorder-mode permutation, verbatim."""
    B, H = cand.shape
    xj = jnp.asarray(x, dtype=dtype)
    onehot = jax.nn.one_hot(jnp.asarray(cand), H, dtype=xj.dtype)  # (B, Hout, Hin)
    xr = xj.reshape(B, H, -1)
    out = jnp.einsum("bij,bjf->bif", onehot, xr, preferred_element_type=xr.dtype)
    return np.asarray(out.reshape(x.shape).astype(jnp.float32))


def _inputs(B, H, row_shape, seed, repeat=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B * H,) + row_shape).astype(np.float32)
    if repeat:  # candidates repeat: most rows take parent 0 or 1
        cand = rng.integers(0, min(H, 2), size=(B, H))
        cand[:, -1] = H - 1
    else:
        cand = np.stack([rng.permutation(H) for _ in range(B)])
    return x, cand


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("repeat", [True, False])
def test_reference_matches_jax_one_hot(dtype, repeat):
    x, cand = _inputs(3, 5, (7, 4, 8), seed=0, repeat=repeat)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    ref = jax_reorder(x, cand, getattr(jnp, dtype))
    for cand_dtype in (torch.int64, torch.int32):
        ct = torch.from_numpy(cand).to(cand_dtype)
        out = port.reorder_reference(xt, ct)
        assert out.dtype == tdt and out.shape == xt.shape
        np.testing.assert_array_equal(out.float().numpy(), ref)
        np.testing.assert_array_equal(port.beam_reorder(xt, ct).float().numpy(), ref)
    # The gather it stands for
    gathered = xt.reshape(3, 5, -1)[torch.arange(3)[:, None], torch.from_numpy(cand)]
    np.testing.assert_array_equal(gathered.reshape(xt.shape).float().numpy(), ref)


def test_negative_zero_compares_equal_in_value():
    """The one-hot product turns -0.0 into +0.0; the kernel copies the bits.
    Both are the same value, which is what the tests and chip_smoke.py compare."""
    x = torch.tensor([[-0.0, 1.0], [2.0, -0.0]]).reshape(2, 2)
    cand = torch.tensor([[1, 0]])
    out = port.reorder_reference(x, cand)
    assert torch.equal(out, torch.tensor([[2.0, 0.0], [0.0, 1.0]]))


def test_out_of_range_candidate_is_a_zero_row_like_jax():
    x, cand = _inputs(2, 3, (4,), seed=1)
    cand[0, 1] = 3
    cand[1, 2] = -1
    ref = jax_reorder(x, cand, jnp.float32)
    out = port.reorder_reference(torch.from_numpy(x), torch.from_numpy(cand))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert not out.reshape(2, 3, -1)[0, 1].any() and not out.reshape(2, 3, -1)[1, 2].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_many_form_equals_per_cache_form(dtype):
    B, H, G, heads, hd = 2, 4, 3, 2, 8
    rng = np.random.default_rng(2)
    xs = [torch.from_numpy(rng.normal(size=(B * H, G, heads, hd)).astype(np.float32)).to(dtype)
          for _ in range(5)]
    cand = torch.from_numpy(rng.integers(0, H, size=(B, H)))
    many = port.beam_reorder_many(xs, cand)
    for x, m in zip(xs, many):
        assert torch.equal(m, port.beam_reorder(x, cand))
    # Into preallocated outputs (the ping-pong set of generate_beam)
    out = [torch.empty_like(x) for x in xs]
    got = port.beam_reorder_many(xs, cand, out=out)
    assert all(g is o for g, o in zip(got, out))
    assert all(torch.equal(o, m) for o, m in zip(out, many))


def test_operands_are_checked():
    x = torch.zeros(6, 3, 4)
    cand = torch.zeros(2, 3, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32 or int64"):
        port.beam_reorder(x, cand.float())
    with pytest.raises(ValueError, match="cannot be viewed"):
        port.beam_reorder(torch.zeros(7, 3), cand)
    with pytest.raises(ValueError, match="differ in shape or dtype"):
        port.beam_reorder_many([x, x.double()], cand)
    with pytest.raises(ValueError, match="alias"):
        port.beam_reorder(x, cand, out=x)
    with pytest.raises(ValueError, match="one tensor per cache"):
        port.beam_reorder_many([x, x.clone()], cand, out=[torch.empty_like(x)])
    with pytest.raises(ValueError, match="no caches"):
        port.beam_reorder_many([], cand)


def test_wrappers_raise_off_the_cpu_and_never_fall_back(monkeypatch):
    """Off the CPU the wrappers launch the kernel or raise: with the kernel's
    library made unloadable the launch raises instead of running the plain
    version; a device that is neither CPU nor CUDA and mixed devices are refused."""
    called = []
    monkeypatch.setattr(port, "reorder_reference", lambda *a: called.append(a))

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(port, "_library", no_library)
    launches = port.LAUNCHES
    x = torch.zeros(6, 3, 4, device="meta")
    cand = torch.zeros(2, 3, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.beam_reorder(x, cand)
    with pytest.raises(ValueError, match="unsupported device"):
        port.beam_reorder_many([x, x], cand)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        port._launch([x, x], cand, None)
    with pytest.raises(ValueError, match="mixed devices"):
        port.beam_reorder(x, torch.zeros(2, 3, dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        port._launch([x.transpose(1, 2)], cand, None)
    assert not called
    assert port.LAUNCHES == launches
