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
