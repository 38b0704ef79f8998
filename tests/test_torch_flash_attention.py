"""Port one-pass attention (novic_tpu_torch.ops.flash_attention, X6) against
JAX's TPU flash-attention kernel (jax.experimental.pallas.ops.tpu
.flash_attention) run in TPU interpret mode on the CPU.

On the CPU the port's wrapper takes the kernel's plain version, which follows
JAX's blocking when given JAX's block_k: multi-step (blocks of 128 over
S=256: online updates with the unnormalised p rounded to bf16) and
single-step (block = S: the normalised p rounded). Inputs are numpy-seeded
bf16, hd 64 and 80, with a padding mask, packed segments, a query row whose
keys are all masked, Sq != Skv, and no segment ids.

Bar: both sides round the same operands to bf16 and sum in float32 in
another order, and exp differs in its last bits, so a p can round one bf16
ulp apart (<= 2^-7 p), which moves an output by at most 2^-7 * max|v| over
the keys; the bf16 output itself may then round one ulp apart. Each element
is held to one bf16 ulp of the JAX output plus 2^-7 * max|v|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds as JSegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

from novic_tpu_torch.ops import flash_attention as port

torch.set_num_threads(2)


def _ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _inputs(seed, B, H, sq, skv, hd, seg):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, n, hd)).astype(np.float32) for n in (sq, skv, skv))
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    q, k, v = bf(q), bf(k), bf(v)
    seg_q = seg_kv = None
    if seg == "padding":
        seg_q = np.zeros((B, sq), np.int32)
        seg_q[:, : sq - sq // 5] = 1
        seg_kv = np.zeros((B, skv), np.int32)
        seg_kv[:, : skv - skv // 5] = 1
    elif seg == "packed":
        seg_q = np.where(np.arange(sq) < sq // 3, 1, 2).astype(np.int32)[None].repeat(B, 0)
        seg_kv = np.where(np.arange(skv) < skv // 3, 1, 2).astype(np.int32)[None].repeat(B, 0)
    elif seg == "masked_row":
        seg_q = np.ones((B, sq), np.int32)
        seg_q[:, 5] = 7  # no key has segment 7
        seg_kv = np.ones((B, skv), np.int32)
    return q, k, v, seg_q, seg_kv


def _jax(q, k, v, seg_q, seg_kv, scale, block):
    f = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    segs = None if seg_q is None else JSegmentIds(q=jnp.asarray(seg_q), kv=jnp.asarray(seg_kv))
    bs = BlockSizes(block_q=min(block, q.shape[2]), block_k_major=block, block_k=block, block_b=1)
    with pltpu.force_tpu_interpret_mode():
        out = jax_flash(f(q), f(k), f(v), segment_ids=segs, sm_scale=scale, block_sizes=bs)
    assert out.dtype == jnp.bfloat16
    return np.asarray(out.astype(jnp.float32))


CASES = [  # (hd, sq, skv, block, segments)
    (64, 256, 256, 128, "padding"),
    (80, 256, 256, 128, "padding"),
    (64, 256, 256, 256, "padding"),
    (80, 256, 256, 256, "padding"),
    (80, 256, 256, 128, "packed"),
    (64, 256, 256, 256, "packed"),
    (64, 256, 256, 128, "masked_row"),
    (80, 256, 256, 256, "masked_row"),
    (64, 128, 256, 128, "padding"),
    (80, 256, 256, 128, None),
]


@pytest.mark.parametrize("hd,sq,skv,block,seg", CASES,
                         ids=[f"hd{c[0]}-q{c[1]}-kv{c[2]}-b{c[3]}-{c[4]}" for c in CASES])
def test_plain_version_matches_jax_flash_attention(hd, sq, skv, block, seg):
    q, k, v, seg_q, seg_kv = _inputs(hd + sq + block, 1, 2, sq, skv, hd, seg)
    scale = 1.0 / np.sqrt(hd)
    ref = _jax(q, k, v, seg_q, seg_kv, scale, block)
    segs = None if seg_q is None else port.SegmentIds(torch.from_numpy(seg_q), torch.from_numpy(seg_kv))
    out = port.flash_attention(q, k, v, segment_ids=segs, sm_scale=scale, block_k=block)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, sq, hd)
    out = out.float().numpy()
    vmax = v.float().abs().amax(dim=2, keepdim=True).numpy()  # over keys
    bar = _ulp(ref) + 2.0 ** -7 * vmax
    assert np.isfinite(out).all()
    assert (np.abs(out - ref) <= bar).all(), np.abs(out - ref).max()
    if seg == "masked_row":  # every key masked: the plain mean of v, as JAX gives
        mean = v.float().mean(dim=2).numpy()
        assert np.abs(out[:, :, 5] - mean).max() <= 2.0 ** -7 * vmax[:, :, 0].max() + 2e-2


def test_kernel_blocking_against_jax_blockings():
    """The kernel's blocking (64-key online updates, default block_k) against
    the single-step and 128-key blockings: every element moves by at most the
    rounding of each p (2^-8 relative wherever it is taken), 2^-8 * max|v|,
    plus one bf16 ulp of the output."""
    q, k, v, seg_q, seg_kv = _inputs(3, 2, 3, 200, 192, 80, "padding")
    segs = port.SegmentIds(torch.from_numpy(seg_q), torch.from_numpy(seg_kv))
    own = port.flash_attention(q, k, v, segment_ids=segs, sm_scale=0.1).float()
    assert torch.equal(own, port.flash_attention_reference(q, k, v, segs, 0.1).float())
    vmax = v.float().abs().amax(dim=2, keepdim=True)
    for block in (128, 192):
        other = port.flash_attention_reference(q, k, v, segs, 0.1, block_k=block).float()
        bar = torch.from_numpy(_ulp(other.numpy())) + 2.0 ** -8 * vmax + 1e-6
        assert ((own - other).abs() <= bar).all(), block


def test_strided_views_and_one_key():
    """(B, S, H, hd) projections read as (B, H, S, hd) views; S = 1."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 1, 3, 16)).astype(np.float32)).to(torch.bfloat16)
    out = port.flash_attention(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2))
    torch.testing.assert_close(out.float(), x.transpose(1, 2).float(), rtol=0, atol=0)
    q, k, v, seg_q, seg_kv = _inputs(5, 2, 3, 100, 100, 64, "packed")
    segs = (torch.from_numpy(seg_q), torch.from_numpy(seg_kv))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    assert torch.equal(port.flash_attention(*views, segment_ids=segs),
                       port.flash_attention(q, k, v, segment_ids=segs))


def test_wrapper_checks():
    q = torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        port.flash_attention(q, q, q, causal=True)
    with pytest.raises(NotImplementedError):
        port.flash_attention(q, q, q, ab=torch.zeros((1, 2, 8, 8)))
    with pytest.raises(ValueError, match="bfloat16"):
        port.flash_attention(q.float(), q, q)
    with pytest.raises(ValueError, match="k and v"):
        port.flash_attention(q, q[:, :1], q)
    with pytest.raises(ValueError, match="segment_ids.kv"):
        seg = torch.ones((1, 8), dtype=torch.int32)
        port.flash_attention(q, q, q, segment_ids=(seg, seg[:, :4]))
