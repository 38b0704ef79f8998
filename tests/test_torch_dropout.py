"""The port's dropout (novic_tpu_torch.ops.dropout, FastDropout) on the CPU,
where it runs the plain version of the CUDA kernel.

The mask is Philox4x32-10 of (seed, element index): pinned here against the
Random123 known-answer vector, as a pure function of the index (any slice of
the stream equals the same slice of the whole), and by its statistics. These
mirror tests/test_dropout.py. The JAX package's kernel draws from the TPU's
hardware generator and has no CPU lowering (novic_tpu/ops/dropout.py:108), so
the bits are not compared with JAX; chip_smoke.py holds the CUDA kernel bit
for bit against this plain version on the card.
"""

import math

import pytest
import torch

from novic_tpu_torch.models.layers import FastDropout
from novic_tpu_torch.ops import dropout as D

torch.set_num_threads(2)
SEED = (0x12345678, 0x9ABCDEF0)


def test_philox_known_answer():
    """Random123's philox4x32_10 vector for counter 0 and key 0."""
    words = D.philox_bits((0, 0), 0, 4).tolist()
    assert words == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


@pytest.mark.parametrize("start,count", [(0, 1000), (1, 7), (3, 13), (499, 501), (998, 2)])
def test_bits_are_a_function_of_the_index(start, count):
    whole = D.philox_bits(SEED, 0, 1000)
    assert torch.equal(D.philox_bits(SEED, start, count), whole[start:start + count])
    assert int(whole.min()) >= 0 and int(whole.max()) < 2 ** 32


def test_halves_at_offsets_give_the_same_mask():
    x = torch.ones(2 * 4099 + 1)
    y = D.dropout_reference(x, SEED, 0.3)
    half = x.numel() // 2
    thresh = D.keep_threshold(0.3)
    for start, count in ((0, half), (half, x.numel() - half)):
        keep = D.philox_bits(SEED, start, count) < thresh
        assert torch.equal(y[start:start + count] != 0, keep)


def test_keep_rate_and_exact_scale():
    rate = 0.25
    x = torch.ones(64, 512)
    y = D.dropout(x, SEED, rate)
    keep = y != 0
    n = x.numel()
    sigma = math.sqrt(rate * (1 - rate) / n)
    assert abs(keep.float().mean().item() - (1 - rate)) < 5 * sigma  # binomial, 5 sigma
    assert torch.equal(y[keep], torch.full_like(y[keep], float(torch.tensor(1 / (1 - rate)))))
    assert bool((y[~keep] == 0).all())


def test_bfloat16_scale_is_rounded_to_the_type():
    rate = 0.3
    x = torch.randn(4, 1000).to(torch.bfloat16)
    y = D.dropout(x, SEED, rate)
    assert y.dtype == torch.bfloat16
    inv = float(torch.tensor(1 / (1 - rate), dtype=torch.bfloat16))
    keep = y != 0
    want = (x.float() * inv).to(torch.bfloat16)
    assert torch.equal(y[keep], want[keep])


def test_deterministic_per_seed_and_distinct_across_seeds():
    x = torch.randn(3, 11, 64)
    a = D.dropout(x, SEED, 0.1)
    assert torch.equal(a, D.dropout(x, SEED, 0.1))
    b = D.dropout(x, (SEED[0], SEED[1] + 1), 0.1)
    c = D.dropout(x, (SEED[0] + 1, SEED[1]), 0.1)
    assert not torch.equal(a, b) and not torch.equal(a, c)


def test_gradient_uses_the_forward_mask():
    x = torch.randn(8, 11, 32, requires_grad=True)
    g = torch.randn(8, 11, 32)
    y = D.dropout(x, SEED, 0.2)
    (y * g).sum().backward()
    scale = float(torch.tensor(1 / 0.8))
    expect = torch.where(y != 0, g * scale, torch.zeros(()))
    assert torch.equal(x.grad, expect)


def test_seed_draws_come_from_the_cpu_generator():
    a = D.draw_seed(torch.Generator().manual_seed(5))
    b = D.draw_seed(torch.Generator().manual_seed(5))
    assert a == b and all(0 <= w < 2 ** 32 for w in a)


@pytest.mark.parametrize("impl", ["auto", "threefry", "pallas"])
def test_fast_dropout_every_impl_takes_the_same_mask(impl):
    x = torch.randn(16, 128)
    y = FastDropout(0.25, impl)(x, deterministic=False, generator=torch.Generator().manual_seed(1))
    seed = D.draw_seed(torch.Generator().manual_seed(1))
    assert torch.equal(y, D.dropout_reference(x, seed, 0.25))


def test_fast_dropout_identity_when_deterministic_or_zero_rate():
    x = torch.randn(4, 32)
    gen = torch.Generator().manual_seed(0)
    assert FastDropout(0.5)(x, deterministic=True, generator=gen) is x
    assert FastDropout(0.0)(x, deterministic=False, generator=gen) is x
    with pytest.raises(ValueError, match="generator"):
        FastDropout(0.5)(x, deterministic=False)


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="dropout impl"):
        FastDropout(0.1, "cuda")


def test_rate_out_of_range_raises_and_other_devices_refused():
    with pytest.raises(ValueError, match="rate"):
        D.dropout_apply(torch.ones(4), SEED, 1.0)
    with pytest.raises(ValueError, match="device"):
        D.dropout_apply(torch.ones(4, device="meta"), SEED, 0.5)
