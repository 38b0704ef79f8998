"""Port embedding noise (novic_tpu_torch.data.noise) against novic_tpu.data.noise.

The JAX package draws from jax.random keys, the port from a torch.Generator,
so the draws differ. The port splits each scheme into draw + transform; here
the JAX draws, reproduced from the same key splits as novic_tpu.data.noise,
are fed into the port's transforms, and the results must agree with the JAX
schemes to 1e-6 (float32 arithmetic in another order). The port's own draws
are checked by their statistics: unit norm, and rotation angles inside their
bounds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from novic_tpu.data.noise import EmbeddingNoise as JNoise
from novic_tpu.data.noise import apply_mean_shift as j_mean_shift
from novic_tpu_torch.data.noise import EmbeddingNoise, apply_mean_shift

torch.set_num_threads(2)
B, F = 16, 64
ATOL = 1e-6
KW = dict(vec_norm=0.5, angle_min=10.0, angle_max=30.0, angle_std=20.0, mix_ratio=0.4)


def _embed(seed=0):
    e = np.random.default_rng(seed).normal(size=(B, F)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _jax_draws(scheme: str, key, embed: np.ndarray, n: EmbeddingNoise) -> dict:
    """The random tensors novic_tpu.data.noise draws for `scheme` from `key`."""
    shape, b1 = embed.shape, embed.shape[:-1] + (1,)
    normal = lambda k, s: np.asarray(jax.random.normal(k, s, jnp.float32))

    def uniform_angle(k):
        k1, k2 = jax.random.split(k)
        lo, hi = math.radians(n.angle_min), math.radians(n.angle_max)
        return {"angle": np.asarray(jax.random.uniform(k1, b1, jnp.float32, lo, hi)),
                "direction": normal(k2, shape)}

    if scheme == "gausselem":
        return {"noise": normal(key, shape)}
    if scheme == "gaussvec":
        k1, k2 = jax.random.split(key)
        return {"noise": normal(k1, shape), "length": normal(k2, b1)}
    if scheme == "gaussangle":
        k1, k2 = jax.random.split(key)
        std, mx = math.radians(n.angle_std), math.radians(n.angle_max)
        return {"angle": np.clip(std * normal(k1, b1), -mx, mx), "direction": normal(k2, shape)}
    if scheme == "uniformangle":
        return uniform_angle(key)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = uniform_angle(k1)
    draws["noise"] = normal(k2, shape)
    draws["mix"] = np.asarray(jax.random.uniform(k3, b1, jnp.float32)) < n.mix_ratio
    return draws


SCHEMES = ["GaussElem", "GaussVec", "GaussAngle", "UniformAngle", "GaussElemUniformAngle"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_transform_of_jax_draws_matches_jax(scheme):
    embed = _embed()
    key = jax.random.PRNGKey(7)
    ref = np.asarray(JNoise.create(scheme, embed_dim=F, **KW)(key, jnp.asarray(embed)))
    noise = EmbeddingNoise.create(scheme, embed_dim=F, **KW)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in
             _jax_draws(noise.scheme, key, embed, noise).items()}
    out = noise.transform(torch.from_numpy(embed), draws).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    if noise.scheme == "gausselemuniformangle":  # both branches of the mix are taken
        assert 0 < draws["mix"].sum() < B


def test_mean_shift_matches_jax():
    embed = _embed(1)
    shift = np.random.default_rng(2).normal(size=(F,)).astype(np.float32) * 0.1
    ref = np.asarray(j_mean_shift(jnp.asarray(embed), jnp.asarray(shift)))
    out = apply_mean_shift(torch.from_numpy(embed), torch.from_numpy(shift)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert apply_mean_shift(torch.from_numpy(embed), None) is not None


@pytest.mark.parametrize("scheme", SCHEMES)
def test_generator_draws_are_unit_and_within_bounds(scheme):
    noise = EmbeddingNoise.create(scheme, embed_dim=F, **KW)
    embed = torch.from_numpy(_embed(3))
    gen = torch.Generator().manual_seed(0)
    out = noise(embed, gen)
    assert out.shape == embed.shape
    np.testing.assert_allclose(out.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    angle = torch.rad2deg(torch.arccos((out * embed).sum(-1).clamp(-1, 1))).numpy()
    tol = 0.05  # degrees: arccos of float32 dots near 1
    if noise.scheme == "uniformangle":
        assert (angle >= KW["angle_min"] - tol).all() and (angle <= KW["angle_max"] + tol).all()
    if noise.scheme == "gaussangle":
        assert (angle <= KW["angle_max"] + tol).all()
    # Same generator seed, same draws; another seed, other draws
    again = noise(embed, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert not torch.equal(out, noise(embed, torch.Generator().manual_seed(1)))


def test_factory_rejects_unknown_and_bad_settings():
    assert EmbeddingNoise.create("", embed_dim=F) is None
    with pytest.raises(ValueError, match="not recognised"):
        EmbeddingNoise.create("Pink", embed_dim=F)
    bad = EmbeddingNoise.create("UniformAngle", angle_min=40.0, angle_max=30.0)
    with pytest.raises(ValueError, match="smaller"):
        bad(torch.from_numpy(_embed()), torch.Generator())
