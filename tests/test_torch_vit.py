"""Port vision tower (novic_tpu_torch.embedders.vit) against the JAX tower.

A small SigLIP-shaped VisionTransformer (2 layers, width 64, 4 heads, image 32,
patch 8, MAP pool, embed 768) is initialised by JAX and carried over by
bridge.py. The JAX side runs with use_pallas_attention=True, its Pallas kernel
interpreted on the CPU. Bars: 5e-3 elementwise at float32 compute (the bar of
tests/test_pallas_attention.py); embedding cosine >= 0.9999 at bf16 compute,
where the MAP head's bf16 softmax rounds differently in the two frameworks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import novic_tpu.ops.attention as jax_attention
from novic_tpu.embedders import vit as jvit
from novic_tpu.embedders.preprocess import PreprocessConfig as JPreprocessConfig
from novic_tpu.embedders.preprocess import preprocess_pil_host as jax_preprocess
from novic_tpu_torch.bridge import vision_tower_from_numpy
from novic_tpu_torch.embedders import vit
from novic_tpu_torch.embedders.preprocess import (
    PreprocessConfig,
    preprocess_frames,
    preprocess_pil_host,
)

torch.set_num_threads(2)

SMALL = dict(image_size=32, patch_size=8, width=64, layers=2, heads=4, mlp_ratio=4.0,
             embed_dim=768, act="gelu_tanh", use_class_token=False, patch_bias=True,
             pre_ln=False, pool="map", layer_norm_eps=1e-6)


@pytest.fixture
def interpreted_pallas(monkeypatch):
    orig = jax_attention.fused_attention
    monkeypatch.setattr(jax_attention, "fused_attention",
                        lambda q, k, v, bias=None, **kw: orig(q, k, v, bias, interpret=True))


def _jax_tower(cfg_kwargs, images, seed=0):
    cfg = jvit.VisionTowerConfig(**cfg_kwargs, use_pallas_attention=True)
    model = jvit.VisionTransformer(cfg=cfg)
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(images[:1]))["params"]
    out = np.asarray(jax.jit(lambda p, x: model.apply({"params": p}, x))(params, jnp.asarray(images)))
    return jax.tree.map(np.asarray, params), out


def _images(n, size, seed):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("pool,extra", [("map", {}), ("cls", {"use_class_token": True,
                                                               "pre_ln": True, "patch_bias": False}),
                                        ("avg", {"use_class_token": True, "embed_dim": 32})])
def test_tower_float32_matches_jax(interpreted_pallas, pool, extra):
    kwargs = {**SMALL, "pool": pool, **extra, "compute_dtype": "float32"}
    images = _images(2, 32, 3)
    params, ref = _jax_tower(kwargs, images)
    model = vision_tower_from_numpy(vit.VisionTowerConfig(**kwargs), params)
    with torch.no_grad():
        out = model(torch.from_numpy(images)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=5e-3, rtol=5e-3)


def test_tower_bfloat16_cosine(interpreted_pallas):
    kwargs = {**SMALL, "compute_dtype": "bfloat16"}
    images = _images(3, 32, 4)
    params, ref = _jax_tower(kwargs, images, seed=1)
    model = vision_tower_from_numpy(vit.VisionTowerConfig(**kwargs), params)
    with torch.no_grad():
        out = model(torch.from_numpy(images)).numpy()
    cos = (out * ref).sum(-1) / np.linalg.norm(out, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert cos.min() >= 0.9999, cos


def test_random_init_matches_flax_scales():
    """Random init: the flax init's parameter names, shapes and scales, and the
    same weights from the same seed."""
    cfg = vit.VisionTowerConfig(**SMALL)
    model = vit.VisionTransformer(cfg).init_random(torch.Generator().manual_seed(0))
    again = vit.VisionTransformer(cfg).init_random(torch.Generator().manual_seed(0))
    jparams = jax.jit(jvit.VisionTransformer(cfg=jvit.VisionTowerConfig(**SMALL)).init)(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)))["params"]
    from novic_tpu.utils.misc import flatten_dict

    jflat = {k: np.asarray(v) for k, v in flatten_dict(jparams).items()}
    state = model.state_dict()
    assert set(state) == set(jflat)
    for name, value in state.items():
        ref = jflat[name]
        assert tuple(value.shape) == ref.shape, name
        assert torch.equal(value, again.state_dict()[name]), name
        if ref.size >= 256:  # std of the draws agrees with flax's init within sampling noise
            assert abs(float(value.std()) - float(ref.std())) <= 0.15 * float(ref.std()) + 1e-6, name
        else:
            assert abs(float(value.mean()) - float(ref.mean())) <= 0.5 * float(ref.std()) + 1e-6, name


def test_preprocess_identity_skip_matches_jax_pil():
    """uint8 frames already at the squash size skip PIL; the array equals the
    JAX package's PIL path bit for bit."""
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8) for _ in range(3)]
    kw = dict(size=32, resize_mode="squash", mean=(0.5,) * 3, std=(0.5,) * 3)
    out = preprocess_pil_host(frames, PreprocessConfig(**kw))
    ref = jax_preprocess(frames, JPreprocessConfig(**kw))
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    # The tensor path that normalises such frames on the embedder's device
    dev = preprocess_frames(torch.from_numpy(np.stack(frames)), PreprocessConfig(**kw))
    np.testing.assert_array_equal(dev.numpy(), ref)
    # A resize still goes through PIL and matches too
    big = [rng.integers(0, 256, size=(48, 40, 3), dtype=np.uint8)]
    for mode in ("squash", "shortest"):
        kw2 = dict(kw, resize_mode=mode)
        np.testing.assert_array_equal(preprocess_pil_host(big, PreprocessConfig(**kw2)),
                                      jax_preprocess(big, JPreprocessConfig(**kw2)))


def test_config_fields_match_jax():
    for port_cls, jax_cls in ((vit.VisionTowerConfig, jvit.VisionTowerConfig),
                              (vit.TextTowerConfig, jvit.TextTowerConfig)):
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())
