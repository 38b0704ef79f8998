"""Port inference API (novic_tpu_torch.infer) against novic_tpu.infer.

NOVICModel.classify_images runs in both packages on 4 seeded uint8 224x224
images at float32 compute: a small SigLIP-shaped tower (registered under one
spec in both registries) with the same converted weights .npz, written by the
JAX package's convert.save_params_npz and read through each package's
weights_path, and the FT0 decoder with its word tokenizer. Preds identical,
logprobs within 1e-4 (sums in another order).

The FT0 asset stores float16, and both packages read it as stored: the JAX
NOVICModel computes with the float16 arrays, and the port rounds its decode
steps at the same points (PrefixedIterDecoder.float16_params). Without those
roundings the logprobs differ by up to ~3e-3.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import novic_tpu.embedders.registry as jax_registry
import novic_tpu.infer as jax_infer
from novic_tpu.embedders.base import HashEmbedder as JHashEmbedder
from novic_tpu.embedders.convert import save_params_npz
from novic_tpu.embedders.vit import TextTransformer as JTextTransformer
from novic_tpu.embedders.vit import VisionTransformer as JVisionTransformer
from novic_tpu.models.generate import generate_beam as jax_generate_beam
from novic_tpu.models.generate import generate_greedy as jax_generate_greedy
from novic_tpu.models.prefixed_iter import PrefixedIterDecoder as JDecoder
from novic_tpu.text.simple import make_test_tokenizer as jax_make_test_tokenizer
from novic_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from novic_tpu_torch import infer
from novic_tpu_torch.bridge import decoder_from_numpy
from novic_tpu_torch.models import generate
from novic_tpu_torch.embedders import registry
from novic_tpu_torch.embedders.base import Embedder, HashEmbedder
from novic_tpu_torch.text.simple import make_test_tokenizer
from novic_tpu_torch.train.checkpoint import load_checkpoint

torch.set_num_threads(2)
FT0 = os.path.join(os.path.dirname(__file__), "..", "assets", "bench_ft0_decoder.npz")
SPEC = "openclip:test/small-siglip-224"


def _small_arch(module):
    arch = module.REGISTRY["openclip:timm/ViT-B-16-SigLIP"]
    return dataclasses.replace(
        arch, vision=dataclasses.replace(arch.vision, patch_size=32, width=64, layers=2, heads=4),
        text=dataclasses.replace(arch.text, width=64, layers=1, heads=4, vocab_size=100))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jarch = _small_arch(jax_registry)
    images = jnp.zeros((1, 224, 224, 3))
    kv, kt = jax.random.split(jax.random.PRNGKey(3))
    vparams = JVisionTransformer(cfg=jarch.vision).init({"params": kv}, images)["params"]
    tparams = JTextTransformer(cfg=jarch.text).init(
        {"params": kt}, jnp.zeros((1, jarch.text.context_length), jnp.int32))["params"]
    tmp = tmp_path_factory.mktemp("weights")
    path = str(tmp / "small_siglip.npz")
    save_params_npz(path, jax.tree.map(np.asarray, vparams), jax.tree.map(np.asarray, tparams))
    ck = load_checkpoint(FT0)
    nouns = ck["target_nouns"][ck["num_invalid_target_nouns"]:]
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, size=(224, 224, 3), dtype=np.uint8) for _ in range(4)]
    return dict(weights=path, nouns=nouns, frames=frames, jarch=jarch)


@pytest.fixture
def registered(setup, monkeypatch):
    monkeypatch.setitem(jax_registry.REGISTRY, SPEC, setup["jarch"])
    monkeypatch.setitem(registry.REGISTRY, SPEC, _small_arch(registry))


@pytest.mark.parametrize("gencfg", ["beam_k10_vnone_gn_t1_a0", "beam_k10_vnone_gp_t1_a0"])
def test_classify_images_matches_jax(setup, registered, gencfg):
    common = dict(embedder_spec=SPEC, gencfg=gencfg, batch_size=4)
    jmodel = jax_infer.NOVICModel(FT0, embedder_kwargs=dict(
        tokenizer=jax_make_test_tokenizer(setup["nouns"]), weights_path=setup["weights"],
        compute_dtype="float32"), **common)
    model = infer.NOVICModel(FT0, device="cpu", embedder_kwargs=dict(
        tokenizer=make_test_tokenizer(setup["nouns"]), weights_path=setup["weights"],
        compute_dtype="float32"), **common)
    with jmodel:
        ref = jmodel.classify_images(setup["frames"])
    with model:
        out = model.classify_images(setup["frames"])
    assert out.preds == ref.preds
    assert out.types == ref.types
    np.testing.assert_allclose(np.array(out.logprobs), np.array(ref.logprobs), atol=1e-4, rtol=1e-4)
    assert np.array(out.logprobs).shape == (4, 10)
    if gencfg.split("_")[3] == "gp":
        assert all(p in set(setup["nouns"]) for row in out.preds for p in row)


@pytest.mark.parametrize("mode", ["greedy", "lazy", "reorder"])
def test_float16_checkpoint_decodes_like_jax(mode):
    """The FT0 decoder as stored (float16): the port's decode, rounding where
    JAX keeps float16 values, gives JAX's tokens, and scores within 1e-4
    (float32 sums in another order)."""
    ck, jck = load_checkpoint(FT0), jax_load_checkpoint(FT0)
    model = decoder_from_numpy(ck["model_config"], ck["params"])
    assert model.float16_params
    assert {np.asarray(a).dtype for a in jax.tree.leaves(jck["params"])} == {np.dtype(np.float16)}
    e = np.random.default_rng(0).normal(size=(4, 768)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    jmodel = JDecoder(cfg=jck["model_config"])
    with torch.no_grad():
        if mode == "greedy":
            ref = jax.jit(lambda p, x: jax_generate_greedy(jmodel, p, x, calc_loss=True))(
                jck["params"], jnp.asarray(e))
            out = generate.generate_greedy(model, torch.from_numpy(e), calc_loss=True)
            pairs = [(out[0], ref[0], 0.0), (out[5], ref[5], 1e-4)]
        else:
            ref = jax.jit(lambda p, x: jax_generate_beam(jmodel, p, x, topk=10, cache_mode=mode))(
                jck["params"], jnp.asarray(e))
            out = generate.generate_beam(model, torch.from_numpy(e), topk=10, cache_mode=mode)
            pairs = [(out[0], ref[0], 0.0), (out[2], ref[2], 1e-4)]
    for got, want, atol in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def test_classify_embeds_pads_ragged_batch(setup, registered):
    """A ragged tail is padded with unit e0 rows to batch_size and cut back."""
    model = infer.NOVICModel(FT0, device="cpu", embedder_spec="test:768", batch_size=4)
    emb = np.random.default_rng(2).normal(size=(5, 768)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    with model:
        out = model.classify_embeds(emb, gencfg="beam_k3_vnone_gn_t1_a0")
        single = model.classify_embeds(emb[4:], gencfg="beam_k3_vnone_gn_t1_a0")
    assert len(out.preds) == 5 and all(len(r) == 3 for r in out.preds)
    assert out.preds[4] == single.preds[0]


@pytest.mark.parametrize("name", ["beam_k10_vnone_gn_t1_a0", "beam_k10_vnone_gp_t1_a0",
                                  "beam_k3_vnone_gr_t1_a0.5", "greedy_k1_vnone_gn_t0.5_a0",
                                  "all_k5_vtgt0.25_gp_t1_a1.25", "beam_k2_vtok1_gn_t2_a0"])
def test_gencfg_names_round_trip_like_jax(name):
    g = infer.GenerationConfig.from_name(name)
    j = jax_infer.GenerationConfig.from_name(name)
    assert g.name == j.name == name
    assert dataclasses.asdict(g) == dataclasses.asdict(j)


@pytest.mark.parametrize("bad", ["beam_k0_vnone_gn_t1_a0", "beam_k10_vnone_gx_t1_a0",
                                 "beam__k10", "sample_k1", "beam_k10_vnone_gn_t1.0_a0"])
def test_gencfg_bad_names_raise(bad):
    with pytest.raises(ValueError):
        infer.GenerationConfig.from_name(bad)


def test_unported_generation_raises(setup):
    """A guided 'all' gencfg builds its task (its precompute waits for the first
    batch); the gencfg checks of novic_tpu's GenerationTask hold (unguided 'all',
    greedy with k > 1 or a vocab prior: ValueError); the ALIGN towers, once
    unported, resolve."""
    model = infer.NOVICModel(FT0, device="cpu", embedder_spec="test:768",
                             gencfg="all_k3_vnone_gp_t1_a0")
    with model:
        assert model.task.gencfg.method == "all" and model.task.precompute is None
        assert model.task.guide_targets.shape == (42919, 8)
    model = infer.NOVICModel(FT0, device="cpu", embedder_spec="test:768")
    with model:
        for bad in ("all_k3_vnone_gn_t1_a0", "greedy_k2_vnone_gn_t1_a0",
                    "greedy_k1_vtgt0.5_gn_t1_a0"):
            with pytest.raises(ValueError):
                model.task_for(bad)
            jdec = jax_infer.Decoder(model=None, params=None, cfg=None, target_tokenizer=None)
            with pytest.raises(ValueError):
                jax_infer.GenerationTask(gencfg=jax_infer.GenerationConfig.from_name(bad),
                                         decoder=jdec, vocab_targets_set=set(),
                                         vocab_targets=np.zeros((1, 8), np.int32),
                                         guide_targets_set=set(), guide_targets=None)
    assert registry.lookup("transformers:kakaobrain/align-base").family == "align"


def test_hash_embedder_bytes_match_jax():
    port = HashEmbedder(spec="test:32", embed_dim=32)
    ref = JHashEmbedder(spec="test:32", embed_dim=32, tokenizer_batch_size=8,
                        inference_batch_size=8, image_batch_size=8, check=False)
    imgs = np.random.default_rng(3).integers(0, 256, size=(3, 8, 8, 3), dtype=np.uint8)
    assert port.inference_image(imgs).tobytes() == ref.inference_image(imgs).tobytes()
    texts = ["a dog", "traffic light"]
    assert port.inference_text(texts).tobytes() == ref.inference_text(texts).tobytes()
    assert isinstance(Embedder.create("test:32"), HashEmbedder)


def test_entry_points_default_to_cuda():
    """NOVICModel and the embedder factory ask for CUDA unless told otherwise."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default would not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.NOVICModel(FT0, embedder_spec="test:768")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Embedder.create("openclip:timm/ViT-B-16-SigLIP", load_model=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.main(["--checkpoint", FT0, "--embedder", "test:768", "--images", "x.png"])
