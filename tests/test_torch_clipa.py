"""The port's CLIPA towers against novic_tpu's on the CPU, narrow and shallow.

CLIPA-v2 runs the port's VisionTransformer and TextTransformer with three
flags that only CLIPA sets together: no ln_pre (pre_ln=False, no patch bias),
avg pooling over the patch tokens with the final LN after the pool, and a
non-causal text tower pooled at the last position.

* tests/test_clipa.py's open_clip state dict converts to trees equal to
  novic_tpu's bit for bit (as numpy and as tensors), with no pre-LN params.
* With those weights, both towers against novic_tpu's: float32 (the port's K1
  swapped for exact attention) within 2e-4 of novic_tpu's einsum towers on
  unit embeddings; bf16 (the port's K1 plain version; novic_tpu's Pallas
  attention interpreted) cosine >= 0.9999.
* The three registered specs equal novic_tpu's; a tiny CLIPA arch serves in
  TorchEmbedder as in JaxEmbedder from one converted .npz.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import novic_tpu.ops.attention as jax_attention
from novic_tpu.embedders import convert as jconvert
from novic_tpu.embedders import vit as jvit
from novic_tpu.embedders.base import JaxEmbedder
from novic_tpu.embedders.registry import REGISTRY as JREGISTRY
from novic_tpu.embedders.registry import _clipa as jclipa
from novic_tpu_torch.bridge import text_tower_from_numpy, vision_tower_from_numpy
from novic_tpu_torch.embedders import convert, vit
from novic_tpu_torch.embedders.base import TorchEmbedder
from novic_tpu_torch.embedders.registry import REGISTRY, _clipa
from novic_tpu_torch.text.simple import make_test_tokenizer
from novic_tpu_torch.utils.misc import flatten_dict
from test_clipa import CTX, D, E, H, L, P, S, V, make_openclip_clipa_sd

torch.set_num_threads(2)
TOL = 2e-4
COSINE_MIN = 0.9999
SPECS = [s for s in JREGISTRY if "CLIPA" in s]


def _exact_attention(q, k, v, bias=None, key_bias=None):
    """K1's function in exact float32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(q.shape[-1]), k)
    if bias is not None:
        scores = scores + bias
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def _unit(x):
    x = np.asarray(x, np.float64)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _configs(dtype: str, pallas: bool = False):
    """The CLIPA flags at test_clipa.py's size: (port vision, text), (JAX vision, text)."""
    v = dict(image_size=S, patch_size=P, width=E, layers=L, heads=H, mlp_ratio=2.0, embed_dim=D,
             act="gelu", use_class_token=True, patch_bias=False, pre_ln=False, pool="avg",
             compute_dtype=dtype)
    t = dict(context_length=CTX, vocab_size=V, width=E, layers=L, heads=H, mlp_ratio=2.0,
             embed_dim=D, act="gelu", causal=False, pool="last", proj_bias=False,
             compute_dtype=dtype)
    return ((vit.VisionTowerConfig(**v), vit.TextTowerConfig(**t)),
            (jvit.VisionTowerConfig(**v, use_pallas_attention=pallas),
             jvit.TextTowerConfig(**t, use_pallas_attention=pallas)))


def test_conversion_equals_jax():
    sd = make_openclip_clipa_sd(np.random.default_rng(0))
    jv, jt = jconvert.convert_openclip_state_dict(sd, "clipa", L, L)
    for form in (sd, {k: torch.from_numpy(x) for k, x in sd.items()}):
        v, t = convert.convert_openclip_state_dict(form, "clipa", L, L)
        for a, b in ((v, jv), (t, jt)):
            fa, fb = flatten_dict(a), flatten_dict(b)
            assert list(fa) == list(fb)
            for k in fa:
                assert fa[k].dtype == fb[k].dtype, k
                np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert "pre_ln_weight" not in v and "patch_bias" not in v
    (vcfg, tcfg), _ = _configs("float32")
    vision_tower_from_numpy(vcfg, v)  # strict: the tree is exactly the tower's params
    text_tower_from_numpy(tcfg, t)


@pytest.mark.parametrize("tower", ["vision", "text"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_towers_match_jax(monkeypatch, tower, dtype):
    rng = np.random.default_rng(7)
    sd = make_openclip_clipa_sd(rng)
    v, t = convert.convert_openclip_state_dict(sd, "clipa", L, L)
    pallas = dtype == "bfloat16"
    if pallas:
        orig = jax_attention.fused_attention
        monkeypatch.setattr(jax_attention, "fused_attention",
                            lambda q, k, v, bias=None, **kw: orig(q, k, v, bias, interpret=True))
    else:
        monkeypatch.setattr(vit, "fused_attention", _exact_attention)
    (vcfg, tcfg), (jvcfg, jtcfg) = _configs(dtype, pallas)
    if tower == "vision":
        x = rng.normal(size=(3, S, S, 3)).astype(np.float32)
        ref = np.asarray(jax.jit(jvit.VisionTransformer(cfg=jvcfg).apply)({"params": v}, x))
        model = vision_tower_from_numpy(vcfg, v)
    else:
        x = rng.integers(0, V, size=(3, CTX)).astype(np.int32)
        ref = np.asarray(jax.jit(jvit.TextTransformer(cfg=jtcfg).apply)({"params": t}, x))
        model = text_tower_from_numpy(tcfg, t)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (3, D)
    if dtype == "float32":
        assert np.abs(_unit(ours) - _unit(ref)).max() <= TOL
    else:
        assert (_unit(ours) * _unit(ref)).sum(-1).min() >= COSINE_MIN


@pytest.mark.parametrize("spec", SPECS)
def test_registry_specs_equal_jax(spec):
    arch, jarch = REGISTRY[spec], JREGISTRY[spec]
    for part in ("vision", "text", "preprocess"):
        assert dataclasses.asdict(getattr(arch, part)) == dataclasses.asdict(getattr(jarch, part))
    assert (arch.family, arch.tokenizer) == ("clipa", "wordpiece")
    assert arch.vision.pool == "avg" and not arch.vision.pre_ln and not arch.vision.patch_bias
    assert arch.text.pool == "last" and not arch.text.causal


def test_embedder_matches_jax(tmp_path, monkeypatch):
    """A tiny CLIPA arch (the registry's _clipa at test_clipa.py's size) served
    by both packages' embedders from one converted .npz, float32, the port's
    K1 swapped for exact attention."""
    arch = _clipa(E, L, H, E, L, H, D, image_size=S, patch=P, context=CTX, vocab=V,
                  v_mlp_ratio=2.0)
    jarch = jclipa(E, L, H, E, L, H, D, image_size=S, patch=P, context=CTX, vocab=V,
                   v_mlp_ratio=2.0)
    sd = make_openclip_clipa_sd(np.random.default_rng(3))
    # test_clipa.py's state dict has a 2x MLP in both towers
    arch = dataclasses.replace(arch, text=dataclasses.replace(arch.text, mlp_ratio=2.0))
    jarch = dataclasses.replace(jarch, text=dataclasses.replace(jarch.text, mlp_ratio=2.0))
    path = str(tmp_path / "clipa.npz")
    jconvert.save_params_npz(path, *jconvert.convert_openclip_state_dict(sd, "clipa", L, L))
    monkeypatch.setattr(vit, "fused_attention", _exact_attention)
    words = ["dog", "cat", "fire truck"]
    kw = dict(load_model=True, check=False, weights_path=path, compute_dtype="float32", seed=0,
              tokenizer=make_test_tokenizer(words, context_length=CTX))
    pemb = TorchEmbedder(spec="openclip:tiny-clipa", arch=arch, device="cpu",
                         inference_batch_size=4, image_batch_size=4, **kw)
    jemb = JaxEmbedder(spec="openclip:tiny-clipa", arch=jarch, tokenizer_batch_size=8,
                       inference_batch_size=4, image_batch_size=4, bpe_merges_path=None, **kw)
    assert pemb.configuration == jemb.configuration
    images = np.random.default_rng(4).normal(size=(3, S, S, 3)).astype(np.float32)
    assert np.abs(pemb.inference_image(images) - jemb.inference_image(images)).max() <= TOL
    assert np.abs(pemb.inference_text(words) - jemb.inference_text(words)).max() <= TOL
