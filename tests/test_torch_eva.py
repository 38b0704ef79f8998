"""The port's EVA02 towers (novic_tpu_torch.embedders.eva) against novic_tpu's
on the CPU, narrow and shallow.

* rope_cat_table equals novic_tpu's bit for bit; apply_rope_cat equals it.
* The SwiGLU/rope/sub-LN tower and the enormous-style tower (fused-qkv
  checkpoint, plain GELU MLP, no rope, no sub-LN) at 2 layers and width 64,
  with novic_tpu's params (its init plus seeded noise) carried across by
  bridge.eva_tower_from_numpy: in float32, with exact attention swapped in
  for K1 (whose bf16 operands alone move embeddings by ~1e-3), unit
  embeddings within 2e-4; in bf16, with K1's plain version, cosine >= 0.9999.
* The conversion of tests/test_eva_parity.py's timm-named mirror equals
  novic_tpu's bit for bit, under both head namings and with the enormous
  variant's fused qkv split; the converted tower agrees with that mirror.
* TorchEmbedder and JaxEmbedder on one converted .npz: image and text
  embeddings within the float32 bar.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from novic_tpu.embedders import convert as jconvert
from novic_tpu.embedders import eva as jeva
from novic_tpu.embedders.base import JaxEmbedder
from novic_tpu.embedders.registry import lookup as jlookup
from novic_tpu_torch.bridge import eva_tower_from_numpy
from novic_tpu_torch.embedders import convert, eva, vit
from novic_tpu_torch.embedders.base import TorchEmbedder
from novic_tpu_torch.text.simple import make_test_tokenizer
from novic_tpu_torch.utils.misc import flatten_dict, unflatten_dict
from test_eva_parity import _TorchEva

torch.set_num_threads(2)
TOL = 2e-4
COSINE_MIN = 0.9999
TINY = dict(image_size=24, patch_size=8, width=64, layers=2, heads=4, mlp_hidden=80,
            embed_dim=20, ref_feat_shape=4)
VARIANTS = {
    "swiglu": dict(use_rope=True, swiglu=True, inner_attn_norm=True, qkv_fused=False),
    "enormous": dict(use_rope=False, swiglu=False, inner_attn_norm=False, qkv_fused=True),
}


def _exact_attention(q, k, v, bias=None, key_bias=None):
    """K1's function in exact float32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(q.shape[-1]), k)
    if bias is not None:
        scores = scores + bias
    if key_bias is not None:
        scores = scores + key_bias[:, None, None, :]
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def _unit(x):
    x = np.asarray(x, np.float64)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _cosines(a, b):
    return (_unit(a) * _unit(b)).sum(-1)


@pytest.mark.parametrize("grid,ref,hd", [(3, 4, 16), (16, 16, 64), (16, 16, 112), (5, 0, 8)])
def test_rope_table_equals_jax(grid, ref, hd):
    table = eva.rope_cat_table(grid, ref, hd)
    np.testing.assert_array_equal(table, jeva.rope_cat_table(grid, ref, hd))


def test_apply_rope_equals_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    table = eva.rope_cat_table(3, 4, 16)
    ours = eva.apply_rope_cat(torch.from_numpy(x), torch.from_numpy(table)).numpy()
    ref = np.asarray(jax.jit(jeva.apply_rope_cat)(x, table))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def _jax_params(cfg, seed):
    """novic_tpu's init of the tower plus seeded noise on every leaf (so the
    zero biases and unit norm scales are exercised too)."""
    model = jeva.EvaVisionTransformer(cfg=cfg)
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(seed)},
                                 np.zeros((1, cfg.image_size, cfg.image_size, 3),
                                          np.float32))["params"]
    flat = flatten_dict(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(seed)
    return unflatten_dict({k: (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32)
                           for k, v in flat.items()})


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tower_matches_jax(monkeypatch, variant, dtype):
    cfg_kw = dict(TINY, **VARIANTS[variant], compute_dtype=dtype)
    jcfg, cfg = jeva.EvaVisionConfig(**cfg_kw), eva.EvaVisionConfig(**cfg_kw)
    params = _jax_params(jcfg, seed=3)
    images = np.random.default_rng(4).normal(size=(3, 24, 24, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jeva.EvaVisionTransformer(cfg=jcfg).apply)({"params": params},
                                                                       images))
    if dtype == "float32":
        monkeypatch.setattr(eva, "fused_attention", _exact_attention)
    tower = eva_tower_from_numpy(cfg, params)
    with torch.no_grad():
        ours = tower(torch.from_numpy(images)).numpy()
    assert ours.shape == ref.shape == (3, 20)
    if dtype == "float32":
        assert np.abs(_unit(ours) - _unit(ref)).max() <= TOL
    else:
        assert _cosines(ours, ref).min() >= COSINE_MIN


def _mirror_state_dict(cfg, seed, head="trunk"):
    torch.manual_seed(seed)
    mirror = _TorchEva(cfg).eval()
    sd = {f"visual.trunk.{k}": v for k, v in mirror.state_dict().items()}
    if head == "proj":  # open_clip's own linear head, without a bias
        sd["visual.head.proj.weight"] = sd.pop("visual.trunk.head.weight")
        del sd["visual.trunk.head.bias"]
        with torch.no_grad():
            mirror.head.bias.zero_()
    return mirror, sd


@pytest.mark.parametrize("variant,head", [("swiglu", "trunk"), ("swiglu", "proj"),
                                          ("enormous", "trunk"), ("enormous", "proj")])
def test_conversion_equals_jax(monkeypatch, variant, head):
    jcfg = jeva.EvaVisionConfig(**TINY, **VARIANTS[variant], compute_dtype="float32")
    cfg = eva.EvaVisionConfig(**TINY, **VARIANTS[variant], compute_dtype="float32")
    mirror, sd = _mirror_state_dict(jcfg, seed=5, head=head)
    ours = convert.convert_openclip_eva_vision(sd, cfg)
    ref = jconvert.convert_openclip_eva_vision(sd, jcfg)
    fa, fb = flatten_dict(ours), flatten_dict(ref)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    if VARIANTS[variant]["qkv_fused"]:
        E = cfg.width
        fused = sd["visual.trunk.blocks.0.attn.qkv.weight"].numpy()
        np.testing.assert_array_equal(fa["blocks_0.k_proj_weight"], fused[E:2 * E])
        assert "blocks_0.k_proj_bias" not in fa  # k has no bias (timm's is a fixed zero)
    # The converted tower agrees with the mirror (float32, exact attention)
    monkeypatch.setattr(eva, "fused_attention", _exact_attention)
    images = np.random.default_rng(6).normal(size=(2, 24, 24, 3)).astype(np.float32)
    with torch.no_grad():
        want = mirror(torch.from_numpy(images.transpose(0, 3, 1, 2))).numpy()
        got = eva_tower_from_numpy(cfg, ours)(torch.from_numpy(images)).numpy()
    assert np.abs(_unit(got) - _unit(want)).max() <= TOL


def test_conversion_needs_the_vision_cfg():
    with pytest.raises(ValueError, match="vision_cfg"):
        convert.convert_openclip_state_dict({}, "eva02", 2, 2)


def _openclip_text_sd(rng, E=64, layers=2, ctx=12, vocab=64, proj=20) -> dict:
    """A stock open_clip CLIP text tower's state dict (numpy), seeded."""
    def w(*shape, scale=0.1):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    sd = {"token_embedding.weight": w(vocab, E), "positional_embedding": w(ctx, E),
          "ln_final.weight": 1 + w(E), "ln_final.bias": w(E), "text_projection": w(E, proj)}
    for i in range(layers):
        p = f"transformer.resblocks.{i}"
        sd.update({f"{p}.attn.in_proj_weight": w(3 * E, E), f"{p}.attn.in_proj_bias": w(3 * E),
                   f"{p}.attn.out_proj.weight": w(E, E), f"{p}.attn.out_proj.bias": w(E),
                   f"{p}.ln_1.weight": 1 + w(E), f"{p}.ln_1.bias": w(E),
                   f"{p}.ln_2.weight": 1 + w(E), f"{p}.ln_2.bias": w(E),
                   f"{p}.mlp.c_fc.weight": w(4 * E, E), f"{p}.mlp.c_fc.bias": w(4 * E),
                   f"{p}.mlp.c_proj.weight": w(E, 4 * E), f"{p}.mlp.c_proj.bias": w(E)})
    return sd


def _port_arch(jarch):
    """The port's EmbedderArch with the JAX arch's field values."""
    from novic_tpu_torch.embedders.preprocess import PreprocessConfig
    from novic_tpu_torch.embedders.registry import EmbedderArch
    from novic_tpu_torch.embedders.vit import TextTowerConfig

    return EmbedderArch(vision=eva.EvaVisionConfig(**dataclasses.asdict(jarch.vision)),
                        text=TextTowerConfig(**dataclasses.asdict(jarch.text)),
                        preprocess=PreprocessConfig(**dataclasses.asdict(jarch.preprocess)),
                        tokenizer=jarch.tokenizer, family=jarch.family)


def test_embedder_matches_jax(tmp_path, monkeypatch):
    """A tiny EVA02 arch (the base spec's, narrowed) served by both packages'
    embedders from one converted .npz, in float32 with exact attention (the
    float32 bar). In bf16 novic_tpu's EVA02 rounds its attention scores and
    softmax to bf16 where K1 keeps them in float32; with these weights that
    alone gives cosines of 0.99990-0.99998, so the bf16 bar is held by the
    tower tests above, at novic_tpu's init scales."""
    base = jlookup("openclip:timm/eva02_base_patch16_clip_224.merged2b_s8b_b131k")
    jarch = dataclasses.replace(
        base, vision=jeva.EvaVisionConfig(**TINY, **VARIANTS["swiglu"]),
        text=dataclasses.replace(base.text, width=64, layers=2, heads=4, vocab_size=64,
                                 context_length=12, embed_dim=20),
        preprocess=dataclasses.replace(base.preprocess, size=24))
    _, sd = _mirror_state_dict(jarch.vision, seed=7)
    sd = {**{k: v.numpy() for k, v in sd.items()}, **_openclip_text_sd(np.random.default_rng(8))}
    path = str(tmp_path / "eva.npz")
    jconvert.save_params_npz(path, *jconvert.convert_openclip_state_dict(
        sd, "eva02", 2, 2, vision_cfg=jarch.vision))
    words = ["dog", "cat", "fire truck"]
    jemb = JaxEmbedder(spec="openclip:tiny-eva02", arch=jarch, tokenizer_batch_size=8,
                       inference_batch_size=4, image_batch_size=4, load_model=True, check=False,
                       weights_path=path, bpe_merges_path=None,
                       tokenizer=make_test_tokenizer(words, context_length=12),
                       compute_dtype="float32", seed=0)
    monkeypatch.setattr(vit, "fused_attention", _exact_attention)
    monkeypatch.setattr(eva, "fused_attention", _exact_attention)
    pemb = TorchEmbedder(spec="openclip:tiny-eva02", arch=_port_arch(jarch), load_model=True,
                         check=False, weights_path=path,
                         tokenizer=make_test_tokenizer(words, context_length=12),
                         compute_dtype="float32", seed=0, device="cpu",
                         inference_batch_size=4, image_batch_size=4)
    assert pemb.configuration == jemb.configuration
    assert isinstance(pemb._vision, eva.EvaVisionTransformer)
    images = np.random.default_rng(9).normal(size=(3, 24, 24, 3)).astype(np.float32)
    assert np.abs(pemb.inference_image(images) - jemb.inference_image(images)).max() <= TOL
    assert np.abs(pemb.inference_text(words) - jemb.inference_text(words)).max() <= TOL


def test_init_on_device_draws_the_same_towers_on_the_cpu():
    """init_on_device=True builds the towers on the embedder's device and
    draws them from a generator there; on the CPU that generator is the host
    init's, so the towers are the same."""
    base = jlookup("openclip:timm/eva02_base_patch16_clip_224.merged2b_s8b_b131k")
    arch = _port_arch(dataclasses.replace(
        base, vision=jeva.EvaVisionConfig(**TINY, **VARIANTS["enormous"]),
        text=dataclasses.replace(base.text, width=64, layers=2, heads=4, vocab_size=64,
                                 context_length=12, embed_dim=20)))
    towers = []
    for on_device in (False, True):
        emb = TorchEmbedder(spec="openclip:tiny-eva02", arch=arch, load_model=True, check=False,
                            weights_path=None, tokenizer=None, compute_dtype="float32", seed=5,
                            device="cpu", init_on_device=on_device)
        towers.append({**emb._vision.state_dict(), **{f"t.{k}": v for k, v in
                                                      emb._text.state_dict().items()}})
    assert list(towers[0]) == list(towers[1])
    assert all(torch.equal(towers[0][k], towers[1][k]) for k in towers[0])
