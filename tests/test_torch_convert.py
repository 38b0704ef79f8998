"""The port's tower conversion (novic_tpu_torch.embedders.convert), local
checkpoint directories in its registry and its convert_embedder action,
against novic_tpu on the CPU.

* HF CLIPModel / SiglipModel built from a small config (transformers, no
  download) convert to trees equal bit for bit to novic_tpu's; with those
  weights the port's float32 towers are within 2e-4 of transformers'
  get_image_features / get_text_features. The port's tower self-attention
  always runs K1 (ops.attention.fused_attention), whose operands are bf16 as
  the JAX package's Pallas kernel's are; that rounding alone moves these
  embeddings by ~1e-3, so this comparison swaps K1 for exact float32
  attention (the same function without the bf16 rounding). The K1 tower is
  held to novic_tpu's Pallas-attention tower in tests/test_torch_vit.py.
* open_clip-named state dicts (tests/test_openclip_convert.py's CLIP fixture,
  and the HF models above renamed to open_clip / timm naming, SigLIP's text
  tower under text. with and without text_model.) convert equal to
  novic_tpu's, and the renamed models equal their HF conversion.
* save_params_npz writes novic_tpu's .npz layout: the same keys in the same
  order; either package's file loads in the other.
* Local open_clip and HF directories resolve to novic_tpu's archs, CLIPA,
  EVA02 and ALIGN directories too, and those families convert equal to
  novic_tpu (tests/test_torch_clipa.py, test_torch_eva.py and
  test_torch_align.py hold their towers); every registered spec resolves to
  novic_tpu's arch, field by field, and tower_modules builds each family.
* action=convert_embedder converts a local open_clip .bin and a local HF
  directory to the .npz novic_tpu's conversion writes.
"""

import json
import math

import numpy as np
import pytest
import torch
import transformers

from novic_tpu.embedders import convert as jconvert
from novic_tpu.embedders.registry import lookup as jlookup
from novic_tpu_torch.bridge import text_tower_from_numpy, vision_tower_from_numpy
from novic_tpu_torch.cli.train import main
from novic_tpu_torch.embedders import convert, vit
from novic_tpu_torch.embedders.registry import lookup
from novic_tpu_torch.embedders.vit import TextTowerConfig, VisionTowerConfig
from novic_tpu_torch.utils.misc import flatten_dict
from test_openclip_convert import make_openclip_clip_sd

torch.set_num_threads(2)
TOL = 2e-4  # float32, another summation order than transformers'
E, L, IMG, P, CTX, VOCAB, PROJ = 32, 2, 24, 8, 16, 99, 20


def _assert_trees_equal(a: dict, b: dict):
    fa, fb = flatten_dict(a), flatten_dict(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _hf_model(family: str):
    if family == "clip":
        cfg = transformers.CLIPConfig(
            text_config_dict=dict(vocab_size=VOCAB, hidden_size=E, intermediate_size=2 * E,
                                  num_hidden_layers=L, num_attention_heads=4,
                                  max_position_embeddings=CTX, hidden_act="quick_gelu",
                                  bos_token_id=97, eos_token_id=98, pad_token_id=0),
            vision_config_dict=dict(hidden_size=E, intermediate_size=2 * E, num_hidden_layers=L,
                                    num_attention_heads=4, image_size=IMG, patch_size=P,
                                    hidden_act="quick_gelu"),
            projection_dim=PROJ)
        torch.manual_seed(0)
        return transformers.CLIPModel(cfg).eval()
    cfg = transformers.SiglipConfig(
        text_config=dict(vocab_size=VOCAB, hidden_size=E, intermediate_size=2 * E,
                         num_hidden_layers=L, num_attention_heads=4,
                         max_position_embeddings=CTX, hidden_act="gelu_pytorch_tanh"),
        vision_config=dict(hidden_size=E, intermediate_size=2 * E, num_hidden_layers=L,
                           num_attention_heads=4, image_size=IMG, patch_size=P,
                           hidden_act="gelu_pytorch_tanh"))
    torch.manual_seed(0)
    return transformers.SiglipModel(cfg).eval()


@pytest.fixture(scope="module")
def hf_models():
    return {family: _hf_model(family) for family in ("clip", "siglip")}


def _tower_cfgs(family: str):
    if family == "clip":
        return (VisionTowerConfig(image_size=IMG, patch_size=P, width=E, layers=L, heads=4,
                                  mlp_ratio=2.0, embed_dim=PROJ, act="quick_gelu",
                                  use_class_token=True, patch_bias=False, pre_ln=True,
                                  pool="cls", compute_dtype="float32"),
                TextTowerConfig(context_length=CTX, vocab_size=VOCAB, width=E, layers=L, heads=4,
                                mlp_ratio=2.0, embed_dim=PROJ, act="quick_gelu", causal=True,
                                pool="argmax", proj_bias=False, compute_dtype="float32"))
    return (VisionTowerConfig(image_size=IMG, patch_size=P, width=E, layers=L, heads=4,
                              mlp_ratio=2.0, embed_dim=E, act="gelu_tanh", use_class_token=False,
                              patch_bias=True, pre_ln=False, pool="map", layer_norm_eps=1e-6,
                              compute_dtype="float32"),
            TextTowerConfig(context_length=CTX, vocab_size=VOCAB, width=E, layers=L, heads=4,
                            mlp_ratio=2.0, embed_dim=E, act="gelu_tanh", causal=False,
                            pool="last", proj_bias=True, layer_norm_eps=1e-6,
                            compute_dtype="float32"))


@pytest.mark.parametrize("family", ["clip", "siglip"])
def test_hf_conversion_equals_jax(hf_models, family):
    v, t = convert.convert_hf_model(hf_models[family], family)
    jv, jt = jconvert.convert_hf_model(hf_models[family], family)
    _assert_trees_equal(v, jv)
    _assert_trees_equal(t, jt)


@pytest.fixture
def f32_attention(monkeypatch):
    """K1's function in exact float32: softmax(q k^T / sqrt(hd) + bias) v."""
    def attention(q, k, v, bias=None):
        scores = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(q.shape[-1]), k)
        if bias is not None:
            scores = scores + bias
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)

    monkeypatch.setattr(vit, "fused_attention", attention)


@pytest.mark.parametrize("family,tower", [("clip", "vision"), ("clip", "text"),
                                          ("siglip", "vision"), ("siglip", "text")])
def test_converted_towers_match_transformers(hf_models, f32_attention, family, tower):
    model = hf_models[family]
    v, t = convert.convert_hf_model(model, family)
    vcfg, tcfg = _tower_cfgs(family)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        if tower == "vision":
            imgs = rng.normal(size=(3, IMG, IMG, 3)).astype(np.float32)
            ref = model.get_image_features(pixel_values=torch.from_numpy(imgs.transpose(0, 3, 1, 2)))
            out = vision_tower_from_numpy(vcfg, v)(torch.from_numpy(imgs))
        else:
            # CLIP-style sequences: bos=97 < content < eos=98, eos the max id (argmax pool)
            toks = rng.integers(1, 97, size=(4, CTX))
            toks[:, 0] = 97
            for i, n in enumerate(rng.integers(3, CTX - 1, size=4)):
                toks[i, n] = 98
                toks[i, n + 1:] = 0
            ref = model.get_text_features(input_ids=torch.from_numpy(toks))
            out = text_tower_from_numpy(tcfg, t)(torch.from_numpy(toks))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


def _openclip_from_hf(model, family: str, text_prefix: str = "text_model.") -> dict:
    """The HF model's weights under open_clip names (CLIP) or timm trunk names
    plus the HF-named text tower under text. (SigLIP)."""
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out = {}
    if family == "clip":
        vm = "vision_model"
        out["visual.conv1.weight"] = sd[f"{vm}.embeddings.patch_embedding.weight"]
        out["visual.class_embedding"] = sd[f"{vm}.embeddings.class_embedding"]
        out["visual.positional_embedding"] = sd[f"{vm}.embeddings.position_embedding.weight"]
        for ours, hf in (("ln_pre", "pre_layrnorm"), ("ln_post", "post_layernorm")):
            for leaf in ("weight", "bias"):
                out[f"visual.{ours}.{leaf}"] = sd[f"{vm}.{hf}.{leaf}"]
        out["visual.proj"] = sd["visual_projection.weight"].T.contiguous()
        tm = "text_model"
        out["token_embedding.weight"] = sd[f"{tm}.embeddings.token_embedding.weight"]
        out["positional_embedding"] = sd[f"{tm}.embeddings.position_embedding.weight"]
        out["ln_final.weight"] = sd[f"{tm}.final_layer_norm.weight"]
        out["ln_final.bias"] = sd[f"{tm}.final_layer_norm.bias"]
        out["text_projection"] = sd["text_projection.weight"].T.contiguous()
        for src, dst in ((vm, "visual.transformer"), (tm, "transformer")):
            for i in range(L):
                h, o = f"{src}.encoder.layers.{i}", f"{dst}.resblocks.{i}"
                for leaf in ("weight", "bias"):
                    out[f"{o}.attn.in_proj_{leaf}"] = torch.cat(
                        [sd[f"{h}.self_attn.{x}_proj.{leaf}"] for x in "qkv"])
                    out[f"{o}.attn.out_proj.{leaf}"] = sd[f"{h}.self_attn.out_proj.{leaf}"]
                    out[f"{o}.ln_1.{leaf}"] = sd[f"{h}.layer_norm1.{leaf}"]
                    out[f"{o}.ln_2.{leaf}"] = sd[f"{h}.layer_norm2.{leaf}"]
                    out[f"{o}.mlp.c_fc.{leaf}"] = sd[f"{h}.mlp.fc1.{leaf}"]
                    out[f"{o}.mlp.c_proj.{leaf}"] = sd[f"{h}.mlp.fc2.{leaf}"]
        return out
    vm, t = "vision_model", "visual.trunk"
    for leaf in ("weight", "bias"):
        out[f"{t}.patch_embed.proj.{leaf}"] = sd[f"{vm}.embeddings.patch_embedding.{leaf}"]
        out[f"{t}.norm.{leaf}"] = sd[f"{vm}.post_layernorm.{leaf}"]
        out[f"{t}.attn_pool.q.{leaf}"] = sd[f"{vm}.head.attention.in_proj_{leaf}"][:E]
        out[f"{t}.attn_pool.kv.{leaf}"] = sd[f"{vm}.head.attention.in_proj_{leaf}"][E:]
        out[f"{t}.attn_pool.proj.{leaf}"] = sd[f"{vm}.head.attention.out_proj.{leaf}"]
        out[f"{t}.attn_pool.norm.{leaf}"] = sd[f"{vm}.head.layernorm.{leaf}"]
        for fc in ("fc1", "fc2"):
            out[f"{t}.attn_pool.mlp.{fc}.{leaf}"] = sd[f"{vm}.head.mlp.{fc}.{leaf}"]
        for i in range(L):
            h, o = f"{vm}.encoder.layers.{i}", f"{t}.blocks.{i}"
            out[f"{o}.attn.qkv.{leaf}"] = torch.cat([sd[f"{h}.self_attn.{x}_proj.{leaf}"]
                                                    for x in "qkv"])
            out[f"{o}.attn.proj.{leaf}"] = sd[f"{h}.self_attn.out_proj.{leaf}"]
            out[f"{o}.norm1.{leaf}"] = sd[f"{h}.layer_norm1.{leaf}"]
            out[f"{o}.norm2.{leaf}"] = sd[f"{h}.layer_norm2.{leaf}"]
            for fc in ("fc1", "fc2"):
                out[f"{o}.mlp.{fc}.{leaf}"] = sd[f"{h}.mlp.{fc}.{leaf}"]
    out[f"{t}.pos_embed"] = sd[f"{vm}.embeddings.position_embedding.weight"][None]
    out[f"{t}.attn_pool.latent"] = sd[f"{vm}.head.probe"]
    for k, v in sd.items():
        if k.startswith("text_model."):
            out["text." + text_prefix + k[len("text_model."):]] = v
    return out


@pytest.mark.parametrize("family,text_prefix", [("clip", ""), ("siglip", "text_model."),
                                                ("siglip", "")])
def test_openclip_conversion_equals_jax_and_hf(hf_models, family, text_prefix):
    sd = _openclip_from_hf(hf_models[family], family, text_prefix)
    v, t = convert.convert_openclip_state_dict(sd, family, L, L)
    jv, jt = jconvert.convert_openclip_state_dict(sd, family, L, L)
    _assert_trees_equal(v, jv)
    _assert_trees_equal(t, jt)
    # The renamed weights are the HF model's: the same trees as its HF conversion
    hv, ht = convert.convert_hf_model(hf_models[family], family)
    for a, b in ((v, hv), (t, ht)):
        fa, fb = flatten_dict(a), flatten_dict(b)
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_openclip_fixture_conversion_equals_jax():
    """tests/test_openclip_convert.py's CLIP state dict, as numpy and as tensors."""
    sd = make_openclip_clip_sd(np.random.default_rng(0))
    for form in (sd, {k: torch.from_numpy(v) for k, v in sd.items()}):
        v, t = convert.convert_openclip_state_dict(form, "clip", 2, 2)
        jv, jt = jconvert.convert_openclip_state_dict(sd, "clip", 2, 2)
        _assert_trees_equal(v, jv)
        _assert_trees_equal(t, jt)


def _tiny_align_model():
    from transformers.models.align.configuration_align import (
        AlignConfig,
        AlignTextConfig,
        AlignVisionConfig,
    )

    vision = AlignVisionConfig(image_size=32, width_coefficient=0.25, depth_coefficient=1.0,
                               depth_divisor=4, kernel_sizes=[3, 5], in_channels=[32, 48],
                               out_channels=[48, 64], strides=[1, 2], num_block_repeats=[1, 2],
                               expand_ratios=[1, 6], hidden_dim=64)
    text = AlignTextConfig(vocab_size=VOCAB, hidden_size=E, num_hidden_layers=L,
                           num_attention_heads=4, intermediate_size=2 * E,
                           max_position_embeddings=CTX)
    torch.manual_seed(0)
    return transformers.AlignModel(AlignConfig(text_config=text.to_dict(),
                                               vision_config=vision.to_dict(),
                                               projection_dim=16)).eval()


@pytest.mark.parametrize("family", ["clipa", "eva02", "align"])
def test_not_ported_families_raise(family):
    """These families were refused before they were ported; each now converts
    to novic_tpu's tree bit for bit (CLIPA's open_clip dict, EVA02's
    timm-named trunk with the stock text tower, a tiny HF AlignModel)."""
    if family == "align":
        model = _tiny_align_model()
        v, t = convert.convert_hf_model(model, family)
        jv, jt = jconvert.convert_hf_model(model, family)
    else:
        from test_clipa import make_openclip_clipa_sd

        sd = make_openclip_clipa_sd(np.random.default_rng(1))
        jcfg = None
        if family == "eva02":
            from test_eva_parity import _TorchEva

            from novic_tpu.embedders.eva import EvaVisionConfig

            jcfg = EvaVisionConfig(image_size=16, patch_size=8, width=32, layers=2, heads=4,
                                   mlp_hidden=40, embed_dim=20, ref_feat_shape=4)
            torch.manual_seed(1)
            sd = {k: v for k, v in sd.items() if not k.startswith("visual.")}
            sd.update({f"visual.trunk.{k}": v for k, v in _TorchEva(jcfg).state_dict().items()})
        v, t = convert.convert_openclip_state_dict(sd, family, 2, 2, vision_cfg=jcfg)
        jv, jt = jconvert.convert_openclip_state_dict(sd, family, 2, 2, vision_cfg=jcfg)
    _assert_trees_equal(v, jv)
    _assert_trees_equal(t, jt)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_params_npz_layout_and_cross_load(hf_models, tmp_path, writer):
    v, t = convert.convert_hf_model(hf_models["siglip"], "siglip")
    pj, pp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jconvert.save_params_npz(pj, v, t)
    convert.save_params_npz(pp, v, t)
    with np.load(pj) as a, np.load(pp) as b:
        assert a.files == b.files  # the same names in the same order
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    path = pp if writer == "port" else pj
    for lv, lt in (convert.load_params_npz(path), jconvert.load_params_npz(path)):
        for a, b in ((lv, v), (lt, t)):
            fa, fb = flatten_dict(a), flatten_dict(b)
            assert set(fa) == set(fb)
            for k in fa:
                np.testing.assert_array_equal(fa[k], fb[k])


# -- local checkpoint directories ------------------------------------------------

SIGLIP_OPENCLIP = {
    "model_cfg": {"embed_dim": 768, "init_logit_bias": -10, "custom_text": True,
                  "vision_cfg": {"timm_model_name": "vit_base_patch16_siglip_224",
                                 "timm_model_pretrained": False, "timm_pool": "map",
                                 "timm_proj": "none", "image_size": 224},
                  "text_cfg": {"context_length": 64, "vocab_size": 32000,
                               "hf_tokenizer_name": "timm/ViT-B-16-SigLIP", "width": 768,
                               "heads": 12, "layers": 12, "no_causal_mask": True,
                               "proj_bias": True, "pool_type": "last",
                               "norm_kwargs": {"eps": 1e-6},
                               "act_kwargs": {"approximate": "tanh"}}},
    "preprocess_cfg": {"mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5],
                       "interpolation": "bicubic", "resize_mode": "squash", "size": 224}}
SO400M_OPENCLIP = {
    "embed_dim": 1152,
    "vision_cfg": {"timm_model_name": "vit_so400m_patch14_siglip_512", "image_size": 512},
    "text_cfg": {"context_length": 64, "vocab_size": 32000,
                 "hf_tokenizer_name": "timm/ViT-SO400M-14-SigLIP", "width": 1152, "heads": 16,
                 "layers": 27, "no_causal_mask": True, "proj_bias": True, "pool_type": "last",
                 "norm_kwargs": {"eps": 1e-6}, "act_kwargs": {"approximate": "tanh"}}}
CLIP_OPENCLIP = {
    "embed_dim": 64,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16,
                   "head_width": 32},
    "text_cfg": {"context_length": 16, "vocab_size": 128, "width": 64, "heads": 2, "layers": 2}}
CLIP_QUICK_GAP_OPENCLIP = {
    "embed_dim": 64, "quick_gelu": True,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16,
                   "pool_type": "avg"},
    "text_cfg": {"context_length": 16, "vocab_size": 128, "width": 64, "heads": 2, "layers": 2}}
CLIP_HF = {
    "model_type": "clip", "projection_dim": 64,
    "vision_config": {"hidden_size": 96, "num_hidden_layers": 3, "num_attention_heads": 4,
                      "intermediate_size": 384, "image_size": 112, "patch_size": 16,
                      "hidden_act": "quick_gelu"},
    "text_config": {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
                    "intermediate_size": 256, "vocab_size": 1000,
                    "max_position_embeddings": 77, "hidden_act": "quick_gelu"}}
SIGLIP_HF = {
    "model_type": "siglip",
    "vision_config": {"image_size": 224, "patch_size": 16, "hidden_size": 768,
                      "num_hidden_layers": 12, "num_attention_heads": 12,
                      "intermediate_size": 3072, "layer_norm_eps": 1e-6},
    "text_config": {"max_position_embeddings": 64, "vocab_size": 32000, "hidden_size": 768,
                    "num_hidden_layers": 12, "num_attention_heads": 12,
                    "intermediate_size": 3072, "layer_norm_eps": 1e-6}}
CLIPA_OPENCLIP = {
    "embed_dim": 768,
    "vision_cfg": {"image_size": 224, "layers": 24, "width": 1024, "patch_size": 14,
                   "no_ln_pre": True, "pool_type": "avg", "final_ln_after_pool": True},
    "text_cfg": {"context_length": 32, "vocab_size": 32000,
                 "hf_tokenizer_name": "bert-base-uncased", "width": 768, "heads": 12,
                 "layers": 12, "pool_type": "last", "no_causal_mask": True}}
EVA02_OPENCLIP = {
    "embed_dim": 512,
    "vision_cfg": {"image_size": 224, "timm_model_name": "eva02_base_patch16_clip_224"},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 512, "heads": 8,
                 "layers": 12}}
ALIGN_HF = {"model_type": "align", "projection_dim": 640}


def _local_dir(tmp_path, kind: str, cfg: dict) -> str:
    d = tmp_path / "ckpt"
    d.mkdir()
    name = "open_clip_config.json" if kind == "openclip" else "config.json"
    (d / name).write_text(json.dumps(cfg))
    return f"{kind}:{d}"


@pytest.mark.parametrize("kind,cfg", [("openclip", SIGLIP_OPENCLIP),
                                      ("openclip", SO400M_OPENCLIP),
                                      ("openclip", CLIP_OPENCLIP),
                                      ("openclip", CLIP_QUICK_GAP_OPENCLIP),
                                      ("transformers", CLIP_HF),
                                      ("transformers", SIGLIP_HF)],
                         ids=["siglip", "so400m", "clip", "clip_quick_avg", "hf_clip",
                              "hf_siglip"])
def test_local_directories_resolve_as_jax(tmp_path, kind, cfg):
    import dataclasses

    spec = _local_dir(tmp_path, kind, cfg)
    arch, jarch = lookup(spec), jlookup(spec)
    for part in ("vision", "text", "preprocess"):
        assert dataclasses.asdict(getattr(arch, part)) == \
            dataclasses.asdict(getattr(jarch, part)), part
    assert (arch.tokenizer, arch.family) == (jarch.tokenizer, jarch.family)
    if cfg is SIGLIP_OPENCLIP:
        assert arch == lookup("openclip:timm/ViT-B-16-SigLIP")


@pytest.mark.parametrize("kind,cfg", [("openclip", CLIPA_OPENCLIP), ("openclip", EVA02_OPENCLIP),
                                      ("transformers", ALIGN_HF)], ids=["clipa", "eva02", "align"])
def test_local_directories_of_unported_families_raise(tmp_path, kind, cfg):
    """Directories of the families ported last resolve to novic_tpu's arch
    (they raised before); a missing directory still raises."""
    import dataclasses

    spec = _local_dir(tmp_path, kind, cfg)
    arch, jarch = lookup(spec), jlookup(spec)
    for part in ("vision", "text", "preprocess"):
        assert dataclasses.asdict(getattr(arch, part)) == \
            dataclasses.asdict(getattr(jarch, part)), part
    assert (arch.tokenizer, arch.family) == (jarch.tokenizer, jarch.family)
    assert arch.family == {"openclip": "eva02" if cfg is EVA02_OPENCLIP else "clipa"}.get(
        kind, "align")
    with pytest.raises(ValueError, match="Unknown embedder spec"):
        lookup(f"{kind}:{tmp_path}/missing")


def test_registry_resolves_every_jax_spec():
    """Every spec of novic_tpu's registry resolves in the port to an arch
    equal to novic_tpu's, field by field (config classes by name), and
    tower_modules builds each family's towers (on the meta device: the
    largest are tens of GB)."""
    import dataclasses

    from novic_tpu.embedders.registry import REGISTRY as JREGISTRY
    from novic_tpu_torch.embedders.base import tower_modules

    families = set()
    for spec, jarch in JREGISTRY.items():
        arch = lookup(spec)
        for part in ("vision", "text", "preprocess"):
            assert type(getattr(arch, part)).__name__ == type(getattr(jarch, part)).__name__
            assert dataclasses.asdict(getattr(arch, part)) == \
                dataclasses.asdict(getattr(jarch, part)), (spec, part)
        assert (arch.tokenizer, arch.family) == (jarch.tokenizer, jarch.family), spec
        if arch.family not in families:
            families.add(arch.family)
            with torch.device("meta"):
                vision, text = tower_modules(arch)
            assert hasattr(vision, "init_random") and hasattr(text, "init_random")
    assert families == {"clip", "siglip", "clipa", "align", "eva02"}


# -- action=convert_embedder --------------------------------------------------------


def test_convert_embedder_action_openclip_bin(tmp_path):
    """load_model=<open_clip .bin> of a local open_clip directory's model."""
    spec = _local_dir(tmp_path, "openclip", {
        "embed_dim": 20,
        "vision_cfg": {"image_size": 16, "layers": 2, "width": 32, "patch_size": 8,
                       "head_width": 8, "mlp_ratio": 2.0},
        "text_cfg": {"context_length": 12, "vocab_size": 50, "width": 32, "heads": 4,
                     "layers": 2, "mlp_ratio": 2.0}})
    sd = make_openclip_clip_sd(np.random.default_rng(5))
    binpath, out = tmp_path / "open_clip_pytorch_model.bin", str(tmp_path / "port.npz")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, binpath)
    assert main(["action=convert_embedder", f"embedder={spec}", f"load_model={binpath}",
                 f"embedder_weights={out}", "--device=cpu"]) == out
    jconvert.save_params_npz(str(tmp_path / "jax.npz"),
                             *jconvert.convert_openclip_state_dict(sd, "clip", 2, 2))
    with np.load(out) as a, np.load(tmp_path / "jax.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    arch = lookup(spec)
    v, _ = convert.load_params_npz(out)
    tower = vision_tower_from_numpy(arch.vision, v)
    emb = tower(torch.zeros(2, 16, 16, 3))
    assert emb.shape == (2, 20) and torch.isfinite(emb).all()


def test_convert_embedder_action_local_hf_dir(hf_models, tmp_path):
    """Without load_model: transformers.AutoModel of a local HF directory."""
    d = tmp_path / "hf_siglip"
    hf_models["siglip"].save_pretrained(d)
    out = str(tmp_path / "port.npz")
    main(["action=convert_embedder", f"embedder=transformers:{d}", f"embedder_weights={out}",
          "--device=cpu"])
    v, t = convert.load_params_npz(out)
    jv, jt = jconvert.convert_hf_model(hf_models["siglip"], "siglip")
    for a, b in ((v, jv), (t, jt)):
        fa, fb = flatten_dict(a), flatten_dict(b)
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
