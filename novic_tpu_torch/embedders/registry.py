"""Known CLIP-family tower architectures (every entry of
novic_tpu.embedders.registry, with the same hyperparameters: CLIP, SigLIP,
DFN, CLIPA, EVA02 and ALIGN), and those of local checkpoint directories:
'openclip:<dir>' from its open_clip_config.json, 'transformers:<dir>' from
its HF config.json (and an ALIGN directory's preprocessor_config.json), derived
as novic_tpu derives them (with no network, only local directories resolve).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

from novic_tpu_torch.embedders.align import AlignTextConfig, AlignVisionConfig
from novic_tpu_torch.embedders.eva import EvaVisionConfig
from novic_tpu_torch.embedders.preprocess import (
    CLIP_MEAN,
    CLIP_STD,
    SIGLIP_MEAN,
    SIGLIP_STD,
    PreprocessConfig,
)
from novic_tpu_torch.embedders.vit import TextTowerConfig, VisionTowerConfig


@dataclasses.dataclass(frozen=True)
class EmbedderArch:
    vision: "VisionTowerConfig | AlignVisionConfig | EvaVisionConfig"
    text: "TextTowerConfig | AlignTextConfig"
    preprocess: PreprocessConfig
    tokenizer: str       # clip_bpe | sentencepiece | wordpiece | bert
    family: str          # clip | siglip | clipa | align | eva02


def _clip(image_size, patch, v_width, v_layers, v_heads, t_width, t_layers, t_heads,
          embed_dim, act="quick_gelu", vocab=49408, context=77, v_mlp_ratio=4.0):
    return EmbedderArch(
        vision=VisionTowerConfig(image_size=image_size, patch_size=patch, width=v_width,
                                 layers=v_layers, heads=v_heads, embed_dim=embed_dim, act=act,
                                 mlp_ratio=v_mlp_ratio,
                                 use_class_token=True, patch_bias=False, pre_ln=True, pool="cls"),
        text=TextTowerConfig(context_length=context, vocab_size=vocab, width=t_width,
                             layers=t_layers, heads=t_heads, embed_dim=embed_dim, act=act,
                             causal=True, pool="argmax", proj_bias=False),
        preprocess=PreprocessConfig(size=image_size, resize_mode="shortest",
                                    mean=CLIP_MEAN, std=CLIP_STD),
        tokenizer="clip_bpe",
        family="clip",
    )


def _siglip(image_size, patch, width, layers, heads, mlp_dim, embed_dim,
            vocab=32000, context=64):
    ratio = mlp_dim / width
    return EmbedderArch(
        vision=VisionTowerConfig(image_size=image_size, patch_size=patch, width=width,
                                 layers=layers, heads=heads, mlp_ratio=ratio,
                                 embed_dim=embed_dim, act="gelu_tanh", use_class_token=False,
                                 patch_bias=True, pre_ln=False, pool="map",
                                 layer_norm_eps=1e-6),
        text=TextTowerConfig(context_length=context, vocab_size=vocab, width=width,
                             layers=layers, heads=heads, mlp_ratio=ratio, embed_dim=embed_dim,
                             act="gelu_tanh", causal=False, pool="last", proj_bias=True,
                             layer_norm_eps=1e-6),
        preprocess=PreprocessConfig(size=image_size, resize_mode="squash",
                                    mean=SIGLIP_MEAN, std=SIGLIP_STD),
        tokenizer="sentencepiece",
        family="siglip",
    )


def _clipa(v_width, v_layers, v_heads, t_width, t_layers, t_heads, embed_dim,
           image_size=224, patch=14, context=32, vocab=32000, v_mlp_ratio=4.0):
    """CLIPA-v2 (open_clip ViT-*-CLIPA configs): a stock ViT trunk with no
    ln_pre, avg pooling over the patch tokens with the final LN after the
    pool, and a non-causal text tower pooled at the last position over a
    BERT-uncased WordPiece vocab at context 32."""
    return EmbedderArch(
        vision=VisionTowerConfig(image_size=image_size, patch_size=patch, width=v_width,
                                 layers=v_layers, heads=v_heads, embed_dim=embed_dim,
                                 act="gelu", mlp_ratio=v_mlp_ratio,
                                 use_class_token=True, patch_bias=False,
                                 pre_ln=False, pool="avg"),
        text=TextTowerConfig(context_length=context, vocab_size=vocab, width=t_width,
                             layers=t_layers, heads=t_heads, embed_dim=embed_dim,
                             act="gelu", causal=False, pool="last", proj_bias=False),
        preprocess=PreprocessConfig(size=image_size, resize_mode="shortest",
                                    mean=CLIP_MEAN, std=CLIP_STD),
        tokenizer="wordpiece",
        family="clipa",
    )


def _eva02(v_width, v_layers, v_heads, mlp_hidden, t_width, t_layers, t_heads,
           embed_dim, patch=16, image_size=224, swiglu=True, qkv_fused=False,
           use_rope=True):
    """EVA02 CLIP: timm's Eva visual trunk and a stock open_clip CLIP text tower."""
    return EmbedderArch(
        vision=EvaVisionConfig(image_size=image_size, patch_size=patch, width=v_width,
                               layers=v_layers, heads=v_heads, mlp_hidden=mlp_hidden,
                               embed_dim=embed_dim, use_rope=use_rope,
                               ref_feat_shape=16, swiglu=swiglu,
                               inner_attn_norm=swiglu, qkv_fused=qkv_fused),
        text=TextTowerConfig(context_length=77, vocab_size=49408, width=t_width,
                             layers=t_layers, heads=t_heads, embed_dim=embed_dim,
                             act="gelu", causal=True, pool="argmax", proj_bias=False),
        preprocess=PreprocessConfig(size=image_size, resize_mode="shortest",
                                    mean=CLIP_MEAN, std=CLIP_STD),
        tokenizer="clip_bpe",
        family="eva02",
    )


# ALIGN's preprocessing as transformers' EfficientNetImageProcessor does it:
# squash to 346 with NEAREST, center crop to 289, mean 0.5, and std 0.5
# applied twice (normalize, then include_top's re-normalize), folded as 0.25
ALIGN_PREPROCESS = PreprocessConfig(size=289, resize_size=346, resize_mode="squash",
                                    mean=SIGLIP_MEAN, std=(0.25, 0.25, 0.25),
                                    interpolation="nearest")

REGISTRY: dict[str, EmbedderArch] = {
    "openai:ViT-B/32": _clip(224, 32, 768, 12, 12, 512, 12, 8, 512),
    "openai:ViT-B/16": _clip(224, 16, 768, 12, 12, 512, 12, 8, 512),
    "openai:ViT-L/14": _clip(224, 14, 1024, 24, 16, 768, 12, 12, 768),
    "openai:ViT-L/14@336px": _clip(336, 14, 1024, 24, 16, 768, 12, 12, 768),
    "openclip:timm/ViT-B-16-SigLIP": _siglip(224, 16, 768, 12, 12, 3072, 768),
    "openclip:timm/ViT-B-16-SigLIP-384": _siglip(384, 16, 768, 12, 12, 3072, 768),
    "openclip:timm/ViT-L-16-SigLIP-256": _siglip(256, 16, 1024, 24, 16, 4096, 1024),
    "openclip:timm/ViT-SO400M-14-SigLIP": _siglip(224, 14, 1152, 27, 16, 4304, 1152, context=16),
    "openclip:timm/ViT-SO400M-14-SigLIP-384": _siglip(384, 14, 1152, 27, 16, 4304, 1152, context=64),
    "openclip:apple/DFN5B-CLIP-ViT-H-14": _clip(224, 14, 1280, 32, 16, 1024, 24, 16, 1024, act="gelu"),
    "openclip:apple/DFN5B-CLIP-ViT-H-14-378": _clip(378, 14, 1280, 32, 16, 1024, 24, 16, 1024, act="gelu"),
    "openclip:apple/DFN2B-CLIP-ViT-L-14": _clip(224, 14, 1024, 24, 16, 768, 12, 12, 768, act="gelu"),
    "openclip:laion/CLIP-ViT-L-14-DataComp.XL-s13B-b90K": _clip(224, 14, 1024, 24, 16, 768, 12, 12, 768, act="gelu"),
    "transformers:laion/CLIP-ViT-L-14-DataComp.XL-s13B-b90K": _clip(224, 14, 1024, 24, 16, 768, 12, 12, 768, act="gelu"),
    "openclip:laion/CLIP-ViT-B-16-DataComp.XL-s13B-b90K": _clip(224, 16, 768, 12, 12, 512, 12, 8, 512, act="gelu"),
    "openclip:laion/CLIP-ViT-B-32-DataComp.XL-s13B-b90K": _clip(224, 32, 768, 12, 12, 512, 12, 8, 512, act="gelu"),
    "openclip:laion/CLIP-ViT-B-32-256x256-DataComp-s34B-b86K": _clip(256, 32, 768, 12, 12, 512, 12, 8, 512, act="gelu"),
    "openclip:laion/CLIP-ViT-B-32-laion2B-s34B-b79K": _clip(224, 32, 768, 12, 12, 512, 12, 8, 512, act="gelu"),
    "transformers:laion/CLIP-ViT-B-32-laion2B-s34B-b79K": _clip(224, 32, 768, 12, 12, 512, 12, 8, 512, act="gelu"),
    "openclip:laion/CLIP-ViT-H-14-laion2B-s32B-b79K": _clip(224, 14, 1280, 32, 16, 1024, 24, 16, 1024, act="gelu"),
    "transformers:laion/CLIP-ViT-H-14-laion2B-s32B-b79K": _clip(224, 14, 1280, 32, 16, 1024, 24, 16, 1024, act="gelu"),
    "openclip:laion/CLIP-ViT-g-14-laion2B-s34B-b88K": _clip(224, 14, 1408, 40, 16, 1024, 24, 16, 1024, act="gelu", v_mlp_ratio=6144 / 1408),
    "openclip:laion/CLIP-ViT-bigG-14-laion2B-39B-b160k": _clip(224, 14, 1664, 48, 16, 1280, 32, 20, 1280, act="gelu", v_mlp_ratio=8192 / 1664),
    "transformers:laion/CLIP-ViT-bigG-14-laion2B-39B-b160k": _clip(224, 14, 1664, 48, 16, 1280, 32, 20, 1280, act="gelu", v_mlp_ratio=8192 / 1664),
    "transformers:facebook/metaclip-h14-fullcc2.5b": _clip(224, 14, 1280, 32, 16, 1024, 24, 16, 1024),
    "transformers:openai/clip-vit-base-patch32": _clip(224, 32, 768, 12, 12, 512, 12, 8, 512),
    "transformers:openai/clip-vit-base-patch16": _clip(224, 16, 768, 12, 12, 512, 12, 8, 512),
    "transformers:openai/clip-vit-large-patch14": _clip(224, 14, 1024, 24, 16, 768, 12, 12, 768),
    "openclip:rwightman/ViT-L-14-CLIPA-datacomp1B": _clipa(1024, 24, 16, 768, 12, 12, 768),
    "openclip:rwightman/ViT-H-14-CLIPA-datacomp1B": _clipa(1280, 32, 16, 1024, 24, 16, 1024),
    "openclip:rwightman/ViT-bigG-14-CLIPA-datacomp1B": _clipa(
        1664, 48, 16, 1280, 32, 20, 1280, v_mlp_ratio=8192 / 1664),
    "transformers:kakaobrain/align-base": EmbedderArch(
        vision=AlignVisionConfig(), text=AlignTextConfig(), preprocess=ALIGN_PREPROCESS,
        tokenizer="bert", family="align"),
    # base/large: SwiGLU + rope + sub-LN; enormous: plain pre-LN blocks with
    # fused qkv; "plus" differs only in its (bigG-sized) text tower
    "openclip:timm/eva02_base_patch16_clip_224.merged2b_s8b_b131k":
        _eva02(768, 12, 12, 2048, 512, 12, 8, 512),
    "openclip:timm/eva02_large_patch14_clip_224.merged2b_s4b_b131k":
        _eva02(1024, 24, 16, 2730, 768, 12, 12, 768, patch=14),
    "openclip:timm/eva02_enormous_patch14_clip_224.laion2b_s4b_b115k":
        _eva02(1792, 64, 16, 15360, 1024, 24, 16, 1024, patch=14,
               swiglu=False, qkv_fused=True, use_rope=False),
    "openclip:timm/eva02_enormous_patch14_plus_clip_224.laion2b_s9b_b144k":
        _eva02(1792, 64, 16, 15360, 1280, 32, 20, 1024, patch=14,
               swiglu=False, qkv_fused=True, use_rope=False),
}


def lookup(spec: str) -> EmbedderArch:
    if spec in REGISTRY:
        return REGISTRY[spec]
    arch = _arch_from_local_hf(spec) or _arch_from_local_openclip(spec)
    if arch is None:
        raise ValueError(f"Unknown embedder spec '{spec}'. Known: {sorted(REGISTRY)}")
    return arch


# Standard timm trunk geometries that open_clip configs reference by NAME only
# (the JSON carries just timm_model_name; the geometry lives in timm), keyed by
# the size word in the name: width, layers, heads, mlp_dim
_TIMM_SIGLIP_SIZES = {
    "base": (768, 12, 12, 3072),
    "large": (1024, 24, 16, 4096),
    "so400m": (1152, 27, 16, 4304),
}
# EVA02's: width, layers, heads, mlp_hidden, and whether the blocks are the
# SwiGLU/rope/sub-LN kind (else plain blocks with fused qkv)
_TIMM_EVA02_SIZES = {
    "base": (768, 12, 12, 2048, True),
    "large": (1024, 24, 16, 2730, True),
    "enormous": (1792, 64, 16, 15360, False),
}


def _arch_from_local_openclip(spec: str) -> "EmbedderArch | None":
    """An EmbedderArch from a local open_clip checkpoint directory's
    open_clip_config.json (the hub layout {"model_cfg", "preprocess_cfg"}, or a
    bare model config): CLIP and CLIPA from the explicit vision_cfg (CLIPA's
    flags no_ln_pre, pool_type 'avg' and final_ln_after_pool with a BERT
    tokenizer), SigLIP and EVA02 from timm_model_name through the size tables;
    None if the spec names no such directory."""
    kind, _, name = spec.partition(":")
    cfg_path = os.path.join(name, "open_clip_config.json")
    if kind != "openclip" or not os.path.isfile(cfg_path):
        return None
    with open(cfg_path) as f:
        raw = json.load(f)
    model = raw.get("model_cfg", raw)
    pp = raw.get("preprocess_cfg", {})
    v = model.get("vision_cfg", {})
    t = model.get("text_cfg", {})
    embed_dim = model.get("embed_dim", 512)

    # -- text tower + tokenizer ------------------------------------------------
    hf_tok = (t.get("hf_tokenizer_name") or "").lower()
    if "bert" in hf_tok:
        tokenizer = "wordpiece"        # CLIPA: BERT-uncased, strip-SEP
    elif hf_tok:
        tokenizer = "sentencepiece"    # SigLIP-style timm tokenizers
    else:
        tokenizer = "clip_bpe"
    act_kwargs = t.get("act_kwargs") or {}
    if act_kwargs.get("approximate") == "tanh":
        t_act = "gelu_tanh"
    elif model.get("quick_gelu", False):
        t_act = "quick_gelu"  # model-level quick_gelu applies to BOTH towers
    else:
        t_act = "gelu"
    text = TextTowerConfig(
        context_length=t.get("context_length", 77),
        vocab_size=t.get("vocab_size", 49408),
        width=t.get("width", 512), layers=t.get("layers", 12),
        heads=t.get("heads", max(t.get("width", 512) // 64, 1)),
        mlp_ratio=t.get("mlp_ratio", 4.0), embed_dim=embed_dim, act=t_act,
        causal=not t.get("no_causal_mask", False),
        pool={"last": "last", "argmax": "argmax", "tok": "argmax"}.get(
            t.get("pool_type", "argmax"), "argmax"),
        proj_bias=bool(t.get("proj_bias", False)),
        layer_norm_eps=(t.get("norm_kwargs") or {}).get("eps", 1e-5))

    # -- vision tower ----------------------------------------------------------
    timm_name = v.get("timm_model_name") or ""
    family = "clip"
    if timm_name:
        m = re.match(r"(vit|eva02)_([a-z0-9]+)_patch(\d+)_(siglip|clip)(_gap)?(?:_(\d+))?",
                     timm_name)
        if not m:
            return None
        trunk, size_word, patch, kind_word, gap, res = m.groups()
        image_size, patch = int(res) if res else v.get("image_size", 224), int(patch)
        if trunk == "vit" and kind_word == "siglip" and size_word in _TIMM_SIGLIP_SIZES:
            w, l, h, mlp = _TIMM_SIGLIP_SIZES[size_word]
            vision = VisionTowerConfig(
                image_size=image_size, patch_size=patch, width=w, layers=l, heads=h,
                mlp_ratio=mlp / w, embed_dim=embed_dim, act="gelu_tanh",
                use_class_token=False, patch_bias=True, pre_ln=False,
                pool="avg" if gap else "map", layer_norm_eps=1e-6)
            family = "siglip"
        elif trunk == "eva02" and size_word in _TIMM_EVA02_SIZES:
            w, l, h, mlp, modern = _TIMM_EVA02_SIZES[size_word]
            vision = EvaVisionConfig(
                image_size=image_size, patch_size=patch, width=w, layers=l, heads=h,
                mlp_hidden=mlp, embed_dim=embed_dim, use_rope=modern, ref_feat_shape=16,
                swiglu=modern, inner_attn_norm=modern, qkv_fused=not modern)
            family = "eva02"
        else:
            return None
    else:
        width = v.get("width", 768)
        head_width = v.get("head_width", 64)
        pool = {"tok": "cls", "avg": "avg"}.get(v.get("pool_type", "tok"), "cls")
        if pool == "avg" and v.get("final_ln_after_pool", False) and tokenizer == "wordpiece":
            family = "clipa"
        vision = VisionTowerConfig(
            image_size=v.get("image_size", 224), patch_size=v.get("patch_size", 16),
            width=width, layers=v.get("layers", 12), heads=max(width // head_width, 1),
            mlp_ratio=v.get("mlp_ratio", 4.0), embed_dim=embed_dim,
            act="quick_gelu" if model.get("quick_gelu", False) else "gelu",
            use_class_token=True, patch_bias=False,
            pre_ln=not v.get("no_ln_pre", False), pool=pool)

    # -- preprocessing ---------------------------------------------------------
    size = pp.get("size", vision.image_size)
    if isinstance(size, (list, tuple)):
        size = int(size[0])
    siglip = family == "siglip"
    preprocess = PreprocessConfig(
        size=int(size), resize_mode=pp.get("resize_mode", "squash" if siglip else "shortest"),
        mean=tuple(pp.get("mean", SIGLIP_MEAN if siglip else CLIP_MEAN)),
        std=tuple(pp.get("std", SIGLIP_STD if siglip else CLIP_STD)),
        interpolation=pp.get("interpolation", "bicubic"))
    return EmbedderArch(vision=vision, text=text, preprocess=preprocess,
                        tokenizer=tokenizer, family=family)


def _arch_from_local_hf(spec: str) -> "EmbedderArch | None":
    """An EmbedderArch from a local HF checkpoint directory's config.json
    (model_type clip, siglip or align); None if the spec names no such
    directory."""
    kind, _, name = spec.partition(":")
    cfg_path = os.path.join(name, "config.json")
    if kind != "transformers" or not os.path.isfile(cfg_path):
        return None
    with open(cfg_path) as f:
        hf = json.load(f)
    if hf.get("model_type") == "align":
        return _align_arch_from_local_hf(name, hf)
    if hf.get("model_type") == "siglip":
        return _siglip_arch_from_local_hf(hf)
    if hf.get("model_type") != "clip":
        return None
    v, t = hf["vision_config"], hf["text_config"]
    act = {"quick_gelu": "quick_gelu", "gelu": "gelu",
           "gelu_new": "gelu_tanh", "gelu_pytorch_tanh": "gelu_tanh"}[
        v.get("hidden_act", "quick_gelu")]
    embed_dim = hf.get("projection_dim", 512)
    return EmbedderArch(
        vision=VisionTowerConfig(
            image_size=v.get("image_size", 224), patch_size=v.get("patch_size", 32),
            width=v.get("hidden_size", 768), layers=v.get("num_hidden_layers", 12),
            heads=v.get("num_attention_heads", 12),
            mlp_ratio=v.get("intermediate_size", 3072) / v.get("hidden_size", 768),
            embed_dim=embed_dim, act=act, use_class_token=True, patch_bias=False,
            pre_ln=True, pool="cls", layer_norm_eps=v.get("layer_norm_eps", 1e-5)),
        text=TextTowerConfig(
            context_length=t.get("max_position_embeddings", 77),
            vocab_size=t.get("vocab_size", 49408), width=t.get("hidden_size", 512),
            layers=t.get("num_hidden_layers", 12), heads=t.get("num_attention_heads", 8),
            mlp_ratio=t.get("intermediate_size", 2048) / t.get("hidden_size", 512),
            embed_dim=embed_dim, act=act, causal=True, pool="argmax", proj_bias=False,
            layer_norm_eps=t.get("layer_norm_eps", 1e-5)),
        preprocess=PreprocessConfig(size=v.get("image_size", 224),
                                    resize_mode="shortest", mean=CLIP_MEAN, std=CLIP_STD),
        tokenizer="clip_bpe",
        family="clip",
    )


def _siglip_arch_from_local_hf(hf: dict) -> EmbedderArch:
    """SigLIP arch from a local HF config (explicit vision/text configs; HF
    SiglipModel has no separate projection: embed_dim = hidden_size)."""
    v, t = hf["vision_config"], hf["text_config"]
    vw, tw = v.get("hidden_size", 768), t.get("hidden_size", 768)
    return EmbedderArch(
        vision=VisionTowerConfig(
            image_size=v.get("image_size", 224), patch_size=v.get("patch_size", 16),
            width=vw, layers=v.get("num_hidden_layers", 12),
            heads=v.get("num_attention_heads", 12),
            mlp_ratio=v.get("intermediate_size", 3072) / vw,
            embed_dim=vw, act="gelu_tanh", use_class_token=False, patch_bias=True,
            pre_ln=False, pool="map", layer_norm_eps=v.get("layer_norm_eps", 1e-6)),
        text=TextTowerConfig(
            context_length=t.get("max_position_embeddings", 64),
            vocab_size=t.get("vocab_size", 32000), width=tw,
            layers=t.get("num_hidden_layers", 12),
            heads=t.get("num_attention_heads", 12),
            mlp_ratio=t.get("intermediate_size", 3072) / tw,
            embed_dim=tw, act="gelu_tanh", causal=False, pool="last",
            proj_bias=True, layer_norm_eps=t.get("layer_norm_eps", 1e-6)),
        preprocess=PreprocessConfig(size=v.get("image_size", 224), resize_mode="squash",
                                    mean=SIGLIP_MEAN, std=SIGLIP_STD),
        tokenizer="sentencepiece",
        family="siglip",
    )


def _align_arch_from_local_hf(dirpath: str, hf: dict) -> EmbedderArch:
    """ALIGN arch from a local HF checkpoint directory: its config.json and
    preprocessor_config.json take precedence over the registry's defaults."""
    v = hf.get("vision_config", {})
    t = hf.get("text_config", {})
    vision = AlignVisionConfig(
        width_coefficient=v.get("width_coefficient", 2.0),
        depth_coefficient=v.get("depth_coefficient", 3.1),
        depth_divisor=v.get("depth_divisor", 8),
        kernel_sizes=tuple(v.get("kernel_sizes", (3, 3, 5, 3, 5, 5, 3))),
        in_channels=tuple(v.get("in_channels", (32, 16, 24, 40, 80, 112, 192))),
        out_channels=tuple(v.get("out_channels", (16, 24, 40, 80, 112, 192, 320))),
        strides=tuple(v.get("strides", (1, 2, 2, 2, 1, 2, 1))),
        num_block_repeats=tuple(v.get("num_block_repeats", (1, 2, 2, 3, 3, 4, 1))),
        expand_ratios=tuple(v.get("expand_ratios", (1, 6, 6, 6, 6, 6, 6))),
        depthwise_padding=tuple(v.get("depthwise_padding", ())),
        squeeze_expansion_ratio=v.get("squeeze_expansion_ratio", 0.25),
    )
    vision = dataclasses.replace(vision, embed_dim=vision.round_filters(vision.out_channels[-1]))
    text = AlignTextConfig(
        # kakaobrain's tokenizer caps at 64; never past the position table
        context_length=min(64, t.get("max_position_embeddings", 512)),
        vocab_size=t.get("vocab_size", 30522), width=t.get("hidden_size", 768),
        layers=t.get("num_hidden_layers", 12), heads=t.get("num_attention_heads", 12),
        mlp_dim=t.get("intermediate_size", 3072),
        max_position_embeddings=t.get("max_position_embeddings", 512),
        type_vocab_size=t.get("type_vocab_size", 2),
        act=t.get("hidden_act", "gelu"), layer_norm_eps=t.get("layer_norm_eps", 1e-12),
        embed_dim=hf.get("projection_dim", 640), pad_token_id=t.get("pad_token_id", 0),
    )
    pre = ALIGN_PREPROCESS
    pp_path = os.path.join(dirpath, "preprocessor_config.json")
    if os.path.isfile(pp_path):
        with open(pp_path) as f:
            pp = json.load(f)

        def _side(val, default):
            if isinstance(val, dict):
                return int(val.get("height", val.get("shortest_edge", default)))
            return int(val) if val is not None else default

        resize_to = _side(pp.get("size"), 346)
        if pp.get("do_center_crop", False):
            size, resize_size = _side(pp.get("crop_size"), 289), resize_to
        else:
            size, resize_size = resize_to, 0
        interp = {0: "nearest", 2: "bilinear", 3: "bicubic"}.get(pp.get("resample", 0), "bicubic")
        std = tuple(pp.get("image_std", SIGLIP_STD))
        if pp.get("include_top", True):
            # The processor divides by std twice (normalize, then include_top's
            # re-normalize): an effective std of std squared
            std = tuple(s * s for s in std)
        pre = PreprocessConfig(
            size=size, resize_size=resize_size if resize_size != size else 0,
            resize_mode="squash", mean=tuple(pp.get("image_mean", SIGLIP_MEAN)),
            std=std, interpolation=interp)
    vision = dataclasses.replace(vision, image_size=pre.size)
    return EmbedderArch(vision=vision, text=text, preprocess=pre, tokenizer="bert",
                        family="align")
