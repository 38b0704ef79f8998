"""Known CLIP-family tower architectures (the ViT-family entries of
novic_tpu.embedders.registry, with the same hyperparameters).

EVA02, ALIGN and CLIPA towers are not ported yet: their specs raise.
"""

from __future__ import annotations

import dataclasses

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
    vision: VisionTowerConfig
    text: TextTowerConfig
    preprocess: PreprocessConfig
    tokenizer: str       # clip_bpe | sentencepiece | wordpiece | bert
    family: str          # clip | siglip


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
}

# Registered in the JAX package but not ported yet (other tower families)
NOT_PORTED = frozenset({
    "openclip:rwightman/ViT-L-14-CLIPA-datacomp1B",
    "openclip:rwightman/ViT-H-14-CLIPA-datacomp1B",
    "openclip:rwightman/ViT-bigG-14-CLIPA-datacomp1B",
    "transformers:kakaobrain/align-base",
    "openclip:timm/eva02_base_patch16_clip_224.merged2b_s8b_b131k",
    "openclip:timm/eva02_large_patch14_clip_224.merged2b_s4b_b131k",
    "openclip:timm/eva02_enormous_patch14_clip_224.laion2b_s4b_b115k",
    "openclip:timm/eva02_enormous_patch14_plus_clip_224.laion2b_s9b_b144k",
})


def lookup(spec: str) -> EmbedderArch:
    if spec in NOT_PORTED:
        raise NotImplementedError(f"Embedder '{spec}' is not ported yet (EVA02/ALIGN/CLIPA towers)")
    if spec not in REGISTRY:
        raise ValueError(f"Unknown embedder spec '{spec}'. Known: {sorted(REGISTRY)}")
    return REGISTRY[spec]
