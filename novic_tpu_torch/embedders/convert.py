"""HF and open_clip state dicts → the port's tower param trees (the
counterpart of novic_tpu.embedders.convert), for every tower family: CLIP and
SigLIP (HF and open_clip naming), CLIPA and EVA02 (open_clip naming; EVA02's
trunk under timm's names) and ALIGN (HF AlignModel, its BatchNorms folded).

The output is the JAX package's numpy tree, under the same names, and
save_params_npz writes the JAX package's .npz layout (the same keys, in the
same order), so a file written by either package loads in the other;
load_params_npz and bridge's *_from_numpy functions serve it. Conversion
runs on the host and never touches the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from novic_tpu_torch.utils.misc import flatten_dict, unflatten_dict


def _np(t) -> np.ndarray:
    """A tensor (bf16 widened to float32, exactly) or array → numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _block_params(sd: dict, prefix: str) -> dict:
    """One HF CLIP/SigLIP encoder layer → TowerBlock params."""
    return {
        "norm1_weight": _np(sd[f"{prefix}.layer_norm1.weight"]),
        "norm1_bias": _np(sd[f"{prefix}.layer_norm1.bias"]),
        "norm2_weight": _np(sd[f"{prefix}.layer_norm2.weight"]),
        "norm2_bias": _np(sd[f"{prefix}.layer_norm2.bias"]),
        "fc1_weight": _np(sd[f"{prefix}.mlp.fc1.weight"]),
        "fc1_bias": _np(sd[f"{prefix}.mlp.fc1.bias"]),
        "fc2_weight": _np(sd[f"{prefix}.mlp.fc2.weight"]),
        "fc2_bias": _np(sd[f"{prefix}.mlp.fc2.bias"]),
        "attn": {
            "q_proj_weight": _np(sd[f"{prefix}.self_attn.q_proj.weight"]),
            "q_proj_bias": _np(sd[f"{prefix}.self_attn.q_proj.bias"]),
            "k_proj_weight": _np(sd[f"{prefix}.self_attn.k_proj.weight"]),
            "k_proj_bias": _np(sd[f"{prefix}.self_attn.k_proj.bias"]),
            "v_proj_weight": _np(sd[f"{prefix}.self_attn.v_proj.weight"]),
            "v_proj_bias": _np(sd[f"{prefix}.self_attn.v_proj.bias"]),
            "out_proj_weight": _np(sd[f"{prefix}.self_attn.out_proj.weight"]),
            "out_proj_bias": _np(sd[f"{prefix}.self_attn.out_proj.bias"]),
        },
    }


def convert_clip_vision(state_dict: dict, num_layers: int) -> dict:
    """HF CLIPVisionModel(+projection) state dict → VisionTransformer params."""
    sd = state_dict
    conv_w = _np(sd["vision_model.embeddings.patch_embedding.weight"])  # (E,3,P,P)
    E = conv_w.shape[0]
    params: dict[str, Any] = {
        # conv kernel → matmul over (ph, pw, c)-ordered patch vectors
        "patch_weight": conv_w.transpose(0, 2, 3, 1).reshape(E, -1),
        "class_embedding": _np(sd["vision_model.embeddings.class_embedding"]).reshape(-1),
        "pos_embedding": _np(sd["vision_model.embeddings.position_embedding.weight"]),
        "pre_ln_weight": _np(sd["vision_model.pre_layrnorm.weight"]),
        "pre_ln_bias": _np(sd["vision_model.pre_layrnorm.bias"]),
        "post_ln_weight": _np(sd["vision_model.post_layernorm.weight"]),
        "post_ln_bias": _np(sd["vision_model.post_layernorm.bias"]),
        "proj_weight": _np(sd["visual_projection.weight"]),
    }
    for i in range(num_layers):
        params[f"blocks_{i}"] = _block_params(sd, f"vision_model.encoder.layers.{i}")
    return params


def convert_clip_text(state_dict: dict, num_layers: int) -> dict:
    sd = state_dict
    params: dict[str, Any] = {
        "token_embedding": _np(sd["text_model.embeddings.token_embedding.weight"]),
        "pos_embedding": _np(sd["text_model.embeddings.position_embedding.weight"]),
        "final_ln_weight": _np(sd["text_model.final_layer_norm.weight"]),
        "final_ln_bias": _np(sd["text_model.final_layer_norm.bias"]),
        "proj_weight": _np(sd["text_projection.weight"]),
    }
    for i in range(num_layers):
        params[f"blocks_{i}"] = _block_params(sd, f"text_model.encoder.layers.{i}")
    return params


def convert_siglip_vision(state_dict: dict, num_layers: int) -> dict:
    sd = state_dict
    conv_w = _np(sd["vision_model.embeddings.patch_embedding.weight"])
    E = conv_w.shape[0]
    in_proj_w = _np(sd["vision_model.head.attention.in_proj_weight"])  # (3E, E)
    in_proj_b = _np(sd["vision_model.head.attention.in_proj_bias"])
    params: dict[str, Any] = {
        "patch_weight": conv_w.transpose(0, 2, 3, 1).reshape(E, -1),
        "patch_bias": _np(sd["vision_model.embeddings.patch_embedding.bias"]),
        "pos_embedding": _np(sd["vision_model.embeddings.position_embedding.weight"]),
        "post_ln_weight": _np(sd["vision_model.post_layernorm.weight"]),
        "post_ln_bias": _np(sd["vision_model.post_layernorm.bias"]),
        "map_probe": _np(sd["vision_model.head.probe"]),
        "map_attn": {
            "q_proj_weight": in_proj_w[:E],
            "q_proj_bias": in_proj_b[:E],
            "k_proj_weight": in_proj_w[E:2 * E],
            "k_proj_bias": in_proj_b[E:2 * E],
            "v_proj_weight": in_proj_w[2 * E:],
            "v_proj_bias": in_proj_b[2 * E:],
            "out_proj_weight": _np(sd["vision_model.head.attention.out_proj.weight"]),
            "out_proj_bias": _np(sd["vision_model.head.attention.out_proj.bias"]),
        },
        "map_ln_weight": _np(sd["vision_model.head.layernorm.weight"]),
        "map_ln_bias": _np(sd["vision_model.head.layernorm.bias"]),
        "map_fc1_weight": _np(sd["vision_model.head.mlp.fc1.weight"]),
        "map_fc1_bias": _np(sd["vision_model.head.mlp.fc1.bias"]),
        "map_fc2_weight": _np(sd["vision_model.head.mlp.fc2.weight"]),
        "map_fc2_bias": _np(sd["vision_model.head.mlp.fc2.bias"]),
    }
    for i in range(num_layers):
        params[f"blocks_{i}"] = _block_params(sd, f"vision_model.encoder.layers.{i}")
    return params


def convert_siglip_text(state_dict: dict, num_layers: int) -> dict:
    sd = state_dict
    params: dict[str, Any] = {
        "token_embedding": _np(sd["text_model.embeddings.token_embedding.weight"]),
        "pos_embedding": _np(sd["text_model.embeddings.position_embedding.weight"]),
        "final_ln_weight": _np(sd["text_model.final_layer_norm.weight"]),
        "final_ln_bias": _np(sd["text_model.final_layer_norm.bias"]),
        "proj_weight": _np(sd["text_model.head.weight"]),
        "proj_bias": _np(sd["text_model.head.bias"]),
    }
    for i in range(num_layers):
        params[f"blocks_{i}"] = _block_params(sd, f"text_model.encoder.layers.{i}")
    return params


def convert_hf_model(model, model_type: str) -> tuple[dict, dict]:
    """Full HF CLIPModel/SiglipModel → (vision_params, text_params)."""
    sd = model.state_dict()
    if model_type == "clip":
        n_v = model.config.vision_config.num_hidden_layers
        n_t = model.config.text_config.num_hidden_layers
        return convert_clip_vision(sd, n_v), convert_clip_text(sd, n_t)
    if model_type == "siglip":
        n_v = model.config.vision_config.num_hidden_layers
        n_t = model.config.text_config.num_hidden_layers
        return convert_siglip_vision(sd, n_v), convert_siglip_text(sd, n_t)
    if model_type == "align":
        return convert_align_model(model)
    raise ValueError(f"Unsupported model type: {model_type}")


def save_params_npz(path: str, vision_params: dict, text_params: dict):
    """Flatten and save converted tower params to a single .npz (vision.* then
    text.*, each in the tree's order, as novic_tpu writes it)."""
    flat = {}
    for name, tree in (("vision", vision_params), ("text", text_params)):
        for k, v in flatten_dict(tree).items():
            flat[f"{name}.{k}"] = v
    np.savez(path, **flat)


def load_params_npz(path: str) -> tuple[dict, dict]:
    """→ (vision param tree, text param tree) of numpy arrays."""
    with np.load(path) as data:
        flat_v = {k[len("vision."):]: data[k] for k in data.files if k.startswith("vision.")}
        flat_t = {k[len("text."):]: data[k] for k in data.files if k.startswith("text.")}
    return unflatten_dict(flat_v), unflatten_dict(flat_t)


# ---------------------------------------------------------------------------
# open_clip-format state dicts (the released backbones, timm SigLIP and DFN5B,
# ship open_clip_pytorch_model.bin with open_clip naming, not HF naming)
# ---------------------------------------------------------------------------


def _openclip_block(sd: dict, prefix: str) -> dict:
    """open_clip ResidualAttentionBlock → TowerBlock params (packed qkv split)."""
    in_w = _np(sd[f"{prefix}.attn.in_proj_weight"])
    in_b = _np(sd[f"{prefix}.attn.in_proj_bias"])
    E = in_w.shape[1]
    return {
        "norm1_weight": _np(sd[f"{prefix}.ln_1.weight"]),
        "norm1_bias": _np(sd[f"{prefix}.ln_1.bias"]),
        "norm2_weight": _np(sd[f"{prefix}.ln_2.weight"]),
        "norm2_bias": _np(sd[f"{prefix}.ln_2.bias"]),
        "fc1_weight": _np(sd[f"{prefix}.mlp.c_fc.weight"]),
        "fc1_bias": _np(sd[f"{prefix}.mlp.c_fc.bias"]),
        "fc2_weight": _np(sd[f"{prefix}.mlp.c_proj.weight"]),
        "fc2_bias": _np(sd[f"{prefix}.mlp.c_proj.bias"]),
        "attn": {
            "q_proj_weight": in_w[:E], "q_proj_bias": in_b[:E],
            "k_proj_weight": in_w[E:2 * E], "k_proj_bias": in_b[E:2 * E],
            "v_proj_weight": in_w[2 * E:], "v_proj_bias": in_b[2 * E:],
            "out_proj_weight": _np(sd[f"{prefix}.attn.out_proj.weight"]),
            "out_proj_bias": _np(sd[f"{prefix}.attn.out_proj.bias"]),
        },
    }


def convert_openclip_clip_vision(state_dict: dict, num_layers: int, pre_ln: bool = True) -> dict:
    """open_clip CLIP visual tower (visual.*) → VisionTransformer params;
    without `pre_ln` the tower has no ln_pre (CLIPA's no_ln_pre).

    Note: open_clip applies the projection as ``pooled @ proj`` with proj of
    shape (width, embed_dim); our proj_weight is torch-layout (out, in), so
    proj_weight = proj.T.
    """
    sd = state_dict
    conv_w = _np(sd["visual.conv1.weight"])  # (E,3,P,P)
    E = conv_w.shape[0]
    params = {
        "patch_weight": conv_w.transpose(0, 2, 3, 1).reshape(E, -1),
        "class_embedding": _np(sd["visual.class_embedding"]).reshape(-1),
        "pos_embedding": _np(sd["visual.positional_embedding"]),
    }
    if pre_ln:
        params["pre_ln_weight"] = _np(sd["visual.ln_pre.weight"])
        params["pre_ln_bias"] = _np(sd["visual.ln_pre.bias"])
    params.update({
        "post_ln_weight": _np(sd["visual.ln_post.weight"]),
        "post_ln_bias": _np(sd["visual.ln_post.bias"]),
        "proj_weight": _np(sd["visual.proj"]).T,
    })
    for i in range(num_layers):
        params[f"blocks_{i}"] = _openclip_block(sd, f"visual.transformer.resblocks.{i}")
    return params


def convert_openclip_clip_text(state_dict: dict, num_layers: int) -> dict:
    sd = state_dict
    params = {
        "token_embedding": _np(sd["token_embedding.weight"]),
        "pos_embedding": _np(sd["positional_embedding"]),
        "final_ln_weight": _np(sd["ln_final.weight"]),
        "final_ln_bias": _np(sd["ln_final.bias"]),
        "proj_weight": _np(sd["text_projection"]).T,
    }
    for i in range(num_layers):
        params[f"blocks_{i}"] = _openclip_block(sd, f"transformer.resblocks.{i}")
    return params


def _timm_block(sd: dict, prefix: str) -> dict:
    """timm ViT block (used by open_clip SigLIP visual trunks) → TowerBlock."""
    qkv_w = _np(sd[f"{prefix}.attn.qkv.weight"])
    qkv_b = _np(sd[f"{prefix}.attn.qkv.bias"])
    E = qkv_w.shape[1]
    return {
        "norm1_weight": _np(sd[f"{prefix}.norm1.weight"]),
        "norm1_bias": _np(sd[f"{prefix}.norm1.bias"]),
        "norm2_weight": _np(sd[f"{prefix}.norm2.weight"]),
        "norm2_bias": _np(sd[f"{prefix}.norm2.bias"]),
        "fc1_weight": _np(sd[f"{prefix}.mlp.fc1.weight"]),
        "fc1_bias": _np(sd[f"{prefix}.mlp.fc1.bias"]),
        "fc2_weight": _np(sd[f"{prefix}.mlp.fc2.weight"]),
        "fc2_bias": _np(sd[f"{prefix}.mlp.fc2.bias"]),
        "attn": {
            "q_proj_weight": qkv_w[:E], "q_proj_bias": qkv_b[:E],
            "k_proj_weight": qkv_w[E:2 * E], "k_proj_bias": qkv_b[E:2 * E],
            "v_proj_weight": qkv_w[2 * E:], "v_proj_bias": qkv_b[2 * E:],
            "out_proj_weight": _np(sd[f"{prefix}.attn.proj.weight"]),
            "out_proj_bias": _np(sd[f"{prefix}.attn.proj.bias"]),
        },
    }


def convert_openclip_siglip_vision(state_dict: dict, num_layers: int) -> dict:
    """open_clip timm-SigLIP visual trunk (visual.trunk.*) → VisionTransformer
    params. The timm MAP head (attn_pool.latent/q/kv/proj/norm/mlp) maps onto
    our map_* params with the packed kv split."""
    sd = state_dict
    t = "visual.trunk"
    conv_w = _np(sd[f"{t}.patch_embed.proj.weight"])
    E = conv_w.shape[0]
    q_w = _np(sd[f"{t}.attn_pool.q.weight"])
    q_b = _np(sd[f"{t}.attn_pool.q.bias"])
    kv_w = _np(sd[f"{t}.attn_pool.kv.weight"])
    kv_b = _np(sd[f"{t}.attn_pool.kv.bias"])
    params = {
        "patch_weight": conv_w.transpose(0, 2, 3, 1).reshape(E, -1),
        "patch_bias": _np(sd[f"{t}.patch_embed.proj.bias"]),
        "pos_embedding": _np(sd[f"{t}.pos_embed"]).reshape(-1, E),
        "post_ln_weight": _np(sd[f"{t}.norm.weight"]),
        "post_ln_bias": _np(sd[f"{t}.norm.bias"]),
        "map_probe": _np(sd[f"{t}.attn_pool.latent"]).reshape(1, 1, E),
        "map_attn": {
            "q_proj_weight": q_w, "q_proj_bias": q_b,
            "k_proj_weight": kv_w[:E], "k_proj_bias": kv_b[:E],
            "v_proj_weight": kv_w[E:], "v_proj_bias": kv_b[E:],
            "out_proj_weight": _np(sd[f"{t}.attn_pool.proj.weight"]),
            "out_proj_bias": _np(sd[f"{t}.attn_pool.proj.bias"]),
        },
        "map_ln_weight": _np(sd[f"{t}.attn_pool.norm.weight"]),
        "map_ln_bias": _np(sd[f"{t}.attn_pool.norm.bias"]),
        "map_fc1_weight": _np(sd[f"{t}.attn_pool.mlp.fc1.weight"]),
        "map_fc1_bias": _np(sd[f"{t}.attn_pool.mlp.fc1.bias"]),
        "map_fc2_weight": _np(sd[f"{t}.attn_pool.mlp.fc2.weight"]),
        "map_fc2_bias": _np(sd[f"{t}.attn_pool.mlp.fc2.bias"]),
    }
    for i in range(num_layers):
        params[f"blocks_{i}"] = _timm_block(sd, f"{t}.blocks.{i}")
    return params


def convert_openclip_clipa_vision(state_dict: dict, num_layers: int) -> dict:
    """open_clip CLIPA visual tower → VisionTransformer(pool='avg') params: the
    stock CLIP naming without ln_pre (its avg pool and final LN after the pool
    are forward-pass differences only)."""
    return convert_openclip_clip_vision(state_dict, num_layers, pre_ln=False)


def convert_openclip_state_dict(state_dict: dict, family: str,
                                num_vision_layers: int, num_text_layers: int,
                                vision_cfg=None) -> tuple[dict, dict]:
    """Full open_clip checkpoint → (vision_params, text_params). `vision_cfg`
    (the registry's EvaVisionConfig) is required for family='eva02': its block
    flags select which checkpoint keys must exist."""
    if family == "eva02":
        if vision_cfg is None:
            raise ValueError("family='eva02' conversion needs vision_cfg "
                             "(the EvaVisionConfig from the registry)")
        return (convert_openclip_eva_vision(state_dict, vision_cfg),
                convert_openclip_clip_text(state_dict, num_text_layers))
    if family == "clip":
        return (convert_openclip_clip_vision(state_dict, num_vision_layers),
                convert_openclip_clip_text(state_dict, num_text_layers))
    if family == "clipa":
        # CLIPA's text tower has the stock open_clip naming (its non-causal
        # mask and last-token pool are forward-pass differences only)
        return (convert_openclip_clipa_vision(state_dict, num_vision_layers),
                convert_openclip_clip_text(state_dict, num_text_layers))
    if family == "siglip":
        vision = convert_openclip_siglip_vision(state_dict, num_vision_layers)
        # open_clip SigLIP text towers use HF naming under text.*
        text_sd = {k[len("text."):]: v for k, v in state_dict.items()
                   if k.startswith("text.")}
        text = convert_siglip_text({f"text_model.{k}": v for k, v in text_sd.items()}
                                   if not any(k.startswith("text_model.") for k in text_sd)
                                   else text_sd, num_text_layers)
        return vision, text
    raise ValueError(f"Unsupported open_clip family: {family}")


# ---------------------------------------------------------------------------
# ALIGN (EfficientNet-B7 + BERT; HF AlignModel). BatchNorms are folded into
# per-channel (scale, bias): the towers are frozen (embedders/align.py).
# ---------------------------------------------------------------------------


def _bn_fold(sd: dict, prefix: str, eps: float) -> tuple[np.ndarray, np.ndarray]:
    gamma = _np(sd[f"{prefix}.weight"]).astype(np.float64)
    beta = _np(sd[f"{prefix}.bias"]).astype(np.float64)
    mean = _np(sd[f"{prefix}.running_mean"]).astype(np.float64)
    var = _np(sd[f"{prefix}.running_var"]).astype(np.float64)
    scale = gamma / np.sqrt(var + eps)
    bias = beta - mean * scale
    return scale.astype(np.float32), bias.astype(np.float32)


def _conv_hwio(t) -> np.ndarray:
    """torch conv weight (O, I, kh, kw) → HWIO (kh, kw, I, O); a depthwise
    (C, 1, k, k) becomes (k, k, 1, C)."""
    return _np(t).transpose(2, 3, 1, 0)


def convert_align_vision(state_dict: dict, cfg, eps: float = 1e-3) -> dict:
    """HF AlignVisionModel state dict (vision_model.*) → EfficientNetTower
    params over align_block_plan(cfg); `eps` is HF's batch_norm_eps."""
    from novic_tpu_torch.embedders.align import align_block_plan

    sd = state_dict
    s, b = _bn_fold(sd, "vision_model.embeddings.batchnorm", eps)
    params: dict[str, Any] = {
        "stem_conv_weight": _conv_hwio(sd["vision_model.embeddings.convolution.weight"]),
        "stem_bn_scale": s, "stem_bn_bias": b,
    }
    for i, plan in enumerate(align_block_plan(cfg)):
        pfx = f"vision_model.encoder.blocks.{i}"
        blk: dict[str, Any] = {}
        if plan.expand_ratio != 1:
            blk["expand_conv_weight"] = _conv_hwio(sd[f"{pfx}.expansion.expand_conv.weight"])
            blk["expand_bn_scale"], blk["expand_bn_bias"] = _bn_fold(
                sd, f"{pfx}.expansion.expand_bn", eps)
        blk["dw_conv_weight"] = _conv_hwio(sd[f"{pfx}.depthwise_conv.depthwise_conv.weight"])
        blk["dw_bn_scale"], blk["dw_bn_bias"] = _bn_fold(
            sd, f"{pfx}.depthwise_conv.depthwise_norm", eps)
        # The SE 1x1 convs (O, I, 1, 1) as dense (O, I)
        blk["se_reduce_weight"] = _np(sd[f"{pfx}.squeeze_excite.reduce.weight"])[:, :, 0, 0]
        blk["se_reduce_bias"] = _np(sd[f"{pfx}.squeeze_excite.reduce.bias"])
        blk["se_expand_weight"] = _np(sd[f"{pfx}.squeeze_excite.expand.weight"])[:, :, 0, 0]
        blk["se_expand_bias"] = _np(sd[f"{pfx}.squeeze_excite.expand.bias"])
        blk["project_conv_weight"] = _conv_hwio(sd[f"{pfx}.projection.project_conv.weight"])
        blk["project_bn_scale"], blk["project_bn_bias"] = _bn_fold(
            sd, f"{pfx}.projection.project_bn", eps)
        params[f"block_{i}"] = blk
    return params


def convert_align_text(state_dict: dict, num_layers: int) -> dict:
    """HF AlignTextModel (text_model.*) + text_projection → BertTextTower params."""
    sd = state_dict
    e = "text_model.embeddings"
    params: dict[str, Any] = {
        "word_embedding": _np(sd[f"{e}.word_embeddings.weight"]),
        "pos_embedding": _np(sd[f"{e}.position_embeddings.weight"]),
        "type_embedding": _np(sd[f"{e}.token_type_embeddings.weight"]),
        "emb_ln_weight": _np(sd[f"{e}.LayerNorm.weight"]),
        "emb_ln_bias": _np(sd[f"{e}.LayerNorm.bias"]),
        "proj_weight": _np(sd["text_projection.weight"]),
        "proj_bias": _np(sd["text_projection.bias"]),
    }
    names = {"q": "attention.self.query", "k": "attention.self.key",
             "v": "attention.self.value", "attn_out": "attention.output.dense",
             "attn_ln": "attention.output.LayerNorm", "fc1": "intermediate.dense",
             "fc2": "output.dense", "out_ln": "output.LayerNorm"}
    for i in range(num_layers):
        for ours, hf in names.items():
            for leaf in ("weight", "bias"):
                params[f"layers_{i}_{ours}_{leaf}"] = _np(
                    sd[f"text_model.encoder.layer.{i}.{hf}.{leaf}"])
    return params


def align_cfg_from_hf(hf_vision_config):
    """HF AlignVisionConfig → the port's AlignVisionConfig (the same field
    values, and the embed_dim its trunk gives)."""
    from novic_tpu_torch.embedders.align import AlignVisionConfig

    v = hf_vision_config
    cfg = AlignVisionConfig(
        width_coefficient=v.width_coefficient, depth_coefficient=v.depth_coefficient,
        depth_divisor=v.depth_divisor, kernel_sizes=tuple(v.kernel_sizes),
        in_channels=tuple(v.in_channels), out_channels=tuple(v.out_channels),
        strides=tuple(v.strides), num_block_repeats=tuple(v.num_block_repeats),
        expand_ratios=tuple(v.expand_ratios),
        depthwise_padding=tuple(v.depthwise_padding),
        squeeze_expansion_ratio=v.squeeze_expansion_ratio)
    return dataclasses.replace(cfg, embed_dim=cfg.round_filters(cfg.out_channels[-1]))


def convert_align_model(model) -> tuple[dict, dict]:
    """Full HF AlignModel → (vision_params, text_params)."""
    sd = model.state_dict()
    cfg = align_cfg_from_hf(model.config.vision_config)
    vision = convert_align_vision(sd, cfg, eps=model.config.vision_config.batch_norm_eps)
    return vision, convert_align_text(sd, model.config.text_config.num_hidden_layers)


# ---------------------------------------------------------------------------
# EVA02 (open_clip delegates the trunk to timm's Eva class: visual.trunk.*;
# the text towers have the stock open_clip CLIP naming). A missing key raises
# KeyError for every fact the checkpoint's keys show (SwiGLU or plain MLP,
# sub-LN, fused or split qkv, layer count, projection naming).
# ---------------------------------------------------------------------------


def convert_openclip_eva_vision(state_dict: dict, cfg) -> dict:
    """open_clip EVA02 visual trunk → EvaVisionTransformer params. `cfg` is the
    EvaVisionConfig (its block flags select which keys must exist)."""
    sd = state_dict
    t = "visual.trunk"
    conv_w = _np(sd[f"{t}.patch_embed.proj.weight"])
    E = conv_w.shape[0]
    params: dict[str, Any] = {
        "patch_weight": conv_w.transpose(0, 2, 3, 1).reshape(E, -1),
        "patch_bias": _np(sd[f"{t}.patch_embed.proj.bias"]),
        "class_embedding": _np(sd[f"{t}.cls_token"]).reshape(-1),
        "pos_embedding": _np(sd[f"{t}.pos_embed"]).reshape(-1, E),
        "final_norm_weight": _np(sd[f"{t}.norm.weight"]),
        "final_norm_bias": _np(sd[f"{t}.norm.bias"]),
    }
    # The projection to the joint space: timm's head (a trunk made with
    # num_classes=embed_dim) or open_clip's own linear head, by its config's
    # timm_proj; a missing bias is zero
    for head in (f"{t}.head", "visual.head.proj"):
        if f"{head}.weight" in sd:
            params["head_weight"] = _np(sd[f"{head}.weight"])
            params["head_bias"] = (_np(sd[f"{head}.bias"]) if f"{head}.bias" in sd
                                   else np.zeros(params["head_weight"].shape[0], np.float32))
            break
    else:
        raise KeyError("EVA02 checkpoint has neither visual.trunk.head.* nor "
                       "visual.head.proj.* — unknown projection naming")
    for i in range(cfg.layers):
        p = f"{t}.blocks.{i}"
        blk: dict[str, Any] = {
            "norm1_weight": _np(sd[f"{p}.norm1.weight"]),
            "norm1_bias": _np(sd[f"{p}.norm1.bias"]),
            "norm2_weight": _np(sd[f"{p}.norm2.weight"]),
            "norm2_bias": _np(sd[f"{p}.norm2.bias"]),
            "out_proj_weight": _np(sd[f"{p}.attn.proj.weight"]),
            "out_proj_bias": _np(sd[f"{p}.attn.proj.bias"]),
            "fc2_weight": _np(sd[f"{p}.mlp.fc2.weight"]),
            "fc2_bias": _np(sd[f"{p}.mlp.fc2.bias"]),
        }
        if cfg.qkv_fused:
            # One fused (3E, E) qkv weight with separate q and v biases (timm's
            # k bias is a fixed zero): split row-wise
            wqkv = _np(sd[f"{p}.attn.qkv.weight"])
            E = wqkv.shape[1]
            blk["q_proj_weight"] = wqkv[:E]
            blk["k_proj_weight"] = wqkv[E:2 * E]
            blk["v_proj_weight"] = wqkv[2 * E:]
            blk["q_proj_bias"] = _np(sd[f"{p}.attn.q_bias"])
            blk["v_proj_bias"] = _np(sd[f"{p}.attn.v_bias"])
        else:
            blk["q_proj_weight"] = _np(sd[f"{p}.attn.q_proj.weight"])
            blk["q_proj_bias"] = _np(sd[f"{p}.attn.q_proj.bias"])
            blk["k_proj_weight"] = _np(sd[f"{p}.attn.k_proj.weight"])
            blk["v_proj_weight"] = _np(sd[f"{p}.attn.v_proj.weight"])
            blk["v_proj_bias"] = _np(sd[f"{p}.attn.v_proj.bias"])
        if cfg.inner_attn_norm:
            blk["attn_norm_weight"] = _np(sd[f"{p}.attn.norm.weight"])
            blk["attn_norm_bias"] = _np(sd[f"{p}.attn.norm.bias"])
        if cfg.swiglu:
            blk["fc1_g_weight"] = _np(sd[f"{p}.mlp.fc1_g.weight"])
            blk["fc1_g_bias"] = _np(sd[f"{p}.mlp.fc1_g.bias"])
            blk["fc1_x_weight"] = _np(sd[f"{p}.mlp.fc1_x.weight"])
            blk["fc1_x_bias"] = _np(sd[f"{p}.mlp.fc1_x.bias"])
            blk["mlp_norm_weight"] = _np(sd[f"{p}.mlp.norm.weight"])
            blk["mlp_norm_bias"] = _np(sd[f"{p}.mlp.norm.bias"])
        else:
            blk["fc1_weight"] = _np(sd[f"{p}.mlp.fc1.weight"])
            blk["fc1_bias"] = _np(sd[f"{p}.mlp.fc1.bias"])
        params[f"blocks_{i}"] = blk
    return params
