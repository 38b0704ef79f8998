"""HF and open_clip CLIP/SigLIP state dicts → the port's tower param trees (the
counterpart of novic_tpu.embedders.convert).

The output is the JAX package's numpy tree, under the same names, and
save_params_npz writes the JAX package's .npz layout (the same keys, in the
same order), so a file written by either package loads in the other;
load_params_npz and bridge.vision_tower_from_numpy / text_tower_from_numpy
serve it. Conversion runs on the host and never touches the device.

The CLIPA, EVA02 and ALIGN maps are not ported: their towers are not
(ROADMAP Queue 1 item 7), and their families raise NotImplementedError.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from novic_tpu_torch.utils.misc import flatten_dict, unflatten_dict

_TOWERS_NOT_PORTED = ("Its towers are not ported to novic_tpu_torch yet (ROADMAP Queue 1 "
                      "item 7: other tower families)")
NOT_PORTED_FAMILIES = {
    "clipa": "open_clip CLIPA conversion is not ported. " + _TOWERS_NOT_PORTED,
    "eva02": "open_clip EVA02 conversion is not ported. " + _TOWERS_NOT_PORTED,
    "align": "HF ALIGN conversion is not ported. " + _TOWERS_NOT_PORTED,
}


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
    if model_type in NOT_PORTED_FAMILIES:
        raise NotImplementedError(NOT_PORTED_FAMILIES[model_type])
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


def convert_openclip_clip_vision(state_dict: dict, num_layers: int) -> dict:
    """open_clip CLIP visual tower (visual.*) → VisionTransformer params.

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
        "pre_ln_weight": _np(sd["visual.ln_pre.weight"]),
        "pre_ln_bias": _np(sd["visual.ln_pre.bias"]),
        "post_ln_weight": _np(sd["visual.ln_post.weight"]),
        "post_ln_bias": _np(sd["visual.ln_post.bias"]),
        "proj_weight": _np(sd["visual.proj"]).T,
    }
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


def convert_openclip_state_dict(state_dict: dict, family: str,
                                num_vision_layers: int, num_text_layers: int,
                                vision_cfg=None) -> tuple[dict, dict]:
    """Full open_clip checkpoint → (vision_params, text_params) for the
    families 'clip' (DFN5B-H-14-378 among them) and 'siglip'. `vision_cfg` is
    taken for the JAX package's signature; the ported families need none."""
    if family in NOT_PORTED_FAMILIES:
        raise NotImplementedError(NOT_PORTED_FAMILIES[family])
    if family == "clip":
        return (convert_openclip_clip_vision(state_dict, num_vision_layers),
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
