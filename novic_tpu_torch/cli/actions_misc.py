"""action=convert_embedder (the counterpart of
novic_tpu.cli.actions_misc.action_convert_embedder): CLIP/SigLIP backbone
weights → the .npz tower weights that `embedder_weights=` and the infer CLI's
`--weights` read, in the JAX package's layout.

Two input modes:
* load_model=<open_clip_pytorch_model.bin / .pt>: a local open_clip-format
  state dict (how the released timm-SigLIP and DFN5B backbones ship), read
  with PyTorch's restricted unpickler and mapped by the spec's family;
* otherwise `transformers.AutoModel.from_pretrained` of the spec's model id
  or local HF directory (HF CLIPModel / SiglipModel).

The other misc actions of novic_tpu are not ported (cli/train.py NOT_PORTED).
"""

from __future__ import annotations

import os

import torch

from novic_tpu_torch.cli.common import resolve_path
from novic_tpu_torch.device import resolve
from novic_tpu_torch.embedders.convert import (
    convert_hf_model,
    convert_openclip_state_dict,
    save_params_npz,
)
from novic_tpu_torch.embedders.registry import lookup
from novic_tpu_torch.utils.logger import log


def action_convert_embedder(cfg, device="cuda"):
    """Convert the spec's weights to embedder_weights (.npz). The conversion runs
    on the host; `device` is resolved as every action's is."""
    resolve(device)
    spec = cfg.embedder
    if ":" not in spec:
        raise ValueError(f"Invalid embedder spec: {spec}")
    out_path = resolve_path(cfg, cfg.embedder_weights)
    if not out_path:
        raise ValueError("convert_embedder requires embedder_weights (output .npz path)")
    arch = lookup(spec)  # what cannot be looked up cannot serve: raises first

    if cfg.load_model:
        src = resolve_path(cfg, cfg.load_model)
        sd = torch.load(src, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        v, t = convert_openclip_state_dict(sd, arch.family, arch.vision.layers, arch.text.layers)
    else:
        try:
            import transformers
        except ImportError as e:
            raise ImportError("convert_embedder without load_model= converts a transformers "
                              "model, and transformers is not installed; pass load_model=<an "
                              "open_clip state dict> instead") from e
        _, src = spec.split(":", 1)
        model = transformers.AutoModel.from_pretrained(src, local_files_only=os.path.isdir(src))
        if arch.family not in type(model).__name__.lower():
            raise ValueError(f"{src} holds a {type(model).__name__}, not a {arch.family} model")
        v, t = convert_hf_model(model, arch.family)
    save_params_npz(out_path, v, t)
    log.info(f"Converted {src} → {out_path}")
    return out_path
