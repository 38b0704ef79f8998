"""Miscellaneous actions (the counterpart of novic_tpu.cli.actions_misc):
wiki image collection, image sampling, embedder weight conversion.

collect_wiki_images (reference train.py:3343-3505): Wikipedia API search and
download with retry/backoff and resizing to at most 0.8 MP; it needs the
network. sample_images (ref train.py:3512-3576): random or zero-shot-weighted
multinomial sampling of images from a directory, the towers on `device`.

action=convert_embedder: backbone weights of any tower family → the .npz
tower weights that `embedder_weights=` and the infer CLI's `--weights` read,
in the JAX package's layout.

Two input modes:
* load_model=<open_clip_pytorch_model.bin / .pt>: a local open_clip-format
  state dict (how the released timm-SigLIP, DFN5B, CLIPA and EVA02 backbones
  ship), read with PyTorch's restricted unpickler and mapped by the spec's
  family;
* otherwise `transformers.AutoModel.from_pretrained` of the spec's model id
  or local HF directory (HF CLIPModel / SiglipModel / AlignModel).
"""

from __future__ import annotations

import json
import os
import random
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from novic_tpu_torch.cli.actions_eval import compute_text_embeddings
from novic_tpu_torch.cli.common import load_embedder, load_noun_dataset, resolve_path
from novic_tpu_torch.data.classification import load_image_dataset_prompts
from novic_tpu_torch.device import resolve
from novic_tpu_torch.embedders.convert import (
    convert_hf_model,
    convert_openclip_state_dict,
    save_params_npz,
)
from novic_tpu_torch.embedders.preprocess import load_images
from novic_tpu_torch.embedders.registry import lookup
from novic_tpu_torch.utils.logger import log

WIKI_API = "https://en.wikipedia.org/w/api.php"


def action_collect_wiki_images(cfg, device="cuda"):
    """Per target noun: Wikipedia page search, image download with size filters,
    resize to ≤0.8MP, exponential-backoff retries (ref train.py:3343-3505).
    Host work only (no tower runs); `device` is resolved as every action's is."""
    import urllib.error
    import urllib.parse
    import urllib.request

    import PIL.Image

    dev = resolve(device)
    out_dir = resolve_path(cfg, cfg.wiki_output_dir)
    if not out_dir:
        raise ValueError("collect_wiki_images requires wiki_output_dir")
    os.makedirs(out_dir, exist_ok=True)
    embedder = load_embedder(cfg, load_model=False, device=dev)
    dataset = load_noun_dataset(cfg, embedder, use_cache=False)

    def api_get(params: dict, retries: int = 5) -> Optional[dict]:
        params = dict(params, format="json")
        url = f"{WIKI_API}?{urllib.parse.urlencode(params)}"
        delay = 1.0
        for attempt in range(retries):
            try:
                req = urllib.request.Request(url, headers={"User-Agent": "novic_tpu/0.1"})
                with urllib.request.urlopen(req, timeout=30) as resp:
                    return json.loads(resp.read().decode())
            except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
                log.warning(f"Wikipedia API error (attempt {attempt + 1}): {e}")
                time.sleep(delay)
                delay *= 2
        return None

    collected = 0
    for noun in dataset.target_nouns:
        search = api_get({"action": "query", "list": "search", "srsearch": noun, "srlimit": 1})
        if not search or not search.get("query", {}).get("search"):
            continue
        title = search["query"]["search"][0]["title"]
        images = api_get({"action": "query", "titles": title, "prop": "images",
                          "imlimit": cfg.wiki_image_limit})
        if not images:
            continue
        pages = images.get("query", {}).get("pages", {})
        image_titles = [im["title"] for page in pages.values()
                        for im in page.get("images", [])
                        if im["title"].lower().endswith((".jpg", ".jpeg", ".png"))]
        for im_title in image_titles[: cfg.wiki_image_limit]:
            info = api_get({"action": "query", "titles": im_title, "prop": "imageinfo",
                            "iiprop": "url|size"})
            if not info:
                continue
            for page in info.get("query", {}).get("pages", {}).values():
                for ii in page.get("imageinfo", []):
                    w, h = ii.get("width", 0), ii.get("height", 0)
                    if w * h < 100 * 100:  # size filter
                        continue
                    url = ii["url"]
                    fname = f"{noun.replace(' ', '_')}_{os.path.basename(url)}"
                    dest = os.path.join(out_dir, fname)
                    if os.path.exists(dest):
                        continue
                    try:
                        req = urllib.request.Request(url, headers={"User-Agent": "novic_tpu/0.1"})
                        with urllib.request.urlopen(req, timeout=60) as resp, open(dest, "wb") as f:
                            shutil.copyfileobj(resp, f)
                        img = PIL.Image.open(dest).convert("RGB")
                        if img.width * img.height > 800_000:  # resize to <=0.8MP
                            scale = (800_000 / (img.width * img.height)) ** 0.5
                            img = img.resize((int(img.width * scale), int(img.height * scale)),
                                             PIL.Image.Resampling.BICUBIC)
                            img.save(dest)
                        collected += 1
                    except Exception as e:  # noqa: BLE001 — one failed download skips that file
                        log.warning(f"Failed to download {url}: {e}")
                        if os.path.exists(dest):
                            os.remove(dest)
    log.info(f"Collected {collected} wiki images into {out_dir}")


def action_sample_images(cfg, device="cuda"):
    """Random or special-noun zero-shot-weighted image sampling: with
    sample_special set, each image is weighted exp(sum_j factor_j *
    max(logit_j - mean, 0)) over the special nouns' ImageNet1K-CLIP prompt
    ensembles, then sampled multinomially without replacement into a
    timestamped subdirectory of sample_output_dir (ref train.py:3512-3576).
    The towers run on `device`."""
    dev = resolve(device)
    src = resolve_path(cfg, cfg.sample_input_dir)
    if not src:
        raise ValueError("Set sample_input_dir to the directory of input images")
    out_parent = resolve_path(cfg, cfg.sample_output_dir)
    if not out_parent:
        raise ValueError("Need to specify an output image directory using sample_output_dir")
    files = sorted(f for f in os.listdir(src)
                   if f.lower().endswith((".jpg", ".jpeg", ".png", ".webp",
                                          ".bmp", ".gif", ".tiff")))
    if not files:
        raise ValueError(f"No images found in {src}")
    n = min(cfg.sample_count, len(files))
    os.makedirs(out_parent, exist_ok=True)
    out = tempfile.mkdtemp(prefix=f"sampled-{time.strftime('%Y%m%d_%H%M%S')}-", dir=out_parent)

    if not cfg.sample_special:
        rng = random.Random(cfg.seed)
        chosen = rng.sample(files, n)
    else:
        special = list(cfg.sample_special)
        factors = np.asarray(cfg.sample_special_factor, np.float32)
        if factors.shape != (len(special),):
            raise ValueError("The lists sample_special and sample_special_factor must have "
                             "the same lengths")
        embedder = load_embedder(cfg, load_model=True, device=dev)
        # ImageNet1K CLIP prompts are generally suitable for open-vocabulary
        # images (ref train.py:3538)
        prompts = load_image_dataset_prompts("imagenet1k", variant="clip")
        text_embeds = compute_text_embeddings(embedder, special, prompts)  # (J, F)
        transform = embedder.get_image_transform()
        weights = []
        B = cfg.batch_size_image
        for i in range(0, len(files), B):
            paths = [os.path.join(src, f) for f in files[i:i + B]]
            embeds = embedder.inference_image(transform(load_images(paths)))
            logits = embeds @ text_embeds.T  # (B, J)
            excess = np.clip(logits - cfg.sample_special_mean, 0.0, None)
            weights.extend(np.exp((excess * factors).sum(axis=1)).tolist())
        weights = np.asarray(weights)
        weights /= weights.sum()
        rng = np.random.default_rng(cfg.seed)
        chosen = [files[i] for i in rng.choice(len(files), size=n, replace=False, p=weights)]

    for f in chosen:
        shutil.copy2(os.path.join(src, f), os.path.join(out, f))
    log.info(f"Sampled {len(chosen)} images from {src} into {out}")
    return out, chosen


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
        if arch.family == "align":
            raise ValueError("ALIGN converts from a transformers AlignModel (its spec's id or "
                             "local HF directory), not from an open_clip state dict")
        src = resolve_path(cfg, cfg.load_model)
        sd = torch.load(src, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        v, t = convert_openclip_state_dict(sd, arch.family, arch.vision.layers, arch.text.layers,
                                           vision_cfg=arch.vision)
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
