"""CLIP ViT (Radford et al., "Learning Transferable Visual Models From
Natural Language Supervision", 2021; open_clip's VisionTransformer, as in
Apple's DFN5B-CLIP-ViT-H-14-378): patch embedding without a bias, a class
token prepended, learned positions over the class token and the patches, a
norm before the blocks (`ln_pre`), pre-LN blocks with q/k/v/out biases and a
GELU MLP, then the class token's final norm (`ln_post`) and a projection
without a bias.

The activation is the exact GELU, as the program's registry states it for
the DFN5B specs. This departs from the source: open_clip registers the
`dfn5b` weights under the model name `ViT-H-14-378-quickgelu`, whose MLP
runs QuickGELU, x * sigmoid(1.702 x). The benchmark runs what the program
runs for the spec (`stated` holds the program to `act`), and the reference
follows it, so the departure is one of the registry, recorded, not of the
comparison.

A tower family of the benchmark (see reference/towers.py), found by its
config's `"family": "clip"`. Imports torch and the reference's helpers
only: nothing of the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.towers import _attend, _Dense, _ln, _patches

# The control: the program's own int8 tower path
CONTROL = "int8"

_ACTS = {"gelu": F.gelu, "quick_gelu": lambda t: t * torch.sigmoid(1.702 * t)}


def stated(c: dict) -> dict:
    """Registry fields, beyond the shared ones, the program must run as stated."""
    return {"mlp_ratio": c["mlp_dim"] / c["width"], "act": c["act"], "pool": c["pool"],
            "use_class_token": c["use_class_token"], "pre_ln": c["pre_ln"],
            "patch_bias": c["patch_bias"], "proj_bias": c["proj_bias"]}


def shapes(c: dict) -> dict[str, tuple]:
    E, P, M, G = c["width"], c["patch_size"], c["mlp_dim"], c["image_size"] // c["patch_size"]
    s = {"patch_weight": (E, P * P * 3), "class_embedding": (E,),
         "pos_embedding": (G * G + 1, E), "pre_ln_weight": (E,), "pre_ln_bias": (E,)}
    for i in range(c["layers"]):
        b = f"blocks_{i}."
        s.update({b + "norm1_weight": (E,), b + "norm1_bias": (E,), b + "norm2_weight": (E,),
                  b + "norm2_bias": (E,), b + "fc1_weight": (M, E), b + "fc1_bias": (M,),
                  b + "fc2_weight": (E, M), b + "fc2_bias": (E,)})
        for n in ("q", "k", "v", "out"):
            s[f"{b}attn.{n}_proj_weight"], s[f"{b}attn.{n}_proj_bias"] = (E, E), (E,)
    s.update({"post_ln_weight": (E,), "post_ln_bias": (E,), "proj_weight": (c["embed_dim"], E)})
    return s


def tokens(c: dict) -> int:
    g = c["image_size"] // c["patch_size"]
    return g * g + 1


def flops(c: dict) -> int:
    """FLOP of one image (every product; the attention's two S x S x hd
    products per head; the class token's projection)."""
    E, M, P, L = c["width"], c["mlp_dim"], c["patch_size"], c["layers"]
    S = tokens(c)
    patch = 2 * (S - 1) * P * P * 3 * E
    block = 2 * 4 * S * E * E + 2 * 2 * S * S * E + 2 * 2 * S * E * M
    return patch + L * block + 2 * E * c["embed_dim"]


def forward(p: dict, c: dict, x, fp8: bool = False):
    d, eps, H = _Dense(fp8), c["layer_norm_eps"], c["heads"]
    act = _ACTS[c["act"]]
    x = d(_patches(x, c["patch_size"]), p["patch_weight"])
    x = torch.cat([p["class_embedding"].expand(x.shape[0], 1, -1), x], dim=1) + p["pos_embedding"]
    x = _ln(x, p["pre_ln_weight"], p["pre_ln_bias"], eps)
    for i in range(c["layers"]):
        b = f"blocks_{i}."
        h = _ln(x, p[b + "norm1_weight"], p[b + "norm1_bias"], eps)
        q, k, v = (d(h, p[f"{b}attn.{n}_proj_weight"], p[f"{b}attn.{n}_proj_bias"])
                   for n in ("q", "k", "v"))
        x = x + d(_attend(q, k, v, H), p[b + "attn.out_proj_weight"], p[b + "attn.out_proj_bias"])
        h = _ln(x, p[b + "norm2_weight"], p[b + "norm2_bias"], eps)
        x = x + d(act(d(h, p[b + "fc1_weight"], p[b + "fc1_bias"])), p[b + "fc2_weight"],
                  p[b + "fc2_bias"])
    pooled = _ln(x[:, 0], p["post_ln_weight"], p["post_ln_bias"], eps)
    return d(pooled, p["proj_weight"])
