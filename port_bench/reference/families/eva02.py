"""EVA02 (Fang et al., "EVA-02: A Visual Representation for Neon Genesis",
2023; timm's Eva trunk in open_clip): patch embedding with a bias, a class
token, learned positions, pre-LN blocks with q/k/v projections (no key
bias), 2-D rotary embedding on the patch tokens of q and k, a norm on the
attention output before its projection (sub-LN), a SwiGLU MLP with a norm
on its hidden state, then the class token's final norm and a linear head.

A tower family of the benchmark (see reference/towers.py), found by its
config's `"family": "eva02"`. Imports torch and the reference's helpers
only: nothing of the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.towers import _attend, _Dense, _ln, _patches, _rope, rope_table

# The control: this reference with float8 e4m3 operands (the program has no
# lower-precision path for this tower)
CONTROL = "fp8"


def stated(c: dict) -> dict:
    """Registry fields, beyond the shared ones, the program must run as stated."""
    return {"mlp_hidden": c["mlp_dim"], "ref_feat_shape": c["rope_ref_grid"]}


def shapes(c: dict) -> dict[str, tuple]:
    E, P, M, G = c["width"], c["patch_size"], c["mlp_dim"], c["image_size"] // c["patch_size"]
    s = {"patch_weight": (E, P * P * 3), "patch_bias": (E,), "class_embedding": (E,),
         "pos_embedding": (G * G + 1, E), "final_norm_weight": (E,), "final_norm_bias": (E,),
         "head_weight": (c["embed_dim"], E), "head_bias": (c["embed_dim"],)}
    for i in range(c["layers"]):
        b = f"blocks_{i}."
        s.update({b + "norm1_weight": (E,), b + "norm1_bias": (E,),
                  b + "q_proj_weight": (E, E), b + "q_proj_bias": (E,), b + "k_proj_weight": (E, E),
                  b + "v_proj_weight": (E, E), b + "v_proj_bias": (E,),
                  b + "attn_norm_weight": (E,), b + "attn_norm_bias": (E,),
                  b + "out_proj_weight": (E, E), b + "out_proj_bias": (E,),
                  b + "norm2_weight": (E,), b + "norm2_bias": (E,),
                  b + "fc1_g_weight": (M, E), b + "fc1_g_bias": (M,),
                  b + "fc1_x_weight": (M, E), b + "fc1_x_bias": (M,),
                  b + "mlp_norm_weight": (M,), b + "mlp_norm_bias": (M,),
                  b + "fc2_weight": (E, M), b + "fc2_bias": (E,)})
    return s


def tokens(c: dict) -> int:
    g = c["image_size"] // c["patch_size"]
    return g * g + 1


def flops(c: dict) -> int:
    """FLOP of one image (every product; the attention's two S x S x hd
    products per head; SwiGLU's three MLP products; the class token's head)."""
    E, M, P, L = c["width"], c["mlp_dim"], c["patch_size"], c["layers"]
    S = tokens(c)
    patch = 2 * (S - 1) * P * P * 3 * E
    block = 2 * 4 * S * E * E + 2 * 2 * S * S * E + 2 * 3 * S * E * M
    return patch + L * block + 2 * E * c["embed_dim"]


def forward(p: dict, c: dict, x, fp8: bool = False):
    d, eps, H = _Dense(fp8), c["layer_norm_eps"], c["heads"]
    G = c["image_size"] // c["patch_size"]
    table = rope_table(G, c["rope_ref_grid"], c["width"] // H, x.device)
    x = d(_patches(x, c["patch_size"]), p["patch_weight"], p["patch_bias"])
    x = torch.cat([p["class_embedding"].expand(x.shape[0], 1, -1), x], dim=1) + p["pos_embedding"]
    for i in range(c["layers"]):
        b = f"blocks_{i}."
        h = _ln(x, p[b + "norm1_weight"], p[b + "norm1_bias"], eps)
        q = d(h, p[b + "q_proj_weight"], p[b + "q_proj_bias"])
        k = d(h, p[b + "k_proj_weight"])
        v = d(h, p[b + "v_proj_weight"], p[b + "v_proj_bias"])
        q = torch.cat([q[:, :1], _rope(q[:, 1:], table, H)], dim=1)
        k = torch.cat([k[:, :1], _rope(k[:, 1:], table, H)], dim=1)
        o = _ln(_attend(q, k, v, H), p[b + "attn_norm_weight"], p[b + "attn_norm_bias"], eps)
        x = x + d(o, p[b + "out_proj_weight"], p[b + "out_proj_bias"])
        h = _ln(x, p[b + "norm2_weight"], p[b + "norm2_bias"], eps)
        hh = F.silu(d(h, p[b + "fc1_g_weight"], p[b + "fc1_g_bias"])) \
            * d(h, p[b + "fc1_x_weight"], p[b + "fc1_x_bias"])
        hh = _ln(hh, p[b + "mlp_norm_weight"], p[b + "mlp_norm_bias"], eps)
        x = x + d(hh, p[b + "fc2_weight"], p[b + "fc2_bias"])
    pooled = _ln(x[:, 0], p["final_norm_weight"], p["final_norm_bias"], eps)
    return d(pooled, p["head_weight"], p["head_bias"])
