"""SigLIP ViT (Zhai et al., "Sigmoid Loss for Language Image Pre-Training",
2023; open_clip's ViT-B-16-SigLIP): patch embedding with a bias, learned
positions, no class token and no pre-norm, pre-LN blocks (tanh GELU MLP),
a final norm over all tokens and a multihead attention pooling head (one
learned probe, a norm and an MLP with a residual).

A tower family of the benchmark (see reference/towers.py), found by its
config's `"family": "siglip"`. Imports torch and the reference's helpers
only: nothing of the program under test.
"""

from __future__ import annotations

import torch.nn.functional as F

from port_bench.reference.towers import _attend, _Dense, _ln, _patches

# The control: the program's own int8 tower path
CONTROL = "int8"


def stated(c: dict) -> dict:
    """Registry fields, beyond the shared ones, the program must run as stated."""
    return {"mlp_ratio": c["mlp_dim"] / c["width"], "act": c["act"], "pool": c["pool"]}


def shapes(c: dict) -> dict[str, tuple]:
    E, P, M, G = c["width"], c["patch_size"], c["mlp_dim"], c["image_size"] // c["patch_size"]
    s = {"patch_weight": (E, P * P * 3), "patch_bias": (E,), "pos_embedding": (G * G, E),
         "post_ln_weight": (E,), "post_ln_bias": (E,), "map_probe": (1, 1, E),
         "map_ln_weight": (E,), "map_ln_bias": (E,), "map_fc1_weight": (M, E),
         "map_fc1_bias": (M,), "map_fc2_weight": (E, M), "map_fc2_bias": (E,)}
    for n in ("q", "k", "v", "out"):
        s[f"map_attn.{n}_proj_weight"], s[f"map_attn.{n}_proj_bias"] = (E, E), (E,)
    for i in range(c["layers"]):
        b = f"blocks_{i}."
        s.update({b + "norm1_weight": (E,), b + "norm1_bias": (E,), b + "norm2_weight": (E,),
                  b + "norm2_bias": (E,), b + "fc1_weight": (M, E), b + "fc1_bias": (M,),
                  b + "fc2_weight": (E, M), b + "fc2_bias": (E,)})
        for n in ("q", "k", "v", "out"):
            s[f"{b}attn.{n}_proj_weight"], s[f"{b}attn.{n}_proj_bias"] = (E, E), (E,)
    return s


def tokens(c: dict) -> int:
    g = c["image_size"] // c["patch_size"]
    return g * g


def flops(c: dict) -> int:
    """FLOP of one image (every product; the attention's two S x S x hd
    products per head; the MAP head's k, v over S tokens, its q, out and
    MLP on one)."""
    E, M, P, L = c["width"], c["mlp_dim"], c["patch_size"], c["layers"]
    S = tokens(c)
    patch = 2 * S * P * P * 3 * E
    block = 2 * 4 * S * E * E + 2 * 2 * S * S * E + 2 * 2 * S * E * M
    head = 2 * 2 * S * E * E + 2 * 2 * E * E + 2 * 2 * S * E + 2 * 2 * E * M
    return patch + L * block + head


def forward(p: dict, c: dict, x, fp8: bool = False):
    d, eps, H = _Dense(fp8), c["layer_norm_eps"], c["heads"]
    act = lambda t: F.gelu(t, approximate="tanh")  # noqa: E731
    x = d(_patches(x, c["patch_size"]), p["patch_weight"], p["patch_bias"]) + p["pos_embedding"]
    for i in range(c["layers"]):
        b = f"blocks_{i}."
        h = _ln(x, p[b + "norm1_weight"], p[b + "norm1_bias"], eps)
        q, k, v = (d(h, p[f"{b}attn.{n}_proj_weight"], p[f"{b}attn.{n}_proj_bias"])
                   for n in ("q", "k", "v"))
        x = x + d(_attend(q, k, v, H), p[b + "attn.out_proj_weight"], p[b + "attn.out_proj_bias"])
        h = _ln(x, p[b + "norm2_weight"], p[b + "norm2_bias"], eps)
        x = x + d(act(d(h, p[b + "fc1_weight"], p[b + "fc1_bias"])), p[b + "fc2_weight"],
                  p[b + "fc2_bias"])
    x = _ln(x, p["post_ln_weight"], p["post_ln_bias"], eps)
    probe = p["map_probe"].expand(x.shape[0], 1, -1)
    q = d(probe, p["map_attn.q_proj_weight"], p["map_attn.q_proj_bias"])
    k = d(x, p["map_attn.k_proj_weight"], p["map_attn.k_proj_bias"])
    v = d(x, p["map_attn.v_proj_weight"], p["map_attn.v_proj_bias"])
    o = d(_attend(q, k, v, H), p["map_attn.out_proj_weight"], p["map_attn.out_proj_bias"])
    h = _ln(o, p["map_ln_weight"], p["map_ln_bias"], eps)
    h = d(act(d(h, p["map_fc1_weight"], p["map_fc1_bias"])), p["map_fc2_weight"], p["map_fc2_bias"])
    return (o + h)[:, 0]
