"""Plain PyTorch references of the two vision towers the benchmark serves,
with their parameter layouts, and the frames' preprocessing.

* SigLIP ViT-B/16 (Zhai et al., "Sigmoid Loss for Language Image
  Pre-Training", 2023; open_clip's ViT-B-16-SigLIP): patch embedding with a
  bias, learned positions, no class token and no pre-norm, pre-LN blocks
  (tanh GELU MLP), a final norm over all tokens and a multihead attention
  pooling head (one learned probe, a norm and an MLP with a residual).
* EVA02-L/14 (Fang et al., "EVA-02: A Visual Representation for Neon
  Genesis", 2023; timm's Eva trunk in open_clip): patch embedding with a
  bias, a class token, learned positions, pre-LN blocks with q/k/v
  projections (no key bias), 2-D rotary embedding on the patch tokens of q
  and k, a norm on the attention output before its projection (sub-LN), a
  SwiGLU MLP with a norm on its hidden state, then the class token's final
  norm and a linear head.

Parameters are named as the towers' state dicts name them (torch layout
(out, in)), so one dict of tensors feeds the program and this reference.
Arithmetic is float32 with TF32 off. `fp8=True` rounds every dense layer's
two operands to float8 e4m3 (no scaling: the values lie far inside its
range) and keeps the products in float32: the lower-precision control.

Imports torch and numpy only: nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.decoder import tf32_matmuls


def siglip_shapes(c: dict) -> dict[str, tuple]:
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


def eva02_shapes(c: dict) -> dict[str, tuple]:
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


SHAPES = {"siglip": siglip_shapes, "eva02": eva02_shapes}


def preprocess(frames: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 (B, S, S, 3) frames already at the tower's size -> (x / 255 -
    mean) / std in float32 (a resize to the same size is the identity)."""
    m = torch.tensor(mean, dtype=torch.float32, device=frames.device)
    s = torch.tensor(std, dtype=torch.float32, device=frames.device)
    return (frames.float() / 255.0 - m) / s


class _Dense:
    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def __call__(self, x, w, b=None):
        if self.fp8:
            x = x.to(torch.float8_e4m3fn).float()
            w = w.to(torch.float8_e4m3fn).float()
        y = x @ w.t()
        return y if b is None else y + b


def _ln(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def _attend(q, k, v, heads):
    """(B, Sq, E) x (B, Sk, E) multi-head softmax attention in float32."""
    B, Sq, E = q.shape
    hd = E // heads
    q, k, v = (t.reshape(B, t.shape[1], heads, hd).transpose(1, 2) for t in (q, k, v))
    a = torch.softmax((q / math.sqrt(hd)) @ k.transpose(-1, -2), dim=-1)
    return (a @ v).transpose(1, 2).reshape(B, Sq, E)


def _patches(x, P):
    B, S = x.shape[0], x.shape[1]
    G = S // P
    x = x[:, :G * P, :G * P].reshape(B, G, P, G, P, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, G * G, P * P * 3)


def siglip_forward(p: dict, c: dict, x: torch.Tensor, fp8: bool = False) -> torch.Tensor:
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


def rope_table(grid: int, ref: int, head_dim: int, device) -> torch.Tensor:
    """(grid*grid, 2*head_dim) [sin | cos] of timm's RotaryEmbeddingCat:
    head_dim // 4 bands per axis at temperature 10,000, coordinates scaled
    to a `ref` grid, each angle on an adjacent channel pair, rows first."""
    bands = 1.0 / (10000.0 ** (np.arange(head_dim // 4, dtype=np.float64) / (head_dim // 4)))
    t = np.arange(grid, dtype=np.float64) / grid * ref
    yy, xx = np.meshgrid(t, t, indexing="ij")
    ang = np.stack([yy.reshape(-1), xx.reshape(-1)], axis=-1)[:, :, None] * bands
    ang = np.repeat(ang.reshape(grid * grid, -1), 2, axis=-1)
    return torch.tensor(np.concatenate([np.sin(ang), np.cos(ang)], axis=-1), dtype=torch.float32,
                        device=device)


def _rope(x, table, heads):
    """Rotate channel pairs (x0, x1) -> (x0 cos - x1 sin, x1 cos + x0 sin) per head."""
    B, N, E = x.shape
    hd = E // heads
    x = x.reshape(B, N, heads, hd)
    sin, cos = table[:, :hd][None, :, None], table[:, hd:][None, :, None]
    pairs = x.reshape(B, N, heads, hd // 2, 2)
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(x.shape)
    return (x * cos + rot * sin).reshape(B, N, E)


def eva02_forward(p: dict, c: dict, x: torch.Tensor, fp8: bool = False) -> torch.Tensor:
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


FORWARD = {"siglip": siglip_forward, "eva02": eva02_forward}


@torch.no_grad()
def embed(params: dict, tower: dict, frames: torch.Tensor, fp8: bool = False,
          rows: int = 64) -> torch.Tensor:
    """Unit embeddings (B, embed_dim) of uint8 frames (B, S, S, 3), float32
    with TF32 off, `rows` frames at a time."""
    forward = FORWARD[tower["family"]]
    out = []
    with tf32_matmuls(False):
        for i in range(0, frames.shape[0], rows):
            x = preprocess(frames[i:i + rows], tower["mean"], tower["std"])
            y = forward(params, tower, x, fp8=fp8)
            out.append(y / y.norm(dim=-1, keepdim=True).clamp_min(1e-12))
    return torch.cat(out)
