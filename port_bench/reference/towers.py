"""What the plain references of the vision towers share: the frames'
preprocessing, the dense layer, layer norm, attention, patches and 2-D
rope, and `embed`, which runs a family's forward in blocks of frames.

Each tower family is a module of its own, port_bench/reference/families/
<family>.py, found by a config's `tower.family` (harness.family_module). It
gives `shapes(c)` (the parameter layout, in the order the seed is cut),
`forward(p, c, x, fp8=False)` (the float32 reference), `tokens(c)` and
`flops(c)` (one image's tokens and FLOP, two per multiply-add), `stated(c)`
(the registry fields, beyond the shared ones, the program must run as
stated) and `CONTROL` ("int8": the program's int8 tower path; "fp8": the
reference with float8 e4m3 operands).

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


@torch.no_grad()
def embed(forward, params: dict, tower: dict, frames: torch.Tensor, fp8: bool = False,
          rows: int = 64) -> torch.Tensor:
    """Unit embeddings (B, embed_dim) of uint8 frames (B, S, S, 3) through a
    family's `forward`, float32 with TF32 off, `rows` frames at a time."""
    out = []
    with tf32_matmuls(False):
        for i in range(0, frames.shape[0], rows):
            x = preprocess(frames[i:i + rows], tower["mean"], tower["std"])
            y = forward(params, tower, x, fp8=fp8)
            out.append(y / y.norm(dim=-1, keepdim=True).clamp_min(1e-12))
    return torch.cat(out)
