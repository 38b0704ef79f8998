"""EVA02 CLIP vision towers in PyTorch (the counterpart of
novic_tpu.embedders.eva): a rotary, SwiGLU and sub-LN ViT (timm's Eva class,
which open_clip's EVA02 models use for their visual trunk).

Blocks of the base and large variants: separate q/k/v projections (k without
a bias), 2-D rotary embedding on q and k of every head with the class token
left unrotated, a LayerNorm on the attention output (sub-LN) before the out
projection, and a SwiGLU MLP with a LayerNorm on its hidden state. The
enormous (EVA-CLIP-E) variant runs plain pre-LN blocks in the same class:
no rope, no sub-LN, a GELU MLP; its checkpoints store a fused qkv weight,
which the converter splits, so the params are separate q/k/v here too. The
text towers are the port's TextTransformer.

Parameters keep the JAX package's names and torch layout (out, in), so the
flax tree flattened with dots is this module's state dict (bridge.py).
Numerics follow the JAX tower: tower_dense matmuls (operands rounded to the
compute dtype, float32 products), float32 layer norms, the residual stream in
the compute dtype, rope in float32. Self-attention goes through
ops.attention.fused_attention (K1) with no bias: the CUDA kernel on the card,
its plain version on the CPU.

Under tensor parallelism (parallel/tp.py `shard_tower`) a block holds its
shards, attends on its local heads, sums out_proj's and fc2's partial products
over the group before their biases, and normalises the sub-LN and the SwiGLU
hidden state, both cut over the group, with all-reduced mean and variance.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from novic_tpu_torch.device import dtype_of
from novic_tpu_torch.embedders.vit import _ACTS, _init_flax_like, _param, f32_layer_norm, tower_dense
from novic_tpu_torch.ops.attention import fused_attention
from novic_tpu_torch.parallel.tp import row_parallel_finish, tp_layer_norm


@dataclasses.dataclass(frozen=True)
class EvaVisionConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_hidden: int = 2048         # explicit: int(width * mlp_ratio), e.g. int(1024*8/3)=2730
    embed_dim: int = 512           # CLIP joint space (timm head / open_clip proj)
    use_rope: bool = True
    ref_feat_shape: int = 16       # rope grid rescale target (timm ref_feat_shape)
    swiglu: bool = True            # SwiGLU MLP with inner LN (scale_mlp)
    inner_attn_norm: bool = True   # sub-LN on attention output (scale_attn_inner)
    qkv_fused: bool = False        # enormous: the checkpoint stores fused qkv (split on conversion)
    act: str = "gelu"              # plain-MLP act for the enormous variant
    layer_norm_eps: float = 1e-6
    compute_dtype: str = "bfloat16"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def mlp_dim(self) -> int:
        return self.mlp_hidden


def rope_cat_table(grid: int, ref: int, head_dim: int) -> np.ndarray:
    """(N, 2*head_dim) [sin | cos] rotary table over the patch grid (timm
    RotaryEmbeddingCat): head_dim//4 bands per spatial axis at temperature
    10000, grid coordinates rescaled to `ref`, each angle repeated for an
    adjacent channel pair, rows (axis 0) in the first head_dim//2 channels."""
    num_bands = head_dim // 4
    bands = 1.0 / (10000.0 ** (np.arange(num_bands, dtype=np.float64) / num_bands))
    t = np.arange(grid, dtype=np.float64)
    if ref:
        t = t / grid * ref
    yy, xx = np.meshgrid(t, t, indexing="ij")
    pos = np.stack([yy.reshape(-1), xx.reshape(-1)], axis=-1)
    ang = pos[:, :, None] * bands
    ang = np.repeat(ang.reshape(pos.shape[0], -1), 2, axis=-1)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


def apply_rope_cat(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x: (B, N, H, hd); table: (N, 2*hd) [sin | cos]. Pair rotation
    (x0, x1) → (x0 cos − x1 sin, x1 cos + x0 sin)."""
    hd = x.shape[-1]
    sin = table[:, :hd][None, :, None, :]
    cos = table[:, hd:][None, :, None, :]
    x2 = x.reshape(*x.shape[:-1], hd // 2, 2)
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)
    return x * cos + rot * sin


class EvaBlock(nn.Module):
    def __init__(self, cfg: EvaVisionConfig):
        super().__init__()
        self.cfg = cfg
        E, M = cfg.width, cfg.mlp_hidden
        self.norm1_weight, self.norm1_bias = _param(E), _param(E)
        self.q_proj_weight, self.q_proj_bias = _param(E, E), _param(E)
        self.k_proj_weight = _param(E, E)
        self.v_proj_weight, self.v_proj_bias = _param(E, E), _param(E)
        if cfg.inner_attn_norm:
            self.attn_norm_weight, self.attn_norm_bias = _param(E), _param(E)
        self.out_proj_weight, self.out_proj_bias = _param(E, E), _param(E)
        self.norm2_weight, self.norm2_bias = _param(E), _param(E)
        if cfg.swiglu:
            self.fc1_g_weight, self.fc1_g_bias = _param(M, E), _param(M)
            self.fc1_x_weight, self.fc1_x_bias = _param(M, E), _param(M)
            self.mlp_norm_weight, self.mlp_norm_bias = _param(M), _param(M)
        else:
            self.fc1_weight, self.fc1_bias = _param(M, E), _param(M)
        self.fc2_weight, self.fc2_bias = _param(E, M), _param(E)
        self.tp = None  # parallel.tp.TPGroup when the params are tensor-parallel shards

    def _norm(self, x: torch.Tensor, name: str, out_dtype: torch.dtype,
              sharded: bool = False) -> torch.Tensor:
        """f32 LayerNorm with the `name` params; over a dim cut by tensor
        parallelism (`sharded`) the statistics are all-reduced, and replicated
        params (attn_norm) are sliced to this rank's columns."""
        w, b = getattr(self, f"{name}_weight"), getattr(self, f"{name}_bias")
        eps = self.cfg.layer_norm_eps
        if not sharded or self.tp is None:
            return f32_layer_norm(x, w, b, eps, out_dtype=out_dtype)
        if w.shape[0] != x.shape[-1]:
            w, b = self.tp.local(w), self.tp.local(b)
        return tp_layer_norm(x, w, b, eps, self.tp, out_dtype=out_dtype)

    def forward(self, x: torch.Tensor, rope: "torch.Tensor | None") -> torch.Tensor:
        cfg = self.cfg
        hd, cd = cfg.width // cfg.heads, cfg.compute_dtype
        dt = dtype_of(cd)
        B, S = x.shape[0], x.shape[1]
        h = self._norm(x, "norm1", dt)
        # -1 heads: all of them, or this rank's under tensor parallelism
        q = tower_dense(h, self.q_proj_weight, self.q_proj_bias, cd).reshape(B, S, -1, hd)
        k = tower_dense(h, self.k_proj_weight, None, cd).reshape(B, S, -1, hd)
        v = tower_dense(h, self.v_proj_weight, self.v_proj_bias, cd).reshape(B, S, -1, hd)
        if rope is not None:
            # Patch tokens only: the class token (index 0) passes unrotated
            q = torch.cat([q[:, :1], apply_rope_cat(q[:, 1:], rope)], dim=1)
            k = torch.cat([k[:, :1], apply_rope_cat(k[:, 1:], rope)], dim=1)
        out = fused_attention(q.contiguous(), k.contiguous(), v.contiguous()).reshape(B, S, -1)
        if cfg.inner_attn_norm:
            out = self._norm(out, "attn_norm", dt, sharded=True)
        out = row_parallel_finish(tower_dense(out, self.out_proj_weight, None, cd),
                                  self.out_proj_bias, self.tp)
        x = x.to(dt) + out.to(dt)

        h = self._norm(x, "norm2", dt)
        if cfg.swiglu:
            g = F.silu(tower_dense(h, self.fc1_g_weight, self.fc1_g_bias, cd))
            hh = g * tower_dense(h, self.fc1_x_weight, self.fc1_x_bias, cd)
            hh = self._norm(hh, "mlp_norm", dt, sharded=True)
        else:
            hh = _ACTS[cfg.act](tower_dense(h, self.fc1_weight, self.fc1_bias, cd).to(dt))
        out = row_parallel_finish(tower_dense(hh, self.fc2_weight, None, cd), self.fc2_bias,
                                  self.tp)
        return x + out.to(dt)


class EvaVisionTransformer(nn.Module):
    """EVA02 image tower. Input (B, S, S, 3) float32, already normalised.
    Output (B, embed_dim) float32, not normalised (the embedder normalises)."""

    def __init__(self, cfg: EvaVisionConfig):
        super().__init__()
        self.cfg = cfg
        E, P, G = cfg.width, cfg.patch_size, cfg.grid
        self.patch_weight, self.patch_bias = _param(E, P * P * 3), _param(E)
        self.class_embedding = _param(E)
        self.pos_embedding = _param(G * G + 1, E)
        for i in range(cfg.layers):
            setattr(self, f"blocks_{i}", EvaBlock(cfg))
        self.final_norm_weight, self.final_norm_bias = _param(E), _param(E)
        self.head_weight, self.head_bias = _param(cfg.embed_dim, E), _param(cfg.embed_dim)
        rope = rope_cat_table(G, cfg.ref_feat_shape, E // cfg.heads) if cfg.use_rope else None
        self.register_buffer("rope", None if rope is None else torch.tensor(rope),
                             persistent=False)

    def init_random(self, generator: torch.Generator) -> "EvaVisionTransformer":
        """Random init with the flax init's shapes and scales (normal weights
        with std width**-0.5, fc2 mlp_hidden**-0.5; zero biases; unit norm
        scales), drawn from `generator` on its device (a CUDA generator draws a
        tower built on the card in place)."""
        _init_flax_like(self, generator, self.cfg.width, {})
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, P, G = images.shape[0], cfg.patch_size, cfg.grid
        if images.shape[1] != cfg.image_size or images.shape[2] != cfg.image_size:
            raise ValueError(f"Expected {cfg.image_size}px square images, got {tuple(images.shape)}")
        x = images[:, :G * P, :G * P].reshape(B, G, P, G, P, 3)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, G * G, P * P * 3)
        x = tower_dense(x, self.patch_weight, self.patch_bias, cfg.compute_dtype)
        x = torch.cat([self.class_embedding.expand(B, 1, -1), x.float()], dim=1)
        x = x + self.pos_embedding
        for i in range(cfg.layers):
            x = getattr(self, f"blocks_{i}")(x, self.rope)
        # The final LN of the class token alone: a LayerNorm is per token
        pooled = f32_layer_norm(x[:, 0, :], self.final_norm_weight, self.final_norm_bias,
                                cfg.layer_norm_eps)
        return tower_dense(pooled, self.head_weight, self.head_bias, "float32")
