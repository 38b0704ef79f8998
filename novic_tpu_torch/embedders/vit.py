"""CLIP-family vision tower in PyTorch (the counterpart of novic_tpu.embedders.vit).

Parameters keep the JAX package's names and torch layout (out, in), so a flax
param tree flattened with dots is this module's state dict (see bridge.py).

Numerics follow the JAX towers:
* `tower_dense` rounds both operands to the compute dtype and accumulates in
  float32 with a float32 result, as jax's dot_general with
  preferred_element_type=float32 does. Products of bf16 values are exact in
  float32, so only the order of the sums differs; TF32 stays off.
* Layer norms run in float32; the residual stream runs in the compute dtype.
* Self-attention always goes through ops.attention.fused_attention: the CUDA
  kernel on the card, its plain version on the CPU. The MAP head's 1-query
  cross-attention stays plain torch and, in bf16 compute, keeps its scores and
  softmax in bf16 as the JAX XLA path does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from novic_tpu_torch.device import dtype_of
from novic_tpu_torch.ops.attention import fused_attention

_ACTS = {
    "gelu": lambda x: F.gelu(x),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}


@dataclasses.dataclass(frozen=True)
class VisionTowerConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    embed_dim: int = 512           # output projection dim (CLIP joint space)
    act: str = "quick_gelu"        # gelu | gelu_tanh | quick_gelu
    use_class_token: bool = True   # CLIP yes, SigLIP no
    patch_bias: bool = False       # CLIP no, SigLIP yes
    pre_ln: bool = True            # CLIP ln_pre, SigLIP none
    pool: str = "cls"              # cls | map | avg
    proj_bias: bool = False
    layer_norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    # The fields below select JAX-side formulations; they are kept so configs
    # compare and hash alike. The port always runs its attention kernel.
    use_pallas_attention: bool = False
    fuse_qkv: bool = False
    attn_impl: str = "einsum"
    quant: str = ""

    @property
    def grid(self) -> int:
        # Floor, matching strided-conv patch embedding
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def mlp_dim(self) -> int:
        return int(self.width * self.mlp_ratio)


@dataclasses.dataclass(frozen=True)
class TextTowerConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8
    mlp_ratio: float = 4.0
    embed_dim: int = 512
    act: str = "quick_gelu"
    causal: bool = True
    pool: str = "argmax"
    proj_bias: bool = False
    layer_norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    use_pallas_attention: bool = False
    fuse_qkv: bool = False
    quant: str = ""

    @property
    def mlp_dim(self) -> int:
        return int(self.width * self.mlp_ratio)


def tower_dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                compute_dtype: str) -> torch.Tensor:
    """x @ w.T + b with torch-layout w; operands rounded to the compute dtype,
    float32 product and result.

    bf16 on CUDA: one cuBLAS bf16 GEMM with float32 accumulation and output
    (torch.mm out_dtype). Elsewhere: a float32 matmul of the bf16-rounded
    operands. Both form the same exact products; only the sum order differs."""
    dt = dtype_of(compute_dtype)
    if dt == torch.bfloat16 and x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]).to(dt), w.to(dt).t(), out_dtype=torch.float32)
        y = y.reshape(*x.shape[:-1], w.shape[0])
    else:
        y = torch.matmul(x.to(dt).float(), w.to(dt).float().t())
    if b is not None:
        y = y + b
    return y


def f32_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LayerNorm computed in float32, emitted in out_dtype."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * weight + bias).to(out_dtype)


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class TowerAttention(nn.Module):
    """Biased MHA with separate q/k/v projections (HF layout)."""

    def __init__(self, width: int, heads: int, compute_dtype: str):
        super().__init__()
        self.width, self.heads, self.compute_dtype = width, heads, compute_dtype
        E = width
        for n in ("q", "k", "v", "out"):
            setattr(self, f"{n}_proj_weight", _param(E, E))
            setattr(self, f"{n}_proj_bias", _param(E))

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        E, H = self.width, self.heads
        hd = E // H
        dt = self.compute_dtype
        src = x if kv is None else kv
        B, Sq, Sk = x.shape[0], x.shape[1], src.shape[1]
        q = tower_dense(x, self.q_proj_weight, self.q_proj_bias, dt).reshape(B, Sq, H, hd)
        k = tower_dense(src, self.k_proj_weight, self.k_proj_bias, dt).reshape(B, Sk, H, hd)
        v = tower_dense(src, self.v_proj_weight, self.v_proj_bias, dt).reshape(B, Sk, H, hd)
        if kv is None:
            sq_bias = None
            if attn_bias is not None:
                sq_bias = attn_bias.float().expand(Sq, Sk).contiguous()
            out = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), sq_bias)
            return tower_dense(out.reshape(B, Sq, E), self.out_proj_weight,
                               self.out_proj_bias, dt)
        # Cross-attention (MAP head): scores and softmax in the compute dtype
        cdt = dtype_of(dt)
        scale = 1.0 / math.sqrt(hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", (q * scale).to(cdt).float(),
                              k.to(cdt).float()).to(cdt)
        if attn_bias is not None:
            scores = scores + attn_bias.to(cdt)
        attn = torch.softmax(scores.float(), dim=-1).to(cdt)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.to(cdt).float())
        return tower_dense(out.reshape(B, Sq, E), self.out_proj_weight, self.out_proj_bias, dt)


class TowerBlock(nn.Module):
    """Pre-LN residual block (HF CLIP/SigLIP encoder layer)."""

    def __init__(self, width: int, heads: int, mlp_dim: int, act: str, eps: float,
                 compute_dtype: str):
        super().__init__()
        E = width
        self.eps, self.act, self.compute_dtype = eps, act, compute_dtype
        self.norm1_weight, self.norm1_bias = _param(E), _param(E)
        self.norm2_weight, self.norm2_bias = _param(E), _param(E)
        self.fc1_weight, self.fc1_bias = _param(mlp_dim, E), _param(mlp_dim)
        self.fc2_weight, self.fc2_bias = _param(E, mlp_dim), _param(E)
        self.attn = TowerAttention(width, heads, compute_dtype)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = dtype_of(self.compute_dtype)
        x = x.to(dt)
        h = f32_layer_norm(x, self.norm1_weight, self.norm1_bias, self.eps, out_dtype=dt)
        x = x + self.attn(h, attn_bias).to(dt)
        h = f32_layer_norm(x, self.norm2_weight, self.norm2_bias, self.eps, out_dtype=dt)
        h = tower_dense(h, self.fc1_weight, self.fc1_bias, self.compute_dtype).to(dt)
        h = _ACTS[self.act](h)
        h = tower_dense(h, self.fc2_weight, self.fc2_bias, self.compute_dtype)
        return x + h.to(dt)


class VisionTransformer(nn.Module):
    """ViT image tower. Input (B, S, S, 3) float32, already normalised. Output
    (B, embed_dim) float32, not normalised (the embedder normalises)."""

    def __init__(self, cfg: VisionTowerConfig):
        super().__init__()
        if cfg.pool not in ("cls", "avg", "map"):
            raise ValueError(f"Unknown vision pool: {cfg.pool}")
        self.cfg = cfg
        E, P = cfg.width, cfg.patch_size
        self.patch_weight = _param(E, P * P * 3)
        if cfg.patch_bias:
            self.patch_bias = _param(E)
        if cfg.use_class_token:
            self.class_embedding = _param(E)
        self.pos_embedding = _param(cfg.num_patches + int(cfg.use_class_token), E)
        if cfg.pre_ln:
            self.pre_ln_weight, self.pre_ln_bias = _param(E), _param(E)
        for i in range(cfg.layers):
            setattr(self, f"blocks_{i}", TowerBlock(E, cfg.heads, cfg.mlp_dim, cfg.act,
                                                    cfg.layer_norm_eps, cfg.compute_dtype))
        self.post_ln_weight, self.post_ln_bias = _param(E), _param(E)
        if cfg.pool == "map":
            self.map_probe = _param(1, 1, E)
            self.map_attn = TowerAttention(E, cfg.heads, cfg.compute_dtype)
            self.map_ln_weight, self.map_ln_bias = _param(E), _param(E)
            self.map_fc1_weight, self.map_fc1_bias = _param(cfg.mlp_dim, E), _param(cfg.mlp_dim)
            self.map_fc2_weight, self.map_fc2_bias = _param(E, cfg.mlp_dim), _param(E)
        if cfg.pool != "map" or cfg.embed_dim != E:
            self.proj_weight = _param(cfg.embed_dim, E)
        if cfg.pool != "map" and cfg.proj_bias:
            self.proj_bias = _param(cfg.embed_dim)

    def init_random(self, generator: torch.Generator) -> "VisionTransformer":
        """Random init with the flax init's shapes and scales (normal weights with
        std width**-0.5, fc2 std mlp_dim**-0.5; zero biases; unit norm scales).
        Draws on the CPU from `generator`, so a seed gives the same weights on
        every device."""
        E = self.cfg.width
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if leaf.endswith("_bias") or leaf == "proj_bias":
                    p.zero_()
                elif leaf.endswith(("norm1_weight", "norm2_weight", "ln_weight")):
                    p.fill_(1.0)
                else:
                    std = p.shape[1] ** -0.5 if leaf.endswith("fc2_weight") else E ** -0.5
                    p.copy_(torch.randn(p.shape, generator=generator) * std)
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, P, G = images.shape[0], cfg.patch_size, cfg.grid
        if images.shape[1] != cfg.image_size or images.shape[2] != cfg.image_size:
            raise ValueError(f"Expected {cfg.image_size}px square images, got {tuple(images.shape)}")
        # Patchify as reshape + matmul: (B,G,P,G,P,3) -> (B,G*G,P*P*3) @ W.T
        images = images[:, :G * P, :G * P]
        x = images.reshape(B, G, P, G, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, G * G, P * P * 3)
        x = tower_dense(x, self.patch_weight, getattr(self, "patch_bias", None), cfg.compute_dtype)
        if cfg.use_class_token:
            cls = self.class_embedding.expand(B, 1, -1)
            x = torch.cat([cls, x.to(cls.dtype)], dim=1)
        x = x + self.pos_embedding
        if cfg.pre_ln:
            x = f32_layer_norm(x, self.pre_ln_weight, self.pre_ln_bias, cfg.layer_norm_eps)
        for i in range(cfg.layers):
            x = getattr(self, f"blocks_{i}")(x)

        eps = cfg.layer_norm_eps
        if cfg.pool == "cls":
            pooled = f32_layer_norm(x[:, 0, :], self.post_ln_weight, self.post_ln_bias, eps)
            return tower_dense(pooled, self.proj_weight, getattr(self, "proj_bias", None), "float32")
        if cfg.pool == "avg":
            tokens = x[:, 1:, :] if cfg.use_class_token else x
            pooled = f32_layer_norm(tokens.float().mean(dim=1), self.post_ln_weight,
                                    self.post_ln_bias, eps)
            return tower_dense(pooled, self.proj_weight, getattr(self, "proj_bias", None), "float32")
        # map: post-LN over all tokens, then the attention-pooling head
        x = f32_layer_norm(x, self.post_ln_weight, self.post_ln_bias, eps)
        attn_out = self.map_attn(self.map_probe.expand(B, 1, -1), kv=x)
        h = f32_layer_norm(attn_out, self.map_ln_weight, self.map_ln_bias, eps)
        h = tower_dense(h, self.map_fc1_weight, self.map_fc1_bias, cfg.compute_dtype)
        h = _ACTS[cfg.act](h)
        h = tower_dense(h, self.map_fc2_weight, self.map_fc2_bias, cfg.compute_dtype)
        out = (attn_out + h)[:, 0, :]
        if cfg.embed_dim != cfg.width:
            return tower_dense(out, self.proj_weight, None, "float32")
        return out.float()
