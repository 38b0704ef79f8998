"""CLIP-family vision and text towers in PyTorch (the counterpart of
novic_tpu.embedders.vit).

Parameters keep the JAX package's names and torch layout (out, in), so a flax
param tree flattened with dots is this module's state dict (see bridge.py).

Numerics follow the JAX towers:
* `tower_dense` rounds both operands to the compute dtype and accumulates in
  float32 with a float32 result, as jax's dot_general with
  preferred_element_type=float32 does. Products of bf16 values are exact in
  float32, so only the order of the sums differs; TF32 stays off.
* Layer norms run in float32 (ops.layer_norm: the CUDA kernel on the card,
  its plain version on the CPU); the residual stream runs in the compute dtype.
* Self-attention always goes through ops.attention.fused_attention: the CUDA
  kernel on the card, its plain version on the CPU. The MAP head's 1-query
  cross-attention stays plain torch and, in bf16 compute, keeps its scores and
  softmax in bf16 as the JAX XLA path does.
* `quant="int8"` or `"int8:pallas"` runs the block q/k/v/o and fc1/fc2 matmuls
  as W8A8 int8 (ops.int8_matmul.int8_dense: the s8 GEMM kernel K2 on the card,
  its exact plain version on the CPU), as the JAX towers do; the patch embed,
  the MAP head and the final projections stay unquantized. Both JAX impls give
  the same integers, so both run K2 here. Each weight is quantized once per
  device and value (a cache outside the state dict), which gives the bits of
  JAX's per-call `quantize_weight` since the weights are frozen.
* Tensor parallelism (parallel/tp.py `shard_tower`): a block whose `tp` is set
  holds its column shards of q/k/v and fc1 and its row shards of out_proj and
  fc2, runs attention on its local heads, and sums each row-parallel product
  over the group before adding the bias once; the MAP head likewise.
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
from novic_tpu_torch.ops.int8_matmul import int8_dense, quantize_rows, quantize_weight
from novic_tpu_torch.ops.layer_norm import layer_norm, layer_norm_reference
from novic_tpu_torch.parallel.tp import row_parallel_finish
from novic_tpu_torch.utils import trace

_ACTS = {
    "gelu": lambda x: F.gelu(x),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "swish": lambda x: F.silu(x),  # EfficientNet (ALIGN): HF ACT2FN["swish"] is SiLU
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
    # use_pallas_attention, fuse_qkv and attn_impl select JAX-side
    # formulations; they are kept so configs compare and hash alike. The port
    # always runs its attention kernel.
    use_pallas_attention: bool = False
    fuse_qkv: bool = False
    attn_impl: str = "einsum"
    # Quantized serving mode of the block matmuls: "" (off) | "int8" |
    # "int8:pallas" (both W8A8 through the K2 kernel; see the module docstring)
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
    quant: str = ""                # see VisionTowerConfig.quant

    @property
    def mlp_dim(self) -> int:
        return int(self.width * self.mlp_ratio)


def check_quant(quant: str) -> None:
    """Raise ValueError for a quant mode the JAX towers reject."""
    if not quant:
        return
    kind, _, impl = quant.partition(":")
    if kind != "int8":
        raise ValueError(f"Unknown tower quant mode: {quant}")
    if impl not in ("", "xla", "pallas"):
        raise ValueError(f"Unknown int8 dense impl: {impl}")


def bf16_dense_grads(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of y = bf16(x) @ bf16(w).T for a float32 cotangent dy (N, out),
    x (N, in), w (out, in), as autograd takes them through the CPU form
    `x.to(bf16).float() @ w.to(bf16).float().t()` and as jax.grad takes them
    through dot_general(preferred_element_type=float32): the float32
    cotangent times the other bf16 operand in float32, rounded to bf16, in the
    operand's own dtype."""
    bf = torch.bfloat16
    dx = (dy @ w.to(bf).float()).to(bf).to(x.dtype)
    dw = (dy.t() @ x.to(bf).float()).to(bf).to(w.dtype)
    return dx, dw


class _Bf16Dense(torch.autograd.Function):
    """The CUDA bf16 GEMM (torch.mm with out_dtype, which autograd cannot
    differentiate) with `bf16_dense_grads` as its backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x.to(torch.bfloat16), w.to(torch.bfloat16).t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        return bf16_dense_grads(dy.float(), *ctx.saved_tensors)


def tower_dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                compute_dtype: str, quant: str = "") -> torch.Tensor:
    """x @ w.T + b with torch-layout w; operands rounded to the compute dtype,
    float32 product and result.

    bf16 on CUDA: one cuBLAS bf16 GEMM with float32 accumulation and output
    (torch.mm out_dtype; under grad through `_Bf16Dense`, whose backward
    takes the CPU form's gradients). Elsewhere: a float32 matmul of the
    bf16-rounded operands. Both form the same exact products; only the sum
    order differs.

    quant="int8[:impl]": W8A8 through int8_dense, w quantized per call as in
    the JAX package (the towers' blocks keep theirs quantized instead).

    A bf16 call counts `tower.dense` in the program's trace (one GEMM)
    while a profiler session runs."""
    if quant:
        check_quant(quant)
        return int8_dense(x, *quantize_weight(w), b)
    dt = dtype_of(compute_dtype)
    if dt == torch.bfloat16:
        trace.count("tower.dense")
    if dt == torch.bfloat16 and x.is_cuda:
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            y = _Bf16Dense.apply(x2, w)
        else:
            y = torch.mm(x2.to(dt), w.to(dt).t(), out_dtype=torch.float32)
        y = y.reshape(*x.shape[:-1], w.shape[0])
    else:
        y = torch.matmul(x.to(dt).float(), w.to(dt).float().t())
    if b is not None:
        y = y + b
    return y


def f32_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LayerNorm computed in float32, emitted in out_dtype: the hand-written
    kernel on the card (ops/layer_norm.py), its plain version elsewhere."""
    if x.is_cuda:
        return layer_norm(x, weight, bias, eps, out_dtype)
    return layer_norm_reference(x, weight, bias, eps, out_dtype)


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class _DenseOwner(nn.Module):
    """Runs its `<name>_weight` / `<name>_bias` params through tower_dense, or in
    the quant mode through int8_dense with each weight quantized once per
    (device, storage, version) into a cache outside the state dict."""

    def __init__(self, compute_dtype: str, quant: str):
        super().__init__()
        check_quant(quant)
        self.compute_dtype, self.quant = compute_dtype, quant
        self._qweights: dict[str, tuple] = {}
        self.tp = None  # parallel.tp.TPGroup when the params are tensor-parallel shards

    def dense(self, x: torch.Tensor, name: str,
              rows: Optional[tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """tower_dense of the named params; in the quant mode `rows` may hold
        quantize_rows of x (flattened) where the caller has them."""
        w, b = getattr(self, f"{name}_weight"), getattr(self, f"{name}_bias")
        if not self.quant:
            return tower_dense(x, w, b, self.compute_dtype)
        key = (w.device, w.data_ptr(), w._version)
        hit = self._qweights.get(name)
        if hit is None or hit[0] != key:
            hit = self._qweights[name] = (key, quantize_weight(w.detach()))
        return int8_dense(x, *hit[1], b, rows)

    def row_dense(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """dense of a row-parallel layer (out_proj, fc2): under tensor
        parallelism the partial product is summed over the group, then the
        bias is added once."""
        if self.tp is None:
            return self.dense(x, name)
        w, b = getattr(self, f"{name}_weight"), getattr(self, f"{name}_bias")
        return row_parallel_finish(tower_dense(x, w, None, self.compute_dtype), b, self.tp)


class TowerAttention(_DenseOwner):
    """Biased MHA with separate q/k/v projections (HF layout)."""

    def __init__(self, width: int, heads: int, compute_dtype: str, quant: str = ""):
        super().__init__(compute_dtype, quant)
        self.width, self.heads = width, heads
        E = width
        for n in ("q", "k", "v", "out"):
            setattr(self, f"{n}_proj_weight", _param(E, E))
            setattr(self, f"{n}_proj_bias", _param(E))

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        E = self.width
        hd = E // self.heads
        src = x if kv is None else kv
        B, Sq, Sk = x.shape[0], x.shape[1], src.shape[1]
        # Self-attention in the quant mode: q, k and v quantize the same rows,
        # so they are quantized once (the bits of three quantize_rows calls)
        rows = quantize_rows(x.reshape(-1, E)) if self.quant and kv is None else None
        # -1 heads: all of them, or this rank's under tensor parallelism
        q = self.dense(x, "q_proj", rows).reshape(B, Sq, -1, hd)
        k = self.dense(src, "k_proj", rows).reshape(B, Sk, -1, hd)
        v = self.dense(src, "v_proj", rows).reshape(B, Sk, -1, hd)
        if kv is None:
            sq_bias = None
            if attn_bias is not None:
                sq_bias = attn_bias.float().expand(Sq, Sk).contiguous()
            out = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), sq_bias)
            return self.row_dense(out.reshape(B, Sq, -1), "out_proj")
        # Cross-attention (MAP head): scores and softmax in the compute dtype
        cdt = dtype_of(self.compute_dtype)
        scale = 1.0 / math.sqrt(hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", (q * scale).to(cdt).float(),
                              k.to(cdt).float()).to(cdt)
        if attn_bias is not None:
            scores = scores + attn_bias.to(cdt)
        attn = torch.softmax(scores.float(), dim=-1).to(cdt)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.to(cdt).float())
        return self.row_dense(out.reshape(B, Sq, -1), "out_proj")


class TowerBlock(_DenseOwner):
    """Pre-LN residual block (HF CLIP/SigLIP encoder layer)."""

    def __init__(self, width: int, heads: int, mlp_dim: int, act: str, eps: float,
                 compute_dtype: str, quant: str = ""):
        super().__init__(compute_dtype, quant)
        E = width
        self.eps, self.act = eps, act
        self.norm1_weight, self.norm1_bias = _param(E), _param(E)
        self.norm2_weight, self.norm2_bias = _param(E), _param(E)
        self.fc1_weight, self.fc1_bias = _param(mlp_dim, E), _param(mlp_dim)
        self.fc2_weight, self.fc2_bias = _param(E, mlp_dim), _param(E)
        self.attn = TowerAttention(width, heads, compute_dtype, quant)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = dtype_of(self.compute_dtype)
        x = x.to(dt)
        h = f32_layer_norm(x, self.norm1_weight, self.norm1_bias, self.eps, out_dtype=dt)
        x = x + self.attn(h, attn_bias).to(dt)
        h = f32_layer_norm(x, self.norm2_weight, self.norm2_bias, self.eps, out_dtype=dt)
        h = self.dense(h, "fc1").to(dt)
        h = _ACTS[self.act](h)
        h = self.row_dense(h, "fc2")
        return x + h.to(dt)


def _init_flax_like(module: nn.Module, generator: torch.Generator, width: int,
                    stds: dict[str, float]) -> None:
    """Random init with the flax init's shapes and scales: zero biases, unit norm
    scales, normal weights with std width**-0.5 (fc2: mlp_dim**-0.5; a leaf named
    in `stds`: that std). Draws from `generator`, on its device, in parameter
    order: a CPU generator gives the same weights whatever the module's device."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in stds:
                std = stds[leaf]
            elif leaf.endswith("_bias"):
                p.zero_()
                continue
            elif leaf.endswith(("norm1_weight", "norm2_weight", "ln_weight", "norm_weight")):
                p.fill_(1.0)
                continue
            else:
                std = p.shape[1] ** -0.5 if leaf.endswith("fc2_weight") else width ** -0.5
            p.copy_(torch.randn(p.shape, generator=generator, device=generator.device) * std)


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
                                                    cfg.layer_norm_eps, cfg.compute_dtype,
                                                    cfg.quant))
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
        self.tp = None  # the MAP head's group under tensor parallelism (parallel/tp.py)

    def init_random(self, generator: torch.Generator) -> "VisionTransformer":
        """Random init with the flax init's shapes and scales (normal weights with
        std width**-0.5, fc2 std mlp_dim**-0.5; zero biases; unit norm scales).
        Draws on the CPU from `generator`, so a seed gives the same weights on
        every device."""
        _init_flax_like(self, generator, self.cfg.width, {})
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
        h = row_parallel_finish(tower_dense(h, self.map_fc2_weight, None, cfg.compute_dtype),
                                self.map_fc2_bias, self.tp)
        out = (attn_out + h)[:, 0, :]
        if cfg.embed_dim != cfg.width:
            return tower_dense(out, self.proj_weight, None, "float32")
        return out.float()


class TextTransformer(nn.Module):
    """Text tower. Input (B, S) int token ids padded to the context length.
    Output (B, embed_dim) float32, not normalised (the embedder normalises).

    The token gather and the position add run in float32; the causal bias is
    an (S, S) float32 mask of -1e30 through the attention kernel; pooling takes
    the end-of-text token (`argmax`: the highest id, first among ties, as
    jnp.argmax) or the last position (`last`)."""

    def __init__(self, cfg: TextTowerConfig):
        super().__init__()
        if cfg.pool not in ("argmax", "last"):
            raise ValueError(f"Unknown text pool: {cfg.pool}")
        self.cfg = cfg
        E = cfg.width
        self.token_embedding = _param(cfg.vocab_size, E)
        self.pos_embedding = _param(cfg.context_length, E)
        for i in range(cfg.layers):
            setattr(self, f"blocks_{i}", TowerBlock(E, cfg.heads, cfg.mlp_dim, cfg.act,
                                                    cfg.layer_norm_eps, cfg.compute_dtype,
                                                    cfg.quant))
        self.final_ln_weight, self.final_ln_bias = _param(E), _param(E)
        self.proj_weight = _param(cfg.embed_dim, E)
        if cfg.proj_bias:
            self.proj_bias = _param(cfg.embed_dim)

    def init_random(self, generator: torch.Generator) -> "TextTransformer":
        """Random init with the flax init's shapes and scales (token table std
        0.02, positions 0.01, the blocks and projection as in the vision tower)."""
        _init_flax_like(self, generator, self.cfg.width,
                        {"token_embedding": 0.02, "pos_embedding": 0.01})
        return self

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S = token_ids.shape
        x = self.token_embedding[token_ids] + self.pos_embedding[:S]
        attn_bias = None
        if cfg.causal:
            i = torch.arange(S, device=token_ids.device)
            attn_bias = torch.where(i[None, :] <= i[:, None], 0.0, -1e30).float()
        for li in range(cfg.layers):
            x = getattr(self, f"blocks_{li}")(x, attn_bias)
        x = f32_layer_norm(x, self.final_ln_weight, self.final_ln_bias, cfg.layer_norm_eps)
        if cfg.pool == "argmax":
            pooled = x[torch.arange(B, device=x.device), token_ids.argmax(dim=1)]
        else:
            pooled = x[:, -1, :]
        return tower_dense(pooled, self.proj_weight, getattr(self, "proj_bias", None), "float32")
