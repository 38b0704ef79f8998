"""ALIGN dual-encoder towers in PyTorch (the counterpart of
novic_tpu.embedders.align): EfficientNet-B7 vision and BERT text, with the
semantics of transformers' AlignModel.

* vision: the EfficientNet trunk without a top conv; the global mean pool of
  the last block's map is the image embedding (no projection).
* text: the BERT post-LN encoder; the [CLS] last hidden state through a
  linear projection (not the tanh pooler).

Parameters keep the JAX package's names and layouts (conv kernels HWIO, BNs
folded into per-channel scale and bias at conversion), so the flax tree
flattened with dots is each module's state dict (bridge.py). Activations
stay NHWC, as in the JAX tower; each conv reads them through a permuted view
(channels-last memory).

Numerics follow the JAX towers. A conv rounds its input and kernel to the
compute dtype and runs in float32 (exact products, float32 sums and result,
as lax.conv_general_dilated with preferred_element_type=float32), with TF32
off whatever torch.backends.cudnn.allow_tf32 says; the folded BN is applied
in float32 and rounded to the compute dtype. The convs are cuDNN's (JAX
computes them outside any Pallas kernel). BERT's self-attention goes through
ops.attention.fused_attention (K1) with a (B, S) key bias of -1e30 at pad
keys (ids == pad_token_id), which K1 adds to every query row and head of its
batch row, as the JAX tower adds its (B, 1, 1, S) bias; position 0 is always
[CLS], so no row is fully masked.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from novic_tpu_torch.device import dtype_of
from novic_tpu_torch.embedders.vit import _ACTS, _param, f32_layer_norm, tower_dense
from novic_tpu_torch.ops.attention import fused_attention


@dataclasses.dataclass(frozen=True)
class AlignVisionConfig:
    """EfficientNet trunk hyperparameters (HF AlignVisionConfig defaults ==
    kakaobrain/align-base == EfficientNet-B7)."""

    image_size: int = 289              # processed input size (processor crop)
    width_coefficient: float = 2.0
    depth_coefficient: float = 3.1
    depth_divisor: int = 8
    kernel_sizes: tuple = (3, 3, 5, 3, 5, 5, 3)
    in_channels: tuple = (32, 16, 24, 40, 80, 112, 192)
    out_channels: tuple = (16, 24, 40, 80, 112, 192, 320)
    strides: tuple = (1, 2, 2, 2, 1, 2, 1)
    num_block_repeats: tuple = (1, 2, 2, 3, 3, 4, 1)
    expand_ratios: tuple = (1, 6, 6, 6, 6, 6, 6)
    depthwise_padding: tuple = ()      # block indices with adjust_padding=False
    squeeze_expansion_ratio: float = 0.25
    act: str = "swish"
    embed_dim: int = 640               # = round_filters(out_channels[-1])
    compute_dtype: str = "bfloat16"

    def round_filters(self, num_channels: int) -> int:
        """Width scaling (HF modeling_align.py round_filters)."""
        divisor = self.depth_divisor
        num_channels *= self.width_coefficient
        new_dim = max(divisor, int(num_channels + divisor / 2) // divisor * divisor)
        if new_dim < 0.9 * num_channels:
            new_dim += divisor
        return int(new_dim)

    def round_repeats(self, repeats: int) -> int:
        return int(math.ceil(self.depth_coefficient * repeats))


@dataclasses.dataclass(frozen=True)
class AlignBlockPlan:
    """Static per-block descriptor resolved from the stage config."""

    in_dim: int
    out_dim: int
    stride: int
    kernel_size: int
    expand_ratio: int
    residual: bool        # repeated blocks (j>0): stride 1, in==out → skip-add
    adjust_padding: bool  # asymmetric (k//2-1, k//2) stride-2 padding


def align_block_plan(cfg: AlignVisionConfig) -> tuple[AlignBlockPlan, ...]:
    """The 7-stage config expanded into blocks (55 for B7), in HF
    AlignVisionEncoder's order."""
    plan = []
    block_num = 0
    for i in range(len(cfg.in_channels)):
        in_dim = cfg.round_filters(cfg.in_channels[i])
        out_dim = cfg.round_filters(cfg.out_channels[i])
        for j in range(cfg.round_repeats(cfg.num_block_repeats[i])):
            plan.append(AlignBlockPlan(
                in_dim=out_dim if j > 0 else in_dim,
                out_dim=out_dim,
                stride=1 if j > 0 else cfg.strides[i],
                kernel_size=cfg.kernel_sizes[i],
                expand_ratio=cfg.expand_ratios[i],
                residual=j > 0,
                adjust_padding=block_num not in cfg.depthwise_padding,
            ))
            block_num += 1
    return tuple(plan)


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int, pad: tuple, compute_dtype: str,
          groups: int = 1) -> torch.Tensor:
    """NHWC x, HWIO kernel → NHWC float32: operands rounded to the compute
    dtype, a float32 conv (TF32 off), `pad` = (left, right, top, bottom) zeros
    added to the input first."""
    dt = dtype_of(compute_dtype)
    xin = x.to(dt).float().permute(0, 3, 1, 2)
    if any(pad):
        xin = F.pad(xin, pad)
    w = kernel.to(dt).float().permute(3, 2, 0, 1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(xin, w, stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def _fold_bn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    return (x.float() * scale + bias).to(out_dtype)


def _init_normal(module: nn.Module, generator: torch.Generator, std: float,
                 ones: tuple[str, ...]) -> None:
    """The flax init's shapes and scales: zero biases, ones for the leaves
    ending in `ones`, normal weights with std `std`, drawn from `generator` on
    its device in parameter order."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(ones):
                p.fill_(1.0)
            elif name.endswith("_bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator, device=generator.device) * std)


class AlignVisionBlock(nn.Module):
    """One MBConv block: expand (1x1) → depthwise → squeeze-excite → project
    (1x1), plus the input on repeated blocks."""

    def __init__(self, plan: AlignBlockPlan, squeeze_ratio: float, act: str, compute_dtype: str):
        super().__init__()
        self.plan, self.act, self.compute_dtype = plan, act, compute_dtype
        p, k = plan, plan.kernel_size
        if k % 2 == 0:
            raise ValueError(f"Depthwise kernels must be odd-sized, got {k}")
        expand_dim = p.in_dim * p.expand_ratio
        if p.expand_ratio != 1:
            self.expand_conv_weight = _param(1, 1, p.in_dim, expand_dim)
            self.expand_bn_scale, self.expand_bn_bias = _param(expand_dim), _param(expand_dim)
        self.dw_conv_weight = _param(k, k, 1, expand_dim)
        self.dw_bn_scale, self.dw_bn_bias = _param(expand_dim), _param(expand_dim)
        # The squeeze width derives from the block's input width (HF)
        dim_se = max(1, int(p.in_dim * squeeze_ratio))
        self.se_reduce_weight, self.se_reduce_bias = _param(dim_se, expand_dim), _param(dim_se)
        self.se_expand_weight, self.se_expand_bias = _param(expand_dim, dim_se), _param(expand_dim)
        self.project_conv_weight = _param(1, 1, expand_dim, p.out_dim)
        self.project_bn_scale, self.project_bn_bias = _param(p.out_dim), _param(p.out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, cd = self.plan, self.compute_dtype
        dt = dtype_of(cd)
        act = _ACTS[self.act]
        inputs = x
        if p.expand_ratio != 1:
            x = act(_fold_bn(_conv(x, self.expand_conv_weight, 1, (0,) * 4, cd),
                             self.expand_bn_scale, self.expand_bn_bias, dt))
        k = p.kernel_size
        if p.stride == 2:
            # HF pads (k//2 - 1, k//2) when adjust_padding (TF's SAME for
            # stride 2), else k//2 on both sides
            lo, hi = (k // 2 - 1 if p.adjust_padding else k // 2), k // 2
        else:
            lo = hi = k // 2  # SAME at stride 1 for an odd kernel
        x = act(_fold_bn(_conv(x, self.dw_conv_weight, p.stride, (lo, hi, lo, hi), cd,
                               groups=self.dw_conv_weight.shape[-1]),
                         self.dw_bn_scale, self.dw_bn_bias, dt))
        se = x.float().mean(dim=(1, 2))
        se = act(tower_dense(se, self.se_reduce_weight, self.se_reduce_bias, cd))
        se = torch.sigmoid(tower_dense(se, self.se_expand_weight, self.se_expand_bias, cd))
        x = x * se[:, None, None, :].to(dt)
        x = _fold_bn(_conv(x, self.project_conv_weight, 1, (0,) * 4, cd),
                     self.project_bn_scale, self.project_bn_bias, dt)
        if p.residual:
            x = x + inputs.to(dt)
        return x


class EfficientNetTower(nn.Module):
    """ALIGN image tower. Input (B, S, S, 3) float32, already normalised.
    Output (B, embed_dim) float32 mean-pooled features, not normalised."""

    def __init__(self, cfg: AlignVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.plan = align_block_plan(cfg)
        if self.plan[-1].out_dim != cfg.embed_dim:
            raise ValueError(f"embed_dim {cfg.embed_dim} != trunk output {self.plan[-1].out_dim}")
        stem_dim = cfg.round_filters(32)
        self.stem_conv_weight = _param(3, 3, 3, stem_dim)
        self.stem_bn_scale, self.stem_bn_bias = _param(stem_dim), _param(stem_dim)
        for i, p in enumerate(self.plan):
            setattr(self, f"block_{i}", AlignVisionBlock(p, cfg.squeeze_expansion_ratio, cfg.act,
                                                         cfg.compute_dtype))

    def init_random(self, generator: torch.Generator) -> "EfficientNetTower":
        """The flax init's shapes and scales: normal(0.02) kernels and SE
        weights, unit BN scales, zero biases."""
        _init_normal(self, generator, 0.02, ("_bn_scale",))
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = dtype_of(cfg.compute_dtype)
        # Stem: ZeroPad2d((0, 1, 0, 1)) and a stride-2 3x3 VALID conv
        x = _ACTS[cfg.act](_fold_bn(_conv(images, self.stem_conv_weight, 2, (0, 1, 0, 1),
                                          cfg.compute_dtype),
                                    self.stem_bn_scale, self.stem_bn_bias, dt))
        for i in range(len(self.plan)):
            x = getattr(self, f"block_{i}")(x)
        # Global mean pool (HF's AvgPool2d over the whole map)
        return x.float().mean(dim=(1, 2))


@dataclasses.dataclass(frozen=True)
class AlignTextConfig:
    """BERT-base encoder (HF AlignTextConfig defaults)."""

    context_length: int = 64           # kakaobrain/align-base tokenizer model_max_length
    vocab_size: int = 30522
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    act: str = "gelu"
    layer_norm_eps: float = 1e-12
    embed_dim: int = 640               # text_projection output (AlignConfig.projection_dim)
    pad_token_id: int = 0
    compute_dtype: str = "bfloat16"


_BERT_LAYER_PARAMS = ("q", "k", "v", "attn_out", "attn_ln", "fc1", "fc2", "out_ln")


class BertTextTower(nn.Module):
    """ALIGN text tower: BERT post-LN encoder, [CLS] pooling, linear projection.

    Input (B, S) int token ids padded with pad_token_id; the pad mask is
    ids == pad_token_id ([PAD] never appears as a content token in BERT
    vocabs). Output (B, embed_dim) float32, not normalised. The params are
    flat, `layers_{i}_q_weight` and so on, as in the JAX tower."""

    def __init__(self, cfg: AlignTextConfig):
        super().__init__()
        self.cfg = cfg
        E, M = cfg.width, cfg.mlp_dim
        self.word_embedding = _param(cfg.vocab_size, E)
        self.pos_embedding = _param(cfg.max_position_embeddings, E)
        self.type_embedding = _param(cfg.type_vocab_size, E)
        self.emb_ln_weight, self.emb_ln_bias = _param(E), _param(E)
        shapes = {"fc1": (M, E), "fc2": (E, M)}
        for li in range(cfg.layers):
            for n in _BERT_LAYER_PARAMS:
                if n.endswith("_ln"):
                    w, b = (E,), (E,)
                else:
                    w = shapes.get(n, (E, E))
                    b = (w[0],)
                setattr(self, f"layers_{li}_{n}_weight", _param(*w))
                setattr(self, f"layers_{li}_{n}_bias", _param(*b))
        self.proj_weight, self.proj_bias = _param(cfg.embed_dim, E), _param(cfg.embed_dim)

    def init_random(self, generator: torch.Generator) -> "BertTextTower":
        """The flax init's shapes and scales: normal(0.02) weights and tables,
        unit LN scales, zero biases."""
        _init_normal(self, generator, 0.02, ("ln_weight",))
        return self

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        E, H, cd, eps = cfg.width, cfg.heads, cfg.compute_dtype, cfg.layer_norm_eps
        B, S = token_ids.shape
        dt = dtype_of(cd)
        act = _ACTS[cfg.act]
        x = self.word_embedding[token_ids] + self.pos_embedding[:S] + self.type_embedding[0]
        x = f32_layer_norm(x, self.emb_ln_weight, self.emb_ln_bias, eps, out_dtype=dt)
        key_bias = torch.where(token_ids != cfg.pad_token_id, 0.0, -1e30).float()

        def dense(h, li, n):
            return tower_dense(h, getattr(self, f"layers_{li}_{n}_weight"),
                               getattr(self, f"layers_{li}_{n}_bias"), cd)

        for li in range(cfg.layers):
            q, k, v = (dense(x, li, n).reshape(B, S, H, E // H) for n in ("q", "k", "v"))
            out = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  key_bias=key_bias)
            out = dense(out.reshape(B, S, E), li, "attn_out")
            # Post-LN (BERT): the LN after the residual add, both sub-layers
            x = f32_layer_norm(x.float() + out, getattr(self, f"layers_{li}_attn_ln_weight"),
                               getattr(self, f"layers_{li}_attn_ln_bias"), eps, out_dtype=dt)
            h = dense(act(dense(x, li, "fc1").to(dt)), li, "fc2")
            x = f32_layer_norm(x.float() + h, getattr(self, f"layers_{li}_out_ln_weight"),
                               getattr(self, f"layers_{li}_out_ln_bias"), eps, out_dtype=dt)
        return tower_dense(x[:, 0, :], self.proj_weight, self.proj_bias, "float32")
