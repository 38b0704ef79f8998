"""Decoder building blocks, inference forms (the counterpart of
novic_tpu.models.layers).

Weights are torch layout (out, in) with the JAX package's parameter names, so
a flattened flax tree is the state dict. Matmuls are exact float32 (TF32 off).
No dropout: this module serves inference only.

The KV-cached paths update the cache tensors in place (the JAX package returns
new arrays); they still return the caches so callers read alike.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from novic_tpu_torch.models.config import DecoderModelConfig, get_activation

NEG_INF = -1e30  # finite -inf stand-in: keeps softmax NaN-free for fully masked rows


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w.T + b with torch-layout weight (out, in)."""
    y = torch.matmul(x, w.t())
    if b is not None:
        y = y + b
    return y


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps) * weight
    if bias is not None:
        y = y + bias
    return y


def causality_mask(max_seq_len: int, prefix_len: int, strictly_causal: bool) -> torch.Tensor:
    """Additive float causal mask; the prefix block is non-causal unless strictly_causal."""
    i = torch.arange(max_seq_len)[:, None]
    j = torch.arange(max_seq_len)[None, :]
    allowed = j <= i
    if not strictly_causal:
        allowed = allowed | ((i < prefix_len) & (j < prefix_len))
    return torch.where(allowed, 0.0, NEG_INF).float()


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class EmbeddingVectorMLP(nn.Module):
    """F → (hidden?) → P·E MLP over unit-normalised embeddings."""

    def __init__(self, cfg: DecoderModelConfig, output_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        output_size = cfg.mlp_seq_len * cfg.hidden_dim
        hl = cfg.mlp_hidden_layer
        if hl == "none":
            hidden = None
        elif hl == "min":
            hidden = min(cfg.embed_dim, output_size)
        elif hl == "max":
            hidden = max(cfg.embed_dim, output_size)
        elif hl == "amean":
            hidden = round(((cfg.embed_dim + output_size) // 2) / 64) * 64
        elif hl == "gmean":
            hidden = round(math.sqrt(cfg.embed_dim * output_size) / 64) * 64
        else:
            raise ValueError(f"Unsupported hidden layer argument: {hl}")
        if cfg.embed_dim <= 0 or output_size <= 0 or (hidden is not None and hidden <= 0):
            raise ValueError("Embedding vector MLP has a non-positive layer size")
        self.hidden = hidden
        if hidden is None:
            self.linear1_weight = _param(output_size, cfg.embed_dim)
            if output_bias:
                self.linear1_bias = _param(output_size)
        else:
            self.linear1_weight = _param(hidden, cfg.embed_dim)
            if cfg.mlp_hidden_bias:
                self.linear1_bias = _param(hidden)
            if cfg.mlp_hidden_norm:
                self.norm_weight = _param(hidden)
                if cfg.mlp_hidden_bias:
                    self.norm_bias = _param(hidden)
            self.linear2_weight = _param(output_size, hidden)
            if output_bias:
                self.linear2_bias = _param(output_size)
            self.act = get_activation(cfg.mlp_hidden_activation)

    def forward(self, embed: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = embed / embed.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        x = dense(x, self.linear1_weight, getattr(self, "linear1_bias", None))
        if self.hidden is not None:
            if cfg.mlp_hidden_norm:
                x = layer_norm(x, self.norm_weight, getattr(self, "norm_bias", None))
            x = self.act(x)
            x = dense(x, self.linear2_weight, getattr(self, "linear2_bias", None))
        return x.reshape(embed.shape[0], cfg.mlp_seq_len, cfg.hidden_dim)


class TransformerLayer(nn.Module):
    """One pre/post-LN encoder layer with optional ReZero (nn.TransformerEncoderLayer
    semantics), in its prefill and KV-cached decode forms."""

    def __init__(self, cfg: DecoderModelConfig):
        super().__init__()
        self.cfg = cfg
        E, FF = cfg.hidden_dim, cfg.feedfwd_dim
        bias = cfg.layer_bias
        self.self_attn_in_proj_weight = _param(3 * E, E)
        self.self_attn_out_proj_weight = _param(E, E)
        self.linear1_weight = _param(FF, E)
        self.linear2_weight = _param(E, FF)
        self.norm1_weight = _param(E)
        self.norm2_weight = _param(E)
        if bias:
            self.self_attn_in_proj_bias = _param(3 * E)
            self.self_attn_out_proj_bias = _param(E)
            self.linear1_bias = _param(FF)
            self.linear2_bias = _param(E)
            self.norm1_bias = _param(E)
            self.norm2_bias = _param(E)
        if cfg.init_rezero_mode == "perskip":
            self.scale1, self.scale2 = _param(()), _param(())
        elif cfg.init_rezero_mode == "perlayer":
            self.scale1 = _param(())
        elif cfg.init_rezero_mode != "none":
            raise ValueError(f"Invalid ReZero specification: {cfg.init_rezero_mode}")
        self.act = get_activation(cfg.layer_activation)

    def _b(self, name: str) -> Optional[torch.Tensor]:
        return getattr(self, name, None)

    def _scale(self, which: int) -> Optional[torch.Tensor]:
        if self.cfg.init_rezero_mode == "perlayer":
            return self.scale1
        return self._b(f"scale{which}")

    def _norm(self, x, which: int):
        return layer_norm(x, getattr(self, f"norm{which}_weight"), self._b(f"norm{which}_bias"))

    def _qkv(self, x: torch.Tensor):
        cfg = self.cfg
        qkv = dense(x, self.self_attn_in_proj_weight, self._b("self_attn_in_proj_bias"))
        q, k, v = qkv.chunk(3, dim=-1)
        shape = (x.shape[0], x.shape[1], cfg.num_heads, cfg.head_dim)
        return q.reshape(shape), k.reshape(shape), v.reshape(shape)

    def _attend(self, q, k, v, attn_bias):
        """q, k, v (B, S[q|k], H, hd); attn_bias additive, broadcastable to (Sq, Sk)."""
        scale = 1.0 / math.sqrt(self.cfg.head_dim)
        scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k) + attn_bias
        attn = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return out.reshape(out.shape[0], out.shape[1], self.cfg.hidden_dim)

    def _ff_block(self, x):
        h = self.act(dense(x, self.linear1_weight, self._b("linear1_bias")))
        h = dense(h, self.linear2_weight, self._b("linear2_bias"))
        scale2 = self._scale(2)
        return h if scale2 is None else h * scale2

    def _finish(self, x, attn_out):
        """Residual + feed-forward after the attention output projection."""
        out = dense(attn_out, self.self_attn_out_proj_weight, self._b("self_attn_out_proj_bias"))
        scale1 = self._scale(1)
        if scale1 is not None:
            out = out * scale1
        if self.cfg.layer_norm_first:
            x = x + out
            return x + self._ff_block(self._norm(x, 2))
        x = self._norm(x + out, 1)
        return self._norm(x + self._ff_block(x), 2)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward (no cache)."""
        h = self._norm(x, 1) if self.cfg.layer_norm_first else x
        q, k, v = self._qkv(h)
        return self._finish(x, self._attend(q, k, v, attn_bias))

    def prefill(self, x, attn_bias, k_cache, v_cache):
        """Multi-token forward that also fills the KV cache at positions [0, S)."""
        S = x.shape[1]
        h = self._norm(x, 1) if self.cfg.layer_norm_first else x
        q, k_new, v_new = self._qkv(h)
        k_cache[:, :S] = k_new.to(k_cache.dtype)
        v_cache[:, :S] = v_new.to(v_cache.dtype)
        out = self._attend(q, k_new, v_new, attn_bias[:S, :S])
        return self._finish(x, out), k_cache, v_cache

    def step_lazy(self, x, pk, pv, tk, tv, anc_bias, step: int):
        """Lazy-cache beam step: the token caches are never reordered.

        x (B,1,E) with B = Bb*R; pk/pv (Bb,P,H,hd) frozen shared prefix; tk/tv
        (B,G,H,hd) slot-stationary token caches, written at slot step-1;
        anc_bias (Bb,R,1,R*G) additive bias selecting each candidate's history
        (slot k = r*G + g)."""
        cfg = self.cfg
        h = self._norm(x, 1) if cfg.layer_norm_first else x
        q, k_new, v_new = self._qkv(h)  # (B,1,H,hd)
        tk[:, step - 1] = k_new[:, 0].to(tk.dtype)
        tv[:, step - 1] = v_new[:, 0].to(tv.dtype)
        B = x.shape[0]
        Bb, P = pk.shape[0], pk.shape[1]
        R, G = B // Bb, tk.shape[1]
        H, hd = cfg.num_heads, cfg.head_dim
        qs = (q * (1.0 / math.sqrt(hd))).reshape(Bb, R, H, hd)
        sp = torch.einsum("brhd,bphd->brhp", qs, pk.float())
        st = torch.einsum("brhd,bkhd->brhk", qs, tk.float().reshape(Bb, R * G, H, hd))
        st = st + anc_bias  # broadcast over the head axis
        attn = torch.softmax(torch.cat([sp, st], dim=-1), dim=-1)  # (Bb,R,H,P+R*G)
        out_p = torch.einsum("brhp,bphd->brhd", attn[..., :P], pv.float())
        out_t = torch.einsum("brhk,bkhd->brhd", attn[..., P:],
                             tv.float().reshape(Bb, R * G, H, hd))
        out = (out_p + out_t).reshape(B, 1, cfg.hidden_dim)
        return self._finish(x, out), tk, tv


class Transformer(nn.Module):
    """Encoder stack + optional final norm; layers are named layers_{i}."""

    def __init__(self, cfg: DecoderModelConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_layers):
            setattr(self, f"layers_{i}", TransformerLayer(cfg))
        if cfg.layer_norm_first:
            self.norm_weight = _param(cfg.hidden_dim)
            if cfg.layer_bias:
                self.norm_bias = _param(cfg.hidden_dim)

    @property
    def layers(self) -> list:
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.num_layers)]

    def _final_norm(self, x):
        if self.cfg.layer_norm_first:
            return layer_norm(x, self.norm_weight, getattr(self, "norm_bias", None))
        return x

    def forward(self, x, attn_bias):
        for layer in self.layers:
            x = layer(x, attn_bias)
        return self._final_norm(x)

    def prefill(self, x, attn_bias, k_caches, v_caches):
        for i, layer in enumerate(self.layers):
            x, k_caches[i], v_caches[i] = layer.prefill(x, attn_bias, k_caches[i], v_caches[i])
        return self._final_norm(x), k_caches, v_caches

    def step_lazy(self, x, pk_caches, pv_caches, tk_caches, tv_caches, anc_bias, step: int):
        for i, layer in enumerate(self.layers):
            x, tk_caches[i], tv_caches[i] = layer.step_lazy(
                x, pk_caches[i], pv_caches[i], tk_caches[i], tv_caches[i], anc_bias, step)
        return self._final_norm(x), tk_caches, tv_caches
