"""Decoder building blocks (the counterpart of novic_tpu.models.layers): the
full-sequence training forward with its dropout sites, and the prefill and
KV-cached decode forms that serving uses.

Weights are torch layout (out, in) with the JAX package's parameter names, so
a flattened flax tree is the state dict. Matmuls are exact float32 (TF32 off).
`init_random` draws every parameter from the same distribution as the flax
initialisers, from an explicit generator (equal in distribution, not in value).

Dropout (FastDropout) draws each site's mask from the counter-based dropout
kernel (ops/dropout.py) on CUDA, and from its plain version on the CPU. Its two
seed words come from a CPU torch.Generator that the caller passes down, so no
site touches device RNG state or synchronises.

The KV-cached paths update the cache tensors in place (the JAX package returns
new arrays); they still return the caches so callers read alike.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from novic_tpu_torch.models.config import DecoderModelConfig, activation_gain, get_activation
from novic_tpu_torch.ops.dropout import draw_seed, dropout

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


def slot_bias(slots: int, last: int, device) -> torch.Tensor:
    """(1, slots) additive bias: 0 at slots <= last, NEG_INF after."""
    return torch.where(torch.arange(slots, device=device)[None, :] <= last, 0.0, NEG_INF)


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape))


DROPOUT_IMPLS = ("auto", "pallas", "threefry")


class FastDropout(nn.Module):
    """Dropout site (the counterpart of novic_tpu.models.layers.FastDropout).

    Every `impl` the JAX package accepts ('auto', 'threefry', 'pallas') takes
    the same mask source here: the dropout kernel on a CUDA tensor, its plain
    version on a CPU tensor. Identity when deterministic or rate <= 0. The
    rate is an attribute so a trainer can rescale it in place."""

    def __init__(self, rate: float, impl: str = "auto"):
        super().__init__()
        if impl not in DROPOUT_IMPLS:
            raise ValueError(f"Unknown dropout impl: {impl}")
        self.rate = rate
        self.impl = impl

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if deterministic or self.rate <= 0.0:
            return x
        if generator is None:
            raise ValueError("FastDropout needs a CPU generator for its seeds when not deterministic")
        return dropout(x.contiguous(), draw_seed(generator), self.rate)

    def extra_repr(self) -> str:
        return f"rate={self.rate}, impl={self.impl}"


def normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    p.copy_(torch.randn(p.shape, generator=generator) * std)


def uniform_(p: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    """U(-bound, bound): torch.nn.Linear's default kaiming-uniform(a=sqrt(5)) for
    bound = 1/sqrt(fan_in), xavier-uniform for bound = sqrt(6/(fan_in+fan_out))."""
    p.copy_((torch.rand(p.shape, generator=generator) * 2.0 - 1.0) * bound)


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
        self.output_bias = output_bias

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        """The flax EmbeddingVectorMLP initialisers (ref embedding_decoder.py:203-226)."""
        cfg = self.cfg
        output_size = cfg.mlp_seq_len * cfg.hidden_dim
        if cfg.init_mlp_mode == "default":
            balanced = None
        elif cfg.init_mlp_mode == "balanced":
            balanced = 1.0 if self.output_bias else 1.0 / math.sqrt(2)
        else:
            raise ValueError(f"Unrecognised MLP initialisation mode: {cfg.init_mlp_mode}")

        def w_init(p, std, fan_in):
            if std is None:
                uniform_(p, 1.0 / math.sqrt(fan_in), generator)
            else:
                normal_(p, std, generator)

        for name, p in self.named_parameters():
            if name.endswith("_bias"):
                p.zero_()
        if self.hidden is None:
            if balanced is None:
                std = None
            else:
                std = balanced / math.sqrt(cfg.hidden_dim) if cfg.init_mlp_unit_norm else balanced
            w_init(self.linear1_weight, std, cfg.embed_dim)
            return
        gain = activation_gain(cfg.mlp_hidden_activation, unit_std=not cfg.init_mlp_unit_norm)
        if balanced is not None:
            out_norm = balanced if cfg.init_mlp_unit_norm else balanced * math.sqrt(cfg.hidden_dim)
            hidden_std = (out_norm / gain) * math.sqrt(cfg.mlp_seq_len / self.hidden)
        elif cfg.init_mlp_unit_norm:
            hidden_std = math.sqrt(cfg.mlp_seq_len / self.hidden)
        else:
            hidden_std = 1.0
        w_init(self.linear1_weight, hidden_std if balanced is not None else None, cfg.embed_dim)
        if cfg.mlp_hidden_norm:
            self.norm_weight.fill_(hidden_std)
        w_init(self.linear2_weight, 1.0 / math.sqrt(output_size), self.hidden)

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
    semantics): the full-sequence form with its four dropout sites (attention
    probabilities, dropout1 after the output projection, ff_dropout after the
    feed-forward activation, dropout2 after linear2), and the prefill and
    KV-cached decode forms, which never drop."""

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
        self.attn_dropout = FastDropout(cfg.layer_dropout, cfg.dropout_impl)
        self.dropout1 = FastDropout(cfg.layer_dropout, cfg.dropout_impl)
        self.ff_dropout = FastDropout(cfg.layer_dropout, cfg.dropout_impl)
        self.dropout2 = FastDropout(cfg.layer_dropout, cfg.dropout_impl)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator, postnorm_override: Optional[float] = None
                    ) -> None:
        """The flax TransformerLayer.setup initialisers (ref embedding_decoder.py:280-409);
        post-LN gives the last layer's norm2 the postnorm scale."""
        cfg = self.cfg
        E, FF = cfg.hidden_dim, cfg.feedfwd_dim
        factor = 1.0 / math.sqrt(E)
        nominal_std = factor if cfg.init_tfrm_unit_norm else 1.0
        gain = activation_gain(cfg.layer_activation,
                               unit_std=not (cfg.init_tfrm_unit_norm or cfg.init_zero_norm))
        init_norm_scale = 0.0 if cfg.init_zero_norm else nominal_std
        if cfg.init_tfrm_mode == "default":
            uniform_(self.self_attn_in_proj_weight, math.sqrt(6.0 / (E + 3 * E)), generator)
            uniform_(self.self_attn_out_proj_weight, 1.0 / math.sqrt(E), generator)
            uniform_(self.linear1_weight, 1.0 / math.sqrt(E), generator)
            uniform_(self.linear2_weight, 1.0 / math.sqrt(FF), generator)
        else:
            if cfg.init_tfrm_mode == "open":
                std_in, std_out = factor, factor
                std_ff1, std_ff2 = factor / math.sqrt(2), factor
            elif cfg.init_tfrm_mode == "balanced":
                d = max(cfg.mlp_seq_len, 1)
                attn_scale = math.sqrt((1 + (nominal_std ** 4) * (d - 1) / d) / d)
                std_in, std_out = factor, factor / attn_scale
                std_ff1, std_ff2 = factor, 1.0 / (math.sqrt(FF) * gain)
            else:
                raise ValueError(f"Unrecognised transformer initialisation mode: {cfg.init_tfrm_mode}")
            if cfg.init_tfrm_proj_layers:
                num_layers_factor = 1.0 / math.sqrt(2 * cfg.num_layers)
                std_out *= num_layers_factor
                std_ff2 *= num_layers_factor
            s = 1.0 / math.sqrt(2) if (cfg.layer_bias and not cfg.init_bias_zero) else 1.0
            normal_(self.self_attn_in_proj_weight, std_in * s, generator)
            normal_(self.self_attn_out_proj_weight, std_out * s, generator)
            normal_(self.linear1_weight, std_ff1 * s, generator)
            normal_(self.linear2_weight, std_ff2 * s, generator)
        self.norm1_weight.fill_(init_norm_scale)
        self.norm2_weight.fill_(init_norm_scale if postnorm_override is None else postnorm_override)
        for name, p in self.named_parameters():
            if name.endswith("_bias") or name.startswith("scale"):
                p.zero_()

    def set_dropout(self, rate: float) -> None:
        for site in (self.attn_dropout, self.dropout1, self.ff_dropout, self.dropout2):
            site.rate = rate

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

    def _attend(self, q, k, v, attn_bias, deterministic: bool = True, generator=None):
        """q, k, v (B, S[q|k], H, hd); attn_bias additive, broadcastable to (Sq, Sk)."""
        scale = 1.0 / math.sqrt(self.cfg.head_dim)
        scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k) + attn_bias
        attn = torch.softmax(scores, dim=-1)
        attn = self.attn_dropout(attn, deterministic, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return out.reshape(out.shape[0], out.shape[1], self.cfg.hidden_dim)

    def _ff_block(self, x, deterministic: bool = True, generator=None):
        h = self.act(dense(x, self.linear1_weight, self._b("linear1_bias")))
        h = self.ff_dropout(h, deterministic, generator)
        h = dense(h, self.linear2_weight, self._b("linear2_bias"))
        h = self.dropout2(h, deterministic, generator)
        scale2 = self._scale(2)
        return h if scale2 is None else h * scale2

    def _finish(self, x, attn_out, deterministic: bool = True, generator=None):
        """Output projection, residual and feed-forward after the attention."""
        out = dense(attn_out, self.self_attn_out_proj_weight, self._b("self_attn_out_proj_bias"))
        out = self.dropout1(out, deterministic, generator)
        scale1 = self._scale(1)
        if scale1 is not None:
            out = out * scale1
        if self.cfg.layer_norm_first:
            x = x + out
            return x + self._ff_block(self._norm(x, 2), deterministic, generator)
        x = self._norm(x + out, 1)
        return self._norm(x + self._ff_block(x, deterministic, generator), 2)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Full-sequence forward (no cache); drops at its four sites unless deterministic."""
        h = self._norm(x, 1) if self.cfg.layer_norm_first else x
        q, k, v = self._qkv(h)
        return self._finish(x, self._attend(q, k, v, attn_bias, deterministic, generator),
                            deterministic, generator)

    def prefill(self, x, attn_bias, k_cache, v_cache):
        """Multi-token forward that also fills the KV cache at positions [0, S)."""
        S = x.shape[1]
        h = self._norm(x, 1) if self.cfg.layer_norm_first else x
        q, k_new, v_new = self._qkv(h)
        k_cache[:, :S] = k_new.to(k_cache.dtype)
        v_cache[:, :S] = v_new.to(v_cache.dtype)
        out = self._attend(q, k_new, v_new, attn_bias[:S, :S])
        return self._finish(x, out), k_cache, v_cache

    def step(self, x, k_cache, v_cache, pos: int, key_bias: Optional[torch.Tensor] = None):
        """KV-cached single-token step (greedy decode): x (B,1,E) at sequence
        position pos; caches (B,Smax,H,hd), written at pos; key_bias (1,Smax)
        additive (0 at keys <= pos), computed here when not given."""
        h = self._norm(x, 1) if self.cfg.layer_norm_first else x
        q, k_new, v_new = self._qkv(h)
        k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
        if key_bias is None:
            key_bias = slot_bias(k_cache.shape[1], pos, x.device)
        out = self._attend(q, k_cache.float(), v_cache.float(), key_bias)
        return self._finish(x, out), k_cache, v_cache

    def step_split(self, x, pk, pv, tk, tv, step: int, token_bias: Optional[torch.Tensor] = None):
        """Split-cache step (reorder-mode beam): the candidates' token caches were
        permuted before the step, so each candidate attends over its own rows.

        x (B,1,E) with B = Bb*R; pk/pv (Bb,P,H,hd) frozen prefix shared by the R
        candidates of a sample; tk/tv (B,G,H,hd) per-candidate token caches,
        written at slot step-1; token_bias (1,G) additive (0 at slots <= step-1),
        computed here when not given."""
        cfg = self.cfg
        h = self._norm(x, 1) if cfg.layer_norm_first else x
        q, k_new, v_new = self._qkv(h)  # (B,1,H,hd)
        tk[:, step - 1] = k_new[:, 0].to(tk.dtype)
        tv[:, step - 1] = v_new[:, 0].to(tv.dtype)
        B = x.shape[0]
        Bb, P = pk.shape[0], pk.shape[1]
        R, G = B // Bb, tk.shape[1]
        H, hd = cfg.num_heads, cfg.head_dim
        if token_bias is None:
            token_bias = slot_bias(G, step - 1, x.device)
        qs = (q * (1.0 / math.sqrt(hd))).reshape(B, H, hd)
        sp = torch.einsum("brhd,bphd->brhp", qs.reshape(Bb, R, H, hd), pk.float()).reshape(B, H, P)
        st = torch.einsum("bhd,bkhd->bhk", qs, tk.float()) + token_bias
        attn = torch.softmax(torch.cat([sp, st], dim=-1), dim=-1)  # (B,H,P+G)
        out_p = torch.einsum("brhp,bphd->brhd", attn[..., :P].reshape(Bb, R, H, P),
                             pv.float()).reshape(B, H, hd)
        out_t = torch.einsum("bhk,bkhd->bhd", attn[..., P:], tv.float())
        out = (out_p + out_t).reshape(B, 1, cfg.hidden_dim)
        return self._finish(x, out), tk, tv

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

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        postnorm_scale = 1.0 / math.sqrt(cfg.hidden_dim) if cfg.init_tfrm_unit_postnorm else 1.0
        for i, layer in enumerate(self.layers):
            last_post_ln = not cfg.layer_norm_first and i == cfg.num_layers - 1
            layer.init_random(generator, postnorm_scale if last_post_ln else None)
        if cfg.layer_norm_first:
            self.norm_weight.fill_(postnorm_scale)
            if cfg.layer_bias:
                self.norm_bias.zero_()

    @property
    def layers(self) -> list:
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.num_layers)]

    def _final_norm(self, x):
        if self.cfg.layer_norm_first:
            return layer_norm(x, self.norm_weight, getattr(self, "norm_bias", None))
        return x

    def forward(self, x, attn_bias, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        for layer in self.layers:
            x = layer(x, attn_bias, deterministic, generator)
        return self._final_norm(x)

    def prefill(self, x, attn_bias, k_caches, v_caches):
        for i, layer in enumerate(self.layers):
            x, k_caches[i], v_caches[i] = layer.prefill(x, attn_bias, k_caches[i], v_caches[i])
        return self._final_norm(x), k_caches, v_caches

    def step(self, x, k_caches, v_caches, pos: int):
        key_bias = slot_bias(k_caches[0].shape[1], pos, x.device)
        for i, layer in enumerate(self.layers):
            x, k_caches[i], v_caches[i] = layer.step(x, k_caches[i], v_caches[i], pos, key_bias)
        return self._final_norm(x), k_caches, v_caches

    def step_split(self, x, pk_caches, pv_caches, tk_caches, tv_caches, step: int):
        token_bias = slot_bias(tk_caches[0].shape[1], step - 1, x.device)
        for i, layer in enumerate(self.layers):
            x, tk_caches[i], tv_caches[i] = layer.step_split(
                x, pk_caches[i], pv_caches[i], tk_caches[i], tv_caches[i], step, token_bias)
        return self._final_norm(x), tk_caches, tv_caches

    def step_lazy(self, x, pk_caches, pv_caches, tk_caches, tv_caches, anc_bias, step: int):
        for i, layer in enumerate(self.layers):
            x, tk_caches[i], tv_caches[i] = layer.step_lazy(
                x, pk_caches[i], pv_caches[i], tk_caches[i], tv_caches[i], anc_bias, step)
        return self._final_norm(x), tk_caches, tv_caches
