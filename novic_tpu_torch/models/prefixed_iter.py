"""PrefixedIterDecoder, inference forms (the counterpart of
novic_tpu.models.prefixed_iter).

Decoder-only causal transformer whose first P sequence positions are an MLP
projection of the embedding vector; token embeddings are weight-tied to the
logits linear. This module serves generation: prefill into split caches and
the lazy-cache beam step.
"""

from __future__ import annotations

import torch
from torch import nn

from novic_tpu_torch.device import dtype_of
from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.models.layers import EmbeddingVectorMLP, Transformer, causality_mask, dense

class PrefixedIterDecoder(nn.Module):

    def __init__(self, cfg: DecoderModelConfig):
        super().__init__()
        self.cfg = cfg
        Q, E = cfg.vocab_size_quant, cfg.hidden_dim
        self.embed_mlp = EmbeddingVectorMLP(cfg, output_bias=False)
        self.logits_weight = nn.Parameter(torch.zeros(Q, E), requires_grad=False)
        if cfg.logits_bias:
            self.logits_bias = nn.Parameter(torch.zeros(Q), requires_grad=False)
        if not cfg.weight_tying:
            self.token_embedding = nn.Parameter(torch.zeros(Q, E), requires_grad=False)
        self.pos_embedding = nn.Parameter(torch.zeros(cfg.max_seq_len, E), requires_grad=False)
        self.transformer = Transformer(cfg)
        self.register_buffer("causality_bias", causality_mask(
            cfg.max_seq_len, cfg.mlp_seq_len, cfg.strictly_causal), persistent=False)

    @property
    def cache_dtype(self) -> torch.dtype:
        return dtype_of(self.cfg.compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.logits_weight.device

    def embed_tokens(self, token_ids: torch.Tensor) -> torch.Tensor:
        table = getattr(self, "token_embedding", self.logits_weight)
        return table[token_ids]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        out = dense(x, self.logits_weight, getattr(self, "logits_bias", None))
        if self.cfg.vocab_quant:
            out = out[..., : self.cfg.vocab_size]
        return out

    def prefill(self, embed: torch.Tensor, k_caches, v_caches):
        """Run the P prefix positions, fill the caches, return first-step logits (B,V)."""
        cfg = self.cfg
        x = self.embed_mlp(embed) + self.pos_embedding[: cfg.mlp_seq_len]
        x, k_caches, v_caches = self.transformer.prefill(x, self.causality_bias, k_caches, v_caches)
        return self.logits(x[:, -1, :]), k_caches, v_caches

    def _caches(self, batch: int, slots: int):
        cfg = self.cfg
        shape = (batch, slots, cfg.num_heads, cfg.head_dim)
        make = lambda: [torch.zeros(shape, dtype=self.cache_dtype, device=self.device)
                        for _ in range(cfg.num_layers)]
        return make(), make()

    def init_token_cache(self, batch: int):
        """Token-slot caches (G = token_length-1 slots) for the split-cache decode."""
        return self._caches(batch, self.cfg.token_length - 1)

    def prefill_split(self, embed: torch.Tensor):
        """Prefill at base-batch rows, returning prefix-only caches (B,P,H,hd)."""
        pk, pv = self._caches(embed.shape[0], self.cfg.mlp_seq_len)
        return self.prefill(embed, pk, pv)

    def decode_step_lazy(self, token_ids: torch.Tensor, step: int, pk_caches, pv_caches,
                         tk_caches, tv_caches, anc_bias: torch.Tensor):
        """Lazy-cache beam decode step (TransformerLayer.step_lazy): the token chosen
        at step-1 feeds position P+step-1; returns logits for the token at `step`."""
        pos = self.cfg.mlp_seq_len + step - 1
        x = self.embed_tokens(token_ids)[:, None, :] + self.pos_embedding[pos][None, None, :]
        x, tk_caches, tv_caches = self.transformer.step_lazy(
            x, pk_caches, pv_caches, tk_caches, tv_caches, anc_bias, step)
        return self.logits(x[:, 0, :]), tk_caches, tv_caches
