"""PrefixedIterDecoder (the counterpart of novic_tpu.models.prefixed_iter).

Decoder-only causal transformer whose first P sequence positions are an MLP
projection of the (noised) embedding vector; token embeddings are weight-tied
to the logits linear, so autograd sums the gradients of both uses into
`logits_weight`. The training forward (`forward`) has the reference contract:
loss sum/basis decomposition, num_end_loss padding expansion, weighted CE with
ignore_index=-1 and label smoothing, guide-restricted argmax correctness, and
the BxMxC / MxBxC multi-target reshapes. Generation prefills either split
caches (beam search: the lazy-cache step, or the split step after the caller
permutes the token caches) or monolithic caches (greedy: the plain cached step).
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
from torch import nn

from novic_tpu_torch.device import dtype_of
from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.models.layers import (
    NEG_INF,
    EmbeddingVectorMLP,
    FastDropout,
    Transformer,
    causality_mask,
    dense,
    normal_,
)


def cross_entropy_elems(logits: torch.Tensor, targets: torch.Tensor, label_smoothing: float
                        ) -> torch.Tensor:
    """Per-element CE with ignore_index=-1 (torch F.cross_entropy semantics).

    logits (..., V); targets (...,) int with -1 = ignored (contributes 0). As
    logsumexp(logits) - logits[target], so no (..., V) log-softmax is kept."""
    valid = targets >= 0
    tsafe = targets.clamp_min(0)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, tsafe[..., None].long())[..., 0]
    loss = lse - picked
    if label_smoothing > 0.0:
        smooth = lse - logits.mean(dim=-1)
        loss = (1.0 - label_smoothing) * loss + label_smoothing * smooth
    return torch.where(valid, loss, torch.zeros((), dtype=loss.dtype, device=loss.device))


def guide_restricted_argmax(x: torch.Tensor, target: torch.Tensor, guide_targets: torch.Tensor
                            ) -> torch.Tensor:
    """Argmax restricted to tokens continuing some prefix-matching guide target
    (ref embedding_decoder.py:751-761), as a scatter-amax.

    x (A,C,V) logits; target (A,C) token ids; guide_targets (W,Cmax)."""
    A, C, V = x.shape
    gt = guide_targets.t()[:C, :].long()  # (C,W)
    ne = target[:, :C - 1, None] != gt[None, :C - 1, :]  # (A,C-1,W)
    dead = torch.cummax(ne.to(torch.int32), dim=1).values.bool()
    guide_mask = torch.cat([torch.zeros((A, 1, gt.shape[1]), dtype=torch.bool, device=x.device),
                            dead], dim=1)  # (A,C,W)
    idx = torch.where(guide_mask, V, gt[None, :, :].expand(A, C, -1))  # (A,C,W)
    base = torch.full((A, C, V + 1), NEG_INF, dtype=x.dtype, device=x.device)
    base.scatter_reduce_(2, idx, torch.zeros(idx.shape, dtype=x.dtype, device=x.device), "amax")
    return torch.argmax(x + base[:, :, :V], dim=2)


def expand_target_padding(target_padding: torch.Tensor, mlp_seq_len: int, num_end_loss: int
                          ) -> torch.Tensor:
    """num_end_loss > 1 padding adjustment: the AxC padding used for loss masking
    (ref embedding_decoder.py:696-709, the seq mask's last C columns)."""
    C = target_padding.shape[-1]
    padding_expand = mlp_seq_len + num_end_loss - 2  # P+N-2
    padding_keep = C - num_end_loss + 1              # C-N+1
    if padding_expand < 1:
        return target_padding
    lead_shape = target_padding.shape[:-1]
    if padding_keep <= 1:
        seq_pad = target_padding[..., 0:1].expand(*lead_shape, padding_expand + 1)
    else:
        lead = target_padding[..., 0:1].expand(*lead_shape, padding_expand)
        seq_pad = torch.cat([lead, target_padding[..., :padding_keep]], dim=-1)
    return seq_pad[..., -C:]


class PrefixedIterDecoder(nn.Module):

    # Forced target tokenization: no start token, end token = pad = 0, compact IDs
    # (ref embedding_decoder.py:619-627)
    @staticmethod
    def get_target_config_kwargs(**target_kwargs) -> dict[str, Any]:
        target_kwargs.update(with_start_token=False, with_end_token=True, compact_ids=True)
        return target_kwargs

    @staticmethod
    def get_data_config_kwargs(**data_kwargs) -> dict[str, Any]:
        return data_kwargs

    def __init__(self, cfg: DecoderModelConfig):
        super().__init__()
        self.cfg = cfg
        Q, E = cfg.vocab_size_quant, cfg.hidden_dim
        self.embed_mlp = EmbeddingVectorMLP(cfg, output_bias=False)
        self.logits_weight = nn.Parameter(torch.zeros(Q, E))
        if cfg.logits_bias:
            self.logits_bias = nn.Parameter(torch.zeros(Q))
        if not cfg.weight_tying:
            self.token_embedding = nn.Parameter(torch.zeros(Q, E))
        self.pos_embedding = nn.Parameter(torch.zeros(cfg.max_seq_len, E))
        self.input_dropout = FastDropout(cfg.input_dropout, cfg.dropout_impl)
        self.transformer = Transformer(cfg)
        self.register_buffer("causality_bias", causality_mask(
            cfg.max_seq_len, cfg.mlp_seq_len, cfg.strictly_causal), persistent=False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "PrefixedIterDecoder":
        """The flax initialisers (prefixed_iter.py setup): vocab-quantised rows past
        vocab_size start at zero."""
        cfg = self.cfg
        std = 1.0 / math.sqrt(2 * cfg.hidden_dim) if cfg.init_mlp_unit_norm else 1.0 / math.sqrt(2)
        self.embed_mlp.init_random(generator)
        normal_(self.logits_weight, std, generator)
        if cfg.logits_bias:
            if cfg.init_bias_zero:
                self.logits_bias.zero_()
            else:
                normal_(self.logits_bias,
                        std if cfg.init_tfrm_unit_postnorm else std * math.sqrt(cfg.hidden_dim),
                        generator)
        if not cfg.weight_tying:
            normal_(self.token_embedding, std, generator)
        normal_(self.pos_embedding, std, generator)
        if cfg.vocab_quant:
            for name in ("logits_weight", "logits_bias", "token_embedding"):
                if hasattr(self, name):
                    getattr(self, name)[cfg.vocab_size:] = 0.0
        self.transformer.init_random(generator)
        return self

    def set_dropout(self, input_rate: float, layer_rate: float) -> None:
        """Set every dropout site's rate (the late-dropout rescale); cfg follows."""
        self.cfg = self.cfg.replace(input_dropout=input_rate, layer_dropout=layer_rate)
        self.input_dropout.rate = input_rate
        for layer in self.transformer.layers:
            layer.set_dropout(layer_rate)

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

    def forward(
        self,
        embed: torch.Tensor,                            # BxF unit embedding vectors
        target: Optional[torch.Tensor],                 # BxC | BxMxC | MxBxC compact token ids
        target_padding: Optional[torch.Tensor] = None,  # same batch shape as target, True = ignore
        target_weight: Optional[torch.Tensor] = None,   # B | BxM | MxB loss weights
        calc_loss: bool = False,
        calc_correct: bool = False,
        only_pred: bool = False,
        guide_targets: Optional[torch.Tensor] = None,   # WxCmax
        multi_first: bool = False,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,    # CPU generator of the dropout seeds
    ):
        """Returns (logits, target_padding_out, loss_sum, loss_basis, correct) with
        the reference contract (ref embedding_decoder.py:121-141)."""
        cfg = self.cfg
        assert embed.ndim == 2
        x = self.embed_mlp(embed)  # BxPxE

        B = M = None
        if target is not None and target.ndim == 3:
            if multi_first:  # A = MB
                M, B = target.shape[:2]
                if M > 1:
                    x = x.repeat(M, 1, 1)
            else:  # A = BM
                B, M = target.shape[:2]
                if M > 1:
                    x = x.repeat_interleave(M, dim=0)
            target = target.reshape(-1, target.shape[-1])
            if target_padding is not None:
                target_padding = target_padding.reshape(-1, target_padding.shape[-1])
            if target_weight is not None:
                target_weight = target_weight.reshape(-1)

        if target is not None and target_weight is not None:
            zero_w = (target_weight == 0)[:, None]
            if target_padding is None:
                target_padding = zero_w.expand(target.shape)
            else:
                target_padding = target_padding | zero_w

        if target is not None and target.shape[1] > 1:
            tok = self.embed_tokens(target[:, :-1].long())  # Ax(C-1)xE
            x = torch.cat([x, tok], dim=1)                  # AxSxE, S = P+C-1
        S = x.shape[1]
        x = x + self.pos_embedding[:S]
        x = self.input_dropout(x, deterministic, generator)

        if target_padding is not None:
            target_padding = expand_target_padding(target_padding, cfg.mlp_seq_len, cfg.num_end_loss)

        x = self.transformer(x, self.causality_bias[:S, :S], deterministic, generator)

        if only_pred:  # T = 1
            x = x[:, -1:, :]
            if target is not None:
                target = target[:, -1:]
                if target_padding is not None:
                    target_padding = target_padding[:, -1:]
        else:  # T = C
            x = x[:, cfg.mlp_seq_len - 1:, :]

        x = self.logits(x)  # AxTxV

        loss_sum = loss_basis = correct = None
        if calc_loss or calc_correct:
            assert target is not None
            if target_padding is not None:
                target = torch.where(target_padding, -1, target)

            if calc_loss:
                elems = cross_entropy_elems(x, target, cfg.label_smoothing)  # AxT
                if target_weight is None:
                    loss_sum = elems.sum()
                    if target_padding is None:
                        loss_basis = embed.new_full((), float(target.numel()))
                    else:
                        loss_basis = (target_padding.numel() - target_padding.sum()).to(embed.dtype)
                else:
                    target_weight = target_weight.float()
                    loss_sum = torch.dot(target_weight, elems.sum(dim=1))
                    if target_padding is None:
                        loss_basis = target.shape[1] * target_weight.sum()
                    else:
                        not_pad = (target_padding.shape[1] - target_padding.sum(dim=1)).to(
                            target_weight.dtype)
                        loss_basis = torch.dot(target_weight, not_pad)

            if calc_correct:
                if guide_targets is None:
                    pred_tokens = torch.argmax(x, dim=2)
                else:
                    assert not only_pred
                    pred_tokens = guide_restricted_argmax(x, target, guide_targets)
                # For masked positions target is -1 so correct is False (argmax >= 0)
                correct = pred_tokens == target

        if M is not None:
            batch_shape = (M, B) if multi_first else (B, M)
            x = x.reshape(batch_shape + x.shape[1:])
            if target_padding is not None:
                target_padding = target_padding.reshape(batch_shape + target_padding.shape[1:])
            if correct is not None:
                correct = correct.reshape(batch_shape + correct.shape[1:])

        return x, target_padding, loss_sum, loss_basis, correct

    def prefill(self, embed: torch.Tensor, k_caches, v_caches):
        """Run the P prefix positions, fill the caches, return first-step logits (B,V)."""
        cfg = self.cfg
        x = self.embed_mlp(embed) + self.pos_embedding[: cfg.mlp_seq_len]
        x, k_caches, v_caches = self.transformer.prefill(x, self.causality_bias, k_caches, v_caches)
        return self.logits(x[:, -1, :]), k_caches, v_caches

    def _caches(self, batch: int, slots: int, dtype: Optional[torch.dtype] = None):
        cfg = self.cfg
        shape = (batch, slots, cfg.num_heads, cfg.head_dim)
        dtype = self.cache_dtype if dtype is None else dtype
        make = lambda: [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(cfg.num_layers)]
        return make(), make()

    def init_cache(self, batch: int, dtype: Optional[torch.dtype] = None):
        """Monolithic caches over all max_seq_len positions (greedy decode), in the
        compute dtype unless `dtype` is given."""
        return self._caches(batch, self.cfg.max_seq_len, dtype)

    def decode_step(self, token_ids: torch.Tensor, step: int, k_caches, v_caches):
        """One monolithic-cache decode step: the token chosen at step-1 feeds
        position P+step-1; returns logits for the token at `step` (step >= 1)."""
        pos = self.cfg.mlp_seq_len + step - 1
        x = self.embed_tokens(token_ids)[:, None, :] + self.pos_embedding[pos][None, None, :]
        x, k_caches, v_caches = self.transformer.step(x, k_caches, v_caches, pos)
        return self.logits(x[:, 0, :]), k_caches, v_caches

    def decode_step_split(self, token_ids: torch.Tensor, step: int, pk_caches, pv_caches,
                          tk_caches, tv_caches):
        """Split-cache decode step (TransformerLayer.step_split): prefix caches at
        base-batch rows (frozen), token caches at candidate rows (slot step-1
        written); the caller permutes the token caches before the step."""
        pos = self.cfg.mlp_seq_len + step - 1
        x = self.embed_tokens(token_ids)[:, None, :] + self.pos_embedding[pos][None, None, :]
        x, tk_caches, tv_caches = self.transformer.step_split(
            x, pk_caches, pv_caches, tk_caches, tv_caches, step)
        return self.logits(x[:, 0, :]), tk_caches, tv_caches

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
