"""DudDecoder (the counterpart of novic_tpu.models.dud): the cheating baseline for
metric upper bounds and pipeline checks.

Its forward "predicts" the target it was given (with the multi-target dedup
priority, so the most-weighted shared-prefix continuation wins); the generate
methods emit a constant noun, the tokenization of "unknown" (or of "" where
"unknown" cannot be encoded; models.base.create_decoder). It has no parameters:
an object on an explicit device, not an nn.Module.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from novic_tpu_torch.device import resolve
from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.models.layers import NEG_INF
from novic_tpu_torch.models.prefixed_iter import cross_entropy_elems, expand_target_padding


class DudDecoder:

    @staticmethod
    def get_target_config_kwargs(**target_kwargs) -> dict[str, Any]:
        return target_kwargs

    @staticmethod
    def get_data_config_kwargs(**data_kwargs) -> dict[str, Any]:
        return data_kwargs

    def __init__(self, cfg: DecoderModelConfig, dud_target: np.ndarray,
                 dud_target_padding: np.ndarray, device: Union[str, torch.device] = "cuda"):
        """dud_target (1, Cd): the constant noun's tokens, without padding."""
        dud_target, dud_target_padding = np.asarray(dud_target), np.asarray(dud_target_padding)
        if dud_target.ndim != 2 or dud_target.shape[0] != 1 or dud_target.shape[1] < 1:
            raise ValueError(f"dud_target must be (1, C >= 1), got {dud_target.shape}")
        if dud_target_padding.any():
            raise ValueError("dud_target must carry no padding")
        self.cfg = cfg
        self.device = resolve(device)
        self.dud_target = torch.from_numpy(dud_target.astype(np.int32)).to(self.device)
        self.dud_target_padding = torch.from_numpy(dud_target_padding.astype(bool)).to(self.device)

    # ------------------------------------------------------------------ forward

    def __call__(self, embed, target, target_padding=None, target_weight=None, *,
                 calc_loss=False, calc_correct=False, only_pred=False, guide_targets=None,
                 multi_first=False):
        """(one-hot logits, target_padding, loss_sum, loss_basis, correct), the
        PrefixedIterDecoder forward's contract; target (..., C) token ids."""
        if target is None:
            raise ValueError(f"{type(self).__name__} can only cheat, so it requires targets")
        Z = target.shape[:-1]
        V = self.cfg.vocab_size

        if target_weight is not None:
            zero_w = (target_weight == 0)[..., None]
            if target_padding is None:
                target_padding = zero_w.expand(target.shape)
            else:
                target_padding = target_padding | zero_w

        if target_padding is not None and self.cfg.num_end_loss > 1:
            # The dud's padding expands with P=1
            target_padding = expand_target_padding(target_padding, 1, self.cfg.num_end_loss)

        target_pred = target
        if len(Z) > 1:
            target_pred = self._dedup_multi(target, target_padding, target_weight, multi_first)

        x = torch.zeros(target_pred.shape + (V,), dtype=torch.float32, device=target.device)
        x.scatter_(-1, target_pred[..., None].long(), 1.0)

        if only_pred:
            target_pred = target_pred[..., -1:]
            x = x[..., -1:, :]
            target = target[..., -1:]
            if target_padding is not None:
                target_padding = target_padding[..., -1:]

        one = torch.tensor(1.0, device=target.device)
        loss_sum = loss_basis = one if calc_loss else None

        correct = None
        if calc_correct:
            correct = target_pred == target
            if target_padding is not None:
                correct = correct & ~target_padding

        return x, target_padding, loss_sum, loss_basis, correct

    def _dedup_multi(self, target, target_padding, target_weight, multi_first):
        """Multi-target dedup priority, over a BxMxC layout: each group of
        prefix-equal targets predicts the (weight-)majority continuation."""
        V = self.cfg.vocab_size
        if multi_first:  # MxBxC -> BxMxC
            target = target.transpose(0, 1)
            if target_padding is not None:
                target_padding = target_padding.transpose(0, 1)
            if target_weight is not None:
                target_weight = target_weight.transpose(0, 1)
        B, M, C = target.shape
        target_pred = target.clone()

        for m in range(M - 1):
            R = M - m
            t_slice = target[:, m:, :]        # BxRxC
            p_slice = target_pred[:, m:, :]   # BxRxC
            eq = (t_slice[:, :1, :-1] == t_slice[:, :, :-1]).to(torch.int32)
            eq = torch.cumprod(eq, dim=-1).bool()  # prefix equality
            equiv = torch.cat([torch.ones((B, R, 1), dtype=torch.bool, device=target.device), eq],
                              dim=-1)
            if target_padding is not None:
                equiv = equiv & ~target_padding[:, m:, :]
            idx = torch.where(equiv, p_slice, V).long()  # masked -> overflow bucket
            if target_weight is None:
                src = torch.ones(idx.shape, dtype=torch.float32, device=target.device)
            else:
                src = target_weight[:, m:, None].float().expand(idx.shape)
            prio = torch.zeros((B, V + 1, C), dtype=torch.float32, device=target.device)
            prio.scatter_add_(1, idx, src)
            best = prio[:, :V, :].argmax(dim=1)  # BxC, the first maximum as jnp.argmax
            target_pred[:, m:, :] = torch.where(equiv, best[:, None, :].to(target_pred.dtype),
                                                p_slice)

        if multi_first:
            target_pred = target_pred.transpose(0, 1)
        return target_pred

    # ----------------------------------------------------------------- generate

    def generate(self, embed, *, collect_logits=False, calc_loss=False, temperature=1.0,
                 length_alpha=0.0, sample_weight=None, guide_targets=None, guide_renorm=False):
        B = embed.shape[0]
        C = self.dud_target.shape[1]
        V = self.cfg.vocab_size
        target = self.dud_target.expand(B, C)
        target_padding = self.dud_target_padding.expand(B, C)
        seq_logits = None
        if collect_logits or calc_loss:
            seq_logits = torch.zeros((B, C, V), dtype=torch.float32, device=self.device)
            seq_logits.scatter_(2, target[:, :, None].long(), 1.0)
        loss_sum = loss_basis = target_score = None
        if calc_loss:
            e = torch.exp(seq_logits / temperature)
            logp = torch.log(e / e.sum(dim=2, keepdim=True))
            target_score = torch.gather(logp, 2, target[:, :, None].long())[:, :, 0].sum(dim=1)
            if length_alpha != 0:
                target_score = target_score * (C ** -length_alpha)
            elems = cross_entropy_elems(seq_logits, target, self.cfg.label_smoothing)
            loss_sum = elems.sum()
            loss_basis = torch.tensor(float(target.numel()), device=self.device)
        return target, target_padding, seq_logits, loss_sum, loss_basis, target_score

    def _constant_topk(self, B: int, H: int, C: int):
        Cd = self.dud_target.shape[1]
        target = torch.zeros((B, H, C), dtype=torch.int32, device=self.device)
        target[:, 0, :Cd] = self.dud_target[0]
        padding = torch.ones((B, H, C), dtype=torch.bool, device=self.device)
        padding[:, 0, :Cd] = self.dud_target_padding[0]
        score = torch.full((B, H), NEG_INF, dtype=torch.float32, device=self.device)
        score[:, 0] = -1.0
        return target, padding, score

    def generate_beam(self, embed, *, topk, temperature=1.0, length_alpha=0.0,
                      vocab_targets=None, vocab_per_token=False, vocab_scaler=0.0,
                      guide_targets=None, guide_renorm=False):
        return self._constant_topk(embed.shape[0], topk, self.dud_target.shape[1])

    def precompute_generate_all(self, **kwargs):
        return None

    def generate_all(self, embed, *, topk, guide_targets, precompute=None, **kwargs):
        return self._constant_topk(embed.shape[0], topk, guide_targets.shape[1])
