"""Decoder model registry and construction helpers (the counterpart of
novic_tpu.models.base).

`create_decoder` builds the module on an explicit device with its parameters
drawn from an explicit generator, in the same distributions as the flax
initialisers of the JAX package (equal in distribution, not in value).
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from novic_tpu_torch.device import resolve
from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.models.dud import DudDecoder
from novic_tpu_torch.models.prefixed_iter import PrefixedIterDecoder
from novic_tpu_torch.utils.logger import log


DECODER_REGISTRY: dict[str, Any] = {
    "PrefixedIterDecoder": PrefixedIterDecoder,
    "DudDecoder": DudDecoder,
}


def decoder_class(name: str):
    try:
        return DECODER_REGISTRY[name]
    except KeyError:
        raise ValueError(f"Unsupported decoder model class: {name}") from None


def _unused(cfg: DecoderModelConfig) -> int:
    if not cfg.vocab_quant:
        return 0
    rows = cfg.vocab_size_quant - cfg.vocab_size
    return rows * cfg.hidden_dim * (1 if cfg.weight_tying else 2) + (rows if cfg.logits_bias else 0)


def create_decoder(cfg: DecoderModelConfig, *, generator: Optional[torch.Generator] = None,
                   device: Union[str, torch.device] = "cuda", target_tokenizer=None
                   ) -> Union[PrefixedIterDecoder, DudDecoder]:
    """The decoder for `cfg`, randomly initialised from `generator` (a CPU
    generator; seed 0 if None) and moved to `device`. A DudDecoder needs
    `target_tokenizer` to tokenize its constant noun."""
    cls = decoder_class(cfg.model)
    dev = resolve(device)
    if cls is DudDecoder:
        if target_tokenizer is None:
            raise ValueError("DudDecoder requires a target tokenizer")
        dud_target, dud_padding = target_tokenizer.tokenize_target("unknown")
        if (dud_target < 0).any():
            dud_target, dud_padding = target_tokenizer.tokenize_target("")
        if dud_padding is None:
            dud_padding = np.zeros_like(dud_target, dtype=bool)
        # The constant noun is used at its own length: trim the padding columns
        keep = int((~dud_padding[0]).sum())
        return DudDecoder(cfg, dud_target[:, :keep], dud_padding[:, :keep], device=dev)
    model = cls(cfg)
    model.init_random(generator if generator is not None else torch.Generator().manual_seed(0))
    n_params = count_params(model, cfg)
    unused = n_params["unused"]
    log.info(f"Created {cfg.model}: {n_params['used']} params"
             f"{f' + {unused} unused' if unused else ''}")
    return model.to(dev)


def verify_unused(model: torch.nn.Module, cfg: DecoderModelConfig) -> None:
    """Raise unless the vocab-quantised unused rows are still zero (ref
    embedding_decoder.py:437-441 state-dict hooks)."""
    if not cfg.vocab_quant or cfg.vocab_size_quant == cfg.vocab_size:
        return
    for name in ("logits_weight", "logits_bias", "token_embedding"):
        p = getattr(model, name, None)
        if p is not None and bool((p.detach()[cfg.vocab_size:] != 0).any()):
            raise ValueError(f"Unexpected values in the unused portion of {name} "
                             f"(vocab quantization invariant violated)")


def count_params(model: torch.nn.Module, cfg: Optional[DecoderModelConfig] = None
                 ) -> dict[str, int]:
    """Parameter count report (ref embedding_decoder.py:1304-1347 ParamCount)."""
    total = sum(p.numel() for p in model.parameters())
    unused = _unused(cfg) if cfg is not None else 0
    return {"total": total, "used": total - unused, "unused": unused}
