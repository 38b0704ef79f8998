"""Object decoder model configuration.

The same fields and cfg JSON as novic_tpu.models.config.DecoderModelConfig, so
checkpoints written by either package load in the other.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any


@dataclasses.dataclass(frozen=True)
class DecoderModelConfig:
    # Problem geometry (derived from embedder + target config)
    embed_dim: int                     # F: input embedding vector dimension
    vocab_size: int                    # V: target (compact) vocab size
    token_length: int                  # Cmax: target token length incl. end token

    # Model class
    model: str = "PrefixedIterDecoder"

    # Loss options (ref embedding_decoder.py:48-50)
    vocab_quant: bool = False          # Round V up to a multiple of 64 with zeroed unused rows
    num_end_loss: int = 1              # Trailing end tokens included in prediction loss (>=1)
    label_smoothing: float = 0.0

    # Architecture (ref config/train.yaml:249-308 released defaults)
    hidden_dim: int = 512              # E
    feedfwd_scale: str = "1/4"         # Feedforward dim = E * scale (exact fraction)
    mlp_seq_len: int = 4               # P: number of prefix tokens from the embedding MLP
    mlp_hidden_layer: str = "none"     # none|min|max|amean|gmean
    mlp_hidden_bias: bool = False
    mlp_hidden_norm: bool = False
    mlp_hidden_activation: str = "gelu"
    input_dropout: float = 0.1
    num_layers: int = 6
    num_heads: int = 8
    layer_dropout: float = 0.1
    layer_activation: str = "gelu"
    layer_norm_first: bool = True
    layer_bias: bool = False
    logits_bias: bool = False

    # Initialisation (ref embedding_decoder.py:203-409)
    init_bias_zero: bool = True
    init_mlp_mode: str = "balanced"     # default|balanced
    init_mlp_unit_norm: bool = False
    init_tfrm_mode: str = "balanced"    # default|open|balanced
    init_tfrm_unit_norm: bool = False
    init_tfrm_unit_postnorm: bool = True
    init_tfrm_proj_layers: bool = True
    init_zero_norm: bool = False
    init_rezero_mode: str = "none"      # none|perskip|perlayer

    # PrefixedIterDecoder specifics (ref embedding_decoder.py:633-645)
    weight_tying: bool = True
    strictly_causal: bool = False

    # Compute options of the JAX package, kept so checkpoints round-trip. The
    # port reads compute_dtype (KV-cache dtype); its matmuls are always exact
    # float32 (TF32 off), whatever matmul_precision says; dropout_impl and
    # attn_impl select JAX-side formulations and are not read here.
    compute_dtype: str = "float32"
    dropout_impl: str = "auto"
    matmul_precision: str = "default"
    attn_impl: str = "auto"

    # ---------------------------------------------------------------- derived

    @property
    def feedfwd_dim(self) -> int:
        frac = Fraction(self.feedfwd_scale)
        dim = self.hidden_dim * frac
        if dim.denominator != 1:
            raise ValueError(
                f"Feedforward dimension scaler ({frac}) must yield an integral dimension "
                f"for hidden dimension {self.hidden_dim}")
        return dim.numerator

    @property
    def head_dim(self) -> int:
        assert self.hidden_dim % self.num_heads == 0
        return self.hidden_dim // self.num_heads

    @property
    def max_seq_len(self) -> int:
        # P + Cmax - 1: end token never needs a next-token prediction
        # (ref embedding_decoder.py:648)
        return self.mlp_seq_len + self.token_length - 1

    @property
    def vocab_size_quant(self) -> int:
        # Q: optionally quantized vocab size (ref embedding_decoder.py:235)
        if self.vocab_quant:
            return ((self.vocab_size + 63) // 64) * 64
        return self.vocab_size

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict[str, Any], **overrides) -> "DecoderModelConfig":
        d = {**d, **overrides}
        known = {f.name for f in dataclasses.fields(DecoderModelConfig)}
        return DecoderModelConfig(**{k: v for k, v in d.items() if k in known})

    def replace(self, **kwargs) -> "DecoderModelConfig":
        return dataclasses.replace(self, **kwargs)


def get_activation(name: str):
    import torch

    if name == "tanh":
        return torch.tanh
    if name == "relu":
        return torch.relu
    if name == "gelu":
        # Exact (erf) formulation, as the JAX package's gelu(approximate=False)
        return torch.nn.functional.gelu
    raise ValueError(f"Unsupported activation function: {name}")
