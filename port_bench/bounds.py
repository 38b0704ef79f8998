"""The yardstick's arithmetic: the H100's peaks, the least time of a kernel
from its shapes, and the FLOPs of the work the cells do.

The peaks and `attention_bound_ms`, `dropout_bound_ms` and
`all_decode_flops` are frozen copies of chip_smoke.py's (the functions it
reports its rooflines with); the rest counts model FLOPs (two per
multiply-add) of the towers (each family's module counts its own) and the
decoder from their shapes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from port_bench.harness import family_module

ROOT = Path(__file__).resolve().parents[1]   # the checkout this port_bench lies in

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12      # float32 outside the tensor cores (TF32 off)

# K1's two kernels by name in a profile: the bf16 pre-pass and the attention
# kernel (attention_bf16.cu's is attention_bf16_kernel, which neither matches)
K1_KERNELS = ("::to_bf16_kernel(", "::attention_kernel<")


def attention_bound_ms(B, S, H, hd, bias: bool, key_bias: bool = False) -> tuple[float, str]:
    """Least time for the function: bytes (q, k, v read, o written, f32; the
    (S, S) bias or the (B, S) key bias read) over HBM rate vs operations (two
    S x S x hd products) over the bf16 peak."""
    nbytes = 4 * B * S * H * hd * 4 + (S * S * 4 if bias else 0) + (B * S * 4 if key_bias else 0)
    flops = 2 * 2 * B * H * S * S * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dropout_bound_ms(n: int, itemsize: int) -> tuple[float, str]:
    """Least time: x read once and y written once over the HBM rate (the Philox
    and compare work is integer arithmetic, far under any peak rate)."""
    return 2 * n * itemsize / HBM_BYTES_PER_S * 1e3, "bytes"


def all_decode_flops(E: int, FF: int, L: int, V: int, P: int, n_pos: np.ndarray) -> tuple[int, int]:
    """(scored positions, FLOP) of one image's exhaustive scoring over targets of
    n_pos positions each (the end token included). Position 0 comes from the
    prefill; each of the other n - 1 runs every layer (the qkv, output and
    feed-forward products, attention over the P prefix and n - 1 token keys)
    and one logits product over the vocabulary."""
    T = np.asarray(n_pos).astype(np.int64) - 1
    dense = 2 * E * 3 * E + 2 * E * E + 2 * 2 * E * FF
    attn = 2 * 2 * (P + T) * E
    return int(T.sum()), int((T * (L * dense + 2 * E * V) + T * L * attn).sum())


def tower_tokens(t: dict) -> int:
    """Tokens of one image through the vision tower, as its family counts them."""
    return family_module(t, ROOT).tokens(t)


def tower_flops(t: dict) -> int:
    """FLOP of one image through the vision tower, as its family counts them
    (every product; the attention's two S x S x hd products per head)."""
    return family_module(t, ROOT).flops(t)


def decoder_position_flops(d: dict, keys: int, logits: bool) -> int:
    """FLOP of one decoder position attending over `keys` positions, with
    the logits product over the vocabulary when `logits`."""
    E, FF, L = d["hidden_dim"], d["feedfwd_dim"], d["num_layers"]
    dense = 2 * 4 * E * E + 2 * 2 * E * FF
    return L * (dense + 2 * 2 * keys * E) + (2 * E * d["vocab_size"] if logits else 0)


def prefill_flops(d: dict) -> int:
    """FLOP of one image's prefill: the embedding's projection to the P
    prefix positions, P positions attending over the prefix, the first logits."""
    P = d["mlp_seq_len"]
    return (2 * d["embed_dim"] * P * d["hidden_dim"] + P * decoder_position_flops(d, P, False)
            + 2 * d["hidden_dim"] * d["vocab_size"])


def beam_flops(d: dict, topk: int) -> int:
    """Model FLOP of one image's beam search of width topk for G tokens: the
    prefill (the first token's logits), then for tokens 2..G topk candidate
    positions each, attending over the prefix and the candidate's tokens,
    with their logits."""
    P, G = d["mlp_seq_len"], d["token_length"] - 1
    steps = sum(topk * decoder_position_flops(d, P + s, True) for s in range(1, G))
    return prefill_flops(d) + steps


def all_flops(d: dict, n_pos: np.ndarray) -> int:
    """Model FLOP of one image's exhaustive scoring: the prefill with the
    first logits, and all_decode_flops over the targets."""
    return prefill_flops(d) + all_decode_flops(d["hidden_dim"], d["feedfwd_dim"], d["num_layers"],
                                               d["vocab_size"], d["mlp_seq_len"], n_pos)[1]
