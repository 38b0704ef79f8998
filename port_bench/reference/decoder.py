"""Plain PyTorch reference of the NOVIC prefix-conditioned noun decoder
(PrefixedIterDecoder, NOVIC, WACV 2025) as the FT0 checkpoint defines it.

It reads the checkpoint file itself (a numpy .npz: `params.*` arrays and a
JSON `__meta__` holding the model config, the target config and the target
nouns) and computes, for given embeddings and labels (token rows, or every
target noun), the teacher-forced score of each: the sum over its tokens, the end token
included when the label is shorter than the decoder's G positions, of the
log-softmax of the logits over the whole vocabulary. That is the score that
guided-plain ("gp") and unguided ("gn") beam search and exhaustive ("all")
scoring return, at temperature 1 and length alpha 0.

The forward is the decoder's full teacher-forced pass: the unit embedding
through one linear layer to P prefix positions, the labels' tokens through
the (tied) logits table, learned positions, pre-LN blocks without biases
(exact GELU), a final norm and the tied logits. The prefix block attends
non-causally within itself, tokens causally.

Arithmetic: float32 with TF32 off. `tf32=True`, the lower-precision
control, rounds both operands of every product to TF32 (10 mantissa bits,
to nearest) and keeps float32 sums, as a TF32 tensor-core GEMM does; it is
the same on any device. The checkpoint stores float16 arrays, and the decoder as published
computes with them as stored: a token position's input is the float16 sum of
its token row and its position row, and the first block's layer norm runs
on that float16 input in float16 (each operation rounded to float16, both
means summed in float32, eps a float16 constant, rsqrt as a float16 sqrt and
a float16 reciprocal). The reference keeps those roundings; the prefix
positions are float32 throughout.

Imports torch and numpy only: nothing of the program under test.
"""

from __future__ import annotations

import ast
import contextlib
import json
import math

import numpy as np
import torch

NEG_INF = -1e30
CHARS = "abcdefghijklmnopqrstuvwxyz0123456789-' "   # the word tokenizer's character tokens


@contextlib.contextmanager
def tf32_matmuls(enabled: bool):
    """TF32 for float32 matmuls on or off inside the block, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to the nearest TF32 value (13 low mantissa bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def read_checkpoint(path: str) -> tuple[dict, dict]:
    """(float32 numpy params by name without the `params.` prefix, meta dict
    with model_config, target_config and target_nouns parsed)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        params = {k[len("params."):]: data[k] for k in data.files if k.startswith("params.")}
    for key in ("model_config", "target_config", "target_nouns"):
        if isinstance(meta[key], str):
            meta[key] = ast.literal_eval(meta[key])
    return params, meta


class LabelTokens:
    """Label string -> compact token ids, as the FT0 target config defines
    them over the word tokenizer of its nouns: words (sorted, after the
    character tokens) joined by the space character's token, mapped through
    the compact map, then the end token 0."""

    def __init__(self, meta: dict):
        tc = meta["target_config"]
        nouns = meta["target_nouns"][meta["num_invalid_target_nouns"]:]
        words = sorted({w for n in nouns for w in n.lower().split(" ")})
        self.word_id = {w: len(CHARS) + i for i, w in enumerate(words)}
        self.compact = np.asarray(tc["compact_map"], np.int64)
        self.unmap = {int(c): i for i, c in enumerate(self.compact) if c >= 0}
        self.id_word = {i: w for w, i in self.word_id.items()}
        self.token_length = int(tc["token_length"])
        self.nouns = list(nouns)

    def encode(self, label: str) -> list[int]:
        ids: list[int] = []
        for i, word in enumerate(label.lower().strip().split(" ")):
            if i:
                ids.append(CHARS.index(" "))
            if word in self.word_id:
                ids.append(self.word_id[word])
            else:
                ids.extend(CHARS.index(c) if c in CHARS else CHARS.index("-") for c in word)
        out = [int(self.compact[i]) for i in ids]
        if any(t <= 0 for t in out):
            raise ValueError(f"label {label!r} is outside the decoder's token set")
        return out

    def decode(self, ids) -> str:
        """The label string of one row of compact ids (end and padding 0 skip)."""
        parts = []
        for c in ids:
            t = self.unmap.get(int(c), -1) if int(c) != 0 else -1
            if 0 <= t < len(CHARS):
                parts.append(CHARS[t])
            elif t in self.id_word:
                parts.append(self.id_word[t])
        return "".join(parts).rstrip()

    def batch(self, labels: list[str], positions: int) -> tuple[np.ndarray, np.ndarray]:
        """(N, positions) int64 ids with the end token and zero padding, and
        (N,) the number of scored positions of each (tokens + end, at most
        `positions`). A label longer than `positions` raises."""
        ids = np.zeros((len(labels), positions), np.int64)
        n = np.zeros(len(labels), np.int64)
        for r, label in enumerate(labels):
            toks = self.encode(label)
            if len(toks) > positions:
                raise ValueError(f"label {label!r} has {len(toks)} tokens > {positions}")
            ids[r, :len(toks)] = toks
            n[r] = min(len(toks) + 1, positions)
        return ids, n


def _layer_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w


def _layer_norm_fp16(x16: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Layer norm of a float16 input with every operation rounded to float16
    (the means taken in float32, then rounded). Returns float32 values."""
    h = torch.float16
    mean = x16.float().mean(dim=-1, keepdim=True).to(h)
    d = x16 - mean
    var = torch.square(d).float().mean(dim=-1, keepdim=True).to(h)
    eps16 = float(torch.tensor(eps, dtype=h))
    r = torch.reciprocal(torch.sqrt(var + eps16))
    return (d * r * w.to(h)).float()


class ReferenceDecoder:
    """The FT0 decoder in plain torch on `device`, from the checkpoint file."""

    def __init__(self, checkpoint: str, device: str | torch.device, *, tf32: bool = False):
        params, meta = read_checkpoint(checkpoint)
        cfg = meta["model_config"]
        if (cfg["model"] != "PrefixedIterDecoder" or not cfg["layer_norm_first"]
                or cfg["layer_bias"] or cfg["logits_bias"] or not cfg["weight_tying"]
                or cfg["mlp_hidden_layer"] != "none" or cfg["layer_activation"] != "gelu"
                or cfg["strictly_causal"] or cfg["vocab_quant"]):
            raise ValueError("the reference covers the FT0 decoder's form only")
        self.device = torch.device(device)
        self.fp16_params = all(a.dtype == np.float16 for a in params.values())
        self.p = {k: torch.from_numpy(a.astype(np.float32)).to(self.device)
                  for k, a in params.items()}
        self.E, self.P, self.L = cfg["hidden_dim"], cfg["mlp_seq_len"], cfg["num_layers"]
        self.H = cfg["num_heads"]
        self.V = cfg["vocab_size"]
        self.G = cfg["token_length"] - 1
        self.tf32 = tf32
        if tf32:
            self.p = {k: round_tf32(v) for k, v in self.p.items()}
        self.labels = LabelTokens(meta)
        S = self.P + self.G
        i = torch.arange(S)[:, None]
        j = torch.arange(S)[None, :]
        allowed = (j <= i) | ((i < self.P) & (j < self.P))
        self.mask = torch.where(allowed, 0.0, NEG_INF).to(self.device)

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w.T (w's operand already rounded when tf32)."""
        return (round_tf32(x) if self.tf32 else x) @ w.t()

    def _block(self, x: torch.Tensor, i: int, first_norm: torch.Tensor | None) -> torch.Tensor:
        p, E, H = self.p, self.E, self.H
        hd = E // H
        pre = f"transformer.layers_{i}."
        h = first_norm if first_norm is not None else _layer_norm(x, p[pre + "norm1_weight"], 1e-5)
        A, S = x.shape[0], x.shape[1]
        q, k, v = self._mm(h, p[pre + "self_attn_in_proj_weight"]).chunk(3, dim=-1)
        q, k, v = (t.reshape(A, S, H, hd).transpose(1, 2) for t in (q, k, v))
        scores = (q / math.sqrt(hd)) @ k.transpose(-1, -2) + self.mask[:S, :S]
        o = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(A, S, E)
        x = x + self._mm(o, p[pre + "self_attn_out_proj_weight"])
        h = _layer_norm(x, p[pre + "norm2_weight"], 1e-5)
        h = torch.nn.functional.gelu(self._mm(h, p[pre + "linear1_weight"]))
        return x + self._mm(h, p[pre + "linear2_weight"])

    def hidden(self, embeds: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """(A, P + T, E) final-norm outputs of embeddings (A, F) followed by
        token inputs (A, T)."""
        p, P = self.p, self.P
        A, T = tokens.shape
        e = embeds / embeds.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        prefix = self._mm(e, p["embed_mlp.linear1_weight"]).reshape(A, P, self.E)
        prefix = prefix + p["pos_embedding"][:P]
        tok = p["logits_weight"][tokens]
        pos = p["pos_embedding"][P:P + T][None]
        w1 = p["transformer.layers_0.norm1_weight"]
        if self.fp16_params:
            tok16 = tok.half() + pos.half()
            x = torch.cat([prefix, tok16.float()], dim=1)
            first = torch.cat([_layer_norm(prefix, w1, 1e-5), _layer_norm_fp16(tok16, w1, 1e-5)],
                              dim=1)
        else:
            x = torch.cat([prefix, tok + pos], dim=1)
            first = None
        for i in range(self.L):
            x = self._block(x, i, first if i == 0 else None)
        return _layer_norm(x, p["transformer.norm_weight"], 1e-5)

    @torch.no_grad()
    def score_ids(self, embeds: torch.Tensor, ids: torch.Tensor, n_pos: torch.Tensor
                  ) -> torch.Tensor:
        """(A,) float64 teacher-forced scores of token rows ids (A, G) with
        n_pos (A,) scored positions each, under embeddings (A, F)."""
        with tf32_matmuls(False):
            T = int(n_pos.max())
            h = self.hidden(embeds.float(), ids[:, :T - 1])[:, self.P - 1:self.P - 1 + T]
            logp = torch.log_softmax(self._mm(h, self.p["logits_weight"]), dim=-1)  # (A, T, V)
            picked = torch.gather(logp, 2, ids[:, :T, None])[..., 0]                # (A, T)
            live = torch.arange(T, device=ids.device)[None, :] < n_pos[:, None]
            return torch.where(live, picked, 0.0).double().sum(dim=1)

    def score_rows(self, embeds: torch.Tensor, ids: np.ndarray, padding: np.ndarray,
                   rows: int = 4096) -> np.ndarray:
        """(B, K) scores of token rows ids (B, K, G) whose positions past the
        end token are marked in padding (B, K, G), under embeddings (B, F)."""
        B, K, G = ids.shape
        n = (G - padding.sum(axis=-1)).reshape(-1).astype(np.int64)
        t = np.where(padding, 0, ids).reshape(-1, G).astype(np.int64)
        n, t = torch.from_numpy(n).to(self.device), torch.from_numpy(t).to(self.device)
        e = embeds.to(self.device).float().repeat_interleave(K, dim=0)
        out = [self.score_ids(e[i:i + rows], t[i:i + rows], n[i:i + rows])
               for i in range(0, B * K, rows)]
        return torch.cat(out).cpu().numpy().reshape(B, K)

    def score_all(self, embed: torch.Tensor, rows: int = 4096) -> np.ndarray:
        """(W,) scores of every target noun under one embedding (F,), in the
        order of the checkpoint's nouns."""
        ids, n = self.labels.batch(self.labels.nouns, self.G)
        ids = torch.from_numpy(ids).to(self.device)
        n = torch.from_numpy(n).to(self.device)
        e = embed.to(self.device).float()[None]
        out = [self.score_ids(e.expand(min(rows, len(n) - i), -1), ids[i:i + rows], n[i:i + rows])
               for i in range(0, len(n), rows)]
        return torch.cat(out).cpu().numpy()
