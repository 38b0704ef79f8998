"""KV-cached greedy decode, beam search and exhaustive guided scoring (the
counterparts of novic_tpu.models.generate `generate_greedy`, `generate_beam` and
`precompute_generate_all` / `generate_all`).

Same semantics as the JAX package: temperature, length alpha, the first-token
end ban, forced end for finished candidates, guided decoding either through
the guide trie (guide_trie.build_guide_trie tables on the device) or through the
alive mask, with or without guide renormalisation, and (beam) vocab priors per
token or per target, through a trie or the mask.

Beam search keeps its token caches in one of two ways (`cache_mode`):
* "lazy" (and "auto"): slot-stationary caches; each candidate selects its
  history with an additive ancestry bias in attention.
* "reorder": the 2L token caches are permuted by candidate at every step, in one
  launch of the beam-reorder kernel (ops/beam_reorder.py) from one cache set into
  a second, preallocated one; the two sets swap roles each step.

Exhaustive scoring ("all") teacher-forces every guide target: the shared prefix
is prefilled once per call, position 0 is scored from the prefill logits, and the
targets run in descending length buckets, a chunk of targets at a time, through
the prefix-cached score_hidden, one position's (rows, V) logits at a time. The
host-side precompute (paddings, renorm trie tables, vocab prior corrections,
alpha scales) is numpy, as in the JAX package.

Ties: jax.lax.top_k and jnp.argmax pick the lowest index among equal values.
torch.topk promises no order, so every top-k here is a stable descending sort
(generate_all's over the JAX package's row order); argmax over bool rows casts
to int first (torch.argmax returns the first maximum).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from novic_tpu_torch.models.guide_trie import build_guide_trie
from novic_tpu_torch.models.layers import NEG_INF
from novic_tpu_torch.models.prefixed_iter import cross_entropy_elems
from novic_tpu_torch.ops.beam_reorder import beam_reorder_many
from novic_tpu_torch.utils import trace

INF = -NEG_INF


def _trie_children(trie: dict, state: torch.Tensor, Cm: int, vocab_size: int):
    """A node's children (tok, id) rows: one gather of the packed tok+id table
    when it exists, else two gathers."""
    pk = trie.get("child_pack")
    if pk is not None:
        packed = pk[Cm][state]
        tok, cid = _unpack_children(packed, vocab_size)
        return tok, cid, packed
    return trie["child_tok"][Cm][state], trie["child_id"][Cm][state], None


def _unpack_children(packed: torch.Tensor, vocab_size: int):
    tok_bits = max(int(vocab_size).bit_length(), 1)
    return packed & ((1 << tok_bits) - 1), packed >> tok_bits


def _scatter_allowed(base_shape: tuple, idx: torch.Tensor) -> torch.Tensor:
    """NEG_INF everywhere except 0 at positions named by idx along the last axis
    (base_shape = (..., V+1); idx values of V land in the discarded overflow column)."""
    base = torch.full(base_shape, NEG_INF, dtype=torch.float32, device=idx.device)
    return _scatter_max_zero(base, idx)


def _scatter_max_zero(base: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """max(base, 0) at the positions named by idx (last axis; leading axes aligned)."""
    if idx.dim() not in (2, 3):
        raise ValueError(f"Unsupported idx ndim: {idx.dim()}")
    idx = idx.long()
    return base.scatter_reduce(-1, idx, torch.zeros(idx.shape, dtype=base.dtype,
                                                     device=base.device), reduce="amax")


def _scatter_count(base_shape: tuple, idx: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Counts (or summed weights) of the positions named by idx along the last axis."""
    if idx.dim() not in (2, 3):
        raise ValueError(f"Unsupported idx ndim: {idx.dim()}")
    src = (torch.ones(idx.shape, dtype=torch.float32, device=idx.device) if weights is None
           else weights.float())
    base = torch.zeros(base_shape, dtype=torch.float32, device=idx.device)
    return base.scatter_add(-1, idx.long(), src)


def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along dim (0 if none), as jnp.argmax over bools."""
    return mask.to(torch.int32).argmax(dim=dim)


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis with jax.lax.top_k's tie order (lowest index first)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]



@torch.inference_mode()
def generate_greedy(
    model,
    embed: torch.Tensor,
    *,
    collect_logits: bool = False,
    calc_loss: bool = False,
    temperature: float = 1.0,
    length_alpha: float = 0.0,
    sample_weight: Optional[torch.Tensor] = None,
    guide_targets: Optional[torch.Tensor] = None,
    guide_renorm: bool = False,
    guide_trie: Optional[dict] = None,
):
    """Greedy KV-cached decode over a PrefixedIterDecoder. Returns
    (target BxG int32, target_padding BxG, seq_logits BxGxV | None, loss_sum,
    loss_basis, target_score), the last three None unless calc_loss.

    guide_targets: (W, C) int tensor on the model's device; guide_trie: its
    build_guide_trie tables on the device (a trie node per sample instead of the
    (B,W) alive mask)."""
    cfg = model.cfg
    dev = embed.device
    B, G, V = embed.shape[0], cfg.token_length - 1, cfg.vocab_size
    k, v = model.init_cache(B)
    logits, k, v = model.prefill(embed, k, v)

    have_guide = guide_targets is not None
    use_trie = have_guide and guide_trie is not None
    if use_trie:
        guide_state = torch.ones((B,), dtype=torch.long, device=dev)  # all at the root
    elif have_guide:
        guide_state = torch.zeros((B, guide_targets.shape[0]), dtype=torch.bool, device=dev)
    else:
        guide_state = None
    is_end = torch.arange(V, device=dev) == 0

    def pick_token(logits, guide_state, step):
        """(token, guide_score or None, new guide state) by the reference's rules."""
        if use_trie:
            Cm = step - 1
            if Cm == 0:
                # Every sample is at the root: one (V,) allowed vector, one children row
                gct = guide_trie["child_tok"][0][1]
                guide_score = _scatter_allowed((1, V + 1), gct[None, :])[0, :V][None, :].expand(B, V)
                token = torch.argmax(guide_score + logits, dim=1).to(torch.int32)
                eq = gct[None, :] == token[:, None]
                child = guide_trie["child_id"][0][1][_first_true(eq, 1)]
            else:
                gct, cid, _ = _trie_children(guide_trie, guide_state, Cm, V)  # (B, M) each
                guide_score = _scatter_allowed((B, V + 1), gct)[:, :V]
                token = torch.argmax(guide_score + logits, dim=1).to(torch.int32)
                eq = gct == token[:, None]
                child = torch.gather(cid, 1, _first_true(eq, 1)[:, None].long())[:, 0]
            new_state = torch.where(eq.any(dim=1), child, torch.zeros_like(child)).long()
        elif have_guide:
            gcol = guide_targets[:, step - 1]  # (W,)
            idx = torch.where(guide_state, V, gcol[None, :].expand(guide_state.shape))
            guide_score = _scatter_allowed((B, V + 1), idx)[:, :V]
            token = torch.argmax(guide_score + logits, dim=1).to(torch.int32)
            new_state = guide_state | (token[:, None] != gcol[None, :])
        else:
            guide_score = None
            # Disallow the end token at the very first step
            masked = torch.where(is_end[None, :], NEG_INF, logits) if step == 1 else logits
            token = torch.argmax(masked, dim=1).to(torch.int32)
            new_state = None
        return token, guide_score, new_state

    sample_mask = torch.zeros((B,), dtype=torch.bool, device=dev)
    seq_logits_l, tokens_l, paddings_l, guide_scores_l = [], [], [], []
    for step in range(1, G + 1):
        token, guide_score, guide_state = pick_token(logits, guide_state, step)
        seq_logits_l.append(logits)
        tokens_l.append(token)
        paddings_l.append(sample_mask)  # padding at position step-1 = finished before this step
        guide_scores_l.append(guide_score)
        sample_mask = sample_mask | (token == 0)
        if step < G:  # the last step's logits would predict past the token length
            logits, k, v = model.decode_step(token.long(), step, k, v)

    target = torch.stack(tokens_l, dim=1)            # BxG
    target_padding = torch.stack(paddings_l, dim=1)  # BxG
    seq_logits = torch.stack(seq_logits_l, dim=1)    # BxGxV
    target = torch.where(target_padding, 0, target)

    loss_sum = loss_basis = target_score = None
    if calc_loss:
        score_logits = seq_logits / temperature
        if have_guide and guide_renorm:
            score_logits = score_logits + torch.stack(guide_scores_l, dim=1)
        logp = torch.log_softmax(score_logits, dim=2)
        target_score = torch.gather(logp, 2, target[:, :, None].long())[:, :, 0]
        target_score = torch.where(target_padding, 0.0, target_score).sum(dim=1)
        if length_alpha != 0:
            n = (G - target_padding.sum(dim=1)).to(target_score.dtype).clamp_min(1.0)
            target_score = target_score * torch.pow(n, -length_alpha)
        loss_target = torch.where(target_padding, -1, target)
        elems = cross_entropy_elems(seq_logits, loss_target, cfg.label_smoothing)
        if sample_weight is None:
            loss_sum = elems.sum()
            loss_basis = (target_padding.numel() - target_padding.sum()).to(embed.dtype)
        else:
            loss_sum = torch.dot(sample_weight, elems.sum(dim=1))
            loss_basis = torch.dot(sample_weight,
                                   (G - target_padding.sum(dim=1)).to(sample_weight.dtype))

    return (target, target_padding, seq_logits if (collect_logits or calc_loss) else None,
            loss_sum, loss_basis, target_score)


def _same_targets(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.shape == b.shape and a.device == b.device and torch.equal(a, b))


@torch.inference_mode()
def generate_beam(
    model,
    embed: torch.Tensor,
    *,
    topk: int,
    temperature: float = 1.0,
    length_alpha: float = 0.0,
    vocab_targets: Optional[torch.Tensor] = None,
    vocab_per_token: bool = False,
    vocab_scaler: float = 0.0,
    guide_targets: Optional[torch.Tensor] = None,
    guide_renorm: bool = False,
    cache_mode: str = "auto",
    guide_trie: Optional[dict] = None,
    vocab_trie: Optional[dict] = None,
):
    """Batched KV-cached beam search over a PrefixedIterDecoder. Returns
    (target BxHxG int32, padding BxHxG bool, scores BxH) in descending score order.

    guide_targets / vocab_targets: (W, C) / (Z, C) int tensors on the model's
    device; guide_trie / vocab_trie: their build_guide_trie tables as tensors on
    the device (optional; W-independent per-step cost). The vocab prior reads the
    tries' child_cnt and node_cnt tables. cache_mode: "auto" (= "lazy"), "lazy"
    or "reorder" (see the module docstring)."""
    cfg = model.cfg
    dev = embed.device
    B, H = embed.shape[0], topk
    G, V = cfg.token_length - 1, cfg.vocab_size
    if cache_mode == "auto":
        cache_mode = "lazy"
    if cache_mode not in ("lazy", "reorder"):
        raise ValueError(f"Unsupported beam cache_mode: {cache_mode}")
    lazy = cache_mode == "lazy"

    have_guide = guide_targets is not None
    use_vocab = vocab_targets is not None and vocab_scaler != 0
    vocab_is_guide = use_vocab and have_guide and _same_targets(vocab_targets, guide_targets)
    W = guide_targets.shape[0] if have_guide else 0
    Z = vocab_targets.shape[0] if use_vocab else 0
    use_alpha = length_alpha != 0
    g_trie = guide_trie if have_guide else None
    v_trie = vocab_trie if (use_vocab and not vocab_is_guide) else None
    for name, trie in (("guide_trie", g_trie), ("vocab_trie", v_trie)):
        if trie is not None and len(trie["child_tok"]) < G:
            raise ValueError(f"{name} depth {len(trie['child_tok'])} < decode steps {G}")

    with trace.span("decode.prefill"):
        # Split caches: prefix slots prefilled once at B rows and shared; the G token
        # slots live at B*H rows
        logits1_base, pk, pv = model.prefill_split(embed)
        tk, tv = model.init_token_cache(B * H)
        logits_raw = logits1_base[:, None, :].expand(B, H, V)
        if lazy:
            # anc[b,c,g] = candidate-slot row holding candidate c's token from step g+1 (-1 = none)
            anc = torch.full((B, H, G), -1, dtype=torch.int32, device=dev)
        else:
            # The reorder kernel is out of place: the second cache set it writes into
            spare_k, spare_v = model.init_token_cache(B * H)
            spare = spare_k + spare_v

        target = torch.zeros((B, H, G), dtype=torch.int32, device=dev)
        padding = torch.ones((B, H, G), dtype=torch.bool, device=dev)
        padding[:, 0, 0] = False
        score = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
        score[:, 0] = 0.0
    # Alive-set states: a trie node per candidate (root = node 1 at slot 0, dead
    # slots at node 0), or the full (B,H,W) / (B,H,Z) dead-row mask

    def initial_state(trie, rows):
        if trie is not None:
            state = torch.zeros((B, H), dtype=torch.long, device=dev)
            state[:, 0] = 1
        else:
            state = torch.ones((B, H, rows), dtype=torch.bool, device=dev)
            state[:, 0, :] = False
        return state

    guide_state = initial_state(g_trie, W) if have_guide else None
    vocab_state = initial_state(v_trie, Z) if (use_vocab and not vocab_is_guide) else None
    seq_len = None
    if use_alpha:
        seq_len = torch.zeros((B, H), dtype=torch.float32, device=dev)
        seq_len[:, 0] = 1.0
    b_idx = torch.arange(B, device=dev)[:, None]
    h_range = torch.arange(H, device=dev)
    col_is_end = (torch.arange(V, device=dev) == 0)[None, None, :]
    slot0 = (h_range == 0)[None, :, None]

    def gather_h(x, cand):
        """Gather along the candidate (H) axis: x (B,H,...) by cand (B,H)."""
        return x[b_idx, cand]

    def trie_rows(trie, state, Cm, counts: bool):
        """A node's children (tok, id, packed) and, for the vocab prior, their row
        counts and the node's (cnt, node_cnt)."""
        ct, cid, packed = _trie_children(trie, state, Cm, V)
        if not counts:
            return ct, cid, None, None, packed
        return ct, cid, trie["child_cnt"][Cm][state], trie["node_cnt"][Cm][state], packed

    def trie_advance(ct, cid, cand, tok, packed=None):
        """New node after candidate reorder + emitting tok (dead node 0 if no child)."""
        if packed is not None:
            ct_g, cid_g = _unpack_children(gather_h(packed, cand), V)
        else:
            ct_g, cid_g = gather_h(ct, cand), gather_h(cid, cand)
        eq = ct_g == tok[:, :, None]
        child = torch.gather(cid_g, 2, _first_true(eq, 2)[:, :, None].long())[:, :, 0]
        return torch.where(eq.any(dim=2), child, torch.zeros_like(child)).long()

    def trie_advance_root(trie, state, cand, tok):
        """Step-1 advance: parents are the root (node 1) or dead."""
        r_ct = trie["child_tok"][0][1]
        r_cid = trie["child_id"][0][1]
        eq = r_ct[None, None, :] == tok[:, :, None]
        child = r_cid[_first_true(eq, 2)]
        parent_root = gather_h(state, cand) == 1
        return torch.where(parent_root & eq.any(dim=2), child, torch.zeros_like(child)).long()

    def vocab_log_probs(Cm, g_rows, guide_idx, finished):
        """log of the vocab prior (B,H,V): the share of alive vocab rows (per
        target) or of distinct next tokens (per token) that continue with each
        token; INF where it is 0; 0 on the end column of finished candidates.
        Also returns the vocab trie's children rows when it read them (None else)."""
        v_rows = None
        t_trie = g_trie if (vocab_is_guide and g_trie is not None) else v_trie
        if t_trie is not None and Cm == 0:
            # Root: every candidate is at the root (slot 0) or dead: one (V,) vector
            r_ct = t_trie["child_tok"][0][1]
            if vocab_per_token:
                present = _scatter_count((1, V + 1), r_ct[None, :]).clamp_max(1.0)[0, :V]
                root_vp = present / present.sum().clamp_min(1e-30)
            else:
                counts = _scatter_count((1, V + 1), r_ct[None, :],
                                        weights=t_trie["child_cnt"][0][1][None, :])[0, :V]
                root_vp = counts / t_trie["node_cnt"][0][1].float().clamp_min(1e-30)
            # Dead slots: probability 0, as the mask path's all-dead rows
            probs = torch.where(slot0, root_vp[None, None, :], 0.0)
        else:
            if vocab_is_guide and g_trie is not None:
                cnt_idx, cnt_w, nz_cnt = g_rows[0], g_rows[2], g_rows[3]
            elif v_trie is not None:
                v_rows = trie_rows(v_trie, vocab_state, Cm, counts=True)
                cnt_idx, cnt_w, nz_cnt = v_rows[0], v_rows[2], v_rows[3]
            else:
                if vocab_is_guide:
                    vocab_idx = guide_idx
                else:
                    zcol = vocab_targets[:, Cm]
                    vocab_idx = torch.where(vocab_state, V, zcol[None, None, :].expand(B, H, Z))
                cnt_idx, cnt_w, nz_cnt = vocab_idx, None, None
            if vocab_per_token:
                present = _scatter_count((B, H, V + 1), cnt_idx).clamp_max(1.0)[:, :, :V]
                probs = present / present.sum(dim=2, keepdim=True).clamp_min(1e-30)
            elif cnt_w is not None:  # trie: weighted by the children's row counts
                counts = _scatter_count((B, H, V + 1), cnt_idx, weights=cnt_w)
                probs = counts[:, :, :V] / nz_cnt[:, :, None].float().clamp_min(1e-30)
            else:
                counts = _scatter_count((B, H, V + 1), cnt_idx)
                nz = cnt_idx.shape[2] - counts[:, :, V:]  # rows alive
                probs = counts[:, :, :V] / nz.clamp_min(1e-30)
        logs = torch.log(probs)
        logs = torch.where(torch.isfinite(logs), logs, INF)
        return torch.where(col_is_end & finished[:, :, None], 0.0, logs), v_rows

    for step in range(1, G + 1):
        with trace.span("decode.step", step=step):
            trace.count("decode.steps")
            Cm = step - 1
            finished = padding[:, :, Cm]  # (B,H)
            logits = logits_raw / temperature
            # Force finished candidates to predict end with score 0
            logits = torch.where(~col_is_end & finished[:, :, None], NEG_INF, logits)

            guide_score = guide_idx = g_rows = None
            if g_trie is not None:
                if Cm == 0:
                    # Root special case: every candidate is at the root (slot 0) or dead
                    root_ct = g_trie["child_tok"][0][1]
                    root_allowed = _scatter_allowed((1, V + 1), root_ct[None, :])[0, :V]
                    guide_score = torch.where(slot0, root_allowed[None, None, :], NEG_INF)
                else:
                    g_rows = trie_rows(g_trie, guide_state, Cm, counts=vocab_is_guide)
                    guide_score = _scatter_allowed((B, H, V + 1), g_rows[0])[:, :, :V]
            elif have_guide:
                gcol = guide_targets[:, Cm]  # (W,)
                guide_idx = torch.where(guide_state, V, gcol[None, None, :].expand(B, H, W))
                guide_score = _scatter_allowed((B, H, V + 1), guide_idx)[:, :, :V]
            if guide_score is not None:
                guide_score = torch.where(col_is_end & finished[:, :, None], 0.0, guide_score)
                if guide_renorm:
                    logits = logits + guide_score

            scores = torch.log_softmax(logits, dim=2)
            v_rows = None
            if use_vocab:
                vocab_logs, v_rows = vocab_log_probs(Cm, g_rows, guide_idx, finished)
                scores = scores - vocab_scaler * vocab_logs
            scores = scores + score[:, :, None]
            if step == 1:  # disallow end as the first generated token
                scores = torch.where(col_is_end & slot0, NEG_INF, scores)
            if have_guide and not guide_renorm:
                scores = scores + guide_score

            flat = scores.reshape(B, H * V)
            if use_alpha:
                scale = torch.pow(seq_len.clamp_min(1.0), -length_alpha)  # (B,H)
                new_score_normed, top_idx = _top_k((scores * scale[:, :, None]).reshape(B, H * V),
                                                   H)
                new_score = torch.gather(flat, 1, top_idx)
            else:
                new_score, top_idx = _top_k(flat, H)
                new_score_normed = None

            cand = top_idx // V  # (B,H)
            tok = (top_idx % V).to(torch.int32)

            target = gather_h(target, cand)
            target[:, :, Cm] = tok
            padding = gather_h(padding, cand)
            new_finished = (tok == 0) | padding[:, :, Cm]
            if step < G:
                padding[:, :, step] = new_finished

            if g_trie is not None:
                guide_state = (trie_advance_root(g_trie, guide_state, cand, tok) if Cm == 0
                               else trie_advance(g_rows[0], g_rows[1], cand, tok, packed=g_rows[4]))
            elif have_guide:
                guide_state = gather_h(guide_state, cand) | (tok[:, :, None] != gcol[None, None, :])
            if vocab_state is not None:
                if v_trie is not None:
                    vocab_state = (trie_advance_root(v_trie, vocab_state, cand, tok) if Cm == 0
                                   else trie_advance(v_rows[0], v_rows[1], cand, tok,
                                                     packed=v_rows[4]))
                else:
                    zcol = vocab_targets[:, Cm]
                    vocab_state = (gather_h(vocab_state, cand)
                                   | (tok[:, :, None] != zcol[None, None, :]))
            if use_alpha:
                seq_len = gather_h(seq_len, cand) + (~new_finished).float()

            if lazy:
                # Thread the ancestry through the gather instead of the caches;
                # attention selects each candidate's history with an additive bias
                anc = gather_h(anc, cand)
                anc[:, :, Cm] = h_range.to(torch.int32)[None, :]
                allowed = anc[:, :, None, :] == h_range.to(torch.int32)[None, None, :, None]
                anc_bias = torch.where(allowed.reshape(B, H, 1, H * G), 0.0, NEG_INF)
                logits_next, tk, tv = model.decode_step_lazy(tok.reshape(-1).long(), step, pk, pv,
                                                             tk, tv, anc_bias)
            else:
                # Every candidate takes its parent's token-cache rows: one launch over
                # all 2L caches into the spare set, which becomes the current one
                L = len(tk)
                current = tk + tv
                beam_reorder_many(current, cand.contiguous(), out=spare)
                tk, tv, spare = spare[:L], spare[L:], current
                logits_next, tk, tv = model.decode_step_split(tok.reshape(-1).long(), step, pk, pv,
                                                              tk, tv)
            logits_raw = logits_next.reshape(B, H, V)
            score = new_score  # raw cumulative score carries forward

    target = torch.where(padding, 0, target)
    final_score = new_score_normed if use_alpha else score
    return target, padding, final_score


# ---------------------------------------------------------------------------
# Exhaustive guided scoring
# ---------------------------------------------------------------------------

# Default rows (targets x samples) scored per chunk: a chunk's cost is one
# score_hidden and, per position, one (rows, V) float32 logits GEMM, so fewer,
# larger chunks spread the host's per-launch time over more work, up to the
# memory of a few (rows, V) slabs (4.2 GB at 16,384 rows and the FT0
# vocabulary). chip_smoke.py's all_decode phase times 1,024 to 32,768 rows on
# the card (PERF.md §6). Scores do not depend on it.
ALL_CHUNK_ROWS = 16384


@dataclasses.dataclass
class GenerateAllPrecompute:
    guide_targets: np.ndarray       # (W, C) trimmed, padding zeroed
    guide_paddings: np.ndarray      # (W, C) bool
    renorm_trie: Optional[dict]     # guide-trie children tables (renorm masks) or None
    guide_nodes: Optional[np.ndarray]   # (W, C) trie node of each prefix (renorm only)
    vocab_scores: Optional[np.ndarray]  # (W,) prior correction per guide target
    alpha_scale: Optional[np.ndarray]   # (W,) length normalisation
    # The renorm children-token tables on each device generate_all ran on:
    # uploaded once per precompute and device, not once per call
    _renorm_device: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)


def _trie_walk(trie: dict, tokens: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Walk a guide trie with (W, C) token rows (vectorised over W).

    Returns (nodes, match_cnt, node_cnt, n_children), each (W, C): nodes[w,c] =
    trie node of prefix tokens[w,:c] (0 = dead); match_cnt[w,c] = rows under the
    child matching tokens[w,c] (0 if none or dead); node_cnt[w,c] = rows under
    the node; n_children[w,c] = number of distinct next tokens."""
    W, C = tokens.shape
    nodes = np.zeros((W, C), dtype=np.int32)
    match_cnt = np.zeros((W, C), dtype=np.int64)
    node_cnt = np.zeros((W, C), dtype=np.int64)
    n_children = np.zeros((W, C), dtype=np.int64)
    node = np.ones((W,), dtype=np.int64)  # root
    aw = np.arange(W)
    for c in range(C):
        nodes[:, c] = node
        ct = trie["child_tok"][c][node]    # (W, M_c)
        cid = trie["child_id"][c][node]
        cct = trie["child_cnt"][c][node]
        eq = ct == tokens[:, c][:, None]
        hit = eq.any(axis=1)
        idx = np.argmax(eq, axis=1)
        match_cnt[:, c] = np.where(hit, cct[aw, idx], 0)
        node_cnt[:, c] = trie["node_cnt"][c][node]
        n_children[:, c] = (cid != 0).sum(axis=1)
        node = np.where(hit, cid[aw, idx], 0).astype(np.int64)
    return nodes, match_cnt, node_cnt, n_children


def precompute_generate_all(
    vocab_size: int,
    *,
    length_alpha: float,
    vocab_targets: Optional[np.ndarray],
    vocab_per_token: bool,
    vocab_scaler: float,
    guide_targets: np.ndarray,
    guide_renorm: bool,
) -> GenerateAllPrecompute:
    """Host-side (numpy) precompute of generate_all: the guide paddings, the
    renorm trie tables and each target's trie nodes, the vocab prior
    corrections and the alpha scales.

    A prefix's alive rows are a node of the guide (or vocab) trie, so a renorm
    mask is the node's children row and a vocab prior an exact alive-row count
    read off a trie walk: O(W*C), where a mask over all W rows per prefix would
    be O(W^2)."""
    guide_targets = np.asarray(guide_targets)
    W, Cmax = guide_targets.shape
    V = vocab_size

    guide_paddings = np.zeros((W, Cmax), dtype=bool)
    guide_paddings[:, 1:] = np.logical_not(guide_targets[:, :-1])
    guide_paddings[:, 1:] = np.maximum.accumulate(guide_paddings[:, 1:], axis=1)

    C = Cmax - int(guide_paddings.all(axis=0).sum())
    guide_paddings = guide_paddings[:, :C]
    guide_targets = np.where(guide_paddings, 0, guide_targets[:, :C]).astype(np.int32)

    if guide_renorm:
        renorm_trie = build_guide_trie(guide_targets, V, C)
        guide_nodes, _, _, _ = _trie_walk(renorm_trie, guide_targets)
        # Every guide prefix is alive in its own trie by construction
        if C > 1 and not (guide_nodes[:, 1:] > 0).all():
            raise RuntimeError("a guide prefix is dead in its own trie")
    else:
        renorm_trie = None
        guide_nodes = None

    if vocab_targets is None or vocab_scaler == 0:
        vocab_scores = None
    else:
        vocab_targets = np.asarray(vocab_targets)[:, :C]
        v_trie = build_guide_trie(vocab_targets, V, C)
        _, match_cnt, node_cnt, n_children = _trie_walk(v_trie, guide_targets)
        # Per target: |alive rows with this token| / |alive rows|; per token:
        # 1/|distinct next tokens| if this token continues some alive row
        if vocab_per_token:
            probs = np.where(match_cnt > 0, 1.0 / np.maximum(n_children, 1), 0.0)
        else:
            probs = match_cnt / np.maximum(node_cnt, 1).astype(np.float64)
        with np.errstate(divide="ignore"):
            vocab_scores = np.log(probs)
        vocab_scores[~np.isfinite(vocab_scores)] = INF
        vocab_scores[guide_paddings] = 0.0
        vocab_scores = (vocab_scores.sum(axis=1) * vocab_scaler).astype(np.float32)

    if length_alpha == 0:
        alpha_scale = None
    else:
        n = np.maximum(C - guide_paddings.sum(axis=1), 1)
        alpha_scale = np.power(n.astype(np.float32), -length_alpha)

    return GenerateAllPrecompute(guide_targets=guide_targets, guide_paddings=guide_paddings,
                                 renorm_trie=renorm_trie, guide_nodes=guide_nodes,
                                 vocab_scores=vocab_scores, alpha_scale=alpha_scale)


def _score_chunk(model, pk, pv, g_tok: torch.Tensor, g_nodes: Optional[torch.Tensor],
                 child_tok: Optional[list], temperature: float) -> torch.Tensor:
    """(Bb, ch) summed log-probabilities of target positions 1..T of a chunk of
    ch targets (g_tok (ch, T+1)) for each of the Bb samples: per position, the
    logit at the token minus the logsumexp, one (Bb*ch, V) slab at a time; with
    renorm (g_nodes (ch, T+1) trie nodes), the node's children row masks it."""
    Bb = pk[0].shape[0]
    ch, T = g_tok.shape[0], g_tok.shape[1] - 1
    V = model.cfg.vocab_size
    # Rows are sample-major (row = b*ch + g), score_hidden's (Bb, R) layout
    h = model.score_hidden(g_tok[:, :T].repeat(Bb, 1), pk, pv)
    acc = torch.zeros((Bb * ch,), dtype=torch.float32, device=h.device)
    for c in range(T):  # scored positions 1..T; position 0 is shared
        lg = model.logits(h[:, c, :])
        if temperature != 1.0:
            lg = lg / temperature
        if child_tok is not None:
            # The allowed tokens of this prefix's trie node at depth c+1
            allowed = _scatter_allowed((ch, V + 1), child_tok[c + 1][g_nodes[:, c + 1]])[:, :V]
            lg = (lg.view(Bb, ch, V) + allowed).view(Bb * ch, V)
        at = torch.gather(lg, 1, g_tok[:, c + 1].repeat(Bb)[:, None])[:, 0]
        acc = acc + at - torch.logsumexp(lg, dim=1)
    return acc.view(Bb, ch)


@torch.inference_mode()
def generate_all(
    model,
    embed: torch.Tensor,
    *,
    topk: int,
    temperature: float = 1.0,
    length_alpha: float = 0.0,
    vocab_targets: Optional[np.ndarray] = None,
    vocab_per_token: bool = False,
    vocab_scaler: float = 0.0,
    guide_targets: Optional[np.ndarray] = None,
    guide_renorm: bool = False,
    precompute: Optional[GenerateAllPrecompute] = None,
    chunk: Optional[int] = None,
    max_scan_chunks: int = 256,
):
    """Teacher-force every guide target and return each sample's top-k. Returns
    (targets BxKxC int32, paddings BxKxC bool, scores BxK descending) on the
    embedding's device.

    guide_targets / vocab_targets: (W, C) / (Z, C) numpy ids, read only when no
    precompute is given (the precompute is host work). The prefix is prefilled once;
    targets run in descending length buckets (a stable sort), `chunk` targets at a
    time (default ALL_CHUNK_ROWS rows over the batch). The top-k runs over the
    length-sorted rows in the JAX package's order, less the padding its scans add,
    so a tie between duplicated rows picks JAX's row. `max_scan_chunks` caps the
    JAX package's scan length; the port runs no scan, so it changes nothing here.
    Scores do not depend on `chunk`."""
    cfg = model.cfg
    if precompute is None:
        if guide_targets is None:
            raise ValueError("generate_all needs guide_targets or a precompute")
        precompute = precompute_generate_all(
            cfg.vocab_size, length_alpha=length_alpha, vocab_targets=vocab_targets,
            vocab_per_token=vocab_per_token, vocab_scaler=vocab_scaler,
            guide_targets=guide_targets, guide_renorm=guide_renorm)

    gt, gp = precompute.guide_targets, precompute.guide_paddings
    W, C = gt.shape
    dev = embed.device
    B, V = embed.shape[0], cfg.vocab_size
    logits1, pk, pv = model.prefill_split(embed)  # (B,V), [(B,P,H,hd)]*L
    if chunk is None:
        chunk = max(ALL_CHUNK_ROWS // max(B, 1), 1)

    n_pos = (C - gp.sum(axis=1)).astype(np.int64)  # scored positions per target, >= 1
    order = np.argsort(-n_pos, kind="stable")
    gt_s, gp_s, n_s = gt[order], gp[order], n_pos[order]
    gn_s = precompute.guide_nodes[order] if precompute.guide_nodes is not None else None
    bounds = list(np.flatnonzero(np.diff(n_s)) + 1) if W > 1 else []

    renorm = gn_s is not None
    child_tok = None
    if renorm:
        child_tok = precompute._renorm_device.get(dev)
        if child_tok is None:
            child_tok = precompute._renorm_device[dev] = [
                torch.from_numpy(np.asarray(t, np.int64)).to(dev)
                for t in precompute.renorm_trie["child_tok"]]

    # Positions 1..: per bucket, chunk by chunk (end-token-only targets score 0 here)
    body = torch.zeros((B, W), dtype=torch.float32, device=dev)
    for st, en in zip([0] + bounds, bounds + [W]):
        length = int(n_s[st])
        if length <= 1:
            continue
        tok = torch.from_numpy(gt_s[st:en, :length].astype(np.int64)).to(dev)
        nodes = torch.from_numpy(gn_s[st:en, :length].astype(np.int64)).to(dev) if renorm else None
        for c0 in range(0, en - st, chunk):
            sl = slice(c0, min(c0 + chunk, en - st))
            body[:, st + sl.start:st + sl.stop] = _score_chunk(
                model, pk, pv, tok[sl], nodes[sl] if renorm else None, child_tok, temperature)

    # Position 0: one log-softmax of the prefill logits serves every target; with
    # renorm its mask is the root's children row (every guide is alive there)
    lse_in = logits1 / temperature
    if renorm:
        root_mask = _scatter_allowed((1, V + 1), child_tok[0][1][None, :])[0, :V]
        lse_in = lse_in + root_mask[None, :]
    logp0 = torch.log_softmax(lse_in, dim=1)  # (B,V)
    scores = body + logp0[:, torch.from_numpy(gt_s[:, 0]).to(dev).long()]
    if precompute.vocab_scores is not None:
        scores = scores - torch.from_numpy(precompute.vocab_scores[order]).to(dev)[None, :]
    if precompute.alpha_scale is not None:
        scores = scores * torch.from_numpy(precompute.alpha_scale[order]).to(dev)[None, :]

    top_scores, top_idx = _top_k(scores, topk)
    idx = top_idx.cpu().numpy()
    return (torch.from_numpy(gt_s[idx]).to(dev), torch.from_numpy(gp_s[idx]).to(dev),
            top_scores)
