"""KV-cached beam search (the counterpart of novic_tpu.models.generate `generate_beam`).

Same semantics as the JAX package: temperature, length alpha, the first-token
end ban, forced end for finished candidates, and guided decoding either through
the guide trie (guide_trie.build_guide_trie tables on the device) or through the
(B,H,W) alive mask, with or without guide renormalisation. The token caches are
slot-stationary ("lazy" mode): each candidate selects its history with an
additive ancestry bias in attention.

Ties: jax.lax.top_k and jnp.argmax pick the lowest index among equal values.
torch.topk promises no order, so the beam's top-k is a stable descending sort;
argmax over bool rows casts to int first (torch.argmax returns the first
maximum).

Not ported yet: vocab priors, cache_mode="reorder", generate_greedy and
generate_all; they raise NotImplementedError.
"""

from __future__ import annotations

from typing import Optional

import torch

from novic_tpu_torch.models.layers import NEG_INF


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


def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along dim (0 if none), as jnp.argmax over bools."""
    return mask.to(torch.int32).argmax(dim=dim)


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis with jax.lax.top_k's tie order (lowest index first)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def generate_greedy(*args, **kwargs):
    raise NotImplementedError("generate_greedy is not ported yet (beam search only)")


def generate_all(*args, **kwargs):
    raise NotImplementedError("generate_all is not ported yet (beam search only)")


@torch.inference_mode()
def generate_beam(
    model,
    embed: torch.Tensor,
    *,
    topk: int,
    temperature: float = 1.0,
    length_alpha: float = 0.0,
    vocab_targets: Optional[torch.Tensor] = None,
    vocab_scaler: float = 0.0,
    guide_targets: Optional[torch.Tensor] = None,
    guide_renorm: bool = False,
    cache_mode: str = "auto",
    guide_trie: Optional[dict] = None,
):
    """Batched KV-cached beam search over a PrefixedIterDecoder. Returns
    (target BxHxG int32, padding BxHxG bool, scores BxH) in descending score order.

    guide_targets: (W, C) int tensor on the model's device; guide_trie: its
    build_guide_trie tables as tensors on the device (optional; W-independent
    per-step cost)."""
    cfg = model.cfg
    dev = embed.device
    B, H = embed.shape[0], topk
    G, V = cfg.token_length - 1, cfg.vocab_size
    if cache_mode not in ("auto", "lazy"):
        raise NotImplementedError(f"Beam cache_mode {cache_mode!r} is not ported yet (lazy only)")
    if vocab_targets is not None and vocab_scaler != 0:
        raise NotImplementedError("Vocab priors are not ported yet")

    have_guide = guide_targets is not None
    W = guide_targets.shape[0] if have_guide else 0
    use_alpha = length_alpha != 0
    g_trie = guide_trie if have_guide else None
    if g_trie is not None and len(g_trie["child_tok"]) < G:
        raise ValueError(f"guide_trie depth {len(g_trie['child_tok'])} < decode steps {G}")

    # Split caches: prefix slots prefilled once at B rows and shared; the G token
    # slots live at B*H rows and stay where each candidate wrote them.
    logits1_base, pk, pv = model.prefill_split(embed)
    tk, tv = model.init_token_cache(B * H)
    logits_raw = logits1_base[:, None, :].expand(B, H, V)
    # anc[b,c,g] = candidate-slot row holding candidate c's token from step g+1 (-1 = none)
    anc = torch.full((B, H, G), -1, dtype=torch.int32, device=dev)

    target = torch.zeros((B, H, G), dtype=torch.int32, device=dev)
    padding = torch.ones((B, H, G), dtype=torch.bool, device=dev)
    padding[:, 0, 0] = False
    score = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    score[:, 0] = 0.0
    # Alive-set state: a trie node per candidate (root = node 1 at slot 0, dead
    # slots at node 0), or the full (B,H,W) dead-row mask
    if g_trie is not None:
        guide_state = torch.zeros((B, H), dtype=torch.long, device=dev)
        guide_state[:, 0] = 1
    elif have_guide:
        guide_state = torch.ones((B, H, W), dtype=torch.bool, device=dev)
        guide_state[:, 0, :] = False
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

    def trie_advance(ct, cid, cand, tok, packed=None):
        """New node after candidate reorder + emitting tok (dead node 0 if no child)."""
        if packed is not None:
            ct_g, cid_g = _unpack_children(gather_h(packed, cand), V)
        else:
            ct_g, cid_g = gather_h(ct, cand), gather_h(cid, cand)
        eq = ct_g == tok[:, :, None]
        child = torch.gather(cid_g, 2, _first_true(eq, 2)[:, :, None].long())[:, :, 0]
        return torch.where(eq.any(dim=2), child, torch.zeros_like(child)).long()

    def trie_advance_root(state, cand, tok):
        """Step-1 advance: parents are the root (node 1) or dead."""
        r_ct = g_trie["child_tok"][0][1]
        r_cid = g_trie["child_id"][0][1]
        eq = r_ct[None, None, :] == tok[:, :, None]
        child = r_cid[_first_true(eq, 2)]
        parent_root = gather_h(state, cand) == 1
        return torch.where(parent_root & eq.any(dim=2), child, torch.zeros_like(child)).long()

    for step in range(1, G + 1):
        Cm = step - 1
        finished = padding[:, :, Cm]  # (B,H)
        logits = logits_raw / temperature
        # Force finished candidates to predict end with score 0
        logits = torch.where(~col_is_end & finished[:, :, None], NEG_INF, logits)

        guide_score = None
        g_ct = g_cid = g_pk = None
        if g_trie is not None:
            if Cm == 0:
                # Root special case: every candidate is at the root (slot 0) or dead
                root_ct = g_trie["child_tok"][0][1]
                root_allowed = _scatter_allowed((1, V + 1), root_ct[None, :])[0, :V]
                guide_score = torch.where(slot0, root_allowed[None, None, :], NEG_INF)
            else:
                g_ct, g_cid, g_pk = _trie_children(g_trie, guide_state, Cm, V)
                guide_score = _scatter_allowed((B, H, V + 1), g_ct)[:, :, :V]
        elif have_guide:
            gcol = guide_targets[:, Cm]  # (W,)
            guide_idx = torch.where(guide_state, V, gcol[None, None, :].expand(B, H, W))
            guide_score = _scatter_allowed((B, H, V + 1), guide_idx)[:, :, :V]
        if guide_score is not None:
            guide_score = torch.where(col_is_end & finished[:, :, None], 0.0, guide_score)
            if guide_renorm:
                logits = logits + guide_score

        scores = torch.log_softmax(logits, dim=2) + score[:, :, None]
        if step == 1:  # disallow end as the first generated token
            scores = torch.where(col_is_end & slot0, NEG_INF, scores)
        if have_guide and not guide_renorm:
            scores = scores + guide_score

        flat = scores.reshape(B, H * V)
        if use_alpha:
            scale = torch.pow(seq_len.clamp_min(1.0), -length_alpha)  # (B,H)
            new_score_normed, top_idx = _top_k((scores * scale[:, :, None]).reshape(B, H * V), H)
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
            guide_state = (trie_advance_root(guide_state, cand, tok) if Cm == 0
                           else trie_advance(g_ct, g_cid, cand, tok, packed=g_pk))
        elif have_guide:
            guide_state = gather_h(guide_state, cand) | (tok[:, :, None] != gcol[None, None, :])
        if use_alpha:
            seq_len = gather_h(seq_len, cand) + (~new_finished).float()

        # Thread the ancestry through the gather instead of the caches; attention
        # selects each candidate's history with an additive bias
        anc = gather_h(anc, cand)
        anc[:, :, Cm] = h_range.to(torch.int32)[None, :]
        allowed = anc[:, :, None, :] == h_range.to(torch.int32)[None, None, :, None]
        anc_bias = torch.where(allowed.reshape(B, H, 1, H * G), 0.0, NEG_INF)
        logits_next, tk, tv = model.decode_step_lazy(tok.reshape(-1).long(), step, pk, pv,
                                                     tk, tv, anc_bias)
        logits_raw = logits_next.reshape(B, H, V)
        score = new_score  # raw cumulative score carries forward

    target = torch.where(padding, 0, target)
    final_score = new_score_normed if use_alpha else score
    return target, padding, final_score
