"""Trie tables for guided decoding at large guide-set sizes.

The reference's guided decoding (ref embedding_decoder.py:807-813,915-943)
keeps a per-candidate alive mask over all W guide targets and rebuilds the
allowed-token scatter from it every step. That is O(B*K*W) work and traffic
per step — measured catastrophically slow at FT0 scale on TPU (W=42,919:
~2.7 s/step, exp/guided_beam_bisect.py). But the alive set of a candidate is
always "guide rows whose prefix equals my generated prefix", i.e. a node of
the guide-target trie. This module precomputes, per depth d, padded children
tables over the distinct depth-d prefixes, so the per-step state is ONE int32
per candidate (its trie node) and the per-step work is a gather of that
node's children row (M_d entries, typically 10s-100s) — W-independent.

Semantics are exactly the mask formulation's:
  * allowed tokens at step d = the node's children tokens (= position-d
    tokens of alive rows);
  * the new node after emitting `tok` = the child with that token, or the
    dead sentinel (node 0, no children) — identical to mask |= (tok != gcol);
  * alive-row counts for vocab priors = child row-counts / node row-count.

Tables are plain dicts of numpy arrays, built on the host; the decode path
moves them to the device once per guide set (infer.GenerationTask._maybe_trie).
"""

from __future__ import annotations

import numpy as np

__all__ = ["build_guide_trie", "trie_num_nodes"]


def build_guide_trie(guide_targets: np.ndarray, vocab_size: int, depth: int) -> dict:
    """Build per-depth children tables for the (W, C) guide-target rows.

    Returns {"child_tok": [d](N_d, M_d) int32 (pad = vocab_size),
             "child_id":  [d](N_d, M_d) int32 (index into depth d+1; 0 = dead),
             "child_cnt": [d](N_d, M_d) int32 (guide rows under the child),
             "node_cnt":  [d](N_d,)     int32 (guide rows under the node)}
    for d in [0, depth). Node 0 at every depth is the dead sentinel (zero
    children, count 0); the root (depth 0) is node 1. Rows are compared over
    their first `depth` columns including trailing padding zeros, matching
    the step range of generate_beam/generate_greedy (step Cm indexes
    guide_targets[:, Cm] for Cm in [0, depth)).
    """
    gt = np.asarray(guide_targets, dtype=np.int32)
    if gt.ndim != 2:
        raise ValueError(f"guide_targets must be 2D (W, C), got {gt.shape}")
    W, C = gt.shape
    if depth > C:
        raise ValueError(f"trie depth {depth} exceeds guide width {C}")
    V = int(vocab_size)

    # Lexicographic sort over the first `depth` columns: every trie node is a
    # contiguous row range of the sorted array.
    order = np.lexsort(tuple(gt[:, d] for d in reversed(range(depth))))
    gs = gt[order, :depth]  # (W, depth) sorted

    child_tok, child_id, child_cnt, node_cnt = [], [], [], []
    # starts[d][w] = True where sorted row w begins a new depth-d prefix group.
    starts = np.zeros(W, dtype=bool)
    starts[0] = True  # depth 0: one root group spanning all rows
    group_id = np.zeros(W, dtype=np.int64)  # depth-d group index per row (root=0)
    group_sizes = np.array([W], dtype=np.int64)

    for d in range(depth):
        # Children of depth-d groups = depth-(d+1) groups.
        new_starts = starts.copy()
        if W > 1:
            new_starts[1:] |= gs[1:, d] != gs[:-1, d]
        cstart_rows = np.flatnonzero(new_starts)           # (E,) first row of each child
        E = len(cstart_rows)
        cparent = group_id[cstart_rows]                    # (E,) parent group index
        ctoken = gs[cstart_rows, d].astype(np.int64)       # (E,)
        csize = np.diff(np.append(cstart_rows, W))         # (E,) rows per child

        # Per-parent child slot: children of one parent are consecutive in E
        # and cparent is non-decreasing, so the first child index of each
        # parent is searchsorted(cparent, cparent) (first occurrence).
        slot = np.arange(E) - np.searchsorted(cparent, cparent, side="left")
        M = int(slot.max()) + 1 if E else 1
        N = len(group_sizes) + 1  # +1 dead sentinel at index 0

        tok_t = np.full((N, M), V, dtype=np.int32)
        id_t = np.zeros((N, M), dtype=np.int32)
        cnt_t = np.zeros((N, M), dtype=np.int32)
        tok_t[cparent + 1, slot] = ctoken
        id_t[cparent + 1, slot] = np.arange(E) + 1  # child group index (+1 for sentinel)
        cnt_t[cparent + 1, slot] = csize
        ncnt_t = np.zeros((N,), dtype=np.int32)
        ncnt_t[1:] = group_sizes

        child_tok.append(tok_t)
        child_id.append(id_t)
        child_cnt.append(cnt_t)
        node_cnt.append(ncnt_t)

        starts = new_starts
        group_id = np.cumsum(new_starts) - 1
        group_sizes = csize.astype(np.int64)

    # Packed tok+id table: the decode hot loop needs BOTH the children tokens
    # (allowed-token scatter) and the children ids (state advance) every step;
    # packing them into one int32 halves the sequential per-step table gathers
    # — the dominant share of the W-independent single-image guided-latency
    # penalty (BENCH_NOTES "Guided-decode cost bisection"). Layout:
    # pack = (child_id << tok_bits) | child_tok, with tok_bits sized for the
    # pad value V; omitted (None) if the two fields cannot share 31 bits.
    tok_bits = max(int(V).bit_length(), 1)
    max_id = max((int(t.max()) for t in child_id if t.size), default=0)
    id_bits = max(max_id.bit_length(), 1)
    if tok_bits + id_bits <= 31:
        child_pack = [
            ((i.astype(np.int64) << tok_bits) | t.astype(np.int64)).astype(np.int32)
            for t, i in zip(child_tok, child_id)]
    else:
        child_pack = None

    return {"child_tok": child_tok, "child_id": child_id,
            "child_cnt": child_cnt, "node_cnt": node_cnt,
            "child_pack": child_pack, "pack_tok_bits": np.int32(tok_bits)}



def trie_num_nodes(trie: dict) -> int:
    """Total node-table entries across depths (diagnostic / memory estimate):
    the sum of the `child_tok` sizes, as in novic_tpu.

    Call it on build_guide_trie's own output. GenerationTask._maybe_trie keeps
    only depth 0 of `child_tok` on the device when the packed table exists
    (the deeper depths become (1, 1) placeholders), so on those device tables
    the sum under-reports."""
    return int(sum(t.size for t in trie["child_tok"]))
