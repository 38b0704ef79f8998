"""Port greedy decode (novic_tpu_torch.models.generate.generate_greedy) against the JAX package.

FT0 decoder (float32 parameters), B=3 seeded unit embeddings: unguided,
mask-guided (300 guide rows), trie-guided (all 42,919 nouns) and trie-guided
with renorm; the loss (calc_loss, with and without sample weights), the
collected logits, length alpha and temperature. Tokens and paddings identical;
logits, scores and losses within 1e-5 relative.
"""

import os

import numpy as np
import pytest
import torch

import jax

from novic_tpu.models.generate import generate_greedy as jax_generate_greedy
from novic_tpu.models.guide_trie import build_guide_trie as jax_build_guide_trie
from novic_tpu.models.prefixed_iter import PrefixedIterDecoder as JDecoder
from novic_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from novic_tpu_torch.bridge import decoder_from_numpy
from novic_tpu_torch.infer import load_guide_targets
from novic_tpu_torch.models import generate
from novic_tpu_torch.models.guide_trie import build_guide_trie
from novic_tpu_torch.text.simple import make_test_tokenizer
from novic_tpu_torch.text.target import TargetTokenizer
from novic_tpu_torch.train.checkpoint import load_checkpoint

torch.set_num_threads(2)
FT0 = os.path.join(os.path.dirname(__file__), "..", "assets", "bench_ft0_decoder.npz")


@pytest.fixture(scope="module")
def ft0():
    ck = load_checkpoint(FT0)
    jck = jax_load_checkpoint(FT0)
    nouns = ck["target_nouns"][ck["num_invalid_target_nouns"]:]
    gids, _ = load_guide_targets(TargetTokenizer(make_test_tokenizer(nouns), ck["target_config"]),
                                 nouns)
    embed = np.random.default_rng(1).normal(size=(3, 768)).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float32), jck["params"])
    return dict(model=decoder_from_numpy(ck["model_config"], jparams),  # both read float32
                jmodel=JDecoder(cfg=jck["model_config"]), jparams=jparams,
                gids=gids, embed=embed)


def _close(a, b, rtol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1.0), (np.abs(a - b).max(),)


@pytest.mark.parametrize("case", [
    dict(calc_loss=True),
    dict(calc_loss=True, temperature=0.7, length_alpha=0.5, weights=True, guide_rows=300),
    dict(calc_loss=True, guided=True),
    dict(calc_loss=True, guided=True, guide_renorm=True, length_alpha=1.0),
    dict(collect_logits=True, guided=True, guide_rows=300, guide_renorm=True),
], ids=["unguided", "mask_alpha_weights", "trie", "trie_renorm", "mask_renorm_logits"])
def test_greedy_matches_jax(ft0, case):
    case = dict(case)
    model = ft0["model"]
    G = model.cfg.token_length - 1
    rows = case.pop("guide_rows", None)
    guided = case.pop("guided", False) or rows is not None
    weights = case.pop("weights", False)
    guide = (ft0["gids"][:rows] if rows else ft0["gids"]) if guided else None
    jtrie = trie = None
    if guided and rows is None:
        jt = jax_build_guide_trie(guide, model.cfg.vocab_size, G)
        jt.pop("pack_tok_bits")
        jtrie = jax.device_put(jt)
        t = build_guide_trie(guide, model.cfg.vocab_size, G)
        trie = {k: [torch.from_numpy(x) for x in t[k]] for k in ("child_tok", "child_id",
                                                                 "child_pack")}
    sw = np.array([0.5, 2.0, 1.0], np.float32) if weights else None
    jm = ft0["jmodel"]
    fn = jax.jit(lambda p, e, tr, w: jax_generate_greedy(jm, p, e, guide_targets=guide,
                                                         guide_trie=tr, sample_weight=w, **case))
    ref = fn(ft0["jparams"], ft0["embed"], jtrie, sw)
    out = generate.generate_greedy(
        model, torch.from_numpy(ft0["embed"]), guide_trie=trie,
        guide_targets=None if guide is None else torch.from_numpy(guide.astype(np.int64)),
        sample_weight=None if sw is None else torch.from_numpy(sw), **case)
    assert len(out) == len(ref) == 6
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    assert out[0].dtype == torch.int32
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    for a, b in zip(out[2:], ref[2:]):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a.numpy(), b)
    if guided:
        rows_ok = {tuple(r) for r in guide[:, :G].tolist()}
        assert all(tuple(r) in rows_ok for r in out[0].tolist())


def test_greedy_is_beam_k1(ft0):
    """Greedy decode and beam search with one candidate pick the same tokens."""
    e = torch.from_numpy(ft0["embed"])
    t, p, *_ = generate.generate_greedy(ft0["model"], e)
    bt, bp, _ = generate.generate_beam(ft0["model"], e, topk=1, cache_mode="reorder")
    assert torch.equal(bt[:, 0], t) and torch.equal(bp[:, 0], p)
