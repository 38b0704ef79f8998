"""Port beam search (novic_tpu_torch.models.generate) against the JAX package.

FT0 decoder, B=2 seeded unit embeddings: beam tokens and padding identical,
scores within 1e-5 relative, for unguided, trie-guided and renormalised guided
decoding with length alpha. The (B,H,W) mask path runs on a small guide set.
Also pins the top-k tie order (lowest index first, as jax.lax.top_k).
"""

import os

import numpy as np
import pytest
import torch

import jax

from novic_tpu.infer import load_guide_targets as jax_load_guide_targets
from novic_tpu.models.generate import generate_beam as jax_generate_beam
from novic_tpu.models.guide_trie import build_guide_trie as jax_build_guide_trie
from novic_tpu.models.prefixed_iter import PrefixedIterDecoder as JDecoder
from novic_tpu.text.simple import make_test_tokenizer as jax_make_test_tokenizer
from novic_tpu.text.target import TargetTokenizer as JTargetTokenizer
from novic_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from novic_tpu_torch.bridge import decoder_from_numpy
from novic_tpu_torch.infer import GenerationConfig, load_guide_targets
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
    jgids, _ = jax_load_guide_targets(
        JTargetTokenizer(jax_make_test_tokenizer(nouns), jck["target_config"]), nouns)
    np.testing.assert_array_equal(gids, jgids)
    embed = np.random.default_rng(0).normal(size=(2, 768)).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    return dict(model=decoder_from_numpy(ck["model_config"], ck["params"]),
                jmodel=JDecoder(cfg=jck["model_config"]),
                jparams=jax.tree.map(lambda a: np.asarray(a, np.float32), jck["params"]),
                gids=gids, embed=embed)


def _both(ft0, gencfg, guide_rows=None, use_trie=True):
    g = GenerationConfig.from_name(gencfg)
    model, gids = ft0["model"], ft0["gids"]
    if guide_rows is not None:
        gids = gids[:guide_rows]
    G = model.cfg.token_length - 1
    guide = gids if g.guided else None
    jtrie = trie = None
    if guide is not None and use_trie:
        jt = jax_build_guide_trie(guide, model.cfg.vocab_size, G)
        jt.pop("pack_tok_bits")
        jtrie = jax.device_put(jt)
        t = build_guide_trie(guide, model.cfg.vocab_size, G)
        trie = {k: [torch.from_numpy(x) for x in t[k]] for k in ("child_tok", "child_id", "child_pack")}
    kw = dict(topk=g.topk, temperature=g.temperature, length_alpha=g.length_alpha,
              guide_renorm=g.guide_renorm)
    jm = ft0["jmodel"]
    fn = jax.jit(lambda p, e, tr: jax_generate_beam(jm, p, e, guide_targets=guide, guide_trie=tr, **kw))
    ref = [np.asarray(x) for x in fn(ft0["jparams"], ft0["embed"], jtrie)]
    out = generate.generate_beam(
        model, torch.from_numpy(ft0["embed"]),
        guide_targets=None if guide is None else torch.from_numpy(guide.astype(np.int64)),
        guide_trie=trie, **kw)
    return [x.numpy() for x in out], ref


@pytest.mark.parametrize("gencfg", ["beam_k10_vnone_gn_t1_a0", "beam_k10_vnone_gp_t1_a0",
                                    "beam_k3_vnone_gr_t1_a0.5"])
def test_beam_matches_jax(ft0, gencfg):
    (t, p, s), (jt, jp, js) = _both(ft0, gencfg)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-6)
    assert np.all(np.diff(s, axis=1) <= 0)


def test_beam_mask_path_matches_jax(ft0):
    """Small guide set through the (B,H,W) alive mask instead of the trie."""
    (t, p, s), (jt, jp, js) = _both(ft0, "beam_k4_vnone_gp_t1.5_a0", guide_rows=300,
                                    use_trie=False)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-6)


def test_top_k_ties_take_lowest_index():
    x = torch.tensor([[-1e30, 0.5, -1e30, 0.5, 2.0, -1e30, 0.5, -1e30]])
    values, idx = generate._top_k(x, 6)
    assert idx.tolist() == [[4, 1, 3, 6, 0, 2]]
    ref_values, ref_idx = jax.lax.top_k(x.numpy(), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_values))
    # Dead beam slots all at -1e30: the surviving order is by index
    dead = torch.full((2, 40), -1e30)
    assert generate._top_k(dead, 5)[1].tolist() == [[0, 1, 2, 3, 4]] * 2


def test_first_true_matches_argmax_over_bools():
    m = torch.tensor([[False, True, True], [False, False, False], [True, False, True]])
    np.testing.assert_array_equal(generate._first_true(m, 1).numpy(),
                                  np.argmax(m.numpy(), axis=1))


def test_unported_modes_raise(ft0):
    """generate_all is not ported; an unknown cache_mode is refused as JAX refuses it."""
    e = torch.from_numpy(ft0["embed"])
    with pytest.raises(NotImplementedError, match="not ported"):
        generate.generate_all(ft0["model"], e, topk=2)
    with pytest.raises(ValueError, match="cache_mode"):
        generate.generate_beam(ft0["model"], e, topk=2, cache_mode="gather")
    with pytest.raises(ValueError, match="cache_mode"):
        jax_generate_beam(ft0["jmodel"], ft0["jparams"], ft0["embed"], topk=2,
                          cache_mode="gather")
