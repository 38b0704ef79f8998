"""Port beam search with vocab priors against the JAX package, on the FT0 decoder.

Float32 parameters (the asset's float16 arrays cast, as the port loads them),
B=2 seeded unit embeddings; per target and per token, through the tries (the
full 42,919-noun vocabulary, as its own guide set or unguided) and through the
alive mask (300 rows). The port in cache_mode="reorder" against JAX's default
mode: tokens and paddings identical, scores within 1e-5; the port's lazy mode
equal to its reorder mode.
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
TRIE_KEYS = ("child_tok", "child_id", "child_pack", "child_cnt", "node_cnt")


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
    model = decoder_from_numpy(ck["model_config"], ck["params"])
    G = model.cfg.token_length - 1
    # The full vocabulary's tries (JAX's, the port's), built once
    jt = jax_build_guide_trie(gids, model.cfg.vocab_size, G)
    jt.pop("pack_tok_bits")
    t = build_guide_trie(gids, model.cfg.vocab_size, G)
    return dict(model=model, jmodel=JDecoder(cfg=jck["model_config"]),
                jparams=jax.tree.map(lambda a: np.asarray(a, np.float32), jck["params"]),
                gids=gids, embed=embed, jtrie=jax.device_put(jt),
                trie={k: [torch.from_numpy(x) for x in t[k]] for k in TRIE_KEYS})


@pytest.mark.parametrize("gencfg,rows", [
    ("beam_k5_vtgt0.4_gn_t1_a0", None),      # vocab trie, per target
    ("beam_k5_vtok1_gn_t2_a0", None),        # vocab trie, per token
    ("beam_k5_vtgt0.4_gr_t10_a0.5", None),   # the guide trie carries the counts
    ("beam_k4_vtok1_gp_t1.5_a0", 300),       # guide mask = vocab mask, per token
    ("beam_k4_vtgt0.5_gn_t1_a0.3", 300),     # vocab mask, per target
])
def test_vocab_priors_match_jax(ft0, gencfg, rows):
    g = GenerationConfig.from_name(gencfg)
    model = ft0["model"]
    ids = ft0["gids"] if rows is None else ft0["gids"][:rows]
    guide = ids if g.guided else None
    jtrie = trie = jvtrie = vtrie = None
    if rows is None:  # the tries, as GenerationTask builds them at this size
        if g.guided:
            jtrie, trie = ft0["jtrie"], ft0["trie"]
        else:
            jvtrie, vtrie = ft0["jtrie"], ft0["trie"]
    kw = dict(topk=g.topk, temperature=g.temperature, length_alpha=g.length_alpha,
              guide_renorm=g.guide_renorm, vocab_per_token=g.vocab_per_token,
              vocab_scaler=g.vocab_scaler)
    jm = ft0["jmodel"]
    fn = jax.jit(lambda p, e, gt, vt: jax_generate_beam(
        jm, p, e, guide_targets=guide, vocab_targets=ids, guide_trie=gt, vocab_trie=vt, **kw))
    jt, jp, js = (np.asarray(x) for x in fn(ft0["jparams"], ft0["embed"], jtrie, jvtrie))
    ids_t = torch.from_numpy(ids.astype(np.int64))
    e = torch.from_numpy(ft0["embed"])
    outs = {}
    for mode in ("reorder", "lazy"):
        outs[mode] = [x.numpy() for x in generate.generate_beam(
            model, e, guide_targets=ids_t if g.guided else None, vocab_targets=ids_t,
            guide_trie=trie, vocab_trie=vtrie, cache_mode=mode, **kw)]
    t, p, s = outs["reorder"]
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-5)
    assert np.all(np.diff(s, axis=1) <= 1e-6)
    for a, b in zip(outs["lazy"], outs["reorder"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(outs["lazy"][0], t)
