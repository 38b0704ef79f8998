"""The port's DudDecoder (novic_tpu_torch.models.dud) against novic_tpu's.

Both packages build the dud through create_decoder from the same word
tokenizer and target config: the four cases of tests/test_dud.py (the cheating
forward, the constant greedy noun, beam and 'all', the multi-target dedup)
give equal outputs, with weights and in the MxBxC layout too; then a checkpoint
loaded as a DudDecoder serves greedy, beam and 'all' gencfgs through both
packages' GenerationTask alike.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import novic_tpu.infer as jax_infer
from novic_tpu.embedders.base import Embedder as JEmbedder
from novic_tpu.models import DecoderModelConfig as JConfig
from novic_tpu.models import create_decoder as jax_create_decoder
from novic_tpu.text.simple import make_test_tokenizer as jax_make_test_tokenizer
from novic_tpu.text.target import TargetTokenizer as JTargetTokenizer
from novic_tpu.text.target import create_target_config as jax_create_target_config
from novic_tpu_torch import infer
from novic_tpu_torch.embedders.base import Embedder
from novic_tpu_torch.models.base import create_decoder
from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.models.dud import DudDecoder
from novic_tpu_torch.text.simple import make_test_tokenizer
from novic_tpu_torch.text.target import TargetTokenizer, create_target_config

NOUNS = ["dog", "cat", "unknown", "sea lion"]
FT0 = os.path.join(os.path.dirname(__file__), "..", "assets", "bench_ft0_decoder.npz")
TC_KW = dict(with_start_token=False, with_end_token=True, compact_ids=True,
             fixed_token_length=True, auto_fixed_token_length=True, use_masks=True)


def make_duds(nouns=NOUNS):
    tt = TargetTokenizer(make_test_tokenizer(nouns), create_target_config(
        make_test_tokenizer(nouns), nouns, **TC_KW))
    jtt = JTargetTokenizer(jax_make_test_tokenizer(nouns), jax_create_target_config(
        jax_make_test_tokenizer(nouns), nouns, **TC_KW))
    tc = tt.target_config
    kw = dict(embed_dim=8, vocab_size=tc.vocab_size, token_length=tc.token_length,
              model="DudDecoder")
    model = create_decoder(DecoderModelConfig(**kw), device="cpu", target_tokenizer=tt)
    jmodel, params = jax_create_decoder(JConfig(**kw), target_tokenizer=jtt)
    assert isinstance(model, DudDecoder) and params == {}
    return model, jmodel, tt


def _eq(out, ref):
    for a, b in zip(out, ref, strict=True):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dud_forward_all_correct():
    model, jmodel, tt = make_duds()
    ids, mask = tt.tokenize_target(["dog", "sea lion"])
    embed = np.ones((2, 8), np.float32) / np.sqrt(8)
    out = model(torch.from_numpy(embed), torch.from_numpy(ids), torch.from_numpy(mask),
                calc_loss=True, calc_correct=True)
    ref = jmodel(jnp.asarray(embed), jnp.asarray(ids), jnp.asarray(mask),
                 calc_loss=True, calc_correct=True)
    _eq(out, ref)
    assert float(out[2]) == 1.0 and float(out[3]) == 1.0
    np.testing.assert_array_equal(out[4].numpy(), ~mask)  # it cheats
    # only_pred keeps the last position
    _eq(model(torch.from_numpy(embed), torch.from_numpy(ids), only_pred=True, calc_correct=True),
        jmodel(jnp.asarray(embed), jnp.asarray(ids), only_pred=True, calc_correct=True))


@pytest.mark.parametrize("temperature,alpha", [(1.0, 0.0), (2.0, 0.5)])
def test_dud_generate_unknown(temperature, alpha):
    model, jmodel, tt = make_duds()
    embed = np.ones((3, 8), np.float32) / np.sqrt(8)
    kw = dict(calc_loss=True, temperature=temperature, length_alpha=alpha)
    out = model.generate(torch.from_numpy(embed), **kw)
    ref = jmodel.generate(jnp.asarray(embed), **kw)
    assert tt.detokenize_target(out[0].numpy()) == ["unknown"] * 3
    for a, b in zip(out, ref, strict=True):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


def test_dud_beam_and_all():
    model, jmodel, tt = make_duds()
    embed = np.ones((2, 8), np.float32) / np.sqrt(8)
    out = model.generate_beam(torch.from_numpy(embed), topk=3)
    _eq(out, jmodel.generate_beam(jnp.asarray(embed), topk=3))
    assert out[2][:, 0].tolist() == [-1.0, -1.0] and bool((out[2][:, 1:] < -1e29).all())
    guides, _ = tt.tokenize_target(["dog", "cat"])
    assert model.precompute_generate_all() is None
    out = model.generate_all(torch.from_numpy(embed), topk=2, guide_targets=guides)
    _eq(out, jmodel.generate_all(jnp.asarray(embed), topk=2, guide_targets=guides))
    assert out[0].shape == (2, 2, guides.shape[1])


@pytest.mark.parametrize("weighted,multi_first", [(False, False), (True, False), (True, True)])
def test_dud_multi_target_dedup(weighted, multi_first):
    """Multi-target dedup: each group of prefix-equal targets predicts its
    (weight-)majority continuation, as the JAX package's dud does."""
    model, jmodel, tt = make_duds()
    ids, mask = tt.tokenize_target(["sea lion", "sea lion", "sea lion", "dog", "cat", "sea"])
    C = ids.shape[1]
    target, padding = ids.reshape(2, 3, C), mask.reshape(2, 3, C)
    weight = np.array([[1.0, 2.0, 0.0], [0.5, 3.0, 1.0]], np.float32) if weighted else None
    if multi_first:
        target, padding = target.transpose(1, 0, 2).copy(), padding.transpose(1, 0, 2).copy()
        weight = weight.T.copy()
    embed = np.ones((2, 8), np.float32) / np.sqrt(8)
    t = lambda x: None if x is None else torch.from_numpy(x)
    j = lambda x: None if x is None else jnp.asarray(x)
    kw = dict(calc_loss=True, calc_correct=True, multi_first=multi_first)
    out = model(t(embed), t(target), t(padding), t(weight), **kw)
    ref = jmodel(j(embed), j(target), j(padding), j(weight), **kw)
    _eq(out, ref)
    c, m = out[4].numpy(), out[1].numpy()
    first = c[:, 0] if multi_first else c[0]
    assert (first | (m[:, 0] if multi_first else m[0])).any()


@pytest.mark.parametrize("gencfg", ["greedy_k1_vnone_gn_t1_a0", "beam_k3_vnone_gn_t1_a0",
                                    "all_k4_vnone_gp_t1_a0"])
def test_dud_serves_through_generation_task(gencfg):
    """A checkpoint loaded with model_override="DudDecoder" serves each method
    through GenerationTask as the JAX package's does."""
    outs = []
    for pkg, emb_cls, kw in ((jax_infer, JEmbedder, {}), (infer, Embedder, {"device": "cpu"})):
        embedder = emb_cls.create("test:768", load_model=False, **kw)
        dec = pkg.load_decoder_from_checkpoint(FT0, embedder, model_override="DudDecoder", **kw)
        assert dec.is_dud
        nouns = list(dec.target_vocab[:50])
        ids, strs = pkg.load_guide_targets(dec.target_tokenizer, nouns)
        task = pkg.GenerationTask(gencfg=pkg.GenerationConfig.from_name(gencfg), decoder=dec,
                                  vocab_targets_set=set(strs), vocab_targets=ids,
                                  guide_targets_set=set(strs), guide_targets=ids)
        task.batch_pad = 4
        emb = np.random.default_rng(1).normal(size=(3, 768)).astype(np.float32)
        task.process(emb)
        outs.append((task.target, task.target_padding, task.target_score, task.target_str,
                     task.result.tolist()))
    (t, p, s, strs, res), (jt, jp, js, jstrs, jres) = outs[1], outs[0]
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_allclose(s, js, rtol=1e-6)
    assert strs == jstrs and res == jres
    # One constant noun ("" here: the asset's word vocabulary cannot encode "unknown")
    assert len({row[0] for row in strs}) == 1
