"""The port's exhaustive guided scoring (generate_all) against the JAX package.

The same seeded numpy inputs and the same parameters (bridge.decoder_from_numpy)
go through novic_tpu.models.generate and novic_tpu_torch.models.generate:
- score_hidden (the prefix-cached extend) within 1e-5, on a small random
  decoder pre-LN and post-LN and on the FT0 asset as stored in float16;
- precompute_generate_all array by array: trie tables and nodes bit-equal,
  vocab_scores and alpha_scale equal in float32;
- generate_all: targets and paddings identical, scores within rtol = atol = 1e-5
  (float32 sums in another order: JAX's attention is a broadcast-reduce, the
  port's an einsum), over tests/test_decoder.py's kwarg cases on a small decoder
  and on the FT0 asset (float16) at its first 2,048 guide targets, B=2;
- the chunk and max_scan_chunks invariance, and the top-k row JAX's
  jax.lax.top_k picks among duplicated guide rows;
- the 'all' gencfgs through both packages' NOVICModel and GenerationTaskList.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import novic_tpu.infer as jax_infer
import novic_tpu.models.generate as jax_gen
from novic_tpu.infer import load_guide_targets as jax_load_guide_targets
from novic_tpu.models import DecoderModelConfig as JConfig
from novic_tpu.models.prefixed_iter import PrefixedIterDecoder as JDecoder
from novic_tpu.text.simple import make_test_tokenizer as jax_make_test_tokenizer
from novic_tpu.text.target import TargetTokenizer as JTargetTokenizer
from novic_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from novic_tpu_torch import infer
from novic_tpu_torch.bridge import decoder_from_numpy
from novic_tpu_torch.models import generate
from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.text.simple import make_test_tokenizer
from novic_tpu_torch.text.target import TargetTokenizer
from novic_tpu_torch.train.checkpoint import load_checkpoint

torch.set_num_threads(2)
FT0 = os.path.join(os.path.dirname(__file__), "..", "assets", "bench_ft0_decoder.npz")
V, CMAX, F = 23, 7, 32
SMALL = dict(embed_dim=F, vocab_size=V, token_length=CMAX, hidden_dim=64, feedfwd_scale="1/4",
             num_layers=2, num_heads=4, input_dropout=0.0, layer_dropout=0.0)
TOL = dict(rtol=1e-5, atol=1e-5)
TRIE_TABLES = ("child_tok", "child_id", "child_cnt", "node_cnt", "child_pack")


def _small(layer_norm_first: bool = True):
    jm = JDecoder(cfg=JConfig(**SMALL, layer_norm_first=layer_norm_first,
                              matmul_precision="highest"))
    params = jm.init({"params": jax.random.PRNGKey(7)}, jnp.zeros((1, F)),
                     jnp.zeros((1, CMAX), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    cfg = DecoderModelConfig(**SMALL, layer_norm_first=layer_norm_first)
    return jm, params, decoder_from_numpy(cfg, params)


@pytest.fixture(scope="module")
def small():
    return _small()


def _unit(rng, B, dim=F):
    e = rng.normal(size=(B, dim)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _guides(W=17, seed=3):
    """Random guide rows of every length (content tokens, end token, padding),
    with exact duplicates."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, CMAX - 1, size=W)
    toks = rng.integers(1, V, size=(W, CMAX)).astype(np.int32)
    guide = np.where(np.arange(CMAX)[None, :] < lengths[:, None], toks, 0).astype(np.int32)
    guide[5] = guide[2]
    guide[9] = guide[2]
    return guide


@pytest.fixture(scope="module")
def ft0():
    ck, jck = load_checkpoint(FT0), jax_load_checkpoint(FT0)
    nouns = ck["target_nouns"][ck["num_invalid_target_nouns"]:]
    gids, _ = infer.load_guide_targets(
        TargetTokenizer(make_test_tokenizer(nouns), ck["target_config"]), nouns)
    jgids, _ = jax_load_guide_targets(
        JTargetTokenizer(jax_make_test_tokenizer(nouns), jck["target_config"]), nouns)
    np.testing.assert_array_equal(gids, jgids)
    model = decoder_from_numpy(ck["model_config"], ck["params"])  # float16 values, as stored
    assert model.float16_params
    return dict(model=model, jmodel=JDecoder(cfg=jck["model_config"]), jparams=jck["params"],
                gids=gids, embed=_unit(np.random.default_rng(0), 2, 768))


def _jax_all(jm, params, embed, **kw):
    return [np.asarray(x) for x in jax_gen.generate_all(jm, params, jnp.asarray(embed), **kw)]


def _port_all(model, embed, **kw):
    return [x.numpy() for x in generate.generate_all(model, torch.from_numpy(embed), **kw)]


def _assert_same(out, ref):
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_allclose(out[2], ref[2], **TOL)
    assert np.all(np.diff(out[2], axis=1) <= 0)


@pytest.mark.parametrize("case", ["pre_ln", "post_ln", "ft0_float16"])
def test_score_hidden_matches_jax(case, ft0):
    """score_hidden (Transformer.extend against prefill_split's frozen prefix)
    gives JAX's hidden states within 1e-5, and prefill_split its logits."""
    if case == "ft0_float16":
        jm, params, model = ft0["jmodel"], ft0["jparams"], ft0["model"]
        embed, vocab = ft0["embed"], model.cfg.vocab_size
    else:
        jm, params, model = _small(layer_norm_first=case == "pre_ln")
        embed, vocab = _unit(np.random.default_rng(1), 2), V
    rng = np.random.default_rng(2)
    R, T = 3, model.cfg.token_length - 1
    tokens = rng.integers(1, vocab, size=(2 * R, T)).astype(np.int32)
    jlogits, jpk, jpv = jm.apply({"params": params}, jnp.asarray(embed), method="prefill_split")
    jh = jm.apply({"params": params}, jnp.asarray(tokens), jpk, jpv, method="score_hidden")
    with torch.no_grad():
        logits, pk, pv = model.prefill_split(torch.from_numpy(embed))
        h = model.score_hidden(torch.from_numpy(tokens.astype(np.int64)), pk, pv)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert h.shape == (2 * R, T, model.cfg.hidden_dim)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("renorm,vocab,per_token,alpha", [
    (False, False, False, 0.0),
    (True, False, False, 0.0),
    (False, True, False, 0.6),
    (True, True, False, 0.0),
    (True, True, True, 1.25),
    (False, True, True, 0.0),
])
def test_precompute_matches_jax(renorm, vocab, per_token, alpha):
    """precompute_generate_all array by array, over a guide set with duplicate
    rows and a vocab set in which some guide prefixes are dead."""
    rng = np.random.default_rng(3)
    Wn, C, Vs = 37, 5, 13
    lengths = rng.integers(1, C, size=Wn)
    toks = rng.integers(1, Vs, size=(Wn, C), dtype=np.int32)
    guides = np.where(np.arange(C)[None, :] < lengths[:, None], toks, 0).astype(np.int32)
    guides[5] = guides[6] = guides[2]
    vt = np.concatenate([guides[::2], guides[:3]], axis=0) if vocab else None
    kw = dict(length_alpha=alpha, vocab_targets=vt, vocab_per_token=per_token,
              vocab_scaler=0.7 if vocab else 0.0, guide_targets=guides, guide_renorm=renorm)
    pre = generate.precompute_generate_all(Vs, **kw)
    ref = jax_gen.precompute_generate_all(Vs, **kw)
    for name in ("guide_targets", "guide_paddings", "guide_nodes", "vocab_scores", "alpha_scale"):
        a, b = getattr(pre, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b)
    assert (pre.renorm_trie is None) == (ref.renorm_trie is None) == (not renorm)
    if renorm:
        for table in TRIE_TABLES:
            for a, b in zip(pre.renorm_trie[table], ref.renorm_trie[table], strict=True):
                np.testing.assert_array_equal(a, b)


# tests/test_decoder.py's kwarg cases, on a guide set of every length with duplicates
ALL_CASES = [
    dict(topk=4),
    dict(topk=1),
    dict(topk=3, length_alpha=0.7),
    dict(topk=4, temperature=0.7),
    dict(topk=4, guide_renorm=True),
    dict(topk=3, vocab=True, vocab_scaler=0.5),
    dict(topk=3, vocab=True, vocab_scaler=0.5, vocab_per_token=True, guide_renorm=True),
    dict(topk=4, temperature=0.7, length_alpha=0.3, guide_renorm=True),
    dict(topk=6, vocab=True, vocab_scaler=0.35, length_alpha=0.6),
]


@pytest.mark.parametrize("kw", ALL_CASES)
def test_generate_all_matches_jax(small, kw):
    jm, params, model = small
    kw = dict(kw)
    guides = _guides()
    if kw.pop("vocab", False):
        kw["vocab_targets"] = guides[::2]
    kw.update(guide_targets=guides, chunk=3)
    embed = _unit(np.random.default_rng(31), 4)
    _assert_same(_port_all(model, embed, **kw), _jax_all(jm, params, embed, **kw))


@pytest.mark.parametrize("gencfg", ["all_k10_vnone_gp_t1_a0", "all_k5_vtgt0.5_gr_t1_a0.5"])
def test_generate_all_ft0_matches_jax(ft0, gencfg):
    """The FT0 decoder (float16 as stored) at its first 2,048 guide targets, B=2;
    the vocab prior over all 42,919 nouns."""
    g = infer.GenerationConfig.from_name(gencfg)
    kw = dict(topk=g.topk, temperature=g.temperature, length_alpha=g.length_alpha,
              guide_renorm=g.guide_renorm, vocab_per_token=g.vocab_per_token,
              vocab_scaler=g.vocab_scaler, guide_targets=ft0["gids"][:2048],
              vocab_targets=ft0["gids"] if g.vocab_prior else None)
    ref = _jax_all(ft0["jmodel"], ft0["jparams"], ft0["embed"], **kw)
    out = _port_all(ft0["model"], ft0["embed"], chunk=256, **kw)
    _assert_same(out, ref)
    assert out[0].shape == (2, g.topk, 8)


@pytest.mark.parametrize("renorm", [False, True])
def test_generate_all_chunking_invariant(small, renorm):
    """Chunk size changes neither the candidate rows nor the scores (beyond
    float32 sums in another order); max_scan_chunks (JAX's scan length) changes
    nothing, and JAX's output at max_scan_chunks=1 is the port's."""
    jm, params, model = small
    guides = _guides(W=23, seed=4)
    embed = _unit(np.random.default_rng(24), 3)
    kw = dict(topk=7, guide_targets=guides, guide_renorm=renorm)
    base = _port_all(model, embed, chunk=2, **kw)
    for extra in (dict(chunk=2, max_scan_chunks=1), dict(chunk=5), dict(chunk=64), dict()):
        other = _port_all(model, embed, **kw, **extra)
        np.testing.assert_array_equal(other[0], base[0])
        np.testing.assert_array_equal(other[1], base[1])
        np.testing.assert_allclose(other[2], base[2], rtol=1e-6, atol=1e-6)
    _assert_same(_port_all(model, embed, chunk=2, max_scan_chunks=1, **kw),
                 _jax_all(jm, params, embed, chunk=2, max_scan_chunks=1, **kw))


@pytest.mark.parametrize("chunk,max_scan_chunks", [(2, 256), (3, 1)])
def test_duplicate_rows_resolve_to_jax_row(small, monkeypatch, chunk, max_scan_chunks):
    """Exactly duplicated guide rows score alike, so the top-k breaks the tie by
    row: the port's stable sort picks, among the length-sorted rows, the row
    jax.lax.top_k picks, for every rank. JAX's rows hold its scans' padding:
    with top-k over every guide it picks each real row once and no padded row,
    so a real row's rank among the picked indices is its length-sorted index."""
    jm, params, model = small
    guides = np.concatenate([_guides(), _guides()[::-1], _guides()[:4]])
    embed = _unit(np.random.default_rng(5), 2)
    picked = {}

    def spy(name, fn):
        def wrapped(x, k):
            out = fn(x, k)
            picked[name] = np.asarray(out[1])
            return out
        return wrapped

    monkeypatch.setattr(jax.lax, "top_k", spy("jax", jax.lax.top_k))
    monkeypatch.setattr(generate, "_top_k", spy("port", generate._top_k))
    kw = dict(guide_targets=guides, chunk=chunk, max_scan_chunks=max_scan_chunks)
    ref = _jax_all(jm, params, embed, topk=len(guides), **kw)
    out = _port_all(model, embed, topk=len(guides), **kw)
    jax_rows = np.stack([np.searchsorted(np.sort(r), r) for r in picked["jax"]])
    np.testing.assert_array_equal(picked["port"], jax_rows)
    _assert_same(out, ref)
    # The ties are real: duplicated rows got bit-equal scores
    scores = out[2][0]
    assert (np.diff(scores[scores > -1e29]) == 0).any()


def test_generate_all_needs_guides(small):
    with pytest.raises(ValueError, match="guide_targets"):
        generate.generate_all(small[2], torch.zeros((1, F)), topk=1)


# Serving: the 'all' gencfgs of tests/test_infer.py through both packages, the
# FT0 decoder (float16 as stored) guided by 48 of its nouns
ALL_GENCFGS = ["all_k3_vnone_gr_t1_a0", "all_k3_vtok1_gp_t2_a1", "all_k4_vtgt0.5_gp_t1_a0.5"]


@pytest.fixture(scope="module")
def guide_nouns():
    ck = load_checkpoint(FT0)
    nouns = ck["target_nouns"][ck["num_invalid_target_nouns"]:]
    return list(nouns[::900][:48])


@pytest.mark.parametrize("gencfg", ALL_GENCFGS)
def test_classify_embeds_all_matches_jax(guide_nouns, gencfg):
    emb = _unit(np.random.default_rng(9), 5, 768)
    common = dict(embedder_spec="test:768", gencfg=gencfg, batch_size=4,
                  guide_targets=guide_nouns)
    with jax_infer.NOVICModel(FT0, **common) as jmodel:
        ref = jmodel.classify_embeds(emb)
    with infer.NOVICModel(FT0, device="cpu", **common) as model:
        out = model.classify_embeds(emb)
        assert model.task.precompute is not None
    k = infer.GenerationConfig.from_name(gencfg).topk
    assert np.array(out.logprobs).shape == (5, k)
    assert out.preds == ref.preds
    assert out.types == ref.types
    assert all(p in guide_nouns for row in out.preds for p in row)
    np.testing.assert_allclose(np.array(out.logprobs), np.array(ref.logprobs), atol=1e-4, rtol=1e-4)


def test_task_list_shares_the_precompute(guide_nouns):
    """GenerationTaskList computes one precompute per gencfg axes and target
    arrays, shared by tasks that differ elsewhere (temperature, top-k), and
    leaves each task as a lone run does."""
    names = ["all_k3_vnone_gr_t1_a0", "all_k2_vnone_gr_t2_a0", "all_k3_vtgt0.5_gp_t1_a0"]
    emb = _unit(np.random.default_rng(5), 3, 768)
    model = infer.NOVICModel(FT0, device="cpu", embedder_spec="test:768", batch_size=3,
                             guide_targets=guide_nouns)
    with model:
        first = model.task_for(names[0])
        tasks = infer.GenerationTaskList([infer.GenerationTask(
            gencfg=infer.GenerationConfig.from_name(n), decoder=model.decoder,
            vocab_targets_set=first.vocab_targets_set, vocab_targets=first.vocab_targets,
            guide_targets_set=first.guide_targets_set, guide_targets=first.guide_targets)
            for n in names])
        tasks.clear()
        tasks.process(emb)
        assert len(tasks.precompute_cache) == 2
        assert tasks.tasks[0].precompute is tasks.tasks[1].precompute
        got = [(t.target_str, t.target_score) for t in tasks.tasks]
        for task in tasks.tasks:
            task.clear(clear_precompute=True)
            assert task.precompute is None and task.target is None
        for name, (strs, scores) in zip(names, got):
            single = model.classify_embeds(emb, gencfg=name)
            assert single.preds == strs
            np.testing.assert_allclose(single.logprobs, scores, rtol=1e-6)


def test_cli_serves_all_gencfg(guide_nouns, tmp_path, capsys):
    """The inference CLI takes an 'all' gencfg, a guide file and --precompute_dir."""
    from PIL import Image

    path = str(tmp_path / "frame.png")
    Image.fromarray(np.random.default_rng(3).integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(path)
    guide_file = tmp_path / "guides.txt"
    guide_file.write_text("\n".join(guide_nouns))
    store = tmp_path / "store"
    infer.main(["--checkpoint", FT0, "--embedder", "test:768", "--device", "cpu",
                "--gencfg", "all_k3_vnone_gr_t1_a0", "--guide_targets_file", str(guide_file),
                "--precompute_dir", str(store), "--images", path])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"{path} --> ") and line.count("%)") == 3
    assert len(os.listdir(store)) == 1


def test_precompute_object_is_reused_per_device(small):
    """The renorm tables move to a device once per precompute."""
    _, _, model = small
    guides = _guides()
    pre = generate.precompute_generate_all(V, length_alpha=0.0, vocab_targets=None,
                                           vocab_per_token=False, vocab_scaler=0.0,
                                           guide_targets=guides, guide_renorm=True)
    e = torch.from_numpy(_unit(np.random.default_rng(6), 2))
    a = generate.generate_all(model, e, topk=3, precompute=pre)
    tables = pre._renorm_device[torch.device("cpu")]
    b = generate.generate_all(model, e, topk=3, precompute=pre)
    assert pre._renorm_device[torch.device("cpu")] is tables
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
