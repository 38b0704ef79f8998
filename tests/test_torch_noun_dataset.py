"""The port's noun dataset (novic_tpu_torch.data.noun_dataset) against
novic_tpu's on the CPU.

* Index arithmetic: counts, every FSID's and USID's details and text, the
  unique_sample stream, the prompt and hypernym templates and
  cache_config_key are equal to the JAX package's, over
  tests/test_noun_dataset.py's vocabulary with the built-in prompts and over
  data/prompts.json's collections with the Type, Example and Debug hypernyms.
* Loader batches (cached and uncached, training and evaluation) are equal
  array for array for the same seed, with the 'test:24' hash embedder.
* The noun cache: with 'test:24' its file name and bytes equal the JAX
  package's. With a tiny real text tower (a JaxEmbedder and a TorchEmbedder
  loading the same seeded .npz, float32 compute) the file name and the
  target and mask sections of every row are equal, and the embeddings agree
  to atol = rtol = 5e-3 (the bar of tests/test_torch_text_tower.py); the
  32-row re-embedding sanity check passes on both.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import novic_tpu.ops.attention as jax_attention
from novic_tpu.data.noun_dataset import BUILTIN_PROMPTS as J_BUILTIN_PROMPTS
from novic_tpu.data.noun_dataset import NounDataset as JNounDataset
from novic_tpu.embedders import vit as jvit
from novic_tpu.embedders.base import Embedder as JEmbedder
from novic_tpu.embedders.base import JaxEmbedder
from novic_tpu.embedders.convert import save_params_npz
from novic_tpu.embedders.registry import REGISTRY as JREGISTRY
from novic_tpu.text.simple import make_test_tokenizer as j_make_test_tokenizer
from novic_tpu_torch.data.noun_dataset import BUILTIN_PROMPTS, NounDataset
from novic_tpu_torch.embedders.base import Embedder, TorchEmbedder
from novic_tpu_torch.embedders.registry import REGISTRY
from novic_tpu_torch.text.simple import make_test_tokenizer

torch.set_num_threads(2)
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PROMPTS_JSON = os.path.join(REPO, "data", "prompts.json")
TOWER_TOL = 5e-3  # tests/test_torch_text_tower.py's float32 bar

VOCAB = [  # tests/test_noun_dataset.py's
    {"id": 0, "target_noun": "animal", "pretty_noun": "Animal",
     "singulars": ["animal"], "plurals": ["animals"],
     "singulars_freq": [2], "plurals_freq": [1], "hypernyms": []},
    {"id": 1, "target_noun": "dog", "pretty_noun": "Dog",
     "singulars": ["dog", "hound"], "plurals": ["dogs"],
     "singulars_freq": [3, 1], "plurals_freq": [2], "hypernyms": [0]},
    {"id": 2, "target_noun": "fire truck", "pretty_noun": "Fire Truck",
     "singulars": ["fire truck", "fire engine"], "plurals": ["fire trucks"],
     "singulars_freq": [2, 2], "plurals_freq": [1], "hypernyms": []},
    {"id": 3, "target_noun": "apple", "pretty_noun": "Apple",
     "singulars": ["apple"], "plurals": ["apples"],
     "singulars_freq": [1], "plurals_freq": [1], "hypernyms": [0]},
]
NOUNS = [v["target_noun"] for v in VOCAB]
TC_KWARGS = dict(with_start_token=False, with_end_token=True, compact_ids=True,
                 auto_fixed_token_length=True, use_masks=True)

# (prompt source, prompt collection, hypernym collection, vocab_thres)
CONFIGS = [
    ("builtin", "Basic", "None | Type", 0),
    ("builtin", "Basic", "None", 2),
    ("json", "ImageNet1KSel", "Type", 0),
    ("json", "CIFAR | ImageNet1KSel", "Example", 0),
    ("json", "ImageNet1KSel", "Debug | Type", 0),
]


def _pair(cfg, jemb=None, pemb=None, **kw):
    source, prompts, hypernyms, thres = cfg
    common = dict(vocab_json=VOCAB, prompt_collection=prompts, hypernym_collection=hypernyms,
                  vocab_thres=thres, **kw)
    if source == "builtin":
        jds = JNounDataset(jemb or JEmbedder.create("test:24"), prompt_json=J_BUILTIN_PROMPTS,
                           **common)
        pds = NounDataset(pemb or Embedder.create("test:24", device="cpu"),
                          prompt_json=BUILTIN_PROMPTS, **common)
    else:
        jds = JNounDataset(jemb or JEmbedder.create("test:24"), prompt_path=PROMPTS_JSON, **common)
        pds = NounDataset(pemb or Embedder.create("test:24", device="cpu"),
                          prompt_path=PROMPTS_JSON, **common)
    return jds, pds


def _configure(ds, fixed=True):
    emb = ds.embedder
    tc = emb.create_target_config(list(ds.targets), fixed_token_length=fixed, **TC_KWARGS)
    emb.configure_target(tc, list(ds.targets))
    ds.configure_target()
    ds.configure_data(ds.resolve_data_config())


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(map(str, c)))
def test_index_arithmetic_and_texts_match_jax(cfg):
    jds, pds = _pair(cfg, check_consistent=True)
    for attr in ("num_tids", "num_fsids", "num_usids", "target_nouns", "prompt_collection",
                 "hypernym_collection", "no_hypernym_freqs", "unique_hypernyms",
                 "total_freq_hypernyms"):
        assert getattr(pds, attr) == getattr(jds, attr), attr
    for attr in ("target_fsid_map", "target_usid_map"):
        np.testing.assert_array_equal(getattr(pds, attr), getattr(jds, attr))
    for attr in ("singular_prompts", "plural_prompts", "hypernym_prompts"):
        assert ([dataclasses.astuple(p) for p in getattr(pds, attr)]
                == [dataclasses.astuple(p) for p in getattr(jds, attr)]), attr
    # The whole unique-sample stream (check_consistent cross-checks every FSID)
    js = [(s.fsid, s.usid, s.freq, s.noun, s.text, s.target) for s in jds.unique_sample()]
    ps = [(s.fsid, s.usid, s.freq, s.noun, s.text, s.target) for s in pds.unique_sample()]
    assert ps == js and len(ps) == pds.num_usids
    for fsid in range(pds.num_fsids):
        assert pds.get_sample_usid(fsid) == jds.get_sample_usid(fsid)
        assert pds.get_sample_text(fsid=fsid) == jds.get_sample_text(fsid=fsid)
        assert pds[fsid] == jds[fsid]
    for usid in range(pds.num_usids):
        assert pds.get_sample_text(usid=usid) == jds.get_sample_text(usid=usid)
    with pytest.raises(IndexError):
        pds.get_sample_details(fsid=pds.num_fsids)
    with pytest.raises(IndexError):
        pds.get_sample_details(usid=-1)
    _configure(jds)
    _configure(pds)
    assert pds.cache_config_key() == jds.cache_config_key()


def test_bad_vocab_and_prompts_raise_alike():
    bad = [dict(VOCAB[0], id=-1), dict(VOCAB[1], hypernyms=[9]),
           dict(VOCAB[0], singulars_freq=[0]), dict(VOCAB[0], target_noun="")]
    for entry in bad:
        for cls, emb, prompts in ((JNounDataset, JEmbedder.create("test:8"), J_BUILTIN_PROMPTS),
                                  (NounDataset, Embedder.create("test:8", device="cpu"),
                                   BUILTIN_PROMPTS)):
            with pytest.raises(ValueError):
                cls(emb, vocab_json=[entry] + VOCAB[2:], prompt_json=prompts)
    for collection in ("Nope", "Basic | Nope"):
        with pytest.raises(ValueError, match="invalid values"):
            NounDataset(Embedder.create("test:8", device="cpu"), vocab_json=VOCAB,
                        prompt_collection=collection)


def _batches(ds, batch_size, training, seed, fixed):
    _configure(ds, fixed)
    loader, info = ds.create_loader(batch_size=batch_size, training=training, seed=seed)
    with ds.loaded():
        out = [tuple(None if x is None else np.array(x) for x in b) for b in loader]
    return out, info


@pytest.mark.parametrize("cached,training,fixed", [(False, True, False), (False, False, True),
                                                   (True, True, True), (True, False, True)])
def test_loader_batches_match_jax(tmp_path, cached, training, fixed):
    cfg = ("json", "ImageNet1KSel", "Type", 0)
    kw = {"cache_dir": str(tmp_path / "noun")} if cached else {}
    jds, pds = _pair(cfg, **kw)
    (jb, jinfo), (pb, pinfo) = (_batches(jds, 16, training, 5, fixed),
                                _batches(pds, 16, training, 5, fixed))
    assert dataclasses.asdict(pinfo) == dataclasses.asdict(jinfo)
    assert len(pb) == len(jb) == jinfo.epoch_batches
    for a, b in zip(jb, pb):
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
    assert pb[0][0].shape == (16, 24) and pb[0][3] is None


def test_noun_cache_file_byte_identical_with_hash_embedder(tmp_path):
    cfg = ("json", "ImageNet1KSel", "Debug | Type", 0)
    jds, pds = _pair(cfg, cache_dir=str(tmp_path / "jax"))
    pds.cache_dir = str(tmp_path / "port")
    for ds in (jds, pds):
        _configure(ds)
        with ds.loaded():
            pass
    jpath, ppath = jds.cache_path(), pds.cache_path()
    assert os.path.basename(jpath) == os.path.basename(ppath)
    with open(jpath, "rb") as f1, open(ppath, "rb") as f2:
        assert f1.read() == f2.read()
    # The port reads the JAX package's file (and passes its sanity check)
    os.replace(jpath, ppath)
    with pds.loaded():
        e, t, m, _ = pds[7]
        assert e.shape == (24,) and t.dtype == np.int32 and m.dtype == np.bool_


# -- a tiny real text tower on both sides -------------------------------------

SPEC = "openclip:timm/ViT-B-16-SigLIP"


def _small(arch):
    return dataclasses.replace(
        arch, vision=dataclasses.replace(arch.vision, patch_size=32, width=64, layers=1, heads=4),
        text=dataclasses.replace(arch.text, width=64, layers=2, heads=4, vocab_size=64,
                                 context_length=16))


@pytest.fixture
def interpreted_pallas(monkeypatch):
    attn = jax_attention.fused_attention
    monkeypatch.setattr(jax_attention, "fused_attention",
                        lambda q, k, v, bias=None, **kw: attn(q, k, v, bias, interpret=True))


@pytest.fixture(scope="module")
def tower_weights(tmp_path_factory):
    jarch = _small(JREGISTRY[SPEC])
    kv, kt = jax.random.split(jax.random.PRNGKey(7))
    vparams = jvit.VisionTransformer(cfg=jarch.vision).init({"params": kv},
                                                             jnp.zeros((1, 224, 224, 3)))["params"]
    tparams = jvit.TextTransformer(cfg=jarch.text).init(
        {"params": kt}, jnp.zeros((1, jarch.text.context_length), jnp.int32))["params"]
    path = str(tmp_path_factory.mktemp("weights") / "small_siglip.npz")
    save_params_npz(path, jax.tree.map(np.asarray, vparams), jax.tree.map(np.asarray, tparams))
    return path


def _words():
    words = set()
    for v in VOCAB:
        for n in v["singulars"] + v["plurals"]:
            words.update(n.split())
    words.update("a an photo of picture showing image many which is type".split())
    return sorted(words)


def test_noun_cache_with_a_real_text_tower_matches_jax(interpreted_pallas, tower_weights,
                                                       tmp_path):
    common = dict(spec=SPEC, load_model=False, check=False, weights_path=tower_weights,
                  compute_dtype="float32", seed=0, inference_batch_size=8,
                  tokenizer_batch_size=8, image_batch_size=4)
    jemb = JaxEmbedder(arch=_small(JREGISTRY[SPEC]), bpe_merges_path=None,
                       tokenizer=j_make_test_tokenizer(_words(), context_length=16), **common)
    pemb = TorchEmbedder(arch=_small(REGISTRY[SPEC]), device="cpu",
                         tokenizer=make_test_tokenizer(_words(), context_length=16), **common)
    cfg = ("builtin", "Basic", "None | Type", 0)
    jds, pds = _pair(cfg, jemb=jemb, pemb=pemb, cache_dir=str(tmp_path / "jax"))
    pds.cache_dir = str(tmp_path / "port")
    for ds in (jds, pds):
        _configure(ds)
        with ds.loaded():  # generates, then re-embeds 32 USIDs one at a time
            pass
    jpath, ppath = jds.cache_path(), pds.cache_path()
    assert os.path.basename(jpath) == os.path.basename(ppath)
    with open(jpath, "rb") as f1, open(ppath, "rb") as f2:
        jraw, praw = f1.read(), f2.read()
    F, C = pemb.embed_dim, pemb.target_config.token_length
    row = F * 4 + C * 4 + C
    assert len(jraw) == len(praw) == pds.num_usids * row
    jrows = np.frombuffer(jraw, np.uint8).reshape(-1, row)
    prows = np.frombuffer(praw, np.uint8).reshape(-1, row)
    np.testing.assert_array_equal(prows[:, F * 4:], jrows[:, F * 4:])  # targets and masks
    pe = prows[:, :F * 4].copy().view(np.float32)
    je = jrows[:, :F * 4].copy().view(np.float32)
    np.testing.assert_allclose(pe, je, atol=TOWER_TOL, rtol=TOWER_TOL)
    # The uncached loader embeds the same texts through the tower
    pds.use_cache = False
    pds.configure_data(pds.resolve_data_config())
    loader, _ = pds.create_loader(batch_size=8, training=False)
    with pds.loaded():
        embed, *_ = next(iter(loader))
    usids = [pds.get_sample_usid(f) for f in range(8)]
    np.testing.assert_allclose(embed, pe[usids], atol=1e-5, rtol=1e-5)
