"""The port's ten cache writers (novic_tpu_torch.data.cache_writers) against
novic_tpu's on the CPU, mirroring tests/test_cache_writers.py.

Each writer runs in both packages on the same inputs with the same seed and
the 'test:24' hash embedder (whose vectors are byte-identical in both), and
the two files must be byte-identical: header, target sections, weights,
embeddings and the shuffled order. Classification and Image run over local
fake image folders; MergeCaches merges files of both packages. Also:
EmbeddingCacheWriter.tensorize_embed_targets equals the JAX package's on
strings and on lists of strings, and refuses alike.
"""

import json
import os

import numpy as np
import PIL.Image
import pytest
import torch

from novic_tpu.data import cache_writers as jw
from novic_tpu.data.cache import EmbeddingCache as JCache
from novic_tpu.data.cache import EmbeddingCacheWriter as JWriter
from novic_tpu.data.classification import ClassificationLoader as JLoader
from novic_tpu.data.classification import load_image_dataset as j_load_image_dataset
from novic_tpu.data.noun_dataset import NounDataset as JNounDataset
from novic_tpu.embedders.base import Embedder as JEmbedder
from novic_tpu_torch.data import cache_writers as pw
from novic_tpu_torch.data.cache import EmbeddingCache, EmbeddingCacheWriter
from novic_tpu_torch.data.classification import ClassificationLoader, load_image_dataset
from novic_tpu_torch.data.noun_dataset import NounDataset
from novic_tpu_torch.embedders.base import Embedder
from test_torch_train_cli import NATIVE_CACHEIO  # noqa: F401 (the JAX writer's library, whole)

torch.set_num_threads(2)

VOCAB = [  # tests/test_cache_writers.py's
    {"id": 0, "target_noun": "animal", "pretty_noun": "Animal",
     "singulars": ["animal"], "plurals": ["animals"],
     "singulars_freq": [2], "plurals_freq": [1], "hypernyms": []},
    {"id": 1, "target_noun": "dog", "pretty_noun": "Dog",
     "singulars": ["dog", "hound"], "plurals": ["dogs"],
     "singulars_freq": [2, 1], "plurals_freq": [1], "hypernyms": []},
    {"id": 2, "target_noun": "apple", "pretty_noun": "Apple",
     "singulars": ["apple"], "plurals": ["apples"],
     "singulars_freq": [1], "plurals_freq": [1], "hypernyms": []},
]
NOUNS = [v["target_noun"] for v in VOCAB]
PROMPTS = {
    "prompts": {"Basic": [[2, "a photo of {article_singular}"], [1, "many {plural}"]]},
    "hypernyms": {"None": [[1, None]]},
}
TC_KWARGS = dict(with_start_token=False, with_end_token=True, compact_ids=True,
                 fixed_token_length=True, auto_fixed_token_length=True, use_masks=True)


def _embedders():
    out = []
    for emb in (JEmbedder.create("test:24"), Embedder.create("test:24", device="cpu")):
        emb.configure_target(emb.create_target_config(NOUNS, **TC_KWARGS), NOUNS)
        out.append(emb)
    return out


@pytest.fixture(scope="module")
def embedders():
    return _embedders()


def _noun_ds(module, emb):
    """The noun dataset of `module`'s package (jw or pw) over VOCAB."""
    cls = JNounDataset if module is jw else NounDataset
    ds = cls(emb, vocab_json=VOCAB, prompt_json=PROMPTS, prompt_collection="Basic",
             hypernym_collection="None")
    ds.configure_target()
    return ds


def _same_file(a, b):
    with open(a, "rb") as f1, open(b, "rb") as f2:
        ja, pb = f1.read(), f2.read()
    assert len(ja) == len(pb)
    assert ja == pb


def _both(tmp_path, name, make):
    """make(module, embedder, path) → writer; runs both, returns their paths and outputs."""
    jemb, pemb = _embedders()
    jpath, ppath = str(tmp_path / f"jax_{name}.bin"), str(tmp_path / f"port_{name}.bin")
    jout = make(jw, jemb, jpath).generate()
    pout = make(pw, pemb, ppath).generate()
    _same_file(jpath, ppath)
    return jpath, ppath, jout, pout


@pytest.mark.parametrize("num_embed,seed", [(50, 0), (3000, 4)])
def test_random_writer(tmp_path, num_embed, seed):
    _both(tmp_path, "random",
          lambda m, e, p: m.RandomCacheWriter(p, e, num_embed=num_embed, seed=seed))


def test_photo_writer_and_its_debug_tensors(tmp_path):
    _, ppath, jout, pout = _both(tmp_path, "photo",
                                 lambda m, e, p: m.PhotoCacheWriter(p, e, NOUNS, debug=True, seed=0))
    for a, b in zip(jout, pout):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with EmbeddingCache(ppath, strict_embedder=False) as cache:
        assert sorted(np.asarray(cache.get_samples(0, 3)[1])[:, 0].tolist()) == [1, 2, 3]


def test_index_writer(tmp_path):
    _, ppath, _, _ = _both(tmp_path, "index", lambda m, e, p: m.IndexCacheWriter(p, e, NOUNS, seed=0))
    with EmbeddingCache(ppath, strict_embedder=False) as cache:
        np.testing.assert_array_equal(np.asarray(cache.get_samples(0, 3)[1])[:, 0], [1, 2, 3])


@pytest.mark.parametrize("num_embed,M", [(64, 3), (2100, 2)])
def test_test_multi_writer(tmp_path, num_embed, M):
    _both(tmp_path, "multi", lambda m, e, p: m.TestMultiCacheWriter(
        p, e, num_embed=num_embed, target_nouns=NOUNS, num_embed_targets=M, seed=0))


def _noun_writer(kind, **kw):
    return lambda m, e, p: getattr(m, kind)(p, _noun_ds(m, e), **kw)


def test_noun_dataset_writer(tmp_path):
    _both(tmp_path, "noun", _noun_writer("NounDatasetCacheWriter", seed=0))


@pytest.mark.parametrize("freqs", [[1, 1], [1, 2], [0, 1]])
def test_noun_multiset_writer(tmp_path, freqs):
    _both(tmp_path, "multiset", _noun_writer("NounMultisetCacheWriter", multi_target_freq=freqs,
                                             seed=3))


@pytest.mark.parametrize("template_mult,sample_mult", [(2, 3), (1, 1)])
def test_captions_writer(tmp_path, template_mult, sample_mult):
    captions = [
        {"target_noun": "dog",
         "singular_captions": [f"caption {i} about {{singular}}" for i in range(4)],
         "plural_captions": ["two {plural} playing"]},
        {"target_noun": "apple",
         "singular_captions": ["{singular} on a table"],
         "plural_captions": ["{plural} in a bowl"]},
        {"target_noun": "unrelated",
         "singular_captions": ["{singular} x"], "plural_captions": ["{plural} y"]},
    ]
    cap_path = str(tmp_path / "captions.json")
    with open(cap_path, "w") as f:
        json.dump(captions, f)
    _both(tmp_path, "captions", lambda m, e, p: m.CaptionsCacheWriter(
        p, cap_path, _noun_ds(m, e), template_multiplier=template_mult,
        sample_multiplier=sample_mult, seed=0))


@pytest.fixture()
def image_root(tmp_path):
    """An Imagenette-layout folder: 3 classes named by vocab nouns, 5 PNGs each."""
    base = tmp_path / "imgs" / "Imagenette" / "imagenette2-320" / "val"
    rng = np.random.default_rng(0)
    for cls in ("animal", "apple", "dog"):
        d = base / cls
        d.mkdir(parents=True)
        for i in range(5):
            size = (40, 40) if i % 2 else (48, 36)
            PIL.Image.fromarray(rng.integers(0, 256, size=size[::-1] + (3,), dtype=np.uint8)
                                ).save(d / f"img{i}.png")
    return str(tmp_path / "imgs")


def test_classification_writer(tmp_path, image_root):
    def make(m, e, p):
        load, loader_cls = ((j_load_image_dataset, JLoader) if m is jw
                            else (load_image_dataset, ClassificationLoader))
        ds = load("Imagenette", image_root, split="valid")
        loader = loader_cls(ds, batch_size=4, transform=e.get_image_transform(), seed=2)
        return m.ClassificationCacheWriter(p, e, loader, len(ds), targets=NOUNS,
                                           class_targets=[[c] for c in ds.classes], seed=2)

    _, ppath, _, _ = _both(tmp_path, "cls", make)
    with EmbeddingCache(ppath, strict_embedder=False) as cache:
        assert cache.header.embed_num == 15
    with pytest.raises(ValueError, match="class_targets"):
        pw.ClassificationCacheWriter(str(tmp_path / "bad.bin"), _embedders()[1], [], 1,
                                     targets=NOUNS, class_targets=[["dog"], []])


def test_image_writer(tmp_path, image_root):
    folder = os.path.join(image_root, "Imagenette", "imagenette2-320", "val")
    images = [os.path.join(folder, "dog"), os.path.join(folder, "apple", "img1.png")]
    _, ppath, _, _ = _both(tmp_path, "images",
                           lambda m, e, p: m.ImageCacheWriter(p, e, images, seed=1))
    with EmbeddingCache(ppath, strict_embedder=False) as cache:
        assert cache.header.embed_num == 6 and not cache.header.use_targets


@pytest.mark.parametrize("freqs,mode", [([2, 1], "max"), ([1, 1], "min"), ([1, 3], 1)])
def test_merge_caches_writer(tmp_path, freqs, mode):
    jemb, pemb = _embedders()
    p1, p2 = str(tmp_path / "m1.bin"), str(tmp_path / "m2.bin")
    jw.NounDatasetCacheWriter(p1, _noun_ds(jw, jemb), seed=0).generate()  # by the JAX package
    pw.NounMultisetCacheWriter(p2, _noun_ds(pw, pemb), multi_target_freq=[1, 1],
                               seed=0).generate()  # by the port
    outs = []
    for m, cache_cls, emb in ((jw, JCache, jemb), (pw, EmbeddingCache, pemb)):
        caches = [cache_cls(p, strict_embedder=False) for p in (p1, p2)]
        out = str(tmp_path / f"merged_{m.__name__.split('.')[0]}.bin")
        m.MergeCachesWriter(out, emb, caches, freqs=freqs, multi_mode=mode, seed=0).generate()
        outs.append(out)
    _same_file(*outs)


def test_merge_targetless_caches(tmp_path):
    jemb, pemb = _embedders()
    p1, p2 = str(tmp_path / "r1.bin"), str(tmp_path / "r2.bin")
    pw.RandomCacheWriter(p1, pemb, num_embed=30, seed=1).generate()
    pw.RandomCacheWriter(p2, pemb, num_embed=20, seed=2).generate()
    outs = []
    for m, cache_cls, emb in ((jw, JCache, jemb), (pw, EmbeddingCache, pemb)):
        out = str(tmp_path / f"merged_{m.__name__.split('.')[0]}.bin")
        m.MergeCachesWriter(out, emb, [cache_cls(p1, strict_embedder=False),
                                       cache_cls(p2, strict_embedder=False)],
                            freqs=[1, 2], seed=5).generate()
        outs.append(out)
    _same_file(*outs)


def test_tensorize_embed_targets_matches_jax(tmp_path, embedders):
    jemb, pemb = embedders
    kw = dict(num_embed=4, embed_dim=24, target_nouns=NOUNS, num_embed_targets=3,
              full_targets=False)
    jwr = JWriter(str(tmp_path / "j.bin"), target_tokenizer=jemb.target_tokenizer, **kw)
    pwr = EmbeddingCacheWriter(str(tmp_path / "p.bin"), target_tokenizer=pemb.target_tokenizer,
                               **kw)
    for targets in (["dog", "apple", "animal"], [["dog"], ["apple", "dog"], ["animal", "dog",
                                                                              "apple"]],
                    ["dog", ["apple", "animal"]]):
        a, b = jwr.tensorize_embed_targets(targets), pwr.tensorize_embed_targets(targets)
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape == (len(targets), 3)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        pwr.tensorize_embed_targets(["zebra"])
    untargeted = EmbeddingCacheWriter(str(tmp_path / "u.bin"), num_embed=4, embed_dim=24,
                                      use_targets=False)
    with pytest.raises(ValueError, match="use_targets"):
        untargeted.tensorize_embed_targets(["dog"])
