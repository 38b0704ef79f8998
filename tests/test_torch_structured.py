"""The port's structured modality-gap test embedder ('test-structured:')
against novic_tpu's on the CPU: tests/test_structured_embedder.py's cases,
with every embedding, prototype, image center and written file equal to
novic_tpu's bit for bit (the embedder is host numpy in both packages), and
one CLI embedder_zero_shot run with measure_gap in both packages on a
synthetic Food101 set of self-describing class images.
"""

import json
import os

import numpy as np
import PIL.Image
import pytest

from novic_tpu.cli.train import main as jax_main
from novic_tpu.embedders import structured as jstructured
from novic_tpu.embedders.base import Embedder as JEmbedder
from novic_tpu_torch.cli.train import main
from novic_tpu_torch.embedders import structured
from novic_tpu_torch.embedders.base import Embedder

LEXICON = {"dog": "dog", "dogs": "dog", "cat": "cat", "cats": "cat",
           "fire truck": "fire truck", "fire trucks": "fire truck"}
TEXTS = ["a photo of a dog", "many dogs here", "a cat photo", "two fire trucks",
         "nothing relevant", "a photo of a dog and a cat"]
SPECS = ["test-structured:64:60:10:3", "test-structured:64:60:0:3",
         "test-structured:64:60:0:3:0.5", "test-structured:64:60:0:3:1.0:0:0.6",
         "test-structured:64:60:0:3:1.0:20", "test-structured:32"]
NOUNS = [f"n{i}" for i in range(20)] + ["dog", "cat", "fire truck"]


def make(spec, lexicon=LEXICON):
    return (Embedder.create(spec, lexicon=lexicon, device="cpu"),
            JEmbedder.create(spec, lexicon=lexicon))


def assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("spec", SPECS)
def test_geometry_equals_jax(spec):
    """Prototypes, image centers, per-class gaps, text embeddings (string and
    token paths) and the configuration hash equal novic_tpu's."""
    port, ref = make(spec)
    assert port.configuration == ref.configuration
    assert port.get_configuration_hash(True, False) == ref.get_configuration_hash(True, False)
    for noun in NOUNS:
        assert_same(port.prototype(noun), ref.prototype(noun))
        assert_same(port.image_center(noun), ref.image_center(noun))
        assert port.class_gap_deg(noun) == ref.class_gap_deg(noun)
    assert_same(port.inference_text(TEXTS), ref.inference_text(TEXTS))
    tok = port.tokenize(TEXTS, output_dict=True)
    assert_same(port.inference_tokens(tok), ref.inference_tokens(ref.tokenize(TEXTS,
                                                                              output_dict=True)))


def test_images_roundtrip_and_embed_as_jax():
    port, ref = make("test-structured:64:60:10:3")
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    imgs = [structured.encode_class_image(n, rng) for n in ("dog", "cat", "fire truck")]
    assert all(np.array_equal(a, jstructured.encode_class_image(n, jrng))
               for a, n in zip(imgs, ("dog", "cat", "fire truck")))
    pil = [PIL.Image.fromarray(x) for x in imgs]
    px = port.get_image_transform()(pil)
    assert_same(px, ref.get_image_transform()(pil))
    assert [structured.decode_class_image(p) for p in px] == ["dog", "cat", "fire truck"]
    assert [jstructured.decode_class_image(p) for p in px] == ["dog", "cat", "fire truck"]
    # One undecodable image falls back to the hash embedding, in both
    px = np.concatenate([px, np.zeros_like(px[:1])])
    assert_same(port.inference_image(px), ref.inference_image(px))


def test_target_vocab_lexicon_as_jax():
    """Without an explicit lexicon the configured target vocabulary (noun and
    noun + 's') is matched, as when serving from a checkpoint."""
    port, ref = make("test-structured:48:50:5:1", lexicon=None)
    for e in (port, ref):
        e.target_vocab = ("dog", "fire truck")
    texts = ["two dogs", "a fire truck", "a cat"]
    assert_same(port.inference_text(texts), ref.inference_text(texts))


def test_vocab_dataset_and_lexicon_writers_as_jax(tmp_path):
    vocab = structured.make_structured_vocab(5, freq=3, seed=2)
    assert vocab == jstructured.make_structured_vocab(5, freq=3, seed=2)
    assert structured.lexicon_from_vocab_json(vocab) == jstructured.lexicon_from_vocab_json(vocab)
    nouns = [e["target_noun"] for e in vocab]
    structured.write_structured_cls_dataset(str(tmp_path / "port"), nouns, 2, seed=0)
    jstructured.write_structured_cls_dataset(str(tmp_path / "jax"), nouns, 2, seed=0)
    for root, _, files in os.walk(tmp_path / "jax"):
        for name in files:
            path = os.path.join(root, name)
            other = path.replace(str(tmp_path / "jax"), str(tmp_path / "port"), 1)
            with open(path, "rb") as a, open(other, "rb") as b:
                assert a.read() == b.read(), path


def test_bad_specs_raise():
    with pytest.raises(ValueError):
        Embedder.create("test-structured:64:60:10:3:0.5:extra")
    with pytest.raises(ValueError):
        structured.encode_class_image("x" * 40)
    with pytest.raises(ValueError, match="crowd"):
        Embedder.create("test-structured:64:60:10:3:1.0:0:1.5")


def test_embedder_zero_shot_cli_as_jax(tmp_path):
    """embedder_zero_shot with measure_gap through both CLIs: the same top-1
    and the gap JSON equal (the device field aside); the structured geometry
    separates the classes and the measured gap is the designed one."""
    vocab = structured.make_structured_vocab(6, freq=2, seed=0)
    nouns = [e["target_noun"] for e in vocab]
    with open(tmp_path / "vocab.json", "w") as f:
        json.dump(vocab, f)
    root = str(tmp_path / "cls")
    structured.write_structured_cls_dataset(root, nouns, 3, seed=1)
    common = ["embedder=test-structured:64:50:8:0", f"vocab_path={tmp_path}/vocab.json",
              "prompt_path=", "prompt_collection=Basic", "hypernym_collection=None", "seed=0",
              f"output_dir={tmp_path}/outputs", "cls_dataset=Food101",
              f"cls_dataset_root={root}", "cls_split=valid", "batch_size_image=8",
              "measure_gap=true"]
    gaps = {}
    for label, run, extra in (("jax", jax_main, []), ("port", main, ["--device=cpu"])):
        path = str(tmp_path / f"gap_{label}.json")
        res = run(["action=embedder_zero_shot", f"gap_output_path={path}"] + common + extra)
        with open(path) as f:
            gaps[label] = (res, json.load(f))
    (jres, jgap), (pres, pgap) = gaps["jax"], gaps["port"]
    assert pres == jres and pres["Food101"] >= 0.95
    jgap["cfg_embedder"].pop("device")
    pgap["cfg_embedder"].pop("device")
    assert pgap == jgap
    assert abs(pgap["angle_mean"] - 50.0) < 3.0
