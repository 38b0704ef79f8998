"""The port's classification readers (novic_tpu_torch.data.classification)
against novic_tpu's on the CPU, over tests/test_classification.py's fake
MNIST idx, CIFAR pickle and image-folder fixtures (plus gzipped idx,
CIFAR100 and Food101 layouts): the same samples (pixels and labels), class
names, variant JSONs, cleaned names, prompts and loader batches (for the same
seed), and the same errors.
"""

import gzip
import json
import os
import pickle

import numpy as np
import PIL.Image
import pytest

from novic_tpu.data import classification as jc
from novic_tpu_torch.cli.actions_eval import align_cls_class_targets, load_vocab_id_map
from novic_tpu_torch.data import classification as pc
from novic_tpu_torch.utils.misc import get_canon, make_indefinite
from test_classification import write_idx


def _same_dataset(jds, pds):
    assert (pds.name, pds.split, pds.classes, len(pds)) == (jds.name, jds.split, jds.classes,
                                                            len(jds))
    assert pds.files == jds.files
    for i in range(len(pds)):
        a, b = jds[i], pds[i]
        assert len(a) == len(b) and a[1:] == b[1:]
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))


@pytest.fixture()
def mnist_root(tmp_path):
    rng = np.random.default_rng(0)
    for name, gz in (("MNIST", False), ("FashionMNIST", True)):
        raw = tmp_path / name / "raw"
        raw.mkdir(parents=True)
        for prefix, n in (("t10k", 20), ("train", 30)):
            for kind, arr in (("images-idx3", rng.integers(0, 256, (n, 28, 28))),
                              ("labels-idx1", rng.integers(0, 10, (n,)))):
                path = raw / f"{prefix}-{kind}-ubyte"
                write_idx(path, arr)
                if gz:
                    with open(path, "rb") as f, gzip.open(str(path) + ".gz", "wb") as g:
                        g.write(f.read())
                    os.remove(path)
    return str(tmp_path)


@pytest.mark.parametrize("name,split", [("MNIST", "valid"), ("mnist", "all"),
                                        ("FashionMNIST", "train")])
def test_mnist_like_readers(mnist_root, name, split):
    _same_dataset(jc.load_image_dataset(name, mnist_root, split=split),
                  pc.load_image_dataset(name, mnist_root, split=split))


@pytest.fixture()
def cifar_root(tmp_path):
    rng = np.random.default_rng(1)
    folder = tmp_path / "CIFAR" / "cifar-10-batches-py"
    folder.mkdir(parents=True)
    with open(folder / "batches.meta", "wb") as f:
        pickle.dump({b"label_names": [f"class{i}".encode() for i in range(10)]}, f)
    for name, n in [("test_batch", 12)] + [(f"data_batch_{i}", 8) for i in range(1, 6)]:
        with open(folder / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, (n,)).tolist()}, f)
    folder = tmp_path / "CIFAR" / "cifar-100-python"
    folder.mkdir(parents=True)
    with open(folder / "meta", "wb") as f:
        pickle.dump({b"fine_label_names": [f"fine_{i}".encode() for i in range(100)]}, f)
    for name, n in (("test", 7), ("train", 9)):
        with open(folder / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"fine_labels": rng.integers(0, 100, (n,)).tolist()}, f)
    return str(tmp_path)


@pytest.mark.parametrize("name,split", [("CIFAR10", "valid"), ("CIFAR10", "train"),
                                        ("cifar100", "all")])
def test_cifar_readers(cifar_root, name, split):
    _same_dataset(jc.load_image_dataset(name, cifar_root, split=split),
                  pc.load_image_dataset(name, cifar_root, split=split))


@pytest.fixture()
def folder_root(tmp_path):
    rng = np.random.default_rng(2)

    def img(path, size):
        PIL.Image.fromarray(rng.integers(0, 256, size=size + (3,), dtype=np.uint8)).save(path)

    base = tmp_path / "Imagenette" / "imagenette2-320"
    for split in ("train", "val"):
        for cls in ("n01440764", "n02102040"):
            d = base / split / cls
            d.mkdir(parents=True)
            for i in range(3):
                img(d / f"img{i}.jpg", (32, 24 + 8 * i))
    base = tmp_path / "ImageNet-R" / "imagenet-r"
    for cls in ("fire_truck", "sea_lion"):
        (base / cls / "sub").mkdir(parents=True)
        img(base / cls / "a.png", (20, 20))
        img(base / cls / "sub" / "b.png", (20, 30))
    food = tmp_path / "Food101" / "food-101"
    (food / "meta").mkdir(parents=True)
    with open(food / "meta" / "classes.txt", "w") as f:
        f.write("apple_pie\nbaby_back_ribs\n")
    split = {"apple_pie": ["apple_pie/1", "apple_pie/2"], "baby_back_ribs": ["baby_back_ribs/3"]}
    for name in ("train.json", "test.json"):
        with open(food / "meta" / name, "w") as f:
            json.dump(split, f)
    for cls, rels in split.items():
        (food / "images" / cls).mkdir(parents=True)
        for rel in rels:
            img(food / "images" / f"{rel}.jpg", (16, 16))
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    with open(data_dir / "cls_class_names_clip.json", "w") as f:
        json.dump({"imagenette": ["tench (Tinca tinca)", "English springer / spaniel"]}, f)
    with open(data_dir / "cls_prompts_clip.json", "w") as f:
        json.dump({"imagenet1k": ["a photo of a {c}.", "art of the {c}."],
                   "cifar10": ["a blurry {c}."], "default": ["itap of a {c}."]}, f)
    return str(tmp_path)


@pytest.mark.parametrize("name,split,variant,clean,paths", [
    ("Imagenette", "valid", "clip", False, False),
    ("Imagenette", "all", "clip", True, True),
    ("ImageNet-R", "valid", None, False, True),
    ("Food101", "all", None, False, False),
])
def test_folder_readers_and_variants(folder_root, name, split, variant, clean, paths):
    data_dir = os.path.join(folder_root, "data")
    kw = dict(split=split, variant=variant, clean=clean, paths=paths, data_dir=data_dir)
    _same_dataset(jc.load_image_dataset(name, folder_root, **kw),
                  pc.load_image_dataset(name, folder_root, **kw))


def test_readers_refuse_alike(folder_root):
    data_dir = os.path.join(folder_root, "data")
    for args, kw in ((("Imagenette", folder_root), {}),  # wnid folders without a variant JSON
                     (("Nope", folder_root), {}),
                     (("Imagenette", folder_root), {"split": "test"}),
                     (("ImageNet-R", folder_root), {"split": "train"})):
        for mod in (jc, pc):
            with pytest.raises(ValueError):
                mod.load_image_dataset(*args, data_dir=data_dir, **kw)


def test_loader_batches_match_jax(folder_root):
    data_dir = os.path.join(folder_root, "data")

    def transform(images):
        return np.stack([np.asarray(im.resize((16, 16)), np.float32) for im in images])

    out = []
    for mod in (jc, pc):
        ds = mod.load_image_dataset("Imagenette", folder_root, split="all", variant="clip",
                                    paths=True, data_dir=data_dir)
        loader = mod.ClassificationLoader(ds, batch_size=5, transform=transform, seed=3)
        out.append([b for _ in range(2) for b in loader])
    assert len(out[0]) == len(out[1]) == 6
    for (ja, jl, jp), (pa, pl, pp) in zip(*out):
        np.testing.assert_array_equal(ja, pa)
        np.testing.assert_array_equal(jl, pl)
        assert jp == pp


@pytest.mark.parametrize("name", ["great white shark (Carcharodon)", "bell or wind chime",
                                  "sax or saxophone", "tank/armored vehicle",
                                  "puma or mountain lion", "  a (b (c)) d  "])
def test_clean_class_name(name):
    assert pc.clean_class_name(name) == jc.clean_class_name(name)


@pytest.mark.parametrize("name", ["Imagewoof", "CIFAR10", "FashionMNIST", "MNIST", "ImageNet-A"])
def test_prompts_with_alias(folder_root, name):
    data_dir = os.path.join(folder_root, "data")
    assert (pc.load_image_dataset_prompts(name, "clip", data_dir=data_dir)
            == jc.load_image_dataset_prompts(name, "clip", data_dir=data_dir))
    # Without the file: the generic prompt, as in the JAX package
    assert (pc.load_image_dataset_prompts(name, "none", data_dir=data_dir)
            == jc.load_image_dataset_prompts(name, "none", data_dir=data_dir))


def test_repo_class_name_variants_match_jax():
    for name in ("ImageNet1K", "Imagenette", "CIFAR10", "MNIST"):
        for variant in ("clip", "guide", "multi"):
            for clean in (False, True):
                assert (pc.load_class_name_variant(name, variant, clean)
                        == jc.load_class_name_variant(name, variant, clean))


def test_canon_alignment_and_articles_match_jax():
    from novic_tpu.cli.actions_eval import align_cls_class_targets as j_align
    from novic_tpu.cli.actions_eval import load_vocab_id_map as j_map
    from novic_tpu.utils.misc import get_canon as j_canon
    from novic_tpu.utils.misc import make_indefinite as j_indefinite

    nouns = ["", "fire truck", "Fire-Truck", "sea lion", "café", "o'clock", "hour glass",
             "UFO", "unicorn", "European", "apple", "x-ray", "one-way street"]
    classes = ["fire truck", "Sea Lion", "cafe", "oclock", "zebra", "apple"]
    assert load_vocab_id_map(nouns) == j_map(nouns)
    assert align_cls_class_targets(classes, nouns) == j_align(classes, nouns)
    for noun in nouns[1:]:
        for sanitize in (False, True):
            assert get_canon(noun, sanitize) == j_canon(noun, sanitize)
        assert make_indefinite(noun) == j_indefinite(noun)
        assert make_indefinite(noun, suffix=", a thing") == j_indefinite(noun, suffix=", a thing")
