"""Image classification benchmark datasets — native readers, no torchvision.

Capability parity with the reference wrappers (reference
classification_dataset.py): MNIST/FashionMNIST (idx files), CIFAR10/100
(python pickles), Food101 (images + meta json), TinyImageNet/Imagenette/
Imagewoof/ImageNet1K/ImageNet1KVal/ImageNet-A/ImageNet-R (class-folder
layouts), the same root-directory conventions and splits, class-name variant
JSONs (cls_class_names_{variant}.json) with the 'clean' normalizer
(ref :152-175), CLIP prompt sets with dataset aliasing (ref :189-210), and
optional per-sample path returns (ref :31-53).

The reference leans on torchvision; here every format is read directly
(torchvision is not a dependency of this framework). The port's copy of
novic_tpu.data.classification: the same samples, class names, prompts and
loader order for the same seed; the loader's transform is the embedder's
(get_image_transform), which puts the pixels on the embedder's device.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
import pickle
import re
import struct
from typing import Callable, Optional, Sequence

import numpy as np

from novic_tpu_torch.utils.logger import log

DATASET_NAMES = {"MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "Food101", "TinyImageNet",
                 "Imagenette", "Imagewoof", "ImageNet1K", "ImageNet1KVal", "ImageNet-A",
                 "ImageNet-R"}
DATASET_CASED_MAP = {name.lower(): name for name in DATASET_NAMES}
DATASET_SPLITS = ("train", "valid", "all")

MNIST_CLASSES = tuple(str(i) for i in range(10))
FASHION_MNIST_CLASSES = ("T-shirt/top", "Trouser", "Pullover", "Dress", "Coat", "Sandal",
                         "Shirt", "Sneaker", "Bag", "Ankle boot")


@dataclasses.dataclass
class ClassificationDataset:
    """Samples are (PIL image or array, class index, optional path)."""

    name: str
    split: str
    classes: tuple[str, ...]
    # Either in-memory arrays or on-disk file lists
    images: Optional[np.ndarray] = None        # (N,H,W[,3]) uint8 for MNIST/CIFAR
    labels: Optional[np.ndarray] = None        # (N,) int
    files: Optional[list[tuple[str, int]]] = None  # [(path, class_index)]
    return_paths: bool = False

    def __len__(self) -> int:
        return len(self.labels) if self.labels is not None else len(self.files)

    def __getitem__(self, index: int):
        import PIL.Image

        if self.images is not None:
            arr = self.images[index]
            img = PIL.Image.fromarray(arr).convert("RGB")
            label = int(self.labels[index])
            path = None
        else:
            path, label = self.files[index]
            img = PIL.Image.open(path).convert("RGB")
        if self.return_paths:
            return img, label, path
        return img, label


# ---------------------------------------------------------------------------
# Format readers
# ---------------------------------------------------------------------------


def _read_idx(path: str) -> np.ndarray:
    """MNIST idx format (optionally gzipped)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_file(folder: str, names: Sequence[str]) -> str:
    for n in names:
        p = os.path.join(folder, n)
        if os.path.isfile(p):
            return p
    raise FileNotFoundError(f"None of {names} found in {folder}")


def _load_mnist_like(root: str, name: str, train: bool):
    sub = os.path.join(root, name, "raw")
    if not os.path.isdir(sub):
        sub = os.path.join(root, name)
    prefix = "train" if train else "t10k"
    imgs = _read_idx(_find_file(sub, [f"{prefix}-images-idx3-ubyte", f"{prefix}-images-idx3-ubyte.gz"]))
    labels = _read_idx(_find_file(sub, [f"{prefix}-labels-idx1-ubyte", f"{prefix}-labels-idx1-ubyte.gz"]))
    return imgs, labels.astype(np.int64)


def _load_cifar(root: str, name: str, train: bool):
    if name == "CIFAR10":
        folder = os.path.join(root, "cifar-10-batches-py")
        batches = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        label_key = b"labels"
        with open(os.path.join(folder, "batches.meta"), "rb") as f:
            classes = [c.decode() if isinstance(c, bytes) else c
                       for c in pickle.load(f, encoding="bytes")[b"label_names"]]
    else:
        folder = os.path.join(root, "cifar-100-python")
        batches = ["train"] if train else ["test"]
        label_key = b"fine_labels"
        with open(os.path.join(folder, "meta"), "rb") as f:
            classes = [c.decode() if isinstance(c, bytes) else c
                       for c in pickle.load(f, encoding="bytes")[b"fine_label_names"]]
    images, labels = [], []
    for b in batches:
        with open(os.path.join(folder, b), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        images.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.extend(d[label_key])
    return np.concatenate(images), np.asarray(labels, np.int64), tuple(classes)


def _image_folder(root: str) -> tuple[list[tuple[str, int]], tuple[str, ...]]:
    """torchvision-ImageFolder-compatible scan: sorted class dirs → indices."""
    classes = tuple(sorted(e for e in os.listdir(root) if os.path.isdir(os.path.join(root, e))))
    files = []
    exts = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp", ".tiff", ".ppm")
    for idx, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for dirpath, _, filenames in sorted(os.walk(cdir)):
            for fn in sorted(filenames):
                if fn.lower().endswith(exts):
                    files.append((os.path.join(dirpath, fn), idx))
    if not files:
        raise FileNotFoundError(f"No images found under {root}")
    return files, classes


def _load_food101(root: str, train: bool):
    folder = os.path.join(root, "Food101", "food-101")
    if not os.path.isdir(folder):
        folder = os.path.join(root, "food-101")
    with open(os.path.join(folder, "meta", "classes.txt")) as f:
        classes = tuple(line.strip() for line in f if line.strip())
    split_file = os.path.join(folder, "meta", "train.json" if train else "test.json")
    with open(split_file) as f:
        split = json.load(f)
    cls_index = {c: i for i, c in enumerate(classes)}
    files = [(os.path.join(folder, "images", rel + ".jpg"), cls_index[cls])
             for cls, rels in split.items() for rel in rels]
    return files, classes


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------


def clean_class_name(class_name: str) -> str:
    """The reference's class-name cleaner: strip brackets, '/', 'X or Y'
    (ref classification_dataset.py:155-173)."""
    clean = class_name
    bracket_regex = r"\([^()]*\)"
    while re.search(bracket_regex, clean):
        clean = re.sub(bracket_regex, "", clean)
    clean = clean.split(sep="/", maxsplit=1)[0]
    if clean == "bell or wind chime":
        clean = "chime"
    parts = clean.split(" or ")
    if len(parts) >= 2:
        first, last = parts[0], parts[1]
        first_words = first.split()
        last_words = last.split(maxsplit=1)
        if len(first_words) == 1 and len(last_words) > 1:
            clean = f"{first_words[0]} {last_words[1]}"
        else:
            clean = first
    return " ".join(clean.split())


def load_class_name_variant(name: str, variant: str, clean: bool,
                            data_dir: Optional[str] = None) -> Optional[list[str]]:
    """Class names from data/cls_class_names_{variant}.json (ref :143-177)."""
    if data_dir is None:
        from novic_tpu_torch.utils.config import source_dir

        data_dir = os.path.join(source_dir(), "data")
    json_path = os.path.join(data_dir, f"cls_class_names_{variant}.json")
    if not os.path.isfile(json_path):
        return None
    with open(json_path) as f:
        cls_class_names = json.load(f)
    lookup = name.lower()
    if lookup.startswith("imagenet1k"):
        lookup = "imagenet1k"
    class_names = cls_class_names.get(lookup)
    if class_names is not None and clean:
        class_names = [clean_class_name(c) for c in class_names]
    return class_names


def load_image_dataset(name: str, root_path: str, split: str = "valid",
                       variant: Optional[str] = None, clean: bool = False,
                       paths: bool = False, data_dir: Optional[str] = None
                       ) -> ClassificationDataset:
    """Load a benchmark dataset from the standard root layout (ref :60-188)."""
    name_lower = name.lower()
    if name_lower not in DATASET_CASED_MAP:
        raise ValueError(f"Unsupported image classification dataset {name} "
                         f"(available: {', '.join(sorted(DATASET_NAMES))})")
    name = DATASET_CASED_MAP[name_lower]
    root = os.path.expanduser(root_path)
    split = split.lower()
    if split not in DATASET_SPLITS:
        raise ValueError(f"Unrecognised split: {split}")
    train_split = split in ("train", "all")
    valid_split = split in ("valid", "all")

    images = labels = files = None
    classes: tuple[str, ...] = ()
    if name in ("MNIST", "FashionMNIST"):
        parts = []
        if valid_split:
            parts.append(_load_mnist_like(root, name, train=False))
        if train_split:
            parts.append(_load_mnist_like(root, name, train=True))
        images = np.concatenate([p[0] for p in parts])
        labels = np.concatenate([p[1] for p in parts])
        classes = MNIST_CLASSES if name == "MNIST" else FASHION_MNIST_CLASSES
    elif name in ("CIFAR10", "CIFAR100"):
        folder = os.path.join(root, "CIFAR")
        parts = []
        if valid_split:
            parts.append(_load_cifar(folder, name, train=False))
        if train_split:
            parts.append(_load_cifar(folder, name, train=True))
        images = np.concatenate([p[0] for p in parts])
        labels = np.concatenate([p[1] for p in parts])
        classes = parts[0][2]
    elif name == "Food101":
        files = []
        if valid_split:
            f2, classes = _load_food101(root, train=False)
            files.extend(f2)
        if train_split:
            f2, classes = _load_food101(root, train=True)
            files.extend(f2)
    elif name in ("TinyImageNet", "Imagenette", "Imagewoof", "ImageNet1K"):
        folder_map = {"TinyImageNet": "tiny-imagenet-200", "Imagenette": "imagenette2-320",
                      "Imagewoof": "imagewoof2-320", "ImageNet1K": "ILSVRC-CLS"}
        folder = os.path.join(root, name, folder_map[name])
        files = []
        if valid_split:
            f2, classes = _image_folder(os.path.join(folder, "val"))
            files.extend(f2)
        if train_split:
            f2, classes = _image_folder(os.path.join(folder, "train"))
            files.extend(f2)
    elif name == "ImageNet1KVal":
        if train_split:
            raise ValueError(f"The {name} dataset only supports the validation split 'valid'")
        entries = os.listdir(root)
        if not (len(entries) == 1000 and all(re.fullmatch(r"^n\d{8}$", e) for e in entries)):
            raise ValueError("Root must contain exactly the 1000 ImageNet class directories")
        files, classes = _image_folder(root)
    elif name in ("ImageNet-A", "ImageNet-R"):
        if train_split:
            raise ValueError(f"The {name} dataset only supports the validation split 'valid'")
        files, classes = _image_folder(os.path.join(root, name, name.lower()))
    else:
        raise AssertionError

    class_names = load_class_name_variant(name, variant, clean, data_dir) if variant else None
    if class_names is None:
        if any(c[1:].isdigit() for c in classes):
            raise ValueError(f"Could not resolve class names for {name} (wnid folders need a "
                             f"cls_class_names_{variant or '<variant>'}.json)")
        class_names = [c.replace("_", " ") for c in classes]

    ds = ClassificationDataset(name=name, split=split, classes=tuple(class_names),
                               images=images, labels=labels, files=files, return_paths=paths)
    log.info(f"Loaded {name} {split} split: {len(ds)} samples, {len(ds.classes)} classes")
    return ds


def load_image_dataset_prompts(name: str, variant: str = "clip",
                               data_dir: Optional[str] = None) -> tuple[tuple[str, bool], ...]:
    """CLIP prompt ensemble for a dataset, with aliasing (ref :189-210)."""
    name_lower = name.lower()
    if name_lower not in DATASET_CASED_MAP:
        raise ValueError(f"Unsupported image classification dataset: {name}")
    name = DATASET_CASED_MAP[name_lower]
    if data_dir is None:
        from novic_tpu_torch.utils.config import source_dir

        data_dir = os.path.join(source_dir(), "data")
    prompts_path = os.path.join(data_dir, f"cls_prompts_{variant}.json")
    if not os.path.isfile(prompts_path):
        log.warning(f"Prompt ensemble file not found ({prompts_path}) => "
                    f"using the generic 'a photo of a ...' prompt")
        cls_prompts = {}
    else:
        with open(prompts_path) as f:
            cls_prompts = json.load(f)
    alias = {"FashionMNIST": "CIFAR10", "TinyImageNet": "CIFAR100", "Imagenette": "ImageNet1K",
             "Imagewoof": "ImageNet1K", "ImageNet-A": "ImageNet1K", "ImageNet-R": "ImageNet1K"}
    prompts = cls_prompts.get(name_lower)
    if prompts is None and name in alias:
        prompts = cls_prompts.get(alias[name].lower())
    if prompts is None:
        prompts = cls_prompts.get("default", ["a photo of a {c}."])
    return tuple((p.replace("{c}", "{noun}"), False) for p in prompts)


class ClassificationLoader:
    """Shuffled batch loader yielding (pixel_batch, class_indices[, paths])."""

    def __init__(self, dataset: ClassificationDataset, batch_size: int,
                 transform: Callable, shuffle: bool = True, seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.transform = transform
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            samples = [self.dataset[int(i)] for i in idx]
            if self.dataset.return_paths:
                imgs, labels, paths = zip(*samples)
            else:
                imgs, labels = zip(*samples)
                paths = None
            pixel = self.transform(list(imgs))
            labels = np.asarray(labels, np.int64)
            if paths is not None:
                yield pixel, labels, list(paths)
            else:
                yield pixel, labels
