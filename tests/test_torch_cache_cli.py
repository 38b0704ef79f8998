"""The port's cache, test and fix_checkpoints actions and training on
embedding_dataset=NounDataset, through both CLIs on the same workdir (CPU,
the 'test:32' hash embedder, whose vectors are byte-identical in both).

* Every cache action writes a file byte-identical to the JAX CLI's:
  convert_noun_dataset, cache_noun_multiset, cache_captions, cache_cls (a
  fake Imagenette folder whose classes are vocab nouns), cache_images,
  merge_caches, and cache_noun_dataset's noun cache (same name, same bytes).
* test_data_loader and test_embed_cache pass in the port.
* train embedding_dataset=NounDataset (cached and uncached): from the same
  checkpoint, one chunk at lr 1e-4 in each package gives losses and grad
  norms within 1e-5 relative and params within 1e-6 (tests/test_torch_train.py's
  bar; at lr 1e-4 Adam's early steps do not amplify float noise).
* fix_checkpoints retrofits target_nouns into .npz, .model and .train files
  that lack them, as the JAX CLI does; dry_run changes nothing.
"""

import glob
import json
import os
import shutil

import numpy as np
import PIL.Image
import pytest
import torch

from novic_tpu.cli.train import main as jax_main
from novic_tpu.train import checkpoint as jck
from novic_tpu_torch.cli.train import main
from novic_tpu_torch.train.checkpoint import (load_checkpoint, read_reference_pickle,
                                              save_checkpoint, save_reference_checkpoint)
from novic_tpu_torch.utils.misc import flatten_dict
from test_torch_train_cli import NATIVE_CACHEIO  # noqa: F401 (the JAX writer's library, whole)

torch.set_num_threads(2)
RTOL, PARAM_ATOL = 1e-5, 1e-6  # tests/test_torch_train.py's
NOUNS = ["dog", "cat", "fire truck", "sea lion", "apple"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cache_cli")
    vocab = [{"id": i, "target_noun": n, "pretty_noun": n.title(), "singulars": [n],
              "plurals": [n + "s"], "singulars_freq": [1 + i % 2], "plurals_freq": [1],
              "hypernyms": [0] if i == 3 else []} for i, n in enumerate(NOUNS)]
    with open(d / "vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(d / "captions.json", "w") as f:
        json.dump([{"target_noun": "dog", "singular_captions": ["a {singular} runs",
                                                                "the {singular} sleeps"],
                    "plural_captions": ["{plural} play"]},
                   {"target_noun": "apple", "singular_captions": ["one {singular}"],
                    "plural_captions": ["{plural} in a bowl", "many {plural}"]}], f)
    rng = np.random.default_rng(0)
    for cls in ("dog", "fire_truck", "apple"):
        folder = d / "images" / "Imagenette" / "imagenette2-320" / "val" / cls
        folder.mkdir(parents=True)
        for i in range(3):
            PIL.Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)).save(
                folder / f"{i}.png")
    return d


def _args(d, tag, *extra):
    """Shared keys; each package writes under <d>/<tag>."""
    return ["embedder=test:32", f"vocab_path={d}/vocab.json", "seed=3", "batch_size=8",
            f"output_dir={d}/{tag}/out", f"embedding_cache_dir={d}/{tag}/cache",
            f"noun_cache_dir={d}/{tag}/noun", "prompt_collection=ImageNet1KSel",
            "hypernym_collection=Type", "batch_size_embed=16", "batch_size_image=4"] + list(extra)


def _run_both(d, *extra):
    jax_main(_args(d, "jax", *extra))
    return main(_args(d, "port", *extra) + ["--device=cpu"])


def _same(a, b):
    with open(a, "rb") as f1, open(b, "rb") as f2:
        assert f1.read() == f2.read()


CACHE_ACTIONS = [
    ("convert_noun_dataset", []),
    ("cache_noun_multiset", ["multi_target_freq=[1,2]", "hypernym_collection=None"]),
    ("cache_captions", ["template_multiplier=2", "sample_multiplier=3"]),
    ("cache_cls", ["cls_dataset=Imagenette", "class_names_variant="]),
]


@pytest.mark.parametrize("action,extra", CACHE_ACTIONS, ids=[a for a, _ in CACHE_ACTIONS])
def test_cache_action_files_byte_identical(workdir, action, extra):
    extra = list(extra) + [f"save_embedding_cache={action}.bin",
                           f"captions_path={workdir}/captions.json",
                           f"cls_dataset_root={workdir}/images"]
    _run_both(workdir, f"action={action}", *extra)
    _same(workdir / "jax" / "cache" / f"{action}.bin", workdir / "port" / "cache" / f"{action}.bin")


def test_cache_images_and_merge_caches(workdir):
    folder = workdir / "images" / "Imagenette" / "imagenette2-320" / "val" / "dog"
    _run_both(workdir, "action=cache_images", f"images=[{folder}]", "save_embedding_cache=img.bin")
    _same(workdir / "jax" / "cache" / "img.bin", workdir / "port" / "cache" / "img.bin")
    for tag in ("jax", "port"):  # the same inputs on both sides
        src = workdir / f"{tag}_merge_in"
        os.makedirs(src, exist_ok=True)
        for name in ("a", "b"):
            main(_args(workdir, f"{tag}_merge_in", "action=convert_noun_dataset", f"seed={ord(name)}",
                       f"save_embedding_cache={name}.bin", "--device=cpu"))
    ins = [f"{workdir}/{{}}_merge_in/cache/{n}.bin" for n in ("a", "b")]
    jax_main(_args(workdir, "jax", "action=merge_caches", "merge_freqs=[2,1]",
                   f"embedding_datasets=[{ins[0].format('jax')},{ins[1].format('jax')}]",
                   "save_embedding_cache=merged.bin"))
    main(_args(workdir, "port", "action=merge_caches", "merge_freqs=[2,1]",
               f"embedding_datasets=[{ins[0].format('port')},{ins[1].format('port')}]",
               "save_embedding_cache=merged.bin", "--device=cpu"))
    _same(workdir / "jax" / "cache" / "merged.bin", workdir / "port" / "cache" / "merged.bin")


def test_cache_noun_dataset_same_noun_cache(workdir):
    _run_both(workdir, "action=cache_noun_dataset")
    (jpath,), (ppath,) = (glob.glob(f"{workdir}/{t}/noun/noun_cache_*.bin") for t in ("jax", "port"))
    assert os.path.basename(jpath) == os.path.basename(ppath)
    _same(jpath, ppath)
    # A second run only re-checks the file it finds
    mtime = os.path.getmtime(ppath)
    main(_args(workdir, "port", "action=cache_noun_dataset", "--device=cpu"))
    assert os.path.getmtime(ppath) == mtime


@pytest.mark.parametrize("dataset,training", [("NounDataset", "true"), ("NounDataset", "false"),
                                              ("convert_noun_dataset.bin", "true")])
def test_test_data_loader_passes(workdir, dataset, training):
    if not dataset.startswith("Noun"):
        main(_args(workdir, "port", "action=convert_noun_dataset",
                   f"save_embedding_cache={dataset}", "--device=cpu"))
    main(_args(workdir, "port", "action=test_data_loader", f"embedding_dataset={dataset}",
               f"test_training={training}", "accum_factor=3", "noun_cache=false", "--device=cpu"))


def test_test_embed_cache_passes(workdir):
    main(_args(workdir, "port", "action=test_embed_cache", "--device=cpu"))


def test_cache_actions_default_to_cuda(workdir):
    if torch.cuda.is_available():
        pytest.skip("CUDA present")
    for action in ("convert_noun_dataset", "cache_noun_dataset", "test_embed_cache",
                   "fix_checkpoints"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(_args(workdir, "port", f"action={action}", "save_embedding_cache=x.bin"))


# -- training on the noun dataset ---------------------------------------------

TRAIN = ["action=train", "embedding_dataset=NounDataset", "hidden_dim=32", "num_layers=2",
         "num_heads=4", "mlp_seq_len=2", "input_dropout=0.0", "layer_dropout=0.0",
         "chunk_scale=16", "save_top1_min=200", "save_every_max=1", "max_chunks=1"]


@pytest.mark.parametrize("noun_cache", ["true", "false"])
def test_train_on_noun_dataset_matches_jax(workdir, noun_cache):
    tag = f"train_{noun_cache}"
    main(_args(workdir, f"{tag}_base", *TRAIN, f"noun_cache={noun_cache}", "--device=cpu"))
    base = sorted(glob.glob(f"{workdir}/{tag}_base/out/ovod_*/*.npz"))[-1]
    resume = [f"load_model={base}", "load_train_state=false", "init_lr=1e-4",
              f"noun_cache={noun_cache}", "accum_factor=2"]
    jax_main(_args(workdir, f"{tag}_jax", *TRAIN, *resume))
    _, S, _ = main(_args(workdir, f"{tag}_port", *TRAIN, *resume, "--device=cpu"))
    assert S.chunk_id == 2
    jnpz = sorted(glob.glob(f"{workdir}/{tag}_jax/out/ovod_*/*.npz"))[-1]
    pnpz = sorted(glob.glob(f"{workdir}/{tag}_port/out/ovod_*/*.npz"))[-1]
    metrics = []
    for path in (jnpz, pnpz):
        with open(os.path.join(os.path.dirname(path), "metrics.jsonl")) as f:
            metrics.append([json.loads(line) for line in f][-1])
    jm, pm = metrics
    for key in ("loss", "grad_norm_mean", "grad_norm_max"):
        assert abs(pm[key] - jm[key]) <= RTOL * abs(jm[key]), key
    jres, pres = jck.load_checkpoint(jnpz), load_checkpoint(pnpz)
    assert pres["target_nouns"] == jres["target_nouns"] == tuple(NOUNS)
    jp, pp = flatten_dict(jres["params"]), flatten_dict(pres["params"])
    assert set(jp) == set(pp)
    for n in pp:
        np.testing.assert_allclose(pp[n], jp[n], atol=PARAM_ATOL, rtol=0, err_msg=n)


# -- fix_checkpoints ----------------------------------------------------------

def _legacy_checkpoints(workdir, tag):
    """One port .npz re-saved without target nouns, and a .model and a .train
    (reference schema) without them, under <workdir>/<tag>/out/ovod_x/."""
    src = sorted(glob.glob(f"{workdir}/train_true_base/out/ovod_*/*.npz"))
    if not src:
        main(_args(workdir, "train_true_base", *TRAIN, "--device=cpu"))
        src = sorted(glob.glob(f"{workdir}/train_true_base/out/ovod_*/*.npz"))
    ck = load_checkpoint(src[-1])
    out = workdir / tag / "out" / "ovod_x"
    out.mkdir(parents=True)
    common = dict(params=ck["params"], model_config=ck["model_config"],
                  target_config=ck["target_config"], target_nouns=(), num_invalid_target_nouns=0,
                  cfg_flat=ck["cfg_flat"], data_config=ck["data_config"])
    save_checkpoint(str(out / "ovod_chunk0001_x.npz"), opt_state_arrays=ck["opt_arrays"],
                    train_meta=ck["train_meta"], **common)
    save_reference_checkpoint(str(out / "ovod_chunk0001_x.model"), **common)
    save_reference_checkpoint(str(out / "ovod_chunk0002_x.train"),
                              loop_state=ck["train_meta"]["loop_state"], **common)
    with open(out / "junk.model", "wb") as f:
        f.write(b"not a pickle")
    return out


def test_fix_checkpoints_dry_run_then_fix_like_jax(workdir):
    port_dir = _legacy_checkpoints(workdir, "fix_port")
    jax_dir = workdir / "fix_jax" / "out" / "ovod_x"
    shutil.copytree(port_dir, jax_dir)
    before = {p: open(p, "rb").read() for p in glob.glob(f"{port_dir}/*")}
    assert main(_args(workdir, "fix_port", "action=fix_checkpoints", "dry_run=true",
                      "--device=cpu")) == 3
    assert before == {p: open(p, "rb").read() for p in glob.glob(f"{port_dir}/*")}
    assert main(_args(workdir, "fix_port", "action=fix_checkpoints", "--device=cpu")) == 3
    assert jax_main(_args(workdir, "fix_jax", "action=fix_checkpoints")) == 3
    expect = ("",) + tuple(NOUNS)
    jres = jck.load_checkpoint(str(jax_dir / "ovod_chunk0001_x.npz"))
    pres = load_checkpoint(str(port_dir / "ovod_chunk0001_x.npz"))
    assert pres["target_nouns"] == jres["target_nouns"] == expect
    assert pres["num_invalid_target_nouns"] == jres["num_invalid_target_nouns"] == 1
    jmeta, pmeta = dict(jres["meta"]), dict(pres["meta"])
    jmeta.pop("saved_unix_time"), pmeta.pop("saved_unix_time")
    assert jmeta == pmeta
    for n, v in flatten_dict(pres["params"]).items():
        np.testing.assert_array_equal(v, flatten_dict(jres["params"])[n])
    for a, b in zip(pres["opt_arrays"], jres["opt_arrays"]):
        np.testing.assert_array_equal(a, b)
    for name in ("ovod_chunk0001_x.model", "ovod_chunk0002_x.train"):
        p, j = read_reference_pickle(str(port_dir / name)), read_reference_pickle(str(jax_dir / name))
        assert p["target_nouns"] == j["target_nouns"] == expect
        assert p["num_invalid_target_nouns"] == 1
        assert set(p) == set(j)
        for k, v in p["model_state_dict"].items():
            assert torch.equal(v, j["model_state_dict"][k]), k
    # Fixed files are left alone by a second run
    assert main(_args(workdir, "fix_port", "action=fix_checkpoints", "--device=cpu")) == 0
