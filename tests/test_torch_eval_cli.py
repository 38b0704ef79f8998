"""The port's evaluation and inference actions against novic_tpu's, through
both CLIs on one workdir (CPU, the 'test:32' hash embedder, whose vectors
are byte-identical in both packages; the JAX CLI trains the decoder once).

* eval on multi-target, weighted, guided data, and with multi_first: loss
  within 1e-5 relative; token_top1, noun_top1, pos_top1, tokens and
  num_valid_targets equal; eval_debug's printed lines equal. eval_train=true with zero dropout rates equals
  eval mode; with dropout it runs and moves the loss.
* embedder_zero_shot (measure_gap=true, CLIP prompts and clip_prompts=false):
  top-1 equal; the gap JSON equal key by key (histogram counts exact, floats
  within 1e-6, cfg_embedder.device excepted); each package's
  load_mean_shift reads the other's JSON.
* eval_cls (buckets, top-1s, the misclassified files) and
  eval_cls_decoding (the rows, over a gencfgs_grid) equal.
* infer: the predictions JSON (pred and result equal, score within 1e-5),
  the infer_ann_json_update skeleton, and the guide-source precedence of
  tests/test_cli.py:572 (list > guiding dataset > file > model vocabulary).
* estimate_generation_cost / budget_gencfgs: the skip logic around the
  port's own (card-measured) constants.
"""

import glob
import json
import os
import struct

import numpy as np
import PIL.Image
import pytest
import torch

from novic_tpu.cli.common import load_mean_shift as jax_load_mean_shift
from novic_tpu.cli.train import main as jax_main
from novic_tpu.data.cache import EmbeddingCacheWriter as JWriter
from novic_tpu.embedders.base import Embedder as JEmbedder
from novic_tpu.text.simple import make_test_tokenizer as j_make_test_tokenizer
from novic_tpu.utils.config import load_config as jax_load_config
from novic_tpu_torch import infer
from novic_tpu_torch.cli.actions_eval import budget_gencfgs
from novic_tpu_torch.cli.common import load_mean_shift
from novic_tpu_torch.cli.train import main
from novic_tpu_torch.embedders.base import Embedder
from novic_tpu_torch.infer import GenerationConfig, estimate_generation_cost
from novic_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from novic_tpu_torch.utils.config import load_config
from test_torch_train_cli import NATIVE_CACHEIO  # noqa: F401 (the JAX writer's library, whole)

torch.set_num_threads(2)
LOSS_RTOL = 1e-5
SCORE_ATOL = 1e-5
GAP_ATOL = 1e-6
NOUNS = ["dog", "cat", "fire truck", "apple"]
VOCAB = [{"id": i, "target_noun": n, "pretty_noun": n.title(), "singulars": [n],
          "plurals": [n + "s"], "singulars_freq": [2 - i % 2], "plurals_freq": [1],
          "hypernyms": []} for i, n in enumerate(NOUNS)]
MODEL_ARGS = ["batch_size=8", "hidden_dim=32", "num_layers=2", "num_heads=4",
              "mlp_seq_len=1", "num_end_loss=1", "label_smoothing=0.0",
              "input_dropout=0.1", "layer_dropout=0.0"]
CPU = ["--device=cpu"]


def common_args(d, out="outputs"):
    return ["embedder=test:32", f"vocab_path={d}/vocab.json", "prompt_path=",
            "prompt_collection=Basic", "hypernym_collection=None", "seed=3",
            f"output_dir={d}/{out}"]


def _write_idx(path, array):
    array = np.asarray(array, np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x00000800 | array.ndim))
        for n in array.shape:
            f.write(struct.pack(">I", n))
        f.write(array.tobytes())


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The workdir: vocab, a JAX-trained checkpoint and a copy of it with zero
    dropout rates, the noun cache, tests/test_eval_fidelity.py's multi-target
    cache, a synthetic MNIST and an Imagenette folder whose classes are nouns."""
    d = tmp_path_factory.mktemp("eval_cli")
    with open(d / "vocab.json", "w") as f:
        json.dump(VOCAB, f)
    args = common_args(d)
    noun_cache = f"{d}/noun_cache.bin"
    jax_main(["action=convert_noun_dataset", f"save_embedding_cache={noun_cache}"] + args)
    jax_main(["action=train", f"embedding_dataset={noun_cache}", "chunk_scale=8",
              "max_chunks=6", "init_lr=3e-3", "save_every_max=100", "save_top1_min=200"]
             + MODEL_ARGS + args)
    ckpt = sorted(glob.glob(f"{d}/outputs/ovod_*/*.npz"))[-1]
    ck = load_checkpoint(ckpt)
    ckpt0 = f"{d}/ckpt_no_dropout.npz"
    save_checkpoint(ckpt0, params=ck["params"], cfg_flat=ck["cfg_flat"],
                    model_config=ck["model_config"].replace(input_dropout=0.0,
                                                            layer_dropout=0.0),
                    target_config=ck["target_config"], data_config=ck["data_config"],
                    target_nouns=ck["target_nouns"],
                    num_invalid_target_nouns=ck["num_invalid_target_nouns"])

    # Multi-target cache (tests/test_eval_fidelity.py's layouts): M=3, rows
    # embed a noun text; correct first, correct second, correct zero-weighted,
    # single target
    emb = JEmbedder.create("test:32", tokenizer=j_make_test_tokenizer(NOUNS))
    tc = emb.create_target_config(NOUNS, with_start_token=False, with_end_token=True,
                                  compact_ids=True, fixed_token_length=False,
                                  auto_fixed_token_length=True, use_masks=True)
    emb.configure_target(tc, NOUNS)
    N = 52
    rng = np.random.default_rng(11)
    nouns_idx = rng.integers(0, len(NOUNS), size=N)
    embeds = emb.inference_text([f"a photo of a {NOUNS[i]}" for i in nouns_idx])
    targets = np.zeros((N, 3), np.int32)
    weights = np.zeros((N, 3), np.float32)
    for i, ni in enumerate(nouns_idx):
        correct, wrong, wrong2 = ni + 1, (ni + 1) % len(NOUNS) + 1, (ni + 2) % len(NOUNS) + 1
        pat = i % 4
        if pat == 0:
            targets[i, :2], weights[i, :2] = [correct, wrong], [1.0, 0.4]
        elif pat == 1:
            targets[i, :2], weights[i, :2] = [wrong, correct], [0.9, 0.6]
        elif pat == 2:
            targets[i], weights[i] = [wrong, correct, wrong2], [0.9, 0.0, 0.0]
        else:
            targets[i, 0], weights[i, 0] = correct, 1.0
    multi_cache = f"{d}/multi_cache.bin"
    with JWriter(multi_cache, num_embed=N, embed_dim=emb.embed_dim,
                 target_tokenizer=emb.target_tokenizer, target_nouns=NOUNS,
                 num_embed_targets=3, shuffle=False, use_targets=True, full_targets=False,
                 default_weights=False, unit_weights=False,
                 embedder_hash=emb.get_configuration_hash(True, False)) as w:
        w.write(np.asarray(embeds), targets, weights)

    raw = d / "MNIST" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for split in ("t10k", "train"):
        _write_idx(raw / f"{split}-images-idx3-ubyte", rng.integers(0, 256, (16, 28, 28)))
        _write_idx(raw / f"{split}-labels-idx1-ubyte", rng.integers(0, 10, (16,)))
    for cls in ("dog", "cat", "apple", "fire_truck"):
        folder = d / "Imagenette" / "imagenette2-320" / "val" / cls
        folder.mkdir(parents=True)
        for i in range(5):
            PIL.Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)).save(
                folder / f"{cls}_{i}.png")
    return d, ckpt, ckpt0, multi_cache


def eval_args(setup, *extra, ckpt=None):
    d, ck, _, multi_cache = setup
    return (["action=eval", f"embedding_dataset={multi_cache}", f"load_model={ckpt or ck}",
             "multi_target=true", "use_weights=true"] + MODEL_ARGS + common_args(d)
            + list(extra))


def assert_eval_equal(got, want):
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    for key in ("token_top1", "noun_top1", "pos_top1", "tokens", "num_valid_targets",
                "num_samples", "num_batches"):
        assert got[key] == want[key], key


def _debug_lines(text: str) -> list[str]:
    return [line for line in text.splitlines() if " --> " in line]


@pytest.mark.parametrize("extra", [(), ("eval_guided=true",), ("multi_first=true",),
                                   ("eval_guided=true", "multi_first=true", "eval_batches=3",
                                    "eval_debug=true", "eval_debug_samples=6")])
def test_eval_matches_jax(setup, capsys, extra):
    capsys.readouterr()
    (want,) = jax_main(eval_args(setup, *extra)).values()
    want_debug = _debug_lines(capsys.readouterr().out)
    (got,) = main(eval_args(setup, *extra) + CPU).values()
    got_debug = _debug_lines(capsys.readouterr().out)
    assert_eval_equal(got, want)
    assert want["num_valid_targets"] < 3 * want["num_samples"]  # some invalid targets
    # eval_debug: the first batch's target --> guided (unguided) greedy lines
    assert got_debug == want_debug
    assert len(got_debug) == (6 if "eval_debug=true" in extra else 0)


def test_eval_train_mode(setup):
    """Zero dropout rates: train mode equals eval mode (and JAX's); with the
    checkpoint's dropout the loss moves and stays finite."""
    _, _, ckpt0, _ = setup
    (det,) = main(eval_args(setup, "eval_guided=true", ckpt=ckpt0) + CPU).values()
    (train0,) = main(eval_args(setup, "eval_guided=true", "eval_train=true", ckpt=ckpt0)
                     + CPU).values()
    (jax_train0,) = jax_main(eval_args(setup, "eval_guided=true", "eval_train=true",
                                       ckpt=ckpt0)).values()
    assert_eval_equal(train0, det)
    assert_eval_equal(train0, jax_train0)
    (eval_mode,) = main(eval_args(setup) + CPU).values()
    (train,) = main(eval_args(setup, "eval_train=true") + CPU).values()
    assert np.isfinite(train["loss"])
    assert train["loss"] != pytest.approx(eval_mode["loss"], rel=1e-9)


def cls_args(d, name):
    return [f"cls_dataset={name}", f"cls_dataset_root={d}", "cls_split=valid",
            "batch_size_image=8"]


@pytest.mark.parametrize("name,clip_prompts", [("MNIST", "true"), ("Imagenette", "false")])
def test_embedder_zero_shot_gap_json(setup, name, clip_prompts):
    d = setup[0]
    out = {}
    for label, run, extra in (("jax", jax_main, []), ("port", main, CPU)):
        gap = f"{d}/gap_{name}_{label}.json"
        res = run(["action=embedder_zero_shot", "measure_gap=true", f"gap_output_path={gap}",
                   f"clip_prompts={clip_prompts}"] + cls_args(d, name) + common_args(d) + extra)
        with open(gap) as f:
            out[label] = (res, gap, json.load(f))
    (jres, jpath, jgap), (pres, ppath, pgap) = out["jax"], out["port"]
    assert pres == jres
    assert list(pgap) == list(jgap)
    assert jgap["cfg_embedder"].pop("device") == "tpu"
    assert pgap["cfg_embedder"].pop("device") == "cpu"
    for key, want in jgap.items():
        got = pgap[key]
        if isinstance(want, dict) and "counts" in want:
            assert got == want, key  # histograms: bins and counts exact
        elif isinstance(want, float):
            assert got == pytest.approx(want, abs=GAP_ATOL), key
        elif key == "mean_shift":
            np.testing.assert_allclose(got, want, rtol=0, atol=GAP_ATOL)
        else:
            assert got == want, key
    assert sum(pgap["angle_histc"]["counts"]) == (16 if name == "MNIST" else 20)

    # Each package's load_mean_shift reads the other's JSON
    overrides = ["action=train", "embedder=test:32", "mean_shift=true"]
    emb, jemb = Embedder.create("test:32"), JEmbedder.create("test:32")
    from_jax = load_mean_shift(load_config(None, overrides + [f"mean_shift_path={jpath}"]), emb)
    from_port = jax_load_mean_shift(
        jax_load_config(None, overrides + [f"mean_shift_path={ppath}"]), jemb)
    np.testing.assert_array_equal(from_jax, np.asarray(jgap["mean_shift"], np.float32))
    np.testing.assert_array_equal(from_port, np.asarray(pgap["mean_shift"], np.float32))


def _relative_files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(f"{root}/**/*.png", recursive=True))


def test_eval_cls_matches_jax(setup):
    d, ckpt, _, _ = setup
    base = ["action=eval_cls", f"load_model={ckpt}", "eval_cls_save_misclassified=true",
            "class_names_variant="] + cls_args(d, "Imagenette") + MODEL_ARGS
    (want,) = jax_main(base + common_args(d, "cls_jax")).values()
    (got,) = main(base + common_args(d, "cls_port") + CPU).values()
    assert got == want and want["total"] == 20
    assert sum(want["buckets"].values()) == 20
    mis = {label: _relative_files(glob.glob(f"{d}/cls_{label}/ovod_*/misclassified")[0])
           for label in ("jax", "port")}
    assert mis["port"] == mis["jax"]
    assert len(mis["jax"]) == 20 - want["buckets"]["direct_correct_guided_correct"]


def test_eval_cls_decoding_grid_matches_jax(setup):
    d, ckpt, _, _ = setup
    args = (["action=eval_cls_decoding", f"load_model={ckpt}", "class_names_variant=",
             "gencfgs_grid=true", "gencfg_method=[greedy,beam,all]", "gencfg_topk=[2]",
             "gencfg_prior=[none,tgt0.5]", "gencfg_guide=[none,plain]", "gencfg_tau=[1]",
             "gencfg_alpha=[0,0.5]", "eval_topk=2", "eval_samples_max=16"]
            + cls_args(d, "Imagenette") + MODEL_ARGS + common_args(d))
    want = jax_main(args)
    got = main(args + CPU)
    assert got == want
    assert len(want) == 2 + 8 + 4  # greedy x 2 guides, beam 2x2x2, all 2x2 (always guided)
    assert {r[2].split("_")[0] for r in want} == {"greedy", "beam", "all"}


def _infer(run, setup, out_name, *extra):
    d, ckpt, _, _ = setup
    preds = f"{d}/{out_name}.json"
    out = run(["action=infer", f"load_model={ckpt}", f"predictions_path={preds}",
               "gencfgs=[greedy_k1_vnone_gn_t1_a0, beam_k2_vnone_gp_t1_a0]"]
              + MODEL_ARGS + common_args(d) + list(extra))
    with open(preds) as f:
        assert json.load(f) == json.loads(json.dumps(out))
    return out


def assert_predictions_equal(got, want):
    assert got["version"] == want["version"] == 1
    assert got["keys"] == want["keys"]
    assert list(got["models"]) == list(want["models"])
    for name, wm in want["models"].items():
        gm = got["models"][name]
        assert {k: v for k, v in gm.items() if k != "gencfgs"} == \
            {k: v for k, v in wm.items() if k != "gencfgs"}
        assert list(gm["gencfgs"]) == list(wm["gencfgs"])
        for g, wg in wm["gencfgs"].items():
            gg = gm["gencfgs"][g]
            assert gg["pred"] == wg["pred"] and gg["result"] == wg["result"], g
            assert len(gg["pred"]) == len(got["keys"])
            np.testing.assert_allclose(gg["score"], wg["score"], rtol=0, atol=SCORE_ATOL)


def test_infer_predictions_and_annotation_update(setup):
    d = setup[0]
    image_dir = f"{d}/Imagenette/imagenette2-320/val/dog"
    ann0 = {"a photo of a dog": {"correct_primary": ["dog"], "close_primary": []},
            "dog_0.png": {"correct_primary": ["dog"], "close_primary": ["cat"]}}
    outs, anns = {}, {}
    for label, run, extra in (("jax", jax_main, []), ("port", main, CPU)):
        ann = f"{d}/ann_{label}.json"
        with open(ann, "w") as f:
            json.dump(ann0, f)
        outs[label] = _infer(run, setup, f"preds_{label}",
                             "infer_texts=[a photo of a dog, a photo of a cat, an apple]",
                             f"infer_all_dir={image_dir}", f"infer_ann_json={ann}",
                             "infer_ann_json_update=true", *extra)
        with open(ann) as f:
            anns[label] = f.read()
    assert_predictions_equal(outs["port"], outs["jax"])
    assert len(outs["jax"]["keys"]) == 3 + 5
    assert anns["port"] == anns["jax"]
    ann = json.loads(anns["port"])
    assert list(ann) == sorted(ann) and len(ann) == 3 + 5
    assert ann["dog_1.png"] == {"correct_primary": [], "close_primary": []}


def test_infer_guide_source_precedence(setup):
    d = setup[0]
    guide_file = f"{d}/guides.txt"
    with open(guide_file, "w") as f:
        f.write("apple\nfire truck\n")
    cache = f"{d}/noun_cache.bin"
    texts = "infer_texts=[a photo of a dog, a photo of a cat, an apple]"
    cases = [("list", ["infer_guide_targets=[dog, cat]", f"infer_guide_dataset={cache}",
                       f"guide_targets_file={guide_file}"], {"dog", "cat"}),
             ("dataset", [f"infer_guide_dataset={cache}", f"guide_targets_file={guide_file}"],
              set(NOUNS)),
             ("file", [f"guide_targets_file={guide_file}"], {"apple", "fire truck"}),
             ("vocab", [], set(NOUNS))]
    for label, extra, allowed in cases:
        want = _infer(jax_main, setup, f"guide_{label}_jax", texts, *extra)
        got = _infer(main, setup, f"guide_{label}_port", texts, *extra, *CPU)
        assert_predictions_equal(got, want)
        (model,) = got["models"].values()
        assert model["guide_targets"] == len(allowed), label
        assert all(p[0] in allowed for p in model["gencfgs"]["beam_k2_vnone_gp_t1_a0"]["pred"])


def test_generation_cost_and_budget(setup):
    """The estimate's form around the port's constants, and budget_gencfgs'
    skips, alone and through eval_cls_decoding."""
    greedy, beam10, beam2, every = (GenerationConfig.from_name(n) for n in (
        "greedy_k1_vnone_gp_t1_a0", "beam_k10_vnone_gp_t1_a0", "beam_k2_vnone_gn_t1_a0",
        "all_k10_vnone_gp_t1_a0"))
    n, W = 64, 42919
    assert estimate_generation_cost(greedy, n) == pytest.approx(infer.GREEDY_S_PER_IMAGE * n)
    assert estimate_generation_cost(beam10, n) == pytest.approx(
        (infer.GREEDY_S_PER_IMAGE + infer.BEAM_K10_S_PER_IMAGE) * n)
    assert estimate_generation_cost(beam2, n) == pytest.approx(
        (infer.GREEDY_S_PER_IMAGE + 0.2 * infer.BEAM_K10_S_PER_IMAGE) * n)
    assert estimate_generation_cost(every, n, W) == pytest.approx(infer.ALL_S_PER_IMAGE * n)
    assert estimate_generation_cost(every, n, W // 2) == pytest.approx(
        infer.ALL_S_PER_IMAGE * n * (W // 2) / W)
    costs = [estimate_generation_cost(g, n, W) for g in (greedy, beam2, beam10, every)]
    assert costs == sorted(costs)

    def kept(cap):
        cfg = load_config(None, ["action=eval_cls_decoding", f"max_gencfg_cost={cap}"])
        return [g.name for g in budget_gencfgs(cfg, [greedy, beam10, every], n, W)]

    assert kept(0) == [greedy.name, beam10.name, every.name]  # 0 = log only
    assert kept((costs[2] + costs[3]) / 2) == [greedy.name, beam10.name]
    assert kept((costs[0] + costs[2]) / 2) == [greedy.name]
    assert kept(costs[0] / 2) == []

    d, ckpt, _, _ = setup
    base = (["action=eval_cls_decoding", f"load_model={ckpt}", "class_names_variant=",
             "gencfgs=[greedy_k1_vnone_gn_t1_a0, beam_k2_vnone_gp_t1_a0, "
             "all_k2_vnone_gp_t1_a0]"] + cls_args(d, "Imagenette") + MODEL_ARGS
            + common_args(d) + CPU)
    rows = main(base)
    names = ["greedy_k1_vnone_gn_t1_a0", "beam_k2_vnone_gp_t1_a0", "all_k2_vnone_gp_t1_a0"]
    assert [r[2] for r in rows] == names
    est = [estimate_generation_cost(GenerationConfig.from_name(g), 20, len(NOUNS))
           for g in names]
    top, second = sorted(est)[-1], sorted(est)[-2]
    capped = main(base + [f"max_gencfg_cost={(top + second) / 2}"])
    assert capped == [r for r, e in zip(rows, est) if e < top]
