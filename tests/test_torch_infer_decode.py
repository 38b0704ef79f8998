"""The port's NOVICModel serving greedy decode and vocab priors, against novic_tpu's.

Both packages serve the same seeded unit embeddings through
NOVICModel.classify_embeds with the FT0 decoder read from a float32 copy of the
asset (the JAX package would otherwise compute with the stored float16 arrays,
ROADMAP Queue 3) and the 768-wide test embedder: preds and types identical,
logprobs within 1e-4. GenerationTaskList leaves each task as a lone run does.
"""

import os

import numpy as np
import pytest
import torch

import novic_tpu.infer as jax_infer
from novic_tpu_torch import infer

torch.set_num_threads(2)
FT0 = os.path.join(os.path.dirname(__file__), "..", "assets", "bench_ft0_decoder.npz")


@pytest.fixture(scope="module")
def ft0_f32(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ft0") / "ft0_f32.npz")
    with np.load(FT0) as data:
        np.savez(path, **{k: data[k].astype(np.float32) if data[k].dtype == np.float16
                          else data[k] for k in data.files})
    return path


@pytest.mark.parametrize("gencfg", ["greedy_k1_vnone_gn_t1_a0", "beam_k3_vtgt0.5_gr_t1_a0.5",
                                    "greedy_k1_vnone_gr_t0.5_a1", "beam_k4_vtok1_gn_t2_a0"])
def test_classify_embeds_matches_jax(ft0_f32, gencfg):
    emb = np.random.default_rng(9).normal(size=(5, 768)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    common = dict(embedder_spec="test:768", gencfg=gencfg, batch_size=4)
    with jax_infer.NOVICModel(ft0_f32, **common) as jmodel:
        ref = jmodel.classify_embeds(emb)
    with infer.NOVICModel(ft0_f32, device="cpu", **common) as model:
        out = model.classify_embeds(emb)
    k = infer.GenerationConfig.from_name(gencfg).topk
    assert np.array(out.logprobs).shape == (5, k)
    assert out.preds == ref.preds
    assert out.types == ref.types
    np.testing.assert_allclose(np.array(out.logprobs), np.array(ref.logprobs), atol=1e-4, rtol=1e-4)


def test_generation_task_list_matches_single_tasks():
    """GenerationTaskList runs each task on the same batches and leaves each with
    the statistics it gets when run alone."""
    names = ["beam_k3_vnone_gn_t1_a0", "greedy_k1_vnone_gp_t1_a0", "beam_k2_vtok1_gn_t2_a0"]
    emb = np.random.default_rng(5).normal(size=(3, 768)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    model = infer.NOVICModel(FT0, device="cpu", embedder_spec="test:768", batch_size=3)
    with model:
        tasks = infer.GenerationTaskList([model.task_for(n) for n in names])
        tasks.clear()
        tasks.process(emb, class_indices=[0, 1, 2])
        got = [(t.target_str, t.target_score, t.num_samples, t.topk.copy()) for t in tasks.tasks]
        for name, (strs, scores, n, topk) in zip(names, got):
            single = model.classify_embeds(emb, gencfg=name)
            assert single.preds == strs
            np.testing.assert_allclose(single.logprobs, scores, rtol=1e-6)
            assert n == 3 and len(strs[0]) == len(topk) == infer.GenerationConfig.from_name(name).topk


def test_generation_task_list_matches_jax(ft0_f32):
    """Both packages' GenerationTaskList over the same tasks and batches leave
    each task with the same strings, result types and top-k statistics."""
    names = ["greedy_k1_vnone_gn_t1_a0", "beam_k3_vtgt0.5_gr_t1_a0.5"]
    emb = np.random.default_rng(11).normal(size=(6, 768)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    got = []
    for pkg, kw in ((jax_infer, {}), (infer, {"device": "cpu"})):
        with pkg.NOVICModel(ft0_f32, embedder_spec="test:768", batch_size=3, **kw) as model:
            tasks = pkg.GenerationTaskList([model.task_for(n) for n in names])
            tasks.clear()
            for i in (0, 3):
                tasks.process(emb[i:i + 3], class_indices=[0, 1, 2])
            got.append([(t.target_str, t.target_score, t.result.tolist(), t.num_samples,
                         t.topk_counts.tolist()) for t in tasks.tasks])
    for (jstr, jscore, jres, jn, jcounts), (strs, score, res, n, counts) in zip(*got):
        assert (strs, res, n, counts) == (jstr, jres, jn, jcounts)
        np.testing.assert_allclose(score, jscore, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("gencfg", ["greedy_k1_vnone_gn_t1_a0", "beam_k3_vtok1_gn_t1_a0"])
def test_cli_serves_greedy_and_vocab_gencfgs(ft0_f32, tmp_path, capsys, gencfg):
    """The inference CLI takes greedy and vocab-prior gencfgs and prints the
    top labels NOVICModel gives for the same image."""
    from PIL import Image

    from novic_tpu_torch.embedders.preprocess import load_images

    path = str(tmp_path / "frame.png")
    Image.fromarray(np.random.default_rng(3).integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(path)
    infer.main(["--checkpoint", ft0_f32, "--embedder", "test:768", "--device", "cpu",
                "--gencfg", gencfg, "--images", path])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    with infer.NOVICModel(ft0_f32, embedder_spec="test:768", gencfg=gencfg, device="cpu") as model:
        out = model.classify_images(load_images([path]))
    k = infer.GenerationConfig.from_name(gencfg).topk
    assert line.startswith(f"{path} --> ") and line.count("%)") == min(k, 3)
    assert all(p in line for p in out.preds[0][:3])
