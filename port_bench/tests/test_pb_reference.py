"""The plain reference against the program's CPU path at tiny sizes: the
towers (one layer, a 2 x 2 patch grid) from the same weights and frames,
and the decoder's teacher-forced scores against the program's beam scores."""

import gc
import json

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny_cell
from port_bench import harness
from port_bench.reference.decoder import ReferenceDecoder


@pytest.mark.parametrize("workload", ["siglip_b16_ft0.offline_b256_guided",
                                      "eva02_l14_ft0.offline_b64_unguided"])
def test_tower_reference_matches_the_program(workload):
    run = harness.Run(ROOT, tiny_cell(workload), 3_000_000_019, 1.0,
                      False, device="cpu")
    frames = run.frames(4, run.config["tower"]["image_size"])
    model = harness.port_model(run, 4, run.mix["gencfg"])
    try:
        port = model.embed_images(list(frames))
    finally:
        model.__exit__(None, None, None)
    ref = harness.reference_embeddings(run, frames)
    fp8 = harness.reference_embeddings(run, frames, fp8=True)
    gap = harness.cosine_gap(port, ref)
    assert gap < 2e-4                       # bf16 compute against float32, one layer
    assert harness.cosine_gap(fp8, ref) > 5 * gap


def seeded_decoder_run(embed_dim: int, seed: int = 3_900_000_001):
    cell = tiny_cell("siglip_b16_ft0.offline_b256_guided")
    cell.config["decoder"].update(weights="seed", embed_dim=embed_dim)
    return harness.Run(ROOT, cell, seed, 1.0, False, device="cpu")


def test_seeded_decoder_has_the_checkpoints_layout():
    committed = ROOT / "assets" / "bench_ft0_decoder.npz"
    run, same, another = (seeded_decoder_run(768), seeded_decoder_run(768),
                          seeded_decoder_run(768, seed=3_900_000_002))
    path = harness.checkpoint_path(run)
    assert path != committed and harness.checkpoint_path(run) == path      # written once a run
    again, other = harness.checkpoint_path(same), harness.checkpoint_path(another)
    with np.load(committed) as a, np.load(path) as b, np.load(again) as c, np.load(other) as d:
        assert a.files == b.files
        assert [(a[k].shape, a[k].dtype) for k in a.files] == [(b[k].shape, b[k].dtype)
                                                               for k in b.files]
        meta = lambda f: json.loads(bytes(f["__meta__"]).decode())  # noqa: E731
        assert meta(a) == meta(b)
        params = [k for k in a.files if k.startswith("params.")]
        assert all(np.array_equal(b[k], c[k]) for k in params)            # the seed decides
        assert not any(np.array_equal(a[k], b[k]) or np.array_equal(b[k], d[k]) for k in params)
    workdir = path.parent
    del run
    gc.collect()
    assert not workdir.exists()                                           # removed with its run


@pytest.mark.parametrize("gencfg,embed_dim", [
    pytest.param("beam_k10_vnone_gp_t1_a0", 0, id="beam_k10_vnone_gp_t1_a0"),
    pytest.param("beam_k10_vnone_gn_t1_a0", 0, id="beam_k10_vnone_gn_t1_a0"),
    pytest.param("beam_k10_vnone_gp_t1_a0", 1024, id="seed1024-beam_k10_vnone_gp_t1_a0"),
    pytest.param("beam_k10_vnone_gn_t1_a0", 1024, id="seed1024-beam_k10_vnone_gn_t1_a0")])
def test_decoder_reference_matches_program_scores(gencfg, embed_dim):
    """The committed decoder (embed_dim 0), or one drawn from the seed at that width."""
    from novic_tpu_torch.infer import NOVICModel
    from novic_tpu_torch.text.simple import make_test_tokenizer

    run = seeded_decoder_run(embed_dim) if embed_dim else None
    ckpt = str(harness.checkpoint_path(run) if embed_dim else ROOT / "assets" / "bench_ft0_decoder.npz")
    F = embed_dim or 768
    ref = ReferenceDecoder(ckpt, "cpu")
    model = NOVICModel(ckpt, embedder_spec=f"test:{F}", gencfg=gencfg, batch_size=3, device="cpu",
                       embedder_kwargs={"tokenizer": make_test_tokenizer(ref.labels.nouns)})
    e = np.random.default_rng(5).standard_normal((3, F)).astype(np.float32)
    with model:
        out = model.classify_embeds(e)
        ids, pad = model.task.target, model.task.target_padding
    scores = ref.score_rows(torch.from_numpy(e), ids, pad)
    assert np.abs(scores - np.asarray(out.logprobs)).max() < 5e-5
    assert all(ref.labels.decode(ids[b, k]) == out.preds[b][k] for b in range(3) for k in range(10))
    if gencfg.endswith("gp_t1_a0"):          # guided labels re-tokenize to the same rows
        rows, n = ref.labels.batch([p for row in out.preds for p in row], ref.G)
        assert np.array_equal(rows, np.where(pad, 0, ids).reshape(-1, ref.G))
        assert np.array_equal(n, (ref.G - pad.sum(-1)).reshape(-1))
    tf32 = ReferenceDecoder(ckpt, "cpu", tf32=True).score_rows(torch.from_numpy(e), ids, pad)
    assert np.abs(tf32 - scores).max() > 20 * np.abs(scores - np.asarray(out.logprobs)).max()
