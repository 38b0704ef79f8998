"""The plain reference against the program's CPU path at tiny sizes: the
towers (one layer, a 2 x 2 patch grid) from the same weights and frames,
and the decoder's teacher-forced scores against the program's beam scores."""

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


@pytest.mark.parametrize("gencfg", ["beam_k10_vnone_gp_t1_a0", "beam_k10_vnone_gn_t1_a0"])
def test_decoder_reference_matches_program_scores(gencfg):
    from novic_tpu_torch.infer import NOVICModel
    from novic_tpu_torch.text.simple import make_test_tokenizer

    ckpt = str(ROOT / "assets" / "bench_ft0_decoder.npz")
    ref = ReferenceDecoder(ckpt, "cpu")
    model = NOVICModel(ckpt, embedder_spec="test:768", gencfg=gencfg, batch_size=3, device="cpu",
                       embedder_kwargs={"tokenizer": make_test_tokenizer(ref.labels.nouns)})
    e = np.random.default_rng(5).standard_normal((3, 768)).astype(np.float32)
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
