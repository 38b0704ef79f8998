"""The port's spans and counters (novic_tpu_torch/utils/trace.py) on the CPU.

* With no profiler session, `span` and `count` record nothing and keep
  nothing; under torch.profiler a span has its parent, thread and sequence
  id, a thread's spans are kept apart from another's, threads lose no count
  or span, the bound drops and counts, and a new session starts empty.
* A CLIP tower's forward at bf16 compute counts `tower.dense` once a bf16
  product (6 a block and the patch embedding; its float32 projection not),
  under a session only.
* NOVICModel classifying under the profiler (a small SigLIP-shaped tower,
  the FT0 decoder) records one `embed` and one `decode` per batch,
  `decode.steps` = token_length - 1 a decode, and children that cover the
  parents; BatchLoader records `loader.wait` and `loader.produce` once a batch.
* The training loop's `profile_dir` trace holds the program's spans as user
  annotations.
"""

import dataclasses
import json
import os
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from novic_tpu_torch.data.loader import BatchLoader
from novic_tpu_torch.embedders import registry
from novic_tpu_torch.embedders.base import TorchEmbedder
from novic_tpu_torch.embedders.vit import VisionTransformer
from novic_tpu_torch.infer import NOVICModel
from novic_tpu_torch.models.base import create_decoder
from novic_tpu_torch.models.config import DecoderModelConfig
from novic_tpu_torch.text.simple import make_test_tokenizer
from novic_tpu_torch.train.checkpoint import load_checkpoint
from novic_tpu_torch.train.loop import TrainLoopConfig, train
from novic_tpu_torch.utils import trace

torch.set_num_threads(2)
FT0 = os.path.join(os.path.dirname(__file__), "..", "assets", "bench_ft0_decoder.npz")
SPEC = "openclip:timm/ViT-B-16-SigLIP"


@pytest.fixture(autouse=True)
def cleared():
    trace.clear()
    yield
    trace.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def test_no_profiler_records_nothing():
    assert not trace.active()
    assert trace.span("a", rows=3) is trace.span("b")  # one shared no-op context
    for _ in range(3):
        with trace.span("embed", images=4):
            trace.count("decode.steps")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(10_000):
            with trace.span("decode.step", step=1):
                trace.count("decode.steps")
        kept = sum(s.size_diff for s in tracemalloc.take_snapshot().compare_to(before, "filename")
                   if s.traceback[0].filename == trace.__file__)
    finally:
        tracemalloc.stop()
    assert kept <= 0
    assert trace.records() == [] and trace.counters() == {} and trace.dropped() == 0


def test_nested_spans_threads_and_counters():
    def worker():
        with trace.span("loader.produce", index=0):
            pass

    with cpu_profile():
        assert trace.active()
        with trace.span("decode", rows=2):
            with trace.span("decode.step", step=1):
                trace.count("decode.steps")
                thread = threading.Thread(target=worker)
                thread.start()
                thread.join(timeout=30)
                assert not thread.is_alive()
            with trace.span("decode.step", step=2):
                trace.count("decode.steps", 2)
        with trace.span("embed"):
            pass
    assert not trace.active()
    with trace.span("after"):
        pass
    recs = by_name(trace.records())
    assert set(recs) == {"decode", "decode.step", "loader.produce", "embed"}
    (decode,), steps, (produce,), (embed,) = (recs[k] for k in ("decode", "decode.step",
                                                               "loader.produce", "embed"))
    assert decode["parent"] is None and decode["attrs"] == {"rows": 2}
    assert [s["parent"] for s in steps] == [decode["id"]] * 2
    assert [s["seq"] for s in steps] == [decode["seq"]] * 2
    assert [s["attrs"]["step"] for s in steps] == [1, 2]
    assert all(decode["t0"] <= s["t0"] <= s["t1"] <= decode["t1"] for s in steps)
    # The producer thread's span is its own top-level span, not the step's child
    assert produce["parent"] is None and produce["seq"] not in (decode["seq"], embed["seq"])
    assert produce["thread"] != decode["thread"] == threading.get_ident()
    assert embed["parent"] is None and embed["seq"] != decode["seq"]
    assert trace.counters() == {"decode.steps": 3}


def test_bound_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    with cpu_profile():
        for i in range(5):
            with trace.span("loader.wait", i=i):
                pass
    assert [r["attrs"]["i"] for r in trace.records()] == [0, 1, 2]
    assert trace.dropped() == 2
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


def test_a_new_session_replaces_the_last_ones_records(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 2)
    with cpu_profile():
        for i in range(3):
            with trace.span("embed", i=i):
                trace.count("decode.steps")
    assert len(trace.records()) == 2 and trace.dropped() == 1
    assert trace.counters() == {"decode.steps": 3}
    with cpu_profile():
        # The second session starts from an empty list, not a full one
        assert trace.records() == [] and trace.counters() == {} and trace.dropped() == 0
        with trace.span("decode", rows=1):
            pass
    # A session's records stay readable after it ends, until the next starts
    assert [(r["name"], r["attrs"]) for r in trace.records()] == [("decode", {"rows": 1})]
    assert trace.counters() == {} and trace.dropped() == 0


def test_threads_lose_no_count_and_no_span():
    threads, each = 16, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cpu_profile():
            workers = [threading.Thread(target=lambda: [_count_in_span() for _ in range(each)])
                       for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    recs = trace.records()
    assert trace.counters() == {"decode.steps": threads * each}
    assert len(recs) == threads * each and len({r["id"] for r in recs}) == threads * each
    assert all(r["parent"] is None for r in recs)


def _count_in_span():
    with trace.span("decode.step"):
        trace.count("decode.steps")


def _small_arch():
    arch = registry.REGISTRY[SPEC]
    return dataclasses.replace(
        arch, vision=dataclasses.replace(arch.vision, patch_size=16, width=256, layers=4, heads=4,
                                         compute_dtype="float32"),
        text=dataclasses.replace(arch.text, width=64, layers=1, heads=4, vocab_size=100,
                                 compute_dtype="float32"))


@pytest.fixture(scope="module")
def nouns():
    ck = load_checkpoint(FT0)
    return ck["target_nouns"][ck["num_invalid_target_nouns"]:]


def _children_cover(recs, parent_name, share):
    parents = [r for r in recs if r["name"] == parent_name]
    for p in parents:
        kids = [r for r in recs if r["parent"] == p["id"]]
        assert kids and all(k["seq"] == p["seq"] for k in kids)
        covered = sum(k["t1"] - k["t0"] for k in kids)
        assert covered >= share * (p["t1"] - p["t0"]), (parent_name, covered, p["t1"] - p["t0"])
    return parents


@pytest.mark.parametrize("gencfg", ["beam_k10_vnone_gn_t1_a0", "beam_k10_vnone_gp_t1_a0"])
def test_classify_records_a_span_tree_per_batch(nouns, gencfg):
    B = 2
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, size=(224, 224, 3), dtype=np.uint8) for _ in range(2 * B)]
    tok = make_test_tokenizer(nouns)
    model = NOVICModel(FT0, embedder_spec=SPEC, gencfg=gencfg, batch_size=B, device="cpu",
                       embedder_kwargs={"tokenizer": tok})
    model.embedder = TorchEmbedder(spec=SPEC, arch=_small_arch(), load_model=False, check=False,
                                   weights_path=None, tokenizer=tok, compute_dtype="float32",
                                   seed=0, device="cpu", inference_batch_size=B,
                                   image_batch_size=B)
    with model:
        G = model.decoder.cfg.token_length - 1
        model.classify_images(frames[:B])  # the trie is built once, before the profiler
        trace.clear()
        with cpu_profile():
            out = model.classify_images(frames)
    assert len(out.preds) == 2 * B
    recs = trace.records()
    names = by_name(recs)
    assert G == 7
    assert [r["attrs"] for r in names["embed"]] == [{"images": B}] * 2
    assert [r["attrs"] for r in names["decode"]] == [{"rows": B, "gencfg": gencfg}] * 2
    assert trace.counters() == {"decode.steps": 2 * G}
    embeds = _children_cover(recs, "embed", 0.95)
    decodes = _children_cover(recs, "decode", 0.95)
    for parents, kids in ((embeds, ("embed.frames", "embed.forward", "embed.wait")),
                          (decodes, ("decode.h2d", "decode.prefill", "decode.wait",
                                     "decode.finish"))):
        for p in parents:
            assert sorted(r["name"] for r in recs if r["parent"] == p["id"]
                          and r["name"] != "decode.step") == sorted(kids)
    for d in decodes:
        steps = [r for r in names["decode.step"] if r["parent"] == d["id"]]
        assert [s["attrs"]["step"] for s in steps] == list(range(1, G + 1))


@pytest.mark.parametrize("layers", [1, 3])
def test_clip_tower_counts_its_bf16_products(layers):
    """DFN5B's registered CLIP arch, cut small, at bf16 compute: 6 * layers + 1
    `tower.dense` a forward under a session (the float32 projection is not
    a bf16 GEMM), nothing without one."""
    v = registry.REGISTRY["openclip:apple/DFN5B-CLIP-ViT-H-14-378"].vision
    cfg = dataclasses.replace(v, image_size=28, width=32, layers=layers, heads=2, embed_dim=16)
    assert (cfg.compute_dtype, cfg.pool, cfg.use_class_token) == ("bfloat16", "cls", True)
    tower = VisionTransformer(cfg).init_random(torch.Generator().manual_seed(0))
    x = torch.randn(2, 28, 28, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        tower(x)
        assert trace.counters() == {}
        with cpu_profile():
            out = tower(x)
            assert trace.counters() == {"tower.dense": 6 * layers + 1}
    assert out.shape == (2, 16) and out.dtype == torch.float32


class _Rows:
    """A batch-item dataset of (embed, target, mask, weight) numpy batches."""

    def __init__(self, n, batch=4, F=16, C=4):
        rng = np.random.default_rng(0)
        e = rng.normal(size=(n * batch, F)).astype(np.float32)
        self.embed = e / np.linalg.norm(e, axis=1, keepdims=True)
        self.target = rng.integers(1, 20, size=(n * batch, C)).astype(np.int32)
        self.target[:, -1] = 0
        self.mask = self.target == 0
        self.n, self.batch = n, batch

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        s = slice(i * self.batch, (i + 1) * self.batch)
        return self.embed[s], self.target[s], self.mask[s], None


def test_loader_records_a_wait_and_a_produce_per_batch():
    loader = BatchLoader(_Rows(6), prefetch=2, device="cpu", seed=1)
    with cpu_profile():
        got = sum(1 for _ in loader)
    assert got == 6
    names = by_name(trace.records())
    waits, produced = names["loader.wait"], names["loader.produce"]
    # one wait a batch, and one for the producer's end-of-epoch mark
    assert len(waits) == 6 + 1
    assert sorted(r["attrs"]["index"] for r in produced) == list(range(6))
    assert {r["thread"] for r in produced} != {threading.get_ident()}
    assert all(r["parent"] is None for r in waits + produced)


def test_profile_dir_trace_holds_the_programs_spans(tmp_path):
    cfg = DecoderModelConfig(embed_dim=16, vocab_size=20, token_length=4, hidden_dim=16,
                             num_layers=1, num_heads=2, mlp_seq_len=2, input_dropout=0.0,
                             layer_dropout=0.0)
    model = create_decoder(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    loader = BatchLoader(_Rows(4), prefetch=2, device="cpu", seed=1)
    C = TrainLoopConfig(chunk_batches=4, chunk_samples=16, epoch_batches=4, max_chunks=1,
                        accum_size=2)
    train(model=model, loader=loader, C=C, profile_dir=str(tmp_path / "prof"))
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    annotated = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            annotated[e["name"]] = annotated.get(e["name"], 0) + 1
    assert annotated.get("train.step") == 2
    assert annotated.get("loader.wait", 0) >= 4
    assert annotated.get("loader.produce") == 4
