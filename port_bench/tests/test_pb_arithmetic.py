"""Inputs from the seed, the window's arithmetic, the trace reduction and
the frozen bound functions against hand-worked values."""

import hashlib
import importlib
import math

import numpy as np
import pytest

from conftest import ROOT, tiny_cell
from port_bench import bounds, harness, trace


def run_of(workload, seed, **mix):
    return harness.Run(ROOT, tiny_cell(workload, **mix), seed, 10.0, False, device="cpu")


def test_frames_and_weights_from_the_seed():
    r1, r2 = run_of("siglip_b16_ft0.offline_b256_guided", 4_000_000_001), \
        run_of("siglip_b16_ft0.offline_b256_guided", 4_000_000_001)
    r3 = run_of("siglip_b16_ft0.offline_b256_guided", 4_000_000_002)
    assert np.array_equal(r1.frames(3, 32), r2.frames(3, 32))
    assert not np.array_equal(r1.frames(3, 32), r3.frames(3, 32))
    w1, w3 = harness.tower_weights(r1), harness.tower_weights(r3)
    assert all(np.array_equal(w1[k].numpy(), harness.tower_weights(r2)[k].numpy()) for k in w1)
    assert not np.array_equal(w1["patch_weight"].numpy(), w3["patch_weight"].numpy())


# Recorded before the tower families became modules of their own: blake2b of
# the tiny tower's weight draw at seed 1,234,567,891,011 (each name, shape
# and float32 bytes in order), and the shipped config's FLOP and tokens an image
PINNED = {"siglip_b16_ft0.offline_b256_guided":
          ("f8db8adcf0adabbf7603da32bf3eb260", 35_416_584_192, 196),
          "eva02_l14_ft0.offline_b64_unguided":
          ("44da76463a4d554dcd0020af775103b4", 162_000_273_408, 257)}


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_tower_draw_and_counts_as_pinned(workload):
    h = hashlib.blake2b(digest_size=16)
    for name, w in harness.tower_weights(run_of(workload, 1_234_567_891_011)).items():
        h.update(name.encode())
        h.update(str(tuple(w.shape)).encode())
        h.update(w.numpy().tobytes())
    tower = harness.load_cell(ROOT, workload).config["tower"]
    assert (h.hexdigest(), bounds.tower_flops(tower), bounds.tower_tokens(tower)) \
        == PINNED[workload]


def test_offline_rate_is_all_images_over_all_time(monkeypatch):
    offline = importlib.import_module("port_bench.drivers.offline")
    run = run_of("siglip_b16_ft0.offline_b256_guided", 1)
    run.seconds = 0.3
    t = {"now": 100.0}
    monkeypatch.setattr(offline.time, "perf_counter", lambda: t["now"])

    def fake_batch(run, state, i):
        t["now"] += 0.125          # every batch takes 0.125 s
        return np.zeros((4, 8)), type("O", (), {"preds": [], "logprobs": []})(), None, None

    monkeypatch.setattr(offline, "_batch", fake_batch)
    run.t_window = 100.0
    out = offline.window(run, {"done": []})
    assert out["attempted"] == 3 * 4 and out["elapsed_s"] == pytest.approx(0.375)
    assert out["metrics"] == {"images_per_s": pytest.approx(12 / 0.375)}


def test_trace_reduction():
    # the segment ran 100 us on the host from h0 = 2.0 s; the marker kernel at
    # ts 1000 is the trace's time of h0
    h0, h1 = 2.0, 2.0 + 100e-6
    spans = [(h0, h0 + 40e-6, "tower"), (h0 + 40e-6, h0 + 100e-6, "decode")]
    ev = [{"ph": "X", "cat": "kernel", "name": "void at::spin_kernel(long)", "ts": 1000,
           "dur": 1},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1005, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1010, "dur": 10},   # overlaps the first
          {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 1050, "dur": 20},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1060, "dur": 5},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 1090, "dur": 30}]  # cut at 1100
    r = trace.reduce_events(ev, h0, h1, spans)
    assert r["aligned"] and r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((15 + 20 + 10) * 1e-6)
    assert dict(r["device_ops"]) == pytest.approx({"k1": 20e-6, "gemm": 20e-6, "copy": 10e-6})
    # idle 0-5 and 20-50 (middle 35) in tower (35), 70-90 in decode (20)
    assert dict(r["idle_gaps"]) == pytest.approx({"tower": 35e-6, "decode": 20e-6})
    # without the marker the gaps are not labelled by span
    r = trace.reduce_events(ev[1:], h0, h1, spans)
    assert not r["aligned"] and set(dict(r["idle_gaps"])) == {"unaligned"}
    assert trace.reduce_events([], h0, h1, spans)["busy_s"] == 0.0


def test_attention_bound_by_hand():
    # (64,196,12,64): bytes 4*64*196*12*64*4 = 154,140,672 over 3.35e12 B/s
    ms, by = bounds.attention_bound_ms(64, 196, 12, 64, False)
    assert by == "bytes" and ms == pytest.approx(154_140_672 / 3.35e12 * 1e3)
    ms, by = bounds.attention_bound_ms(1, 4096, 1, 128, False)    # 2*2*4096^2*128 FLOP
    assert by == "operations" and ms == pytest.approx(4 * 4096 ** 2 * 128 / 989e12 * 1e3)


def test_dropout_bound_by_hand():
    ms, by = bounds.dropout_bound_ms(1024 * 11 * 512, 4)
    assert by == "bytes" and ms == pytest.approx(2 * 1024 * 11 * 512 * 4 / 3.35e12 * 1e3)


def test_all_decode_flops_by_hand():
    # E=2, FF=1, L=1, V=3, P=1; one target of 3 positions: T=2
    # dense = 2*2*6 + 2*4 + 2*2*2*1 = 24 + 8 + 8 = 40; attn = 4*(1+2)*2 = 24
    positions, flops = bounds.all_decode_flops(2, 1, 1, 3, 1, np.array([3]))
    assert positions == 2 and flops == 2 * (40 + 2 * 2 * 3) + 2 * 24


def test_tower_flops_by_hand():
    t = {"family": "siglip", "image_size": 32, "patch_size": 16, "width": 2, "mlp_dim": 4,
         "layers": 1, "heads": 1, "embed_dim": 2}
    S, E, M = 4, 2, 4
    patch = 2 * S * 16 * 16 * 3 * E
    block = 2 * 4 * S * E * E + 2 * 2 * S * S * E + 2 * 2 * S * E * M
    head = 2 * 2 * S * E * E + 2 * 2 * E * E + 2 * 2 * S * E + 2 * 2 * E * M
    assert bounds.tower_flops(t) == patch + block + head


def test_beam_flops_by_hand():
    d = {"embed_dim": 2, "hidden_dim": 2, "feedfwd_dim": 1, "num_layers": 1, "mlp_seq_len": 1,
         "token_length": 3, "vocab_size": 3}
    def pos(keys, lg):
        return (2 * 4 * 4 + 2 * 2 * 2 * 1) + 4 * keys * 2 + (2 * 2 * 3 if lg else 0)

    prefill = 2 * 2 * 1 * 2 + pos(1, False) + 2 * 2 * 3
    assert bounds.beam_flops(d, 10) == prefill + 10 * pos(2, True)
    assert math.isclose(bounds.FP32_FLOP_PER_S, 67e12) and bounds.BF16_FLOP_PER_S == 989e12


def test_device_idle_scales_the_traced_busy_time_to_the_window():
    from types import SimpleNamespace

    reader = harness.metric_reader(ROOT, "device_idle.offline")
    counts = {"traced": 3, "window": 50}
    run = SimpleNamespace(traced={"busy_s": 0.3}, window={"elapsed_s": 10.0},
                          mix={"driver": "offline"},
                          spans_of=lambda unit, phase="window": [unit] * counts[phase])
    # 0.1 s busy a batch, 50 batches in 10 s: the device idle half the window
    assert reader.read(run, "device_idle.offline") == pytest.approx(50.0)
    run.traced = {"busy_s": 0.0}
    assert reader.read(run, "device_idle.offline") is None
