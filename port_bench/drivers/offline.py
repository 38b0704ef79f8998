"""Offline batch labelling: `NOVICModel.classify_images` on batches of
seeded uint8 frames, back to back, for the window.

The window calls `embed_images` and then `classify_embeds`, the two halves
of `classify_images`, so the benchmark's `tower` and `decode` spans sit on
the layer boundary. The mix names the end-to-end metric its rate is
reported as, the batch, the gencfg, the distinct batches the frames cycle
through, and what the check samples.

The check (compare.py) takes whole batches (beam) or single images
(exhaustive) drawn from the seed after the window closed, among those the
window finished.
"""

from __future__ import annotations

import time

import numpy as np

from port_bench.harness import port_model, sync


def setup(run):
    mix, tower = run.mix, run.config["tower"]
    with run.span("model"):
        model = port_model(run, mix["batch"], mix["gencfg"])
    with run.span("frames"):
        frames = run.frames(mix["batch"] * mix["pool_batches"], tower["image_size"])
    B = mix["batch"]
    pool = [list(frames[i * B:(i + 1) * B]) for i in range(mix["pool_batches"])]
    for i in range(2):  # the tries or the exhaustive precompute, then a warm pass
        with run.span("warmup"):
            model.classify_embeds(model.embed_images(pool[i]))
            sync(run.device)
    return {"model": model, "frames": frames, "pool": pool, "done": []}


def _batch(run, state, i: int):
    model = state["model"]
    images = state["pool"][i % len(state["pool"])]
    with run.span("tower", images=len(images)):
        e = model.embed_images(images)
    with run.span("decode", images=len(images)):
        out = model.classify_embeds(e)
    return e, out, model.task.target, model.task.target_padding


def window(run, state):
    end = run.t_window + run.seconds
    i = 0
    while time.perf_counter() < end:
        e, out, target, padding = _batch(run, state, i)
        state["done"].append((i, e, out.preds, np.asarray(out.logprobs), target, padding))
        i += 1
    elapsed = time.perf_counter() - run.t_window
    images = i * run.mix["batch"]
    run.counters["batches"] = i
    return {"attempted": images, "failed": 0, "elapsed_s": elapsed,
            "metrics": {run.mix["metric"]: images / elapsed}}


def traced(run, state):
    for i in range(run.mix["traced_batches"]):
        _batch(run, state, i)


def release(run, state):
    model = state["model"]
    sample = {"done": state["done"], "frames": state["frames"],
              "guide": set(model.task.guide_targets_set) if model.task.gencfg.guided else None}
    model.__exit__(None, None, None)
    state.clear()
    return sample


def check_inputs(run, sample) -> dict:
    """The rows compare.py judges: whole batches (beam) or images
    (exhaustive) drawn from the seed among those the window finished."""
    mix, B, done = run.mix, run.mix["batch"], sample["done"]
    rng = run.rng(11)
    if mix["gencfg"].startswith("all"):
        picks = rng.choice(len(done) * B, size=min(mix["check_images"], len(done) * B),
                           replace=False)
        rows = [(int(p) // B, int(p) % B) for p in picks]
    else:
        picks = rng.choice(len(done), size=min(mix["check_batches"], len(done)), replace=False)
        rows = [(int(d), r) for d in picks for r in range(B)]
    frame = lambda d, r: sample["frames"][(done[d][0] % mix["pool_batches"]) * B + r]  # noqa: E731
    return {"frames": np.stack([frame(d, r) for d, r in rows]),
            "port_e": np.stack([done[d][1][r] for d, r in rows]),
            "ids": np.stack([done[d][4][r] for d, r in rows]),
            "pad": np.stack([done[d][5][r] for d, r in rows]),
            "preds": [done[d][2][r] for d, r in rows],
            "scores": np.stack([done[d][3][r] for d, r in rows]),
            "guide": sample["guide"], "exhaustive": mix["gencfg"].startswith("all")}
