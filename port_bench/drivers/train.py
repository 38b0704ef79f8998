"""Training from an embedding cache: the FT0 recipe's optimizer steps
through `train/step.py`'s step, fed by the port's loader.

Set-up writes a seeded, prototype-structured cache into TMPDIR through the
port's cache writer (one unit prototype per noun, Gaussian jitter, one
target noun a row), opens it through the port's cache dataset and
`BatchLoader`, builds the FT0 decoder from its checkpoint file, the AdamW
optimizer and the step (noise, dropout, gradient clipping, accumulation),
and drives that same step object through its first `check_steps` steps:
they are what the reference follows, and they warm every shape up. The
window then runs further steps; each takes `accum` loader batches (the
benchmark's `loader` span) concatenated as the training loop does, and one
call of the step (`step`). samples_per_s counts every optimizer step's rows.

The check (compare.compare_train) takes the first steps' batches, their
losses, the optimizer's first moments after step 1 (the clipped gradient as
the optimizer got it) and the parameters after the last check step.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np

from port_bench.harness import checkpoint_path, seed_words, sync


def cache_rows(run, nouns: int) -> tuple[np.ndarray, np.ndarray]:
    """The cache's rows, drawn on the device from the seed: (rows, F) unit
    embeddings (per-noun unit prototypes plus `jitter` Gaussian noise,
    renormalised) and their (rows,) 1-based target noun indices."""
    import torch

    mix, F = run.mix, run.config["decoder"]["embed_dim"]
    gen = run.generator(31)
    protos = torch.randn(nouns, F, device=run.device, generator=gen)
    protos /= protos.norm(dim=1, keepdim=True)
    ids = torch.randint(1, nouns + 1, (mix["rows"],), device=run.device, generator=gen)
    e = protos[ids - 1] + mix["jitter"] * torch.randn(mix["rows"], F, device=run.device,
                                                       generator=gen)
    return (e / e.norm(dim=1, keepdim=True)).cpu().numpy(), ids.cpu().numpy().astype(np.int32)


def _write_cache(run, path: str, ckpt: dict) -> None:
    from novic_tpu_torch.data.cache import EmbeddingCacheWriter
    from novic_tpu_torch.text.simple import make_test_tokenizer
    from novic_tpu_torch.text.target import TargetTokenizer

    nouns = ckpt["target_nouns"][ckpt["num_invalid_target_nouns"]:]
    e, ids = cache_rows(run, len(nouns))
    with EmbeddingCacheWriter(path, num_embed=run.mix["rows"], embed_dim=e.shape[1],
                              target_tokenizer=TargetTokenizer(make_test_tokenizer(nouns),
                                                               ckpt["target_config"]),
                              target_nouns=nouns, num_embed_targets=1, shuffle=True,
                              full_targets=False, unit_weights=True, embedder_strict=False,
                              default_weights=True, seed=seed_words(run.seed, 32)) as writer:
        writer.write(e, ids[:, None])


def setup(run):
    from novic_tpu_torch.bridge import decoder_from_numpy
    from novic_tpu_torch.data.cache import EmbeddingCache
    from novic_tpu_torch.data.noise import EmbeddingNoise
    from novic_tpu_torch.models.prefixed_iter import PrefixedIterDecoder
    from novic_tpu_torch.train.checkpoint import load_checkpoint
    from novic_tpu_torch.train.optim import create_optimizer
    from novic_tpu_torch.train.step import TrainRng, TrainState, make_train_step

    mix = run.mix
    ckpt = load_checkpoint(str(checkpoint_path(run)))
    workdir = tempfile.mkdtemp(prefix="port_bench_train_")
    path = os.path.join(workdir, "cache.bin")
    with run.span("cache"):
        _write_cache(run, path, ckpt)
    cache = EmbeddingCache(path, strict_embedder=False)
    cache.set_translation_source(ckpt["target_config"])
    dataset = cache.create_dataset(batch_size=mix["batch"], training=True)
    dataset.configure_data(dataset.resolve_data_config(**PrefixedIterDecoder.get_data_config_kwargs(
        use_weights=False, unit_weights=None, multi_target=False, multi_first=False,
        fixed_multi_length=False, multi_length=None, full_targets=None)))
    loader, _ = dataset.create_loader(batch_size=mix["batch"], training=True,
                                      seed=seed_words(run.seed, 33) % 2 ** 31,
                                      prefetch=mix["prefetch"], device=run.device)
    dataset.loaded().__enter__()
    model = decoder_from_numpy(ckpt["model_config"], ckpt["params"]).to(run.device)
    model.train()
    opt = create_optimizer(model.named_parameters(), beta1=mix["beta1"], beta2=mix["beta2"],
                           eps=mix["eps"], weight_decay=mix["weight_decay"])
    state = TrainState(model=model, optimizer=opt)
    n = mix["noise"]
    noise = EmbeddingNoise.create(n["scheme"], vec_norm=n["vec_norm"], angle_min=n["angle_min"],
                                  angle_max=n["angle_max"], mix_ratio=n["mix_ratio"])
    step = make_train_step(state, noise=noise, gradient_clip=mix["gradient_clip"],
                           accum_steps=mix["accum"])
    rng_seed = seed_words(run.seed, 34) % 2 ** 40
    st = {"model": model, "state": state, "step": step, "loader": loader,
          "workdir": workdir, "batches": iter(()), "rng": TrainRng.create(rng_seed, run.device),
          "rng_seed": rng_seed, "steps": 0}
    names = [k for k, _ in model.named_parameters()]
    first = {k: p.detach().clone() for k, p in model.named_parameters()}
    check = {"batches": [], "metrics": []}
    for i in range(mix["check_steps"]):
        batch = _next_batch(run, st)
        check["batches"].append(tuple(None if x is None else x.clone() for x in batch))
        check["metrics"].append(st["step"](batch, mix["lr"], st["rng"]).fetch())
        st["steps"] += 1
        if i == 0:
            b1 = opt.param_groups[0]["betas"][0]
            check["grad"] = {k: (opt.state[p]["exp_avg"] / (1.0 - b1)).clone()
                             for k, p in zip(names, model.parameters())}
    check["start"] = first
    check["end"] = {k: p.detach().clone() for k, p in model.named_parameters()}
    st["check"] = check
    for _ in range(mix["warm_steps"]):
        st["step"](_next_batch(run, st), mix["lr"], st["rng"])
    sync(run.device)
    return st


def _next_batch(run, st):
    """`accum` loader batches concatenated as the training loop does (its
    `_accum_concat`: trailing dims padded with the format's padding)."""
    import torch

    from novic_tpu_torch.train.loop import _accum_concat

    parts = []
    with run.span("loader"):
        while len(parts) < run.mix["accum"]:
            try:
                embed, target, mask, weight = next(st["batches"])
            except StopIteration:
                st["batches"] = iter(st["loader"])
                continue
            parts.append((embed.to(torch.float32), target, mask,
                          None if weight is None else weight.to(torch.float32)))
    return tuple(_accum_concat([p[j] for p in parts]) for j in range(4))


def _steps(run, st, count: int = 0, until: float = 0.0) -> int:
    done = 0
    while (count and done < count) or (until and time.perf_counter() < until):
        batch = _next_batch(run, st)
        with run.span("step", tokens=int(batch[1].shape[1])):
            st["step"](batch, run.mix["lr"], st["rng"])
        done += 1
    sync(run.device)
    return done


def window(run, state):
    steps = _steps(run, state, until=run.t_window + run.seconds)
    elapsed = time.perf_counter() - run.t_window
    rows = steps * run.mix["batch"] * run.mix["accum"]
    run.counters["steps"] = steps
    return {"attempted": rows, "failed": 0, "elapsed_s": elapsed,
            "metrics": {"samples_per_s": rows / elapsed}}


def traced(run, state):
    _steps(run, state, count=run.mix["traced_steps"])


def release(run, state):
    sample = {"check": state["check"], "rng_seed": state["rng_seed"]}
    # Stop the loader's prefetch thread; the cache stays mapped (its thread may
    # be inside a read) until the process ends, its file is removed now
    getattr(state["batches"], "close", lambda: None)()
    shutil.rmtree(state["workdir"], ignore_errors=True)
    state.clear()
    return sample


def check_inputs(run, sample) -> dict:
    """The first steps' record, with the loader stage checked by itself:
    `loader_mismatch` counts the rows of those batches that are not a row the
    benchmark wrote (its embedding, and its noun's tokens, end token and
    padding), regenerated from the seed."""
    from port_bench.reference.decoder import LabelTokens, read_checkpoint

    _, meta = read_checkpoint(str(checkpoint_path(run)))
    labels = LabelTokens(meta)
    e, ids = cache_rows(run, len(labels.nouns))
    where = {e[i, :4].tobytes(): i for i in range(len(e))}
    mismatch = 0
    for embed, target, mask, _ in sample["check"]["batches"]:
        embed, target, mask = (x.cpu().numpy() for x in (embed, target, mask))
        for r in range(len(embed)):
            i = where.get(embed[r, :4].tobytes())
            want = (labels.encode(labels.nouns[ids[i] - 1]) + [0]) if i is not None else None
            n = len(want) if want is not None else 0
            if (i is None or not np.array_equal(embed[r], e[i]) or target[r, :n].tolist() != want
                    or mask[r].tolist() != [False] * n + [True] * (mask.shape[1] - n)):
                mismatch += 1
    return {"train": True, "loader_mismatch": mismatch, **sample}
