"""Multi-process helpers of tests/test_torch_parallel.py: each worker function
runs in its own spawned process (gloo over a file:// store, so parallel test
workers never race for a TCP port) and imports only torch and the port.

`run_ranks(name, world, tmp_path, **args)` starts `world` processes, each
calling `name(rank, world, **args)` between init_process_group and
destroy_process_group, joins them with a timeout and returns their results in
rank order; a worker's exception fails the caller with its traceback.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

JOIN_TIMEOUT_S = 120


def _entry(rank: int, world: int, store: str, name: str, args: dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        try:
            payload = ("ok", globals()[name](rank, world, **args))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the test through the result file
        payload = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(payload, f)


def run_ranks(name: str, world: int, tmp_path, **args) -> list:
    out_dir = str(tmp_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, os.path.join(out_dir, "store"), name,
                                              args, out_dir)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung, f"{len(hung)} of {world} ranks did not finish in {JOIN_TIMEOUT_S} s"
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        assert p.exitcode == 0 and os.path.exists(path), f"rank {r} exited with {p.exitcode}"
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        assert status == "ok", f"rank {r} failed:\n{value}"
        results.append(value)
    return results


# ---------------------------------------------------------------------------
# Workers
# ---------------------------------------------------------------------------


def _mesh(shape=None, axes=("data",)):
    from novic_tpu_torch.parallel.mesh import create_mesh

    return create_mesh(axis_names=axes, shape=shape, device="cpu")


def local_meta_batch(batches: list, mesh) -> tuple:
    """A rank's meta-batch as the training loop builds it: its rows of each
    loader batch (on the batch axis), concatenated in order."""
    from novic_tpu_torch.parallel.mesh import shard_rows

    parts = [tuple(None if x is None else shard_rows(torch.from_numpy(x), mesh).contiguous()
                   for x in b) for b in batches]
    return tuple(None if xs[0] is None else torch.cat(xs) for xs in zip(*parts))


def train_step(rank, world, cfg_kw, params, batches, lr, clip, accum, noise_kw, dp=True):
    """One optimizer step from `params` on the loader batches `batches`
    (accumulated), data-parallel over the ranks when `dp`; returns the metrics
    and the updated params."""
    from novic_tpu_torch.bridge import decoder_from_numpy
    from novic_tpu_torch.data.noise import EmbeddingNoise
    from novic_tpu_torch.models.config import DecoderModelConfig
    from novic_tpu_torch.train.optim import create_optimizer
    from novic_tpu_torch.train.step import TrainRng, TrainState, make_train_step

    model = decoder_from_numpy(DecoderModelConfig(**cfg_kw), params)
    state = TrainState(model=model, optimizer=create_optimizer(model.named_parameters()))
    mesh = _mesh() if dp else None
    noise = EmbeddingNoise.create(**noise_kw) if noise_kw else None
    step = make_train_step(state, gradient_clip=clip, accum_steps=accum, noise=noise, mesh=mesh)
    if mesh is None:
        batch = tuple(None if xs[0] is None else torch.from_numpy(np.concatenate(xs))
                      for xs in zip(*batches))
    else:
        batch = local_meta_batch(batches, mesh)
    m = step(batch, lr, TrainRng.create(0, "cpu")).fetch()
    return ({k: float(v) for k, v in m.items()},
            {n: p.detach().numpy() for n, p in model.named_parameters()})


def exact_attention(q, k, v, bias=None, key_bias=None):
    """K1's function in exact float32 (K1 rounds its operands to bf16)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(q.shape[-1]), k)
    if bias is not None:
        scores = scores + bias
    if key_bias is not None:
        scores = scores + key_bias[:, None, None, :]
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def tower_embed(rank, world, arch, weights, mode, shape, axes, images, tokens):
    """Image and token embeddings of the towers in `weights`, in float32 with
    exact attention, under a mesh (mode, shape, axes), or on one device when
    mode is None; with this rank's parameter shapes."""
    from novic_tpu_torch.embedders import eva, vit
    from novic_tpu_torch.embedders.base import TorchEmbedder

    vit.fused_attention = eva.fused_attention = exact_attention
    emb = TorchEmbedder(spec="openclip:tiny", arch=arch, load_model=False, check=False,
                        weights_path=weights, tokenizer=None, compute_dtype="float32", seed=0,
                        device="cpu", inference_batch_size=4, image_batch_size=4)
    if mode is not None:
        emb.set_mesh(_mesh(shape, axes), mode)
    emb.load_model()
    img = emb.inference_image(images)
    txt = emb.inference_tokens({"input_ids": tokens})
    shapes = {n: tuple(p.shape) for tower in (emb._vision, emb._text)
              for n, p in tower.named_parameters(prefix="vision" if tower is emb._vision
                                                 else "text")}
    return img, txt, shapes


def classify(rank, world, checkpoint, embeds, gencfg, batch_size):
    """NOVICModel.classify_embeds served data-parallel over the ranks; a
    ValueError comes back as its message."""
    from novic_tpu_torch.infer import NOVICModel

    model = NOVICModel(checkpoint, embedder_spec="test:768", gencfg=gencfg,
                       batch_size=batch_size, device="cpu")
    with model:
        model.set_mesh(_mesh())
        try:
            out = model.classify_embeds(embeds)
        except ValueError as e:
            return str(e)
    return out.preds, out.logprobs, out.types


def embedder_refusals(rank, world, arch_dp, arch_heads3, align_arch):
    """The set_mesh refusals: an unknown mode, heads that do not split, ALIGN's tower."""
    from novic_tpu_torch.embedders.base import TorchEmbedder

    def make(arch):
        return TorchEmbedder(spec="openclip:tiny", arch=arch, load_model=False, check=False,
                             weights_path=None, tokenizer=None,
                             compute_dtype=arch.vision.compute_dtype, seed=0, device="cpu")

    mesh = _mesh(axes=("model",))
    errors = []
    for arch, mode in ((arch_dp, "pp"), (arch_heads3, "tp"), (align_arch, "tp")):
        try:
            make(arch).set_mesh(mesh, mode)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return errors


def cli_train(rank, world, argv):
    """action=train through the CLI on a process group the caller initialised;
    returns the trained params, the loop's chunk and sample counters and the
    run directories this rank can see."""
    from novic_tpu_torch.cli.train import main

    state, S, ewa = main(argv)
    return ({n: p.detach().numpy() for n, p in state.model.named_parameters()},
            (S.chunk_id, S.batch_id, S.sample_id), ewa.loss)
