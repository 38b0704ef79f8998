"""Smoke test of the PyTorch/CUDA port (novic_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits nonzero:
  1. device: the card's name and its nvidia-smi name and power limit;
  2. build: compile every kernel of the serving path from the checkout's sources;
  3. kernel: each kernel against its plain PyTorch version on the card, at the
     serving shape and at two more (stated tolerance), with its time, the plain
     version's time, the time of one PyTorch library call for the same
     function, and the least time the card could take (bound);
  4. main path: NOVICModel serving SigLIP-B/16 (random weights from a seed) +
     the FT0 decoder with beam k=10, unguided and guided over all 42,919
     nouns, 2 batches of 64 seeded 224x224 frames; checks the outputs and that
     every kernel launched on this path (12 attention launches per tower forward);
  5. card vs CPU: 2 images through the same port on device="cpu" (plain
     versions) and on the card (kernels): embedding cosine and top-1 labels;
  6. timings at B=64, and a profile of one served batch (device busy share);
then the kernels line and, last, {"ok": true, "device": {...}}.
Exits nonzero without printing a result when CUDA is not available.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FT0 = os.path.join(REPO, "assets", "bench_ft0_decoder.npz")
SPEC = "openclip:timm/ViT-B-16-SigLIP"
BATCH = 64
N_BATCHES = 2
SEED = 0
# Kernel vs plain: both round the same operands to bf16 and accumulate in
# float32 in different orders. Where the row sums differ in the last bit, the
# bf16 rounding of a normalised probability p can land one ulp (<= 2^-7 p)
# apart, which moves an output by at most 2^-7 * max|v| over the keys. Hence
# elementwise |out - ref| <= KERNEL_ATOL + 2^-7 * max_keys|v|, and overall
# ||out - ref|| / ||ref|| <= KERNEL_REL_FRO.
KERNEL_ATOL = 2e-4
KERNEL_REL_FRO = 1e-4
COSINE_MIN = 0.9999     # card (kernel) vs CPU (plain) embeddings, bf16 compute
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor-core peak


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, repeats: int = 5) -> list[float]:
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def attention_bound_ms(B, S, H, hd, bias: bool) -> tuple[float, str]:
    """Least time for the function: bytes (q, k, v read, o written, f32; bias read)
    over HBM rate vs operations (two S x S x hd products) over the bf16 peak."""
    nbytes = 4 * B * S * H * hd * 4 + (S * S * 4 if bias else 0)
    flops = 2 * 2 * B * H * S * S * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel(attention) -> dict:
    """Phase 3: fused_attention (kernel) against attention_reference (plain) on the card."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    result = None
    for B, S, H, hd, causal in [(BATCH, 196, 12, 64, False), (8, 729, 16, 72, False),
                                (8, 77, 8, 64, True)]:
        q, k, v = (torch.randn(B, S, H, hd, device="cuda", generator=gen) for _ in range(3))
        bias = None
        if causal:
            i = torch.arange(S, device="cuda")
            bias = torch.where(i[None, :] <= i[:, None], 0.0, -1e30).float().contiguous()
        out = attention.fused_attention(q, k, v, bias)
        torch.cuda.synchronize()
        ref = attention.attention_reference(q, k, v, bias)
        diff = (out - ref).abs()
        err = diff.max().item()
        vmax = v.to(torch.bfloat16).float().abs().amax(dim=1, keepdim=True)  # over keys
        rel_fro = ((out - ref).norm() / ref.norm()).item()
        ok = bool((diff <= KERNEL_ATOL + 2.0 ** -7 * vmax).all()) and rel_fro <= KERNEL_REL_FRO
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = cuda_ms(lambda: attention.fused_attention(q, k, v, bias))
        plain_ms = cuda_ms(lambda: attention.attention_reference(q, k, v, bias))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias))
        bound_ms, bound_by = attention_bound_ms(B, S, H, hd, causal)
        line = {"phase": "kernel", "name": "fused_attention", "shape": [B, S, H, hd],
                "causal_bias": causal, "max_abs_err": err, "rel_fro_err": rel_fro,
                "tol": f"|d| <= {KERNEL_ATOL} + 2^-7 max|v|, rel_fro <= {KERNEL_REL_FRO}", "ok": ok,
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}
        emit(line)
        if not ok:
            raise SystemExit(f"fused_attention disagrees with its plain version at {line['shape']}")
        if result is None:
            result = line  # the serving shape
    return result


def check_output(out, n: int, guide: set | None) -> None:
    lp = np.asarray(out.logprobs, dtype=np.float64)
    if lp.shape != (n, 10) or len(out.preds) != n or any(len(r) != 10 for r in out.preds):
        raise SystemExit(f"unexpected output shape {lp.shape}")
    if not np.isfinite(lp).all():
        raise SystemExit("non-finite logprobs")
    if (np.diff(lp, axis=1) > 1e-6).any():
        raise SystemExit("logprobs not descending per row")
    if guide is not None:
        bad = [p for row in out.preds for p in row if p not in guide]
        if bad:
            raise SystemExit(f"guided preds outside the guide set: {bad[:5]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from novic_tpu_torch.infer import NOVICModel
    from novic_tpu_torch.ops import attention
    from novic_tpu_torch.text.simple import make_test_tokenizer
    from novic_tpu_torch.train.checkpoint import load_checkpoint

    # Plain references and the port run exact float32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build (every kernel of the path; one source so far)
    t0 = time.perf_counter()
    lib = attention.build(force=True)
    emit({"phase": "build", "kernels": [os.path.relpath(str(attention.SOURCE), REPO)],
          "library": os.path.relpath(str(lib), REPO), "seconds": time.perf_counter() - t0,
          "ptxas": (attention.BUILD_DIR / "attention.ptxas.txt").read_text().strip().splitlines()[-3:]})

    # 3. kernel vs plain
    k1 = phase_kernel(attention)

    # 4. main path
    ck = load_checkpoint(FT0)
    nouns = ck["target_nouns"][ck["num_invalid_target_nouns"]:]
    rng = np.random.default_rng(SEED)
    frames = [rng.integers(0, 256, size=(224, 224, 3), dtype=np.uint8)
              for _ in range(BATCH * N_BATCHES)]
    model = NOVICModel(FT0, embedder_spec=SPEC,
                       embedder_kwargs={"tokenizer": make_test_tokenizer(nouns), "seed": SEED},
                       gencfg="beam_k10_vnone_gn_t1_a0", batch_size=BATCH, device="cuda")
    guided_cfg = "beam_k10_vnone_gp_t1_a0"
    guide = set(nouns)
    launches = 0
    with model:
        tower_forwards = math.ceil(len(frames) / BATCH)
        runs = {}
        for label, gencfg in (("unguided", None), ("guided", guided_cfg)):
            attention.LAUNCHES = 0
            t0 = time.perf_counter()
            out = model.classify_images(frames, gencfg=gencfg)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = attention.LAUNCHES
            launches += got
            check_output(out, len(frames), guide if gencfg else None)
            if got != 12 * tower_forwards:
                raise SystemExit(f"{label}: fused_attention launched {got} times, expected "
                                 f"{12 * tower_forwards} (12 per tower forward)")
            runs[label] = out
            emit({"phase": "main_path", "gencfg": gencfg or model.gencfg.name, "images": len(frames),
                  "tower_forwards": tower_forwards, "fused_attention_launches": got,
                  "first_call_s": seconds, "labels": [r[:3] for r in out.preds[:3]],
                  "logprobs": [[round(x, 4) for x in r[:3]] for r in out.logprobs[:3]],
                  "types": out.types[0][:3]})

        # 5. card vs CPU on 2 images
        cpu = NOVICModel(FT0, embedder_spec=SPEC,
                         embedder_kwargs={"tokenizer": make_test_tokenizer(nouns), "seed": SEED},
                         gencfg="beam_k10_vnone_gn_t1_a0", batch_size=2, device="cpu")
        with cpu:
            e_cpu = cpu.embed_images(frames[:2])
            top_cpu = [r[0] for r in cpu.classify_embeds(e_cpu).preds]
        e_gpu = model.embed_images(frames[:2])
        top_gpu = [r[0] for r in runs["unguided"].preds[:2]]
        cos = (e_cpu * e_gpu).sum(-1) / np.linalg.norm(e_cpu, axis=-1) / np.linalg.norm(e_gpu, axis=-1)
        emit({"phase": "card_vs_cpu", "cosine": cos.tolist(), "cosine_min": COSINE_MIN,
              "top1_cpu": top_cpu, "top1_gpu": top_gpu})
        if cos.min() < COSINE_MIN or top_cpu != top_gpu:
            raise SystemExit("card and CPU disagree")

        # 6. timings at B=64
        batch = frames[:BATCH]
        pixels = model.transform_images(batch)
        embeds = model.embed_images(batch)
        tower_ms = cuda_ms(lambda: model.embedder.embed_image_tensor(pixels), iters=5, warmup=1)
        embed_ms = wall_ms(lambda: model.embed_images(batch))
        decode_ms = wall_ms(lambda: model.classify_embeds(embeds))
        decode_guided_ms = wall_ms(lambda: model.classify_embeds(embeds, gencfg=guided_cfg))
        e2e_ms = wall_ms(lambda: model.classify_images(frames), repeats=3)
        emit({"phase": "timing", "device": name, "nvidia_smi": smi, "batch": BATCH,
              "tower_ms_per_batch": tower_ms,
              "preprocess_and_tower_ms_per_batch": statistics.median(embed_ms),
              "decode_ms_per_batch": statistics.median(decode_ms),
              "decode_guided_ms_per_batch": statistics.median(decode_guided_ms),
              "e2e_images_per_s": len(frames) / (statistics.median(e2e_ms) / 1e3),
              "repeats_ms": {"embed": embed_ms, "decode": decode_ms,
                             "decode_guided": decode_guided_ms, "e2e": e2e_ms}})

        # 6b. device busy share and the largest device ops over one served batch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.classify_images(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        # Device-side events only (kernels, copies): host ops also carry the
        # device time of what they launched, which would count it twice
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0 and not e.key.startswith("Activity Buffer")]
        device_us = sum(e.self_device_time_total for e in events)
        top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]
        emit({"phase": "profile", "device": name, "batch": BATCH, "wall_ms": wall / 1e3,
              "device_busy_ms": device_us / 1e3, "device_idle_share": 1.0 - device_us / wall,
              "top_device_kernels_ms": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                                    for e in top]})

    # 7. kernels line, then the result
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "fused_attention", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/attention.cu",
        "replaces": "novic_tpu/ops/attention.py:71",
        "launches": launches, "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
