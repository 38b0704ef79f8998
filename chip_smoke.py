"""Smoke test of the PyTorch/CUDA port (novic_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits nonzero:
  1. device: the card's name and its nvidia-smi name and power limit;
  2. build: compile every kernel (attention.cu, dropout.cu, int8_matmul.cu,
     beam_reorder.cu, attention_bf16.cu, tiled_matmul.cu, flash_attention.cu)
     from the checkout's sources, one nvcc each, started together; count
     HGMMA / IGMMA (wgmma on bf16 / s8), UTMALDG / UTMASTG (TMA load /
     store) and SYNCS (mbarrier) instructions in the SASS of the Hopper
     designs (attention, attention_bf16, flash_attention, tiled_matmul,
     int8_matmul), and fail if one has no wgmma or no UTMALDG, if the s8
     engine's libraries (tiled_matmul, int8_matmul) have no IGMMA or
     tiled_matmul's no UTMASTG, or if ptxas reports a spill or a wgmma
     serialisation ("Potential Performance Loss") in attention.cu,
     flash_attention.cu, tiled_matmul.cu or int8_matmul.cu;
  3. kernel: the attention kernel (K1: a bf16 pre-pass and a TMA + wgmma
     kernel) against its plain PyTorch version on the card, at the serving
     shape, at the DFN5B-H-378 tower's (32,730,16,80), at two more, and at
     edge shapes (S=1, S=65 with the causal bias, hd 8 and 128; stated
     tolerance), with its time and the pre-pass's share, the plain version's
     time, the time of one PyTorch library call for the same function, and
     the least time the card could take (bound);
  3b. dropout kernel: bit-identical to its plain version at the three FT0
     site shapes and a ragged size, rates 0.1 and 0.5; its backward mask is
     the forward's; the keep share is within 5 sigma of 1 - rate; times;
  3c. int8 GEMM (K2): bit-identical to its plain version in the int32 and
     float32+bias epilogues at the int8 towers' shapes and the Hopper
     instance's tile edges (M=1, M=129, N=200, N=199, K=16), and in the int32
     and bfloat16 ones at X4's; each shape through the instance its shape
     picks (the wgmma one; the mma.sync one at K=70 and from an unaligned
     base), counted; times beside the bound and torch._int_mm; then
     exp/pallas_int8_mlp_chain.py's 10-step chain (X4's path, 20 launches,
     all wgmma) bit-identical to its plain version;
  3d. beam-reorder kernel (X5): bit-identical to its plain version, per-cache
     and many forms, at the exp/beam_reorder_kernel.py harness shape and the FT0
     serving shape; times; the harness's 11-step x 12-cache loop (GB/s);
  3e. bf16-input attention kernel (X1, X2): against its plain version at X1's
     (256,196,12,64) in the (B,S,E) layout and X2's (32,730,16,80) head-major
     (fullseq), projection (direct) and bf16-out (allheads) layouts, and at
     edge cases (s_valid 1, 63, 65, 129; hd 72 and 128; one head); times
     beside the bound, SDPA's and K1's at the same shape;
  3f. tiled GEMM kernels (X3): the s8 path's transpose bit-identical to its
     plain version at the probes' w (1280,5120), a ragged one and edges;
     the GEMM bit-identical for s8, within 1e-5 of a float64 product
     (relative to sum |x*w|) for bf16 and float32, at make_matmul's
     (16384,1280,5120) s8 and bf16, make_mm's (8192,1280,5120) checksum in
     float32, bf16 and s8 (s8 also at bn 16, 256, 1024), ragged shapes, s8
     edges (K=16, M=1, N=16) and bf16 and float32 edges ((1,16,16) and
     (129,1040,272), whole and bn=16; float32 also (300,1040,512) at
     bn=256); times beside the bound and torch._int_mm (on w as given and
     column-major) / torch.mm, and the transpose's share of each s8 call's
     device time; the int32 wrap of the s8 checksum;
  3g. one-pass flash-attention kernel (X6, TMA + wgmma): against its plain
     version at the kernel's blocking (64 keys) and at the harnesses' (256,
     768: JAX's multi-step and single-step bodies), at the DFN5B harness's
     (32,16,768,80) and attn_variants' (256,12,256,64), both read in place
     from the padded (B,Sp,H,hd) projections with segment ids, and at edge
     cases (S=1, S=100 with hd 8/64/80/128, Sq != Skv, two packed segments, a
     query with every key masked, no segment ids); times beside the bound,
     SDPA with the segment mask and, at the DFN5B shape, attention_bf16's;
  4. serving path: NOVICModel serving SigLIP-B/16 (random weights from a seed)
     + the FT0 decoder with beam k=10, unguided and guided over all 42,919
     nouns, 2 batches of 64 seeded 224x224 frames; checks the outputs and that
     every kernel launched on this path (12 attention launches per tower forward);
  4b. int8 serving path: a TorchEmbedder with vision.quant="int8:pallas" (the
     same seeded weights) embeds the 2 x 64 frames, NOVICModel.classify_embeds
     labels them unguided and guided; 72 K2 launches (all of its wgmma
     instance) and 12 attention launches per tower forward; card vs CPU and
     int8 vs bf16 cosines; tower ms and K2's share of the tower's device time,
     read by kernel name (the share must be nonzero, and the mma.sync
     instance absent);
  4c. text towers: SigLIP-B/16's (bidirectional, last pool) and OpenAI
     ViT-B/16's (causal, argmax pool) at full width, B=256, bf16 and int8,
     through inference_tokens (seeded ids) and inference_text (FT0 nouns,
     test tokenizer); launch counts, card vs CPU, int8 vs bf16, texts/s;
  4e. the DFN5B-H-14-378 embedder at full width (32-layer vision tower at
     378 px, S=730; 24-layer causal text tower), random weights from a seed,
     bf16 and int8: 2 x 32 seeded uint8 frames preprocessed on the card, 32
     fused_attention and (int8) 192 int8_matmul launches per vision forward,
     every one of K2's wgmma instance; texts at B=256; card vs CPU on 1 frame
     and 4 texts; int8 vs bf16; ms per batch, images/s, texts/s, peak memory,
     K1's (its pre-pass and attention kernel, by name) and K2's device shares
     (K2's read as in 4b);
  4f. the harness paths at their own sizes: exp/dfn5b_attention's tower (B=32,
     32 layers) with the plain chain, X2's three schedules and the flash
     variant (X6; 32 kernel launches a pass each), and its bf16-residual runs
     (the plain chain and flash768), exp/pallas_attn_v2's tower (B=256, 12
     layers) plain and with X1 (12 a pass), and the X3 probe loops (8
     launches a loop, each of its form's instance; an int8 loop's each after
     its own transpose);
  4g. exp/attn_variants' ViT-B/16 tower (B=256, 12 layers) with each attention
     variant and tower_bhsd: ms per pass, X6 launches (12 a pass with
     attn_flash), cosine to attn_xla_f32's tower, and the file's flash-vs-xla
     check at B=4;
  4d. decode modes on the 2 x 64 served embeddings: reorder-mode beam k=10
     (G = 7 X5 launches per batch), unguided and trie-guided, against lazy mode
     (top-1 identical, scores within 1e-4); greedy and vocab-prior gencfgs
     through NOVICModel; greedy and reorder card vs CPU on 2 images;
  5. card vs CPU: 2 images through the same port on device="cpu" (plain
     versions) and on the card (kernels): embedding cosine and top-1 labels;
  6. timings at B=64 (decode lazy and reorder, greedy, vocab priors), and
     profiles of one served batch and of one reorder-mode decode (device busy
     share, X5's device time);
  7. training path: `novic_tpu_torch.cli.train action=train` at the FT0
     asset's recipe and full width (hidden 512, 6 layers, batch 1024 x accum
     8, dropout 0.1/0.1, GaussElemUniformAngle noise) for one epoch (8
     optimizer steps) of a seeded 65,536-row cache; checks finite losses, the
     loss drop, 50 dropout launches per microbatch, and that the checkpoint
     serves 64 frames on the card; then ms per step, samples/s, peak memory
     and a profile of one step;
  8. card vs CPU for one training step (64 rows, dropout on, noise off):
     loss, pre-clip grad norm and the updated params;
then the kernels line and, last, {"ok": true, "device": {...}}.
Exits nonzero without printing a result when CUDA is not available.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
INT8_OP_PER_S = 1979e12     # H100 SXM dense int8 tensor-core peak
FP32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
# Phase 3e: the bf16-input attention kernel's bf16 outputs round one bf16 ulp
# (2^-8 relative) apart where the float32 values differ in their last bits,
# so their relative Frobenius bar is wider than KERNEL_REL_FRO
KERNEL_REL_FRO_BF16 = 4e-4
# Phase 3g: X6 against its plain version at the harnesses' blockings (256,
# 768). Every p is rounded to bf16 at another point (unnormalised per 64-key
# block in the kernel; per 256-key block, or normalised in the single-step
# body), so every output moves, not only where a p sits on a rounding
# boundary. A rounding's relative error is uniform in +-2^-8, rms 2^-8/sqrt(3)
# = 2.3e-3 per p; two independent roundings differ by sqrt(2) times that, and
# the output norm is smaller than that of the terms it averages. The first
# run measured 1.3e-3 (256) and 3.0e-3 (768) at the DFN5B shape and 3.0e-3
# (256) at attn_variants': the bar is 2 x sqrt(2) x 2^-8/sqrt(3) = 6.4e-3. The
# elementwise bar is unchanged: each p is within 2^-8 relative of exact
# whichever max it is taken against, so each output stays within
# 2^-7 * max|v| of the other's.
KERNEL_REL_FRO_BLOCKING = 2 * math.sqrt(2) * 2.0 ** -8 / math.sqrt(3)
# Phase 3f: bf16 and float32 products within this of a float64 product,
# relative to the sum of |x*w| over the same terms (float32 sums of K terms)
MATMUL_REL = 1e-5
DFN5B_SPEC = "openclip:apple/DFN5B-CLIP-ViT-H-14-378"
DFN5B_BATCH, DFN5B_BATCHES = 32, 2
# Phase 4e, card vs CPU at DFN5B-H-378's depth: the bf16 residual stream is
# rounded after every block, so a last-bit difference between the card's sums
# and the CPU's becomes a bf16 ulp now and then, and 1 - cosine grows with the
# depth. The 12-layer towers above give 3-5e-5 and hold COSINE_MIN; the
# 24-layer text tower gave 0.8-1.0e-4 (the first run of this phase), so its
# bf16 bar is 0.9998; the 32-layer vision tower keeps COSINE_MIN. int8
# multiplies such differences about five-fold (INT8_TEXT_COSINE_MIN): both
# int8 towers are held to 0.9995.
DFN5B_TEXT_COSINE_MIN, DFN5B_INT8_COSINE_MIN = 0.9998, 0.9995
# Phase 4f: the harness towers with the kernels against their plain chains,
# cosine per token: the kernels round the normalised P to bf16, the chains
# round the scores and the softmax to bf16
HARNESS_COSINE_MIN = 0.999
# int8 towers (phases 4b, 4c): int8 vs bf16 embeddings on the card. The JAX
# package gives 0.9998 (vision) and 0.9994 (text) at these widths on the CPU
INT8_VS_BF16_VISION, INT8_VS_BF16_TEXT = 0.999, 0.998
# Card vs CPU for an int8 text tower at bf16 compute: a bf16 activation one
# ulp apart (sums in another order; K1's p rounding) is about half an int8 step
# near its row's maximum, and a row maximum one ulp apart shifts every code of
# the row, so int8 multiplies the bf16 towers' 1 - cosine (4e-5 for the SigLIP
# text tower on the card) about five-fold. The vision tower keeps COSINE_MIN.
INT8_TEXT_COSINE_MIN = 0.9995
# Reorder vs lazy beam on the card (phase 4d): the two modes sum the attention
# over the candidate's slots in another order (G slots vs H*G with -inf bias),
# so scores differ in the last float32 bits of a sum of 7 log-probabilities
REORDER_VS_LAZY_ATOL = 1e-4
DECODE_GENCFGS = ["greedy_k1_vnone_gn_t1_a0", "greedy_k1_vnone_gp_t1_a0",
                  "beam_k10_vtok1_gn_t1_a0", "beam_k10_vtgt0.5_gp_t1_a0"]
CLIP_SPEC = "openai:ViT-B/16"
TEXT_BATCH = 256
# Training (phases 7-8): the FT0 asset's recipe (its cfg_flat) at full width
TRAIN_ROWS = 65_536         # one epoch = 64 loader batches = 8 optimizer steps
TRAIN_BATCH, TRAIN_ACCUM = 1024, 8
DROPOUT_SITES = 1 + 4 * 6   # input dropout + 4 per layer x 6 layers
# Card vs CPU for one step: float32 GEMMs sum in another order on each side;
# with the restored AdamW moments an update moves by lr * (1 - beta1) * dg /
# (sqrt(v) + eps), far below these bounds for a grad error of ~1e-5 relative
STEP_LOSS_RTOL, STEP_NORM_RTOL, STEP_PARAM_ATOL = 1e-4, 1e-3, 1e-6


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


L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


def device_ms(fn, iters: int = 20, warmup: int = 3, cold: bool = False) -> float:
    """Mean device time of fn() in ms: the summed duration of the device
    kernels (and copies) it ran, from torch.profiler, over `iters` calls. Unlike
    cuda_ms, host launch overhead between calls does not count. With `cold`,
    each call finds the L2 cache cold: a 256 MB uint8 fill runs before it, and
    its time is left out."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda") if cold else None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # A profiling window can come back without device events (seen with
    # microsecond kernels); such a window is repeated, never reported as 0 ms
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if cold:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0 and not e.key.startswith("Activity Buffer")
                 and not (cold and "FillFunctor<unsigned char>" in e.key))
        if us > 0:
            return us / 1e3 / iters
    raise SystemExit("device_ms: the profiler recorded no device time in 5 windows")


def host_launch_us(n: int = 2000) -> float:
    """Host time of one small kernel launch now: the wall time of n queued
    one-element adds over n. Decode is launch-bound, so its wall time follows
    this, which varies between runs on a shared host."""
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


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


# K1's two kernels by name in a profile: the bf16 pre-pass and the attention
# kernel (attention_bf16.cu's is attention_bf16_kernel, which neither matches)
K1_KERNELS = ("::to_bf16_kernel(", "::attention_kernel<")


def phase_kernel(attention) -> tuple[dict, dict]:
    """Phase 3: fused_attention (kernel) against attention_reference (plain) on
    the card, at the towers' shapes (timed, with the pre-pass's share of the
    device time) and at edge shapes. Returns the lines of the serving shape and
    the DFN5B shape."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    result = dfn5b = None
    for B, S, H, hd, causal, timed in [
            (BATCH, 196, 12, 64, False, True), (32, 730, 16, 80, False, True),
            (8, 729, 16, 72, False, True), (8, 77, 8, 64, True, True),
            # edges: one key; a ragged tile with the causal bias; hd 8 (one
            # k-step, zero-filled past hd) and 128 (two atoms, three consumers)
            (2, 1, 3, 64, False, False), (2, 65, 3, 64, True, False),
            (2, 100, 3, 8, False, False), (2, 129, 3, 128, True, False)]:
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
        line = {"phase": "kernel", "name": "fused_attention", "instance": "wgmma",
                "shape": [B, S, H, hd], "causal_bias": causal, "max_abs_err": err,
                "rel_fro_err": rel_fro,
                "tol": f"|d| <= {KERNEL_ATOL} + 2^-7 max|v|, rel_fro <= {KERNEL_REL_FRO}", "ok": ok}
        if timed:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            run = lambda: attention.fused_attention(q, k, v, bias)  # noqa: E731
            prof = device_profile(run, match=K1_KERNELS)
            bound_ms, bound_by = attention_bound_ms(B, S, H, hd, causal)
            line.update(ms=cuda_ms(run), plain_ms=cuda_ms(
                lambda: attention.attention_reference(q, k, v, bias)),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                          attn_mask=bias)),
                bound_ms=bound_ms, bound_by=bound_by,
                device_ms_by_kernel={name.strip(":(<"): sum(m[1] for m in prof["matched_kernels"]
                                                           if name in m[0])
                                     for name in K1_KERNELS})
        emit(line)
        if not ok:
            raise SystemExit(f"fused_attention disagrees with its plain version at {line['shape']}")
        if result is None:
            result = line  # the serving shape
        if (B, S, H, hd) == (32, 730, 16, 80):
            dfn5b = line  # the DFN5B-H-378 vision tower's
    return result, dfn5b


def dropout_bound_ms(n: int, itemsize: int) -> tuple[float, str]:
    """Least time: x read once and y written once over the HBM rate (the Philox
    and compare work is integer arithmetic, far under any peak rate)."""
    return 2 * n * itemsize / HBM_BYTES_PER_S * 1e3, "bytes"


def phase_dropout(dropout) -> dict:
    """Phase 3b: the dropout kernel against dropout_reference (plain) on the card."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    seeds = torch.Generator().manual_seed(SEED)
    result = None
    B, S, E, H, FF = TRAIN_BATCH, 11, 512, 8, 128
    for shape in [(B, S, E), (B, H, S, S), (B, S, FF), (1_000_003,)]:
        for rate in (0.1, 0.5):
            x = torch.randn(shape, device="cuda", generator=gen, requires_grad=True)
            g = torch.randn(shape, device="cuda", generator=gen)
            seed = dropout.draw_seed(seeds)
            y = dropout.dropout(x, seed, rate)
            (y * g).sum().backward()
            torch.cuda.synchronize()
            ref = dropout.dropout_reference(x.detach(), seed, rate)
            err = (y.detach() - ref).abs().max().item()
            # The mask itself, from the plain version's bits (randn can return an
            # exact 0, so the mask is not read off the values)
            n = x.numel()
            keep = (dropout.philox_bits(seed, 0, n, "cuda") < dropout.keep_threshold(rate))
            keep = keep.reshape(shape)
            inv = dropout.inv_keep(rate, torch.float32)
            zero = torch.zeros((), device="cuda")
            bwd_ok = (torch.equal(y.detach(), torch.where(keep, x.detach() * inv, zero))
                      and torch.equal(x.grad, torch.where(keep, g * inv, zero)))
            keep = keep.float().mean().item()
            sigma = math.sqrt(rate * (1 - rate) / n)
            xd = x.detach()
            # Device time per call (the small sites' kernels are shorter than a
            # Python launch, so back-to-back event timing would time the host);
            # call_ms is the event-timed cost per call, host launch included
            ms = device_ms(lambda: dropout.dropout_apply(xd, seed, rate))
            plain_ms = device_ms(lambda: dropout.dropout_reference(xd, seed, rate), iters=5)
            library_ms = device_ms(lambda: F.dropout(xd, p=rate, training=True))
            call_ms = cuda_ms(lambda: dropout.dropout_apply(xd, seed, rate))
            bound_ms, bound_by = dropout_bound_ms(n, xd.element_size())
            ok = err == 0.0 and bwd_ok and abs(keep - (1 - rate)) <= 5 * sigma
            line = {"phase": "kernel", "name": "dropout", "shape": list(shape), "rate": rate,
                    "max_abs_err": err, "tol": "bit-identical (0)", "backward_mask_ok": bwd_ok,
                    "keep_share": keep, "keep_5sigma": 5 * sigma, "ok": ok, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "call_ms": call_ms}
            emit(line)
            if not ok:
                raise SystemExit(f"dropout disagrees with its plain version at {shape}, rate {rate}")
            if result is None:
                result = line  # the largest FT0 site, rate 0.1
    return result


def int8_bound_ms(M: int, N: int, K: int, out_bytes: int, scales: bool,
                  bias: bool) -> tuple[float, str]:
    """Least time: the int8 operands, the scales and the bias read once and the
    output written once over the HBM rate, vs 2MNK over the int8 peak."""
    nbytes = (M * K + N * K + out_bytes * M * N + (4 * (M + N) if scales else 0)
              + (4 * N if bias else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * M * N * K / INT8_OP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# (label, M, K, N): the int8 towers' GEMMs (vision at B=64: 64 x 196 tokens;
# the SigLIP text tower at B=256: 256 x 64 tokens), the edges of the Hopper
# instance's 128 x 128 tiles and 128-byte K stages (one row; a tile row past a
# whole number; N not a multiple of the tile, even and odd; the least K it
# takes), the shapes that keep the mma.sync instance (K % 16 != 0; a base
# that is not 16-byte aligned), and the DFN5B-H MLP pair of
# exp/pallas_int8_mlp_chain.py (X4)
INT8_SHAPES = [("vision q/k/v/o", 12544, 768, 768), ("vision fc1", 12544, 768, 3072),
               ("vision fc2", 12544, 3072, 768), ("text fc1", 16384, 768, 3072),
               ("edge M=1", 1, 768, 768), ("edge M=129", 129, 768, 768),
               ("edge N=200", 1000, 768, 200), ("edge N=199", 300, 768, 199),
               ("edge K=16", 512, 16, 384), ("ragged", 257, 70, 200),
               ("unaligned base", 257, 768, 256)]
X4_SHAPES = [("x4 fc1", 16384, 1280, 5120), ("x4 fc2", 16384, 5120, 1280)]


def phase_int8(int8mm) -> tuple[dict, dict]:
    """Phase 3c: K2 against its plain version on the card, every epilogue
    bit-identical, each shape through the instance its shape picks (counted);
    then exp/pallas_int8_mlp_chain.py's fused chain (X4's path). Returns the
    kernels-line sources: (vision fc1 int32, x4 fc1 bfloat16, ragged int32: the
    mma.sync instance)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    picked = {}
    for label, M, K, N in INT8_SHAPES + X4_SHAPES:
        xq = torch.randint(-127, 128, (M, K), device="cuda", generator=gen, dtype=torch.int8)
        wq = torch.randint(-127, 128, (N, K), device="cuda", generator=gen, dtype=torch.int8)
        if label == "unaligned base":  # the same values, one byte into a buffer
            xq = torch.cat([xq.new_zeros(1), xq.reshape(-1)])[1:].view(M, K)
        want_instance = ("wgmma" if K % 16 == 0 and xq.data_ptr() % 16 == 0
                         and wq.data_ptr() % 16 == 0 else "mma_sync")
        sx = torch.rand(M, device="cuda", generator=gen) * 1e-2 + 1e-4
        sw = torch.rand(N, device="cuda", generator=gen) * 1e-2 + 1e-4
        b = torch.randn(N, device="cuda", generator=gen)
        epilogues = {
            "int32": (lambda: int8mm.int8_matmul(xq, wq),
                      lambda: int8mm.int8_matmul_reference(xq, wq), 4, False, False),
            "float32+bias": (lambda: int8mm.int8_matmul_dequant(xq, sx, wq, sw, b),
                             lambda: int8mm.int8_matmul_dequant_reference(xq, sx, wq, sw, b),
                             4, True, True),
            "bfloat16": (lambda: int8mm.int8_matmul_dequant(xq, sx, wq, sw, None, torch.bfloat16),
                         lambda: int8mm.int8_matmul_dequant_reference(xq, sx, wq, sw, None,
                                                                      torch.bfloat16), 2, True, False),
        }
        names = ["int32", "bfloat16"] if label.startswith("x4") else ["int32", "float32+bias"]
        for epi in names:
            run, plain, out_bytes, scales, bias = epilogues[epi]
            before = dict(int8mm.INSTANCE_LAUNCHES)
            out = run()
            torch.cuda.synchronize()
            ran = [k for k, n in int8mm.INSTANCE_LAUNCHES.items() if n != before[k]]
            ref = plain()
            err = (out.double() - ref.double()).abs().max().item()
            ok = torch.equal(out, ref) and ran == [want_instance]
            library_ms = None
            if epi == "int32" and M > 16 and K % 8 == 0 and N % 8 == 0 and ran == ["wgmma"]:
                library_ms = device_ms(lambda: torch._int_mm(xq, wq.t()))
            bound_ms, bound_by = int8_bound_ms(M, N, K, out_bytes, scales, bias)
            line = {"phase": "kernel", "name": "int8_matmul", "shape": label, "mkn": [M, K, N],
                    "epilogue": epi, "instance": ran, "expected_instance": want_instance,
                    "max_abs_err": err, "tol": "bit-identical (0)", "ok": ok,
                    "ms": device_ms(run), "plain_ms": device_ms(plain, iters=3, warmup=1),
                    "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
            emit(line)
            if not ok:
                raise SystemExit(f"int8_matmul ({epi}) disagrees with its plain version at {label} "
                                 f"or ran the {ran} instance (expected {want_instance})")
            if (label, epi) in (("vision fc1", "int32"), ("x4 fc1", "bfloat16"),
                                ("ragged", "int32")):
                picked[label] = line
            del out, ref

    # X4's path: the harness's fused chain, h -> quantize -> fc1 (bf16
    # dequant) -> gelu -> quantize -> fc2 (bf16 dequant), 10 chained steps, with
    # the kernel and with the plain version; the bf16 chain is the control
    E, Fd = 1280, 5120
    cpu = torch.Generator().manual_seed(SEED)
    x0 = (torch.randn(16384, E, generator=cpu) * 0.05).to(torch.bfloat16).cuda()
    w1 = (torch.randn(Fd, E, generator=cpu) * 0.02).cuda()
    w2 = (torch.randn(E, Fd, generator=cpu) * 0.02).cuda()
    (w1q, s1), (w2q, s2) = int8mm.quantize_weight(w1), int8mm.quantize_weight(w2)
    w1b, w2b = w1.to(torch.bfloat16), w2.to(torch.bfloat16)

    def int8_chain(mm):
        h = x0
        for _ in range(10):
            xq, sx = int8mm.quantize_rows(h)
            a = F.gelu(mm(xq, sx, w1q, s1, None, torch.bfloat16).float(), approximate="tanh")
            aq, sa = int8mm.quantize_rows(a)
            h = mm(aq, sa, w2q, s2, None, torch.bfloat16)
        return h

    def bf16_chain():
        h = x0
        for _ in range(10):
            a = F.gelu(torch.mm(h, w1b.t(), out_dtype=torch.float32), approximate="tanh")
            h = torch.mm(a.to(torch.bfloat16), w2b.t(), out_dtype=torch.float32).to(torch.bfloat16)
        return h

    int8mm.LAUNCHES = 0
    int8mm.INSTANCE_LAUNCHES = dict.fromkeys(int8mm.INSTANCE_LAUNCHES, 0)
    out = int8_chain(int8mm.int8_matmul_dequant)
    torch.cuda.synchronize()
    launches = int8mm.LAUNCHES
    ok = (torch.equal(out, int8_chain(int8mm.int8_matmul_dequant_reference)) and launches == 20
          and int8mm.INSTANCE_LAUNCHES["wgmma"] == launches)
    line = {"phase": "x4_chain", "steps": 10, "rows": 16384, "launches": launches,
            "instance_launches": dict(int8mm.INSTANCE_LAUNCHES), "bit_identical_to_plain": ok,
            "int8_ms_per_step": cuda_ms(lambda: int8_chain(int8mm.int8_matmul_dequant),
                                        iters=3, warmup=1) / 10,
            "bf16_ms_per_step": cuda_ms(bf16_chain, iters=3, warmup=1) / 10}
    emit(line)
    if not ok:
        raise SystemExit("the int8 MLP chain disagrees with its plain version or launched "
                         f"{int8mm.INSTANCE_LAUNCHES} times (expected 20, all wgmma)")
    picked["x4 fc1"]["path_launches"] = launches
    return picked["vision fc1"], picked["x4 fc1"], picked["ragged"]


def reorder_bound_ms(n: int, rows_read: int, rows: int, row_bytes: int,
                     cand_bytes: int) -> tuple[float, str]:
    """Least time for n caches of `rows` rows: the rows that cand names (each
    read once; candidates repeat, so fewer than `rows`), every row written once,
    cand read once, over the HBM rate (a permutation does no arithmetic)."""
    return (n * (rows_read + rows) * row_bytes + cand_bytes) / HBM_BYTES_PER_S * 1e3, "bytes"


# X5's shapes (label, B, H, G, heads, hd, dtype): exp/beam_reorder_kernel.py's
# harness, and FT0 serving at B=64, k=10 (token_length 8: G=7; 8 heads x 64)
REORDER_SHAPES = [("harness", 256, 10, 11, 8, 64, torch.bfloat16),
                  ("ft0_serving", BATCH, 10, 7, 8, 64, torch.float32)]
REORDER_CACHES, HARNESS_STEPS = 12, 11


def phase_beam_reorder(reorder) -> tuple[dict, dict]:
    """Phase 3d: X5 against its plain version on the card, bit for bit, per-cache
    and many forms at both shapes; then the harness's 11-step x 12-cache loop.
    Returns the kernels-line sources (FT0 serving shape): (per-cache, many)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    picked = {}
    for label, B, H, G, heads, hd, dtype in REORDER_SHAPES:
        xs = [torch.randn(B * H, G, heads, hd, device="cuda", generator=gen).to(dtype)
              for _ in range(REORDER_CACHES)]
        cand = torch.randint(0, H, (B, H), device="cuda", generator=gen)
        rows = (torch.arange(B, device="cuda")[:, None] * H + cand).reshape(-1)
        flat = [x.reshape(B * H, -1) for x in xs]
        one = reorder.beam_reorder(xs[0], cand)
        many = reorder.beam_reorder_many(xs, cand)
        torch.cuda.synchronize()
        refs = [reorder.reorder_reference(x, cand) for x in xs]
        checks = {"per_cache": [(one, refs[0])], "many": list(zip(many, refs))}
        for form, pairs in checks.items():
            err = max((o.float() - r.float()).abs().max().item() for o, r in pairs)
            ok = all(torch.equal(o, r) for o, r in pairs)
            n = len(pairs)
            if form == "per_cache":
                run = lambda: reorder.beam_reorder(xs[0], cand)  # noqa: E731
                plain = lambda: reorder.reorder_reference(xs[0], cand)  # noqa: E731
                library = lambda: flat[0].index_select(0, rows)  # noqa: E731
            else:
                run = lambda: reorder.beam_reorder_many(xs, cand)  # noqa: E731
                plain = lambda: [reorder.reorder_reference(x, cand) for x in xs]  # noqa: E731
                library = lambda: [f.index_select(0, rows) for f in flat]  # noqa: E731
            rows_read = rows.unique().numel()
            bound_ms, bound_by = reorder_bound_ms(n, rows_read, B * H,
                                                  flat[0][0].numel() * flat[0].element_size(),
                                                  cand.numel() * cand.element_size())
            # Device time with the L2 cold before each call (decode finds the
            # caches cold: a step moves more than the 50 MB L2), and warm
            library_ms = device_ms(library, cold=True)
            line = {"phase": "kernel", "name": "beam_reorder" if n == 1 else "beam_reorder_many",
                    "shape": label, "cache": [B * H, G, heads, hd], "dtype": str(dtype),
                    "caches": n, "rows_read": rows_read, "rows": B * H, "max_abs_err": err,
                    "tol": "bit-identical (0)", "ok": ok,
                    "ms": device_ms(run, cold=True), "plain_ms": device_ms(plain, iters=5, cold=True),
                    "library_ms": library_ms if n == 1 else None,
                    "index_select_per_cache_total_ms": library_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "warm_ms": device_ms(run),
                    "call_ms": cuda_ms(run)}
            emit(line)
            if not ok:
                raise SystemExit(f"beam_reorder ({form}) disagrees with its plain version at {label}")
            if label == "ft0_serving":
                picked[form] = line
        del xs, flat, one, many, refs

    # The harness: 11 sequential steps over 12 caches, out of place (ping-pong)
    label, B, H, G, heads, hd, dtype = REORDER_SHAPES[0]
    cur = [torch.randn(B * H, G, heads, hd, device="cuda", generator=gen).to(dtype)
           for _ in range(REORDER_CACHES)]
    spare = [torch.empty_like(x) for x in cur]
    cands = torch.randint(0, H, (HARNESS_STEPS, B, H), device="cuda", generator=gen)

    def loop(form):
        a, b = cur, spare
        for s in range(HARNESS_STEPS):
            if form == "many":
                reorder.beam_reorder_many(a, cands[s], out=b)
            elif form == "per_cache":
                for x, o in zip(a, b):
                    reorder.beam_reorder(x, cands[s], out=o)
            else:
                b = [reorder.reorder_reference(x, cands[s]) for x in a]
            a, b = b, a
        return a

    # Effective rate over every row read and written; the bound counts only the
    # rows each step's cand names
    row_bytes = G * heads * hd * cur[0].element_size()
    gbytes = REORDER_CACHES * B * H * row_bytes * 2 * HARNESS_STEPS / 1e9
    rows_read = sum((torch.arange(B, device="cuda")[:, None] * H + c).unique().numel() for c in cands)
    bound_ms, _ = reorder_bound_ms(REORDER_CACHES, rows_read, HARNESS_STEPS * B * H, row_bytes,
                                   cands.numel() * cands.element_size())
    harness = {"phase": "x5_harness", "steps": HARNESS_STEPS, "caches": REORDER_CACHES,
               "cache": [B * H, G, heads, hd], "dtype": str(dtype), "gbytes_moved": gbytes,
               "rows_read_share": rows_read / (HARNESS_STEPS * B * H), "bound_ms": bound_ms}
    for form in ("one_hot_plain", "per_cache", "many"):
        reorder.LAUNCHES = 0
        loop(form)
        torch.cuda.synchronize()
        harness[f"{form}_launches"] = reorder.LAUNCHES
        ms = cuda_ms(lambda: loop(form), iters=5, warmup=1)
        harness[f"{form}_ms"] = ms
        harness[f"{form}_gb_per_s"] = gbytes / (ms / 1e3)
    emit(harness)
    want = {"one_hot_plain": 0, "per_cache": HARNESS_STEPS * REORDER_CACHES, "many": HARNESS_STEPS}
    if any(harness[f"{f}_launches"] != n for f, n in want.items()):
        raise SystemExit(f"the X5 harness launched {[harness[f + '_launches'] for f in want]}, "
                         f"expected {list(want.values())}")
    picked["per_cache"]["path_launches"] = harness["per_cache_launches"]
    return picked["per_cache"], picked["many"]


def sass_counts(lib) -> dict:
    """Instructions in a library's SASS (cuobjdump from the CUDA toolkit):
    HGMMA (wgmma on floating-point inputs), IGMMA (wgmma on s8), UTMALDG /
    UTMASTG (TMA loads / stores), SYNCS (mbarrier operations)."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return {op: sum(line.count(op) for line in text.splitlines()) for op in
            ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG", "SYNCS")}


def attention_bf16_bound_ms(B, S, H, hd, out_bytes: int) -> tuple[float, str]:
    """Least time: bf16 q, k, v read once and o written once over the HBM rate,
    vs the two S x S x hd products over the bf16 peak."""
    n = B * S * H * hd
    t_bytes = (3 * 2 + out_bytes) * n / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * B * H * S * S * hd / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(1e-30))) - 7)


def phase_attention_bf16(ab, k1_dfn5b: dict) -> dict:
    """Phase 3e: the bf16-input attention kernel (X1, X2) against its plain
    version on the card, in each harness's layout and output dtype. Returns
    the lines by replaced function."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16
    # X1: (256, 196, 768) projections read in place as (B, S, H, hd)
    B, S, H, hd = 256, 196, 12, 64
    x1 = [torch.randn(B, S, H * hd, device="cuda", generator=gen).to(bf).view(B, S, H, hd)
          for _ in range(3)]
    # X2: (32, 730, 16, 80) padded to 736 rows (direct, allheads) and moved to
    # (B*H, 768, 1, hd) (fullseq), as the harness's preps do
    B2, S2, H2, hd2 = 32, 730, 16, 80
    proj = [F.pad(torch.randn(B2, S2, H2, hd2, device="cuda", generator=gen).to(bf),
                  (0, 0, 0, 0, 0, 736 - S2)) for _ in range(3)]
    head_major = [F.pad(t, (0, 0, 0, 0, 0, 768 - 736)).transpose(1, 2).reshape(B2 * H2, 768, 1, hd2)
                  for t in proj]
    cases = {"fused_attention2": ("exp/pallas_attn_v2.py:44", x1, S, 1.0 / math.sqrt(hd),
                                  torch.float32),
             "fullseq": ("exp/dfn5b_attention.py:131", head_major, S2, 1.0, torch.float32),
             "allheads": ("exp/dfn5b_attention.py:175", proj, S2, 1.0, bf),
             "direct": ("exp/dfn5b_attention.py:246", proj, S2, 1.0, torch.float32)}

    def check(q, k, v, sv, scale, od) -> tuple[bool, float, float, str]:
        out = ab.attention_bf16(q, k, v, sv, scale, od)
        torch.cuda.synchronize()
        ref = ab.attention_bf16_reference(q, k, v, sv, scale, od)
        diff = (out.float() - ref.float()).abs()
        vmax = v[:, :sv].float().abs().amax(dim=1, keepdim=True)  # over keys
        ulp = bf16_ulp(ref) if od == bf else 0.0
        rel_fro = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        rel_bar = KERNEL_REL_FRO_BF16 if od == bf else KERNEL_REL_FRO
        ok = bool((diff <= KERNEL_ATOL + 2.0 ** -7 * vmax + ulp).all()) and rel_fro <= rel_bar
        tol = (f"|d| <= {KERNEL_ATOL} + 2^-7 max|v|{' + 1 bf16 ulp' if od == bf else ''}, "
               f"rel_fro <= {rel_bar}")
        return ok, diff.max().item(), rel_fro, tol

    # Edges of the tensor maps and the ring: s_valid within, at and past a
    # 64-key tile and a 128-query block; hd 72 (an atom zero-filled past hd)
    # and 128 (two full atoms); a head dimension of size 1
    edges = [(f"s_valid_{sv}", (2, 160, 3, 64), sv, torch.float32) for sv in (1, 63, 65, 129)]
    edges += [(f"hd{hd}_{str(od)[6:]}", (2, 100, 3, hd), 100, od) for hd in (72, 128)
              for od in (torch.float32, bf)]
    edges += [("heads_1", (4, 96, 1, 64), 90, torch.float32)]
    for name, shape, sv, od in edges:
        q, k, v = (torch.randn(*shape, device="cuda", generator=gen).to(bf) for _ in range(3))
        ok, err, rel_fro, tol = check(q, k, v, sv, 1.0 / math.sqrt(shape[3]), od)
        emit({"phase": "kernel", "name": "attention_bf16", "case": name, "shape": list(shape),
              "s_valid": sv, "out_dtype": str(od), "max_abs_err": err, "rel_fro_err": rel_fro,
              "tol": tol, "ok": ok})
        if not ok:
            raise SystemExit(f"attention_bf16 ({name}) disagrees with its plain version")

    lines = {}
    for name, (replaces, (q, k, v), sv, scale, od) in cases.items():
        run = lambda: ab.attention_bf16(q, k, v, sv, scale, od)  # noqa: E731
        ok, err, rel_fro, tol = check(q, k, v, sv, scale, od)
        qt, kt, vt = (t[:, :sv].transpose(1, 2) for t in (q, k, v))
        bound_ms, bound_by = attention_bf16_bound_ms(q.shape[0], sv, q.shape[2], q.shape[3],
                                                     od.itemsize)
        line = {"phase": "kernel", "name": "attention_bf16", "replaces": replaces, "case": name,
                "shape": [q.shape[0], sv, q.shape[2], q.shape[3]], "strides": list(q.stride()),
                "out_dtype": str(od), "scale": scale, "max_abs_err": err, "rel_fro_err": rel_fro,
                "tol": tol, "ok": ok,
                "ms": cuda_ms(run), "plain_ms": cuda_ms(lambda: ab.attention_bf16_reference(
                    q, k, v, sv, scale, od), iters=3, warmup=1),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)),
                "bound_ms": bound_ms, "bound_by": bound_by}
        if sv == S2:  # K1 at the same shape, float32 in and out (phase 3)
            line["k1_fused_attention_ms"] = k1_dfn5b["ms"]
        emit(line)
        if not ok:
            raise SystemExit(f"attention_bf16 ({name}) disagrees with its plain version")
        lines[name] = line
    return lines


def matmul_bound_ms(M: int, N: int, K: int, in_bytes: int, out_elems: int,
                    peak: float) -> tuple[float, str]:
    """Least time: x and w read once and the output (4-byte elements) written
    once over the HBM rate, vs 2MNK over the peak rate of the input type."""
    t_bytes = ((M * K + K * N) * in_bytes + 4 * out_elems) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * N * K / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# (label, input form, M, K, N, bn): exp/pallas_int8_matmul.py make_matmul's
# shape (full output), exp/pallas_int8_rate_pin.py make_mm's (checksum over
# bn=512 column blocks; s8 also over the bn the probe's sweep and ragged
# calls pass: 16, within a tile; 256; 1024, across tiles), ragged shapes
# (other bn), the s8 engine's edges (K = 16, one partial 128-byte stage; one
# row; N = 16, one partial store box), and the bf16 and float32 kernels'
# edges (one row; a tile row and K stage past a whole number, whole and with
# bn = 16; float32 also a 256-wide bn, whose blocks hold whole tiles)
TILED_CASES = [("make_matmul", "s8", 16384, 1280, 5120, None),
               ("make_matmul", "bf16", 16384, 1280, 5120, None),
               ("make_mm", "f32", 8192, 1280, 5120, 512), ("make_mm", "bf16", 8192, 1280, 5120, 512),
               ("make_mm", "s8", 8192, 1280, 5120, 512),
               ("make_mm bn16", "s8", 8192, 1280, 5120, 16),
               ("make_mm bn256", "s8", 8192, 1280, 5120, 256),
               ("make_mm bn1024", "s8", 8192, 1280, 5120, 1024),
               ("edge K=16", "s8", 300, 16, 400, None), ("edge K=16", "s8", 300, 16, 400, 16),
               ("edge M=1", "s8", 1, 272, 400, None), ("edge M=1", "s8", 1, 272, 400, 80),
               ("edge N=16", "s8", 1000, 272, 16, None), ("edge N=16", "s8", 1000, 272, 16, 16),
               ("ragged", "s8", 1000, 272, 400, None), ("ragged", "bf16", 1000, 272, 400, 80),
               ("ragged", "f32", 1000, 272, 400, 40), ("ragged", "s8", 1000, 272, 400, 16),
               ("edge", "bf16", 1, 16, 16, None), ("edge", "bf16", 1, 16, 16, 16),
               ("edge", "bf16", 129, 1040, 272, None), ("edge", "bf16", 129, 1040, 272, 16),
               ("ragged", "f32", 1000, 272, 400, None), ("edge", "f32", 1, 16, 16, None),
               ("edge", "f32", 1, 16, 16, 16), ("edge", "f32", 129, 1040, 272, None),
               ("edge", "f32", 129, 1040, 272, 16), ("edge", "f32", 300, 1040, 512, 256)]
TILED_FORMS = {"s8": (torch.int8, 1, INT8_OP_PER_S), "bf16": (torch.bfloat16, 2, BF16_FLOP_PER_S),
               "f32": (torch.float32, 4, FP32_FLOP_PER_S)}


TILED_INSTANCES = {"s8": "s8_wgmma", "bf16": "bf16_wgmma", "f32": "f32_fma"}
# The s8 path's transpose, w (K, N) -> wᵀ (N, K): the probes' w, a ragged one,
# and edges of its 128 x 128-byte tile (one 16 x 16 chunk; K past a tile)
TRANSPOSE_SHAPES = [("probe", 1280, 5120), ("ragged", 272, 400), ("edge", 16, 16),
                    ("edge", 1040, 272)]
# The s8 wgmma engine that K2's Hopper instance and X3's s8 path include
S8_ENGINE = "novic_tpu_torch/ops/csrc/int8_wgmma.cuh"
# An s8 call's two kernels by name in a profile
X3_S8_KERNELS = ("transpose_s8_kernel", "int8_wgmma_kernel")


def yardstick_ms(fn) -> float | None:
    """cuda_ms of a library call timed beside a kernel, or None where the
    library refuses the inputs (torch._int_mm takes more than 16 rows, and
    cuBLAS refuses some small int8 layouts, such as K = 16 with w row-major)."""
    try:
        return cuda_ms(fn)
    except RuntimeError:
        return None


def phase_transpose(tm, gen) -> dict:
    """Phase 3f, first: the s8 path's transpose kernel against its plain
    version, bit-identical, timed (device time) at the probes' and a ragged
    w, each call finding the L2 cache cold (w's 6.5 MB would stay in the 50 MB
    L2 between calls, and the bound counts device-memory bytes), and warm.
    Returns the probes' line."""
    picked = None
    for label, K, N in TRANSPOSE_SHAPES:
        w = torch.randint(-128, 128, (K, N), device="cuda", generator=gen, dtype=torch.int8)
        before = tm.TRANSPOSE_LAUNCHES
        out = tm.transpose_s8(w)
        torch.cuda.synchronize()
        ref = tm.transpose_s8_reference(w)
        ok = torch.equal(out, ref) and tm.TRANSPOSE_LAUNCHES == before + 1
        line = {"phase": "kernel", "name": "transpose_s8", "case": label, "kn": [K, N],
                "max_abs_err": (out.int() - ref.int()).abs().max().item(),
                "tol": "bit-identical (0)", "ok": ok}
        if label != "edge":
            line.update(ms=device_ms(lambda: tm.transpose_s8(w), cold=True),
                        plain_ms=device_ms(lambda: tm.transpose_s8_reference(w), cold=True),
                        library_ms=device_ms(lambda: w.t().contiguous(), cold=True),
                        library_call="w.t().contiguous(), which is also the plain version",
                        bound_ms=2 * K * N / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                        ms_warm_l2=device_ms(lambda: tm.transpose_s8(w)),
                        call_ms=cuda_ms(lambda: tm.transpose_s8(w)))
        emit(line)
        if not ok:
            raise SystemExit(f"transpose_s8 disagrees with its plain version at {(K, N)}")
        if label == "probe":
            picked = line
    return picked


def phase_tiled_matmul(tm) -> tuple[dict, dict]:
    """Phase 3f: the transpose kernel, then the tiled GEMM (X3) against its
    plain version and a float64 product on the card, each call through its
    form's instance (an s8 call also through one transpose). Returns the GEMM
    lines by (label, form) and the transpose's line."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    transpose = phase_transpose(tm, gen)
    picked = {}
    for label, form, M, K, N, bn in TILED_CASES:
        dt, in_bytes, peak = TILED_FORMS[form]
        xf = torch.randn(M, K, device="cuda", generator=gen)
        wf = torch.randn(K, N, device="cuda", generator=gen)
        # The probes' operands: normal, cast to bf16, or x * 10 truncated to int8
        x, w = ((xf * 10).to(dt), (wf * 10).to(dt)) if dt == torch.int8 else (xf.to(dt), wf.to(dt))
        del xf, wf
        run = lambda: tm.tiled_matmul(x, w, bn)  # noqa: E731
        before, transposes = dict(tm.INSTANCE_LAUNCHES), tm.TRANSPOSE_LAUNCHES
        out = run()
        torch.cuda.synchronize()
        ran = {k: n - before[k] for k, n in tm.INSTANCE_LAUNCHES.items() if n != before[k]}
        transposes = tm.TRANSPOSE_LAUNCHES - transposes
        launched_ok = ran == {TILED_INSTANCES[form]: 1} and transposes == (dt == torch.int8)
        ref = tm.tiled_matmul_reference(x, w, bn)
        line = {"phase": "kernel", "name": "tiled_matmul", "case": label, "form": form,
                "mkn": [M, K, N], "bn": bn, "instance": ran, "transposes": transposes}
        if dt == torch.int8:
            ok = torch.equal(out, ref)
            line.update(max_abs_err=(out.double() - ref.double()).abs().max().item(),
                        tol="bit-identical (0)")
        else:
            y64 = x.double() @ w.double()
            a64 = x.double().abs() @ w.double().abs()
            if bn:
                y64, a64 = y64.reshape(M, -1, bn).sum(-1), a64.reshape(M, -1, bn).sum(-1)
            rel = ((out.double() - y64).abs() / a64).max().item()
            ok = rel <= MATMUL_REL
            line.update(max_abs_err=(out.double() - y64).abs().max().item(), rel_err=rel,
                        plain_rel_err=((ref.double() - y64).abs() / a64).max().item(),
                        tol=f"|d| <= {MATMUL_REL} sum|x*w| vs a float64 product")
            del y64, a64
        ok = ok and launched_ok
        # One library call on the same inputs: the full product (make_mm's
        # block sums are one more op on top of it)
        if dt == torch.int8:
            w_cm = w.t().contiguous().t()  # the same values, column-major as cuBLAS wants them
            library = lambda: torch._int_mm(x, w)  # noqa: E731
            line["int_mm_w_column_major_ms"] = yardstick_ms(lambda: torch._int_mm(x, w_cm))
            # The transpose's share of the call's device time
            prof = device_profile(run, match=X3_S8_KERNELS)
            split = {k: sum(m[1] for m in prof["matched_kernels"] if k in m[0])
                     for k in X3_S8_KERNELS}
            line.update(device_ms_by_kernel=split,
                        transpose_share=split["transpose_s8_kernel"] / sum(split.values()))
        elif dt == torch.bfloat16:
            library = lambda: torch.mm(x, w, out_dtype=torch.float32)  # noqa: E731
        else:
            library = lambda: torch.mm(x, w)  # noqa: E731
        bound_ms, bound_by = matmul_bound_ms(M, N, K, in_bytes, M * (N // bn if bn else N), peak)
        line.update(ok=ok, ms=cuda_ms(run), plain_ms=cuda_ms(lambda: tm.tiled_matmul_reference(
            x, w, bn), iters=3, warmup=1), library_ms=yardstick_ms(library),
            library_call="torch._int_mm" if dt == torch.int8 else "torch.mm",
            bound_ms=bound_ms, bound_by=bound_by)
        emit(line)
        if not ok:
            raise SystemExit(f"tiled_matmul ({label}, {form}) disagrees with its plain version "
                             f"or launched {ran} and {transposes} transposes")
        if label in ("make_matmul", "make_mm"):
            picked[(label, form)] = line
        del x, w, out, ref
    # The s8 checksum's int32 sums wrap past 2^31 as the probe's int32 scratch does
    x = torch.full((2, 32), 127, dtype=torch.int8, device="cuda")
    w = torch.full((32, 8192), 127, dtype=torch.int8, device="cuda")
    got, want = tm.tiled_matmul(x, w, bn=8192), tm.tiled_matmul_reference(x, w, bn=8192)
    torch.cuda.synchronize()
    emit({"phase": "kernel", "name": "tiled_matmul", "case": "int32_wrap", "sum": 32 * 127 * 127 * 8192,
          "got": got[0, 0].item(), "ok": torch.equal(got, want)})
    if not torch.equal(got, want):
        raise SystemExit("tiled_matmul: the s8 checksum does not wrap as int32")
    return picked, transpose


def flash_bound_ms(B, H, sq, skv, hd, seg: bool) -> tuple[float, str]:
    """Least time: bf16 q, k, v read once, o written once (and the int32
    segment ids read once) over the HBM rate, vs the two Sq x Skv x hd
    products over the bf16 peak. Every query row is computed, padded ones
    included."""
    nbytes = 2 * B * H * hd * (2 * sq + 2 * skv) + (4 * B * (sq + skv) if seg else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * B * H * sq * skv * hd / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# X6's cases (label, B, H, Sq, Skv, hd, segments, blockings held): the two
# harness shapes read in place from the padded (B, Sp, H, hd) projections with
# the harnesses' segment ids (S real tokens), then edge cases
FLASH_CASES = [("dfn5b", 32, 16, 768, 768, 80, 730, (None, 256, 768)),
               ("attn_variants", 256, 12, 256, 256, 64, 196, (None, 256)),
               ("s1", 2, 3, 1, 1, 64, None, (None,)),
               ("hd8", 2, 3, 100, 100, 8, 90, (None,)),
               ("hd64", 2, 3, 100, 100, 64, 90, (None,)),
               ("hd80", 2, 3, 100, 100, 80, 90, (None,)),
               ("hd128", 2, 3, 100, 100, 128, 90, (None,)),
               ("sq_ne_skv", 2, 3, 70, 200, 80, "sq_ne_skv", (None,)),
               ("packed", 2, 3, 300, 300, 64, "packed", (None,)),
               ("masked_row", 2, 3, 130, 130, 80, "masked_row", (None,)),
               ("no_segment_ids", 2, 3, 150, 150, 64, None, (None,))]
FLASH_REPLACES = {"dfn5b": "exp/dfn5b_attention.py:91 -> jax/experimental/pallas/ops/tpu/"
                           "flash_attention.py:758",
                  "attn_variants": "exp/attn_variants.py:68 -> jax/experimental/pallas/ops/tpu/"
                                   "flash_attention.py:758"}


def _flash_segments(kind, B, sq, skv):
    """Segment ids (q, kv) int32 on the card for a 3g case, or None."""
    if kind is None:
        return None
    ar_q, ar_kv = torch.arange(sq, device="cuda"), torch.arange(skv, device="cuda")
    if isinstance(kind, int):  # the harnesses': 1 over the real tokens, 0 over the padding
        q, kv = (ar_q < kind).int(), (ar_kv < kind).int()
    elif kind == "sq_ne_skv":
        q, kv = (ar_q < sq - 10).int(), (ar_kv < skv - 30).int()
    elif kind == "packed":  # two segments in one row
        q, kv = (ar_q >= sq // 3).int() + 1, (ar_kv >= skv // 3).int() + 1
    else:  # masked_row: query 0 is in a segment no key has
        q, kv = torch.ones(sq, dtype=torch.int32, device="cuda"), torch.ones(
            skv, dtype=torch.int32, device="cuda")
        q[0] = 7
    return q[None].repeat(B, 1).contiguous(), kv[None].repeat(B, 1).contiguous()


def phase_flash_attention(fa, ab) -> dict:
    """Phase 3g: X6 against its plain version on the card at the kernel's
    blocking and at the harnesses'. Returns the harness shapes' lines."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16
    lines = {}
    for label, B, H, sq, skv, hd, seg_kind, blockings in FLASH_CASES:
        def proj(n):  # (B, n, H, hd) bf16, zero past the real tokens, read as (B, H, n, hd)
            x = torch.randn(B, n, H, hd, device="cuda", generator=gen).to(bf)
            if isinstance(seg_kind, int):
                x[:, seg_kind:] = 0
            return x.transpose(1, 2)

        q, k, v = proj(sq), proj(skv), proj(skv)
        segs = _flash_segments(seg_kind, B, sq, skv)
        scale = 1.0 / math.sqrt(hd)
        run = lambda: fa.flash_attention(q, k, v, segment_ids=segs, sm_scale=scale)  # noqa: E731
        out = run().float()
        torch.cuda.synchronize()
        vmax = v.float().abs().amax(dim=2, keepdim=True)  # over keys
        line = {"phase": "kernel", "name": "flash_attention", "instance": "wgmma", "case": label,
                "shape": [B, H, sq, skv, hd], "q_strides": list(q.stride()),
                "segments": seg_kind if seg_kind is None or isinstance(seg_kind, str)
                else f"1 over {seg_kind} tokens, 0 over the padding", "blockings": {}}
        ok = bool(torch.isfinite(out).all())
        for bk in blockings:
            ref = fa.flash_attention_reference(q, k, v, segs, scale, bk).float()
            diff = (out - ref).abs()
            rel_fro = ((out - ref).norm() / ref.norm()).item()
            rel_bar = KERNEL_REL_FRO_BF16 if bk is None else KERNEL_REL_FRO_BLOCKING
            held = bool((diff <= KERNEL_ATOL + 2.0 ** -7 * vmax + bf16_ulp(ref)).all()) \
                and rel_fro <= rel_bar
            line["blockings"]["kernel (64)" if bk is None else str(bk)] = {
                "max_abs_err": diff.max().item(), "rel_fro_err": rel_fro, "rel_fro_bar": rel_bar,
                "ok": held}
            ok = ok and held
            del ref, diff
        if seg_kind == "masked_row":  # every key masked: the plain mean of v over every key
            mean = v.float().mean(dim=2)
            err = (out[:, :, 0] - mean).abs()
            line["masked_row_vs_mean_of_v"] = err.max().item()
            ok = ok and bool((err <= bf16_ulp(mean) + 1e-5).all())
        line["max_abs_err"] = line["blockings"]["kernel (64)"]["max_abs_err"]
        line["tol"] = (f"|d| <= {KERNEL_ATOL} + 2^-7 max|v| + 1 bf16 ulp; rel_fro <= "
                       f"{KERNEL_REL_FRO_BF16} (kernel blocking), {KERNEL_REL_FRO_BLOCKING:.2e} "
                       f"(256, 768)")
        line["ok"] = ok
        mask = None if segs is None else segs[0][:, None, :, None] == segs[1][:, None, None, :]
        bound_ms, bound_by = flash_bound_ms(B, H, sq, skv, hd, segs is not None)
        line.update(ms=cuda_ms(run), plain_ms=cuda_ms(
            lambda: fa.flash_attention_reference(q, k, v, segs, scale), iters=3, warmup=1),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                      scale=scale)),
            library_call="scaled_dot_product_attention(attn_mask=segment mask)",
            bound_ms=bound_ms, bound_by=bound_by)
        if label == "dfn5b":  # X2's kernel on the same projections (730 real rows), bf16 out
            qp, kp, vp = (t.transpose(1, 2) for t in (q, k, v))
            line["attention_bf16_ms"] = cuda_ms(lambda: ab.attention_bf16(qp, kp, vp, seg_kind,
                                                                          scale, bf))
        emit(line)
        if not ok:
            raise SystemExit(f"flash_attention disagrees with its plain version ({label})")
        if label in FLASH_REPLACES:
            lines[label] = line
        del q, k, v, out, mask
    return lines


def cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def device_profile(fn, match: tuple = ("dropout_f32", "dropout_bf16")) -> dict:
    """Wall time, device busy time and the largest device ops of one call of fn;
    "matched_kernels" lists the device ops whose name holds one of `match`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    # Device-side events only (kernels, copies): host ops also carry the
    # device time of what they launched, which would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0 and not e.key.startswith("Activity Buffer")]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    return {"wall_ms": wall / 1e3, "device_busy_ms": device_us / 1e3,
            "device_idle_share": 1.0 - device_us / wall,
            "top_device_kernels_ms": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                                      for e in top],
            "matched_kernels": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                                for e in events if any(m in e.key for m in match)]}


# K2's two instances by kernel name in a profile: the Hopper instance, which
# every tower shape takes, and the mma.sync one
K2_KERNELS = ("int8_wgmma_kernel", "int8_gemm_kernel")


def k2_share(prof: dict, launches: int) -> tuple[float, dict]:
    """K2's device ms in a tower profile (matched on K2_KERNELS), all of it
    the Hopper instance's. Raises where the tower launched K2 but the profile
    shows none of it, or shows the mma.sync instance: a renamed kernel cannot
    drop out of the tower's account."""
    by_kernel = {name: sum(m[1] for m in prof["matched_kernels"] if name in m[0])
                 for name in K2_KERNELS}
    if launches and (by_kernel["int8_wgmma_kernel"] <= 0 or by_kernel["int8_gemm_kernel"] > 0):
        raise SystemExit(f"K2 in the tower's profile: {by_kernel} after {launches} launches "
                         "(expected the Hopper instance alone)")
    return by_kernel["int8_wgmma_kernel"], by_kernel


def check_output(out, n: int, guide: set | None, k: int = 10) -> None:
    lp = np.asarray(out.logprobs, dtype=np.float64)
    if lp.shape != (n, k) or len(out.preds) != n or any(len(r) != k for r in out.preds):
        raise SystemExit(f"unexpected output shape {lp.shape}")
    if not np.isfinite(lp).all():
        raise SystemExit("non-finite logprobs")
    if (np.diff(lp, axis=1) > 1e-6).any():
        raise SystemExit("logprobs not descending per row")
    if guide is not None:
        bad = [p for row in out.preds for p in row if p not in guide]
        if bad:
            raise SystemExit(f"guided preds outside the guide set: {bad[:5]}")


def torch_embedder(spec: str, arch, nouns: list, device: str, batch: int):
    """A TorchEmbedder built directly with a replaced arch (random weights from
    SEED: the same towers as Embedder.create's), as JaxEmbedder can be."""
    from novic_tpu_torch.embedders.base import TorchEmbedder
    from novic_tpu_torch.text.simple import make_test_tokenizer

    return TorchEmbedder(spec=spec, arch=arch, load_model=True, check=False, weights_path=None,
                         tokenizer=make_test_tokenizer(nouns, context_length=arch.text.context_length),
                         compute_dtype="bfloat16", seed=SEED, device=device,
                         inference_batch_size=batch, image_batch_size=batch)


def phase_int8_serving(model, frames: list, nouns: list, guided_cfg: str, name: str,
                       smi: str) -> dict:
    """Phase 4b: the int8 vision tower on the serving path."""
    from novic_tpu_torch.embedders.registry import lookup
    from novic_tpu_torch.ops import attention, int8_matmul

    arch = lookup(SPEC)
    arch8 = dataclasses.replace(arch, vision=dataclasses.replace(arch.vision, quant="int8:pallas"))
    emb = torch_embedder(SPEC, arch8, nouns, "cuda", BATCH)
    pixels = [model.transform_images(frames[i:i + BATCH]) for i in range(0, len(frames), BATCH)]
    attention.LAUNCHES = int8_matmul.LAUNCHES = 0
    int8_matmul.INSTANCE_LAUNCHES = dict.fromkeys(int8_matmul.INSTANCE_LAUNCHES, 0)
    t0 = time.perf_counter()
    embeds = np.concatenate([emb.inference_image(p) for p in pixels])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k2, k1 = int8_matmul.LAUNCHES, attention.LAUNCHES
    k2_instances = dict(int8_matmul.INSTANCE_LAUNCHES)
    forwards = len(pixels)
    labels = {}
    for label, gencfg in (("unguided", None), ("guided", guided_cfg)):
        out = model.classify_embeds(embeds, gencfg=gencfg)
        check_output(out, len(frames), set(nouns) if gencfg else None)
        labels[label] = [r[:3] for r in out.preds[:2]]
    cpu = torch_embedder(SPEC, arch8, nouns, "cpu", 2)
    e_cpu = cpu.inference_image(cpu.get_image_transform()(frames[:2]))
    del cpu
    cos_cpu = cosines(e_cpu, embeds[:2])
    top1_cpu = [r[0] for r in model.classify_embeds(e_cpu).preds]
    top1_gpu = [r[0] for r in model.classify_embeds(embeds[:2]).preds]
    cos_bf16 = cosines(embeds[:BATCH], model.embedder.inference_image(pixels[0]))
    bf16_ms = cuda_ms(lambda: model.embedder.embed_image_tensor(pixels[0]), iters=5, warmup=1)
    int8_ms = cuda_ms(lambda: emb.embed_image_tensor(pixels[0]), iters=5, warmup=1)
    prof = device_profile(lambda: emb.embed_image_tensor(pixels[0]), match=K2_KERNELS)
    k2_ms, k2_by_kernel = k2_share(prof, k2)
    line = {"phase": "int8_serving", "device": name, "nvidia_smi": smi, "quant": "int8:pallas",
            "images": len(frames), "tower_forwards": forwards, "int8_matmul_launches": k2,
            "int8_matmul_instance_launches": k2_instances,
            "fused_attention_launches": k1, "first_call_s": seconds, "labels": labels,
            "card_vs_cpu_cosine": cos_cpu.tolist(), "top1_cpu": top1_cpu, "top1_gpu": top1_gpu,
            "int8_vs_bf16_cosine_min": float(cos_bf16.min()),
            "int8_vs_bf16_cosine_mean": float(cos_bf16.mean()),
            "tower_ms_per_batch": int8_ms, "bf16_tower_ms_per_batch": bf16_ms,
            "profile_wall_ms": prof["wall_ms"], "profile_device_busy_ms": prof["device_busy_ms"],
            "int8_matmul_device_ms": k2_ms, "int8_matmul_share": k2_ms / prof["device_busy_ms"],
            "int8_matmul_device_ms_by_kernel": k2_by_kernel,
            "top_device_kernels_ms": prof["top_device_kernels_ms"]}
    emit(line)
    del emb
    torch.cuda.empty_cache()
    if k2 != 72 * forwards or k1 != 12 * forwards or k2_instances["wgmma"] != k2:
        raise SystemExit(f"int8 tower: {k2_instances} int8_matmul and {k1} fused_attention "
                         f"launches over {forwards} forwards (expected 72, all wgmma, and 12 "
                         "per forward)")
    if cos_cpu.min() < COSINE_MIN or top1_cpu != top1_gpu:
        raise SystemExit("int8 tower: card and CPU disagree")
    if cos_bf16.min() < INT8_VS_BF16_VISION:
        raise SystemExit(f"int8 tower: cosine to the bf16 tower {cos_bf16.min()} < "
                         f"{INT8_VS_BF16_VISION}")
    return line


def device_guide(dec, nouns: list) -> tuple[torch.Tensor, dict]:
    """The guide ids of `nouns` and their trie tables on the card, as
    GenerationTask keeps them."""
    from novic_tpu_torch.infer import load_guide_targets
    from novic_tpu_torch.models.guide_trie import build_guide_trie

    ids, _ = load_guide_targets(dec.target_tokenizer, nouns)
    t = build_guide_trie(ids, dec.cfg.vocab_size, dec.cfg.token_length - 1)
    trie = {k: [torch.from_numpy(x).cuda() for x in t[k]]
            for k in ("child_tok", "child_id", "child_pack")}
    return torch.from_numpy(ids.astype(np.int64)).cuda(), trie


def beam_direct(dec_model, e: torch.Tensor, mode: str, guide=None):
    """generate_beam at k=10 in `mode`, unguided or guided through (ids, trie)."""
    from novic_tpu_torch.models.generate import generate_beam

    kw = {} if guide is None else dict(guide_targets=guide[0], guide_trie=guide[1])
    return generate_beam(dec_model, e, topk=10, cache_mode=mode, **kw)


def phase_decode_modes(model, embeds: np.ndarray, nouns: list, ck: dict, guide,
                       name: str, smi: str) -> dict:
    """Phase 4d: reorder-mode beam search (X5 on the path) on the 2 x 64 served
    embeddings, unguided and trie-guided, against lazy mode on the card; greedy
    and vocab-prior gencfgs through NOVICModel; card vs CPU on 2 images."""
    from novic_tpu_torch.bridge import decoder_from_numpy
    from novic_tpu_torch.models.generate import generate_greedy
    from novic_tpu_torch.ops import attention, beam_reorder, dropout, int8_matmul

    dec = model.decoder
    G = dec.cfg.token_length - 1
    batches = [torch.from_numpy(embeds[i:i + BATCH]).cuda() for i in range(0, len(embeds), BATCH)]
    nouns_set = set(nouns)
    line = {"phase": "decode_modes", "device": name, "nvidia_smi": smi, "images": len(embeds),
            "batches": len(batches), "topk": 10, "decode_steps": G}
    for label, g in (("unguided", None), ("guided", guide)):
        attention.LAUNCHES = dropout.LAUNCHES = int8_matmul.LAUNCHES = beam_reorder.LAUNCHES = 0
        t0 = time.perf_counter()
        reorder = [beam_direct(dec.model, e, "reorder", g) for e in batches]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = beam_reorder.LAUNCHES
        others = attention.LAUNCHES + dropout.LAUNCHES + int8_matmul.LAUNCHES
        lazy = [beam_direct(dec.model, e, "lazy", g) for e in batches]
        torch.cuda.synchronize()
        lazy_launches = beam_reorder.LAUNCHES - launches
        t_r, s_r = torch.cat([o[0] for o in reorder]), torch.cat([o[2] for o in reorder])
        t_l, s_l = torch.cat([o[0] for o in lazy]), torch.cat([o[2] for o in lazy])
        top1_same = bool(torch.equal(t_r[:, 0], t_l[:, 0]))
        score_diff = (s_r - s_l).abs().max().item()
        differs = (t_r != t_l).any(dim=-1)  # (n, K) ranks holding another candidate
        preds = dec.target_tokenizer.detokenize_target(t_r.cpu().numpy())
        finite = bool(torch.isfinite(s_r).all()) and bool((s_r > -1e29).all())
        descending = bool((s_r[:, 1:] <= s_r[:, :-1] + 1e-6).all())
        outside = [p for row in preds for p in row if p not in nouns_set] if g else []
        line[label] = {"x5_launches": launches, "x5_launches_per_batch": launches / len(batches),
                       "other_kernel_launches": others, "lazy_x5_launches": lazy_launches,
                       "first_call_s": seconds, "top1_identical_to_lazy": top1_same,
                       "max_score_diff_vs_lazy": score_diff,
                       "lower_ranks_swapped_vs_lazy": int(differs[:, 1:].sum()),
                       "labels": [r[:3] for r in preds[:2]], "finite": finite,
                       "descending": descending, "guided_outside_guide_set": len(outside)}
        if launches != G * len(batches) or lazy_launches or others:
            raise SystemExit(f"{label} reorder beam: {launches} X5 launches over {len(batches)} "
                             f"batches (expected {G} per batch), {lazy_launches} in lazy mode, "
                             f"{others} of other kernels")
        if not (top1_same and score_diff <= REORDER_VS_LAZY_ATOL and finite and descending
                and not outside):
            emit(line)
            raise SystemExit(f"{label} reorder beam disagrees with lazy mode or gave bad scores")

    # Greedy and vocab priors through NOVICModel
    line["gencfgs"] = {}
    for gencfg in DECODE_GENCFGS:
        t0 = time.perf_counter()
        out = model.classify_embeds(embeds, gencfg=gencfg)
        seconds = time.perf_counter() - t0
        k = int(gencfg.split("_")[1][1:])
        check_output(out, len(embeds), nouns_set if "_gp_" in gencfg else None, k)
        line["gencfgs"][gencfg] = {"first_call_s": seconds, "labels": [r[:3] for r in out.preds[:2]],
                                   "logprobs": [[round(x, 4) for x in r[:3]] for r in out.logprobs[:2]]}

    # Card vs CPU on 2 images: the same embeddings through the decoder on each
    cpu_model = decoder_from_numpy(ck["model_config"], ck["params"])
    e_cpu, e_gpu = torch.from_numpy(embeds[:2]), batches[0][:2]
    greedy = [generate_greedy(m, e, calc_loss=True) for m, e in ((dec.model, e_gpu), (cpu_model, e_cpu))]
    reord = [beam_direct(m, e, "reorder") for m, e in ((dec.model, e_gpu), (cpu_model, e_cpu))]
    line["card_vs_cpu"] = {
        "greedy_top1_identical": bool(torch.equal(greedy[0][0].cpu(), greedy[1][0])),
        "greedy_max_score_diff": (greedy[0][5].cpu() - greedy[1][5]).abs().max().item(),
        "reorder_top1_identical": bool(torch.equal(reord[0][0][:, 0].cpu(), reord[1][0][:, 0])),
        "reorder_max_score_diff": (reord[0][2].cpu() - reord[1][2]).abs().max().item(),
        "top1_gpu": dec.target_tokenizer.detokenize_target(reord[0][0][:, :1].cpu().numpy())}
    emit(line)
    cvc = line["card_vs_cpu"]
    if not (cvc["greedy_top1_identical"] and cvc["reorder_top1_identical"]):
        raise SystemExit("greedy or reorder decode: card and CPU disagree on top-1")
    return line


def phase_text(nouns: list, name: str, smi: str) -> None:
    """Phase 4c: the SigLIP and CLIP text towers at B=256, bf16 and int8."""
    from novic_tpu_torch.embedders.registry import lookup
    from novic_tpu_torch.ops import attention, int8_matmul

    rng = np.random.default_rng(SEED)
    for spec in (SPEC, CLIP_SPEC):
        arch = lookup(spec)
        ctx, vocab = arch.text.context_length, arch.text.vocab_size
        # Seeded ids below the top id, with the top id (CLIP's end token) once a row
        ids = rng.integers(0, vocab - 1, size=(TEXT_BATCH, ctx)).astype(np.int32)
        ids[np.arange(TEXT_BATCH), rng.integers(1, ctx, size=TEXT_BATCH)] = vocab - 1
        texts = list(nouns[:TEXT_BATCH])
        embeds = {}
        for quant in ("", "int8:pallas"):
            archq = dataclasses.replace(arch, text=dataclasses.replace(arch.text, quant=quant))
            emb = torch_embedder(spec, archq, nouns, "cuda", TEXT_BATCH)
            counts = []
            out = {}
            for label, fn in (("ids", lambda: emb.inference_tokens({"input_ids": ids})),
                              ("texts", lambda: emb.inference_text(texts))):
                attention.LAUNCHES = int8_matmul.LAUNCHES = 0
                out[label] = fn()
                torch.cuda.synchronize()
                counts.append((attention.LAUNCHES, int8_matmul.LAUNCHES))
            cpu = torch_embedder(spec, archq, nouns, "cpu", 2)
            e_cpu = cpu.inference_tokens({"input_ids": ids[:2]})
            del cpu
            cos_cpu = cosines(e_cpu, out["ids"][:2])
            tids = torch.from_numpy(ids).cuda()
            ms = cuda_ms(lambda: emb.embed_token_tensor(tids), iters=5, warmup=1)
            del emb
            torch.cuda.empty_cache()
            embeds[quant] = out
            finite = all(np.isfinite(v).all() and v.shape == (TEXT_BATCH, arch.text.embed_dim)
                         for v in out.values())
            want = (12, 72 if quant else 0)
            emit({"phase": "text_tower", "spec": spec, "device": name, "nvidia_smi": smi,
                  "quant": quant or "none", "causal": arch.text.causal, "pool": arch.text.pool,
                  "batch": TEXT_BATCH, "context": ctx, "launches_per_forward": counts,
                  "card_vs_cpu_cosine": cos_cpu.tolist(),
                  "card_vs_cpu_bar": INT8_TEXT_COSINE_MIN if quant else COSINE_MIN,
                  "ms_per_batch": ms,
                  "texts_per_s": TEXT_BATCH / (ms / 1e3), "finite": finite})
            if not finite:
                raise SystemExit(f"{spec} text tower ({quant or 'bf16'}): bad embeddings")
            if any(c != want for c in counts):
                raise SystemExit(f"{spec} text tower ({quant or 'bf16'}): launches {counts}, "
                                 f"expected {want} (fused_attention, int8_matmul) per forward")
            if cos_cpu.min() < (INT8_TEXT_COSINE_MIN if quant else COSINE_MIN):
                raise SystemExit(f"{spec} text tower ({quant or 'bf16'}): card and CPU disagree")
        cos = {k: cosines(embeds[""][k], embeds["int8:pallas"][k]) for k in ("ids", "texts")}
        emit({"phase": "text_int8_vs_bf16", "spec": spec,
              "cosine_min": {k: float(v.min()) for k, v in cos.items()},
              "cosine_mean": {k: float(v.mean()) for k, v in cos.items()},
              "bar": INT8_VS_BF16_TEXT})
        if min(v.min() for v in cos.values()) < INT8_VS_BF16_TEXT:
            raise SystemExit(f"{spec}: int8 text tower too far from the bf16 one")


def phase_dfn5b(nouns: list, name: str, smi: str) -> dict:
    """Phase 4e: the DFN5B-H-14-378 embedder at full width, bf16 and int8.
    Returns the bf16 line (K1's launches there feed the kernels line)."""
    from novic_tpu_torch.embedders.registry import lookup
    from novic_tpu_torch.ops import attention, int8_matmul

    arch = lookup(DFN5B_SPEC)
    size, layers, tlayers = arch.vision.image_size, arch.vision.layers, arch.text.layers
    rng = np.random.default_rng(SEED + 5)
    frames = [rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
              for _ in range(DFN5B_BATCH * DFN5B_BATCHES)]
    ctx, vocab = arch.text.context_length, arch.text.vocab_size
    ids = rng.integers(0, vocab - 1, size=(TEXT_BATCH, ctx)).astype(np.int32)
    ids[np.arange(TEXT_BATCH), rng.integers(1, ctx, size=TEXT_BATCH)] = vocab - 1
    texts = list(nouns[:4])
    lines, embeds, failures = {}, {}, []
    for quant in ("", "int8:pallas"):
        label = quant or "bf16"
        archq = dataclasses.replace(arch, vision=dataclasses.replace(arch.vision, quant=quant),
                                    text=dataclasses.replace(arch.text, quant=quant))
        t0 = time.perf_counter()
        emb = torch_embedder(DFN5B_SPEC, archq, nouns, "cuda", DFN5B_BATCH)
        init_s = time.perf_counter() - t0
        transform = emb.get_image_transform()
        torch.cuda.reset_peak_memory_stats()
        attention.LAUNCHES = int8_matmul.LAUNCHES = 0
        int8_matmul.INSTANCE_LAUNCHES = dict.fromkeys(int8_matmul.INSTANCE_LAUNCHES, 0)
        t0 = time.perf_counter()
        pixels = [transform(frames[i:i + DFN5B_BATCH]) for i in range(0, len(frames), DFN5B_BATCH)]
        image_embeds = np.concatenate([emb.inference_image(p) for p in pixels])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        k1, k2 = attention.LAUNCHES, int8_matmul.LAUNCHES
        k2_wgmma = int8_matmul.INSTANCE_LAUNCHES["wgmma"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        vision_ms = cuda_ms(lambda: emb.embed_image_tensor(pixels[0]), iters=3, warmup=1)
        preprocess_ms = cuda_ms(lambda: transform(frames[:DFN5B_BATCH]), iters=3, warmup=1)
        prof = device_profile(lambda: emb.embed_image_tensor(pixels[0]),
                              match=K1_KERNELS + K2_KERNELS)
        k1_dev = sum(m[1] for m in prof["matched_kernels"] if any(n in m[0] for n in K1_KERNELS))
        k2_dev, _ = k2_share(prof, k2)
        attention.LAUNCHES = int8_matmul.LAUNCHES = 0
        text_embeds = emb.inference_tokens({"input_ids": ids})
        torch.cuda.synchronize()
        tk1, tk2 = attention.LAUNCHES, int8_matmul.LAUNCHES
        tids = torch.from_numpy(ids).cuda()
        text_ms = cuda_ms(lambda: emb.embed_token_tensor(tids), iters=3, warmup=1)
        four = emb.inference_text(texts)
        del emb, pixels
        torch.cuda.empty_cache()
        # Card vs CPU (plain versions) on 1 frame and 4 texts, the same seeded towers
        t0 = time.perf_counter()
        cpu = torch_embedder(DFN5B_SPEC, archq, nouns, "cpu", 4)
        e_img = cpu.inference_image(cpu.get_image_transform()(frames[:1]))
        e_txt = cpu.inference_text(texts)
        cpu_s = time.perf_counter() - t0
        del cpu
        cos_img, cos_txt = cosines(e_img, image_embeds[:1]), cosines(e_txt, four)
        image_bar = DFN5B_INT8_COSINE_MIN if quant else COSINE_MIN
        text_bar = DFN5B_INT8_COSINE_MIN if quant else DFN5B_TEXT_COSINE_MIN
        finite = (np.isfinite(image_embeds).all() and np.isfinite(text_embeds).all()
                  and image_embeds.shape == (len(frames), arch.vision.embed_dim)
                  and text_embeds.shape == (TEXT_BATCH, arch.text.embed_dim))
        want = (layers, 6 * layers if quant else 0)
        want_text = (tlayers, 6 * tlayers if quant else 0)
        forwards = len(frames) // DFN5B_BATCH
        line = {"phase": "dfn5b", "spec": DFN5B_SPEC, "device": name, "nvidia_smi": smi,
                "quant": quant or "none", "images": len(frames), "batch": DFN5B_BATCH,
                "tokens": arch.vision.num_patches + 1, "layers": [layers, tlayers],
                "preprocess_on_card": True, "init_s": init_s, "first_call_s": first_s,
                "vision_launches": [k1, k2], "expected_vision_launches": [want[0] * forwards,
                                                                          want[1] * forwards],
                "vision_int8_matmul_wgmma_launches": k2_wgmma,
                "text_launches": [tk1, tk2], "expected_text_launches": list(want_text),
                "vision_ms_per_batch": vision_ms, "images_per_s": DFN5B_BATCH / (vision_ms / 1e3),
                "preprocess_ms_per_batch": preprocess_ms,
                "text_batch": TEXT_BATCH, "text_ms_per_batch": text_ms,
                "texts_per_s": TEXT_BATCH / (text_ms / 1e3), "peak_memory_gb": peak_gb,
                "profile_device_busy_ms": prof["device_busy_ms"],
                "fused_attention_device_ms": k1_dev,
                "fused_attention_share": k1_dev / prof["device_busy_ms"],
                "int8_matmul_device_ms": k2_dev, "int8_matmul_share": k2_dev / prof["device_busy_ms"],
                "top_device_kernels_ms": prof["top_device_kernels_ms"],
                "card_vs_cpu_cosine_image": cos_img.tolist(),
                "card_vs_cpu_cosine_text": cos_txt.tolist(),
                "card_vs_cpu_bars": [image_bar, text_bar], "cpu_side_s": cpu_s,
                "cpu_side_layers": [layers, tlayers], "finite": bool(finite)}
        emit(line)
        if ((k1, k2) != (want[0] * forwards, want[1] * forwards) or (tk1, tk2) != want_text
                or k2_wgmma != k2):
            raise SystemExit(f"DFN5B {label}: launches vision {(k1, k2)} ({k2_wgmma} of K2's "
                             f"wgmma), text {(tk1, tk2)}; expected {want} per vision forward, "
                             f"every K2 launch wgmma, and {want_text} per text forward")
        if not finite:
            raise SystemExit(f"DFN5B {label}: bad embeddings")
        # Both modes report before a disagreement fails the phase
        if cos_img.min() < image_bar or cos_txt.min() < text_bar:
            failures.append(f"DFN5B {label}: card and CPU disagree")
        lines[label] = line
        embeds[label] = (image_embeds, text_embeds)
    cos_v = cosines(embeds["bf16"][0], embeds["int8:pallas"][0])
    cos_t = cosines(embeds["bf16"][1], embeds["int8:pallas"][1])
    emit({"phase": "dfn5b_int8_vs_bf16", "image_cosine_min": float(cos_v.min()),
          "image_cosine_mean": float(cos_v.mean()), "text_cosine_min": float(cos_t.min()),
          "text_cosine_mean": float(cos_t.mean()), "bars": [INT8_VS_BF16_VISION, INT8_VS_BF16_TEXT]})
    if cos_v.min() < INT8_VS_BF16_VISION or cos_t.min() < INT8_VS_BF16_TEXT:
        failures.append("DFN5B: the int8 towers are too far from the bf16 ones")
    if failures:
        raise SystemExit("; ".join(failures))
    return lines["bf16"]


def phase_harnesses(name: str, smi: str) -> dict:
    """Phase 4f: the harness paths of X2, X1 and X3 at their own sizes.
    Returns the kernel launches of each path's driven run, by variant or loop."""
    from novic_tpu_torch.exp import attn_v2, int8_matmul_probe as probe
    from novic_tpu_torch.exp import dfn5b_attention as x2h
    from novic_tpu_torch.ops import attention_bf16 as ab, flash_attention as fa, tiled_matmul as tm

    def tokens_cosine(a, b):
        a, b = a.float().reshape(-1, a.shape[-1]), b.float().reshape(-1, b.shape[-1])
        return float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())

    launches = {}
    # X2 and X6: exp/dfn5b_attention.py's tower, B=32, 32 layers, each attention
    # variant (the X2 schedules launch attention_bf16, flash launches X6), then
    # the harness's bf16-residual runs
    params = x2h.make_params(seed=SEED, device="cuda")
    x0 = torch.randn((x2h.B, x2h.S, x2h.E), generator=torch.Generator().manual_seed(SEED + 6)).cuda()
    line = {"phase": "x2_harness", "device": name, "nvidia_smi": smi, "batch": x2h.B,
            "layers": len(params), "shape": [x2h.S, x2h.E, x2h.H, x2h.hd]}
    outs, counts = {}, {}
    runs = [(v, fn, torch.float32) for v, fn in x2h.VARIANTS.items()]
    runs += [(v, fn, dt) for v, (fn, dt) in x2h.RESID16.items()]
    with torch.inference_mode():
        for variant, fn, resid in runs:
            ab.LAUNCHES = fa.LAUNCHES = 0
            outs[variant] = x2h.tower(params, x0, fn, resid_dtype=resid)
            torch.cuda.synchronize()
            n = (ab.LAUNCHES, fa.LAUNCHES)
            ms = cuda_ms(lambda: x2h.tower(params, x0, fn, resid_dtype=resid), iters=3, warmup=1)
            line[variant] = {"attention_bf16_launches": n[0], "flash_attention_launches": n[1],
                             "ms_per_batch": ms, "images_per_s": x2h.B / (ms / 1e3),
                             "resid_dtype": str(resid),
                             "finite": bool(torch.isfinite(outs[variant]).all())}
            counts[variant] = n
            launches[variant] = n[1] if "flash" in variant else n[0]  # its kernel's
    for variant in ("fullseq", "allheads", "direct", "flash"):
        line[variant]["token_cosine_min_vs_plain"] = tokens_cosine(outs[variant], outs["xla"])
    flash768, xla16 = list(x2h.RESID16)[1], list(x2h.RESID16)[0]
    line[flash768]["token_cosine_min_vs_plain"] = tokens_cosine(outs[flash768], outs[xla16])
    line["fullseq_equals_direct"] = bool(torch.equal(outs["fullseq"], outs["direct"]))
    emit(line)
    del params, x0, outs
    torch.cuda.empty_cache()
    want = {v: (0, 0) if v.startswith("xla") else (0, x2h.LAYERS) if "flash" in v
            else (x2h.LAYERS, 0) for v, _, _ in runs}
    bad = [v for v, _, _ in runs if counts[v] != want[v] or not line[v]["finite"]]
    bad += [v for v in ("fullseq", "allheads", "direct", "flash", flash768)
            if line[v]["token_cosine_min_vs_plain"] < HARNESS_COSINE_MIN]
    if bad or not line["fullseq_equals_direct"]:
        raise SystemExit(f"X2 harness: {bad or 'fullseq != direct'} (launches, finiteness or "
                         f"cosine >= {HARNESS_COSINE_MIN} to the plain chain)")

    # X1: exp/pallas_attn_v2.py's tower, B=256, 12 layers, plain and with the kernel
    params = attn_v2.make_params(seed=SEED, device="cuda")
    x0 = torch.randn((attn_v2.B, attn_v2.S, attn_v2.E),
                     generator=torch.Generator().manual_seed(SEED + 7)).cuda()
    line = {"phase": "x1_harness", "device": name, "nvidia_smi": smi, "batch": attn_v2.B,
            "layers": len(params)}
    outs = {}
    with torch.inference_mode():
        for variant, use in (("plain", False), ("x1", True)):
            ab.LAUNCHES = 0
            outs[variant] = attn_v2.tower(x0, params, use)
            torch.cuda.synchronize()
            n = ab.LAUNCHES
            ms = cuda_ms(lambda: attn_v2.tower(x0, params, use), iters=3, warmup=1)
            line[variant] = {"launches": n, "ms_per_batch": ms,
                             "images_per_s": attn_v2.B / (ms / 1e3),
                             "finite": bool(torch.isfinite(outs[variant]).all())}
    line["x1"]["token_cosine_min_vs_plain"] = tokens_cosine(outs["x1"], outs["plain"])
    launches["fused_attention2"] = line["x1"]["launches"]
    emit(line)
    del params, x0, outs
    torch.cuda.empty_cache()
    if (line["plain"]["launches"], line["x1"]["launches"]) != (0, attn_v2.L) or not (
            line["plain"]["finite"] and line["x1"]["finite"]
            and line["x1"]["token_cosine_min_vs_plain"] >= HARNESS_COSINE_MIN):
        raise SystemExit("X1 harness: launches, finiteness or cosine to the plain chain")

    # X3: the probes' loops (INNER calls, each output summed), make_matmul at
    # (16384, 1280, 5120) and make_mm at (8192, 1280, 5120) over the sweep's bn
    def loop(fn, x, w):
        acc = torch.zeros((), device="cuda")
        for _ in range(probe.INNER):
            acc = acc + fn(x, w).sum().float()
        return acc

    line = {"phase": "x3_probes", "device": name, "nvidia_smi": smi, "inner": probe.INNER,
            "loops": {}}
    big, small = probe.inputs(probe.M, device="cuda"), probe.inputs(probe.MM_M, device="cuda")
    runs = [(f"make_matmul {form}", probe.make_matmul(*probe.MATMUL_TILE, dt, acc, acc),
             big[form])
            for form, dt, acc in (("bf16", torch.bfloat16, torch.float32),
                                  ("int8", torch.int8, torch.int32))]
    for bm, bn, bk in {t[1]: t for t in probe.MM_TILES}.values():  # one tile per bn
        runs += [(f"make_mm {form} bn{bn}", probe.make_mm(bm, bn, bk, acc), small[form])
                 for form, acc in (("f32", torch.float32), ("bf16", torch.float32),
                                   ("int8", torch.int32))]
    for key, fn, (x, w) in runs:
        tm.LAUNCHES = tm.TRANSPOSE_LAUNCHES = 0
        tm.INSTANCE_LAUNCHES = dict.fromkeys(tm.INSTANCE_LAUNCHES, 0)
        loop(fn, x, w).item()
        n, instances, transposes = tm.LAUNCHES, dict(tm.INSTANCE_LAUNCHES), tm.TRANSPOSE_LAUNCHES
        ms = cuda_ms(lambda: loop(fn, x, w), iters=3, warmup=1) / probe.INNER
        line["loops"][key] = {"launches": n, "instance_launches": instances,
                              "transpose_launches": transposes, "ms_per_call": ms,
                              "tflops": 2 * x.shape[0] * x.shape[1] * w.shape[1] / (ms / 1e3) / 1e12}
    emit(line)
    del big, small, runs
    torch.cuda.empty_cache()
    # Each loop launches only its form's instance, INNER times; an int8 loop
    # one transpose before each of its launches (the entry point launches both)
    bad = []
    for key, v in line["loops"].items():
        form = "s8" if " int8" in key else "bf16" if " bf16" in key else "f32"
        want = {k: probe.INNER if k == TILED_INSTANCES[form] else 0 for k in v["instance_launches"]}
        if (v["launches"], v["instance_launches"], v["transpose_launches"]) != (
                probe.INNER, want, probe.INNER if form == "s8" else 0):
            bad.append(key)
    if bad:
        raise SystemExit(f"X3 probes: {bad} launched other than {probe.INNER} calls of their "
                         "form's instance (and, for int8, as many transposes)")
    launches.update({key: v["launches"] for key, v in line["loops"].items()})
    launches["transpose_s8"] = sum(v["transpose_launches"] for v in line["loops"].values())
    return launches


def phase_attn_variants(name: str, smi: str) -> int:
    """Phase 4g: exp/attn_variants.py's ViT-B/16 tower at B=256, 12 layers,
    with each attention variant and tower_bhsd; the file's flash-vs-xla check.
    Returns X6's launches in the attn_flash pass."""
    from novic_tpu_torch.exp import attn_variants as av
    from novic_tpu_torch.ops import attention_bf16 as ab, flash_attention as fa

    params = av.make_params(av.L, seed=SEED, device="cuda")
    x0 = torch.randn((av.B, av.S, av.E), generator=torch.Generator().manual_seed(SEED + 8)).cuda()
    line = {"phase": "attn_variants", "device": name, "nvidia_smi": smi, "batch": av.B,
            "layers": len(params), "shape": [av.S, av.E, av.H, av.hd], "padded_to": av.SP}
    ab.LAUNCHES = fa.LAUNCHES = 0
    line["flash_vs_xla_max_abs_diff_b4"] = av.check("cuda")
    line["check_launches"] = fa.LAUNCHES
    runs = {v: (lambda x, p, a=attn: av.tower(x, a, p)) for v, attn in av.VARIANTS.items()}
    runs["tower_bhsd"] = av.tower_bhsd
    outs = {}
    with torch.inference_mode():
        for variant, fn in runs.items():
            ab.LAUNCHES = fa.LAUNCHES = 0
            outs[variant] = fn(x0, params)
            torch.cuda.synchronize()
            n = (fa.LAUNCHES, ab.LAUNCHES)
            ms = cuda_ms(lambda: fn(x0, params), iters=3, warmup=1)
            line[variant] = {"flash_attention_launches": n[0], "attention_bf16_launches": n[1],
                             "ms_per_batch": ms, "images_per_s": av.B / (ms / 1e3),
                             "finite": bool(torch.isfinite(outs[variant]).all())}
    for variant in runs:
        a = outs[variant].float().reshape(-1, av.E)
        b = outs["attn_xla_f32"].float().reshape(-1, av.E)
        line[variant]["token_cosine_min_vs_attn_xla_f32"] = float(
            torch.nn.functional.cosine_similarity(a, b, dim=-1).min())
    emit(line)
    del params, x0, outs
    torch.cuda.empty_cache()
    bad = [v for v in runs if (line[v]["flash_attention_launches"], line[v]["attention_bf16_launches"])
           != ((av.L if v == "attn_flash" else 0), 0) or not line[v]["finite"]
           or line[v]["token_cosine_min_vs_attn_xla_f32"] < HARNESS_COSINE_MIN]
    if bad or line["check_launches"] != 1 or not 0 < line["flash_vs_xla_max_abs_diff_b4"] < 0.05:
        raise SystemExit(f"attn_variants harness: {bad} (launches, finiteness or cosine >= "
                         f"{HARNESS_COSINE_MIN} to attn_xla_f32's tower), or the check")
    return line["attn_flash"]["flash_attention_launches"]


def x3_loop_key(label: str, form: str) -> str:
    """The phase-4f probe loop of a phase-3f case (make_mm's at bn=512)."""
    form = "int8" if form == "s8" else form
    return f"make_matmul {form}" if label == "make_matmul" else f"make_mm {form} bn512"


def write_train_cache(path: str, nouns: list) -> None:
    """A prototype-structured cache of TRAIN_ROWS seeded rows (as
    exp/train_bench_ckpt.py builds the FT0 asset's): per-noun unit prototypes
    plus 0.15 Gaussian jitter, renormalised, one target noun per row."""
    from novic_tpu_torch.data.cache import EmbeddingCacheWriter
    from novic_tpu_torch.text.simple import make_test_tokenizer
    from novic_tpu_torch.text.target import TargetTokenizer, create_target_config

    tok = make_test_tokenizer(nouns)
    tc = create_target_config(tok, nouns, with_start_token=False, with_end_token=True,
                              compact_ids=True, fixed_token_length=True,
                              auto_fixed_token_length=True, use_masks=True)
    F = 768
    rng = np.random.default_rng(SEED)
    protos = rng.standard_normal(size=(len(nouns), F), dtype=np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    with EmbeddingCacheWriter(path, num_embed=TRAIN_ROWS, embed_dim=F,
                              target_tokenizer=TargetTokenizer(tok, tc), target_nouns=nouns,
                              num_embed_targets=1, shuffle=True, full_targets=False,
                              unit_weights=True, embedder_strict=False, default_weights=True,
                              seed=SEED) as writer:
        for start in range(0, TRAIN_ROWS, 32768):
            n = min(32768, TRAIN_ROWS - start)
            ids = rng.integers(1, len(nouns) + 1, size=(n, 1)).astype(np.int32)
            e = protos[ids[:, 0] - 1] + 0.15 * rng.standard_normal(size=(n, F), dtype=np.float32)
            e /= np.linalg.norm(e, axis=1, keepdims=True)
            writer.write(e, ids)


def step_batch(ckpt: dict, rows: int, seed: int):
    """(embed, target, mask, None) numpy batch of `rows` random nouns of the
    checkpoint's vocabulary, tokenized with its target config."""
    from novic_tpu_torch.text.simple import make_test_tokenizer
    from novic_tpu_torch.text.target import TargetTokenizer

    nouns = ckpt["target_nouns"][ckpt["num_invalid_target_nouns"]:]
    rng = np.random.default_rng(seed)
    picks = [nouns[i] for i in rng.integers(0, len(nouns), size=rows)]
    target, mask = TargetTokenizer(make_test_tokenizer(nouns), ckpt["target_config"]).tokenize_target(picks)
    embed = rng.standard_normal(size=(rows, ckpt["model_config"].embed_dim), dtype=np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    return embed, target.astype(np.int32), mask, None


def to_device(batch, device: str):
    return tuple(None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in batch)


def phase_train(workdir: str, nouns: list, ft0: dict, name: str, smi: str) -> dict:
    """Phase 7: action=train at the FT0 recipe and width, through the CLI on the card."""
    from novic_tpu_torch.cli.train import main as train_main
    from novic_tpu_torch.data.noise import EmbeddingNoise
    from novic_tpu_torch.infer import NOVICModel
    from novic_tpu_torch.ops import attention, dropout
    from novic_tpu_torch.text.simple import make_test_tokenizer
    from novic_tpu_torch.train.checkpoint import load_checkpoint
    from novic_tpu_torch.train.step import TrainRng, make_train_step

    vocab, cache = os.path.join(workdir, "vocab.json"), os.path.join(workdir, "cache.bin")
    t0 = time.perf_counter()
    with open(vocab, "w") as f:
        json.dump([{"target_noun": n} for n in nouns], f)
    write_train_cache(cache, list(nouns))
    cache_s = time.perf_counter() - t0
    recipe = ["hidden_dim=512", "num_layers=6", "num_heads=8", "mlp_seq_len=4",
              "feedfwd_scale=1/4", f"batch_size={TRAIN_BATCH}", f"accum_factor={TRAIN_ACCUM}",
              "input_dropout=0.1", "layer_dropout=0.1", "noise_scheme=GaussElemUniformAngle",
              "noise_vec_norm=0.5", "noise_angle_min=10", "noise_angle_max=30",
              "noise_mix_ratio=0.15", "init_lr=1.5e-3", "lr_warmup=4"]
    asset = {k: ft0["cfg_flat"].get(k) for k in ("hidden_dim", "num_layers", "batch_size",
                                                 "accum_factor", "input_dropout", "noise_scheme",
                                                 "init_lr", "lr_warmup")}
    args = (["action=train", f"embedding_dataset={cache}", "embedder=test:768",
             f"vocab_path={vocab}", "prompt_path=", f"seed={SEED}", f"output_dir={workdir}/outputs",
             "chunk_scale=0.38", "max_chunks=4", "save_every_max=1000000", "save_top1_min=200",
             "--device=cuda"] + recipe)
    torch.cuda.reset_peak_memory_stats()
    attention.LAUNCHES = dropout.LAUNCHES = 0
    t0 = time.perf_counter()
    state, S, ewa = train_main(args)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    drop_launches, att_launches = dropout.LAUNCHES, attention.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ckpts = sorted(glob.glob(os.path.join(workdir, "outputs", "ovod_*", "*.npz")))
    if not ckpts:
        raise SystemExit("training saved no checkpoint")
    with open(os.path.join(os.path.dirname(ckpts[-1]), "metrics.jsonl")) as f:
        chunks = [json.loads(line) for line in f]
    losses = [c["chunk_loss"] for c in chunks]
    microbatches = state.step * TRAIN_ACCUM
    line = {"phase": "train", "device": name, "nvidia_smi": smi, "asset_recipe": asset,
            "recipe": recipe, "rows": TRAIN_ROWS, "chunks": len(chunks), "steps": state.step,
            "microbatches": microbatches, "chunk_mean_loss": losses,
            "ewa_loss": [c["loss"] for c in chunks], "top1": [c["top1"] for c in chunks],
            "grad_norm_max": [c["grad_norm_max"] for c in chunks],
            "dropout_launches": drop_launches, "expected_dropout_launches":
            DROPOUT_SITES * 2 * microbatches, "attention_launches": att_launches,
            "cache_write_s": cache_s, "train_wall_s": train_s,
            "train_samples_per_s_incl_setup": TRAIN_ROWS / train_s, "peak_memory_gb": peak_gb,
            "checkpoint": os.path.basename(ckpts[-1])}
    emit(line)
    if state.step != TRAIN_ROWS // (TRAIN_BATCH * TRAIN_ACCUM) or len(chunks) != 4:
        raise SystemExit(f"training ran {state.step} steps over {len(chunks)} chunks")
    if not all(math.isfinite(v) for c in chunks for v in (c["chunk_loss"], c["loss"],
                                                           c["grad_norm_max"])):
        raise SystemExit("non-finite training loss or grad norm")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"loss did not drop: {losses}")
    if drop_launches != DROPOUT_SITES * 2 * microbatches:
        raise SystemExit(f"dropout kernel launched {drop_launches} times, expected "
                         f"{DROPOUT_SITES * 2 * microbatches} (25 sites x fwd+bwd per microbatch)")

    # The checkpoint serves on the card
    served = NOVICModel(ckpts[-1], embedder_spec=SPEC,
                        embedder_kwargs={"tokenizer": make_test_tokenizer(nouns), "seed": SEED},
                        gencfg="beam_k10_vnone_gn_t1_a0", batch_size=BATCH, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    frames = [rng.integers(0, 256, size=(224, 224, 3), dtype=np.uint8) for _ in range(BATCH)]
    with served:
        out = served.classify_images(frames)
    # After 8 steps the best beams may decode to "" (the end token first) on these
    # random-tower embeddings, as novic_tpu's checkpoint does after the same training
    check_output(out, BATCH, None)
    emit({"phase": "train_checkpoint_serves", "images": BATCH, "labels": [r[:3] for r in out.preds[:2]]})

    # Step timing at the recipe's shape (B=1024 x 8 microbatches), and a profile of one step
    ck = load_checkpoint(ckpts[-1])
    batch = to_device(step_batch(ck, TRAIN_BATCH * TRAIN_ACCUM, SEED + 2), "cuda")
    noise = EmbeddingNoise.create("GaussElemUniformAngle", vec_norm=0.5, angle_min=10.0,
                                  angle_max=30.0, mix_ratio=0.15)
    step = make_train_step(state, noise=noise, gradient_clip=1.0, accum_steps=TRAIN_ACCUM)
    rng_t = TrainRng.create(SEED, "cuda")
    step(batch, 1e-4, rng_t).fetch()  # warm
    step_ms = wall_ms(lambda: step(batch, 1e-4, rng_t), repeats=5)
    med = statistics.median(step_ms)
    emit({"phase": "train_timing", "device": name, "nvidia_smi": smi,
          "batch": TRAIN_BATCH, "accum": TRAIN_ACCUM, "target_len": int(batch[1].shape[1]),
          "ms_per_step": med, "repeats_ms": step_ms,
          "samples_per_s": TRAIN_BATCH * TRAIN_ACCUM / (med / 1e3), "peak_memory_gb": peak_gb})
    prof = device_profile(lambda: step(batch, 1e-4, rng_t))
    drop = prof.pop("matched_kernels")
    emit({"phase": "train_profile", "device": name, "steps": 1, **prof,
          # The profiler slows the host; against the unprofiled step time:
          "device_idle_share_unprofiled": 1.0 - prof["device_busy_ms"] / med,
          "dropout_kernel_ms_per_step": sum(d[1] for d in drop),
          "dropout_launches_per_step": sum(d[2] for d in drop)})
    return line


def phase_train_card_vs_cpu(workdir: str) -> None:
    """Phase 8: one step (64 rows, accum 1, dropout on, noise off) on the card
    (kernels) and on the CPU (plain versions), from the same checkpoint, its
    AdamW state and the same dropout seeds."""
    from novic_tpu_torch.bridge import adamw_state_from_leaves, decoder_from_numpy
    from novic_tpu_torch.train.checkpoint import load_checkpoint
    from novic_tpu_torch.train.optim import create_optimizer
    from novic_tpu_torch.train.step import TrainRng, TrainState, make_train_step

    path = sorted(glob.glob(os.path.join(workdir, "outputs", "ovod_*", "*.npz")))[-1]
    ck = load_checkpoint(path)
    batch = step_batch(ck, 64, SEED + 3)
    lr = float(ck["cfg_flat"]["init_lr"])
    out = {}
    for dev in ("cuda", "cpu"):
        model = decoder_from_numpy(ck["model_config"], ck["params"]).to(dev)
        opt = create_optimizer(model.named_parameters(), weight_decay=ck["cfg_flat"]["weight_decay"])
        adamw_state_from_leaves(model, opt, ck["opt_arrays"])
        step = make_train_step(TrainState(model=model, optimizer=opt), gradient_clip=1.0)
        m = step(to_device(batch, dev), lr, TrainRng.create(SEED, dev)).fetch()
        out[dev] = (m, {n: p.detach().cpu() for n, p in model.named_parameters()})
    (mg, pg), (mc, pc) = out["cuda"], out["cpu"]
    loss_g, loss_c = float(mg["loss_sum"] / mg["loss_basis"]), float(mc["loss_sum"] / mc["loss_basis"])
    norm_g, norm_c = float(mg["grad_norm"]), float(mc["grad_norm"])
    param_err = max((pg[n] - pc[n]).abs().max().item() for n in pg)
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    norm_rel = abs(norm_g - norm_c) / norm_c
    ok = loss_rel <= STEP_LOSS_RTOL and norm_rel <= STEP_NORM_RTOL and param_err <= STEP_PARAM_ATOL
    emit({"phase": "train_card_vs_cpu", "rows": 64, "loss_cuda": loss_g, "loss_cpu": loss_c,
          "loss_rel": loss_rel, "grad_norm_cuda": norm_g, "grad_norm_cpu": norm_c,
          "grad_norm_rel": norm_rel, "param_max_abs_diff": param_err,
          "tol": {"loss_rel": STEP_LOSS_RTOL, "grad_norm_rel": STEP_NORM_RTOL,
                  "param_abs": STEP_PARAM_ATOL}, "ok": ok})
    if not ok:
        raise SystemExit("card and CPU disagree on the training step")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from novic_tpu_torch.infer import NOVICModel
    from novic_tpu_torch.ops import (attention, attention_bf16, beam_reorder, build, dropout,
                                     flash_attention, int8_matmul, tiled_matmul)
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

    # 2. build every kernel of every path, one nvcc per source, started together
    t0 = time.perf_counter()
    sources = [attention.SOURCE, dropout.SOURCE, int8_matmul.SOURCE, beam_reorder.SOURCE,
               attention_bf16.SOURCE, tiled_matmul.SOURCE, flash_attention.SOURCE]
    libs = build.build_all(sources, force=True)
    # The Hopper designs (wgmma, TMA, mbarriers) are what was built
    hopper = (attention.SOURCE, attention_bf16.SOURCE, flash_attention.SOURCE,
              tiled_matmul.SOURCE, int8_matmul.SOURCE)
    sass = {build.library_path(s).name: sass_counts(build.library_path(s)) for s in hopper}
    s8_engine = (build.library_path(tiled_matmul.SOURCE).name,
                 build.library_path(int8_matmul.SOURCE).name)
    ptxas = {s.name: build.ptxas_path(s).read_text().splitlines() for s in sources}
    emit({"phase": "build", "kernels": [os.path.relpath(str(s), REPO) for s in sources],
          "libraries": [os.path.relpath(str(lib), REPO) for lib in libs],
          "seconds": time.perf_counter() - t0,
          "ptxas": {name: [line for line in lines if "Used " in line or "spill" in line
                           or "Potential Performance Loss" in line]
                    for name, lines in ptxas.items()},
          "sass": sass})
    for lib, counts in sass.items():
        if not counts["HGMMA"] + counts["IGMMA"] or not counts["UTMALDG"]:
            raise SystemExit(f"{lib}: no wgmma (HGMMA, IGMMA) or no TMA load (UTMALDG) in its "
                             f"SASS: {counts}")
        if (lib in s8_engine and not counts["IGMMA"]) or (lib == s8_engine[0]
                                                            and not counts["UTMASTG"]):
            raise SystemExit(f"{lib}: no s8 wgmma (IGMMA), or X3's int32 epilogue without its TMA "
                             f"store (UTMASTG), in its SASS: {counts}")
    # The Hopper designs that must not spill or serialise a wgmma
    for s in (attention.SOURCE, flash_attention.SOURCE, tiled_matmul.SOURCE, int8_matmul.SOURCE):
        bad = [line for line in ptxas[s.name] if "Potential Performance Loss" in line
               or ("spill" in line and " 0 bytes spill stores" not in line)]
        if bad:
            raise SystemExit(f"{s.name}: ptxas reports {bad[:3]}")

    # 3. kernels vs plain
    k1, k1_dfn5b = phase_kernel(attention)
    k3 = phase_dropout(dropout)
    k2, x4, k2_mma_sync = phase_int8(int8_matmul)
    x5, x5_many = phase_beam_reorder(beam_reorder)
    x12 = phase_attention_bf16(attention_bf16, k1_dfn5b)
    x3, x3_transpose = phase_tiled_matmul(tiled_matmul)
    x6 = phase_flash_attention(flash_attention, attention_bf16)

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
            attention.LAUNCHES = dropout.LAUNCHES = 0
            t0 = time.perf_counter()
            out = model.classify_images(frames, gencfg=gencfg)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = attention.LAUNCHES
            if dropout.LAUNCHES:
                raise SystemExit(f"{label}: serving launched the dropout kernel")
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

        # 4b. the int8 serving path, 4c. the text towers
        int8_line = phase_int8_serving(model, frames, nouns, guided_cfg, name, smi)
        phase_text(nouns, name, smi)

        # 4e. the DFN5B-H-14-378 embedder, 4f. the X1-X3 and X6 harness paths,
        # 4g. the attn_variants tower (X6)
        dfn5b_line = phase_dfn5b(nouns, name, smi)
        harness_launches = phase_harnesses(name, smi)
        x6_variants_launches = phase_attn_variants(name, smi)

        # 4d. reorder-mode beam (X5), greedy and vocab priors on the served embeddings
        guide = device_guide(model.decoder, nouns)
        decode_line = phase_decode_modes(model, model.embed_images(frames), nouns, ck, guide,
                                         name, smi)

        # 6. timings at B=64
        batch = frames[:BATCH]
        pixels = model.transform_images(batch)
        embeds = model.embed_images(batch)
        tower_ms = cuda_ms(lambda: model.embedder.embed_image_tensor(pixels), iters=5, warmup=1)
        embed_ms = wall_ms(lambda: model.embed_images(batch))
        launch_us = [host_launch_us()]
        decode_ms = wall_ms(lambda: model.classify_embeds(embeds))
        decode_guided_ms = wall_ms(lambda: model.classify_embeds(embeds, gencfg=guided_cfg))
        e2e_ms = wall_ms(lambda: model.classify_images(frames), repeats=3)
        # generate_beam alone (tokens to the host, no detokenization), lazy and
        # reorder in turns: lazy, reorder, reorder, lazy, ...
        e64 = torch.from_numpy(embeds).cuda()
        gen = {"lazy": [], "reorder": []}
        for mode in ["lazy", "reorder", "reorder", "lazy"] * 3:
            gen[mode] += wall_ms(lambda: [x.cpu() for x in beam_direct(model.decoder.model, e64,
                                                                      mode)], repeats=1)
        greedy_ms = wall_ms(lambda: model.classify_embeds(embeds, gencfg=DECODE_GENCFGS[0]))
        vocab_ms = wall_ms(lambda: model.classify_embeds(embeds, gencfg=DECODE_GENCFGS[2]))
        vocab_guided_ms = wall_ms(lambda: model.classify_embeds(embeds, gencfg=DECODE_GENCFGS[3]))
        launch_us.append(host_launch_us())
        emit({"phase": "timing", "device": name, "nvidia_smi": smi, "batch": BATCH,
              "host_launch_us_before_after_decode": launch_us,
              "tower_ms_per_batch": tower_ms,
              "preprocess_and_tower_ms_per_batch": statistics.median(embed_ms),
              "decode_ms_per_batch": statistics.median(decode_ms),
              "decode_guided_ms_per_batch": statistics.median(decode_guided_ms),
              "decode_lazy_generate_ms_per_batch": statistics.median(gen["lazy"]),
              "decode_reorder_ms_per_batch": statistics.median(gen["reorder"]),
              "decode_greedy_ms_per_batch": statistics.median(greedy_ms),
              "decode_vocab_prior_ms_per_batch": statistics.median(vocab_ms),
              "decode_vocab_prior_guided_ms_per_batch": statistics.median(vocab_guided_ms),
              "e2e_images_per_s": len(frames) / (statistics.median(e2e_ms) / 1e3),
              "gencfgs": {"decode_greedy": DECODE_GENCFGS[0], "decode_vocab_prior": DECODE_GENCFGS[2],
                          "decode_vocab_prior_guided": DECODE_GENCFGS[3]},
              "repeats_ms": {"embed": embed_ms, "decode": decode_ms,
                             "decode_guided": decode_guided_ms, "e2e": e2e_ms,
                             "generate_lazy": gen["lazy"], "generate_reorder": gen["reorder"],
                             "greedy": greedy_ms, "vocab_prior": vocab_ms,
                             "vocab_prior_guided": vocab_guided_ms}})

        # 6b. device busy share and the largest device ops over one served batch,
        # and over one lazy and one reorder-mode decode of it (X5's share)
        prof = device_profile(lambda: model.classify_images(batch))
        prof.pop("matched_kernels")
        emit({"phase": "profile", "device": name, "batch": BATCH, **prof})
        for mode in ("lazy", "reorder"):
            prof = device_profile(lambda: beam_direct(model.decoder.model, e64, mode),
                                  match=("beam_reorder_kernel",))
            matched = prof.pop("matched_kernels")
            x5_ms = sum(m[1] for m in matched)
            emit({"phase": "profile_decode", "mode": mode, "device": name, "batch": BATCH, **prof,
                  "x5_device_ms": x5_ms, "x5_kernels": sum(m[2] for m in matched),
                  "x5_share_of_device_busy": x5_ms / prof["device_busy_ms"]})

    # 7. training path, 8. card vs CPU for one step
    workdir = tempfile.mkdtemp(prefix="novic_chip_smoke_")
    try:
        train_line = phase_train(workdir, nouns, ck, name, smi)
        phase_train_card_vs_cpu(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # Kernels line, then the result
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "fused_attention", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/attention.cu",
        "replaces": "novic_tpu/ops/attention.py:71",
        "launches": launches, "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}, {
        "name": "dropout", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/dropout.cu",
        "replaces": "novic_tpu/ops/dropout.py:103",
        "launches": train_line["dropout_launches"], "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": k3["library_ms"]}, {
        "name": "int8_matmul", "route": "cuda", "instance": "wgmma",
        "source": "novic_tpu_torch/ops/csrc/int8_matmul.cu", "engine": S8_ENGINE,
        "replaces": "novic_tpu/ops/int8_matmul.py:73",
        "launches": int8_line["int8_matmul_instance_launches"]["wgmma"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": k2["library_ms"]}, {
        # The mma.sync instance, for shapes no tower has (phase 3c's ragged K)
        "name": "int8_matmul_mma_sync", "route": "cuda", "instance": "mma_sync",
        "source": "novic_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "novic_tpu/ops/int8_matmul.py:73",
        "launches": int8_line["int8_matmul_instance_launches"]["mma_sync"],
        "max_abs_err": k2_mma_sync["max_abs_err"], "ms": k2_mma_sync["ms"],
        "plain_ms": k2_mma_sync["plain_ms"], "bound_ms": k2_mma_sync["bound_ms"],
        "bound_by": k2_mma_sync["bound_by"], "library_ms": k2_mma_sync["library_ms"]}, {
        "name": "int8_matmul_dequant_bf16", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "exp/pallas_int8_mlp_chain.py:97",
        "launches": x4["path_launches"], "max_abs_err": x4["max_abs_err"], "ms": x4["ms"],
        "plain_ms": x4["plain_ms"], "bound_ms": x4["bound_ms"], "bound_by": x4["bound_by"],
        "library_ms": x4["library_ms"]}, {
        "name": "beam_reorder", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/beam_reorder.cu",
        "replaces": "exp/beam_reorder_kernel.py:53",
        "launches": x5["path_launches"], "max_abs_err": x5["max_abs_err"], "ms": x5["ms"],
        "plain_ms": x5["plain_ms"], "bound_ms": x5["bound_ms"], "bound_by": x5["bound_by"],
        "library_ms": x5["library_ms"]}, {
        "name": "beam_reorder_many", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/beam_reorder.cu",
        "replaces": "exp/beam_reorder_kernel.py:77",
        "launches": decode_line["unguided"]["x5_launches"] + decode_line["guided"]["x5_launches"],
        "max_abs_err": x5_many["max_abs_err"], "ms": x5_many["ms"],
        "plain_ms": x5_many["plain_ms"], "bound_ms": x5_many["bound_ms"],
        "bound_by": x5_many["bound_by"], "library_ms": x5_many["library_ms"]}, {
        "name": "fused_attention_dfn5b", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/attention.cu",
        "replaces": "novic_tpu/ops/attention.py:71",
        "launches": dfn5b_line["vision_launches"][0], "max_abs_err": k1_dfn5b["max_abs_err"],
        "ms": k1_dfn5b["ms"], "plain_ms": k1_dfn5b["plain_ms"], "bound_ms": k1_dfn5b["bound_ms"],
        "bound_by": k1_dfn5b["bound_by"], "library_ms": k1_dfn5b["library_ms"]}] + [{
        "name": f"attention_bf16_{case}", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/attention_bf16.cu", "replaces": line["replaces"],
        "launches": harness_launches[case], "max_abs_err": line["max_abs_err"],
        "ms": line["ms"], "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
        "bound_by": line["bound_by"], "library_ms": line["library_ms"]}
        for case, line in x12.items()] + [{
        "name": f"flash_attention_{case}", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/flash_attention.cu", "replaces": FLASH_REPLACES[case],
        "launches": harness_launches["flash"] if case == "dfn5b" else x6_variants_launches,
        "max_abs_err": line["max_abs_err"], "ms": line["ms"], "plain_ms": line["plain_ms"],
        "bound_ms": line["bound_ms"], "bound_by": line["bound_by"],
        "library_ms": line["library_ms"]} for case, line in x6.items()] + [{
        "name": f"tiled_matmul_{label}_{form}", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/tiled_matmul.cu",
        **({"engine": S8_ENGINE} if form == "s8" else {}),
        "replaces": ("exp/pallas_int8_matmul.py:46" if label == "make_matmul"
                     else "exp/pallas_int8_rate_pin.py:46"),
        "launches": harness_launches[x3_loop_key(label, form)], "max_abs_err": line["max_abs_err"],
        "ms": line["ms"],
        "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"], "bound_by": line["bound_by"],
        "library_ms": line["library_ms"]} for (label, form), line in x3.items()] + [{
        # The s8 path's K-major copy of w, which each s8 call above launches first
        "name": "transpose_s8", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/tiled_matmul.cu",
        "replaces": "exp/pallas_int8_matmul.py:46",
        "launches": harness_launches["transpose_s8"], "max_abs_err": x3_transpose["max_abs_err"],
        "ms": x3_transpose["ms"], "plain_ms": x3_transpose["plain_ms"],
        "bound_ms": x3_transpose["bound_ms"], "bound_by": x3_transpose["bound_by"],
        "library_ms": x3_transpose["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
