"""Smoke test of the PyTorch/CUDA port (novic_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits nonzero:
  1. device: the card's name and its nvidia-smi name and power limit;
  2. build: compile every kernel (attention.cu, dropout.cu, int8_matmul.cu,
     beam_reorder.cu, attention_bf16.cu, tiled_matmul.cu, flash_attention.cu,
     flash_attention_bwd.cu, layer_norm.cu) from the checkout's sources, one nvcc each,
     started together; count
     HGMMA / IGMMA (wgmma on bf16 / s8), UTMALDG / UTMASTG (TMA load /
     store) and SYNCS (mbarrier) instructions in the SASS of the Hopper
     designs (attention, attention_bf16, flash_attention,
     flash_attention_bwd, tiled_matmul, int8_matmul), and fail if one has no
     wgmma or no UTMALDG, if the s8 engine's libraries (tiled_matmul,
     int8_matmul) have no IGMMA or tiled_matmul's no UTMASTG, or if ptxas
     reports a spill or a wgmma serialisation ("Potential Performance Loss")
     in attention.cu, flash_attention.cu, flash_attention_bwd.cu,
     tiled_matmul.cu or int8_matmul.cu;
  3. kernel: the attention kernel (K1: a bf16 pre-pass and a TMA + wgmma
     kernel) against its plain PyTorch version on the card, at the serving
     shape, at the DFN5B-H-378 tower's (32,730,16,80), at two more, at the
     tower's shape in all_decode (16,196,12,64), and at edge shapes (S=1,
     S=65 with the causal bias, hd 8 and 128; stated tolerance), with its
     time and the pre-pass's share, the plain version's time, the time of one
     PyTorch library call for the same function, and the least time the card
     could take (bound);
  3b. dropout kernel: bit-identical to its plain version at the three FT0
     site shapes and a ragged size, rates 0.1 and 0.5; its backward mask is
     the forward's; the keep share is within 5 sigma of 1 - rate; times; two
     halves at their element offsets (a data-parallel rank's rows; offsets
     that are and are not multiples of 4, float32 and bf16) give the whole
     tensor's mask;
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
     SDPA with the segment mask and, at the DFN5B shape, attention_bf16's.
     Then its backward (X6b: the dQ kernel, which computes di, then the
     dK/dV kernel, both TMA + wgmma) and its
     causal and ab options at the harness shapes (256,12,256,64) and
     (32,16,768,80) with padding ids, (8,12,256,64) causal, the same with a
     float32 ab, (4,16,768,80) with causal, padding ids and a float32 ab,
     (4,12,200,328,80) with causal, padding ids and a bf16 ab, and edges of
     the kernels' instances (hd 128 causal with packed ids and a bf16 ab, hd
     112 with a masked row and a float32 ab, hd 96 packed, hd 8 with one
     query): the forward
     (o, l, m) against the plain forward, each backward kernel against the
     plain backward on the kernel's o, l and m (dq, dk, dv, dab), and the
     autograd path (flash_attention with inputs requiring grad: one forward
     with residuals and one launch of each backward kernel, the same
     gradients); ms (CUDA events; and device ms, from the profiler) of the
     forward without and with residuals and without the case's options,
     beside its bound, its plain version's and SDPA's with the same mask;
     of each backward kernel and of the whole backward (its host code, the
     maps' encoding and both launches: `_launch_bwd`) beside their bounds,
     the plain backward's ms and torch.autograd.grad through SDPA with the
     same mask;
  3h. LayerNorm kernel: against its plain form (the towers' f32_layer_norm
     before the kernel) at D 64, 77, 512, 768, 1024, 1280, 1792 and 2730,
     float32 and bf16 in and out, on one row, 50,176 rows, class-token rows
     read in place through their row stride and an unaligned base (float32
     outputs within 8 ulps of what the order of two sums can move; bf16
     outputs the kernel's own float32 rounded, and the plain form's but for
     flips of one bf16 ulp and that bar in at most 1e-3 of the values); times at (50176, 768)
     bf16 -> bf16 and (16448, 2730) float32 -> bf16 beside the bound, the
     plain form's and F.layer_norm's;
  4. serving path: NOVICModel serving SigLIP-B/16 (random weights from a seed)
     + the FT0 decoder with beam k=10, unguided and guided over all 42,919
     nouns, 2 batches of 64 seeded 224x224 frames; checks the outputs and that
     every kernel launched on this path (12 attention and 26 LayerNorm
     launches per tower forward);
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
  4h. the gradient path through attn_variants' tower with attn_flash, as
     jax.grad of the root file's tower takes it: forward and backward of a
     seeded cotangent at B=256, 12 layers, full width (12 X6, 12 dK/dV and
     12 dQ launches a step, every parameter gradient finite), ms per step,
     peak memory and X6b's share of a step's device time (profiler, by
     kernel name); card vs CPU at 2 layers, B=8: each parameter
     gradient's cosine (the key bias, whose exact gradient is 0, by norm);
  4d. decode modes on the 2 x 64 served embeddings: reorder-mode beam k=10
     (G = 7 X5 launches per batch), unguided and trie-guided, against lazy mode
     (top-1 identical, scores within 1e-4); greedy and vocab-prior gencfgs
     through NOVICModel; greedy and reorder card vs CPU on 2 images;
  5. card vs CPU: 2 images through the same port on device="cpu" (plain
     versions) and on the card (kernels): embedding cosine and top-1 labels;
  6. timings at B=64 (decode lazy and reorder, greedy, vocab priors), and
     profiles of one served batch and of one reorder-mode decode (device busy
     share, X5's device time);
  all_decode: exhaustive 'all' scoring through NOVICModel.classify_images at
     B=16 over the full 42,919-noun guide set (all_k10_vnone_gp_t1_a0): 12 K1
     launches (one tower forward) and no other kernel, predictions in the guide
     set, finite descending scores, top-1 equal to generate_all called directly;
     seconds per batch, images/s, scored positions, FLOP and the share of the
     float32 bound, generate_all's time at four chunk sizes (each with the
     default's targets, scores within 1e-4) and a device-only profile of one
     call (busy and idle share, GEMM share); the renorm, vocab-prior and alpha
     gencfg computed and stored by a first NOVICModel and loaded from the
     store by a second (same targets and scores); generate_all card vs CPU
     at the first 4,096 guide targets, with and without renorm (identical
     targets and paddings, scores within 1e-4);
  7. training path: `novic_tpu_torch.cli.train action=train` at the FT0
     asset's recipe and full width (hidden 512, 6 layers, batch 1024 x accum
     8, dropout 0.1/0.1, GaussElemUniformAngle noise) for one epoch (8
     optimizer steps) of a seeded 65,536-row cache; checks finite losses, the
     loss drop, 50 dropout launches per microbatch, and that the checkpoint
     serves 64 frames on the card; then ms per step, samples/s, peak memory
     and a profile of one step;
  8. card vs CPU for one training step (64 rows, dropout on, noise off):
     loss, pre-clip grad norm and the updated params;
  9. reference (released-weight interop): a seeded SigLIP-B/16 state dict in
     open_clip naming (timm trunk, HF text tower under text.) saved with its
     open_clip_config.json, whose directory must resolve to SPEC's arch, and
     converted by `action=convert_embedder load_model=<bin>`; the FT0 decoder
     in float32 written as a reference .model and as a .npz, both serving
     the 2 x 64 frames through NOVICModel with the converted weights (the
     .model taking its spec from cfg_flat): equal labels, logprobs within
     1e-6, the converted tower card vs CPU on 4 frames; one chunk resumed
     from a reference .train made of phase 7's checkpoint (params, AdamW
     moments, loop state) and from that .npz: losses and params within 1e-6,
     and save_torch_checkpoints' .model served; one AdamP chunk through the
     CLI, ms per step beside AdamW's, and one AdamP step card vs CPU (the
     projection choice per parameter, the other params); K1 and K3′
     launches under launches_by_phase["reference"];
  10. noun_data (training from text): a vocab JSON of the 42,919 FT0 nouns
     (singular = noun, plural = noun + "s"), ImageNet1KSel's templates and
     phase 9's SigLIP-B/16 weights, every step through the CLI on the card:
     cache_noun_dataset over all nouns (557,947 texts; texts/s; 12 K1
     launches per 256-text forward, 26,544 with the 32-row sanity check; 64
     rows re-embedded on the CPU); convert_noun_dataset, cache_noun_multiset
     and cache_captions over the first 4,096 nouns (the converted rows equal
     the noun cache's); train embedding_dataset=NounDataset at the FT0 recipe,
     2 chunks of 2 steps, cached and uncached (12 K1 per loader batch), with
     ms per step, the device idle share of a step with its loader, peak
     memory, K1 and K3' launches, the first batches cached vs uncached;
     cache_cls over 1,024 seeded PNGs in 10 classes named by FT0 nouns,
     cache_images over one class, merge_caches of the class cache and the
     converted one; whether an image row's embedding depends on its batch's
     size; one 256-text flush with the tower padded to 256 and to 512 rows
     (the config's batch_size_embed); test_data_loader over the converted
     cache; K1 and K3' launches
     under launches_by_phase["noun_data"];
  11. eval (the evaluation, inference and results actions), every step through
     the CLI on the card over phase 10's workdir, phase 9's SigLIP-B/16 and
     its FT0 .model: embedder_zero_shot measure_gap=true over the 1,024 PNGs
     (top-1, angles, images/s), the gap JSON read back by load_mean_shift (768
     finite values) and feeding a 2-step mean_shift=true training chunk; eval
     over the multiset cache with phase 10's checkpoint (guided, 4 x 128
     rows) on the card, on the CPU (loss within EVAL_LOSS_RTOL, flipped token
     argmaxes of the first batch within EVAL_FLIP_SHARE) and with
     eval_train=true (25 K3' launches a batch); eval_cls over the PNGs and
     eval_cls_decoding over 64 of them (greedy unguided and guided, guided
     beam k=10, 'all' over the 42,919 FT0 nouns), each gencfg's decode
     seconds beside estimate_generation_cost's and the constants they give,
     then a max_gencfg_cost between the beam and 'all' estimates that must
     skip 'all'; infer over one class folder and 3 texts with
     infer_ann_json_update; format_preds in its four modes, format_metrics
     and format_wandb over the run dirs; sample_images twice with the same
     seed (the same files); K1 held to 12 per tower forward in every step,
     under launches_by_phase["eval"] with K3';
  12. towers (the EVA02, CLIPA and ALIGN families and 'test-structured:'):
     K1 against its plain version at the L/14 vision towers' (64,257,16,64),
     EVA02-E's (32,257,16,112) and ALIGN's BERT (256,64,12,64) with a ragged
     (B, S) key bias, timed beside SDPA and the bound, and a fully masked
     64-key tile adding exactly 0; EVA02-L/14 (a seeded open_clip state dict
     converted through action=convert_embedder) and CLIPA-L/14 (seeded)
     serving the FT0 decoder, guided beam k=10, over phase 4's 2 x 64 frames
     (24 K1 launches a tower forward; card vs CPU on 2 frames, cosine and
     top-1; images/s, tower ms, texts/s at B=256); EVA02-E-14-plus at full
     width and depth (64 layers of 1792, MLP 15360; weights drawn on the card)
     at B=32 images and B=256 texts, peak memory, card vs CPU at full width
     with 4 layers; ALIGN's EfficientNet-B7 at 289 px (B=32) and BERT over
     256 ragged texts (12 key-bias K1 launches a forward), card vs CPU, and
     embedder_zero_shot over phase 10's 1,024 PNGs through the CLI; with
     'test-structured:768', cache_noun_multiset, embedder_zero_shot with its
     gap and one mean_shift=true training chunk through the CLI (K3');
  13. serving_tools: the demo server (tools/demo_server.py create_server on
     127.0.0.1, port 0) in front of NOVICModel (SigLIP-B/16 + FT0, the demo's
     default gencfg beam_k10_vnone_gn_t1_a0, model batch = max_batch as the
     demo's main sets it) answering 16 concurrent http.client clients, each
     posting 8 PNGs of phase 4's frames in turn, at max_batch 8 and 64:
     served images/s, mean and largest group, p50/p95 request ms, K1
     launches (12 a group); every answer's preds equal to a direct
     classify_images of its image; one undecodable upload answered 400
     while the others succeed. Then, on nccl at world size 1: NOVICModel
     .set_mesh (dp) and TorchEmbedder.set_mesh (tp over a size-1 'model'
     axis) serve the same preds as without a mesh (logprobs within 1e-5),
     and one data-parallel training step (phase 7's checkpoint and recipe,
     1024 x accum 8, dropout and noise on) equals the plain step (params
     within 1e-6; 400 K3' launches); "multi-card: not run (1 device)";
  14. orbax: phase 7's FT0 checkpoint (params and AdamW moments) saved as an
     .orbax directory by the port's own zarr v2, OCDBT and zstd code (no
     orbax, tensorstore or zstandard; the host codec built from
     train/csrc/zstd.cpp) and read back, every array bit-identical to the
     .npz; seconds and MB/s each way beside the .npz's, the directory's size;
     one chunk resumed through the CLI from the directory with
     checkpoint_format=orbax against the same chunk from the .npz (losses and
     params within 1e-6, K3' on; it writes an .orbax of its own); phase 4's
     2 x 64 frames served through NOVICModel from the directory (the spec
     from its novic_meta.json) and from the resumed chunk's, each against its
     .npz (equal labels, logprobs within 1e-6, 12 K1 launches a forward);
     tests/data/orbax_small.orbax, which real orbax wrote (zstd-compressed
     chunks, a per-process store), read bit for bit as its .npz twin; K1 and
     K3' launches under launches_by_phase["orbax"];
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
# Phase 3g, X6b against its plain backward on the same o, l and m: both take
# the same exact products of bf16 values in float32 and sum them in another
# order, and exp differs in its last bits, so a bf16 rounding of p or ds can
# land one ulp (2^-8 relative) apart. Where every one did, a gradient would
# move by 2^-8 of its norm, and no element by more than 2^-7 of the largest
# magnitude among its elements; the bf16 result may then round one ulp apart.
# The forward's l and m: the same sums of exps in another order (ex2.approx
# against torch.exp), within 1e-5 relative (m of max(|m|, 1))
BWD_REL_FRO = 2.0 ** -8
LM_RTOL = 1e-5
# Phase 4h: the harness tower's parameter gradients card vs CPU at 2 layers
# (the kernels' 64-key blocking against the single-step plain versions; the
# CPU tests hold the CPU path against jax.grad at 0.9999). The key bias's
# exact gradient is 0 (softmax is invariant to a constant added to a row's
# scores): both sides hold rounding residue, each within 2^-7 of the query
# bias's gradient norm
GRAD_COSINE_MIN = 0.9999
# Phase 3h: the LayerNorm kernel at every tower width and a ragged one, on one
# row, a SigLIP-B/16 batch's 256 x 196 token rows, the class-token rows read
# in place and an unaligned base. Its bfloat16 outputs are its own float32
# outputs rounded; against the plain form's, a value whose float32 sums
# differ in the last bits rounds one bf16 ulp apart where it sits by a
# rounding boundary: about one value in 2^16 per differing float32 ulp, so
# this share bounds the flips with room (at least one flip is allowed)
LN_WIDTHS = (64, 77, 512, 768, 1024, 1280, 1792, 2730)
LN_ROWS = 256 * 196
LN_EPS = 1e-6
LN_BF16_FLIP_SHARE = 1e-3
# Per SigLIP-B/16 forward: norm1 and norm2 in each of 12 blocks, the post-LN
# and the MAP head's LN
SIGLIP_LN_PER_FORWARD = 2 * 12 + 2
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
# Exhaustive decode (phase all_decode): B=16 at the full guide set, the chunk
# sizes (rows = targets x images per chunk) whose generate_all times are read,
# and card vs CPU at a trimmed guide set. Both sides run the same float32 math
# with TF32 off, summed in another order (GEMMs over K = 512, logsumexps over
# 8,002 logits, up to 7 positions a target): a score of magnitude ~10 moves by a
# few float32 ulps (1e-6) a position, far below 1e-4; targets and paddings
# (the ranking) must be identical. The same bar holds generate_all's scores at
# each chunk size against the default's: a chunk's row count is every GEMM's M,
# from which cuBLAS picks its tiles, so the sums run in another order there too
# (5.7e-6 read in each full run on an H100 80GB HBM3 at 700 W; card vs CPU 1.6e-5).
ALL_GENCFG, ALL_RENORM_GENCFG = "all_k10_vnone_gp_t1_a0", "all_k10_vtgt0.5_gr_t1_a0.5"
ALL_BATCH = 16
ALL_CHUNK_ROWS_TRIED = (1024, 4096, 16384, 32768)
ALL_CPU_TARGETS = 4096
ALL_SUM_ORDER_ATOL = 1e-4
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
FT0_RECIPE = ["hidden_dim=512", "num_layers=6", "num_heads=8", "mlp_seq_len=4",
              "feedfwd_scale=1/4", f"batch_size={TRAIN_BATCH}", f"accum_factor={TRAIN_ACCUM}",
              "input_dropout=0.1", "layer_dropout=0.1", "noise_scheme=GaussElemUniformAngle",
              "noise_vec_norm=0.5", "noise_angle_min=10", "noise_angle_max=30",
              "noise_mix_ratio=0.15", "init_lr=1.5e-3", "lr_warmup=4"]
# Phase 9 (reference): SigLIP-B/16's open_clip_config.json as the hub ships it
# (timm trunk by name; HF-style text tower), from which lookup derives SPEC's arch
SIGLIP_OPENCLIP_CONFIG = {
    "model_cfg": {"embed_dim": 768, "init_logit_bias": -10, "custom_text": True,
                  "vision_cfg": {"timm_model_name": "vit_base_patch16_siglip_224",
                                 "timm_model_pretrained": False, "timm_pool": "map",
                                 "timm_proj": "none", "image_size": 224},
                  "text_cfg": {"context_length": 64, "vocab_size": 32000,
                               "hf_tokenizer_name": "timm/ViT-B-16-SigLIP", "width": 768,
                               "heads": 12, "layers": 12, "no_causal_mask": True,
                               "proj_bias": True, "pool_type": "last",
                               "norm_kwargs": {"eps": 1e-6},
                               "act_kwargs": {"approximate": "tanh"}}},
    "preprocess_cfg": {"mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5],
                       "interpolation": "bicubic", "resize_mode": "squash", "size": 224}}
# The .model and float32 .npz checkpoints hold the same float32 values and run
# the same kernels: equal labels, logprobs within this; the resumed chunks
# (.train and .npz, the same moments, seeds and batches) within this too
REFERENCE_ATOL = 1e-6
# AdamP card vs CPU: a parameter's projection choice may differ only where its
# cosine lies this close to the threshold (float32 sums in another order).
# The other params after one step (phase 8's size, phase 7's moments): the
# first run read 2.4e-7 (H100 80GB HBM3, 700 W), so phase 8's AdamW bar, 1e-6,
# holds AdamP too
ADAMP_CHOICE_MARGIN = 1e-5
ADAMP_PARAM_ATOL = 1e-6
# Phase 10 (noun_data): training from text at SigLIP-B/16 width over the FT0
# asset's nouns. The vocabulary: singular = the noun, plural = the noun + "s",
# frequency 1 each, no hypernyms; ImageNet1KSel's 7 singular and 6 plural
# templates give 557,947 unique texts (USIDs) and 815,461 frequency-weighted
# samples (FSIDs); the first NOUN_CONVERT nouns 53,248 and 77,824
NOUN_COLLECTION = "ImageNet1KSel"
NOUN_USIDS, NOUN_FSIDS = 557_947, 815_461
NOUN_CONVERT = 4096
NOUN_CONVERT_USIDS, NOUN_CONVERT_FSIDS = 53_248, 77_824
NOUN_EMBED_BATCH = 256   # batch_size_embed; the noun cache flushes every 256 texts
NOUN_SANITY_ROWS = 32    # rows NounDataset.ensure_cache re-embeds one text at a time
NOUN_CPU_ROWS = 64       # noun-cache rows re-embedded on the CPU (plain path)
NOUN_CHECK_ROWS = 256    # converted-cache rows held against the noun cache
NOUN_TRAIN_CHUNKS, NOUN_TRAIN_STEPS = 2, 2   # 2 chunks of 2 optimizer steps (16 loader batches)
CLS_CLASSES, CLS_IMAGES, CLS_SIZE = 10, 1024, 224
CLS_IMAGE_BATCH = 256    # batch_size_image (config/train.yaml)
CAPTION_TEMPLATES = (["a photo of a {singular} on a table", "there is a {singular} in the park",
                      "an old {singular} next to a wall", "a close-up of a {singular}"],
                     ["two {plural} in a row", "many {plural} on the ground",
                      "a pile of {plural}"])
# Phase 11 (eval): the evaluation, inference and results actions over phase 10's
# workdir and phase 9's FT0 .model. eval reads EVAL_BATCHES batches of
# EVAL_BATCH rows of the multiset cache (3 targets a row, 28 character tokens a
# target); eval_cls_decoding decodes EVAL_SAMPLES_MAX images in one batch.
EVAL_BATCH, EVAL_BATCHES = 128, 4
EVAL_SAMPLES_MAX = 64
EVAL_GENCFGS = ["greedy_k1_vnone_gn_t1_a0", "greedy_k1_vnone_gp_t1_a0",
                "beam_k10_vnone_gp_t1_a0", "all_k10_vnone_gp_t1_a0"]
INFER_GENCFGS = ["greedy_k1_vnone_gn_t1_a0", "beam_k10_vnone_gp_t1_a0"]
INFER_TEXTS = ["a photo of a dog", "a close-up of a red apple", "a fire truck in the street"]
SAMPLE_COUNT = 16
# eval on the card vs on the CPU, the same batches: both sides compute float32
# logits (TF32 off) with GEMMs summed in another order, so logits differ by
# ~1e-6 relative. The loss, a mean of log-softmaxes, moves by as much: phase
# 8's loss bar (STEP_LOSS_RTOL) holds with room. A token's argmax flips only
# where its top two logits lie within that error; at 1e-6 of logits of order
# 10 that is a gap under ~1e-5, which a share of at most 1e-3 of the scored
# tokens of a trained decoder shows (in practice none).
EVAL_LOSS_RTOL = STEP_LOSS_RTOL
EVAL_FLIP_SHARE = 1e-3
# Phase 12 (towers): the EVA02, CLIPA and ALIGN families at full width. The
# two L/14 towers embed in 768 dims, so the FT0 decoder serves them; EVA02-E
# runs at full width and depth with its weights drawn on the card (20 GB in
# float32), and is held card vs CPU at full width with EVA_E_CPU_LAYERS layers
EVA_L_SPEC = "openclip:timm/eva02_large_patch14_clip_224.merged2b_s4b_b131k"
CLIPA_L_SPEC = "openclip:rwightman/ViT-L-14-CLIPA-datacomp1B"
EVA_E_SPEC = "openclip:timm/eva02_enormous_patch14_plus_clip_224.laion2b_s9b_b144k"
ALIGN_SPEC = "transformers:kakaobrain/align-base"
EVA_E_BATCH, ALIGN_BATCH, EVA_E_CPU_LAYERS = 32, 32, 4
# Card vs CPU for EVA02-L/14 at bf16 compute. Its class-token pool sees one
# token's noise: a last-bit difference between the card's sums and the CPU's
# becomes a bf16 ulp of an LN output now and then (four LNs a block), and 1 -
# cosine grows with depth. The first run of this phase read, on seeded
# towers: 4e-5 at 6 layers, 8e-5 at 12, 1.3e-4 at 24, and 1.5e-4 at 24 with
# the card's attention swapped for its plain version (so not K1); CLIPA-L/14,
# which averages 256 tokens, read 1e-6. So its bf16 bar is DFN5B's 24-layer
# text bar, 0.9998, and both L/14 towers are also held card vs CPU at
# float32 compute (the residual stream in float32) to COSINE_MIN
EVA_L_BF16_COSINE_MIN = DFN5B_TEXT_COSINE_MIN
# The structured test embedder's mean-shift chunk: 32 classes, 8 images each
STRUCTURED_SPEC = "test-structured:768:60:10:0"
STRUCTURED_CLASSES, STRUCTURED_IMAGES = 32, 8
STRUCTURED_MODEL = ["batch_size=256", "hidden_dim=256", "num_layers=2", "num_heads=4",
                    "mlp_seq_len=2", "input_dropout=0.1", "layer_dropout=0.1"]


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


def attention_bound_ms(B, S, H, hd, bias: bool, key_bias: bool = False) -> tuple[float, str]:
    """Least time for the function: bytes (q, k, v read, o written, f32; the
    (S, S) bias or the (B, S) key bias read) over HBM rate vs operations (two
    S x S x hd products) over the bf16 peak."""
    nbytes = 4 * B * S * H * hd * 4 + (S * S * 4 if bias else 0) + (B * S * 4 if key_bias else 0)
    flops = 2 * 2 * B * H * S * S * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# K1's two kernels by name in a profile: the bf16 pre-pass and the attention
# kernel (attention_bf16.cu's is attention_bf16_kernel, which neither matches)
K1_KERNELS = ("::to_bf16_kernel(", "::attention_kernel<")


def k1_check(attention, gen, B, S, H, hd, causal: bool = False, key_pads: bool = False,
             timed: bool = True, optional_profile: bool = False) -> dict:
    """One K1 shape on the card against its plain version (stated tolerance),
    with its times, SDPA's, its bound and the pre-pass's share where `timed`.
    `causal`: the (S, S) causal bias; `key_pads`: a (B, S) key bias of -1e30
    past each row's seeded length (key 0 always kept), BERT's pad mask. With
    `optional_profile`, a profiler that shows no K1 kernel leaves the share
    unmeasured (None) instead of failing the run."""
    import torch.nn.functional as F

    q, k, v = (torch.randn(B, S, H, hd, device="cuda", generator=gen) for _ in range(3))
    bias = key_bias = mask = None
    if causal:
        i = torch.arange(S, device="cuda")
        bias = mask = torch.where(i[None, :] <= i[:, None], 0.0, -1e30).float().contiguous()
    if key_pads:
        lengths = torch.randint(1, S + 1, (B,), device="cuda", generator=gen)
        key_bias = torch.where(torch.arange(S, device="cuda")[None, :] < lengths[:, None],
                               0.0, -1e30).float().contiguous()
        mask = key_bias[:, None, None, :]
    out = attention.fused_attention(q, k, v, bias, key_bias)
    torch.cuda.synchronize()
    ref = attention.attention_reference(q, k, v, bias, key_bias)
    diff = (out - ref).abs()
    err = diff.max().item()
    vmax = v.to(torch.bfloat16).float().abs().amax(dim=1, keepdim=True)  # over keys
    rel_fro = ((out - ref).norm() / ref.norm()).item()
    ok = bool((diff <= KERNEL_ATOL + 2.0 ** -7 * vmax).all()) and rel_fro <= KERNEL_REL_FRO
    line = {"phase": "kernel", "name": "fused_attention", "instance": "wgmma",
            "shape": [B, S, H, hd], "causal_bias": causal, "key_bias": key_pads,
            "max_abs_err": err, "rel_fro_err": rel_fro,
            "tol": f"|d| <= {KERNEL_ATOL} + 2^-7 max|v|, rel_fro <= {KERNEL_REL_FRO}", "ok": ok}
    if timed:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        run = lambda: attention.fused_attention(q, k, v, bias, key_bias)  # noqa: E731
        prof = device_profile(run, match=K1_KERNELS, require=K1_KERNELS[1:],
                              optional=optional_profile)
        bound_ms, bound_by = attention_bound_ms(B, S, H, hd, causal, key_pads)
        line.update(ms=cuda_ms(run), plain_ms=cuda_ms(
            lambda: attention.attention_reference(q, k, v, bias, key_bias)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      attn_mask=mask)),
            bound_ms=bound_ms, bound_by=bound_by,
            device_ms_by_kernel=prof and {name.strip(":(<"): sum(
                m[1] for m in prof["matched_kernels"] if name in m[0]) for name in K1_KERNELS})
    emit(line)
    if not ok:
        raise SystemExit(f"fused_attention disagrees with its plain version at {line['shape']}")
    return line


def phase_kernel(attention) -> tuple[dict, dict, dict]:
    """Phase 3: fused_attention (kernel) against attention_reference (plain) on
    the card, at the towers' shapes (timed, with the pre-pass's share of the
    device time) and at edge shapes. Returns the lines of the serving shape,
    the DFN5B shape and the noun cache's text-tower shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    result = dfn5b = text = None
    for B, S, H, hd, causal, timed in [
            (BATCH, 196, 12, 64, False, True), (32, 730, 16, 80, False, True),
            (8, 729, 16, 72, False, True), (8, 77, 8, 64, True, True),
            # the tower's shape in all_decode (a batch of ALL_BATCH frames)
            (ALL_BATCH, 196, 12, 64, False, True),
            # the noun_data phase's: the SigLIP text tower at the noun cache's
            # batch and at a training loader batch, the vision tower at cache_cls's
            (NOUN_EMBED_BATCH, 64, 12, 64, False, True), (TRAIN_BATCH, 64, 12, 64, False, True),
            (CLS_IMAGE_BATCH, 196, 12, 64, False, True),
            # edges: one key; a ragged tile with the causal bias; hd 8 (one
            # k-step, zero-filled past hd) and 128 (two atoms, three consumers)
            (2, 1, 3, 64, False, False), (2, 65, 3, 64, True, False),
            (2, 100, 3, 8, False, False), (2, 129, 3, 128, True, False)]:
        line = k1_check(attention, gen, B, S, H, hd, causal=causal, timed=timed)
        if result is None:
            result = line  # the serving shape
        if (B, S, H, hd) == (32, 730, 16, 80):
            dfn5b = line  # the DFN5B-H-378 vision tower's
        if (B, S, H, hd) == (NOUN_EMBED_BATCH, 64, 12, 64):
            text = line  # the SigLIP text tower's in the noun cache
    return result, dfn5b, text


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
    # Element offsets (a data-parallel rank's rows): the two halves of a tensor,
    # each at its offset, give the whole tensor's mask, float32 and bf16, at
    # offsets that are and are not multiples of 4 (the vector and scalar paths)
    for dtype in (torch.float32, torch.bfloat16):
        for n, cut in ((2 * 11 * 512 * 512, 11 * 512 * 512), (1_000_003, 499_999)):
            x = torch.randn(n, device="cuda", generator=gen).to(dtype)
            seed = dropout.draw_seed(seeds)
            whole = dropout.dropout_apply(x, seed, 0.1)
            parts = [dropout.dropout_apply(x[:cut].clone(), seed, 0.1, 0),
                     dropout.dropout_apply(x[cut:].clone(), seed, 0.1, cut)]
            ref = dropout.dropout_reference(x[cut:].clone(), seed, 0.1, cut)
            ok = torch.equal(torch.cat(parts), whole) and torch.equal(parts[1], ref)
            emit({"phase": "kernel_dropout_offset", "dtype": str(dtype), "n": n, "offset": cut,
                  "offset_mod_4": cut % 4, "ok": ok})
            if not ok:
                raise SystemExit(f"dropout at element offset {cut} ({dtype}) is not the whole "
                                 f"tensor's mask")
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
            prof = device_profile(run, match=X3_S8_KERNELS, require=X3_S8_KERNELS)
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


def causal_pairs(sq: int, skv: int, causal: bool) -> int:
    """The (query, key) pairs a run needs: under causal those with key <=
    query, else all of them."""
    return sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv


def flash_bound_ms(B, H, sq, skv, hd, seg: bool, causal: bool = False,
                   ab_bytes: int = 0) -> tuple[float, str]:
    """Least time: bf16 q, k, v read once, o written once (and the int32
    segment ids and the bias read once) over the HBM rate, vs the two
    products over the bf16 peak, over `causal_pairs`. Every query row is
    computed, padded ones included."""
    nbytes = 2 * B * H * hd * (2 * sq + 2 * skv) + (4 * B * (sq + skv) if seg else 0)
    nbytes += ab_bytes * B * H * sq * skv
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * B * H * causal_pairs(sq, skv, causal) * hd / BF16_FLOP_PER_S * 1e3
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
            ref = fa.flash_attention_reference(q, k, v, segment_ids=segs, sm_scale=scale,
                                               block_k=bk)[0].float()
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
            lambda: fa.flash_attention_reference(q, k, v, segment_ids=segs, sm_scale=scale),
            iters=3, warmup=1),
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


def flash_bwd_bound_ms(B, H, sq, skv, hd, seg: bool, causal: bool, ab_bytes: int,
                       kernel: str) -> tuple[float, str]:
    """Least time of one X6b kernel, or ("pair") of the whole backward: each
    input read once and each output written once over the HBM rate, vs its
    products over the bf16 peak. dQ: q, k, v, do, o (bf16), l, m (float32),
    ab and the segment ids read; dq (and dab) and the rows' stats (m, 1/l,
    di: 16 bytes a row) written; 3 products (S, dP, dQ). dK/dV: q, k, v, do,
    the stats, ab and the segment ids read; dk, dv written; 4 products (S,
    dP, dV, dK). The pair reads the function's inputs once and writes its
    four outputs (the stats pass between the kernels): 7 products. A product
    counts the (query, key) pairs of this run: under causal those with key
    <= query; every query row otherwise, padded ones included, as the
    kernels compute them."""
    pairs = causal_pairs(sq, skv, causal)
    bf, rows = 2 * B * H * hd, 4 * B * H * sq
    common = bf * (2 * sq + 2 * skv) + ab_bytes * B * H * sq * skv
    common += 4 * B * (sq + skv) if seg else 0
    read = {"dq": common + bf * sq + 2 * rows, "dkv": common + 4 * rows,
            "pair": common + bf * sq + 2 * rows}[kernel]
    written = {"dkv": bf * 2 * skv, "dq": bf * sq + 4 * rows + ab_bytes * B * H * sq * skv,
               "pair": bf * (sq + 2 * skv) + ab_bytes * B * H * sq * skv}[kernel]
    products = {"dkv": 4, "dq": 3, "pair": 7}[kernel]
    t_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
    t_ops = products * 2 * B * H * pairs * hd / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# X6b's cases (label, B, H, Sq, Skv, hd, segments, causal, ab dtype): the two
# harness shapes as phase 3g reads them, then the forward's causal and ab
# options, together, and Sq != Skv (whose last 10 queries, in a segment of
# keys past every key they visit, are rows with every visited key masked);
# then edges of the kernels' instances: hd 128 and 112 (dK/dV over 32-query
# halves), hd 96 (its products one after the other), hd 8 with one query,
# ragged Sq and Skv
FLASH_BWD_CASES = [("dfn5b", 32, 16, 768, 768, 80, 730, False, None),
                   ("attn_variants", 256, 12, 256, 256, 64, 196, False, None),
                   ("causal", 8, 12, 256, 256, 64, None, True, None),
                   ("ab_f32", 8, 12, 256, 256, 64, None, False, torch.float32),
                   ("causal_segments_ab", 4, 16, 768, 768, 80, 730, True, torch.float32),
                   ("sq_ne_skv", 4, 12, 200, 328, 80, "sq_ne_skv", True, torch.bfloat16),
                   ("hd128_causal_ab", 2, 4, 300, 200, 128, "packed", True, torch.bfloat16),
                   ("hd112_masked_row_ab", 2, 3, 130, 132, 112, "masked_row", False,
                    torch.float32),
                   ("hd96_packed", 2, 3, 200, 200, 96, "packed", False, None),
                   ("hd8_one_query", 2, 3, 1, 70, 8, None, False, None)]
# X6b's two kernels by name in a profile (csrc/flash_attention_bwd.cu)
FLASH_BWD_KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
FLASH_BWD_REPLACES = {"dkv": "jax/experimental/pallas/ops/tpu/flash_attention.py:796",
                      "dq": "jax/experimental/pallas/ops/tpu/flash_attention.py:1146"}


def _held(got: torch.Tensor, ref: torch.Tensor, atol: torch.Tensor | float,
          rel_bar: float) -> dict:
    """Elementwise |got - ref| <= atol and ||got - ref|| / ||ref|| <= rel_bar."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    rel = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    return {"max_abs_err": diff.max().item(), "rel_fro_err": rel, "rel_fro_bar": rel_bar,
            "ok": bool(torch.isfinite(got).all() and (diff <= atol).all() and rel <= rel_bar)}


def phase_flash_attention_bwd(fa) -> dict:
    """Phase 3g, backward: at each FLASH_BWD_CASES case the extended forward
    (causal, ab, the residuals l and m) against its plain version, the dQ
    and dK/dV kernels against `flash_attention_bwd_reference` on the kernel's
    o, l and m, and flash_attention's autograd path (one forward with
    residuals, one launch of each backward kernel, the same gradients); times
    of each kernel and of the whole backward (`_launch_bwd`: its host code,
    the maps' encoding, dQ with di, dK/dV) beside the bounds, the plain
    backward and torch.autograd.grad through scaled_dot_product_attention
    with the same mask. Returns the lines by case."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bf = torch.bfloat16
    lines = {}
    for label, B, H, sq, skv, hd, seg_kind, causal, ab_dtype in FLASH_BWD_CASES:
        def proj(n):  # (B, n, H, hd) bf16, zero past the real tokens, read as (B, H, n, hd)
            x = torch.randn(B, n, H, hd, device="cuda", generator=gen).to(bf)
            if isinstance(seg_kind, int):
                x[:, seg_kind:] = 0
            return x.transpose(1, 2)

        q, k, v, do = proj(sq), proj(skv), proj(skv), proj(sq)
        ab = None if ab_dtype is None else torch.randn(B, H, sq, skv, device="cuda",
                                                       generator=gen).to(ab_dtype)
        segs = _flash_segments(seg_kind, B, sq, skv)
        scale = 1.0 / math.sqrt(hd)
        line = {"phase": "kernel", "name": "flash_attention_bwd", "case": label,
                "shape": [B, H, sq, skv, hd], "causal": causal,
                "ab": None if ab is None else str(ab_dtype).replace("torch.", ""),
                "segments": seg_kind if seg_kind is None or isinstance(seg_kind, str)
                else f"1 over {seg_kind} tokens, 0 over the padding",
                "tol": f"each gradient: |d| <= 1 bf16 ulp + 2^-7 max|ref|, rel_fro <= "
                       f"{BWD_REL_FRO:.2e}; o: phase 3g's forward bars; l, m: {LM_RTOL} relative"}
        # The forward with its residuals, against the plain forward
        ab_bytes = 0 if ab is None else ab.element_size()
        o, l, m = fa._launch(q, k, v, ab, segs, causal, scale, residuals=True)
        o_r, l_r, m_r = fa.flash_attention_reference(q, k, v, ab, segs, causal, scale)
        vmax = v.float().abs().amax(dim=2, keepdim=True)
        fwd = _held(o, o_r, KERNEL_ATOL + 2.0 ** -7 * vmax + bf16_ulp(o_r), KERNEL_REL_FRO_BF16)
        fwd["l_rel_err"] = ((l - l_r).abs() / l_r.abs()).max().item()
        fwd["m_rel_err"] = ((m - m_r).abs() / m_r.abs().clamp_min(1.0)).max().item()
        fwd["ok"] = fwd["ok"] and fwd["l_rel_err"] <= LM_RTOL and fwd["m_rel_err"] <= LM_RTOL
        del o_r, l_r, m_r
        # The backward kernels against the plain backward on the kernel's o, l, m:
        # dQ first (it writes di, m and 1/l a row), then dK/dV
        a = fa._bwd_inputs(q, k, v, ab, segs, o, l, m, do, causal, scale)
        dq, dab = fa._launch_dq(a, ab is not None)
        dk, dv = fa._launch_dkv(a)
        refs = fa.flash_attention_bwd_reference(q, k, v, ab, segs, o, l, m, do, causal, scale)
        grads = {}
        for gname, got, ref in zip(("dq", "dk", "dv", "dab"), (dq, dk, dv, dab), refs):
            if ref is not None:
                grads[gname] = _held(got, ref, bf16_ulp(ref) + 2.0 ** -7 * ref.float().abs().max(),
                                     BWD_REL_FRO)
        del refs
        # The autograd path: one forward with residuals, one launch of each kernel
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        if ab is not None:
            leaves.append(ab.detach().requires_grad_())
        fa.LAUNCHES = fa.DKV_LAUNCHES = fa.DQ_LAUNCHES = 0
        out = fa.flash_attention(*leaves[:3], leaves[3] if ab is not None else None, segs,
                                 causal=causal, sm_scale=scale)
        auto = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        launches = {"forward": fa.LAUNCHES, "dkv": fa.DKV_LAUNCHES, "dq": fa.DQ_LAUNCHES}
        same = torch.equal(out, o) and all(torch.equal(x, y) for x, y in
                                           zip(auto, (dq, dk, dv, dab)))
        del out, auto
        ok = fwd["ok"] and all(g["ok"] for g in grads.values()) and same and \
            launches == {"forward": 1, "dkv": 1, "dq": 1}
        # Times: the forward without and with residuals, each backward kernel,
        # the plain backward, SDPA's backward with the same mask
        bounds = {kern: flash_bwd_bound_ms(B, H, sq, skv, hd, segs is not None, causal,
                                           ab_bytes, kern) for kern in ("dkv", "dq", "pair")}
        # (CUDA events over back-to-back launches; below ~0.1 ms those measure
        # the wrapper's host time, so the kernels' device time is read too)
        fwd_runs = {"": lambda: fa._launch(q, k, v, ab, segs, causal, scale),
                    "_with_residuals": lambda: fa._launch(q, k, v, ab, segs, causal, scale,
                                                          residuals=True),
                    "_without_options": lambda: fa._launch(q, k, v, None, segs, False, scale)}
        for key, run in fwd_runs.items():
            fwd["ms" + key], fwd["device_ms" + key] = cuda_ms(run), device_ms(run)
        fwd["bound_ms"], fwd["bound_by"] = flash_bound_ms(B, H, sq, skv, hd, segs is not None,
                                                          causal, ab_bytes)
        fwd["plain_ms"] = cuda_ms(lambda: fa.flash_attention_reference(
            q, k, v, ab, segs, causal, scale), iters=3, warmup=1)
        dkv_ms, dq_ms = cuda_ms(lambda: fa._launch_dkv(a)), cuda_ms(
            lambda: fa._launch_dq(a, ab is not None))
        dkv_dev, dq_dev = device_ms(lambda: fa._launch_dkv(a)), device_ms(
            lambda: fa._launch_dq(a, ab is not None))
        whole = lambda: fa._launch_bwd(q, k, v, ab, segs, o, l, m, do, causal,  # noqa: E731
                                       scale, ab is not None)
        whole_ms, whole_dev = cuda_ms(whole), device_ms(whole)
        plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(
            q, k, v, ab, segs, o, l, m, do, causal, scale), iters=3, warmup=1)
        keep = None
        if segs is not None:
            keep = segs[0][:, None, :, None] == segs[1][:, None, None, :]
        if causal:
            below = torch.arange(skv, device="cuda")[None, :] <= torch.arange(
                sq, device="cuda")[:, None]
            keep = below if keep is None else keep & below
        mask = keep
        if ab is not None:  # JAX's (q.k + ab) * scale: SDPA adds ab * scale
            mask = (ab.float() * scale).to(bf)
            if keep is not None:
                mask = mask.masked_fill(~keep, -torch.inf)
            mask = mask.requires_grad_()
        sd = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.no_grad():
            fwd["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale))
        sdpa_out = F.scaled_dot_product_attention(*sd, attn_mask=mask, scale=scale)
        sd_inputs = sd + ([mask] if ab is not None else [])
        library_ms = cuda_ms(lambda: torch.autograd.grad(sdpa_out, sd_inputs, do,
                                                         retain_graph=True), iters=5, warmup=1)
        line.update(forward=fwd, grads=grads, autograd_path_equal=same,
                    autograd_path_launches=launches,
                    max_abs_err=max(g["max_abs_err"] for g in grads.values()),
                    dkv={"ms": dkv_ms, "device_ms": dkv_dev, "bound_ms": bounds["dkv"][0],
                         "bound_by": bounds["dkv"][1]},
                    dq={"ms": dq_ms, "device_ms": dq_dev, "bound_ms": bounds["dq"][0],
                        "bound_by": bounds["dq"][1], "writes_dab": ab is not None},
                    backward_ms=dkv_ms + dq_ms,
                    whole_backward={"ms": whole_ms, "device_ms": whole_dev,
                                    "bound_ms": bounds["pair"][0],
                                    "bound_by": bounds["pair"][1],
                                    "what": "_launch_bwd: maps, dQ with di, dK/dV"},
                    pair_bound_ms=bounds["pair"][0], pair_bound_by=bounds["pair"][1],
                    plain_ms=plain_ms, library_ms=library_ms,
                    library_device_ms=device_ms(lambda: torch.autograd.grad(
                        sdpa_out, sd_inputs, do, retain_graph=True), iters=5, warmup=1),
                    library_call="torch.autograd.grad through scaled_dot_product_attention "
                                 "(attn_mask: the segment and causal mask, + ab * scale), "
                                 "forward outside the window", ok=ok)
        emit(line)
        del q, k, v, do, ab, o, l, m, a, dk, dv, dq, dab, sd, sdpa_out, mask, keep
        torch.cuda.empty_cache()
        if not ok:
            raise SystemExit(f"flash_attention backward disagrees with its plain version, or "
                             f"its autograd path with the kernels ({label})")
        lines[label] = line
    return lines


def layer_norm_bound_ms(rows: int, D: int, in_bytes: int, out_bytes: int) -> tuple[float, str]:
    """Least time: x read once, y written once and the float32 weight and bias
    read once, over the HBM rate (a few float32 operations an element)."""
    return (rows * D * (in_bytes + out_bytes) + 8 * D) / HBM_BYTES_PER_S * 1e3, "bytes"


def f32_ulp(x: torch.Tensor) -> torch.Tensor:
    """One float32 ulp at |x| (24 significant bits; normal numbers)."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126))) - 23)


def layer_norm_bar(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   y_plain: torch.Tensor) -> torch.Tensor:
    """Elementwise bar of |kernel - plain| in float32 outputs. Both round at
    the same points and differ in the order of their two sums alone: the mean
    moves by a few ulps of mean |x| (times r |w| in y), the variance by a few
    of its own (a relative move of y - b), and the last products and sums
    round once each. 8 ulps of each."""
    xd = x.double()
    mean = xd.mean(-1, keepdim=True)
    r = torch.rsqrt(((xd - mean) ** 2).mean(-1, keepdim=True) + LN_EPS)
    shift = f32_ulp(xd.abs().mean(-1, keepdim=True)).double() * r * w.double().abs()
    return 8 * (f32_ulp(y_plain) + f32_ulp(y_plain - b) + shift.float())


def layer_norm_compare(layer_norm, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       out_dtype: torch.dtype) -> dict:
    """One launch of the LayerNorm kernel against the plain form: float32
    outputs within layer_norm_bar of the plain form's; bfloat16 outputs the
    kernel's own float32 outputs rounded, and the plain form's but for flips,
    each within one bf16 ulp plus that bar (two float32 values within the bar
    round at most that far apart)."""
    launches = layer_norm.LAUNCHES
    y = layer_norm.layer_norm(x, w, b, LN_EPS, out_dtype)
    one_launch = layer_norm.LAUNCHES == launches + 1
    p32 = layer_norm.layer_norm_reference(x, w, b, LN_EPS, torch.float32)
    p = p32.to(out_dtype)
    bar = layer_norm_bar(x, w, b, p32)
    err = (y.float() - p.float()).abs()
    out = {"max_abs_err": err.max().item(), "one_launch": one_launch, "n": p.numel()}
    if out_dtype == torch.float32:
        out["bar_share"] = (err / bar).max().item()
        out["ok"] = one_launch and out["bar_share"] <= 1
    else:
        own = layer_norm.layer_norm(x, w, b, LN_EPS, torch.float32).to(out_dtype)
        flips = int((y != p).sum().item())
        step = bf16_ulp(torch.maximum(y.float().abs(), p.float().abs())) + bar
        out.update(own_rounding=torch.equal(y, own), flips=flips, flip_share=flips / p.numel(),
                   flip_bar_share=(err / step).max().item())
        out["ok"] = (one_launch and out["own_rounding"] and out["flip_bar_share"] <= 1
                     and flips <= max(1, LN_BF16_FLIP_SHARE * p.numel()))
    return out


def phase_layer_norm(layer_norm) -> dict:
    """Phase 3h: the LayerNorm kernel against its plain form (the towers'
    f32_layer_norm before the kernel) at every width of LN_WIDTHS, float32
    and bfloat16 in and out, on one row, LN_ROWS rows, the class-token rows
    of a (256, 5, D) tensor read in place (a row stride of 5 D) and 4,096 rows
    from a base one element past alignment (the element path); then its time
    at SigLIP-B/16's (50176, 768) bf16 -> bf16 and EVA02-L/14's mlp_norm
    (16448, 2730) float32 -> bf16, beside its bound, the plain form's and
    F.layer_norm's (the library yardstick; the port never calls it)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dtypes = (torch.float32, torch.bfloat16)
    worst = {"max_abs_err_f32": 0.0, "bar_share_f32": 0.0, "max_abs_err_bf16": 0.0,
             "flip_share_bf16": 0.0, "flip_bar_share_bf16": 0.0}
    for D in LN_WIDTHS:
        w = 1 + 0.1 * torch.randn(D, device="cuda", generator=gen)
        b = 0.1 * torch.randn(D, device="cuda", generator=gen)
        for dtype in dtypes:
            rows = (torch.randn(LN_ROWS, D, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
            tokens = (torch.randn(256, 5, D, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
            flat = (torch.randn(4096 * D + 1, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
            layouts = {"one_row": rows[:1], "rows": rows, "class_token": tokens[:, 0, :],
                       "unaligned": flat[1:].view(4096, D)}
            for out_dtype in dtypes:
                got = {k: layer_norm_compare(layer_norm, x, w, b, out_dtype)
                       for k, x in layouts.items()}
                line = {"phase": "kernel_layer_norm", "D": D, "dtype": str(dtype),
                        "out_dtype": str(out_dtype), "layouts": got,
                        "ok": all(g["ok"] for g in got.values())}
                emit(line)
                if not line["ok"]:
                    raise SystemExit(f"layer_norm disagrees with its plain form at D={D}, "
                                     f"{dtype} -> {out_dtype}")
                key = "f32" if out_dtype == torch.float32 else "bf16"
                for g in got.values():
                    worst[f"max_abs_err_{key}"] = max(worst[f"max_abs_err_{key}"],
                                                      g["max_abs_err"])
                    if key == "f32":
                        worst["bar_share_f32"] = max(worst["bar_share_f32"], g["bar_share"])
                    else:
                        worst["flip_share_bf16"] = max(worst["flip_share_bf16"],
                                                       g["flip_share"])
                        worst["flip_bar_share_bf16"] = max(worst["flip_bar_share_bf16"],
                                                           g["flip_bar_share"])
            del rows, tokens, flat, layouts
    emit({"phase": "kernel_layer_norm_worst", **worst})

    lines = {}
    for label, R, D, dtype, out_dtype in (
            ("siglip_b16", LN_ROWS, 768, torch.bfloat16, torch.bfloat16),
            ("eva02_l14_mlp_norm", 64 * 257, 2730, torch.float32, torch.bfloat16)):
        w = 1 + 0.1 * torch.randn(D, device="cuda", generator=gen)
        b = 0.1 * torch.randn(D, device="cuda", generator=gen)
        x = (torch.randn(R, D, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
        check = layer_norm_compare(layer_norm, x, w, b, out_dtype)
        ms = device_ms(lambda: layer_norm.layer_norm(x, w, b, LN_EPS, out_dtype))
        call_ms = cuda_ms(lambda: layer_norm.layer_norm(x, w, b, LN_EPS, out_dtype))
        plain_ms = device_ms(lambda: layer_norm.layer_norm_reference(x, w, b, LN_EPS, out_dtype),
                             iters=5)
        wl, bl = w.to(dtype), b.to(dtype)
        library_ms = device_ms(lambda: F.layer_norm(x, (D,), wl, bl, LN_EPS).to(out_dtype))
        bound_ms, bound_by = layer_norm_bound_ms(R, D, x.element_size(), out_dtype.itemsize)
        line = {"phase": "kernel", "name": "layer_norm", "case": label, "shape": [R, D],
                "dtype": str(dtype), "out_dtype": str(out_dtype),
                "max_abs_err": check["max_abs_err"], "flips": check.get("flips"),
                "ok": check["ok"], "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "roofline": bound_ms / ms}
        emit(line)
        if not check["ok"]:
            raise SystemExit(f"layer_norm disagrees with its plain form at {label}")
        lines[label] = line
    lines["worst"] = worst
    return lines


def cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def device_profile(fn, match: tuple = ("dropout_f32", "dropout_bf16"), host: bool = True,
                   require: tuple = (), optional: bool = False) -> dict | None:
    """Wall time, device busy time and the largest device ops of one call of fn;
    "matched_kernels" lists the device ops whose name holds one of `match`.
    Without `host`, only device activity is traced (a call of tens of thousands
    of launches then takes seconds, not minutes, to read back). A window that
    holds no device event, or no event for a name in `require` (kernels the
    call is known to launch), is repeated, as in device_ms; after 5 such
    windows the run fails rather than report a share of nothing, or, where
    the profile is `optional` (no check reads it), prints what the last
    window held and returns None."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    for _ in range(5):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        # Device-side events only (kernels, copies): host ops also carry the
        # device time of what they launched, which would count it twice
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0 and not e.key.startswith("Activity Buffer")]
        if events and all(any(r in e.key for e in events) for r in require):
            break
    else:
        if optional:
            emit({"phase": "device_profile_missing", "require": list(require),
                  "events": len(events), "last_window": [e.key[:90] for e in events[:20]]})
            return None
        raise SystemExit(f"device_profile: 5 windows without device events for {require or 'any op'}")
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
    prof = device_profile(lambda: emb.embed_image_tensor(pixels[0]), match=K2_KERNELS,
                          require=K2_KERNELS[:1] * bool(k2))
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


def all_decode_flops(cfg, n_pos: np.ndarray) -> tuple[int, int]:
    """(scored positions, FLOP) of one image's exhaustive scoring over targets of
    n_pos positions each (the end token included). Position 0 comes from the
    prefill; each of the other n - 1 runs every layer (the qkv, output and
    feed-forward products, attention over the P prefix and n - 1 token keys)
    and one logits product over the vocabulary."""
    E, FF, L, V, P = cfg.hidden_dim, cfg.feedfwd_dim, cfg.num_layers, cfg.vocab_size, cfg.mlp_seq_len
    T = n_pos.astype(np.int64) - 1
    dense = 2 * E * 3 * E + 2 * E * E + 2 * 2 * E * FF
    attn = 2 * 2 * (P + T) * E
    return int(T.sum()), int((T * (L * dense + 2 * E * V) + T * L * attn).sum())


def phase_all_decode(ck: dict, nouns: list, frames: list, name: str, smi: str) -> dict:
    """Phase all_decode: exhaustive scoring of 16 served frames over the full
    guide set through NOVICModel; the renorm, vocab-prior and alpha gencfg
    computed and stored, then loaded; generate_all card vs CPU."""
    from novic_tpu_torch import infer
    from novic_tpu_torch.bridge import decoder_from_numpy
    from novic_tpu_torch.models import generate
    from novic_tpu_torch.ops import (attention, attention_bf16, beam_reorder, dropout,
                                     flash_attention, int8_matmul, tiled_matmul)
    from novic_tpu_torch.text.simple import make_test_tokenizer

    batch = frames[:ALL_BATCH]
    nouns_set = set(nouns)
    common = dict(embedder_spec=SPEC, batch_size=ALL_BATCH, device="cuda",
                  embedder_kwargs={"tokenizer": make_test_tokenizer(nouns), "seed": SEED})
    others = (dropout, int8_matmul, beam_reorder, attention_bf16, tiled_matmul, flash_attention)
    line = {"phase": "all_decode", "device": name, "nvidia_smi": smi, "gencfg": ALL_GENCFG,
            "images": len(batch), "host_launch_us": host_launch_us()}
    phase_t0 = time.perf_counter()
    with infer.NOVICModel(FT0, gencfg=ALL_GENCFG, **common) as model:
        dec, task = model.decoder, model.task
        for mod in (attention,) + others:
            mod.LAUNCHES = 0
        t0 = time.perf_counter()
        out = model.classify_images(batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        k1 = attention.LAUNCHES
        other_launches = {m.__name__.rsplit(".", 1)[-1]: m.LAUNCHES for m in others}
        check_output(out, len(batch), nouns_set)
        pre = task.precompute
        n_pos = pre.guide_paddings.shape[1] - pre.guide_paddings.sum(axis=1)
        positions, flops = all_decode_flops(dec.cfg, n_pos)
        e2e_ms = wall_ms(lambda: model.classify_images(batch), repeats=1)
        embeds = model.embed_images(batch)
        decode_ms = wall_ms(lambda: model.classify_embeds(embeds), repeats=1)
        e = torch.from_numpy(embeds).cuda()
        # generate_all alone at each chunk size (targets per chunk = rows / 16);
        # the default's output is the direct call NOVICModel's top-1 must match
        chunks, outs = {}, {}
        for rows in ALL_CHUNK_ROWS_TRIED:
            torch.cuda.reset_peak_memory_stats()
            ms = wall_ms(lambda: outs.__setitem__(rows, generate.generate_all(
                dec.model, e, topk=10, precompute=pre, chunk=rows // ALL_BATCH)), repeats=1)
            chunks[rows] = {"ms": ms[0], "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        direct = outs[generate.ALL_CHUNK_ROWS]
        for rows, c in chunks.items():
            c["targets_identical"] = bool(torch.equal(outs[rows][0], direct[0]))
            c["max_score_diff"] = (outs[rows][2] - direct[2]).abs().max().item()
        top1_direct = dec.target_tokenizer.detokenize_target(direct[0][:, 0].cpu().numpy())
        top1 = [r[0] for r in out.preds]
        t0 = time.perf_counter()
        prof = device_profile(lambda: generate.generate_all(dec.model, e, topk=10, precompute=pre),
                              match=("gemm", "Gemm"), host=False)
        profile_s = time.perf_counter() - t0
        gemm_ms = sum(m[1] for m in prof.pop("matched_kernels"))
        decode_s = decode_ms[0] / 1e3
        line.update({
            "guide_targets": int(len(n_pos)), "targets_by_positions": {
                int(n): int(c) for n, c in zip(*np.unique(n_pos, return_counts=True))},
            "scored_positions_per_image": positions, "flop_per_image": flops,
            "fused_attention_launches": k1, "other_kernel_launches": other_launches,
            "first_call_s": first_s, "e2e_s_per_batch": e2e_ms[0] / 1e3,
            "images_per_s": len(batch) / (e2e_ms[0] / 1e3), "decode_s_per_batch": decode_s,
            "float32_bound_s_per_batch": flops * len(batch) / FP32_FLOP_PER_S,
            "float32_bound_share": flops * len(batch) / FP32_FLOP_PER_S / decode_s,
            "achieved_tflop_per_s": flops * len(batch) / decode_s / 1e12,
            "top1_identical_to_direct": top1 == top1_direct, "labels": [r[:3] for r in out.preds[:2]],
            "chunk_rows_default": generate.ALL_CHUNK_ROWS, "chunks": chunks,
            "chunk_score_atol": ALL_SUM_ORDER_ATOL,
            "profile": {**prof, "gemm_device_ms": gemm_ms, "seconds": profile_s,
                        "gemm_share_of_device_busy": gemm_ms / prof["device_busy_ms"]}})

        # Card vs CPU: the same 2 embeddings through generate_all at a trimmed guide set
        cpu_model = decoder_from_numpy(ck["model_config"], ck["params"])
        line["card_vs_cpu"] = {"targets": ALL_CPU_TARGETS, "atol": ALL_SUM_ORDER_ATOL}
        for label, renorm in (("plain", False), ("renorm", True)):
            kw = dict(topk=10, guide_targets=task.guide_targets[:ALL_CPU_TARGETS],
                      guide_renorm=renorm)
            gpu = [x.cpu() for x in generate.generate_all(dec.model, e[:2], **kw)]
            t0 = time.perf_counter()
            cpu = generate.generate_all(cpu_model, torch.from_numpy(embeds[:2]), **kw)
            line["card_vs_cpu"][label] = {
                "targets_identical": bool(torch.equal(gpu[0], cpu[0])),
                "paddings_identical": bool(torch.equal(gpu[1], cpu[1])),
                "max_score_diff": (gpu[2] - cpu[2]).abs().max().item(),
                "cpu_s": time.perf_counter() - t0}
        del cpu_model

    # The renorm, vocab-prior and alpha gencfg: a first model computes and stores
    # the precompute, a second loads it from the store (computing it is a fault)
    store_dir = tempfile.mkdtemp(prefix="novic_all_store_")
    runs = []
    try:
        for run in ("compute", "load"):
            with infer.NOVICModel(FT0, gencfg=ALL_RENORM_GENCFG, precompute_dir=store_dir,
                                  **common) as m:
                compute = infer.precompute_generate_all
                if run == "load":
                    def refuse(*args, **kwargs):
                        raise SystemExit("all_decode: the second task recomputed the precompute")
                    infer.precompute_generate_all = refuse
                try:
                    t0 = time.perf_counter()
                    m.task.ensure_precomputed()
                    pre_s = time.perf_counter() - t0
                finally:
                    infer.precompute_generate_all = compute
                ms = wall_ms(lambda: runs.append(m.classify_embeds(embeds)), repeats=1)
                line[f"renorm_{run}"] = {"precompute_s" if run == "compute" else "store_load_s": pre_s,
                                         "decode_s_per_batch": ms[0] / 1e3,
                                         "store_files": len(os.listdir(store_dir))}
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    line["renorm_gencfg"] = ALL_RENORM_GENCFG
    line["renorm_same_preds"] = runs[0].preds == runs[1].preds
    line["renorm_max_logprob_diff"] = float(np.abs(np.array(runs[0].logprobs)
                                                   - np.array(runs[1].logprobs)).max())
    line["renorm_labels"] = [r[:3] for r in runs[0].preds[:2]]
    line["phase_s"] = time.perf_counter() - phase_t0
    emit(line)
    torch.cuda.empty_cache()

    check_output(runs[0], len(batch), nouns_set)
    if k1 != 12 or any(other_launches.values()):
        raise SystemExit(f"all_decode: {k1} fused_attention launches (expected 12, one tower "
                         f"forward) and other kernels {other_launches} (expected none)")
    if not line["top1_identical_to_direct"]:
        raise SystemExit("all_decode: NOVICModel's top-1 differs from generate_all's")
    for rows, c in chunks.items():
        if not c["targets_identical"] or c["max_score_diff"] > ALL_SUM_ORDER_ATOL:
            raise SystemExit(f"all_decode: chunk rows {rows} changed the result: {c}")
    for label in ("plain", "renorm"):
        c = line["card_vs_cpu"][label]
        if not (c["targets_identical"] and c["paddings_identical"]
                and c["max_score_diff"] <= ALL_SUM_ORDER_ATOL):
            raise SystemExit(f"all_decode: card and CPU disagree ({label}): {c}")
    if not line["renorm_same_preds"] or line["renorm_max_logprob_diff"] > 1e-5 \
            or line["renorm_load"]["store_files"] != 1:
        raise SystemExit("all_decode: the stored precompute gave other results")
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
                              match=K1_KERNELS + K2_KERNELS,
                              require=K1_KERNELS[1:] * bool(k1) + K2_KERNELS[:1] * bool(k2))
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


def phase_attn_variants_grad(name: str, smi: str) -> dict:
    """Phase 4h: the gradient path through exp/attn_variants.py's ViT-B/16
    tower with attn_flash, as jax.grad of the root file's `tower` takes it:
    forward and backward of a seeded cotangent at full width and depth (B=256,
    S=196 padded to 256, 12 layers): 12 X6 forward, 12 dK/dV and 12 dQ
    launches a step, every parameter gradient finite; ms per step and peak
    memory; then card vs CPU (plain versions) at full width, 2 layers, B=8:
    the cosine of each parameter gradient (the key bias's by its norm)."""
    from novic_tpu_torch.exp import attn_variants as av
    from novic_tpu_torch.ops import flash_attention as fa

    def grads(x, cot, params):
        leaves = [t.requires_grad_() for layer in params for t in layer.values()]
        return torch.autograd.grad(av.tower(x, av.attn_flash, params), leaves, cot)

    gen = torch.Generator().manual_seed(SEED + 9)
    x0 = torch.randn((av.B, av.S, av.E), generator=gen)
    cot = torch.randn((av.B, av.S, av.E), generator=gen)
    params = av.make_params(av.L, seed=SEED, device="cuda")
    xg, cg = x0.cuda(), cot.cuda()
    line = {"phase": "attn_variants_grad", "device": name, "nvidia_smi": smi, "batch": av.B,
            "layers": av.L, "shape": [av.S, av.E, av.H, av.hd], "padded_to": av.SP}
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.DKV_LAUNCHES = fa.DQ_LAUNCHES = 0
    g = grads(xg, cg, params)
    torch.cuda.synchronize()
    launches = {"forward": fa.LAUNCHES, "dkv": fa.DKV_LAUNCHES, "dq": fa.DQ_LAUNCHES}
    finite = all(bool(torch.isfinite(t).all()) for t in g)
    del g
    ms = cuda_ms(lambda: grads(xg, cg, params), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # X6b's and X6's share of one step's device time, by kernel name
    prof = device_profile(lambda: grads(xg, cg, params), host=False,
                          match=FLASH_BWD_KERNELS + ("flash_attention_kernel",),
                          require=FLASH_BWD_KERNELS)
    matched = prof.pop("matched_kernels")
    x6b_ms = sum(mk[1] for mk in matched if any(name in mk[0] for name in FLASH_BWD_KERNELS))
    x6_ms = sum(mk[1] for mk in matched if "flash_attention_kernel" in mk[0])
    line.update(launches=launches, all_grads_finite=finite, ms_per_step=ms,
                images_per_s=av.B / (ms / 1e3), peak_memory_gb=peak,
                profile={"device_busy_ms": prof["device_busy_ms"],
                         "device_idle_share": prof["device_idle_share"],
                         "x6b_device_ms": x6b_ms,
                         "x6b_share_of_device_busy": x6b_ms / prof["device_busy_ms"],
                         "x6_device_ms": x6_ms,
                         "x6b_kernels": [mk for mk in matched
                                         if any(name in mk[0] for name in FLASH_BWD_KERNELS)],
                         "top_device_kernels_ms": prof["top_device_kernels_ms"][:6]})
    del params, xg, cg
    torch.cuda.empty_cache()

    # Card vs CPU at full width, 2 layers, B=8 (the same seeded values)
    n = 8
    keys = list(av.make_params(1, seed=SEED + 1, device="cpu")[0])
    card = grads(x0[:n].cuda(), cot[:n].cuda(), av.make_params(2, seed=SEED + 1, device="cuda"))
    cpu = grads(x0[:n], cot[:n], av.make_params(2, seed=SEED + 1, device="cpu"))
    cosine, bk = {}, {}
    for i, (a, b) in enumerate(zip(card, cpu)):
        layer, key = divmod(i, len(keys))
        a, b = a.double().cpu().ravel(), b.double().ravel()
        tag = f"{layer}.{keys[key]}"
        if keys[key] == "bk":  # exactly 0 in exact arithmetic: residue on both sides
            j = i - key + keys.index("bq")
            bq = [card[j].double().norm().item(), cpu[j].double().norm().item()]
            bk[tag] = {"norm_card": a.norm().item(), "norm_cpu": b.norm().item(),
                       "bar": [2.0 ** -7 * x for x in bq]}
            continue
        cosine[tag] = float(a @ b / (a.norm() * b.norm()))
    line.update(card_vs_cpu={"batch": n, "layers": 2, "cosine": cosine,
                             "cosine_min": min(cosine.values()), "bar": GRAD_COSINE_MIN,
                             "bk_norms": bk})
    emit(line)
    bk_ok = all(v["norm_card"] <= v["bar"][0] and v["norm_cpu"] <= v["bar"][1]
                for v in bk.values())
    if launches != {"forward": av.L, "dkv": av.L, "dq": av.L} or not finite \
            or min(cosine.values()) < GRAD_COSINE_MIN or not bk_ok:
        raise SystemExit(f"attn_variants gradient: launches {launches} (expected {av.L} each), "
                         f"finite {finite}, card vs CPU cosine {min(cosine.values())} "
                         f"(bar {GRAD_COSINE_MIN}), bk within its bar {bk_ok}")
    return line


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


def ft0_train_args(workdir: str, out: str, *extra: str) -> list[str]:
    """action=train at the FT0 recipe over phase 7's cache, into <workdir>/<out>;
    `extra` overrides (the later key wins)."""
    return (["action=train", f"embedding_dataset={workdir}/cache.bin", "embedder=test:768",
             f"vocab_path={workdir}/vocab.json", "prompt_path=", f"seed={SEED}",
             f"output_dir={workdir}/{out}", "chunk_scale=0.38", "max_chunks=4",
             "save_every_max=1000000", "save_top1_min=200", "--device=cuda"]
            + FT0_RECIPE + list(extra))


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
    asset = {k: ft0["cfg_flat"].get(k) for k in ("hidden_dim", "num_layers", "batch_size",
                                                 "accum_factor", "input_dropout", "noise_scheme",
                                                 "init_lr", "lr_warmup")}
    args = ft0_train_args(workdir, "outputs")
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
            "recipe": FT0_RECIPE, "rows": TRAIN_ROWS, "chunks": len(chunks), "steps": state.step,
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


def seeded_writers(seed: int):
    """(rand, linear, norm) writing seeded float32 tensors into a state dict:
    normal weights with std fan_in**-0.5, biases and embeddings std 0.02,
    norm scales near 1; one CPU generator, drawn in call order."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, std=0.02):
        return torch.randn(*shape, generator=gen) * std

    def linear(sd, name, out, inp):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = rand(out, inp, std=inp ** -0.5), rand(out)

    def norm(sd, name, width):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = 1.0 + rand(width), rand(width)

    return rand, linear, norm


def siglip_openclip_state_dict(arch, seed: int) -> dict:
    """A SigLIP backbone in open_clip naming, with the keys and shapes
    convert_openclip_state_dict(sd, "siglip", layers, layers) reads: the timm
    trunk under visual.trunk (packed qkv, MAP head with packed kv) and the
    HF-named text tower under text.text_model. Seeded float32 weights
    (seeded_writers)."""
    v, t = arch.vision, arch.text
    rand, linear, norm = seeded_writers(seed)

    E, M, P, tr = v.width, v.mlp_dim, v.patch_size, "visual.trunk"
    sd = {f"{tr}.patch_embed.proj.weight": rand(E, 3, P, P, std=(3 * P * P) ** -0.5),
          f"{tr}.patch_embed.proj.bias": rand(E), f"{tr}.pos_embed": rand(1, v.grid ** 2, E),
          f"{tr}.attn_pool.latent": rand(1, 1, E)}
    norm(sd, f"{tr}.norm", E)
    for name, out, inp in (("q", E, E), ("kv", 2 * E, E), ("proj", E, E), ("mlp.fc1", M, E),
                           ("mlp.fc2", E, M)):
        linear(sd, f"{tr}.attn_pool.{name}", out, inp)
    norm(sd, f"{tr}.attn_pool.norm", E)
    for i in range(v.layers):
        b = f"{tr}.blocks.{i}"
        norm(sd, f"{b}.norm1", E)
        norm(sd, f"{b}.norm2", E)
        for name, out, inp in (("attn.qkv", 3 * E, E), ("attn.proj", E, E), ("mlp.fc1", M, E),
                               ("mlp.fc2", E, M)):
            linear(sd, f"{b}.{name}", out, inp)
    T, TM, tm = t.width, t.mlp_dim, "text.text_model"
    sd[f"{tm}.embeddings.token_embedding.weight"] = rand(t.vocab_size, T)
    sd[f"{tm}.embeddings.position_embedding.weight"] = rand(t.context_length, T)
    norm(sd, f"{tm}.final_layer_norm", T)
    linear(sd, f"{tm}.head", t.embed_dim, T)
    for i in range(t.layers):
        b = f"{tm}.encoder.layers.{i}"
        norm(sd, f"{b}.layer_norm1", T)
        norm(sd, f"{b}.layer_norm2", T)
        for name, out, inp in (("self_attn.q_proj", T, T), ("self_attn.k_proj", T, T),
                               ("self_attn.v_proj", T, T), ("self_attn.out_proj", T, T),
                               ("mlp.fc1", TM, T), ("mlp.fc2", T, TM)):
            linear(sd, f"{b}.{name}", out, inp)
    return sd


def eva_openclip_state_dict(arch, seed: int) -> dict:
    """An EVA02 backbone of the SwiGLU/rope/sub-LN kind in open_clip naming,
    with the keys and shapes convert_openclip_state_dict(sd, "eva02", ...)
    reads: timm's Eva trunk under visual.trunk (separate q/k/v, k without a
    bias, the head under the trunk) and the stock CLIP text tower. Seeded
    float32 weights (seeded_writers)."""
    v, t = arch.vision, arch.text
    rand, linear, norm = seeded_writers(seed)
    E, M, P, tr = v.width, v.mlp_hidden, v.patch_size, "visual.trunk"
    sd = {f"{tr}.patch_embed.proj.weight": rand(E, 3, P, P, std=(3 * P * P) ** -0.5),
          f"{tr}.patch_embed.proj.bias": rand(E), f"{tr}.cls_token": rand(1, 1, E),
          f"{tr}.pos_embed": rand(1, v.grid ** 2 + 1, E)}
    norm(sd, f"{tr}.norm", E)
    linear(sd, f"{tr}.head", v.embed_dim, E)
    for i in range(v.layers):
        b = f"{tr}.blocks.{i}"
        for name, width in (("norm1", E), ("norm2", E), ("attn.norm", E), ("mlp.norm", M)):
            norm(sd, f"{b}.{name}", width)
        for name, out, inp in (("attn.q_proj", E, E), ("attn.v_proj", E, E), ("attn.proj", E, E),
                               ("mlp.fc1_g", M, E), ("mlp.fc1_x", M, E), ("mlp.fc2", E, M)):
            linear(sd, f"{b}.{name}", out, inp)
        sd[f"{b}.attn.k_proj.weight"] = rand(E, E, std=E ** -0.5)
    T, TM = t.width, t.mlp_dim
    sd["token_embedding.weight"] = rand(t.vocab_size, T)
    sd["positional_embedding"] = rand(t.context_length, T)
    sd["text_projection"] = rand(T, t.embed_dim, std=T ** -0.5)
    norm(sd, "ln_final", T)
    for i in range(t.layers):
        b = f"transformer.resblocks.{i}"
        norm(sd, f"{b}.ln_1", T)
        norm(sd, f"{b}.ln_2", T)
        sd[f"{b}.attn.in_proj_weight"] = rand(3 * T, T, std=T ** -0.5)
        sd[f"{b}.attn.in_proj_bias"] = rand(3 * T)
        for name, out, inp in (("attn.out_proj", T, T), ("mlp.c_fc", TM, T),
                               ("mlp.c_proj", T, TM)):
            linear(sd, f"{b}.{name}", out, inp)
    return sd


def adamp_choices(opt, params: dict, grads: dict) -> dict:
    """Per parameter of ndim > 1: (the view AdamP projects in, channel / layer /
    none, and the distance of each view's cosine from its threshold), from the
    pre-step params and the gradients the step used, on their own device."""
    from novic_tpu_torch.train.optim import AdamP

    g0 = opt.param_groups[0]
    out = {}
    for n, p in params.items():
        if p.dim() < 2:
            continue
        choice, margins = "none", []
        for view, rows in (("channel", p.shape[0]), ("layer", 1)):
            cos, _ = AdamP.view_cosine(p, grads[n], rows, float(np.float32(g0["eps"])))
            thr = AdamP.threshold(g0["delta"], p.numel() // rows)
            margins.append(abs(float(cos) - thr))
            if choice == "none" and float(cos) < thr:
                choice = view
        out[n] = (choice, min(margins))
    return out


def phase_reference(workdir: str, ck: dict, nouns: list, frames: list, name: str,
                    smi: str) -> dict:
    """Phase 9: released-weight interop at full width. A seeded SigLIP-B/16 in
    open_clip naming converted through action=convert_embedder; the FT0
    decoder (float32) served from a reference .model and from a .npz; training
    resumed from a reference .train and from phase 7's .npz; AdamP trained,
    timed and held card vs CPU."""
    from novic_tpu_torch.bridge import (adamw_moments, adamw_state_from_leaves,
                                        decoder_from_numpy)
    from novic_tpu_torch.cli.train import main as train_main
    from novic_tpu_torch.data.noise import EmbeddingNoise
    from novic_tpu_torch.embedders.registry import lookup
    from novic_tpu_torch.infer import NOVICModel
    from novic_tpu_torch.ops import attention, dropout
    from novic_tpu_torch.text.simple import make_test_tokenizer
    from novic_tpu_torch.train.checkpoint import (load_checkpoint, load_reference_checkpoint,
                                                  save_checkpoint, save_reference_checkpoint)
    from novic_tpu_torch.train.optim import AdamP, create_optimizer
    from novic_tpu_torch.train.step import TrainRng, TrainState, make_train_step
    from novic_tpu_torch.utils.misc import flatten_dict

    refdir = os.path.join(workdir, "reference")
    bindir = os.path.join(refdir, "ViT-B-16-SigLIP")
    os.makedirs(bindir)
    phase_t0 = time.perf_counter()
    attention.LAUNCHES = dropout.LAUNCHES = 0
    line = {"phase": "reference", "device": name, "nvidia_smi": smi}

    # 1. The backbone as an open_clip directory: the .bin and its config
    arch = lookup(SPEC)
    t0 = time.perf_counter()
    sd = siglip_openclip_state_dict(arch, SEED)
    binpath = os.path.join(bindir, "open_clip_pytorch_model.bin")
    torch.save(sd, binpath)
    with open(os.path.join(bindir, "open_clip_config.json"), "w") as f:
        json.dump(SIGLIP_OPENCLIP_CONFIG, f)
    line.update(backbone_params=sum(x.numel() for x in sd.values()),
                backbone_bytes=os.path.getsize(binpath),
                backbone_make_s=time.perf_counter() - t0)
    del sd
    local = f"openclip:{bindir}"
    if lookup(local) != arch:
        raise SystemExit(f"{local} resolves to another arch than {SPEC}")

    # 2. Conversion through the CLI
    weights = os.path.join(refdir, "siglip_b16.npz")
    t0 = time.perf_counter()
    train_main(["action=convert_embedder", f"embedder={local}", f"load_model={binpath}",
                f"embedder_weights={weights}", "--device=cuda"])
    line["convert_s"] = time.perf_counter() - t0

    # 3. The FT0 decoder in float32, as a reference .model and as a .npz; the
    # cfg_flat names the backbone it serves with
    params32 = {k: np.asarray(v, np.float32) for k, v in flatten_dict(ck["params"]).items()}
    kw = dict(params=params32, model_config=ck["model_config"], target_config=ck["target_config"],
              target_nouns=ck["target_nouns"], data_config=ck["data_config"],
              num_invalid_target_nouns=ck["num_invalid_target_nouns"],
              cfg_flat={**ck["cfg_flat"], "embedder": SPEC})
    model_path = os.path.join(refdir, "ovod_chunk0001_ft0.model")
    npz_path = os.path.join(refdir, "ovod_chunk0001_ft0.npz")
    save_reference_checkpoint(model_path, **kw)
    save_checkpoint(npz_path, **kw)

    # 4. Both serve the 2 x 64 frames; the .model takes its spec from cfg_flat
    ekw = {"tokenizer": make_test_tokenizer(nouns), "weights_path": weights}
    gencfg = "beam_k10_vnone_gn_t1_a0"
    forwards = math.ceil(len(frames) / BATCH)
    k1 = {}

    def k1_count(label: str, before: int, calls: int, per_call: int = forwards):
        k1[label] = attention.LAUNCHES - before
        if k1[label] != arch.vision.layers * per_call * calls:
            raise SystemExit(f"{label}: fused_attention launched {k1[label]} times, expected "
                             f"{arch.vision.layers * per_call * calls} (one a layer a forward)")

    by_model = NOVICModel(model_path, embedder_kwargs=ekw, gencfg=gencfg, batch_size=BATCH,
                          device="cuda")
    if by_model.embedder.spec != SPEC:
        raise SystemExit(f".model served with {by_model.embedder.spec}, not its cfg_flat's {SPEC}")
    with by_model:
        before = attention.LAUNCHES
        out_model = by_model.classify_images(frames)
        model_ms = wall_ms(lambda: by_model.classify_images(frames), repeats=3)
        k1_count("serve_model", before, 4)
        before = attention.LAUNCHES
        e_gpu = by_model.embed_images(frames[:4])
        k1_count("embed_4", before, 1, 1)
    with NOVICModel(npz_path, embedder_spec=SPEC, embedder_kwargs=ekw, gencfg=gencfg,
                    batch_size=BATCH, device="cuda") as by_npz:
        before = attention.LAUNCHES
        out_npz = by_npz.classify_images(frames)
        k1_count("serve_npz", before, 1)
    for out in (out_model, out_npz):
        check_output(out, len(frames), None)
    with NOVICModel(npz_path, embedder_spec=SPEC, embedder_kwargs=ekw, gencfg=gencfg,
                    batch_size=4, device="cpu") as cpu:
        e_cpu = cpu.embed_images(frames[:4])
    cos = cosines(e_gpu, e_cpu)
    lp_diff = float(np.abs(np.asarray(out_model.logprobs) - np.asarray(out_npz.logprobs)).max())
    line.update(images=len(frames), labels_equal=out_model.preds == out_npz.preds,
                logprob_max_abs_diff=lp_diff, labels=[r[:3] for r in out_model.preds[:2]],
                model_images_per_s=len(frames) / (statistics.median(model_ms) / 1e3),
                model_repeats_ms=model_ms, tower_cosine_card_vs_cpu=cos.tolist())
    if not line["labels_equal"] or lp_diff > REFERENCE_ATOL:
        raise SystemExit(f".model and .npz serve apart: labels equal {line['labels_equal']}, "
                         f"logprobs {lp_diff}")
    if cos.min() < COSINE_MIN:
        raise SystemExit(f"converted tower card vs CPU cosine {cos.min()} < {COSINE_MIN}")

    # 5. Resume one chunk from a reference .train (phase 7's last checkpoint: its
    # params, AdamW moments and loop state) and from that .npz itself
    base = sorted(glob.glob(os.path.join(workdir, "outputs", "ovod_*", "*.npz")))[-1]
    bck = load_checkpoint(base)
    cfg_flat = bck["cfg_flat"]
    holder = decoder_from_numpy(bck["model_config"], bck["params"])
    adamw = create_optimizer(holder.named_parameters(), weight_decay=cfg_flat["weight_decay"],
                             weight_decay_1d=cfg_flat["weight_decay_1d"])
    base_step = adamw_state_from_leaves(holder, adamw, bck["opt_arrays"])
    moments = adamw_moments(holder, adamw)
    loop_state = bck["train_meta"]["loop_state"]
    train_path = os.path.join(refdir, f"ovod_chunk{loop_state['chunk_id'] - 1:04d}_ref.train")
    save_reference_checkpoint(train_path, params=bck["params"], model_config=bck["model_config"],
                              target_config=bck["target_config"], target_nouns=bck["target_nouns"],
                              num_invalid_target_nouns=bck["num_invalid_target_nouns"],
                              cfg_flat=cfg_flat, data_config=bck["data_config"],
                              loop_state=loop_state, opt_moments=moments)
    if load_reference_checkpoint(train_path)["opt_moments"]["step"] != base_step:
        raise SystemExit("the .train does not hold phase 7's optimizer step")
    chunk = loop_state["chunk_id"]
    resumed = {}
    for label, src in (("train", train_path), ("npz", base)):
        drops = dropout.LAUNCHES
        t0 = time.perf_counter()
        state, S, _ = train_main(ft0_train_args(
            workdir, f"resume_{label}", f"load_model={src}", f"max_chunks={chunk}",
            "save_every_max=1", f"save_torch_checkpoints={str(label == 'train').lower()}"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        saved = sorted(glob.glob(os.path.join(workdir, f"resume_{label}", "ovod_*", "*.npz")))[-1]
        with open(os.path.join(os.path.dirname(saved), "metrics.jsonl")) as f:
            metrics = [json.loads(x) for x in f]
        resumed[label] = dict(step=state.step, chunk=S.chunk_id, seconds=seconds, path=saved,
                              losses=[(m["chunk_loss"], m["loss"]) for m in metrics],
                              params=flatten_dict(load_checkpoint(saved)["params"]),
                              dropout_launches=dropout.LAUNCHES - drops)
    rt, rn = resumed["train"], resumed["npz"]
    loss_diff = max(abs(a - b) for x, y in zip(rt["losses"], rn["losses"]) for a, b in zip(x, y))
    param_diff = max(float(np.abs(rt["params"][n] - rn["params"][n]).max()) for n in rn["params"])
    steps = rt["step"] - base_step
    line.update(resume_chunk=chunk, resume_steps=steps, resume_losses=rt["losses"],
                resume_loss_max_abs_diff=loss_diff, resume_param_max_abs_diff=param_diff,
                resume_s={k: r["seconds"] for k, r in resumed.items()},
                resume_dropout_launches=[rt["dropout_launches"], rn["dropout_launches"]])
    if (rt["step"], rt["chunk"]) != (rn["step"], rn["chunk"]) or rt["chunk"] != chunk + 1 \
            or steps < 1 or len(rt["losses"]) != 1 or len(rn["losses"]) != 1:
        raise SystemExit(f"the resumed runs differ in steps or chunks: {rt['step']}/{rt['chunk']} "
                         f"vs {rn['step']}/{rn['chunk']} (chunk {chunk}, base step {base_step})")
    if loss_diff > REFERENCE_ATOL or param_diff > REFERENCE_ATOL:
        raise SystemExit(f"resume from .train vs .npz: losses {loss_diff}, params {param_diff}")
    if rt["dropout_launches"] != DROPOUT_SITES * 2 * steps * TRAIN_ACCUM:
        raise SystemExit(f"resumed chunk launched dropout {rt['dropout_launches']} times")
    # save_torch_checkpoints wrote a .model beside the .npz; step 4's loader serves it
    torch_ckpt = rt["path"][:-4] + ".model"
    with NOVICModel(torch_ckpt, embedder_spec=SPEC, embedder_kwargs=ekw, gencfg=gencfg,
                    batch_size=BATCH, device="cuda") as served:
        before = attention.LAUNCHES
        check_output(served.classify_images(frames[:BATCH]), BATCH, None)
        k1_count("serve_saved_model", before, 1, 1)
    written = flatten_dict(load_reference_checkpoint(torch_ckpt)["params"])
    if any(not np.array_equal(written[n], rt["params"][n]) for n in rt["params"]):
        raise SystemExit("the saved .model holds other params than its .npz")

    # 6. AdamP: one FT0-recipe chunk from phase 7's params through the CLI
    drops = dropout.LAUNCHES
    t0 = time.perf_counter()
    pstate, pS, _ = train_main(ft0_train_args(
        workdir, "adamp", "optimizer=AdamP", f"load_model={base}", "load_train_state=false",
        "max_chunks=1", "save_every_max=1"))
    torch.cuda.synchronize()
    adamp_s = time.perf_counter() - t0
    adamp_drops = dropout.LAUNCHES - drops
    saved = sorted(glob.glob(os.path.join(workdir, "adamp", "ovod_*", "*.npz")))[-1]
    with open(os.path.join(os.path.dirname(saved), "metrics.jsonl")) as f:
        adamp_losses = [json.loads(x)["chunk_loss"] for x in f]
    if not isinstance(pstate.optimizer, AdamP) or not all(map(math.isfinite, adamp_losses)):
        raise SystemExit(f"AdamP chunk: {type(pstate.optimizer).__name__}, losses {adamp_losses}")
    if adamp_drops != DROPOUT_SITES * 2 * pstate.step * TRAIN_ACCUM:
        raise SystemExit(f"AdamP chunk launched dropout {adamp_drops} times")
    line.update(fused_attention_launches=attention.LAUNCHES, fused_attention_by_step=k1,
                dropout_launches=dropout.LAUNCHES,
                adamp_chunk_steps=pstate.step, adamp_chunk_losses=adamp_losses,
                adamp_chunk_s=adamp_s)

    # ms per step at the recipe's shape, AdamW and AdamP in turns on one batch;
    # and the optimizer's step alone
    batch = to_device(step_batch(bck, TRAIN_BATCH * TRAIN_ACCUM, SEED + 2), "cuda")
    noise = EmbeddingNoise.create("GaussElemUniformAngle", vec_norm=0.5, angle_min=10.0,
                                  angle_max=30.0, mix_ratio=0.15)
    runs = {}
    for opt_name in ("AdamW", "AdamP"):
        model = decoder_from_numpy(bck["model_config"], bck["params"]).to("cuda")
        opt = create_optimizer(model.named_parameters(), weight_decay=cfg_flat["weight_decay"],
                               weight_decay_1d=cfg_flat["weight_decay_1d"], optimizer=opt_name)
        st = TrainState(model=model, optimizer=opt)
        runs[opt_name] = (make_train_step(st, noise=noise, gradient_clip=1.0,
                                          accum_steps=TRAIN_ACCUM), opt)
    rng_t = TrainRng.create(SEED, "cuda")
    for step, _ in runs.values():
        step(batch, 1e-4, rng_t).fetch()  # warm
    step_ms = {"AdamW": [], "AdamP": []}
    opt_ms = {"AdamW": [], "AdamP": []}
    for opt_name in ("AdamW", "AdamP", "AdamP", "AdamW") * 2:
        step, opt = runs[opt_name]
        step_ms[opt_name] += wall_ms(lambda: step(batch, 1e-4, rng_t), repeats=1)
        opt_ms[opt_name] += wall_ms(opt.step, repeats=3)
    line.update(ms_per_step={k: statistics.median(v) for k, v in step_ms.items()},
                optimizer_step_ms={k: statistics.median(v) for k, v in opt_ms.items()},
                step_repeats_ms=step_ms, optimizer_repeats_ms=opt_ms)

    # AdamP card vs CPU for one step at phase 8's size (64 rows, accum 1,
    # dropout on, noise off), its moments those of phase 7's AdamW state
    batch = step_batch(bck, 64, SEED + 3)
    lr = float(cfg_flat["init_lr"])
    sides = {}
    for dev in ("cuda", "cpu"):
        model = decoder_from_numpy(bck["model_config"], bck["params"]).to(dev)
        opt = create_optimizer(model.named_parameters(), weight_decay=cfg_flat["weight_decay"],
                               weight_decay_1d=cfg_flat["weight_decay_1d"], optimizer="AdamP")
        for n, p in model.named_parameters():
            src = adamw.state[dict(holder.named_parameters())[n]]
            opt.state[p] = {"mu": src["exp_avg"].to(dev).clone(),
                            "nu": src["exp_avg_sq"].to(dev).clone()}
        opt.param_groups[0]["count"] = base_step
        pre = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = make_train_step(TrainState(model=model, optimizer=opt), gradient_clip=1.0)
        m = step(to_device(batch, dev), lr, TrainRng.create(SEED, dev)).fetch()
        grads = {n: p.grad for n, p in model.named_parameters()}
        sides[dev] = (m, {n: p.detach().cpu() for n, p in model.named_parameters()},
                      adamp_choices(opt, pre, grads))
    (mg, pg, cg), (mc, pc, cc) = sides["cuda"], sides["cpu"]
    flipped = sorted(n for n in cg if cg[n][0] != cc[n][0])
    unexplained = [n for n in flipped if min(cg[n][1], cc[n][1]) > ADAMP_CHOICE_MARGIN]
    held = [n for n in pg if n not in flipped]
    adamp_err = max((pg[n] - pc[n]).abs().max().item() for n in held)
    loss_g = float(mg["loss_sum"] / mg["loss_basis"])
    loss_c = float(mc["loss_sum"] / mc["loss_basis"])
    # Each projection branch on the card: one step of a (8, 64) parameter whose
    # gradient is orthogonal to its rows (channel), to it as a whole only
    # (layer), or aligned with it (none)
    branches = {}
    for kind in ("channel", "layer", "none"):
        gen = np.random.default_rng(SEED)
        p0 = gen.standard_normal((8, 64), dtype=np.float32)
        g0 = gen.standard_normal((8, 64), dtype=np.float32)
        if kind == "channel":
            rows = p0 / np.linalg.norm(p0, axis=1, keepdims=True)
            g0 = g0 - rows * (rows * g0).sum(axis=1, keepdims=True)
        elif kind == "layer":
            flat = p0.ravel() / np.linalg.norm(p0)
            g0 = g0 - (flat * (flat * g0.ravel()).sum()).reshape(p0.shape)
        else:
            g0 = 0.5 * p0 + 0.05 * g0
        got = {}
        for dev in ("cuda", "cpu"):
            w = torch.nn.Parameter(torch.tensor(p0, device=dev))
            w.grad = torch.tensor(g0.astype(np.float32), device=dev)
            opt = AdamP([w], lr=1e-2, weight_decay=0.1)
            choice = adamp_choices(opt, {"w": w.detach().clone()}, {"w": w.grad})["w"][0]
            opt.step()
            got[dev] = (choice, w.detach().cpu())
        branches[kind] = {"choice_cuda": got["cuda"][0], "choice_cpu": got["cpu"][0],
                          "max_abs_diff": (got["cuda"][1] - got["cpu"][1]).abs().max().item()}
    line.update(adamp_card_vs_cpu={
        "rows": 64, "choices": {k: sum(c == k for c, _ in cg.values())
                                for k in ("channel", "layer", "none")},
        "choice_differs": len(flipped), "choice_differs_params": flipped,
        "loss_rel": abs(loss_g - loss_c) / abs(loss_c), "param_max_abs_diff": adamp_err,
        "param_atol": ADAMP_PARAM_ATOL, "branches": branches})
    line["seconds"] = time.perf_counter() - phase_t0
    emit(line)
    if unexplained:
        raise SystemExit(f"AdamP's projection differs card vs CPU away from its threshold: "
                         f"{unexplained}")
    if adamp_err > ADAMP_PARAM_ATOL or line["adamp_card_vs_cpu"]["loss_rel"] > STEP_LOSS_RTOL:
        raise SystemExit("card and CPU disagree on the AdamP step")
    bad = {k: b for k, b in branches.items() if b["choice_cuda"] != k or b["choice_cpu"] != k
           or b["max_abs_diff"] > ADAMP_PARAM_ATOL}
    if bad:
        raise SystemExit(f"AdamP's projection branches disagree card vs CPU: {bad}")
    return line


def noun_vocab(nouns) -> list[dict]:
    """The FT0 nouns as a vocab JSON: singular = the noun, plural = noun + "s"."""
    return [{"id": i, "target_noun": n, "pretty_noun": n, "singulars": [n], "plurals": [n + "s"],
             "singulars_freq": [1], "plurals_freq": [1], "hypernyms": []}
            for i, n in enumerate(nouns)]


def write_class_folders(root: str, classes: list, rng) -> list[str]:
    """CLS_IMAGES seeded 224 px PNGs in an Imagenette layout, one folder per
    class (named by the noun, spaces as underscores), dealt round-robin; each
    image is 14x14 seeded colours upscaled 16x, so PNG encoding stays quick."""
    folders = []
    for c in classes:
        folders.append(os.path.join(root, "Imagenette", "imagenette2-320", "val",
                                    c.replace(" ", "_")))
        os.makedirs(folders[-1])
    from PIL import Image

    for i in range(CLS_IMAGES):
        small = rng.integers(0, 256, size=(14, 14, 3), dtype=np.uint8)
        img = np.repeat(np.repeat(small, CLS_SIZE // 14, axis=0), CLS_SIZE // 14, axis=1)
        Image.fromarray(img).save(os.path.join(folders[i % len(classes)], f"{i:04d}.png"))
    return folders


def phase_noun_data(workdir: str, weights: str, nouns: list, name: str, smi: str) -> dict:
    """Phase 10: the noun dataset, the cache writers and training from text,
    every step through `novic_tpu_torch.cli.train` on the card, with phase 9's
    seeded SigLIP-B/16 weights (bf16, 12 layers at 768) and the CLI's tokenizer
    (no SentencePiece file: the character-level test tokenizer, as in novic_tpu)."""
    from novic_tpu_torch.bridge import decoder_from_numpy
    from novic_tpu_torch.cli.common import gen_data_config, load_embedder, load_embedding_dataset
    from novic_tpu_torch.cli.train import main as train_main
    from novic_tpu_torch.data import noun_dataset
    from novic_tpu_torch.data.cache import EmbeddingCache
    from novic_tpu_torch.data.noise import EmbeddingNoise
    from novic_tpu_torch.embedders.base import Embedder
    from novic_tpu_torch.embedders.preprocess import load_images
    from novic_tpu_torch.ops import attention, dropout
    from novic_tpu_torch.train.checkpoint import load_checkpoint
    from novic_tpu_torch.train.loop import _accum_concat, _tensor
    from novic_tpu_torch.train.optim import create_optimizer
    from novic_tpu_torch.train.step import TrainRng, TrainState, make_train_step
    from novic_tpu_torch.utils.config import load_config

    wd = os.path.join(workdir, "noun_data")
    os.makedirs(wd)
    phase_t0 = time.perf_counter()
    vocab_all, vocab_cut = os.path.join(wd, "vocab.json"), os.path.join(wd, "vocab_4096.json")
    for path, n in ((vocab_all, len(nouns)), (vocab_cut, NOUN_CONVERT)):
        with open(path, "w") as f:
            json.dump(noun_vocab(nouns[:n]), f)
    noun_dir, cache_dir = os.path.join(wd, "noun"), os.path.join(wd, "cache")
    common = [f"embedder={SPEC}", f"embedder_weights={weights}", "embedder_compute_dtype=bfloat16",
              f"prompt_collection={NOUN_COLLECTION}", "hypernym_collection=None",
              f"batch_size_embed={NOUN_EMBED_BATCH}", f"batch_size_image={CLS_IMAGE_BATCH}",
              f"noun_cache_dir={noun_dir}", f"embedding_cache_dir={cache_dir}",
              f"output_dir={wd}/out", f"seed={SEED}"]
    line = {"phase": "noun_data", "device": name, "nvidia_smi": smi, "nouns": len(nouns),
            "prompt_collection": NOUN_COLLECTION, "batch_size_embed": NOUN_EMBED_BATCH}
    k1, k3 = {}, {}

    def run(label: str, *args: str):
        """One CLI action on the card: its seconds; K1 and K3' launches by label."""
        attention.LAUNCHES = dropout.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_main(list(args) + ["--device=cuda"])
        torch.cuda.synchronize()
        k1[label], k3[label] = attention.LAUNCHES, dropout.LAUNCHES
        return out, time.perf_counter() - t0

    def expect_k1(label: str, forwards: int):
        if k1[label] != 12 * forwards:
            raise SystemExit(f"noun_data {label}: fused_attention launched {k1[label]} times, "
                             f"expected {12 * forwards} (12 per text-tower forward)")

    # 1. cache_noun_dataset over all nouns; generation and the sanity check timed apart
    spans = {}

    def timed(key, fn):
        def wrapper(self, *a, **kw):
            torch.cuda.synchronize()
            t0, n0 = time.perf_counter(), attention.LAUNCHES
            out = fn(self, *a, **kw)
            torch.cuda.synchronize()
            spans[key] = (time.perf_counter() - t0, attention.LAUNCHES - n0)
            return out
        return wrapper

    originals = (noun_dataset.NounDataset._generate_cache,
                 noun_dataset.NounDataset._sanity_check_cache)
    noun_dataset.NounDataset._generate_cache = timed("generate", originals[0])
    noun_dataset.NounDataset._sanity_check_cache = timed("sanity", originals[1])
    try:
        _, secs = run("cache_noun_dataset", "action=cache_noun_dataset", f"vocab_path={vocab_all}",
                      *common)
    finally:
        (noun_dataset.NounDataset._generate_cache,
         noun_dataset.NounDataset._sanity_check_cache) = originals
    (noun_path,) = glob.glob(os.path.join(noun_dir, "noun_cache_*.bin"))
    size = os.path.getsize(noun_path)
    row = size // NOUN_USIDS
    gen_batches = math.ceil(NOUN_USIDS / NOUN_EMBED_BATCH)
    line["cache_noun_dataset"] = {
        "usids": NOUN_USIDS, "bytes": size, "row_bytes": row, "seconds": secs,
        "generate_s": spans["generate"][0], "sanity_check_s": spans["sanity"][0],
        "texts_per_s": NOUN_USIDS / spans["generate"][0],
        "k1_launches": k1["cache_noun_dataset"],
        "k1_expected": 12 * (gen_batches + NOUN_SANITY_ROWS),
        "k1_generate_sanity": [spans["generate"][1], spans["sanity"][1]]}
    emit({"phase": "noun_cache", **line["cache_noun_dataset"]})
    if size != NOUN_USIDS * row or (row - 768 * 4) % 5:
        raise SystemExit(f"noun cache of {size} bytes does not hold {NOUN_USIDS} rows")
    expect_k1("cache_noun_dataset", gen_batches + NOUN_SANITY_ROWS)
    C = (row - 768 * 4) // 5
    rows = np.memmap(noun_path, dtype=np.uint8, mode="r").reshape(NOUN_USIDS, row)

    def noun_embeds(usids) -> np.ndarray:
        return np.ascontiguousarray(rows[np.asarray(usids), :768 * 4]).view(np.float32)

    # ... NOUN_CPU_ROWS of its rows re-embedded on the CPU by the plain path
    cpu = Embedder.create(SPEC, weights_path=weights, compute_dtype="bfloat16", device="cpu",
                          inference_batch_size=NOUN_CPU_ROWS, load_model=True)
    ds = noun_dataset.NounDataset(cpu, vocab_path=vocab_all, prompt_collection=NOUN_COLLECTION,
                                  prompt_path=os.path.join(REPO, "data", "prompts.json"),
                                  hypernym_collection="None")
    if (ds.num_usids, ds.num_fsids) != (NOUN_USIDS, NOUN_FSIDS):
        raise SystemExit(f"noun dataset counts {ds.num_usids}, {ds.num_fsids}")
    pick = np.sort(np.random.default_rng(SEED).choice(NOUN_USIDS, NOUN_CPU_ROWS, replace=False))
    texts = [ds.get_sample_text(usid=int(u))[0] for u in pick]
    t0 = time.perf_counter()
    e_cpu = cpu.inference_text(texts)
    cos = cosines(e_cpu, noun_embeds(pick))
    line["noun_cache_card_vs_cpu"] = {"rows": NOUN_CPU_ROWS, "cosine_min": float(cos.min()),
                                      "bar": COSINE_MIN, "cpu_s": time.perf_counter() - t0}
    del cpu
    emit({"phase": "noun_cache_card_vs_cpu", **line["noun_cache_card_vs_cpu"]})
    if cos.min() < COSINE_MIN:
        raise SystemExit("noun cache: card and CPU disagree")

    # 2. convert_noun_dataset, cache_noun_multiset and cache_captions over the first nouns
    rng = np.random.default_rng(SEED + 10)
    captions = [{"target_noun": n,
                 "singular_captions": list(rng.choice(CAPTION_TEMPLATES[0], 3, replace=False)),
                 "plural_captions": list(rng.choice(CAPTION_TEMPLATES[1], 2, replace=False))}
                for n in nouns[:NOUN_CONVERT]]
    cap_path = os.path.join(wd, "captions.json")
    with open(cap_path, "w") as f:
        json.dump(captions, f)
    cut = [f"vocab_path={vocab_cut}", *common]
    writers = {}
    for label, extra, texts_per_forward in (
            ("convert_noun_dataset", [], [NOUN_CONVERT_USIDS]),
            ("cache_noun_multiset", ["multi_target_freq=[1,2]"],
             [NOUN_CONVERT_FSIDS, 2 * NOUN_CONVERT_FSIDS]),
            ("cache_captions", [f"captions_path={cap_path}", "template_multiplier=2",
                                "sample_multiplier=2"], None)):
        _, secs = run(label, f"action={label}", f"save_embedding_cache={label}.bin", *extra, *cut)
        cache = EmbeddingCache(os.path.join(cache_dir, f"{label}.bin"), strict_embedder=False)
        n = cache.header.embed_num
        forwards = sum(math.ceil(t / NOUN_EMBED_BATCH)
                       for t in (texts_per_forward or [n]))
        writers[label] = {"rows": n, "targets_per_row": cache.header.embed_targets_dim,
                          "bytes": cache.meta.total_size, "seconds": secs,
                          "texts_per_s": sum(texts_per_forward or [n]) / secs,
                          "k1_launches": k1[label], "k1_expected": 12 * forwards}
        emit({"phase": "noun_writer", "action": label, **writers[label]})
        expect_k1(label, forwards)
    line["writers"] = writers
    if (writers["convert_noun_dataset"]["rows"], writers["cache_noun_multiset"]["rows"]) != (
            NOUN_CONVERT_FSIDS, 3 * NOUN_CONVERT_FSIDS):
        raise SystemExit(f"converted/multiset caches hold {writers}")
    # The converted cache's rows are the noun cache's rows of the same USIDs: the
    # writer emits FSIDs in order, row k landing at the seeded permutation's k
    conv_path = os.path.join(cache_dir, "convert_noun_dataset.bin")
    perm = np.random.default_rng(SEED).permutation(NOUN_CONVERT_FSIDS)
    fsids = np.sort(np.random.default_rng(SEED + 1).choice(NOUN_CONVERT_FSIDS, NOUN_CHECK_ROWS,
                                                           replace=False))
    with EmbeddingCache(conv_path, strict_embedder=False) as conv:
        got = np.stack([np.asarray(conv.get_samples(int(perm[f]), int(perm[f]) + 1)[0][0])
                        for f in fsids])
    ref = noun_embeds([ds.get_sample_usid(int(f)) for f in fsids])
    cos = cosines(got, ref)
    line["converted_vs_noun_cache"] = {"rows": NOUN_CHECK_ROWS, "cosine_min": float(cos.min()),
                                       "max_abs_diff": float(np.abs(got - ref).max()),
                                       "bar": COSINE_MIN}
    emit({"phase": "converted_vs_noun_cache", **line["converted_vs_noun_cache"]})
    if cos.min() < COSINE_MIN:
        raise SystemExit("converted cache rows differ from the noun cache's")

    # 3. train embedding_dataset=NounDataset at the FT0 recipe, cached and uncached
    train_args = [f"vocab_path={vocab_all}", *common, "embedding_dataset=NounDataset",
                  "chunk_scale=0.38", f"max_chunks={NOUN_TRAIN_CHUNKS}", "save_every_max=1000000",
                  "save_top1_min=200"] + FT0_RECIPE
    microbatches = NOUN_TRAIN_CHUNKS * NOUN_TRAIN_STEPS * TRAIN_ACCUM
    first_batches, trains = {}, {}
    for noun_cache in ("true", "false"):
        label = f"train_noun_cache_{noun_cache}"
        args = train_args + [f"noun_cache={noun_cache}", f"output_dir={wd}/{label}"]
        torch.cuda.reset_peak_memory_stats()
        (state, S, ewa), secs = run(label, "action=train", *args)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ckpts = sorted(glob.glob(os.path.join(wd, label, "ovod_*", "*.npz")))
        with open(os.path.join(os.path.dirname(ckpts[-1]), "metrics.jsonl")) as f:
            chunks = [json.loads(x) for x in f]
        # K1: the noun cache's sanity check (cached), 12 per loader batch (uncached)
        k1_want = 12 * (NOUN_SANITY_ROWS if noun_cache == "true" else microbatches)
        res = {"seconds": secs, "steps": state.step, "chunks": len(chunks),
               "chunk_loss": [c["chunk_loss"] for c in chunks],
               "ewa_loss": [c["loss"] for c in chunks],
               "ms_per_step_chunk2": chunks[-1]["chunk_time"] / NOUN_TRAIN_STEPS * 1e3,
               "peak_memory_gb": peak_gb, "k1_launches": k1[label], "k1_expected": k1_want,
               "dropout_launches": k3[label],
               "dropout_expected": DROPOUT_SITES * 2 * microbatches}

        # The same dataset and loader in Python: the first batch, then whole steps
        # (8 loader batches and the accumulated step) timed and profiled
        cfg = load_config(None, args)
        emb = load_embedder(cfg, device="cuda")
        dset = load_embedding_dataset(cfg, emb, training=True)
        gen_data_config(cfg, dset)
        loader, _ = dset.create_loader(batch_size=TRAIN_BATCH, training=True, seed=SEED)
        ck = load_checkpoint(ckpts[-1])
        model = decoder_from_numpy(ck["model_config"], ck["params"]).to("cuda")
        opt = create_optimizer(model.named_parameters(), weight_decay=cfg.weight_decay)
        noise = EmbeddingNoise.create("GaussElemUniformAngle", vec_norm=0.5, angle_min=10.0,
                                      angle_max=30.0, mix_ratio=0.15)
        step = make_train_step(TrainState(model=model, optimizer=opt), noise=noise,
                               gradient_clip=1.0, accum_steps=TRAIN_ACCUM)
        rng_t = TrainRng.create(SEED, "cuda")
        with dset.loaded():
            it = iter(loader)
            first = next(it)
            first_batches[noun_cache] = first

            def one_step():
                batches = [next(it) for _ in range(TRAIN_ACCUM)]
                bt = tuple(_accum_concat([_tensor(b[j], torch.device("cuda"), dt)
                                          for b in batches])
                           for j, dt in enumerate((torch.float32, None, None, torch.float32)))
                step(bt, 1e-4, rng_t).fetch()

            one_step()  # warm
            step_ms = wall_ms(one_step, repeats=3)
            prof = device_profile(one_step, host=False)
        prof.pop("matched_kernels")
        del model, opt, step, emb, dset
        torch.cuda.empty_cache()
        res.update(ms_per_step_with_loader=statistics.median(step_ms), repeats_ms=step_ms,
                   step_device_busy_ms=prof["device_busy_ms"],
                   step_device_idle_share=1.0 - prof["device_busy_ms"] / statistics.median(step_ms),
                   step_top_device_kernels_ms=prof["top_device_kernels_ms"][:6])
        trains[label] = res
        emit({"phase": "noun_train", "noun_cache": noun_cache, "device": name, "nvidia_smi": smi,
              "recipe": FT0_RECIPE, **res})
        if state.step != NOUN_TRAIN_CHUNKS * NOUN_TRAIN_STEPS or len(chunks) != NOUN_TRAIN_CHUNKS:
            raise SystemExit(f"{label}: {state.step} steps over {len(chunks)} chunks")
        if not all(math.isfinite(v) for c in chunks for v in (c["chunk_loss"], c["loss"])):
            raise SystemExit(f"{label}: non-finite loss")
        if k1[label] != k1_want or k3[label] != res["dropout_expected"]:
            raise SystemExit(f"{label}: K1 {k1[label]} (expected {k1_want}), K3' {k3[label]} "
                             f"(expected {res['dropout_expected']}) launches")
    line["train"] = trains
    (ec, tc, mc, _), (eu, tu, mu, _) = first_batches["true"], first_batches["false"]
    cos = cosines(np.asarray(ec), np.asarray(eu))
    w = min(tc.shape[1], tu.shape[1])
    same_targets = bool(np.array_equal(np.asarray(tc)[:, :w], np.asarray(tu)[:, :w]))
    line["cached_vs_uncached_first_batch"] = {"rows": int(ec.shape[0]),
                                              "cosine_min": float(cos.min()),
                                              "bar": COSINE_MIN, "same_targets": same_targets}
    emit({"phase": "cached_vs_uncached", **line["cached_vs_uncached_first_batch"]})
    if cos.min() < COSINE_MIN or not same_targets:
        raise SystemExit("the uncached loader's first batch differs from the noun cache's rows")
    del rows
    os.remove(noun_path)  # 1.8 GB

    # 4. cache_cls over seeded class folders, cache_images over one, merge_caches
    classes = [nouns[int(i)] for i in np.random.default_rng(SEED + 2).choice(
        NOUN_CONVERT, CLS_CLASSES, replace=False)]
    img_root = os.path.join(wd, "images")
    t0 = time.perf_counter()
    folders = write_class_folders(img_root, classes, np.random.default_rng(SEED + 3))
    write_s = time.perf_counter() - t0
    _, secs = run("cache_cls", "action=cache_cls", "cls_dataset=Imagenette",
                  f"cls_dataset_root={img_root}", "cls_split=valid", "class_names_variant=",
                  "save_embedding_cache=cls.bin", *cut)
    n_first = len(os.listdir(folders[0]))
    _, secs_img = run("cache_images", "action=cache_images", f"images=[{folders[0]}]",
                      "save_embedding_cache=images.bin", *cut)
    _, secs_merge = run("merge_caches", "action=merge_caches",
                        "embedding_datasets=[cls.bin,convert_noun_dataset.bin]",
                        "save_embedding_cache=merged.bin", *cut)
    sizes = {k: EmbeddingCache(os.path.join(cache_dir, f"{k}.bin"),
                               strict_embedder=False).header.embed_num
             for k in ("cls", "images", "merged")}
    line["images"] = {"classes": classes, "images": CLS_IMAGES, "png_write_s": write_s,
                      "cache_cls_s": secs, "cache_cls_images_per_s": CLS_IMAGES / secs,
                      "cache_images_s": secs_img, "cache_images_rows": n_first,
                      "merge_s": secs_merge, "rows": sizes,
                      "k1_launches": {k: k1[k] for k in ("cache_cls", "cache_images",
                                                          "merge_caches")}}
    emit({"phase": "noun_images", **line["images"]})
    expect_k1("cache_cls", math.ceil(CLS_IMAGES / CLS_IMAGE_BATCH))
    expect_k1("cache_images", math.ceil(n_first / CLS_IMAGE_BATCH))
    expect_k1("merge_caches", 0)
    if sizes != {"cls": CLS_IMAGES, "images": n_first, "merged": CLS_IMAGES + NOUN_CONVERT_FSIDS}:
        raise SystemExit(f"image caches hold {sizes}")

    # ... and whether a row's card embedding depends on the size of its batch
    emb = Embedder.create(SPEC, weights_path=weights, compute_dtype="bfloat16", device="cuda",
                          image_batch_size=CLS_IMAGE_BATCH, load_model=True)
    paths = sorted(glob.glob(os.path.join(img_root, "Imagenette", "*", "val", "*", "*.png")))
    pixels = emb.get_image_transform()(load_images(paths[:CLS_IMAGE_BATCH]))
    full = emb.inference_image(pixels)
    invariance = {}
    for b in (n_first, 64, 1):
        part = emb.inference_image(pixels[:b])
        invariance[str(b)] = {"max_abs_diff": float(np.abs(part - full[:b]).max()),
                              "cosine_min": float(cosines(part, full[:b]).min()),
                              "bit_identical": bool(np.array_equal(part, full[:b]))}
    texts = [f"a photo of a {n}." for n in nouns[:NOUN_EMBED_BATCH]]
    t_full, t_one = emb.inference_text(texts), emb.inference_text(texts[:1])
    line["batch_invariance"] = {"image_vs_batch_of": CLS_IMAGE_BATCH, "image": invariance,
                                "text_1_vs_256_bit_identical": bool(np.array_equal(t_one,
                                                                                   t_full[:1]))}
    emit({"phase": "batch_invariance", **line["batch_invariance"]})
    # One noun-cache flush (256 texts) with the tower padded to 256 rows (this
    # run) and to 512 (config/train.yaml's batch_size_embed)
    flush_ms = {}
    for rows in (NOUN_EMBED_BATCH, 2 * NOUN_EMBED_BATCH):
        emb.inference_batch_size = rows
        emb.inference_text(texts)  # warm
        flush_ms[rows] = wall_ms(lambda: emb.inference_text(texts), repeats=5)
    del emb
    torch.cuda.empty_cache()
    med = {rows: statistics.median(v) for rows, v in flush_ms.items()}
    line["padding"] = {"texts": NOUN_EMBED_BATCH, "flush_ms_padded_to": med,
                       "repeats_ms": flush_ms,
                       "noun_cache_extra_s_at_512": (med[2 * NOUN_EMBED_BATCH]
                                                     - med[NOUN_EMBED_BATCH]) * gen_batches / 1e3}
    emit({"phase": "noun_cache_padding", **line["padding"]})

    # 5. test_data_loader over the converted cache, at the FT0 batch and accumulation
    _, secs = run("test_data_loader", "action=test_data_loader",
                  f"embedding_dataset={conv_path}", "test_training=true",
                  f"batch_size={TRAIN_BATCH}", f"accum_factor={TRAIN_ACCUM}", *cut)
    line["test_data_loader_s"] = secs
    line["k1_launches"] = sum(k1.values())
    line["k1_launches_by_step"] = k1
    line["dropout_launches"] = sum(k3.values())
    line["seconds"] = time.perf_counter() - phase_t0
    emit({"phase": "noun_data_done", "seconds": line["seconds"], "k1_launches": k1,
          "dropout_launches": k3})
    return line


def phase_eval(workdir: str, weights: str, nouns: list, name: str, smi: str) -> dict:
    """Phase 11: the evaluation, inference and results actions, every step through
    `novic_tpu_torch.cli.train` on the card, over phase 10's workdir (its vocab of
    the FT0 nouns, the multiset and converted caches, the checkpoint it trained
    from the noun cache and its 1,024 PNGs in 10 classes) with phase 9's seeded
    SigLIP-B/16 (bf16) and phase 9's FT0 .model."""
    from novic_tpu_torch import infer
    from novic_tpu_torch.cli import actions_train
    from novic_tpu_torch.cli.common import (gen_data_config, load_embedder,
                                            load_embedding_dataset, load_mean_shift)
    from novic_tpu_torch.cli.train import main as train_main
    from novic_tpu_torch.data.classification import load_image_dataset_prompts
    from novic_tpu_torch.embedders.base import TorchEmbedder
    from novic_tpu_torch.infer import GenerationConfig, GenerationTask
    from novic_tpu_torch.ops import attention, dropout
    from novic_tpu_torch.text.simple import make_test_tokenizer
    from novic_tpu_torch.utils.config import load_config

    nd = os.path.join(workdir, "noun_data")
    wd = os.path.join(workdir, "eval")
    os.makedirs(wd)
    phase_t0 = time.perf_counter()
    vocab = os.path.join(nd, "vocab.json")
    multiset = os.path.join(nd, "cache", "cache_noun_multiset.bin")
    converted = os.path.join(nd, "cache", "convert_noun_dataset.bin")
    (ckpt,) = glob.glob(os.path.join(nd, "train_noun_cache_true", "ovod_*", "*.npz"))[-1:]
    ft0_model = os.path.join(workdir, "reference", "ovod_chunk0001_ft0.model")
    img_root = os.path.join(nd, "images")
    folders = sorted(glob.glob(os.path.join(img_root, "Imagenette", "*", "val", "*")))
    n_first = len(os.listdir(folders[0]))
    out_dir = os.path.join(wd, "out")
    common = [f"embedder={SPEC}", f"embedder_weights={weights}", "embedder_compute_dtype=bfloat16",
              f"vocab_path={vocab}", f"prompt_collection={NOUN_COLLECTION}",
              "hypernym_collection=None", f"batch_size_embed={NOUN_EMBED_BATCH}",
              f"batch_size_image={CLS_IMAGE_BATCH}", f"output_dir={out_dir}", f"seed={SEED}"]
    cls = ["cls_dataset=Imagenette", f"cls_dataset_root={img_root}", "cls_split=valid"]
    line = {"phase": "eval", "device": name, "nvidia_smi": smi}
    k1, k3, secs = {}, {}, {}

    def run(label: str, *args: str, device: str = "cuda"):
        """One CLI action: its result; its seconds, K1 and K3' launches by label."""
        attention.LAUNCHES = dropout.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_main(list(args) + [f"--device={device}"])
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        k1[label], k3[label] = attention.LAUNCHES, dropout.LAUNCHES
        return out

    def tower_forwards(images: int = 0, text_calls: int = 0, texts_per_call: int = 0) -> int:
        return (math.ceil(images / CLS_IMAGE_BATCH)
                + text_calls * math.ceil(texts_per_call / NOUN_EMBED_BATCH))

    def expect(label: str, forwards: int, dropouts: int = 0):
        if (k1[label], k3[label]) != (12 * forwards, dropouts):
            raise SystemExit(f"eval {label}: fused_attention launched {k1[label]} times, dropout "
                             f"{k3[label]}; expected {12 * forwards} (12 per tower forward) "
                             f"and {dropouts}")

    # 1. embedder_zero_shot with the modality gap; its JSON feeds a training chunk
    gap_path = os.path.join(wd, "modality_gap.json")
    prompts = load_image_dataset_prompts("Imagenette", "clip")
    zs = run("embedder_zero_shot", "action=embedder_zero_shot", "measure_gap=true",
             f"gap_output_path={gap_path}", *cls, *common)
    expect("embedder_zero_shot", tower_forwards(CLS_IMAGES, CLS_CLASSES, len(prompts)))
    with open(gap_path) as f:
        gap = json.load(f)
    shift_cfg = load_config(None, ["action=train", "mean_shift=true",
                                   f"mean_shift_path={gap_path}", *common])
    shift = load_mean_shift(shift_cfg, load_embedder(shift_cfg, device="cuda"))
    line["embedder_zero_shot"] = {
        "top1": zs["Imagenette"], "seconds": secs["embedder_zero_shot"],
        "images_per_s": CLS_IMAGES / secs["embedder_zero_shot"],
        "angle_mean": gap["angle_mean"], "angle_std": gap["angle_std"],
        "all_angle_mean": gap["all_angle_mean"], "all_angle_std": gap["all_angle_std"],
        "angle_count": sum(gap["angle_histc"]["counts"]), "device_key": gap["cfg_embedder"]["device"],
        "mean_shift_norm": float(np.linalg.norm(shift)), "prompts": len(prompts),
        "k1_launches": k1["embedder_zero_shot"]}
    emit({"phase": "eval_zero_shot", **line["embedder_zero_shot"]})
    if shift.shape != (768,) or not np.isfinite(shift).all() or \
            line["embedder_zero_shot"]["angle_count"] != CLS_IMAGES:
        raise SystemExit(f"modality gap: shift {shift.shape}, {gap['angle_histc']['bins']} bins")
    # ... one chunk of 2 steps at the FT0 recipe over the converted cache, mean_shift=true
    loaded = []
    original = actions_train.load_mean_shift
    actions_train.load_mean_shift = lambda cfg, emb: loaded.append(original(cfg, emb)) or loaded[-1]
    try:
        state, S, _ = run("train_mean_shift", "action=train", f"embedding_dataset={converted}",
                          "mean_shift=true", f"mean_shift_path={gap_path}",
                          # 2 steps of TRAIN_ACCUM loader batches; a chunk is chunk_scale
                          # x the cache's target nouns (a hair under, for the ceil)
                          f"chunk_scale={(2 * TRAIN_ACCUM * TRAIN_BATCH - 0.5) / NOUN_CONVERT!r}",
                          "max_chunks=1", "save_every_max=1000000", "save_top1_min=200",
                          *common, f"output_dir={wd}/train_mean_shift", *FT0_RECIPE)
    finally:
        actions_train.load_mean_shift = original
    with open(glob.glob(os.path.join(wd, "train_mean_shift", "ovod_*", "metrics.jsonl"))[0]) as f:
        chunk = json.loads(f.readline())
    line["train_mean_shift"] = {"steps": state.step, "chunk_loss": chunk["chunk_loss"],
                                "seconds": secs["train_mean_shift"],
                                "dropout_launches": k3["train_mean_shift"]}
    emit({"phase": "eval_train_mean_shift", **line["train_mean_shift"]})
    if not (len(loaded) == 1 and np.array_equal(loaded[0], np.asarray(gap["mean_shift"],
                                                                      np.float32))):
        raise SystemExit("training did not read the measured mean shift")
    if state.step != 2 or not math.isfinite(chunk["chunk_loss"]):
        raise SystemExit(f"mean-shift chunk: {state.step} steps, loss {chunk['chunk_loss']}")
    expect("train_mean_shift", 0, DROPOUT_SITES * 2 * 2 * TRAIN_ACCUM)

    # 2. eval over the multiset cache with phase 10's checkpoint: card, CPU, train mode
    eval_args = ["action=eval", f"embedding_dataset={multiset}", f"load_model={ckpt}",
                 "multi_target=true", "use_weights=true", "eval_guided=true",
                 f"batch_size={EVAL_BATCH}",
                 f"eval_batches={EVAL_BATCHES}", *common]
    evals = {}
    for label, extra, device in (("eval", [], "cuda"), ("eval_cpu", [], "cpu"),
                                 ("eval_train", ["eval_train=true"], "cuda")):
        (evals[label],) = run(label, *eval_args, *extra, device=device).values()
    expect("eval", 0)
    expect("eval_train", 0, DROPOUT_SITES * EVAL_BATCHES)
    card, cpu, trained = evals["eval"], evals["eval_cpu"], evals["eval_train"]
    # Flipped argmaxes, counted on the first batch: the decoder's logits on both sides
    cfg = load_config(None, eval_args)
    emb = load_embedder(cfg, device="cuda")
    dset = load_embedding_dataset(cfg, emb, training=False)
    gen_data_config(cfg, dset)
    preds = {}
    for device in ("cuda", "cpu"):
        dec = infer.load_decoder_from_checkpoint(ckpt, emb, device=device)
        dset.set_translation(emb.target_config)
        with dset.loaded():
            loader, _ = dset.create_loader(batch_size=EVAL_BATCH, training=False)
            e, t, m, w = next(iter(loader))
        e, t, m = (None if x is None else torch.from_numpy(np.array(x)).to(device)
                   for x in (e, t, m))
        with torch.no_grad():
            logits, pad = dec.model(e.float(), t, m)[:2]
        argmax = logits.argmax(-1).cpu().numpy()
        preds[device] = (argmax, np.zeros(argmax.shape, bool) if pad is None
                         else pad.cpu().numpy())
    scored = ~preds["cpu"][1]
    flips = int(((preds["cuda"][0] != preds["cpu"][0]) & scored).sum())
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    line["eval"] = {"rows": card["num_samples"], "tokens": card["tokens"],
                    "card": {k: card[k] for k in ("loss", "token_top1", "noun_top1")},
                    "cpu": {k: cpu[k] for k in ("loss", "token_top1", "noun_top1")},
                    "train_mode": {k: trained[k] for k in ("loss", "token_top1", "noun_top1")},
                    "loss_rel_diff": loss_rel, "loss_bar": EVAL_LOSS_RTOL,
                    "flipped_argmaxes": flips, "scored_tokens_first_batch": int(scored.sum()),
                    "flip_bar": EVAL_FLIP_SHARE,
                    "seconds": {k: secs[k] for k in ("eval", "eval_cpu", "eval_train")},
                    "dropout_launches_train_mode": k3["eval_train"]}
    emit({"phase": "eval_eval", **line["eval"]})
    if loss_rel > EVAL_LOSS_RTOL or flips > EVAL_FLIP_SHARE * scored.sum() or \
            card["tokens"] != cpu["tokens"] or card["num_samples"] != EVAL_BATCH * EVAL_BATCHES:
        raise SystemExit(f"eval: card and CPU disagree ({loss_rel} relative, {flips} flips)")
    if not all(math.isfinite(trained[k]) for k in ("loss", "token_top1", "noun_top1")):
        raise SystemExit("eval_train: non-finite metrics")

    # 3. eval_cls and eval_cls_decoding with the FT0 .model (its tokenizer: the
    # word-level test tokenizer over its nouns, which the CLI has no key for);
    # the decode seconds of each gencfg beside estimate_generation_cost's
    spans = {}

    def timed(key_fn, fn):
        def wrapper(self, *a, **kw):
            key = key_fn(self, *a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            torch.cuda.synchronize()
            if key is not None:
                spans[key] = spans.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    originals = (TorchEmbedder._build_tokenizer, GenerationTask.generate,
                 GenerationTask.ensure_precomputed, GenerationTask._maybe_trie)
    TorchEmbedder._build_tokenizer = staticmethod(
        lambda arch, path: make_test_tokenizer(nouns, context_length=arch.text.context_length))
    GenerationTask.generate = timed(lambda t, *a: ("generate", t.gencfg.name), originals[1])
    GenerationTask.ensure_precomputed = timed(
        lambda t, *a: ("precompute", t.gencfg.name) if t.precompute is None else None,
        originals[2])
    GenerationTask._maybe_trie = timed(lambda t, *a: ("trie", t.gencfg.name), originals[3])
    cls_ft0 = [*cls, "class_names_variant=", f"load_model={ft0_model}", *common]
    try:
        eval_cls = run("eval_cls", "action=eval_cls", *cls_ft0)
        spans.clear()
        # (the later key wins: one batch of EVAL_SAMPLES_MAX images)
        rows = run("eval_cls_decoding", "action=eval_cls_decoding", *cls_ft0,
                   f"gencfgs=[{', '.join(EVAL_GENCFGS)}]", f"eval_samples_max={EVAL_SAMPLES_MAX}",
                   f"batch_size_image={EVAL_SAMPLES_MAX}", "eval_topk=3")
        decode = dict(spans)
        (res,) = eval_cls.values()
        W = len(nouns)  # the FT0 vocabulary, all encodable by its tokenizer
        est = {g: infer.estimate_generation_cost(GenerationConfig.from_name(g), EVAL_SAMPLES_MAX, W)
               for g in EVAL_GENCFGS}
        cap = (est["beam_k10_vnone_gp_t1_a0"] + est["all_k10_vnone_gp_t1_a0"]) / 2
        capped = run("eval_cls_decoding_capped", "action=eval_cls_decoding", *cls_ft0,
                     f"gencfgs=[{EVAL_GENCFGS[2]}, {EVAL_GENCFGS[3]}]", f"max_gencfg_cost={cap}",
                     f"eval_samples_max={EVAL_SAMPLES_MAX}",
                     f"batch_size_image={EVAL_SAMPLES_MAX}")

        # 4. infer over one class folder and a few texts, with an annotation JSON
        ann_path = os.path.join(wd, "annotations.json")
        first = sorted(os.listdir(folders[0]))
        with open(ann_path, "w") as f:
            json.dump({INFER_TEXTS[0]: {"correct_primary": ["dog"], "close_primary": []},
                       first[0]: {"correct_primary": [], "close_primary": []}}, f)
        spans.clear()
        out = run("infer", "action=infer", f"infer_all_dir={folders[0]}",
                  f"infer_texts=[{', '.join(INFER_TEXTS)}]", f"gencfgs=[{', '.join(INFER_GENCFGS)}]",
                  f"infer_ann_json={ann_path}", "infer_ann_json_update=true",
                  f"load_model={ft0_model}", *common)
        infer_decode = dict(spans)
    finally:
        (TorchEmbedder._build_tokenizer, GenerationTask.generate,
         GenerationTask.ensure_precomputed, GenerationTask._maybe_trie) = (
            staticmethod(originals[0]), *originals[1:])
    expect("eval_cls", tower_forwards(CLS_IMAGES))
    expect("eval_cls_decoding", 1)
    expect("eval_cls_decoding_capped", 1)
    per_gencfg = {}
    for g in EVAL_GENCFGS:
        fixed = decode.get(("precompute", g), 0.0) + decode.get(("trie", g), 0.0)
        per_gencfg[g] = {"seconds": decode[("generate", g)], "fixed_s": fixed,
                         "decode_s": decode[("generate", g)] - fixed,
                         "per_image_s": (decode[("generate", g)] - fixed) / EVAL_SAMPLES_MAX,
                         "estimate_s": est[g]}
    greedy = max(per_gencfg[g]["per_image_s"] for g in EVAL_GENCFGS[:2])
    line["eval_cls"] = {"images": CLS_IMAGES, "seconds": secs["eval_cls"],
                        "images_per_s": CLS_IMAGES / secs["eval_cls"],
                        "direct_top1": res["direct_top1"], "guided_top1": res["guided_top1"],
                        "buckets": res["buckets"]}
    line["eval_cls_decoding"] = {
        "images": EVAL_SAMPLES_MAX, "guide_targets": W, "seconds": secs["eval_cls_decoding"],
        "images_per_s": EVAL_SAMPLES_MAX / secs["eval_cls_decoding"],
        "rows": [r[2:6] for r in rows], "per_gencfg": per_gencfg,
        "constants_in_use": {"greedy": infer.GREEDY_S_PER_IMAGE,
                             "beam_k10": infer.BEAM_K10_S_PER_IMAGE, "all": infer.ALL_S_PER_IMAGE},
        "constants_measured": {
            "greedy": greedy,
            "beam_k10": per_gencfg[EVAL_GENCFGS[2]]["per_image_s"] - greedy,
            "all": per_gencfg[EVAL_GENCFGS[3]]["per_image_s"]},
        "cap_s": cap, "capped_rows": [r[2] for r in capped],
        "capped_seconds": secs["eval_cls_decoding_capped"]}
    emit({"phase": "eval_cls", **line["eval_cls"]})
    emit({"phase": "eval_cls_decoding", "device": name, "nvidia_smi": smi,
          **line["eval_cls_decoding"]})
    if sum(res["buckets"].values()) != CLS_IMAGES or [r[2] for r in rows] != EVAL_GENCFGS:
        raise SystemExit(f"eval_cls: {res['buckets']}; decoding rows {[r[2] for r in rows]}")
    if [r[2] for r in capped] != [EVAL_GENCFGS[2]]:
        raise SystemExit(f"max_gencfg_cost={cap}: kept {[r[2] for r in capped]}")

    # ... the predictions JSON and the annotation skeleton
    keys = INFER_TEXTS + [os.path.join(folders[0], f) for f in first]
    with open(ann_path) as f:
        ann = json.load(f)
    (model_out,) = out["models"].values()
    expect("infer", tower_forwards(n_first, 1, len(INFER_TEXTS)))
    bad = [g for g, k in ((INFER_GENCFGS[0], 1), (INFER_GENCFGS[1], 10))
           if len(model_out["gencfgs"][g]["pred"]) != len(keys)
           or any(len(row) != k for row in model_out["gencfgs"][g]["pred"])
           or not np.isfinite(np.asarray(model_out["gencfgs"][g]["score"])).all()]
    line["infer"] = {"samples": len(keys), "seconds": secs["infer"],
                     "samples_per_s": len(keys) / secs["infer"],
                     "decode_s": {g: infer_decode[("generate", g)] for g in INFER_GENCFGS},
                     "annotated_samples": len(ann), "first": [
                         model_out["gencfgs"][g]["pred"][0][:3] for g in INFER_GENCFGS]}
    emit({"phase": "eval_infer", **line["infer"]})
    if out["keys"] != keys or bad or sorted(ann) != sorted(INFER_TEXTS + first) or \
            ann[first[1]] != {"correct_primary": [], "close_primary": []}:
        raise SystemExit(f"infer: keys {len(out['keys'])}/{len(keys)}, bad rows {bad}, "
                         f"annotations {len(ann)}")

    # 5. format_preds in its four modes; format_metrics and format_wandb over the run dirs
    (pred_path,) = glob.glob(os.path.join(out_dir, "ovod_*", "predictions.json"))
    beam = model_out["gencfgs"][INFER_GENCFGS[1]]["pred"]
    rng = np.random.default_rng(SEED + 11)
    for i, key in enumerate(out["keys"]):
        sample = os.path.basename(key)
        ann[sample] = {"correct_primary": [beam[i][int(rng.integers(0, 10))]],
                       "close_primary": [beam[i][0]] if i % 2 else []}
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    formats = {}
    for mode in ("nouns_v1", "model_topk_v1", "model_max_v1", "gencfg_model_v1"):
        formats[mode] = run(f"format_preds_{mode}", "action=format_preds",
                            f"predictions_path={pred_path}", f"annotations_paths=[{ann_path}]",
                            f"format_mode={mode}", *common)
    metrics_rows = run("format_metrics", "action=format_metrics", *common)
    wandb_rows = run("format_wandb", "action=format_wandb", "fmt_type=all_v1", *common)
    top1 = formats["model_max_v1"]
    line["format"] = {"model_max_v1_top1": {g: [round(s, 3) for s in v[0]]
                                            for g, d in top1.items() for v in d.values()},
                      "format_metrics_rows": len(metrics_rows),
                      "format_wandb_rows": len(wandb_rows),
                      "format_wandb_actions": sorted({r[1] for r in wandb_rows}),
                      "seconds": sum(v for k, v in secs.items() if k.startswith("format"))}
    emit({"phase": "eval_format", **line["format"]})
    # (eval_cls_decoding's run dir holds no config.json, as in novic_tpu, so the
    # database lists it only where it shares eval_cls's dir)
    if not metrics_rows or not wandb_rows or not all(formats.values()) or \
            {"eval", "eval_cls", "infer"} - set(line["format"]["format_wandb_actions"]):
        raise SystemExit(f"format: {len(metrics_rows)} metrics rows, {len(wandb_rows)} "
                         f"database rows of {line['format']['format_wandb_actions']}")

    # 6. sample_images over one folder, weighted toward two of its classes' nouns; twice
    special = [os.path.basename(folders[0]).replace("_", " "),
               os.path.basename(folders[1]).replace("_", " ")]
    chosen = []
    for label in ("sample_images", "sample_images_again"):
        _, picked = run(label, "action=sample_images", f"sample_input_dir={folders[0]}",
                        f"sample_output_dir={wd}/sampled", f"sample_count={SAMPLE_COUNT}",
                        f"sample_special=[{', '.join(special)}]",
                        "sample_special_factor=[2.0, 1.0]", *common)
        chosen.append(picked)
        imagenet_prompts = len(load_image_dataset_prompts("imagenet1k", "clip"))
        expect(label, tower_forwards(n_first, len(special), imagenet_prompts))
    line["sample_images"] = {"images": n_first, "count": SAMPLE_COUNT, "special": special,
                             "seconds": secs["sample_images"],
                             "images_per_s": n_first / secs["sample_images"],
                             "same_choice": chosen[0] == chosen[1]}
    emit({"phase": "eval_sample_images", **line["sample_images"]})
    if chosen[0] != chosen[1] or len(set(chosen[0])) != min(SAMPLE_COUNT, n_first):
        raise SystemExit(f"sample_images: {chosen}")

    line["k1_launches"] = sum(k1.values())
    line["k1_launches_by_step"] = k1
    line["dropout_launches"] = sum(k3.values())
    line["dropout_launches_by_step"] = {k: v for k, v in k3.items() if v}
    line["seconds"] = time.perf_counter() - phase_t0
    emit({"phase": "eval_done", "seconds": line["seconds"], "k1_launches": k1,
          "dropout_launches": line["dropout_launches_by_step"], "action_seconds": secs})
    return line


def phase_towers(workdir: str, frames: list, nouns: list, name: str, smi: str) -> dict:
    """Phase 12: the EVA02, CLIPA and ALIGN tower families and the structured
    test embedder on the card. K1 at the towers' new shapes (hd 112; BERT's
    (B, S) key bias) against its plain version; EVA02-L/14 converted through
    the CLI and CLIPA-L/14 (seeded) serving the FT0 decoder, guided beam k=10,
    2 x 64 frames; EVA02-E-14-plus at full width and depth (weights drawn on
    the card); ALIGN's EfficientNet-B7 and BERT towers, and zero-shot over
    phase 10's PNGs through the CLI; a mean_shift=true chunk with
    'test-structured:' through the CLI (K3'). Returns the kernels line's
    inputs: K1's three lines and their launches on this phase's path."""
    from novic_tpu_torch.cli.train import main as train_main
    from novic_tpu_torch.embedders.base import Embedder, TorchEmbedder
    from novic_tpu_torch.embedders.registry import lookup
    from novic_tpu_torch.embedders.structured import (make_structured_vocab,
                                                      write_structured_cls_dataset)
    from novic_tpu_torch.infer import NOVICModel
    from novic_tpu_torch.ops import attention, dropout
    from novic_tpu_torch.text.simple import make_test_tokenizer

    wd = os.path.join(workdir, "towers")
    os.makedirs(wd)
    phase_t0 = time.perf_counter()
    line = {"phase": "towers", "device": name, "nvidia_smi": smi}
    failures = []

    # 1. K1 at the new shapes: the L/14 towers' (hd 64, 257 tokens), EVA02-E's
    # (hd 112, K1's KS = 7 instance) and ALIGN's BERT with its ragged key bias
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # (the profiles here are optional: one full run's profiler showed no K1
    # kernel at this point of the script, though phase 12 alone shows them)
    k1 = {"vision_l14": k1_check(attention, gen, BATCH, 257, 16, 64, optional_profile=True),
          "eva02_e": k1_check(attention, gen, EVA_E_BATCH, 257, 16, 112, optional_profile=True),
          "key_bias": k1_check(attention, gen, TEXT_BATCH, 64, 12, 64, key_pads=True,
                               optional_profile=True)}
    # ... and a whole 64-key tile masked by the key bias adds exactly 0
    q, k, v = (torch.randn(4, 150, 4, 64, device="cuda", generator=gen) for _ in range(3))
    key_bias = torch.zeros(4, 150, device="cuda")
    key_bias[:, 64:128] = -1e30
    v2 = v.clone()
    v2[:, 64:128] = 1e3
    masked_tile_exact = torch.equal(attention.fused_attention(q, k, v, key_bias=key_bias),
                                    attention.fused_attention(q, k, v2, key_bias=key_bias))
    emit({"phase": "towers_masked_tile", "shape": [4, 150, 4, 64], "masked_keys": [64, 128],
          "exact_zero": masked_tile_exact})
    if not masked_tile_exact:
        raise SystemExit("K1: a fully masked 64-key tile moved the output")
    launches = {key: 0 for key in k1}

    def ids_for(arch, rows: int, seed: int) -> np.ndarray:
        """Seeded token ids: the highest id (the argmax pool's end token) at a
        seeded position of each row, pads after it."""
        rng = np.random.default_rng(seed)
        ctx, vocab = arch.text.context_length, arch.text.vocab_size
        ids = rng.integers(1, vocab - 1, size=(rows, ctx)).astype(np.int32)
        ends = rng.integers(1, ctx, size=rows)
        ids[np.arange(rows), ends] = vocab - 1
        ids[np.arange(ctx)[None, :] > ends[:, None]] = 0
        return ids

    # 2. EVA02-L/14 (converted through the CLI) and CLIPA-L/14 (seeded) serve
    # the FT0 decoder, guided beam k=10, 2 batches of 64
    eva_l = lookup(EVA_L_SPEC)
    t0 = time.perf_counter()
    sd = eva_openclip_state_dict(eva_l, SEED)
    binpath, eva_weights = os.path.join(wd, "eva02_l14.bin"), os.path.join(wd, "eva02_l14.npz")
    torch.save(sd, binpath)
    backbone_params = sum(x.numel() for x in sd.values())
    del sd
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_main(["action=convert_embedder", f"embedder={EVA_L_SPEC}", f"load_model={binpath}",
                f"embedder_weights={eva_weights}", "--device=cuda"])
    line["eva02_l_conversion"] = {"params": backbone_params, "make_s": make_s,
                                  "convert_s": time.perf_counter() - t0}
    os.remove(binpath)
    guided, unguided = "beam_k10_vnone_gp_t1_a0", "beam_k10_vnone_gn_t1_a0"
    guide = set(nouns)
    for label, spec, extra in (("eva02_l14", EVA_L_SPEC, {"weights_path": eva_weights}),
                               ("clipa_l14", CLIPA_L_SPEC, {"seed": SEED})):
        arch = lookup(spec)
        ekw = {"tokenizer": make_test_tokenizer(nouns, context_length=arch.text.context_length),
               **extra}
        with NOVICModel(FT0, embedder_spec=spec, embedder_kwargs=ekw, gencfg=guided,
                        batch_size=BATCH, device="cuda") as model:
            attention.LAUNCHES = 0
            t0 = time.perf_counter()
            out = model.classify_images(frames)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            got = attention.LAUNCHES
            check_output(out, len(frames), guide)
            want = arch.vision.layers * math.ceil(len(frames) / BATCH)
            launches["vision_l14"] += got
            e2e_ms = wall_ms(lambda: model.classify_images(frames), repeats=3)
            pixels = model.transform_images(frames[:BATCH])
            tower_ms = cuda_ms(lambda: model.embedder.embed_image_tensor(pixels), iters=5,
                               warmup=1)
            tids = torch.from_numpy(ids_for(arch, TEXT_BATCH, SEED + 12)).cuda()
            text_ms = cuda_ms(lambda: model.embedder.embed_token_tensor(tids), iters=5, warmup=1)
            prof = device_profile(lambda: model.embedder.embed_image_tensor(pixels),
                                  match=K1_KERNELS, require=K1_KERNELS[1:], optional=True) or {
                "device_busy_ms": None, "top_device_kernels_ms": None, "matched_kernels": None}
            k1_ms = prof["matched_kernels"] and sum(m[1] for m in prof["matched_kernels"])
            e_gpu = model.embed_images(frames[:2])
            top_gpu = [r[0] for r in model.classify_embeds(e_gpu, gencfg=unguided).preds]
        with NOVICModel(FT0, embedder_spec=spec, embedder_kwargs=ekw, gencfg=unguided,
                        batch_size=2, device="cpu") as cpu:
            e_cpu = cpu.embed_images(frames[:2])
            top_cpu = [r[0] for r in cpu.classify_embeds(e_cpu).preds]
        cos = cosines(e_cpu, e_gpu)
        # ... and at float32 compute, the same weights
        f32 = [Embedder.create(spec, compute_dtype="float32", device=dev, image_batch_size=2,
                               **ekw) for dev in ("cuda", "cpu")]
        e32 = [emb.inference_image(emb.get_image_transform()(frames[:2])) for emb in f32]
        del f32
        cos32 = cosines(e32[1], e32[0])
        bar = EVA_L_BF16_COSINE_MIN if label == "eva02_l14" else COSINE_MIN
        res = {"spec": spec, "images": len(frames), "batch": BATCH, "gencfg": guided,
               "tokens": arch.vision.grid ** 2 + 1, "layers": [arch.vision.layers,
                                                               arch.text.layers],
               "fused_attention_launches": got, "expected_launches": want,
               "first_call_s": first_s, "e2e_images_per_s": len(frames) / (
                   statistics.median(e2e_ms) / 1e3), "e2e_ms": e2e_ms,
               "tower_ms_per_batch": tower_ms, "tower_images_per_s": BATCH / (tower_ms / 1e3),
               "text_batch": TEXT_BATCH, "text_ms_per_batch": text_ms,
               "texts_per_s": TEXT_BATCH / (text_ms / 1e3),
               "profile_device_busy_ms": prof["device_busy_ms"],
               "fused_attention_device_ms": k1_ms,
               "fused_attention_share": k1_ms and k1_ms / prof["device_busy_ms"],
               "top_device_kernels_ms": prof["top_device_kernels_ms"],
               "labels": [r[:3] for r in out.preds[:3]], "card_vs_cpu_cosine": cos.tolist(),
               "card_vs_cpu_bar": bar, "card_vs_cpu_cosine_float32": cos32.tolist(),
               "top1_cpu": top_cpu, "top1_gpu": top_gpu}
        emit({"phase": f"towers_{label}", **res})
        line[label] = res
        if got != want:
            raise SystemExit(f"{label}: fused_attention launched {got} times, expected {want}")
        if cos.min() < bar or cos32.min() < COSINE_MIN or top_cpu != top_gpu:
            failures.append(f"{label}: card and CPU disagree")

    # 3. EVA02-E-14-plus at full width and depth, its weights drawn on the card
    eva_e = lookup(EVA_E_SPEC)
    e_tok = make_test_tokenizer(nouns, context_length=eva_e.text.context_length)

    def eva_e_embedder(arch):
        return TorchEmbedder(spec=EVA_E_SPEC, arch=arch, load_model=False, check=False,
                             weights_path=None, tokenizer=e_tok, compute_dtype="bfloat16",
                             seed=SEED, device="cuda", init_on_device=True,
                             inference_batch_size=TEXT_BATCH, image_batch_size=EVA_E_BATCH)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    emb = eva_e_embedder(eva_e)
    t0 = time.perf_counter()
    emb.load_model()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_gb = [sum(p.numel() for p in m.parameters()) * 4 / 1e9
                for m in (emb._vision, emb._text)]
    pixels = emb.get_image_transform()(frames[:EVA_E_BATCH])
    attention.LAUNCHES = 0
    image_embeds = emb.inference_image(pixels)
    torch.cuda.synchronize()
    e_launches = attention.LAUNCHES
    launches["eva02_e"] += e_launches
    vision_ms = cuda_ms(lambda: emb.embed_image_tensor(pixels), iters=3, warmup=1)
    ids = ids_for(eva_e, TEXT_BATCH, SEED + 13)
    attention.LAUNCHES = 0
    text_embeds = emb.inference_tokens({"input_ids": ids})
    torch.cuda.synchronize()
    e_text_launches = attention.LAUNCHES
    tids = torch.from_numpy(ids).cuda()
    text_ms = cuda_ms(lambda: emb.embed_token_tensor(tids), iters=3, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del emb
    torch.cuda.empty_cache()
    # card vs CPU at full width with EVA_E_CPU_LAYERS layers in each tower
    arch4 = dataclasses.replace(
        eva_e, vision=dataclasses.replace(eva_e.vision, layers=EVA_E_CPU_LAYERS),
        text=dataclasses.replace(eva_e.text, layers=EVA_E_CPU_LAYERS))
    emb = eva_e_embedder(arch4)
    emb.load_model()
    with torch.inference_mode():
        card = [emb.embed_image_tensor(pixels[:1]).cpu().numpy(),
                emb.embed_token_tensor(tids[:4]).cpu().numpy()]
        t0 = time.perf_counter()
        cpu = [emb._vision.cpu()(pixels[:1].cpu()).numpy(),
               emb._text.cpu()(tids[:4].cpu()).numpy()]
        cpu_s = time.perf_counter() - t0
    del emb
    cos_img, cos_txt = cosines(cpu[0], card[0]), cosines(cpu[1], card[1])
    finite = (np.isfinite(image_embeds).all() and np.isfinite(text_embeds).all()
              and image_embeds.shape == (EVA_E_BATCH, eva_e.vision.embed_dim)
              and text_embeds.shape == (TEXT_BATCH, eva_e.text.embed_dim))
    res = {"spec": EVA_E_SPEC, "layers": [eva_e.vision.layers, eva_e.text.layers],
           "width": [eva_e.vision.width, eva_e.text.width], "mlp": eva_e.vision.mlp_hidden,
           "param_gb_float32": param_gb, "init_on_card_s": init_s, "batch": EVA_E_BATCH,
           "vision_launches": e_launches, "text_launches": e_text_launches,
           "vision_ms_per_batch": vision_ms, "images_per_s": EVA_E_BATCH / (vision_ms / 1e3),
           "text_batch": TEXT_BATCH, "text_ms_per_batch": text_ms,
           "texts_per_s": TEXT_BATCH / (text_ms / 1e3), "peak_memory_gb": peak_gb,
           "cpu_check_layers": EVA_E_CPU_LAYERS, "card_vs_cpu_cosine_image": cos_img.tolist(),
           "card_vs_cpu_cosine_text": cos_txt.tolist(), "cpu_side_s": cpu_s,
           "finite": bool(finite)}
    emit({"phase": "towers_eva02_e", **res})
    line["eva02_e"] = res
    if (e_launches, e_text_launches) != (eva_e.vision.layers, eva_e.text.layers) or not finite:
        raise SystemExit(f"EVA02-E: launches {(e_launches, e_text_launches)} (expected one a "
                         f"layer a forward), finite {finite}")
    if cos_img.min() < COSINE_MIN or cos_txt.min() < COSINE_MIN:
        failures.append("EVA02-E: card and CPU disagree")

    # 4. ALIGN: EfficientNet-B7 at 289 px and BERT over ragged texts
    align = lookup(ALIGN_SPEC)
    torch.cuda.reset_peak_memory_stats()
    emb = torch_embedder(ALIGN_SPEC, align, nouns, "cuda", ALIGN_BATCH)
    t0 = time.perf_counter()
    pixels = emb.get_image_transform()(frames[:ALIGN_BATCH])
    preprocess_s = time.perf_counter() - t0
    attention.LAUNCHES = 0
    image_embeds = emb.inference_image(pixels)
    torch.cuda.synchronize()
    a_vision_launches = attention.LAUNCHES
    vision_ms = cuda_ms(lambda: emb.embed_image_tensor(pixels), iters=3, warmup=1)
    rng = np.random.default_rng(SEED + 14)
    ctx = align.text.context_length
    lengths = rng.integers(1, ctx + 1, size=TEXT_BATCH)
    ids = rng.integers(1000, align.text.vocab_size, size=(TEXT_BATCH, ctx)).astype(np.int32)
    ids[:, 0] = 101  # [CLS] in BERT-uncased; any nonzero id serves
    ids[np.arange(ctx)[None, :] >= lengths[:, None]] = align.text.pad_token_id
    attention.LAUNCHES = 0
    text_embeds = emb.inference_tokens({"input_ids": ids})
    torch.cuda.synchronize()
    a_text_launches = attention.LAUNCHES
    launches["key_bias"] += a_text_launches
    tids = torch.from_numpy(ids).cuda()
    text_ms = cuda_ms(lambda: emb.embed_token_tensor(tids), iters=5, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del emb
    t0 = time.perf_counter()
    cpu = torch_embedder(ALIGN_SPEC, align, nouns, "cpu", 4)
    e_img = cpu.inference_image(pixels[:2].cpu())
    e_txt = cpu.inference_tokens({"input_ids": ids[:4]})
    cpu_s = time.perf_counter() - t0
    del cpu
    cos_img, cos_txt = cosines(e_img, image_embeds[:2]), cosines(e_txt, text_embeds[:4])
    finite = (np.isfinite(image_embeds).all() and np.isfinite(text_embeds).all()
              and image_embeds.shape == (ALIGN_BATCH, align.vision.embed_dim)
              and text_embeds.shape == (TEXT_BATCH, align.text.embed_dim))
    res = {"spec": ALIGN_SPEC, "image_size": align.vision.image_size, "batch": ALIGN_BATCH,
           "host_preprocess_s": preprocess_s, "vision_ms_per_batch": vision_ms,
           "images_per_s": ALIGN_BATCH / (vision_ms / 1e3), "vision_launches": a_vision_launches,
           "text_batch": TEXT_BATCH, "text_lengths_min_max": [int(lengths.min()),
                                                             int(lengths.max())],
           "text_launches": a_text_launches, "text_ms_per_batch": text_ms,
           "texts_per_s": TEXT_BATCH / (text_ms / 1e3), "peak_memory_gb": peak_gb,
           "card_vs_cpu_cosine_image": cos_img.tolist(),
           "card_vs_cpu_cosine_text": cos_txt.tolist(), "cpu_side_s": cpu_s,
           "finite": bool(finite)}
    emit({"phase": "towers_align", **res})
    line["align"] = res
    if (a_vision_launches, a_text_launches) != (0, align.text.layers) or not finite:
        raise SystemExit(f"ALIGN: K1 launches vision {a_vision_launches}, text "
                         f"{a_text_launches} (expected 0 and {align.text.layers}); "
                         f"finite {finite}")
    if cos_img.min() < COSINE_MIN or cos_txt.min() < COSINE_MIN:
        failures.append("ALIGN: card and CPU disagree")

    # ... zero-shot over phase 10's 1,024 PNGs through the CLI
    from novic_tpu_torch.data.classification import load_image_dataset_prompts

    img_root = os.path.join(workdir, "noun_data", "images")
    prompts = load_image_dataset_prompts("Imagenette", "clip")
    gap_path = os.path.join(wd, "align_gap.json")
    attention.LAUNCHES = 0
    t0 = time.perf_counter()
    zs = train_main(["action=embedder_zero_shot", "measure_gap=true",
                     f"gap_output_path={gap_path}", f"embedder={ALIGN_SPEC}",
                     "embedder_compute_dtype=bfloat16",
                     f"vocab_path={os.path.join(workdir, 'noun_data', 'vocab.json')}",
                     f"prompt_collection={NOUN_COLLECTION}", "hypernym_collection=None",
                     f"batch_size_embed={NOUN_EMBED_BATCH}", f"batch_size_image={CLS_IMAGE_BATCH}",
                     f"output_dir={wd}/out", f"seed={SEED}", "cls_dataset=Imagenette",
                     f"cls_dataset_root={img_root}", "cls_split=valid", "--device=cuda"])
    torch.cuda.synchronize()
    zs_s = time.perf_counter() - t0
    zs_launches = attention.LAUNCHES
    launches["key_bias"] += zs_launches
    want = align.text.layers * CLS_CLASSES * math.ceil(len(prompts) / NOUN_EMBED_BATCH)
    with open(gap_path) as f:
        gap = json.load(f)
    res = {"top1": zs["Imagenette"], "seconds": zs_s, "images_per_s": CLS_IMAGES / zs_s,
           "k1_launches": zs_launches, "expected_k1_launches": want,
           "angle_mean": gap["angle_mean"], "angle_count": sum(gap["angle_histc"]["counts"]),
           "mean_shift_dims": len(gap["mean_shift"])}
    emit({"phase": "towers_align_zero_shot", **res})
    line["align_zero_shot"] = res
    if (zs_launches != want or res["angle_count"] != CLS_IMAGES
            or res["mean_shift_dims"] != align.vision.embed_dim):
        raise SystemExit(f"ALIGN zero-shot: {zs_launches} K1 launches (expected {want}), "
                         f"{res['angle_count']} angles, {res['mean_shift_dims']} dims")

    # 5. 'test-structured:': its cache, its gap and one mean_shift=true chunk
    sdir = os.path.join(wd, "structured")
    os.makedirs(sdir)
    vocab = make_structured_vocab(STRUCTURED_CLASSES, freq=20, seed=SEED)
    with open(os.path.join(sdir, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    write_structured_cls_dataset(os.path.join(sdir, "cls"), [e["target_noun"] for e in vocab],
                                 STRUCTURED_IMAGES, seed=SEED + 1)
    common = [f"embedder={STRUCTURED_SPEC}", f"vocab_path={sdir}/vocab.json", "prompt_path=",
              "prompt_collection=Basic", "hypernym_collection=None", f"seed={SEED}",
              f"output_dir={sdir}/out", "--device=cuda"]
    cache, sgap = os.path.join(sdir, "multiset.bin"), os.path.join(sdir, "gap.json")
    t0 = time.perf_counter()
    train_main(["action=cache_noun_multiset", f"save_embedding_cache={cache}",
                "multi_target_freq=[2,1]"] + common)
    szs = train_main(["action=embedder_zero_shot", "measure_gap=true", f"gap_output_path={sgap}",
                      "cls_dataset=Food101", f"cls_dataset_root={sdir}/cls", "cls_split=valid",
                      "batch_size_image=128"] + common)
    attention.LAUNCHES = dropout.LAUNCHES = 0
    state, _, _ = train_main(["action=train", f"embedding_dataset={cache}", "mean_shift=true",
                              f"mean_shift_path={sgap}", "chunk_scale=16", "max_chunks=1",
                              "save_every_max=1000000", "save_top1_min=200"]
                             + STRUCTURED_MODEL + common)
    torch.cuda.synchronize()
    with open(glob.glob(os.path.join(sdir, "out", "ovod_*", "metrics.jsonl"))[0]) as f:
        chunk = json.loads(f.readline())
    with open(sgap) as f:
        gap = json.load(f)
    sites = 1 + 4 * 2  # input dropout + 4 per layer x 2 layers, forward and backward
    res = {"spec": STRUCTURED_SPEC, "zero_shot_top1": szs["Food101"],
           "gap_angle_mean": gap["angle_mean"], "steps": state.step,
           "chunk_loss": chunk["chunk_loss"], "dropout_launches": dropout.LAUNCHES,
           "expected_dropout_launches": 2 * sites * state.step,
           "k1_launches": attention.LAUNCHES, "seconds": time.perf_counter() - t0}
    emit({"phase": "towers_structured", **res})
    line["structured"] = res
    if (state.step < 1 or not math.isfinite(chunk["chunk_loss"]) or attention.LAUNCHES
            or dropout.LAUNCHES != res["expected_dropout_launches"]):
        raise SystemExit(f"structured mean-shift chunk: {res}")

    # The phase line: every number above beside the card's name and power limit
    line.update(kernels={case: {key: kl[key] for key in ("shape", "key_bias", "max_abs_err", "ms",
                                                        "plain_ms", "library_ms", "bound_ms",
                                                        "bound_by")}
                         for case, kl in k1.items()},
                masked_tile_exact_zero=masked_tile_exact, k1_launches=launches,
                seconds=time.perf_counter() - phase_t0, failures=failures)
    emit(line)
    if failures:
        raise SystemExit("; ".join(failures))
    return {"k1": k1, "launches": launches, "dropout_launches": res["dropout_launches"]}


# Phase 13: the demo server (16 clients x 8 PNGs, at the demo's default
# max_batch and at 64) and the parallel paths at world size 1 on nccl
DEMO_CLIENTS, DEMO_PER_CLIENT = 16, 8
DEMO_MAX_BATCHES = (8, 64)
DEMO_GENCFG = "beam_k10_vnone_gn_t1_a0"   # the demo server's default
MESH_LOGPROB_ATOL = 1e-5                  # set_mesh vs no mesh (dp, tp at size 1)
DP_STEP_PARAM_ATOL = 1e-6                 # the DP step at world 1 vs the plain step


def png_bytes(frame: np.ndarray) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    return buf.getvalue()


def serve_clients(server, uploads: list, bad: bytes | None = None) -> tuple[list, list, float]:
    """Each client posts its PNGs in turn (one connection a request); `bad`
    goes first from client 0. → (responses per client as (status, json or
    text), per-request ms, wall seconds of the whole round)."""
    import http.client
    from concurrent.futures import ThreadPoolExecutor

    port = server.server_address[1]

    def post(data: bytes):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            t = time.perf_counter()
            conn.request("POST", "/classify", body=data)
            resp = conn.getresponse()
            body = resp.read()
            ms = (time.perf_counter() - t) * 1e3
        finally:
            conn.close()
        return resp.status, (json.loads(body) if resp.status == 200 else body.decode()), ms

    def client(i: int, row: list):
        return [post(d) for d in ([bad] if bad is not None and i == 0 else []) + row]

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(uploads)) as pool:
        results = list(pool.map(client, range(len(uploads)), uploads))
    seconds = time.perf_counter() - t0
    ms = [r[2] for res in results for r in res]
    return [[r[:2] for r in res] for res in results], ms, seconds


def phase_serving_tools(workdir: str, frames: list, nouns: list, name: str, smi: str) -> dict:
    """Phase 13: the demo server in front of NOVICModel (SigLIP-B/16 + FT0,
    the demo's default gencfg) answering 16 concurrent clients x 8 PNGs at
    max_batch 8 and 64, every answer equal to a direct classify_images of its
    image, one undecodable upload answered 400 among them; then set_mesh in
    dp and tp and one data-parallel training step, at world size 1 on nccl."""
    import io
    import threading

    import torch.distributed as dist
    from PIL import Image

    from novic_tpu_torch.bridge import adamw_state_from_leaves, decoder_from_numpy
    from novic_tpu_torch.data.noise import EmbeddingNoise
    from novic_tpu_torch.infer import NOVICModel
    from novic_tpu_torch.ops import attention, dropout
    from novic_tpu_torch.parallel.mesh import create_mesh
    from novic_tpu_torch.text.simple import make_test_tokenizer
    from novic_tpu_torch.tools.demo_server import create_server
    from novic_tpu_torch.train.checkpoint import load_checkpoint
    from novic_tpu_torch.train.optim import create_optimizer
    from novic_tpu_torch.train.step import TrainRng, TrainState, make_train_step

    phase_t0 = time.perf_counter()
    n_img = DEMO_CLIENTS * DEMO_PER_CLIENT
    pngs = [png_bytes(f) for f in frames[:n_img]]
    pil = [Image.open(io.BytesIO(d)).convert("RGB") for d in pngs]
    uploads = [pngs[c * DEMO_PER_CLIENT:(c + 1) * DEMO_PER_CLIENT] for c in range(DEMO_CLIENTS)]
    kw = dict(embedder_spec=SPEC, gencfg=DEMO_GENCFG, device="cuda",
              embedder_kwargs={"tokenizer": make_test_tokenizer(nouns), "seed": SEED})
    line = {"phase": "serving_tools", "device": name, "nvidia_smi": smi, "clients": DEMO_CLIENTS,
            "pngs_per_client": DEMO_PER_CLIENT, "gencfg": DEMO_GENCFG, "runs": {}}
    k1_launches = 0
    for max_batch in DEMO_MAX_BATCHES:
        # The demo's main(): the model batch is max_batch
        with NOVICModel(FT0, batch_size=max_batch, **kw) as model:
            direct = model.classify_images(pil)
            server = create_server(model, host="127.0.0.1", port=0, max_batch=max_batch)
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            try:
                serve_clients(server, [uploads[0][:1]])  # warm-up: the first request
                batcher = server.RequestHandlerClass.state.batcher
                batcher.batches_run = batcher.requests_served = batcher.max_group = 0
                attention.LAUNCHES = dropout.LAUNCHES = 0
                bad = b"\x89PNG\r\n\x1a\n" + b"\0" * 64 if max_batch == DEMO_MAX_BATCHES[0] else None
                results, ms, seconds = serve_clients(server, uploads, bad=bad)
                torch.cuda.synchronize()
                launches = attention.LAUNCHES
            finally:
                server.shutdown()
                server.server_close()
                thread.join(60)
        if bad is not None:
            status, text = results[0].pop(0)
            if status != 400:
                raise SystemExit(f"demo server: an undecodable upload got {status}, not 400")
        mismatched = []
        for c, res in enumerate(results):
            for j, (status, out) in enumerate(res):
                i = c * DEMO_PER_CLIENT + j
                if status != 200:
                    raise SystemExit(f"demo server: request {i} got {status}: {out}")
                if out["preds"] != [direct.preds[i]] or out["gencfg"] != DEMO_GENCFG:
                    mismatched.append(i)
        if mismatched:
            raise SystemExit(f"demo server: responses {mismatched[:8]} differ from a direct "
                             f"classify_images of their images")
        if launches != 12 * batcher.batches_run or dropout.LAUNCHES:
            raise SystemExit(f"demo server: {launches} K1 launches for {batcher.batches_run} "
                             f"groups (12 a tower forward expected), {dropout.LAUNCHES} dropout")
        k1_launches += launches
        served = batcher.requests_served
        line["runs"][f"max_batch_{max_batch}"] = {
            "images": n_img, "served_images_per_s": n_img / seconds, "seconds": seconds,
            "groups": batcher.batches_run, "mean_group": served / max(batcher.batches_run, 1),
            "largest_group": batcher.max_group, "p50_request_ms": float(np.percentile(ms, 50)),
            "p95_request_ms": float(np.percentile(ms, 95)), "k1_launches": launches,
            "bad_upload_status": 400 if bad is not None else None}
        emit({"phase": "serving_tools_run", "max_batch": max_batch, "device": name,
              "nvidia_smi": smi, **line["runs"][f"max_batch_{max_batch}"]})

    # The parallel paths at world size 1 on nccl (one card: no multi-card run)
    store = os.path.join(workdir, "dist_store")
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        frames64 = frames[:BATCH]
        with NOVICModel(FT0, batch_size=BATCH, **kw) as model:
            ref = model.classify_images(frames64)
            attention.LAUNCHES = 0
            model.set_mesh(create_mesh(device="cuda"))
            dp = model.classify_images(frames64)
            dp_launches = attention.LAUNCHES
            model.set_mesh(None)
            attention.LAUNCHES = 0
            model.embedder.set_mesh(create_mesh(axis_names=("model",), device="cuda"), "tp")
            tp = model.classify_images(frames64)
            tp_launches = attention.LAUNCHES
        mesh_check = {}
        for mode, out in (("dp", dp), ("tp", tp)):
            err = float(np.abs(np.array(out.logprobs) - np.array(ref.logprobs)).max())
            mesh_check[mode] = {"preds_equal": out.preds == ref.preds, "logprob_max_abs_err": err}
            if out.preds != ref.preds or err > MESH_LOGPROB_ATOL:
                raise SystemExit(f"set_mesh {mode}: {mesh_check[mode]} against no mesh")
        if dp_launches != 12 or tp_launches != 12:
            raise SystemExit(f"set_mesh: K1 launched {dp_launches} (dp) / {tp_launches} (tp) "
                             f"times for one batch, expected 12")
        k1_launches += dp_launches + tp_launches

        # One DP step at world 1 from phase 7's checkpoint and recipe, against the plain step
        path = sorted(glob.glob(os.path.join(workdir, "outputs", "ovod_*", "*.npz")))[-1]
        ck = load_checkpoint(path)
        cf = ck["cfg_flat"]
        batch = to_device(step_batch(ck, TRAIN_BATCH * TRAIN_ACCUM, SEED + 5), "cuda")
        noise = EmbeddingNoise.create(cf["noise_scheme"], embed_dim=ck["model_config"].embed_dim,
                                      vec_norm=cf["noise_vec_norm"], angle_min=cf["noise_angle_min"],
                                      angle_max=cf["noise_angle_max"], mix_ratio=cf["noise_mix_ratio"])
        steps = {}
        for label, mesh in (("plain", None), ("dp", create_mesh(device="cuda"))):
            model = decoder_from_numpy(ck["model_config"], ck["params"]).to("cuda")
            opt = create_optimizer(model.named_parameters(), weight_decay=cf["weight_decay"])
            adamw_state_from_leaves(model, opt, ck["opt_arrays"])
            step = make_train_step(TrainState(model=model, optimizer=opt), noise=noise,
                                   gradient_clip=1.0, accum_steps=TRAIN_ACCUM, mesh=mesh)
            dropout.LAUNCHES = 0
            m = step(batch, float(cf["init_lr"]), TrainRng.create(SEED, "cuda")).fetch()
            torch.cuda.synchronize()
            steps[label] = (m, {n: p.detach().clone() for n, p in model.named_parameters()},
                            dropout.LAUNCHES)
        (mp_, pp, _), (md, pd, dp_drop) = steps["plain"], steps["dp"]
        param_err = max((pd[n] - pp[n]).abs().max().item() for n in pp)
        dp_step = {"rows": TRAIN_BATCH * TRAIN_ACCUM, "accum": TRAIN_ACCUM,
                   "loss_plain": float(mp_["loss_sum"] / mp_["loss_basis"]),
                   "loss_dp": float(md["loss_sum"] / md["loss_basis"]),
                   "grad_norm_plain": float(mp_["grad_norm"]), "grad_norm_dp": float(md["grad_norm"]),
                   "param_max_abs_diff": param_err, "tol": DP_STEP_PARAM_ATOL,
                   "dropout_launches": dp_drop}
        if param_err > DP_STEP_PARAM_ATOL or dp_drop != TRAIN_ACCUM * 2 * DROPOUT_SITES:
            raise SystemExit(f"the DP step at world 1 differs from the plain step: {dp_step}")
    finally:
        dist.destroy_process_group()
    print("multi-card: not run (1 device)", flush=True)
    line.update({"mesh_world_size": 1, "backend": "nccl", "set_mesh": mesh_check,
                 "dp_train_step": dp_step, "k1_launches": k1_launches,
                 "dropout_launches": dp_drop, "multi_card": "not run (1 device)",
                 "seconds": time.perf_counter() - phase_t0})
    emit(line)
    return line


ORBAX_ATOL = REFERENCE_ATOL   # resumed and served from .orbax vs .npz (phase 9's bar)
ORBAX_FIXTURE = os.path.join(REPO, "tests", "data", "orbax_small.orbax")


def _dtype_name(a: np.ndarray) -> str:
    """bfloat16 for ml_dtypes' and for the V2 an .npz gives it back as."""
    return "bfloat16" if a.dtype.name == "bfloat16" or a.dtype.str.endswith("V2") else a.dtype.str


def checkpoint_differences(a: dict, b: dict) -> list[str]:
    """Arrays (params and optimizer leaves) of two loaded checkpoints that
    differ in shape, dtype or any bit."""
    from novic_tpu_torch.utils.misc import flatten_dict

    pa, pb = flatten_dict(a["params"]), flatten_dict(b["params"])
    oa, ob = list(a["opt_arrays"] or []), list(b["opt_arrays"] or [])
    if sorted(pa) != sorted(pb) or len(oa) != len(ob):
        return ["the array names or counts"]
    pairs = [(f"params.{k}", pa[k], pb[k]) for k in pa] + [
        (f"opt.{i}", x, y) for i, (x, y) in enumerate(zip(oa, ob))]
    return [k for k, x, y in pairs if x.shape != y.shape or _dtype_name(x) != _dtype_name(y)
            or x.tobytes() != y.tobytes()]


def phase_orbax(workdir: str, frames: list, nouns: list, name: str, smi: str) -> dict:
    """Phase 14: orbax checkpoints at full width without orbax, tensorstore or
    zstandard. Phase 7's FT0 checkpoint saved as an .orbax directory (its
    cfg_flat naming SPEC) and read back, bit for bit as the .npz; one chunk
    resumed from it with checkpoint_format=orbax against the same chunk from
    the .npz (K3'); phase 4's 2 x 64 frames served from the directory with the
    spec from its novic_meta.json, and from the resumed chunk's .orbax,
    against the .npz (K1); the committed fixture that real orbax wrote read
    bit for bit as its .npz twin."""
    import importlib.util

    from novic_tpu_torch.cli.train import main as train_main
    from novic_tpu_torch.infer import NOVICModel
    from novic_tpu_torch.ops import attention, build, dropout
    from novic_tpu_torch.text.simple import make_test_tokenizer
    from novic_tpu_torch.train import zstd
    from novic_tpu_torch.train.checkpoint import (load_checkpoint, save_checkpoint,
                                                  save_checkpoint_orbax)
    from novic_tpu_torch.utils.misc import flatten_dict

    phase_t0 = time.perf_counter()
    attention.LAUNCHES = dropout.LAUNCHES = 0
    line = {"phase": "orbax", "device": name, "nvidia_smi": smi,
            "zstandard_installed": importlib.util.find_spec("zstandard") is not None,
            "orbax_installed": importlib.util.find_spec("orbax") is not None}
    t0 = time.perf_counter()
    build.build_host(zstd.SOURCE, force=True)
    line["codec_build_s"] = time.perf_counter() - t0
    odir = os.path.join(workdir, "orbax")
    os.makedirs(odir)

    # 1. Phase 7's checkpoint saved as an .orbax directory and read back; the
    # .npz format beside it (the file cache is warm for every read)
    base = sorted(glob.glob(os.path.join(workdir, "outputs", "ovod_*", "*.npz")))[-1]
    t0 = time.perf_counter()
    bck = load_checkpoint(base)
    npz_load_s = time.perf_counter() - t0
    chunk = bck["train_meta"]["loop_state"]["chunk_id"]
    kw = dict(params=bck["params"], model_config=bck["model_config"],
              target_config=bck["target_config"], data_config=bck["data_config"],
              target_nouns=bck["target_nouns"],
              num_invalid_target_nouns=bck["num_invalid_target_nouns"],
              opt_state_arrays=bck["opt_arrays"], train_meta=bck["train_meta"],
              cfg_flat={**bck["cfg_flat"], "embedder": SPEC})
    path = os.path.join(odir, f"ovod_chunk{chunk - 1:04d}_ft0.orbax")
    # The .orbax save flushes its data file and manifest to disk (os.fsync) and
    # the .npz save does not: the fsyncs are timed apart, and the .npz is
    # flushed after its save, so that the two compare like for like
    fsync_s, real_fsync = [], os.fsync

    def timed_fsync(fd):
        t = time.perf_counter()
        real_fsync(fd)
        fsync_s.append(time.perf_counter() - t)

    os.fsync = timed_fsync
    try:
        t0 = time.perf_counter()
        save_checkpoint_orbax(path, **kw)
        save_s = time.perf_counter() - t0
    finally:
        os.fsync = real_fsync
    t0 = time.perf_counter()
    ock = load_checkpoint(path)
    load_s = time.perf_counter() - t0
    twin = os.path.join(odir, "twin.npz")
    t0 = time.perf_counter()
    save_checkpoint(twin, **kw)
    npz_save_s = time.perf_counter() - t0
    with open(twin, "rb+") as f:
        t0 = time.perf_counter()
        os.fsync(f.fileno())
        npz_fsync_s = time.perf_counter() - t0
    nbytes = (sum(a.nbytes for a in flatten_dict(bck["params"]).values())
              + sum(a.nbytes for a in bck["opt_arrays"]))
    dir_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
    differ = checkpoint_differences(ock, bck)
    meta_equal = ({k: v for k, v in ock["meta"].items() if k not in ("saved_unix_time", "cfg_flat")}
                  == {k: v for k, v in bck["meta"].items()
                      if k not in ("saved_unix_time", "cfg_flat")}
                  and ock["cfg_flat"] == kw["cfg_flat"])
    line.update(checkpoint={
        "arrays": len(flatten_dict(bck["params"])) + len(bck["opt_arrays"]),
        "params": sum(a.size for a in flatten_dict(bck["params"]).values()),
        "array_mb": nbytes / 1e6, "dir_mb": dir_bytes / 1e6,
        "save_s": save_s, "save_mb_per_s": nbytes / 1e6 / save_s,
        "save_fsync_s": fsync_s, "save_without_fsync_s": save_s - sum(fsync_s),
        "load_s": load_s, "load_mb_per_s": nbytes / 1e6 / load_s,
        "npz_save_s": npz_save_s, "npz_fsync_s": npz_fsync_s,
        "npz_load_s": npz_load_s, "file_cache": "warm",
        "arrays_differing": differ, "meta_equal": meta_equal})
    if differ or not meta_equal:
        raise SystemExit(f"the .orbax directory reads back other arrays or meta: {differ}, "
                         f"meta equal {meta_equal}")

    # 2. One chunk resumed from the directory (checkpoint_format=orbax) and from
    # the .npz, at phase 7's recipe with K3' on
    resumed = {}
    for label, src, fmt in (("orbax", path, "orbax"), ("npz", base, "npz")):
        drops = dropout.LAUNCHES
        t0 = time.perf_counter()
        state, S, _ = train_main(ft0_train_args(
            workdir, f"orbax_resume_{label}", f"load_model={src}", f"max_chunks={chunk}",
            "save_every_max=1", f"checkpoint_format={fmt}"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        saved = sorted(glob.glob(os.path.join(workdir, f"orbax_resume_{label}", "ovod_*",
                                              f"*.{fmt}")))[-1]
        with open(os.path.join(os.path.dirname(saved), "metrics.jsonl")) as f:
            metrics = [json.loads(x) for x in f]
        live = {n: p.detach().cpu().numpy() for n, p in state.model.named_parameters()}
        written = flatten_dict(load_checkpoint(saved)["params"])
        resumed[label] = dict(step=state.step, chunk=S.chunk_id, seconds=seconds, path=saved,
                              losses=[(m["chunk_loss"], m["loss"]) for m in metrics],
                              params=live, written_equal=all(
                                  np.array_equal(written[n], live[n]) for n in live),
                              dropout_launches=dropout.LAUNCHES - drops)
    ro, rn = resumed["orbax"], resumed["npz"]
    loss_diff = max(abs(a - b) for x, y in zip(ro["losses"], rn["losses"]) for a, b in zip(x, y))
    param_diff = max(float(np.abs(ro["params"][n] - rn["params"][n]).max()) for n in rn["params"])
    line.update(resume_chunk=chunk, resume_steps=ro["step"], resume_losses=ro["losses"],
                resume_loss_max_abs_diff=loss_diff, resume_param_max_abs_diff=param_diff,
                resume_s={k: r["seconds"] for k, r in resumed.items()},
                resume_saved=os.path.basename(ro["path"]),
                resume_dropout_launches=[ro["dropout_launches"], rn["dropout_launches"]])
    if (ro["step"], ro["chunk"]) != (rn["step"], rn["chunk"]) or ro["chunk"] != chunk + 1 \
            or len(ro["losses"]) != 1 or len(rn["losses"]) != 1:
        raise SystemExit(f"the resumed runs differ in steps or chunks: {ro['step']}/{ro['chunk']} "
                         f"vs {rn['step']}/{rn['chunk']} (chunk {chunk})")
    if loss_diff > ORBAX_ATOL or param_diff > ORBAX_ATOL:
        raise SystemExit(f"resume from .orbax vs .npz: losses {loss_diff}, params {param_diff}")
    if not (ro["path"].endswith(".orbax") and os.path.isdir(ro["path"]) and ro["written_equal"]
            and rn["written_equal"]):
        raise SystemExit(f"the resumed chunk's checkpoint: {ro['path']}, written equal "
                         f"{ro['written_equal']} / {rn['written_equal']}")
    new_steps = {label: r["dropout_launches"] // (DROPOUT_SITES * 2 * TRAIN_ACCUM)
                 for label, r in resumed.items()}
    for label, r in resumed.items():
        if not r["dropout_launches"] or r["dropout_launches"] % (DROPOUT_SITES * 2 * TRAIN_ACCUM):
            raise SystemExit(f"{label}: the resumed chunk launched dropout "
                             f"{r['dropout_launches']} times")
    line["resume_new_steps"] = new_steps

    # 3. Serving: the directory (spec from its novic_meta.json) and the resumed
    # chunk's directory, each against its .npz, over phase 4's frames
    ekw = {"tokenizer": make_test_tokenizer(nouns), "seed": SEED}
    gencfg = "beam_k10_vnone_gn_t1_a0"
    forwards = math.ceil(len(frames) / BATCH)
    if NOVICModel._peek_embedder_spec(path) != SPEC:
        raise SystemExit(f"{path}: novic_meta.json names {NOVICModel._peek_embedder_spec(path)}")
    served, k1 = {}, {}
    for label, src, spec in (("orbax", path, None), ("npz", base, SPEC),
                             ("resumed_orbax", ro["path"], SPEC),
                             ("resumed_npz", rn["path"], SPEC)):
        with NOVICModel(src, embedder_spec=spec, embedder_kwargs=ekw, gencfg=gencfg,
                        batch_size=BATCH, device="cuda") as model:
            if model.embedder.spec != SPEC:
                raise SystemExit(f"{label}: served with {model.embedder.spec}")
            before = attention.LAUNCHES
            t0 = time.perf_counter()
            out = model.classify_images(frames)
            torch.cuda.synchronize()
            served[label] = (out, time.perf_counter() - t0)
            k1[label] = attention.LAUNCHES - before
        check_output(out, len(frames), None)
        if k1[label] != 12 * forwards:
            raise SystemExit(f"{label}: fused_attention launched {k1[label]} times, expected "
                             f"{12 * forwards}")
    serve = {}
    for a, b in (("orbax", "npz"), ("resumed_orbax", "resumed_npz")):
        oa, ob = served[a][0], served[b][0]
        serve[a] = {"labels_equal": oa.preds == ob.preds,
                    "logprob_max_abs_diff": float(np.abs(np.asarray(oa.logprobs)
                                                         - np.asarray(ob.logprobs)).max())}
    line.update(images=len(frames), serve=serve, serve_s={k: v[1] for k, v in served.items()},
                labels=[r[:3] for r in served["orbax"][0].preds[:2]], k1_by_step=k1)
    bad = {k: v for k, v in serve.items()
           if not v["labels_equal"] or v["logprob_max_abs_diff"] > ORBAX_ATOL}
    if bad:
        raise SystemExit(f".orbax and .npz serve apart: {bad}")

    # 4. The committed fixture: real orbax bytes (zstd-compressed chunks, a
    # per-process store), read by the port's own codec
    t0 = time.perf_counter()
    fx, twin = load_checkpoint(ORBAX_FIXTURE), load_checkpoint(ORBAX_FIXTURE[:-6] + ".npz")
    fx_differ = checkpoint_differences(fx, twin)
    line.update(fixture={"arrays": len(flatten_dict(fx["params"])) + len(fx["opt_arrays"]),
                         "arrays_differing": fx_differ, "load_s": time.perf_counter() - t0})
    if fx_differ or fx["cfg_flat"] != twin["cfg_flat"]:
        raise SystemExit(f"the orbax fixture differs from its .npz twin: {fx_differ}")
    line.update(k1_launches=attention.LAUNCHES, dropout_launches=dropout.LAUNCHES,
                seconds=time.perf_counter() - phase_t0)
    emit(line)
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from novic_tpu_torch.infer import NOVICModel
    from novic_tpu_torch.ops import (attention, attention_bf16, beam_reorder, build, dropout,
                                     flash_attention, int8_matmul, layer_norm, tiled_matmul)
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
               attention_bf16.SOURCE, tiled_matmul.SOURCE, flash_attention.SOURCE,
               flash_attention.BWD_SOURCE, layer_norm.SOURCE]
    libs = build.build_all(sources, force=True)
    # The Hopper designs (wgmma, TMA, mbarriers) are what was built
    hopper = (attention.SOURCE, attention_bf16.SOURCE, flash_attention.SOURCE,
              flash_attention.BWD_SOURCE, tiled_matmul.SOURCE, int8_matmul.SOURCE)
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
    for s in (attention.SOURCE, flash_attention.SOURCE, flash_attention.BWD_SOURCE,
              tiled_matmul.SOURCE, int8_matmul.SOURCE):
        bad = [line for line in ptxas[s.name] if "Potential Performance Loss" in line
               or ("spill" in line and " 0 bytes spill stores" not in line)]
        if bad:
            raise SystemExit(f"{s.name}: ptxas reports {bad[:3]}")

    # 3. kernels vs plain
    k1, k1_dfn5b, k1_text = phase_kernel(attention)
    k3 = phase_dropout(dropout)
    k2, x4, k2_mma_sync = phase_int8(int8_matmul)
    x5, x5_many = phase_beam_reorder(beam_reorder)
    x12 = phase_attention_bf16(attention_bf16, k1_dfn5b)
    x3, x3_transpose = phase_tiled_matmul(tiled_matmul)
    x6 = phase_flash_attention(flash_attention, attention_bf16)
    x6b = phase_flash_attention_bwd(flash_attention)
    ln = phase_layer_norm(layer_norm)

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
    launches = ln_launches = 0
    with model:
        tower_forwards = math.ceil(len(frames) / BATCH)
        runs = {}
        for label, gencfg in (("unguided", None), ("guided", guided_cfg)):
            attention.LAUNCHES = dropout.LAUNCHES = layer_norm.LAUNCHES = 0
            t0 = time.perf_counter()
            out = model.classify_images(frames, gencfg=gencfg)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = attention.LAUNCHES
            ln_launches += layer_norm.LAUNCHES
            if layer_norm.LAUNCHES != SIGLIP_LN_PER_FORWARD * tower_forwards:
                raise SystemExit(f"{label}: layer_norm launched {layer_norm.LAUNCHES} times, "
                                 f"expected {SIGLIP_LN_PER_FORWARD * tower_forwards} "
                                 f"({SIGLIP_LN_PER_FORWARD} per tower forward)")
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
                  "layer_norm_launches": layer_norm.LAUNCHES,
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
        # 4h. the gradient path through the attn_variants tower (X6, X6b)
        grad_line = phase_attn_variants_grad(name, smi)

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
                                  match=("beam_reorder_kernel",),
                                  require=("beam_reorder_kernel",) * (mode == "reorder"))
            matched = prof.pop("matched_kernels")
            x5_ms = sum(m[1] for m in matched)
            emit({"phase": "profile_decode", "mode": mode, "device": name, "batch": BATCH, **prof,
                  "x5_device_ms": x5_ms, "x5_kernels": sum(m[2] for m in matched),
                  "x5_share_of_device_busy": x5_ms / prof["device_busy_ms"]})

    # all_decode: exhaustive scoring at the full guide set
    all_line = phase_all_decode(ck, nouns, frames, name, smi)

    # 7. training path, 8. card vs CPU for one step
    workdir = tempfile.mkdtemp(prefix="novic_chip_smoke_")
    try:
        train_line = phase_train(workdir, nouns, ck, name, smi)
        phase_train_card_vs_cpu(workdir)
        # 9. released-weight interop: conversion, reference checkpoints, AdamP
        ref_line = phase_reference(workdir, ck, nouns, frames, name, smi)
        # 10. the noun dataset, the cache writers and training from text
        noun_line = phase_noun_data(workdir, os.path.join(workdir, "reference", "siglip_b16.npz"),
                                    list(nouns), name, smi)
        # 11. the evaluation, inference and results actions
        eval_line = phase_eval(workdir, os.path.join(workdir, "reference", "siglip_b16.npz"),
                               list(nouns), name, smi)
        # 12. the EVA02, CLIPA and ALIGN towers and the structured test embedder
        towers = phase_towers(workdir, frames, list(nouns), name, smi)
        # 13. the demo server; set_mesh and the DP train step at world size 1
        serving = phase_serving_tools(workdir, frames, list(nouns), name, smi)
        # 14. orbax checkpoints: phase 7's saved, read, resumed and served
        orbax_line = phase_orbax(workdir, frames, list(nouns), name, smi)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # Kernels line, then the result
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "fused_attention", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/attention.cu",
        "replaces": "novic_tpu/ops/attention.py:71",
        "launches": launches,
        "launches_by_phase": {"main_path": launches,
                              "all_decode": all_line["fused_attention_launches"],
                              "reference": ref_line["fused_attention_launches"],
                              "noun_data": noun_line["k1_launches"],
                              "eval": eval_line["k1_launches"],
                              "towers": sum(towers["launches"].values()),
                              "serving_tools": serving["k1_launches"],
                              "orbax": orbax_line["k1_launches"]},
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}, {
        "name": "dropout", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/dropout.cu",
        "replaces": "novic_tpu/ops/dropout.py:103",
        "launches": train_line["dropout_launches"],
        "launches_by_phase": {"train": train_line["dropout_launches"],
                              "reference": ref_line["dropout_launches"],
                              "noun_data": noun_line["dropout_launches"],
                              "eval": eval_line["dropout_launches"],
                              "towers": towers["dropout_launches"],
                              "serving_tools": serving["dropout_launches"],
                              "orbax": orbax_line["dropout_launches"]},
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": k3["library_ms"]}, {
        # Replaces no TPU kernel: XLA fused the JAX package's LayerNorm. Times
        # at the SigLIP-B/16 serving shape (phase 3h also times EVA02-L's mlp_norm)
        "name": "layer_norm", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/layer_norm.cu", "replaces": None,
        "launches": ln_launches, "launches_by_phase": {"main_path": ln_launches},
        "max_abs_err": ln["worst"]["max_abs_err_f32"], "ms": ln["siglip_b16"]["ms"],
        "plain_ms": ln["siglip_b16"]["plain_ms"], "bound_ms": ln["siglip_b16"]["bound_ms"],
        "bound_by": ln["siglip_b16"]["bound_by"], "library_ms": ln["siglip_b16"]["library_ms"]}, {
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
        "bound_by": k1_dfn5b["bound_by"], "library_ms": k1_dfn5b["library_ms"]}, {
        # The SigLIP text tower's shape in the noun cache (noun_data phase)
        "name": "fused_attention_noun_text", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/attention.cu",
        "replaces": "novic_tpu/ops/attention.py:71",
        "launches": noun_line["k1_launches_by_step"]["cache_noun_dataset"],
        "max_abs_err": k1_text["max_abs_err"], "ms": k1_text["ms"],
        "plain_ms": k1_text["plain_ms"], "bound_ms": k1_text["bound_ms"],
        "bound_by": k1_text["bound_by"], "library_ms": k1_text["library_ms"]}] + [{
        # Phase 12's shapes: the EVA02-L and CLIPA-L vision towers (hd 64, 257
        # tokens), EVA02-E's (hd 112) and ALIGN's BERT with its (B, S) key bias
        "name": f"fused_attention_{case}", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/attention.cu",
        "replaces": "novic_tpu/ops/attention.py:71", "launches": towers["launches"][case],
        "max_abs_err": kl["max_abs_err"], "ms": kl["ms"], "plain_ms": kl["plain_ms"],
        "bound_ms": kl["bound_ms"], "bound_by": kl["bound_by"], "library_ms": kl["library_ms"]}
        for case, kl in towers["k1"].items()] + [{
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
        # X6b at the attn_variants tower's shape, launched by its gradient (4h)
        "name": f"flash_attention_bwd_{kern}", "route": "cuda",
        "source": "novic_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "replaces": FLASH_BWD_REPLACES[kern], "launches": grad_line["launches"][kern],
        "max_abs_err": max(x6b["attn_variants"]["grads"][g]["max_abs_err"]
                           for g in (("dk", "dv") if kern == "dkv" else ("dq",))),
        "ms": x6b["attn_variants"][kern]["ms"], "plain_ms": x6b["attn_variants"]["plain_ms"],
        "bound_ms": x6b["attn_variants"][kern]["bound_ms"],
        "bound_by": x6b["attn_variants"][kern]["bound_by"],
        "library_ms": x6b["attn_variants"]["library_ms"]} for kern in ("dkv", "dq")] + [{
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
