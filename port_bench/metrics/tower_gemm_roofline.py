"""The tower's bf16 GEMMs' share of the bf16 peak in the traced segment:
the FLOP of the tower's bf16 products (the patch embedding and each
block's q, k, v, out, fc1 and fc2; not the float32 projection, nor the
attention's S x S products, which K1 computes) for the traced batches at
989 TFLOP/s, over the device time of cuBLAS's bf16 GEMM kernels by name in
the profile (%). No reading unless the program's `tower.dense` counter
reads, a batch, the products counted here (one GEMM a call)."""

from port_bench import bounds, program_spans
from port_bench.harness import family_module

# cuBLAS's bf16 GEMM kernels by name (the tower's torch.mm with a float32
# out_dtype), as the H100's profile of a DFN5B forward at B=64 names them:
# nvjet_tss_256x128_* (q, k, v, out, fc2), nvjet_tss_192x192_* (fc1) and
# cutlass_80_tensorop_s16816gemm_bf16_* (the patch embedding, K = 588), 193
# kernels for 193 calls; the float32 projection's and the decoder's GEMMs
# (sm80_xmma_gemm_f32f32, cutlass_80_simt_sgemm, splitKreduce) match neither.
# The reduced trace keeps seconds by name, not launches, so the reader holds
# the program's count of calls, not of kernels, to the products it counts.
GEMM_KERNELS = ("nvjet_", "gemm_bf16")


def tower_gemm_flops(t: dict) -> tuple[int, int]:
    """(products, FLOP) of one image's bf16 GEMMs, from its family's
    parameter shapes: the patch embedding over the G x G patches and each
    block's matrices over the S tokens, two FLOP per multiply-add."""
    shapes = family_module(t, bounds.ROOT).shapes(t)
    G, S = t["image_size"] // t["patch_size"], bounds.tower_tokens(t)
    out, k = shapes["patch_weight"]
    products, flop = 1, 2 * G * G * out * k
    for name, shape in shapes.items():
        if name.startswith("blocks_") and len(shape) == 2:
            products += 1
            flop += 2 * S * shape[0] * shape[1]
    return products, flop


def read(run, name):
    tr = run.traced
    towers = [s for s in run.spans if s["name"] == "tower" and s["phase"] == "traced"]
    if tr is None or not towers:
        return None
    products, flop = tower_gemm_flops(run.config["tower"])
    if program_spans.counter_per(run, "tower.dense", "embed") != products:
        return None
    gemm_s = sum(sec for n, sec in tr["kernels"] if any(k in n for k in GEMM_KERNELS))
    images = sum(s["images"] for s in towers)
    return 100.0 * images * flop / bounds.BF16_FLOP_PER_S / gemm_s if gemm_s > 0 else None
