// Tower self-attention for Hopper (sm_90a): softmax(q.k^T / sqrt(hd) + bias).v
//
// Replaces the Pallas kernel novic_tpu/ops/attention.py `fused_attention`
// (bodies `_attention_kernel` and `_attention_kernel_bias`) and computes what it
// computes, rounding where it rounds:
//   * q is scaled in float32, then rounded to bf16; k and v are rounded to bf16;
//   * scores q.k^T accumulate in float32, the optional (S, S) bias is added in
//     float32, and the softmax is float32: exp(s - max) / sum;
//   * the NORMALISED probabilities are rounded to bf16, and P.v accumulates in
//     float32. The output is float32.
// It does not copy the TPU block structure: S is not padded to 128 and hd is not
// padded to 128 (those were TPU lane rules). The ragged key tail is masked here,
// and hd is zero-padded only to the tensor-core depth of 16.
//
// Layout: q, k, v, o are (B, S, H, hd) float32, contiguous; bias is (S, S)
// float32 or null. Any S >= 1, any hd <= 128 that is a multiple of 8.
//
// Design: one block of 8 warps per (batch, head, tile of 128 queries); each
// warp owns 16 query rows and keeps them in mma.sync m16n8k16 bf16 fragments.
// The block walks the keys in tiles of 64 (k, v rounded to bf16 into shared
// memory), 16 keys per step, twice: pass 1 keeps, per thread, the running max
// of its scores and their sum of exps rescaled to it, and merges the four
// threads of each row at the end; pass 2 forms the normalised
// P = exp(s - max) / sum, rounds it to bf16 in registers (the score
// accumulator layout is the A-operand layout of the next mma) and accumulates
// P.v. Recomputing q.k^T on the tensor cores is cheaper than keeping score
// rows, and P is normalised before it is rounded, as in the TPU kernel.
// Working on 16 keys at a time keeps the registers at or under 128 for
// hd <= 80, so two blocks fit on an SM.
//
// Tolerance: products of bf16 values are exact in float32; the sums run in
// another order than the plain version's, so a row sum can differ in its last
// bit and move the bf16 rounding of a p by one ulp (<= 2^-7 p): an output then
// differs by at most 2^-7 * max|v| over the keys (chip_smoke.py checks this
// bound, and the relative Frobenius error).
//
// Bound on the H100 at SigLIP-B/16 (B=64, S=196, H=12, hd=64): q, k, v and o
// in float32 are 4 x 64*196*768*4 B = 154 MB per launch, ~46 us at 3.35 TB/s;
// the work is ~7.6 GFLOP, ~8 us at the bf16 tensor-core peak. So the launch is
// memory-bound while its I/O is float32. This version re-reads k twice and v
// once per query tile (from L2), converts them to bf16 on the way into shared
// memory, and uses mma.sync, not wgmma/TMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQTile = 16 * kWarps;  // queries per block
constexpr int kKTile = 64;           // keys per shared-memory tile
constexpr int kMaxHd = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + kKTile) of `src` (f32, row stride `stride`) as bf16 into `dst`
// (row stride LD). Rows at or past S and columns at or past hd are zero. The
// trip count is a compile-time constant, so every thread's loads are issued
// before the first one is waited for.
template <int HDP, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const float* src, int r0, int S,
                                          size_t stride, int hd) {
  constexpr int kQuads = HDP / 4;  // float4 per row
  constexpr int kIters = kKTile * kQuads / kThreads;
  static_assert(kKTile * kQuads % kThreads == 0, "tile quads must split evenly over threads");
  float4 x[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kQuads, c = 4 * (i % kQuads);
    x[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S && c < hd) x[it] = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * stride + c);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kQuads, c = 4 * (i % kQuads);
    *reinterpret_cast<uint2*>(dst + r * LD + c) =
        make_uint2(pack_bf16(x[it].x, x[it].y), pack_bf16(x[it].z, x[it].w));
  }
}

// Scores of one warp's 16 rows against 16 keys [key0, key0 + 16) of the tile in
// `ks` (two m16n8 accumulators; element j of sc[t] is row (j < 2 ? row0 : row1),
// key key0 + t*8 + 2c + (j & 1)). Keys at or past S are -inf; the bias is added.
template <int KSTEPS, int LD>
__device__ __forceinline__ void score_chunk(float (&sc)[2][4], const uint32_t (&qa)[KSTEPS][4],
                                            const __nv_bfloat16* ks, int local0, int key0,
                                            int S, const float* bias, int row0, int row1,
                                            int g, int c) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[t][j] = 0.f;
    const __nv_bfloat16* kr = ks + (local0 + t * 8 + g) * LD + 2 * c;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + s * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + s * 16 + 8);
      mma_bf16(sc[t], qa[s][0], qa[s][1], qa[s][2], qa[s][3], b0, b1);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + t * 8 + 2 * c + (j & 1);
      const int r = j < 2 ? row0 : row1;
      if (key >= S) {
        sc[t][j] = -INFINITY;
      } else if (bias != nullptr && r < S) {
        sc[t][j] += bias[(size_t)r * S + key];
      }
    }
  }
}

template <int KSTEPS>  // KSTEPS = padded hd / 16
__global__ void __launch_bounds__(kThreads, 2)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, int S, int H, int hd, float scale) {
  constexpr int HDP = 16 * KSTEPS;
  constexpr int LD = HDP + 8;  // bf16 row stride: conflict-free fragment loads
  constexpr int DTILES = HDP / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kKTile * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kKTile * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;  // mma group (row) and thread-in-group
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t stride = (size_t)H * hd;
  const size_t base = (size_t)b * S * stride + (size_t)h * hd;
  const int row0 = blockIdx.x * kQTile + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;

  // q fragments (A operand, 16 rows x HDP): scaled in float32, rounded to bf16
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (j & 1) ? row1 : row0;
      const int col = s * 16 + 2 * c + ((j & 2) ? 8 : 0);
      float2 x = make_float2(0.f, 0.f);
      if (r < S && col < hd) x = *reinterpret_cast<const float2*>(q + base + (size_t)r * stride + col);
      qa[s][j] = pack_bf16(x.x * scale, x.y * scale);
    }
  }

  // Per-thread running max and sum of exps over this thread's keys (merged
  // across the four threads of a row after pass 1)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float out[DTILES][4];
#pragma unroll
  for (int t = 0; t < DTILES; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[t][j] = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < S; k0 += kKTile) {
      __syncthreads();  // previous tile consumed
      load_tile<HDP, LD>(ks, k + base, k0, S, stride, hd);
      if (pass == 1) load_tile<HDP, LD>(vs, v + base, k0, S, stride, hd);
      __syncthreads();
      const int kn = min(kKTile, S - k0);
      for (int kk = 0; kk < kn; kk += 16) {
        float sc[2][4];
        score_chunk<KSTEPS, LD>(sc, qa, ks, kk, k0 + kk, S, bias, row0, row1, g, c);
        if (pass == 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float cmax = fmaxf(fmaxf(sc[0][2 * i], sc[0][2 * i + 1]),
                                     fmaxf(sc[1][2 * i], sc[1][2 * i + 1]));
            const float m_new = fmaxf(m[i], cmax);
            if (m_new == -INFINITY) continue;  // no valid key seen yet
            l[i] = l[i] * expf(m[i] - m_new) + expf(sc[0][2 * i] - m_new) +
                   expf(sc[0][2 * i + 1] - m_new) + expf(sc[1][2 * i] - m_new) +
                   expf(sc[1][2 * i + 1] - m_new);
            m[i] = m_new;
          }
        } else {
          // P (normalised, rounded to bf16) as the A fragment of the next mma
          float p[2][4];
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int j = 0; j < 4; ++j) p[t][j] = expf(sc[t][j] - m[j >> 1]) / l[j >> 1];
          const uint32_t a0 = pack_bf16(p[0][0], p[0][1]);
          const uint32_t a1 = pack_bf16(p[0][2], p[0][3]);
          const uint32_t a2 = pack_bf16(p[1][0], p[1][1]);
          const uint32_t a3 = pack_bf16(p[1][2], p[1][3]);
          const __nv_bfloat16* vr = vs + (kk + 2 * c) * LD + g;
#pragma unroll
          for (int t = 0; t < DTILES; ++t) {
            const __nv_bfloat16* vt = vr + t * 8;
            const uint32_t b0 = (uint32_t)__bfloat16_as_ushort(vt[0]) |
                                ((uint32_t)__bfloat16_as_ushort(vt[LD]) << 16);
            const uint32_t b1 = (uint32_t)__bfloat16_as_ushort(vt[8 * LD]) |
                                ((uint32_t)__bfloat16_as_ushort(vt[9 * LD]) << 16);
            mma_bf16(out[t], a0, a1, a2, a3, b0, b1);
          }
        }
      }
    }
    if (pass == 0) {
      // Merge the four threads of each row (lanes 4g .. 4g+3)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mr = m[i];
#pragma unroll
        for (int off = 1; off < 4; off *= 2) mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, off));
        float lr = m[i] == -INFINITY ? 0.f : l[i] * expf(m[i] - mr);
#pragma unroll
        for (int off = 1; off < 4; off *= 2) lr += __shfl_xor_sync(0xffffffffu, lr, off);
        m[i] = mr;
        l[i] = lr;
      }
    }
  }

  // out[t]: rows row0 (j = 0, 1) and row1 (j = 2, 3), features t*8 + 2c + (j & 1)
#pragma unroll
  for (int t = 0; t < DTILES; ++t) {
    const int col = t * 8 + 2 * c;
    if (col >= hd) continue;
    if (row0 < S)
      *reinterpret_cast<float2*>(o + base + (size_t)row0 * stride + col) = make_float2(out[t][0], out[t][1]);
    if (row1 < S)
      *reinterpret_cast<float2*>(o + base + (size_t)row1 * stride + col) = make_float2(out[t][2], out[t][3]);
  }
}

template <int KSTEPS>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias, float* o,
                   int B, int S, int H, int hd, float scale, cudaStream_t stream) {
  dim3 grid((S + kQTile - 1) / kQTile, H, B);
  attention_kernel<KSTEPS><<<grid, kThreads, 0, stream>>>(q, k, v, bias, o, S, H, hd, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest hd the kernel takes; the wrapper checks against it.
int novic_attention_max_hd() { return kMaxHd; }

// Launch on `stream`; returns the CUDA error of the launch (0 = success).
int novic_attention_f32(const float* q, const float* k, const float* v, const float* bias,
                        float* o, int B, int S, int H, int hd, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > kMaxHd || hd % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((hd + 15) / 16) {
    case 1: return (int)launch<1>(q, k, v, bias, o, B, S, H, hd, scale, st);
    case 2: return (int)launch<2>(q, k, v, bias, o, B, S, H, hd, scale, st);
    case 3: return (int)launch<3>(q, k, v, bias, o, B, S, H, hd, scale, st);
    case 4: return (int)launch<4>(q, k, v, bias, o, B, S, H, hd, scale, st);
    case 5: return (int)launch<5>(q, k, v, bias, o, B, S, H, hd, scale, st);
    case 6: return (int)launch<6>(q, k, v, bias, o, B, S, H, hd, scale, st);
    case 7: return (int)launch<7>(q, k, v, bias, o, B, S, H, hd, scale, st);
    default: return (int)launch<8>(q, k, v, bias, o, B, S, H, hd, scale, st);
  }
}

}  // extern "C"
