// Attention over bf16 inputs in strided layouts for Hopper (sm_90a):
// softmax(scale * q.k^T over the keys < s_valid) . v, float32 or bf16 out.
//
// Replaces the Pallas kernels of exp/pallas_attn_v2.py `fused_attention2` (X1;
// def :44, pallas_call :53, body `attn_kernel` :28) and of
// exp/dfn5b_attention.py `make_attn_fullseq` (X2; :131, call :144, body
// `_fullseq_kernel`), `make_attn_allheads` (:175, :186, `_allheads_kernel`) and
// `make_attn_direct` (:246, :258, `_direct_kernel`). Each body computes, per
// (batch, head), and this kernel computes, rounding where they round:
//   * s = q.k^T over bf16 operands, accumulated in float32;
//   * s *= scale, in float32 after the product (X1: 1/sqrt(hd); X2: 1, since
//     its q arrives pre-scaled and rounded to bf16);
//   * keys at or past s_valid are masked (-1e30 there; exp gives 0 for both);
//   * p = exp(s - max) / sum, NORMALISED, then rounded to bf16;
//   * o = p.v accumulated in float32, stored as float32 or rounded to bf16.
// The Pallas kernels differ only in the layouts they read and write, which
// this kernel takes as a base pointer and (batch, seq, head) element strides
// with hd contiguous: X1's (B, S, E), fullseq's (B*H, SP, hd) and
// allheads/direct's (B, SP, H, hd) are all read in place. Nothing at or past
// s_valid is read, and queries there are not computed (the harnesses slice
// them off).
//
// Layout: q, k, v bf16, o float32 or bf16, each 16-byte aligned with strides
// that are multiples of 8 elements; hd a multiple of 8, at most 128 (zero
// padded to the tensor-core depth of 16 in shared memory); any s_valid >= 1.
//
// Design (right and simple first), as the port's K1 (attention.cu): one block
// of 8 warps per (batch, head, 128 queries), each warp 16 query rows held in
// mma.sync m16n8k16 bf16 fragments. The block walks the keys twice in tiles of
// 64 through a 2-stage cp.async ring (k, and v in the second pass, copied as
// they are: no conversion on the way in). Pass 1 keeps each row's running max
// and its sum of exps rescaled to it; pass 2 forms the normalised p, rounds it
// to bf16 in registers (the score accumulator layout is the A operand layout
// of the next mma) and accumulates p.v. k fragments come from ldmatrix, v
// fragments from ldmatrix.trans.
//
// Bound on the H100 at X2's shape (B=32, S=730, H=16, hd=80): the two
// products are 4*B*H*S^2*hd = 87.3 GFLOP, 0.0883 ms at the 989 TFLOP/s bf16
// peak; q, k, v in bf16 and o in float32 are 299 MB, 0.0893 ms at 3.35 TB/s
// (bf16 out: 239 MB, 0.0714 ms, so operations bound it). At X1's (256, 196,
// 12, 64): 385 MB, 0.1150 ms, bytes. The kernel reads q, k, v and writes o
// once from device memory (k and v of a head are re-read from L2 by each of
// its query tiles), so what separates it from the bound is compute: pass 2
// recomputes q.k^T (1.5x the products' operations), mma.sync runs below the
// wgmma rate, and exp and the division run per score on the CUDA cores in
// both passes. wgmma, one pass with a rescaled output, and warp specialisation
// are later work.
//
// Tolerance: products of bf16 values are exact in float32; sums run in
// another order than the plain version's, so a row sum can differ in its last
// bit and move the bf16 rounding of a p by one ulp (<= 2^-7 p): an output then
// differs by at most 2^-7 * max|v| over the keys, plus one bf16 ulp of the
// output where it is stored as bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "mma_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQTile = 16 * kWarps;  // queries per block
constexpr int kKTile = 64;           // keys per shared-memory stage
constexpr int kMaxHd = 128;
constexpr int kMaxDevices = 64;

struct Strides {
  long long b, s, h;  // in elements; hd is contiguous
};

template <int HDP>  // hd padded to a multiple of 16
struct Tile {
  static constexpr int LD = HDP + 8;  // bf16 row stride: conflict-free ldmatrix rows
  static constexpr int kElems = kKTile * LD;
  static constexpr int kSmemBytes = 2 * 2 * kElems * 2;  // 2 stages x (k, v) x bf16
};

// Rows [k0, k0 + kKTile) of one head (`head` points at its seq 0, feature 0)
// into `dst` with cp.async; rows at or past s_valid and columns at or past hd
// are zero-filled without reading.
template <int HDP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* head,
                                          long long seq_stride, int k0, int s_valid, int hd) {
  constexpr int kChunks = HDP / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kKTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = 8 * (i % kChunks);
    const bool valid = k0 + r < s_valid && c < hd;
    const __nv_bfloat16* src = valid ? head + (long long)(k0 + r) * seq_stride + c : head;
    cp_async16(smem_u32(dst + r * Tile<HDP>::LD + c), src, valid ? 16 : 0);
  }
}

// Scores of one warp's 16 rows against keys [key0, key0 + 16): two m16n8
// accumulators; element j of sc[t] is row (j < 2 ? row0 : row1), key
// key0 + 8t + 2c + (j & 1). `kaddr` is this lane's ldmatrix address of the
// chunk's first key row. Scaled in float32; keys at or past s_valid are -inf.
template <int KSTEPS>
__device__ __forceinline__ void score_chunk(float (&sc)[2][4], const uint32_t (&qa)[KSTEPS][4],
                                            uint32_t kaddr, int key0, int s_valid, float scale,
                                            int c) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[t][j] = 0.f;
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    uint32_t kb[4];  // b0, b1 of keys 0-7, then of keys 8-15
    ldmatrix_x4(kb, kaddr + s * 16 * 2);
    mma_bf16(sc[0], qa[s], kb[0], kb[1]);
    mma_bf16(sc[1], qa[s], kb[2], kb[3]);
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + t * 8 + 2 * c + (j & 1);
      sc[t][j] = key < s_valid ? sc[t][j] * scale : -INFINITY;
    }
}

template <bool kOutBF16>
__device__ __forceinline__ void store_pair(void* o, long long idx, float x, float y) {
  if constexpr (kOutBF16) {
    *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(o) + idx) = pack_bf16(x, y);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(o) + idx) = make_float2(x, y);
  }
}

template <int KSTEPS, bool kOutBF16>  // KSTEPS = padded hd / 16
__global__ void __launch_bounds__(kThreads, 2)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, void* __restrict__ o, Strides qs,
                      Strides ks, Strides vs, Strides os, int s_valid, int hd, float scale) {
  constexpr int HDP = 16 * KSTEPS;
  constexpr int LD = Tile<HDP>::LD;
  constexpr int kElems = Tile<HDP>::kElems;
  constexpr int DTILES = HDP / 8;  // even: v fragments come two n8 tiles at a time
  extern __shared__ __align__(16) __nv_bfloat16 smem[];  // stage s: k at 2s, v at 2s + 1

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;  // mma group (row) and thread-in-group
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qh = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kh = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vh = v + b * vs.b + h * vs.h;
  const int row0 = blockIdx.x * kQTile + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;

  // q fragments (A operand, 16 rows x HDP), bf16 pairs as they are stored
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (j & 1) ? row1 : row0;
      const int col = s * 16 + 2 * c + ((j & 2) ? 8 : 0);
      qa[s][j] = r < s_valid && col < hd
                     ? *reinterpret_cast<const uint32_t*>(qh + r * qs.s + col)
                     : 0u;
    }
  }

  // This lane's ldmatrix offsets (elements) in a tile: k rows (keys) 0-7 at
  // features 0-7 / 8-15 give b0 / b1 of keys 0-7, lanes 16-31 those of keys
  // 8-15; v (transposed) keys 0-7 / 8-15 give b0 / b1 of features 0-7, lanes
  // 16-31 those of features 8-15
  const int k_lane = ((lane & 7) + ((lane >> 4) & 1) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  // Per-thread running max and sum of exps over this thread's keys (merged
  // across the four threads of a row after pass 1)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float out[DTILES][4];
#pragma unroll
  for (int t = 0; t < DTILES; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[t][j] = 0.f;

  const int ntiles = (s_valid + kKTile - 1) / kKTile;
  for (int pass = 0; pass < 2; ++pass) {
    load_tile<HDP>(smem, kh, ks.s, 0, s_valid, hd);
    if (pass == 1) load_tile<HDP>(smem + kElems, vh, vs.s, 0, s_valid, hd);
    cp_async_commit();
    for (int t = 0; t < ntiles; ++t) {
      const int st = t & 1;
      if (t + 1 < ntiles) {
        __nv_bfloat16* next = smem + 2 * (st ^ 1) * kElems;
        load_tile<HDP>(next, kh, ks.s, (t + 1) * kKTile, s_valid, hd);
        if (pass == 1) load_tile<HDP>(next + kElems, vh, vs.s, (t + 1) * kKTile, s_valid, hd);
      }
      cp_async_commit();
      cp_async_wait<1>();  // tile t has landed
      __syncthreads();     // ... for every thread
      const uint32_t kbase = smem_u32(smem + 2 * st * kElems);
      const uint32_t vbase = kbase + kElems * 2;
      const int k0 = t * kKTile;
      const int kn = min(kKTile, s_valid - k0);
      for (int kk = 0; kk < kn; kk += 16) {
        float sc[2][4];
        score_chunk<KSTEPS>(sc, qa, kbase + (k_lane + kk * LD) * 2, k0 + kk, s_valid, scale, c);
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
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int j = 0; j < 4; ++j) p[u][j] = expf(sc[u][j] - m[j >> 1]) / l[j >> 1];
          const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                                  pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
          for (int u = 0; u < DTILES; u += 2) {
            uint32_t vb[4];  // b0, b1 of features u*8.., then of (u+1)*8..
            ldmatrix_x4_trans(vb, vbase + (v_lane + kk * LD + u * 8) * 2);
            mma_bf16(out[u], pa, vb[0], vb[1]);
            mma_bf16(out[u + 1], pa, vb[2], vb[3]);
          }
        }
      }
      __syncthreads();  // stage st is consumed before it is refilled
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
  const long long obase = b * os.b + h * os.h;
#pragma unroll
  for (int t = 0; t < DTILES; ++t) {
    const int col = t * 8 + 2 * c;
    if (col >= hd) continue;
    if (row0 < s_valid) store_pair<kOutBF16>(o, obase + row0 * os.s + col, out[t][0], out[t][1]);
    if (row1 < s_valid) store_pair<kOutBF16>(o, obase + row1 * os.s + col, out[t][2], out[t][3]);
  }
}

template <int KSTEPS, bool kOutBF16>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   void* o, const Strides (&st)[4], int B, int H, int s_valid, int hd,
                   float scale, cudaStream_t stream) {
  auto kernel = attention_bf16_kernel<KSTEPS, kOutBF16>;
  constexpr int kSmem = Tile<16 * KSTEPS>::kSmemBytes;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const dim3 grid((s_valid + kQTile - 1) / kQTile, H, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(q, k, v, o, st[0], st[1], st[2], st[3], s_valid, hd,
                                            scale);
  return cudaGetLastError();
}

template <bool kOutBF16>
cudaError_t dispatch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                     void* o, const Strides (&st)[4], int B, int H, int s_valid, int hd,
                     float scale, cudaStream_t stream) {
  switch ((hd + 15) / 16) {
    case 1: return launch<1, kOutBF16>(q, k, v, o, st, B, H, s_valid, hd, scale, stream);
    case 2: return launch<2, kOutBF16>(q, k, v, o, st, B, H, s_valid, hd, scale, stream);
    case 3: return launch<3, kOutBF16>(q, k, v, o, st, B, H, s_valid, hd, scale, stream);
    case 4: return launch<4, kOutBF16>(q, k, v, o, st, B, H, s_valid, hd, scale, stream);
    case 5: return launch<5, kOutBF16>(q, k, v, o, st, B, H, s_valid, hd, scale, stream);
    case 6: return launch<6, kOutBF16>(q, k, v, o, st, B, H, s_valid, hd, scale, stream);
    case 7: return launch<7, kOutBF16>(q, k, v, o, st, B, H, s_valid, hd, scale, stream);
    default: return launch<8, kOutBF16>(q, k, v, o, st, B, H, s_valid, hd, scale, stream);
  }
}

}  // namespace

extern "C" {

// Largest hd the kernel takes; the wrapper checks against it.
int novic_attention_bf16_max_hd() { return kMaxHd; }

// Launch on `stream`; returns the CUDA error of the launch (0 = success).
// strides: 12 element strides, (batch, seq, head) of q, k, v and o in turn.
int novic_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         const long long* strides, int B, int H, int s_valid, int hd,
                         float scale, int out_bf16, void* stream) {
  if (B <= 0 || H <= 0 || s_valid <= 0 || hd <= 0 || hd > kMaxHd || hd % 8 != 0 ||
      strides == nullptr)
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(out_bf16 ? dispatch<true>(qb, kb, vb, o, st, B, H, s_valid, hd, scale, s)
                        : dispatch<false>(qb, kb, vb, o, st, B, H, s_valid, hd, scale, s));
}

}  // extern "C"
