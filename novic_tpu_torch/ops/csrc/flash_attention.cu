// One-pass (online-softmax) attention with segment ids for Hopper (sm_90a):
// the forward pass of JAX's TPU flash-attention kernel as the repo calls it.
//
// Replaces jax.experimental.pallas.ops.tpu.flash_attention (pallas_call at
// flash_attention.py:758; bodies `_flash_attention_kernel_single_batch` :342
// and `_flash_attention_kernel_single_batch_single_step` :484), which the exp/
// harnesses reach through `make_attn_flash` (exp/dfn5b_attention.py:91) and
// `attn_flash` (exp/attn_variants.py:68) (X6). Per (batch, head):
//   * s = q.k^T over bf16 operands, accumulated in float32, then s *= scale;
//   * where the query's and the key's segment ids differ, s += -0.7 * FLT_MAX
//     (DEFAULT_MASK_VALUE: finite and additive, so a query whose keys are all
//     masked gets the plain average of v over every key, never NaN);
//   * online softmax per key block: m' = max(m, rowmax s), p = exp(s - m'),
//     l' = rowsum p + exp(m - m') * l, the UNNORMALISED p rounded to bf16 and
//     o' = exp(m - m') * o + bf16(p).v accumulated in float32;
//   * o / l stored as bf16 (q's dtype).
// JAX's multi-step body keeps o normalised after every block (o *= l_corr /
// l', o += bf16(p).v / l'); dividing once at the end differs from it only in
// float32 rounding. Its single-step body (block_k == kv length) rounds the
// normalised p instead; the plain version (ops/flash_attention.py) follows
// either blocking exactly.
//
// Layout: q (B, H, Sq, hd), k and v (B, H, Skv, hd) bf16 and o (B, H, Sq, hd)
// bf16, each a base pointer with (batch, head, seq) element strides and hd
// contiguous, 16-byte aligned with strides that are multiples of 8 elements;
// hd a multiple of 8, at most 128 (zero padded to the tensor-core depth of 16
// in shared memory); any Sq, Skv >= 1. Segment ids, when given: int32 (B, Sq)
// and (B, Skv), rows contiguous.
//
// Design (right and simple first), built on attention_bf16.cu: one block of 8
// warps per (batch, head, 128 queries), each warp 16 query rows held in
// mma.sync m16n8k16 bf16 fragments. The block walks the keys ONCE in tiles of
// 64 through a 2-stage cp.async ring holding k, v and the tile's key segment
// ids. For each tile a warp computes its 16 x 64 scores, adds the mask, takes
// each row's tile max across the four threads of the row (two shuffles),
// rescales l and the output fragments by exp(m - m'), forms p = exp(s - m'),
// packs it to bf16 in registers as the A fragment of the P.v mma (the score
// accumulator layout is the A operand layout) and accumulates. The kernel's
// online-update block is its key tile (64 keys), so it rounds p where JAX's
// multi-step body rounds it, at block_k = 64. Keys past Skv in the last tile
// are zero-filled and get a score of -inf (p = 0): they are not keys.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): every one of the Sq rows is
// computed, padded queries included. At the DFN5B harness's (32, 16, 768, 80)
// the two products are 4*B*H*S^2*hd = 96.6 GFLOP, 0.0977 ms; q, k, v and o in
// bf16 are 252 MB, 0.0751 ms: operations bound it. At attn_variants'
// (256, 12, 256, 64): 51.5 GFLOP, 0.0521 ms; 403 MB, 0.120 ms: bytes. What
// separates the kernel from the bound is compute: mma.sync runs below the
// wgmma rate and exp runs per score on the CUDA cores; wgmma, TMA and warp
// specialisation are later work.
//
// Tolerance against the plain version at block_k = 64: products of bf16
// values are exact in float32; sums and exp differ in their last bits, which
// can move the bf16 rounding of a p by one ulp (<= 2^-8 relative), so an
// output moves by at most 2^-7 * max|v| over the keys, plus one bf16 ulp of
// the output.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>
#include <math.h>

#include "mma_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQTile = 16 * kWarps;  // queries per block
constexpr int kKTile = 64;           // keys per shared-memory stage and online update
constexpr int kMaxHd = 128;
constexpr int kMaxDevices = 64;
// flash_attention.py DEFAULT_MASK_VALUE: the product in double, then float32
constexpr float kMaskValue = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));

struct Strides {
  long long b, h, s;  // in elements; hd is contiguous
};

template <int HDP>  // hd padded to a multiple of 16
struct Tile {
  static constexpr int LD = HDP + 8;  // bf16 row stride: conflict-free ldmatrix rows
  static constexpr int kElems = kKTile * LD;
  // 2 stages x (k, v) x bf16, then 2 stages x kKTile int32 key segment ids
  static constexpr int kSegOffset = 2 * 2 * kElems * 2;
  static constexpr int kSmemBytes = kSegOffset + 2 * kKTile * 4;
};

// 4 bytes global -> shared; src_bytes = 0 zero-fills without reading
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// Rows [k0, k0 + kKTile) of one head (`head` points at its seq 0, feature 0)
// into `dst` with cp.async; rows at or past n and columns at or past hd are
// zero-filled without reading.
template <int HDP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* head,
                                          long long seq_stride, int k0, int n, int hd) {
  constexpr int kChunks = HDP / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kKTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = 8 * (i % kChunks);
    const bool valid = k0 + r < n && c < hd;
    const __nv_bfloat16* src = valid ? head + (long long)(k0 + r) * seq_stride + c : head;
    cp_async16(smem_u32(dst + r * Tile<HDP>::LD + c), src, valid ? 16 : 0);
  }
}

// The tile's key segment ids (keys past n: 0, never read as keys)
__device__ __forceinline__ void load_seg(int* dst, const int* seg, int k0, int n) {
  const int r = threadIdx.x;
  if (r < kKTile) {
    const bool valid = k0 + r < n;
    cp_async4(smem_u32(dst + r), valid ? seg + k0 + r : seg, valid ? 4 : 0);
  }
}

template <int KSTEPS, bool kSeg>  // KSTEPS = padded hd / 16
__global__ void __launch_bounds__(kThreads, KSTEPS > 5 ? 1 : 2)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                       Strides qs, Strides ks, Strides vs, Strides os, int sq, int skv, int hd,
                       float scale) {
  constexpr int HDP = 16 * KSTEPS;
  constexpr int LD = Tile<HDP>::LD;
  constexpr int kElems = Tile<HDP>::kElems;
  constexpr int DTILES = HDP / 8;  // even: v fragments come two n8 tiles at a time
  constexpr int NT = kKTile / 8;   // score n8 tiles per key tile
  extern __shared__ __align__(16) __nv_bfloat16 smem[];  // stage s: k at 2s, v at 2s + 1
  int* const seg_smem = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) + Tile<HDP>::kSegOffset);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;  // mma group (row) and thread-in-group
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qh = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kh = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vh = v + b * vs.b + h * vs.h;
  const int* kvseg_b = kSeg ? kv_seg + (long long)b * skv : nullptr;
  const int row0 = blockIdx.x * kQTile + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;
  int qseg[2] = {0, 0};
  if (kSeg) {
    qseg[0] = row0 < sq ? q_seg[(long long)b * sq + row0] : 0;
    qseg[1] = row1 < sq ? q_seg[(long long)b * sq + row1] : 0;
  }

  // q fragments (A operand, 16 rows x HDP), bf16 pairs as they are stored
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (j & 1) ? row1 : row0;
      const int col = s * 16 + 2 * c + ((j & 2) ? 8 : 0);
      qa[s][j] = r < sq && col < hd ? *reinterpret_cast<const uint32_t*>(qh + r * qs.s + col) : 0u;
    }
  }

  // This lane's ldmatrix offsets (elements) in a tile: k rows (keys) 0-7 at
  // features 0-7 / 8-15 give b0 / b1 of keys 0-7, lanes 16-31 those of keys
  // 8-15; v (transposed) keys 0-7 / 8-15 give b0 / b1 of features 0-7, lanes
  // 16-31 those of features 8-15
  const int k_lane = ((lane & 7) + ((lane >> 4) & 1) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  // Running row max m (equal across the four threads of a row), this
  // thread's share of the row sum l, and the unnormalised output
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float out[DTILES][4];
#pragma unroll
  for (int t = 0; t < DTILES; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[t][j] = 0.f;

  const int ntiles = (skv + kKTile - 1) / kKTile;
  load_tile<HDP>(smem, kh, ks.s, 0, skv, hd);
  load_tile<HDP>(smem + kElems, vh, vs.s, 0, skv, hd);
  if (kSeg) load_seg(seg_smem, kvseg_b, 0, skv);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) {
      __nv_bfloat16* next = smem + 2 * (st ^ 1) * kElems;
      load_tile<HDP>(next, kh, ks.s, (t + 1) * kKTile, skv, hd);
      load_tile<HDP>(next + kElems, vh, vs.s, (t + 1) * kKTile, skv, hd);
      if (kSeg) load_seg(seg_smem + (st ^ 1) * kKTile, kvseg_b, (t + 1) * kKTile, skv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();     // ... for every thread
    const uint32_t kbase = smem_u32(smem + 2 * st * kElems);
    const uint32_t vbase = kbase + kElems * 2;
    const int* tseg = seg_smem + st * kKTile;
    const int k0 = t * kKTile;

    // Scores: sc[n][j] is row (j < 2 ? row0 : row1), key k0 + 8n + 2c + (j & 1)
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t kaddr = kbase + (k_lane + kk * 16 * LD) * 2;
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        uint32_t kb[4];  // b0, b1 of keys 0-7 of the chunk, then of keys 8-15
        ldmatrix_x4(kb, kaddr + s * 16 * 2);
        mma_bf16(sc[2 * kk], qa[s], kb[0], kb[1]);
        mma_bf16(sc[2 * kk + 1], qa[s], kb[2], kb[3]);
      }
    }
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = 8 * n + 2 * c + (j & 1);  // in the tile
        float x = sc[n][j] * scale;
        if (kSeg) x += tseg[key] == qseg[j >> 1] ? 0.f : kMaskValue;
        x = k0 + key < skv ? x : -INFINITY;
        sc[n][j] = x;
        tmax[j >> 1] = fmaxf(tmax[j >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off *= 2)
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], off));
      // Every tile holds a key, so the new max is finite: no -inf - -inf
      const float m_new = fmaxf(m[i], tmax[i]);
      alpha[i] = __expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int u = 0; u < DTILES; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[u][j] *= alpha[j >> 1];

    // p = exp(s - m), unnormalised, summed in float32 and rounded to bf16 as
    // the A fragment of the P.v mma, one 16-key chunk at a time
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      float p[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[u][j] = __expf(sc[2 * kk + u][j] - m[j >> 1]);
          l[j >> 1] += p[u][j];
        }
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int u = 0; u < DTILES; u += 2) {
        uint32_t vb[4];  // b0, b1 of features u*8.., then of (u+1)*8..
        ldmatrix_x4_trans(vb, vbase + (v_lane + kk * 16 * LD + u * 8) * 2);
        mma_bf16(out[u], pa, vb[0], vb[1]);
        mma_bf16(out[u + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }

  // The row sums over the four threads of each row, then o / l in bf16
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int off = 1; off < 4; off *= 2) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  // out[u]: rows row0 (j = 0, 1) and row1 (j = 2, 3), features u*8 + 2c + (j & 1)
  const long long obase = b * os.b + h * os.h;
#pragma unroll
  for (int u = 0; u < DTILES; ++u) {
    const int col = u * 8 + 2 * c;
    if (col >= hd) continue;
    if (row0 < sq)
      *reinterpret_cast<uint32_t*>(o + obase + row0 * os.s + col) =
          pack_bf16(out[u][0] / l[0], out[u][1] / l[0]);
    if (row1 < sq)
      *reinterpret_cast<uint32_t*>(o + obase + row1 * os.s + col) =
          pack_bf16(out[u][2] / l[1], out[u][3] / l[1]);
  }
}

template <int KSTEPS, bool kSeg>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   __nv_bfloat16* o, const int* q_seg, const int* kv_seg, const Strides (&st)[4],
                   int B, int H, int sq, int skv, int hd, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<KSTEPS, kSeg>;
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
  const dim3 grid((sq + kQTile - 1) / kQTile, H, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(q, k, v, o, q_seg, kv_seg, st[0], st[1], st[2], st[3],
                                            sq, skv, hd, scale);
  return cudaGetLastError();
}

template <bool kSeg>
cudaError_t dispatch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                     __nv_bfloat16* o, const int* q_seg, const int* kv_seg,
                     const Strides (&st)[4], int B, int H, int sq, int skv, int hd, float scale,
                     cudaStream_t s) {
  switch ((hd + 15) / 16) {
    case 1: return launch<1, kSeg>(q, k, v, o, q_seg, kv_seg, st, B, H, sq, skv, hd, scale, s);
    case 2: return launch<2, kSeg>(q, k, v, o, q_seg, kv_seg, st, B, H, sq, skv, hd, scale, s);
    case 3: return launch<3, kSeg>(q, k, v, o, q_seg, kv_seg, st, B, H, sq, skv, hd, scale, s);
    case 4: return launch<4, kSeg>(q, k, v, o, q_seg, kv_seg, st, B, H, sq, skv, hd, scale, s);
    case 5: return launch<5, kSeg>(q, k, v, o, q_seg, kv_seg, st, B, H, sq, skv, hd, scale, s);
    case 6: return launch<6, kSeg>(q, k, v, o, q_seg, kv_seg, st, B, H, sq, skv, hd, scale, s);
    case 7: return launch<7, kSeg>(q, k, v, o, q_seg, kv_seg, st, B, H, sq, skv, hd, scale, s);
    default: return launch<8, kSeg>(q, k, v, o, q_seg, kv_seg, st, B, H, sq, skv, hd, scale, s);
  }
}

}  // namespace

extern "C" {

// Largest hd the kernel takes; the wrapper checks against it.
int novic_flash_attention_max_hd() { return kMaxHd; }

// Launch on `stream`; returns the CUDA error of the launch (0 = success).
// strides: 12 element strides, (batch, head, seq) of q, k, v and o in turn.
// q_seg and kv_seg are both null (no segment ids) or both set.
int novic_flash_attention(const void* q, const void* k, const void* v, void* o, const void* q_seg,
                          const void* kv_seg, const long long* strides, int B, int H, int sq,
                          int skv, int hd, float scale, void* stream) {
  if (B <= 0 || H <= 0 || sq <= 0 || skv <= 0 || hd <= 0 || hd > kMaxHd || hd % 8 != 0 ||
      strides == nullptr || (q_seg == nullptr) != (kv_seg == nullptr))
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  const auto* qsg = static_cast<const int*>(q_seg);
  const auto* ksg = static_cast<const int*>(kv_seg);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(q_seg ? dispatch<true>(qb, kb, vb, ob, qsg, ksg, st, B, H, sq, skv, hd, scale, s)
                     : dispatch<false>(qb, kb, vb, ob, qsg, ksg, st, B, H, sq, skv, hd, scale, s));
}

}  // extern "C"
