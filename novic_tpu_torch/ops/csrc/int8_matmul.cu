// W8A8 int8 GEMM for Hopper (sm_90a): (M, K) s8 x (N, K)^T s8 -> (M, N) s32,
// with an optional dequant epilogue.
//
// Replaces the Pallas kernel novic_tpu/ops/int8_matmul.py `int8_matmul_pallas`
// (body `_int8_mm_kernel`): a zero-padded, tiled s8 x s8 product accumulated in
// s32. It also replaces exp/pallas_int8_mlp_chain.py `pallas_int8_mm` (the same
// product, the int32 epilogue below) and `pallas_int8_mm_deq` (the bfloat16
// epilogue). It computes what those kernels compute; it does not copy their
// block grid. Three epilogues, chosen by an argument:
//   0  int32:    out = acc;
//   1  float32:  out = ((float)acc * sx[m]) * sw[n] (+ bias[n]), the order of
//                novic_tpu/ops/int8_matmul.py `int8_dense`;
//   2  bfloat16: out = bf16_rn(((float)acc * sx[m]) * sw[n]), no bias.
// The epilogue is written with __int2float_rn, __fmul_rn and __fadd_rn so that
// nvcc cannot contract a*b+c into an FMA: PyTorch rounds each op separately,
// and acc passes 2^24 at K=3072, so the int->float rounding mode matters too.
// The plain version in ops/int8_matmul.py is then equal bit for bit.
//
// Layout: A (M, K) int8 row-major; B (N, K) int8 row-major, the torch weight
// layout (out, in): both K-major, which is the one layout 8-bit wgmma takes for
// B (it has no transpose) and the "col" operand of mma.sync m16n8k32, so the
// weight needs no transpose. Two instances, chosen by the wrapper by shape:
//
// Hopper instance (K a positive multiple of 16, A and B 16-byte aligned: every
// shape of the towers and X4): persistent blocks, one an SM, of three
// warpgroups, in clusters of 2 x 2 that walk quads of 128 x 128 output tiles
// (tile rows 2i, 2i + 1 by tile columns 2c, 2c + 1). Warpgroup 2 is the
// producer: one thread streams half of its block's A tile (64 rows x 128 K
// bytes), multicast into the two blocks of its tile row, and half of its B
// tile, multicast into the two blocks of its tile column, by TMA, 128-byte
// swizzled, into a ring of six 32 KB stages with mbarriers (`full` when a
// stage's bytes have landed, `empty` when its consumer's four warps in every
// block have read it), so A and B are each read from L2 once for two tiles.
// Warpgroups 0 and 1 take alternate 128 x 128 output tiles (ping-pong) and run
// wgmma m64n128k32 s8 -> s32 on them, two a k-step (rows 0-63 and 64-127),
// keeping one stage's products in flight; a k32 step moves the descriptors 32
// bytes along a swizzle row. Each runs its main loop when the other has issued
// its last stage (`turn` barriers), so while one warpgroup stores a finished
// tile from its registers, the other multiplies the next with the whole ring
// ahead of it: the output stream, which bounds the kernel at the towers'
// shapes, runs beside the tensor cores instead of after them. A tile's row and
// column scales and bias are loaded as its main loop starts and staged in
// shared memory for its epilogue, so their latency is not paid there. The
// tensor maps' extents zero-fill the ragged M, N and K edges; stores are
// masked. Quads walk n fastest, so the tiles in flight share a few A row panels
// and all of B.
//
// mma.sync instance (any other shape: K % 16 != 0, an unaligned pointer, K =
// 0): blocks of 8 warps own a 128 x 128 output tile and walk K in steps of 64
// bytes through a 4-stage cp.async ring in shared memory (rows padded to 80
// bytes, so ldmatrix reads are free of bank conflicts); each warp owns 64 x 32
// outputs, 4 x 4 m16n8 s32 accumulators, and feeds mma.sync from ldmatrix.x4
// (an s8 16 x 32 tile is a b16 16 x 16 tile to ldmatrix, since both operands
// are contiguous along K). The K tail is zero-filled and the M/N edges masked;
// where 16-byte copies are not aligned a scalar byte path loads the tiles.
//
// Bound on the H100 at the SigLIP-B/16 tower shapes (B=64: M = 12,544 tokens):
// q/k/v/o (K = N = 768) move 9.6 MB of A, 0.6 MB of B and 38.5 MB of float32
// out, 14.6 us at 3.35 TB/s, against 14.8 GOP, 7.5 us at the 1,979 TOPS int8
// dense peak: bound by bytes, mostly the float32 output. fc1 (N = 3,072) is
// bound by bytes the same way (49.6 us); fc2 (K = 3,072, N = 768) by
// operations (29.9 us). Both instances write each output once, in 8-byte
// pairs (4-byte for bfloat16), from registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;  // block tile (K in bytes)
constexpr int kStages = 4;
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWM = kBM / kWarpsM;  // 64 rows per warp
constexpr int kWN = kBN / kWarpsN;  // 32 columns per warp
constexpr int kMFrags = kWM / 16;
constexpr int kNFrags = kWN / 8;
constexpr int kLds = kBK + 16;      // shared row stride in bytes
constexpr int kTileBytes = (kBM + kBN) * kLds;
constexpr int kSmemBytes = kStages * kTileBytes;  // 81,920
constexpr int kMaxDevices = 64;

enum Epilogue { kInt32 = 0, kF32 = 1, kBF16 = 2 };

// Rows [r0, r0 + kRows) and bytes [k0, k0 + kBK) of the (rows, K) int8 matrix
// `src` into `dst` (row stride kLds). Rows at or past `rows` and bytes at or
// past K are zero.
template <int kRows, bool kAligned>
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* __restrict__ src, int r0,
                                          int rows, int k0, int K) {
  constexpr int kChunksPerRow = kBK / 16;
  constexpr int kChunks = kRows * kChunksPerRow;
  static_assert(kChunks % kThreads == 0, "tile chunks must split evenly over threads");
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunksPerRow, c = 16 * (i % kChunksPerRow);
    const int gr = r0 + r, gk = k0 + c;
    int8_t* d = dst + r * kLds + c;
    if constexpr (kAligned) {
      // K % 16 == 0: a chunk lies wholly inside K or wholly past it
      const bool valid = gr < rows && gk < K;
      cp_async16(smem_u32(d), valid ? src + (size_t)gr * K + gk : src, valid ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (gr < rows) {
        const int8_t* s = src + (size_t)gr * K;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (gk + j < K) w[j / 4] |= (uint32_t)(uint8_t)s[gk + j] << (8 * (j % 4));
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ float dequant(int acc, float s, float w) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s), w);
}

// The dequant factors of columns col and, if `two`, col + 1: weight scales
// and bias (the bias only for the float32 epilogue, where there is one)
struct ColScale {
  float w0, w1, b0, b1;
};

template <int kEpi>
__device__ __forceinline__ ColScale col_scale(const float* __restrict__ sw,
                                              const float* __restrict__ bias, int col, bool two) {
  ColScale c{0.f, 0.f, 0.f, 0.f};
  if constexpr (kEpi != kInt32) {
    c.w0 = sw[col];
    if (two) c.w1 = sw[col + 1];
    if (kEpi == kF32 && bias != nullptr) {
      c.b0 = bias[col];
      if (two) c.b1 = bias[col + 1];
    }
  }
  return c;
}

// Outputs (row, col) and, if `two`, (row, col + 1) at flat index `idx`; the
// bias is added where `has_bias`
template <int kEpi>
__device__ __forceinline__ void store_pair(void* out, size_t idx, bool two, bool vec, int a0,
                                           int a1, float s, const ColScale& c, bool has_bias) {
  if constexpr (kEpi == kInt32) {
    int* o = static_cast<int*>(out) + idx;
    if (two && vec) {
      *reinterpret_cast<int2*>(o) = make_int2(a0, a1);
    } else {
      o[0] = a0;
      if (two) o[1] = a1;
    }
  } else {
    float y0 = dequant(a0, s, c.w0);
    float y1 = two ? dequant(a1, s, c.w1) : 0.f;
    if constexpr (kEpi == kF32) {
      if (has_bias) {
        y0 = __fadd_rn(y0, c.b0);
        if (two) y1 = __fadd_rn(y1, c.b1);
      }
      float* o = static_cast<float*>(out) + idx;
      if (two && vec) {
        *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
      } else {
        o[0] = y0;
        if (two) o[1] = y1;
      }
    } else {
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + idx;
      const __nv_bfloat16 b0 = __float2bfloat16_rn(y0), b1 = __float2bfloat16_rn(y1);
      if (two && vec) {
        *reinterpret_cast<uint32_t*>(o) = (uint32_t)__bfloat16_as_ushort(b0) |
                                          ((uint32_t)__bfloat16_as_ushort(b1) << 16);
      } else {
        o[0] = b0;
        if (two) o[1] = b1;
      }
    }
  }
}

template <int kEpi, bool kAligned>
__global__ void __launch_bounds__(kThreads, 2)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 const float* __restrict__ bias, void* __restrict__ out, int M, int N, int K,
                 bool vec) {
  extern __shared__ __align__(16) int8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warp_m = warp / kWarpsN, warp_n = warp % kWarpsN;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ktiles = (K + kBK - 1) / kBK;
  auto stage_a = [&](int s) { return smem + s * kTileBytes; };
  auto stage_b = [&](int s) { return smem + s * kTileBytes + kBM * kLds; };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) {
      load_tile<kBM, kAligned>(stage_a(s), A, m0, M, s * kBK, K);
      load_tile<kBN, kAligned>(stage_b(s), B, n0, N, s * kBK, K);
    }
    cp_async_commit();
  }

  int acc[kMFrags][kNFrags][4];
#pragma unroll
  for (int i = 0; i < kMFrags; ++i)
#pragma unroll
    for (int j = 0; j < kNFrags; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // ldmatrix.x4 row addresses. A: lanes 0-15 give rows 0-15 at bytes 0-15 of the
  // 32-byte k-step, lanes 16-31 the same rows at bytes 16-31 -> a0..a3. B: lanes
  // 0-7 / 8-15 give n rows 0-7 at bytes 0-15 / 16-31, lanes 16-31 n rows 8-15 ->
  // (b0, b1) of two n8 fragments.
  const int a_row = warp_m * kWM + (lane % 16), a_col = (lane / 16) * 16;
  const int b_row = warp_n * kWN + (lane % 8) + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 16;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ... for every thread; tile kt - 1 is consumed
    const int next = kt + kStages - 1;
    if (next < ktiles) {
      load_tile<kBM, kAligned>(stage_a(next % kStages), A, m0, M, next * kBK, K);
      load_tile<kBN, kAligned>(stage_b(next % kStages), B, n0, N, next * kBK, K);
    }
    cp_async_commit();
    const uint32_t as = smem_u32(stage_a(kt % kStages));
    const uint32_t bs = smem_u32(stage_b(kt % kStages));
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[kMFrags][4];
      uint32_t bf[kNFrags / 2][4];
#pragma unroll
      for (int i = 0; i < kMFrags; ++i)
        ldmatrix_x4(af[i], as + (a_row + i * 16) * kLds + ks * 32 + a_col);
#pragma unroll
      for (int j = 0; j < kNFrags / 2; ++j)
        ldmatrix_x4(bf[j], bs + (b_row + j * 16) * kLds + ks * 32 + b_col);
#pragma unroll
      for (int i = 0; i < kMFrags; ++i)
#pragma unroll
        for (int j = 0; j < kNFrags; ++j)
          mma_s8(acc[i][j], af[i], bf[j / 2][2 * (j % 2)], bf[j / 2][2 * (j % 2) + 1]);
    }
  }
  cp_async_wait<0>();

  // acc[i][j]: rows g (e = 0, 1) and g + 8 (e = 2, 3), columns 2t + (e & 1)
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < kMFrags; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp_m * kWM + i * 16 + g + 8 * h;
      if (row >= M) continue;
      const float s = kEpi == kInt32 ? 0.f : sx[row];
#pragma unroll
      for (int j = 0; j < kNFrags; ++j) {
        const int col = n0 + warp_n * kWN + j * 8 + 2 * t;
        if (col >= N) continue;
        const bool two = col + 1 < N;
        store_pair<kEpi>(out, (size_t)row * N + col, two, vec, acc[i][j][2 * h],
                         acc[i][j][2 * h + 1], s, col_scale<kEpi>(sw, bias, col, two),
                         bias != nullptr);
      }
    }
  }
}

template <int kEpi, bool kAligned>
cudaError_t launch(const int8_t* A, const int8_t* B, const float* sx, const float* sw,
                   const float* bias, void* out, int M, int N, int K, cudaStream_t stream) {
  auto kernel = int8_gemm_kernel<kEpi, kAligned>;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(A, B, sx, sw, bias, out, M, N, K, N % 2 == 0);
  return cudaGetLastError();
}

// ---- Hopper instance: TMA + s8 wgmma, persistent, ping-pong ------------------

constexpr int kQBM = 128, kQBN = 128, kQBK = 128;  // a warpgroup's tile; K bytes per stage
constexpr int kQStages = 6;                        // one ring, both consumers
constexpr int kQThreads = 384;                     // consumer warpgroups 0, 1; producer 2
constexpr int kQTileBytes = kQBM * kQBK;           // 128 rows of 128 bytes
constexpr int kQHalfBytes = kQTileBytes / 2;       // the 64 rows one block loads
constexpr int kQStageBytes = 2 * kQTileBytes;      // A and B: 32 KB
constexpr int kQBarOffset = kQStages * kQStageBytes;
// A tile's dequant factors for each consumer, twice (tiles alternate): the
// weight scales and bias of its 128 columns and the scales of its 128 rows
constexpr int kQScaleOffset = kQBarOffset + (2 * kQStages + 2) * 8;
constexpr int kQScaleFloats = 3 * kQBN;
constexpr int kQSmemBytes = kQScaleOffset + 2 * 2 * kQScaleFloats * 4 + 1024;  // + alignment
constexpr int kPlanLen = 5;                        // per map: 2 dims, 1 stride, 2 box
constexpr int kQCluster = 4;                       // 2 x 2 blocks: a quad of tiles

// A cluster's four blocks, rank = rm + 2 rn, take the tiles (2i + rm, 2c + rn)
// of a quad (i, c) (quads n fastest). Block (rm, rn) loads half of its A
// tile, rows [64 rn, +64), multicast into the blocks (rm, 0) and (rm, 1),
// which share that tile row, and half of its B tile, rows [64 rm, +64),
// multicast into (0, rn) and (1, rn). Consumer warpgroup wg takes the
// cluster's quads j = wg, wg + 2, ... (quad cluster + j * clusters); the
// ring's slot for stage kt of quad j is j * ktiles + kt. The warpgroups run
// their main loops in turn (`turn` barriers): one starts a quad's main loop
// once the other has issued the last stage of the quad before, so the tensor
// cores serve one at a time, the other's epilogue runs beside them, and every
// wait on a `full` barrier comes after the waits on all earlier slots (within
// one phase of it).
template <int kEpi>
__global__ void __cluster_dims__(kQCluster, 1, 1) __launch_bounds__(kQThreads, 1)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  const float* __restrict__ bias, void* __restrict__ out, int M, int N, int K,
                  bool vec) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kQBarOffset);
  uint64_t* empty = full + kQStages;
  uint64_t* turn = empty + kQStages;  // [wg]: warpgroup wg may start its next main loop
  const int wg = threadIdx.x / 128;
  const int rank = (int)cluster_rank(), rm = rank & 1, rn = rank >> 1;
  const int quads_n = (N + 2 * kQBN - 1) / (2 * kQBN);
  const int quads = (M + 2 * kQBM - 1) / (2 * kQBM) * quads_n;
  const int cluster = blockIdx.x / kQCluster, clusters = gridDim.x / kQCluster;
  const int ktiles = (K + kQBK - 1) / kQBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kQCluster * 4);  // each warp of the slot's consumer in every block
    }
    for (int w = 0; w < 2; ++w) mbar_init(&turn[w], 4);  // each warp of the other consumer
    mbar_fence_init();
  }
  cluster_sync();  // the peers' barriers are initialised before anything reaches them

  if (wg == 2) {
    // ---- producer: one thread streams the quads' stages in order ----
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      prefetch_map(&amap);
      prefetch_map(&bmap);
      const uint16_t a_mask = (uint16_t)((1 << rm) | (1 << (rm + 2)));
      const uint16_t b_mask = (uint16_t)(0x3 << (2 * rn));
      int it = 0;  // ring slot, counted across quads
      for (int j = 0;; ++j) {
        const int quad = cluster + j * clusters;
        if (quad >= quads) break;
        const int m0 = (quad / quads_n * 2 + rm) * kQBM, n0 = (quad % quads_n * 2 + rn) * kQBN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int st = it % kQStages;
          // Every block's consumers have released the stage: the copies this
          // block's halves land in are free too
          mbar_wait(&empty[st], ((it / kQStages) & 1) ^ 1);
          uint8_t* stage = smem + st * kQStageBytes;
          mbar_arrive_expect_tx(&full[st], kQStageBytes);
          tma_load_2d_multicast(stage + rn * kQHalfBytes, &amap, &full[st], kt * kQBK,
                                m0 + rn * (kQBM / 2), a_mask);
          tma_load_2d_multicast(stage + kQTileBytes + rm * kQHalfBytes, &bmap, &full[st],
                                kt * kQBK, n0 + rm * (kQBN / 2), b_mask);
        }
      }
    }
    __syncwarp();
    cluster_sync();  // the peers no longer read this block's barriers
  } else {
    // ---- consumers: warpgroup wg owns all 128 x 128 outputs of each of its
    // tiles, rows [0, 64) in acc[0] and [64, 128) in acc[1] ----
    regs_alloc<232>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = 16 * (t / 32) + lane / 4, c2 = 2 * (lane % 4);
    // A stage is released by lane 0 of each warp of this warpgroup, to every
    // block of the cluster
    auto release = [&](int slot) {
      __syncwarp();
      if (lane == 0)
        for (int b = 0; b < kQCluster; ++b) mbar_arrive_cluster(&empty[slot % kQStages], b);
    };
    for (int j = wg, n = 0;; j += 2, ++n) {
      const int quad = cluster + j * clusters;
      if (quad >= quads) break;
      // The other warpgroup has issued quad j - 1's last stage: warpgroup 1's
      // n-th turn is the n-th phase of turn[1], warpgroup 0's (n - 1)-th
      if (j > 0) mbar_wait(&turn[wg], (wg == 0 ? n - 1 : n) & 1);
      // A tile past M or N is all zero-fill and stores nothing
      const int m0 = (quad / quads_n * 2 + rm) * kQBM, n0 = (quad % quads_n * 2 + rn) * kQBN;
      // The tile's dequant factors, one column and one row a thread, loaded
      // now so that the main loop hides their latency (0 past N or M)
      float pre_w = 0.f, pre_b = 0.f, pre_s = 0.f;
      if constexpr (kEpi != kInt32) {
        if (n0 + t < N) {
          pre_w = sw[n0 + t];
          if (kEpi == kF32 && bias != nullptr) pre_b = bias[n0 + t];
        }
        if (m0 + t < M) pre_s = sx[m0 + t];
      }
      int acc[2][kQBN / 2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < kQBN / 2; ++i) acc[h][i] = 0;
      const int first = j * ktiles;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int it = first + kt, st = it % kQStages;
        mbar_wait(&full[st], (it / kQStages) & 1);
        const uint32_t a_base = smem_addr(smem + st * kQStageBytes);
        const uint32_t b_base = a_base + kQTileBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQBK / 32; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            wgmma_ss<kQBN>(acc[h], desc_b128(a_base + h * 64 * 128 + kk * 32, 16, 1024),
                           desc_b128(b_base + kk * 32, 16, 1024), 1);
        wgmma_commit();
        // Keep this stage's products in flight; the previous stage's are done
        wgmma_wait<1>();
        if (kt > 0) release(it - 1);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&turn[wg ^ 1]);  // the other warpgroup's turn
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      release(first + ktiles - 1);  // the tile's last stage

      // Epilogue, while the other warpgroup multiplies its tile: acc[h] holds
      // rows 64 h + r0 (4 jj + 0, 1) and 64 h + r0 + 8 (4 jj + 2, 3), columns
      // 8 jj + c2 + (0, 1). The dequant factors go through shared memory
      // (this warpgroup's copy for tiles of n's parity; the barrier also
      // orders the last reads of the copy two tiles back before these
      // writes); the outputs are stored from registers in pairs.
      float* scale = reinterpret_cast<float*>(smem + kQScaleOffset) +
                     (2 * wg + (n & 1)) * kQScaleFloats;
      if constexpr (kEpi != kInt32) {
        scale[t] = pre_w;
        scale[kQBN + t] = pre_b;
        scale[2 * kQBN + t] = pre_s;
        bar_sync(1 + wg, 128);
      }
      float s[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          s[h][hh] = kEpi == kInt32 ? 0.f : scale[2 * kQBN + 64 * h + r0 + 8 * hh];
#pragma unroll
      for (int jj = 0; jj < kQBN / 8; ++jj) {
        const int col = n0 + 8 * jj + c2;
        if (col >= N) continue;
        const bool two = col + 1 < N;
        ColScale cs{0.f, 0.f, 0.f, 0.f};
        if constexpr (kEpi != kInt32) {
          const float2 w2 = *reinterpret_cast<const float2*>(scale + 8 * jj + c2);
          const float2 b2 = *reinterpret_cast<const float2*>(scale + kQBN + 8 * jj + c2);
          cs = ColScale{w2.x, w2.y, b2.x, b2.y};
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = m0 + 64 * h + r0 + 8 * hh;
            if (row >= M) continue;
            store_pair<kEpi>(out, (size_t)row * N + col, two, vec, acc[h][4 * jj + 2 * hh],
                             acc[h][4 * jj + 2 * hh + 1], s[h][hh], cs, bias != nullptr);
          }
      }
    }  // quad
    cluster_sync();  // the peers no longer read this block's barriers or write its ring
  }
}

// The plans agree with what the kernel loads: A dims (K, M) and B dims (K,
// N), each row K bytes apart, boxes of 128 K bytes by 64 rows, half a tile
bool plan_matches(const long long* p, int M, int N, int K) {
  return p[0] == K && p[1] == M && p[2] == K && p[3] == kQBK && p[4] == kQBM / 2 && p[5] == K &&
         p[6] == N && p[7] == K && p[8] == kQBK && p[9] == kQBN / 2;
}

template <int kEpi>
cudaError_t launch_wgmma(const int8_t* A, const int8_t* B, const long long* plan, const float* sx,
                         const float* sw, const float* bias, void* out, int M, int N, int K,
                         cudaStream_t stream) {
  auto kernel = int8_wgmma_kernel<kEpi>;
  static bool configured[kMaxDevices] = {};
  static int max_clusters[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kQSmemBytes);
    if (err != cudaSuccess) return err;
    // The clusters the card holds at once: a GPC's SMs need not split into
    // whole clusters of four
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(sms / kQCluster * kQCluster);
    cfg.blockDim = dim3(kQThreads);
    cfg.dynamicSmemBytes = kQSmemBytes;
    err = cudaOccupancyMaxActiveClusters(&max_clusters[dev], kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (max_clusters[dev] < 1) return cudaErrorInvalidConfiguration;
    configured[dev] = true;
  }
  CUtensorMap amap, bmap;
  err = encode_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, A, 2, plan);
  if (err == cudaSuccess)
    err = encode_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, B, 2, plan + kPlanLen);
  if (err != cudaSuccess) return err;
  // Persistent: one block an SM (its ring takes 192 KB), as many clusters as
  // the card holds at once, each walking quads of output tiles
  const long long quads =
      (long long)((M + 2 * kQBM - 1) / (2 * kQBM)) * ((N + 2 * kQBN - 1) / (2 * kQBN));
  if (quads > INT32_MAX / kQCluster) return cudaErrorInvalidValue;
  const int grid = kQCluster * (int)(quads < max_clusters[dev] ? quads : max_clusters[dev]);
  kernel<<<grid, kQThreads, kQSmemBytes, stream>>>(amap, bmap, sx, sw, bias, out, M, N, K,
                                                   N % 2 == 0);
  return cudaGetLastError();
}

template <int kEpi>
cudaError_t dispatch(const int8_t* A, const int8_t* B, const float* sx, const float* sw,
                     const float* bias, void* out, int M, int N, int K, cudaStream_t stream) {
  const bool aligned = K % 16 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(B) % 16 == 0;
  return aligned ? launch<kEpi, true>(A, B, sx, sw, bias, out, M, N, K, stream)
                 : launch<kEpi, false>(A, B, sx, sw, bias, out, M, N, K, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error of the launch (0 = success).
// epilogue: 0 int32 out; 1 float32 out (bias may be null); 2 bfloat16 out (no bias).
// plan: the Hopper instance's tensor maps of A and B, 5 values each: dims
// (K, M) / (K, N), the byte stride of dim 1 (K), box (128, 128); it takes K a
// positive multiple of 16 and 16-byte aligned A and B, and refuses anything
// else. A null plan runs the mma.sync instance, which takes any K >= 0.
int novic_int8_matmul(const void* a, const void* b, const long long* plan, const float* sx,
                      const float* sw, const float* bias, void* out, int M, int N, int K,
                      int epilogue, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || out == nullptr) return (int)cudaErrorInvalidValue;
  if (epilogue != kInt32 && (sx == nullptr || sw == nullptr)) return (int)cudaErrorInvalidValue;
  if (epilogue != kF32 && bias != nullptr) return (int)cudaErrorInvalidValue;
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* B = static_cast<const int8_t*>(b);
  cudaStream_t st = (cudaStream_t)stream;
  if (plan != nullptr) {
    if (K == 0 || K % 16 != 0 || reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(B) % 16 != 0 || !plan_matches(plan, M, N, K))
      return (int)cudaErrorInvalidValue;
    switch (epilogue) {
      case kInt32: return (int)launch_wgmma<kInt32>(A, B, plan, sx, sw, bias, out, M, N, K, st);
      case kF32: return (int)launch_wgmma<kF32>(A, B, plan, sx, sw, bias, out, M, N, K, st);
      case kBF16: return (int)launch_wgmma<kBF16>(A, B, plan, sx, sw, bias, out, M, N, K, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (epilogue) {
    case kInt32: return (int)dispatch<kInt32>(A, B, sx, sw, bias, out, M, N, K, st);
    case kF32: return (int)dispatch<kF32>(A, B, sx, sw, bias, out, M, N, K, st);
    case kBF16: return (int)dispatch<kBF16>(A, B, sx, sw, bias, out, M, N, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
