// The port's one s8 wgmma GEMM engine (sm_90a): (M, K) s8 x (N, K)^T s8 -> s32,
// both operands K-major, with five epilogues. Included by int8_matmul.cu (K2's
// Hopper instance: epilogues 0-2) and tiled_matmul.cu (X3's s8 path: 3 and 4),
// each library building the epilogues it launches; everything here lives in
// namespace q8 inside the includer's anonymous namespace.
//
// Epilogues, chosen by a template argument:
//   kInt32      out = acc, stored from registers in pairs;
//   kF32        out = ((float)acc * sx[m]) * sw[n] (+ bias[n]), the order of
//               novic_tpu/ops/int8_matmul.py `int8_dense`;
//   kBF16       out = bf16_rn(((float)acc * sx[m]) * sw[n]), no bias;
//   kInt32Tma   out = acc by TMA store: each consumer warp stages its 16 rows
//               of a half-tile 32 columns at a time (2 KB, 128-byte swizzled as
//               the out map reads it) in one of its two slots, and its lane 0
//               stores the piece; a slot is rewritten once the store issued
//               from it two pieces earlier has read it, so the staging runs
//               beside the stores and no warp waits for another. The map's
//               extents drop the rows past M and columns past N;
//   kChecksum   out[m, n / bn] += the sum of acc over each row's bn-blocks:
//               each thread sums its columns along the row until a block ends,
//               the four threads of a row combine by shuffles, and one int32
//               atomic per row, tile and block adds it into the zeroed out.
//               int32 sums wrap, and sums mod 2^32 do not depend on order, so
//               the result is exact whatever the order of the atomics.
// The dequant epilogues are written with __int2float_rn, __fmul_rn and
// __fadd_rn so that nvcc cannot contract a*b+c into an FMA: PyTorch rounds
// each op separately, and acc passes 2^24 at K=3072, so the int->float
// rounding mode matters too.
//
// Design: persistent blocks, one an SM, of three warpgroups, in clusters of 2 x
// 2 that walk quads of 128 x 128 output tiles (tile rows 2i, 2i + 1 by tile
// columns 2c, 2c + 1). Warpgroup 2 is the producer: one thread streams half of
// its block's A tile (64 rows x 128 K bytes), multicast into the two blocks of
// its tile row, and half of its B tile, multicast into the two blocks of its
// tile column, by TMA, 128-byte swizzled, into a ring of six 32 KB stages with
// mbarriers (`full` when a stage's bytes have landed, `empty` when its
// consumer's four warps in every block have read it), so A and B are each read
// from L2 once for two tiles. Warpgroups 0 and 1 take alternate 128 x 128
// output tiles (ping-pong) and run wgmma m64n128k32 s8 -> s32 on them, two a
// k-step (rows 0-63 and 64-127), keeping one stage's products in flight; a k32
// step moves the descriptors 32 bytes along a swizzle row. Each runs its main
// loop when the other has issued its last stage (`turn` barriers), so while one
// warpgroup stores a finished tile, the other multiplies the next with the
// whole ring ahead of it: the output stream runs beside the tensor cores
// instead of after them. A tile's row and column scales and bias are loaded as
// its main loop starts and staged in shared memory for its epilogue. The
// tensor maps' extents zero-fill the ragged M, N and K edges. Quads walk n
// fastest, so the tiles in flight share a few A row panels and all of B.
//
// Shared memory: the ring (192 KB), then kInt32Tma's staging (8 consumer
// warps x 2 slots x 2 KB = 32 KB, which fits beside the whole ring: 224 KB of
// the 227 KB a block may take), the barriers, and the dequant epilogues'
// scales (6 KB, only where there are any).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {
namespace q8 {

enum Epilogue { kInt32 = 0, kF32 = 1, kBF16 = 2, kInt32Tma = 3, kChecksum = 4 };

constexpr int kMaxDevices = 64;

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

// Outputs (row, col) and, if `two`, (row, col + 1) at flat index `idx` in the
// register epilogues (kInt32, kF32, kBF16); the bias is added where `has_bias`
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

constexpr int kQBM = 128, kQBN = 128, kQBK = 128;  // a warpgroup's tile; K bytes per stage
constexpr int kQStages = 6;                        // one ring, both consumers
constexpr int kQThreads = 384;                     // consumer warpgroups 0, 1; producer 2
constexpr int kQTileBytes = kQBM * kQBK;           // 128 rows of 128 bytes
constexpr int kQHalfBytes = kQTileBytes / 2;       // the 64 rows one block loads
constexpr int kQStageBytes = 2 * kQTileBytes;      // A and B: 32 KB
constexpr int kQRingBytes = kQStages * kQStageBytes;
constexpr int kQPieceRows = 16, kQPieceCols = 32;  // kInt32Tma: a warp's store box
constexpr int kQPieceBytes = kQPieceRows * kQPieceCols * 4;  // 2 KB
constexpr int kQScaleFloats = 3 * kQBN;
constexpr int kPlanLen = 5;                        // per map: 2 dims, 1 stride, 2 box
constexpr int kQCluster = 4;                       // 2 x 2 blocks: a quad of tiles

// Shared memory of the epilogue's instance: the ring, the store staging, the
// barriers (full and empty per stage, two `turn`), then the dequant factors
// for each consumer, twice (tiles alternate): the weight scales and bias of
// its 128 columns and the scales of its 128 rows
template <int kEpi>
struct Layout {
  static constexpr int kStaging = kEpi == kInt32Tma ? 2 * 4 * 2 * kQPieceBytes : 0;
  static constexpr int kBarOffset = kQRingBytes + kStaging;
  static constexpr int kScaleOffset = kBarOffset + (2 * kQStages + 2) * 8;
  static constexpr int kSmemBytes =
      kScaleOffset + (kEpi <= kBF16 ? 2 * 2 * kQScaleFloats * 4 : 0) + 1024;  // + alignment
};
static_assert(Layout<kInt32Tma>::kSmemBytes <= 232448,
              "kInt32Tma's staging must fit beside the ring");

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
// one phase of it). `omap` is read by kInt32Tma only, `bn` by kChecksum only.
template <int kEpi>
__global__ void __cluster_dims__(kQCluster, 1, 1) __launch_bounds__(kQThreads, 1)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                  const __grid_constant__ CUtensorMap omap, const float* __restrict__ sx,
                  const float* __restrict__ sw, const float* __restrict__ bias,
                  void* __restrict__ out, int M, int N, int K, int bn, bool vec) {
  using L = Layout<kEpi>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
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
    const int t = threadIdx.x % 128, lane = t % 32, warp = t / 32;
    const int r0 = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
    // kInt32Tma: this warp's two staging slots, and the pieces it has stored
    uint8_t* slots = smem + kQRingBytes + (wg * 4 + warp) * 2 * kQPieceBytes;
    int pieces = 0;
    if constexpr (kEpi == kInt32Tma) {
      if (lane == 0) prefetch_map(&omap);
    }
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
      if constexpr (kEpi == kF32 || kEpi == kBF16) {
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
      // 8 jj + c2 + (0, 1).
      if constexpr (kEpi == kInt32Tma) {
        // Piece (h, q): this warp's rows [64 h + 16 warp, +16) by columns
        // [32 q, +32), a 16 x 128-byte box whose 16-byte chunks are XOR-ed
        // by (row % 8) = lane / 4, as the map's 128-byte swizzle lays it out
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < kQBN / kQPieceCols; ++q) {
            const int gm = m0 + 64 * h + kQPieceRows * warp, gn = n0 + kQPieceCols * q;
            if (gm >= M || gn >= N) continue;  // warp-uniform: the piece lies past the output
            uint8_t* slot = slots + (pieces & 1) * kQPieceBytes;
            if (lane == 0) bulk_wait_read<1>();  // the store issued from this slot has read it
            __syncwarp();
#pragma unroll
            for (int jq = 0; jq < kQPieceCols / 8; ++jq)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int row = lane / 4 + 8 * hh, chunk = 2 * jq + (lane % 4) / 2;
                const int jj = q * (kQPieceCols / 8) + jq;
                *reinterpret_cast<int2*>(slot + row * 128 + ((chunk ^ (row & 7)) << 4) +
                                         8 * (lane & 1)) =
                    make_int2(acc[h][4 * jj + 2 * hh], acc[h][4 * jj + 2 * hh + 1]);
              }
            fence_proxy_async();
            __syncwarp();
            if (lane == 0) {
              tma_store_2d(&omap, slot, gn, gm);
              bulk_commit();
            }
            ++pieces;
          }
      } else if constexpr (kEpi == kChecksum) {
        // Each row's sums over its bn-blocks, in registers: the thread's two
        // columns of each 8-column chunk, summed along the row until a block
        // ends, then over the four threads of the row (lanes 4g .. 4g + 3),
        // whose chunk walk is the same; one atomic per row, tile and block.
        // Sums are unsigned, so they wrap as int32 does.
        if (n0 < N) {
          int* o = static_cast<int*>(out);
          const int groups = N / bn;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = m0 + 64 * h + r0 + 8 * hh;
              int blk = n0 / bn, blk_end = (blk + 1) * bn;  // warp-uniform
              unsigned run = 0u;
#pragma unroll
              for (int jj = 0; jj < kQBN / 8; ++jj) {
                const int col = n0 + 8 * jj;
                if (col >= N) break;
                if (col >= blk_end) {
                  run += __shfl_xor_sync(0xffffffffu, run, 1);
                  run += __shfl_xor_sync(0xffffffffu, run, 2);
                  if (c2 == 0 && row < M) atomicAdd(o + (size_t)row * groups + blk, (int)run);
                  run = 0u;
                  ++blk;
                  blk_end += bn;
                }
                run += (unsigned)acc[h][4 * jj + 2 * hh] + (unsigned)acc[h][4 * jj + 2 * hh + 1];
              }
              run += __shfl_xor_sync(0xffffffffu, run, 1);
              run += __shfl_xor_sync(0xffffffffu, run, 2);
              if (c2 == 0 && row < M) atomicAdd(o + (size_t)row * groups + blk, (int)run);
            }
        }
      } else {
        // The dequant factors go through shared memory (this warpgroup's copy
        // for tiles of n's parity; the barrier also orders the last reads of
        // the copy two tiles back before these writes); the outputs are stored
        // from registers in pairs.
        float* scale = reinterpret_cast<float*>(smem + L::kScaleOffset) +
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
      }
    }  // quad
    if constexpr (kEpi == kInt32Tma) {
      if (lane == 0) bulk_wait<0>();  // this warp's stores are done before its block leaves
    }
    cluster_sync();  // the peers no longer read this block's barriers or write its ring
  }
}

// The plans agree with what the kernel loads: A dims (K, M) and B dims (K,
// N), each row K bytes apart, boxes of 128 K bytes by 64 rows, half a tile
bool plan_matches(const long long* p, int M, int N, int K) {
  return p[0] == K && p[1] == M && p[2] == K && p[3] == kQBK && p[4] == kQBM / 2 && p[5] == K &&
         p[6] == N && p[7] == K && p[8] == kQBK && p[9] == kQBN / 2;
}

// ... and kInt32Tma's out map stores what a warp stages: int32 out dims (N,
// M), rows 4 N bytes apart, boxes of 32 columns by 16 rows
bool out_plan_matches(const long long* p, int M, int N) {
  return p[0] == N && p[1] == M && p[2] == 4ll * N && p[3] == kQPieceCols && p[4] == kQPieceRows;
}

// Launch the epilogue's instance on `stream`: plan holds the maps of A and B
// (and, for kInt32Tma, of the int32 out) as the wrappers' _tma_plan lay them
// out; the caller has checked them against plan_matches / out_plan_matches
template <int kEpi>
cudaError_t launch_wgmma(const int8_t* A, const int8_t* B, const long long* plan, const float* sx,
                         const float* sw, const float* bias, void* out, int M, int N, int K,
                         int bn, cudaStream_t stream) {
  using L = Layout<kEpi>;
  auto kernel = int8_wgmma_kernel<kEpi>;
  static bool configured[kMaxDevices] = {};
  static int max_clusters[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
    if (err != cudaSuccess) return err;
    // The clusters the card holds at once: a GPC's SMs need not split into
    // whole clusters of four
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(sms / kQCluster * kQCluster);
    cfg.blockDim = dim3(kQThreads);
    cfg.dynamicSmemBytes = L::kSmemBytes;
    err = cudaOccupancyMaxActiveClusters(&max_clusters[dev], kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (max_clusters[dev] < 1) return cudaErrorInvalidConfiguration;
    configured[dev] = true;
  }
  CUtensorMap amap, bmap, omap{};
  err = encode_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, A, 2, plan);
  if (err == cudaSuccess)
    err = encode_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, B, 2, plan + kPlanLen);
  if (err == cudaSuccess && kEpi == kInt32Tma)
    err = encode_map(&omap, CU_TENSOR_MAP_DATA_TYPE_INT32, out, 2, plan + 2 * kPlanLen);
  if (err != cudaSuccess) return err;
  // Persistent: one block an SM (its ring takes 192 KB), as many clusters as
  // the card holds at once, each walking quads of output tiles
  const long long quads =
      (long long)((M + 2 * kQBM - 1) / (2 * kQBM)) * ((N + 2 * kQBN - 1) / (2 * kQBN));
  if (quads > INT32_MAX / kQCluster) return cudaErrorInvalidValue;
  const int grid = kQCluster * (int)(quads < max_clusters[dev] ? quads : max_clusters[dev]);
  kernel<<<grid, kQThreads, L::kSmemBytes, stream>>>(amap, bmap, omap, sx, sw, bias, out, M, N, K,
                                                      bn, N % 2 == 0);
  return cudaGetLastError();
}

}  // namespace q8
}  // namespace
