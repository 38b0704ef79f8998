// Tiled GEMM for Hopper (sm_90a): x (M, K) . w (K, N) with w row-major (K, N),
// in three input forms, written out whole or reduced to a per-block checksum.
//
// Replaces the Pallas kernels exp/pallas_int8_matmul.py `make_matmul` (X3;
// def :46, pallas_call :51, body `matmul_kernel`) and
// exp/pallas_int8_rate_pin.py `make_mm` (def :46, pallas_call :50, body
// `_kernel`): a tiled product accumulated in scratch, int8 -> int32, bf16 ->
// float32 or float32 -> float32, stored whole as (M, N) (`make_matmul`) or
// summed over each bn-wide column block of each row into (M, N / bn) float32
// (`make_mm`, whose int32 sums are cast to float32 after the sum). The TPU's
// bm, bn and bk were VMEM tilings; here bn only names the checksum's column
// blocks, and the kernel picks its own tiles:
//   s8    mma.sync m16n8k32 s8 -> s32 (K2's core, int8_matmul.cu). ldmatrix
//         has no 8-bit transpose, so the s8 B tile stays row-major (k, n) in
//         shared memory as cp.async lands it (its 16-byte chunks XOR-swizzled
//         by row), and each thread gathers the four k bytes of its fragment's
//         column with byte loads and packs them.
//   bf16  wgmma m64n256k16 bf16 -> f32 fed by TMA (below).
//   f32   exact float32 FMA on the CUDA cores, fed by TMA (below): Hopper's
//         tensor cores have no full float32 mode, and TF32 is not the product
//         the probe computes.
// Epilogue 0 stores (M, N): int32 for s8, float32 otherwise. Epilogue 1, the
// checksum: each block sums its tile's outputs per row and 8-column chunk in
// shared memory, then per bn-block, and adds that into out[m, n / bn] with one
// atomic per row, block and bn-block. The s8 sums are int32 (the wrapper
// zeroes the buffer and casts it to float32 after), so their wrap is the
// plain version's and they are exact; the float32 sums run in an order that
// varies from run to run.
//
// Layout: x (M, K) and w (K, N) row-major, 16-byte aligned, K and N multiples
// of 16 (the wrapper checks); any M >= 1; the checksum's bn a multiple of 8
// that divides N.
//
// Design. s8 (right and simple first): blocks of 8 warps own a 128 x 128
// output tile and walk K 64 bytes at a time through a 4-stage cp.async ring,
// each warp 64 x 32 outputs in 4 x 4 m16n8 accumulators, A fragments by
// ldmatrix.x4, as K2's mma.sync instance does. f32 (Hopper): persistent blocks,
// one an SM, of two consumer warpgroups and a producer warpgroup, walking 128 x
// 128 output tiles (n fastest); setmaxnreg gives the consumers 232 registers a
// thread and the producer 40 (ptxas holds a block of 9 warps to 168 registers a
// thread, and the FMA warps spill there). One producer thread streams each tile's
// stages by TMA through a 4-stage mbarrier ring of 32 KB stages: x as 128 rows
// of 32 k (one 128-byte row each, K-major as x lies) and w as four boxes of 32
// k-rows by 32 columns, all 128-byte swizzled. A stage is complete on its
// `full` barrier when its 32 KB have landed and free on its `empty` one when
// each consumer warp has read it, so the consumers never meet at a block
// barrier and the producer runs into the next tile while they finish this one.
// Each consumer thread owns 8 rows x 8 columns of the tile and, for each 4 k,
// reads one float4 along k from each of its rows of x (no transposed copy; the
// swizzle puts the warp's two rows in other banks) and two float4 of w per k,
// then issues 256 FMAs; each output is one FMA chain in k order. Every shared-
// memory read is a per-thread offset plus a constant. The checksum is taken in
// registers and shuffles (a tile row lies in 16 lanes of one warp): one atomic
// per row and tile where bn is a multiple of 128, else
// one per row and 8 columns. bf16 (Hopper): persistent blocks of three
// warpgroups, one block an SM, in clusters of two; each cluster walks pairs
// of 128 x 256 output tiles that share their columns (tile rows 2i, 2i + 1).
// Warpgroup 2 is the producer: one thread streams its x tile (128 rows x 64
// k, K-major) and half of the pair's w stage (two of its four 64-column
// boxes of 64 k-rows: the MN-major B operand) by TMA through a 4-stage ring
// of 48 KB stages, 128-byte swizzled; the w boxes are multicast into both
// blocks of the cluster, so each stage of w is read from L2 once for two
// tiles. A stage is complete on its `full` mbarrier when its 48 KB have
// landed, and free on its `empty` one when every consumer warp of both
// blocks has released it. Warpgroups 0 and 1 each own 64 rows x 256 columns
// in 128 float32 registers a thread and issue four wgmma m64n256k16 a stage
// (w with the transpose bit), keeping one stage's products in flight while
// the next is issued; the producer runs ahead into the next tile while they
// store. The tensor maps' extents zero-fill the ragged M, K and N edges (a
// tile row past M is all zero-fill); stores are masked. The bf16 checksum
// is taken in registers: each thread sums its columns along the row until a
// bn-block ends, the four threads of a row combine by shuffles, and one
// atomic per row and block adds it to out.
//
// Bound on the H100 at `make_matmul`'s (16384, 1280) . (1280, 5120), 214.7 GOP:
// s8 0.1085 ms at the 1,979 TOPS int8 peak (its bytes, 363 MB with the int32
// out, 0.1084 ms at 3.35 TB/s); bf16 0.2171 ms at 989 TFLOP/s (bytes 0.1166
// ms). `make_mm` at M = 8192, 107.4 GOP, writes almost nothing: f32 1.603 ms at
// the 67 TFLOP/s float32 rate, bf16 0.1086 ms, s8 0.0543 ms, all operations.
// The design keeps x and w in L2 and writes each output once; mma.sync (not
// wgmma) and the s8 byte gathers hold the s8 path below its rate. The f32
// path issues 16 shared-memory float4 reads per 256 FMAs a thread, so its
// issue slots, not shared memory, set its ceiling near 94% of the FMA rate.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128;  // block tile
constexpr int kThreads = 256;
constexpr int kChunks = kBN / 8;     // 8-column chunks of a tile row (checksum)
constexpr int kMaxDevices = 64;

enum In { kS8 = 0, kBF16 = 1, kF32 = 2 };

__device__ __forceinline__ int add(int a, int b) {  // int32 sum that wraps, as the plain version's
  return (int)((unsigned)a + (unsigned)b);
}

// The s8 checksum epilogue, second half: `part` holds (kBM rows, kChunks)
// sums of 8 columns; each row's chunks are summed per bn-block and added to
// out.
__device__ __forceinline__ void checksum_flush(const int* part, int* __restrict__ out, int m0,
                                               int n0, int M, int N, int bn) {
  __syncthreads();
  if (threadIdx.x >= kBM) return;
  const int row = m0 + threadIdx.x;
  if (row >= M) return;
  const int groups = N / bn;
  int sum = 0;
  int cur = -1;
  for (int q = 0; q < kChunks; ++q) {
    const int col = n0 + 8 * q;
    if (col >= N) break;
    if (col / bn != cur) {
      if (cur >= 0) atomicAdd(out + (size_t)row * groups + cur, sum);
      cur = col / bn;
      sum = 0;
    }
    sum = add(sum, part[threadIdx.x * kChunks + q]);
  }
  if (cur >= 0) atomicAdd(out + (size_t)row * groups + cur, sum);
}

// ---- s8 path (mma.sync) -----------------------------------------------------

constexpr int kBKBytes = 64;  // K bytes per stage
constexpr int kStages = 4;
constexpr int kWarpsN = 4;
constexpr int kWM = 64, kWN = 32;  // warp tile
constexpr int kMFrags = kWM / 16, kNFrags = kWN / 8;
constexpr int kLdA = kBKBytes + 16;  // A row stride in bytes: ldmatrix rows conflict-free
constexpr int kABytes = kBM * kLdA;

template <int kIn>
struct TC;
template <>
struct TC<kS8> {
  using T = int8_t;
  using Acc = int;
  static constexpr int kBK = 64;   // k per stage
  static constexpr int kLdB = kBN;  // B row stride in bytes (chunks swizzled by row)
};

template <int kIn>
__host__ __device__ constexpr int stage_bytes() { return kABytes + TC<kIn>::kBK * TC<kIn>::kLdB; }
template <int kIn>
__host__ __device__ constexpr int smem_bytes() { return kStages * stage_bytes<kIn>(); }

// Byte offset of (row r, byte col) in the s8 B tile: 16-byte chunk (col / 16)
// XOR (r / 4) % 8, so the gathers of rows 4c + e (c = 0..3) hit four chunks
__device__ __forceinline__ int s8_b_offset(int r, int col) {
  return r * kBN + ((((col >> 4) ^ (r >> 2)) & 7) << 4) + (col & 15);
}

// Stage `kt` of the operands: x rows [m0, m0 + kBM) at K bytes [kt * 64, +64),
// and w rows [kt * kBK, +kBK) at columns [n0, n0 + kBN). Rows at or past M or K
// and columns at or past N are zero-filled.
template <int kIn>
__device__ __forceinline__ void load_stage(uint8_t* stage, const uint8_t* __restrict__ x,
                                           const uint8_t* __restrict__ w, int m0, int n0, int M,
                                           int N, int K, int kt) {
  using T = typename TC<kIn>::T;
  constexpr int kBK = TC<kIn>::kBK;
  const int kbytes = K * (int)sizeof(T), nbytes = N * (int)sizeof(T);
#pragma unroll
  for (int it = 0; it < kBM * 4 / kThreads; ++it) {  // A: 4 chunks of 16 bytes a row
    const int i = threadIdx.x + it * kThreads;
    const int r = i / 4, cb = 16 * (i % 4);
    const int gk = kt * kBKBytes + cb;
    const bool valid = m0 + r < M && gk < kbytes;
    cp_async16(smem_u32(stage + r * kLdA + cb),
               valid ? x + (size_t)(m0 + r) * kbytes + gk : x, valid ? 16 : 0);
  }
  constexpr int kRowChunks = kBN * (int)sizeof(T) / 16;
  uint8_t* bs = stage + kABytes;
#pragma unroll
  for (int it = 0; it < kBK * kRowChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kRowChunks, cb = 16 * (i % kRowChunks);
    const int gk = kt * kBK + r, gn = n0 * (int)sizeof(T) + cb;
    const bool valid = gk < K && gn < nbytes;
    cp_async16(smem_u32(bs + s8_b_offset(r, cb)), valid ? w + (size_t)gk * nbytes + gn : w,
               valid ? 16 : 0);
  }
}

// The s8 B fragment of column `col` at k rows [k0 + 4c, +4) (b0) and
// [k0 + 16 + 4c, +4) (b1)
__device__ __forceinline__ void s8_b_frag(const int8_t* bs, int k0, int c, int col, uint32_t& b0,
                                          uint32_t& b1) {
  uint32_t v[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = (uint8_t)bs[s8_b_offset(k0 + 4 * c + e, col)];
    v[4 + e] = (uint8_t)bs[s8_b_offset(k0 + 16 + 4 * c + e, col)];
  }
  b0 = v[0] | (v[1] << 8) | (v[2] << 16) | (v[3] << 24);
  b1 = v[4] | (v[5] << 8) | (v[6] << 16) | (v[7] << 24);
}

template <int kIn, bool kChecksum>
__global__ void __launch_bounds__(kThreads, 2)
tc_gemm_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
               typename TC<kIn>::Acc* __restrict__ out, int M, int N, int K, int bn) {
  using Acc = typename TC<kIn>::Acc;
  constexpr int kBK = TC<kIn>::kBK;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warp_m = warp / kWarpsN, warp_n = warp % kWarpsN;
  const int g = lane / 4, c = lane % 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ktiles = (K + kBK - 1) / kBK;
  auto stage = [&](int s) { return smem + s * stage_bytes<kIn>(); };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage<kIn>(stage(s), x, w, m0, n0, M, N, K, s);
    cp_async_commit();
  }

  Acc acc[kMFrags][kNFrags][4];
#pragma unroll
  for (int i = 0; i < kMFrags; ++i)
#pragma unroll
    for (int j = 0; j < kNFrags; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // ldmatrix.x4 row addresses of A: lanes 0-15 rows 0-15 at bytes 0-15 of the
  // 32-byte k-step, lanes 16-31 the same rows at bytes 16-31 -> a0..a3.
  const int a_row = warp_m * kWM + (lane % 16), a_col = (lane / 16) * 16;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();               // ... for every thread; stage kt - 1 is consumed
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage<kIn>(stage(next % kStages), x, w, m0, n0, M, N, K, next);
    cp_async_commit();
    const uint8_t* st = stage(kt % kStages);
    const uint32_t as = smem_u32(st);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {  // two 32-byte k-steps of A per stage
      uint32_t af[kMFrags][4];
#pragma unroll
      for (int i = 0; i < kMFrags; ++i)
        ldmatrix_x4(af[i], as + (a_row + i * 16) * kLdA + ks * 32 + a_col);
      const int8_t* bs = reinterpret_cast<const int8_t*>(st + kABytes);
#pragma unroll
      for (int j = 0; j < kNFrags; ++j) {
        uint32_t b0, b1;
        s8_b_frag(bs, ks * 32, c, warp_n * kWN + j * 8 + g, b0, b1);
#pragma unroll
        for (int i = 0; i < kMFrags; ++i) mma_s8(acc[i][j], af[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // acc[i][j]: rows g (e = 0, 1) and g + 8 (e = 2, 3), columns 2c + (e & 1)
  if constexpr (kChecksum) {
    __syncthreads();  // the ring is free: reuse it for the chunk sums
    Acc* part = reinterpret_cast<Acc*>(smem);
#pragma unroll
    for (int i = 0; i < kMFrags; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < kNFrags; ++j) {
          Acc s = add(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
          s = add(s, __shfl_xor_sync(0xffffffffu, s, 1));
          s = add(s, __shfl_xor_sync(0xffffffffu, s, 2));
          if (c == 0)
            part[(warp_m * kWM + i * 16 + g + 8 * hh) * kChunks + (warp_n * kWN + j * 8) / 8] = s;
        }
    checksum_flush(part, out, m0, n0, M, N, bn);
  } else {
#pragma unroll
    for (int i = 0; i < kMFrags; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + warp_m * kWM + i * 16 + g + 8 * hh;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < kNFrags; ++j) {
          const int col = n0 + warp_n * kWN + j * 8 + 2 * c;
          if (col >= N) continue;
          *reinterpret_cast<int2*>(out + (size_t)row * N + col) =
              make_int2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
        }
      }
  }
}

// ---- bf16 path (TMA + wgmma) ------------------------------------------------

constexpr int kHBM = 128, kHBN = 256, kHBK = 64;  // block tile, k per stage
constexpr int kHStages = 4;
constexpr int kHThreads = 384;                    // consumer warpgroups 0, 1; producer 2
constexpr int kHChunks = kHBN / 8;                // 8-column chunks of a tile row (checksum)
constexpr int kXBytes = kHBM * kHBK * 2;          // x tile: 128 rows of 128 bytes
constexpr int kWBoxBytes = kHBK * 128;            // w box: 64 k-rows of 64 columns
constexpr int kWBytes = (kHBN / 64) * kWBoxBytes;
constexpr int kHStageBytes = kXBytes + kWBytes;   // 48 KB
constexpr int kHBarOffset = kHStages * kHStageBytes;
constexpr int kHSmemBytes = kHBarOffset + 2 * kHStages * 8 + 1024;  // + alignment
constexpr int kPlanLen = 5;                       // per map: 2 dims, 1 stride, 2 box
constexpr int kCluster = 2;                       // blocks of a cluster: tile rows that share w

template <bool kChecksum>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kHThreads, 1)
bf16_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                 float* __restrict__ out, int M, int N, int K, int bn) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kHBarOffset);
  uint64_t* empty = full + kHStages;
  const int wg = threadIdx.x / 128;
  // The cluster's two blocks take tile rows 2i and 2i + 1 of one tile column
  // (a row past M is all zero-fill and stores nothing) and each loads half
  // of the shared w stage, multicast into both
  const uint32_t rank = cluster_rank(), peer = rank ^ 1;
  const int tiles_n = (N + kHBN - 1) / kHBN;
  const int pairs = (M + kCluster * kHBM - 1) / (kCluster * kHBM) * tiles_n;
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  const int ktiles = (K + kHBK - 1) / kHBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kHStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 8);  // each consumer warp of both blocks
    }
    mbar_fence_init();
  }
  cluster_sync();  // the peer's barriers are initialised before anything reaches them

  if (wg == 2) {
    // ---- producer: one thread issues every load ----
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      prefetch_map(&xmap);
      prefetch_map(&wmap);
      int it = 0;  // ring slot, counted across tiles
      for (int pair = cluster; pair < pairs; pair += clusters) {
        const int m0 = (pair / tiles_n * kCluster + rank) * kHBM, n0 = pair % tiles_n * kHBN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int st = it % kHStages;
          // Both blocks' consumers have released the stage: the peer's copy
          // of it is free for this block's half of w too
          mbar_wait(&empty[st], ((it / kHStages) & 1) ^ 1);
          uint8_t* stage = smem + st * kHStageBytes;
          mbar_arrive_expect_tx(&full[st], kHStageBytes);
          tma_load_2d(stage, &xmap, &full[st], kt * kHBK, m0);
          for (int a = rank * 2; a < rank * 2 + 2; ++a)
            tma_load_2d_multicast(stage + kXBytes + a * kWBoxBytes, &wmap, &full[st],
                                  n0 + 64 * a, kt * kHBK, 0x3);
        }
      }
    }
    __syncwarp();
    cluster_sync();  // the peer no longer reads this block's barriers
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, +64) of each 128 x 256 tile ----
    regs_alloc<232>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = wg * 64 + 16 * (t / 32) + lane / 4, c2 = 2 * (lane % 4);
    int it = 0;
    // A stage is released by lane 0 of each warp, to this block and the peer
    auto release = [&](int slot) {
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_cluster(&empty[slot % kHStages], rank);
        mbar_arrive_cluster(&empty[slot % kHStages], peer);
      }
    };
    for (int pair = cluster; pair < pairs; pair += clusters) {
      const int m0 = (pair / tiles_n * kCluster + rank) * kHBM, n0 = pair % tiles_n * kHBN;
      float acc[kHBN / 2];
#pragma unroll
      for (int i = 0; i < kHBN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int st = it % kHStages;
        mbar_wait(&full[st], (it / kHStages) & 1);
        const uint32_t a_base = smem_addr(smem + st * kHStageBytes) + wg * 64 * 128;
        const uint32_t b_base = smem_addr(smem + st * kHStageBytes + kXBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHBK / 16; ++kk)
          wgmma_ss<kHBN, 1>(acc, desc_b128(a_base + kk * 32, 16, 1024),
                            desc_b128(b_base + kk * 16 * 128, kWBoxBytes, 1024), 1);
        wgmma_commit();
        // Keep this stage's products in flight; the previous stage's are done
        wgmma_wait<1>();
        if (kt > 0) release(it - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(it - 1);  // the tile's last stage

      // acc: rows r0 (4j + 0, 1) and r0 + 8 (4j + 2, 3), columns 8j + c2 + (0, 1)
      if constexpr (kChecksum) {
        // Each row's sums over its bn-blocks, in registers: the thread's two
        // columns of each 8-column chunk, summed along the row until a block
        // ends, then over the four threads of the row (lanes 4g .. 4g + 3),
        // whose chunk walk is the same; one atomic per row and block
        const int groups = N / bn;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + r0 + 8 * hh;
          int blk = n0 / bn, blk_end = (blk + 1) * bn;  // warp-uniform
          float run = 0.f;
#pragma unroll
          for (int j = 0; j < kHChunks; ++j) {
            const int col = n0 + 8 * j;
            if (col >= N) break;
            if (col >= blk_end) {
              run += __shfl_xor_sync(0xffffffffu, run, 1);
              run += __shfl_xor_sync(0xffffffffu, run, 2);
              if (c2 == 0 && row < M) atomicAdd(out + (size_t)row * groups + blk, run);
              run = 0.f;
              ++blk;
              blk_end += bn;
            }
            run += acc[4 * j + 2 * hh] + acc[4 * j + 2 * hh + 1];
          }
          run += __shfl_xor_sync(0xffffffffu, run, 1);
          run += __shfl_xor_sync(0xffffffffu, run, 2);
          if (c2 == 0 && row < M) atomicAdd(out + (size_t)row * groups + blk, run);
        }
      } else {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + r0 + 8 * hh;
          if (row >= M) continue;
#pragma unroll
          for (int j = 0; j < kHChunks; ++j) {
            const int col = n0 + 8 * j + c2;
            if (col >= N) continue;
            *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
                make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
          }
        }
      }
    }  // tile
    cluster_sync();  // the peer no longer reads this block's barriers or writes its ring
  }
}

// ---- float32 path (TMA ring + CUDA-core FMA) ---------------------------------

constexpr int kFBM = 128, kFBN = 128;             // block tile
constexpr int kFBK = 32;                          // k per stage: one 128-byte row of x
constexpr int kFStages = 4;
constexpr int kFConsumers = 256;                  // warpgroups 0, 1: 8 x 8 outputs a thread
constexpr int kFThreads = kFConsumers + 128;      // + producer warpgroup 2
constexpr int kFXBytes = kFBM * kFBK * 4;         // x tile: 128 rows of 128 bytes
constexpr int kFWBoxBytes = kFBK * 128;           // w box: 32 k-rows of 32 columns
constexpr int kFWBytes = (kFBN / 32) * kFWBoxBytes;
constexpr int kFStageBytes = kFXBytes + kFWBytes;  // 32 KB
constexpr int kFBarOffset = kFStages * kFStageBytes;
constexpr int kFSmemBytes = kFBarOffset + 2 * kFStages * 8 + 1024;  // + alignment

// 16 bytes of shared memory at a shared-window address
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

template <bool kChecksum>
__global__ void __launch_bounds__(kFThreads, 1)
f32_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                float* __restrict__ out, int M, int N, int K, int bn) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kFBarOffset);
  uint64_t* empty = full + kFStages;
  const int tiles_n = (N + kFBN - 1) / kFBN;
  const int tiles = (M + kFBM - 1) / kFBM * tiles_n;
  const int ktiles = (K + kFBK - 1) / kFBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kFConsumers / 32);  // each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kFConsumers) {
    // ---- producer: one thread streams every tile's stages ----
    regs_dealloc<40>();
    if (threadIdx.x == kFConsumers) {
      prefetch_map(&xmap);
      prefetch_map(&wmap);
      int it = 0;  // ring slot, counted across tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kFBM, n0 = tile % tiles_n * kFBN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int st = it % kFStages;
          mbar_wait(&empty[st], ((it / kFStages) & 1) ^ 1);
          uint8_t* stage = smem + st * kFStageBytes;
          mbar_arrive_expect_tx(&full[st], kFStageBytes);
          tma_load_2d(stage, &xmap, &full[st], kt * kFBK, m0);
          for (int a = 0; a < kFBN / 32; ++a)
            tma_load_2d(stage + kFXBytes + a * kFWBoxBytes, &wmap, &full[st], n0 + 32 * a,
                        kt * kFBK);
        }
      }
    }
  } else {
    // ---- consumers: thread (ty, tx) owns rows 4 ty + i and 64 + 4 ty + i,
    // and columns 4 tx + j and 64 + 4 tx + j (i, j < 4), of each tile ----
    regs_alloc<232>();
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, lane = threadIdx.x % 32;
    // Every read of a stage is a per-thread offset plus a constant. x row r =
    // 4 ty + (i & 3) (+ 64) keeps k-chunk c at chunk c ^ (r & 7) = c ^ (i & 3)
    // ^ 4 (ty & 1): bit 6 of (c ^ (i & 3)) << 4 is bit 2 of c, so the odd
    // ty's XOR with 64 is + 64 where c < 4 and - 64 where c >= 4. w column
    // chunk tx of k-row k sits at chunk (tx & 7) ^ (k & 7) of its box: one
    // offset for each k & 7.
    const uint32_t x_lo = 512 * ty + 64 * (ty & 1), x_hi = 512 * ty - 64 * (ty & 1);
    uint32_t w_at[8];
#pragma unroll
    for (int k7 = 0; k7 < 8; ++k7)
      w_at[k7] = kFXBytes + (tx >> 3) * kFWBoxBytes + (((tx & 7) ^ k7) << 4);
    const uint32_t sbase = smem_addr(smem);
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * kFBM, n0 = tile % tiles_n * kFBN;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int st = it % kFStages;
        mbar_wait(&full[st], (it / kFStages) & 1);
        const uint32_t stage = sbase + st * kFStageBytes;
#pragma unroll
        for (int c = 0; c < kFBK / 4; ++c) {
          // Four k of each of the thread's 8 rows, one float4 a row
          float4 a4[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            a4[i] = lds128(stage + (c < 4 ? x_lo : x_hi) + ((i & 3) + (i < 4 ? 0 : 64)) * 128 +
                           ((c ^ (i & 3)) << 4));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int k = 4 * c + kk;
            const uint32_t w = stage + w_at[k & 7] + k * 128;
            const float4 b0 = lds128(w), b1 = lds128(w + 2 * kFWBoxBytes);
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float a = kk == 0 ? a4[i].x : kk == 1 ? a4[i].y : kk == 2 ? a4[i].z : a4[i].w;
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);  // this warp has read the stage
      }

      if constexpr (kChecksum) {
        // A tile row's 128 columns lie in the 16 lanes of one warp that share
        // ty. Where bn is a multiple of 128 the tile lies in one bn-block: the
        // row's sum over those lanes, one atomic per row. Else per 8-column
        // chunk: the pair of lanes (tx, tx ^ 1) that holds it, one atomic each.
        const int groups = N / bn;
        const bool whole = bn % kFBN == 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = m0 + (i < 4 ? 0 : 64) + 4 * ty + (i & 3);
          float s[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            s[h] = acc[i][4 * h] + acc[i][4 * h + 1] + acc[i][4 * h + 2] + acc[i][4 * h + 3];
          if (whole) {
            float r = s[0] + s[1];
#pragma unroll
            for (int o = 1; o < 16; o *= 2) r += __shfl_xor_sync(0xffffffffu, r, o);
            if (tx == 0 && row < M) atomicAdd(out + (size_t)row * groups + n0 / bn, r);
          } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float r = s[h] + __shfl_xor_sync(0xffffffffu, s[h], 1);
              const int col = n0 + 64 * h + 4 * tx;
              if ((tx & 1) == 0 && row < M && col < N)
                atomicAdd(out + (size_t)row * groups + col / bn, r);
            }
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = m0 + (i < 4 ? 0 : 64) + 4 * ty + (i & 3);
          if (row >= M) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = n0 + 64 * h + 4 * tx;
            if (col >= N) continue;
            *reinterpret_cast<float4*>(out + (size_t)row * N + col) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
          }
        }
      }
    }  // tile
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes, bool (&configured)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  return cudaSuccess;
}

// The device's SM count, read once per device
cudaError_t sm_count(int& n) {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  n = sms[dev];
  return cudaSuccess;
}

template <int kIn, bool kChecksum>
cudaError_t launch_tc(const void* x, const void* w, void* out, int M, int N, int K, int bn,
                      cudaStream_t stream) {
  auto kernel = tc_gemm_kernel<kIn, kChecksum>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(kernel, smem_bytes<kIn>(), configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem_bytes<kIn>(), stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<typename TC<kIn>::Acc*>(out), M, N, K, bn);
  return cudaGetLastError();
}

// The plans agree with what the kernels load: x dims (K, M), box (one
// 128-byte row, the block's rows); w dims (N, K), box (one 128-byte row, the
// k of a stage): bf16 (64, 128) and (64, 64), float32 (32, 128) and (32, 32)
bool plan_matches(const long long* p, int M, int N, int K, int atom, int rows, int bk) {
  return p[0] == K && p[1] == M && p[3] == atom && p[4] == rows && p[5] == N && p[6] == K &&
         p[8] == atom && p[9] == bk;
}

template <bool kChecksum>
cudaError_t launch_bf16(const void* x, const void* w, const long long* plan, void* out, int M,
                        int N, int K, int bn, cudaStream_t stream) {
  auto kernel = bf16_gemm_kernel<kChecksum>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(kernel, kHSmemBytes, configured);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, wmap;
  err = encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, plan);
  if (err == cudaSuccess)
    err = encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, 2, plan + kPlanLen);
  if (err != cudaSuccess) return err;
  // Persistent: at most one block an SM, each cluster walking pairs of
  // output tiles (n fastest)
  int sms = 0;
  err = sm_count(sms);
  if (err != cudaSuccess) return err;
  const long long pairs =
      (long long)((M + kCluster * kHBM - 1) / (kCluster * kHBM)) * ((N + kHBN - 1) / kHBN);
  if (pairs > INT32_MAX / kCluster) return cudaErrorInvalidValue;
  const int grid = kCluster * (int)(pairs < sms / kCluster ? pairs : sms / kCluster);
  kernel<<<grid, kHThreads, kHSmemBytes, stream>>>(xmap, wmap, static_cast<float*>(out), M, N, K,
                                                   bn);
  return cudaGetLastError();
}

template <bool kChecksum>
cudaError_t launch_f32(const void* x, const void* w, const long long* plan, void* out, int M,
                       int N, int K, int bn, cudaStream_t stream) {
  auto kernel = f32_gemm_kernel<kChecksum>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(kernel, kFSmemBytes, configured);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, wmap;
  err = encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, 2, plan);
  if (err == cudaSuccess)
    err = encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w, 2, plan + kPlanLen);
  if (err != cudaSuccess) return err;
  // Persistent: one block an SM (its ring takes 128 KB, its consumers 232
  // registers a thread), each walking tiles
  // blockIdx.x, + gridDim.x, ... (n fastest)
  int sms = 0;
  err = sm_count(sms);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((M + kFBM - 1) / kFBM) * ((N + kFBN - 1) / kFBN);
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, kFThreads, kFSmemBytes, stream>>>(xmap, wmap, static_cast<float*>(out), M, N, K,
                                                   bn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error of the launch (0 = success).
// in_kind: 0 s8 (out int32), 1 bf16 (out float32), 2 float32 (out float32).
// bn = 0 stores (M, N); bn > 0 adds each row's bn-block sums into the
// (M, N / bn) out, which the caller has zeroed (int32 for s8).
// plan (bf16 and float32, else unused): the tensor maps of x and w, 5 values
// each: dims (K, M) / (N, K), the byte stride of dim 1, box (one 128-byte row,
// 128 rows) / (one 128-byte row, the stage's k): bf16 (64, 128) / (64, 64),
// float32 (32, 128) / (32, 32).
int novic_tiled_matmul(const void* x, const void* w, const long long* plan, void* out, int M,
                       int N, int K, int in_kind, int bn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 16 != 0 || out == nullptr ||
      M > 65535 * kBM || bn < 0 || (bn > 0 && (bn % 8 != 0 || N % bn != 0)) ||
      (in_kind == kBF16 &&
       (plan == nullptr || !plan_matches(plan, M, N, K, 64, kHBM, kHBK))) ||
      (in_kind == kF32 && (plan == nullptr || !plan_matches(plan, M, N, K, 32, kFBM, kFBK))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool sum = bn > 0;
  switch (in_kind) {
    case kS8:
      return (int)(sum ? launch_tc<kS8, true>(x, w, out, M, N, K, bn, st)
                       : launch_tc<kS8, false>(x, w, out, M, N, K, bn, st));
    case kBF16:
      return (int)(sum ? launch_bf16<true>(x, w, plan, out, M, N, K, bn, st)
                       : launch_bf16<false>(x, w, plan, out, M, N, K, bn, st));
    case kF32:
      return (int)(sum ? launch_f32<true>(x, w, plan, out, M, N, K, bn, st)
                       : launch_f32<false>(x, w, plan, out, M, N, K, bn, st));
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
