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
//   f32   exact float32 FMA on the CUDA cores: Hopper's tensor cores have no
//         full float32 mode, and TF32 is not the product the probe computes.
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
// ldmatrix.x4, as in K2. f32: the same tile, K 8 at a time, register-staged
// into a double buffer (A transposed on the way in), each thread 8 x 8 outputs
// from float4 shared-memory reads. bf16 (Hopper): persistent blocks of three
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
// wgmma) and the s8 byte gathers, and the f32 path's shared-memory reads, hold
// those two paths below their rates.

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
__device__ __forceinline__ float add(float a, float b) { return a + b; }

// Checksum epilogue, second half: `part` holds (kBM rows, kChunks) sums of 8
// columns; each row's chunks are summed per bn-block and added to out.
template <typename Acc>
__device__ __forceinline__ void checksum_flush(const Acc* part, Acc* __restrict__ out, int m0,
                                               int n0, int M, int N, int bn) {
  __syncthreads();
  if (threadIdx.x >= kBM) return;
  const int row = m0 + threadIdx.x;
  if (row >= M) return;
  const int groups = N / bn;
  Acc sum = 0;
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
    checksum_flush<Acc>(part, out, m0, n0, M, N, bn);
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

// ---- float32 path (CUDA cores) ---------------------------------------------

constexpr int kBKF = 8;        // k per stage
constexpr int kLdAF = kBM + 4;  // transposed A row stride (floats): conflict-free stores

template <bool kChecksum>
__global__ void __launch_bounds__(kThreads)
f32_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
                int M, int N, int K, int bn) {
  __shared__ __align__(16) float as[2][kBKF][kLdAF];  // (k, m): A transposed
  __shared__ __align__(16) float bs[2][kBKF][kBN];    // (k, n)
  __shared__ float part[kChecksum ? kBM * kChunks : 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // Loader: A float4 x[m0 + am][k + ak .. + 3]; B float4 w[k + bk][n0 + bn4 .. + 3]
  const int am = tid / 2, ak = (tid % 2) * 4;
  const int bk = tid / 32, bn4 = (tid % 32) * 4;
  const int ktiles = (K + kBKF - 1) / kBKF;
  float4 ra, rb;
  auto fetch = [&](int kt) {
    const int k0 = kt * kBKF;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    ra = m0 + am < M && k0 + ak < K ? *reinterpret_cast<const float4*>(x + (size_t)(m0 + am) * K + k0 + ak) : zero;
    rb = k0 + bk < K && n0 + bn4 < N ? *reinterpret_cast<const float4*>(w + (size_t)(k0 + bk) * N + n0 + bn4) : zero;
  };
  auto stash = [&](int buf) {
    as[buf][ak + 0][am] = ra.x;
    as[buf][ak + 1][am] = ra.y;
    as[buf][ak + 2][am] = ra.z;
    as[buf][ak + 3][am] = ra.w;
    *reinterpret_cast<float4*>(&bs[buf][bk][bn4]) = rb;
  };

  // This thread's outputs: rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j and 64 + tx*4 + j
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) fetch(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kBKF; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[cur][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < ktiles) stash(cur ^ 1);
    __syncthreads();
  }

  if constexpr (kChecksum) {
    // Columns tx*4 .. +3 lie in 8-column chunk tx / 2 (and 8 + tx / 2): sum
    // the 4, add the neighbouring thread's (tx ^ 1, lane ^ 1), even tx stores
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rl = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float s = acc[i][4 * half] + acc[i][4 * half + 1] + acc[i][4 * half + 2] + acc[i][4 * half + 3];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        if ((tx & 1) == 0) part[rl * kChunks + 8 * half + tx / 2] = s;
      }
    }
    checksum_flush<float>(part, out, m0, n0, M, N, bn);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
      if (row >= M) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = n0 + 64 * half + tx * 4;
        if (col >= N) continue;
        *reinterpret_cast<float4*>(out + (size_t)row * N + col) =
            make_float4(acc[i][4 * half], acc[i][4 * half + 1], acc[i][4 * half + 2],
                        acc[i][4 * half + 3]);
      }
    }
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

// The plans agree with what the kernel loads: x dims (K, M), box (64, 128);
// w dims (N, K), box (64, 64)
bool bf16_plan_matches(const long long* p, int M, int N, int K) {
  return p[0] == K && p[1] == M && p[3] == kHBK && p[4] == kHBM && p[5] == N && p[6] == K &&
         p[8] == 64 && p[9] == kHBK;
}

template <bool kChecksum>
cudaError_t launch_bf16(const void* x, const void* w, const long long* plan, void* out, int M,
                        int N, int K, int bn, cudaStream_t stream) {
  auto kernel = bf16_gemm_kernel<kChecksum>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem(kernel, kHSmemBytes, configured);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, wmap;
  err = encode_bf16_map(&xmap, x, 2, plan);
  if (err == cudaSuccess) err = encode_bf16_map(&wmap, w, 2, plan + kPlanLen);
  if (err != cudaSuccess) return err;
  // Persistent: at most one block an SM, each cluster walking pairs of
  // output tiles (n fastest)
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static int sms[kMaxDevices] = {};
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const long long pairs =
      (long long)((M + kCluster * kHBM - 1) / (kCluster * kHBM)) * ((N + kHBN - 1) / kHBN);
  if (pairs > INT32_MAX / kCluster) return cudaErrorInvalidValue;
  const int grid = kCluster * (int)(pairs < sms[dev] / kCluster ? pairs : sms[dev] / kCluster);
  kernel<<<grid, kHThreads, kHSmemBytes, stream>>>(xmap, wmap, static_cast<float*>(out), M, N, K,
                                                   bn);
  return cudaGetLastError();
}

template <bool kChecksum>
cudaError_t launch_f32(const void* x, const void* w, void* out, int M, int N, int K, int bn,
                       cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  f32_gemm_kernel<kChecksum><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), M, N,
      K, bn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error of the launch (0 = success).
// in_kind: 0 s8 (out int32), 1 bf16 (out float32), 2 float32 (out float32).
// bn = 0 stores (M, N); bn > 0 adds each row's bn-block sums into the
// (M, N / bn) out, which the caller has zeroed (int32 for s8).
// plan (bf16 only, else unused): the tensor maps of x and w, 5 values each:
// dims (K, M) / (N, K), the byte stride of dim 1, box (64, 128) / (64, 64).
int novic_tiled_matmul(const void* x, const void* w, const long long* plan, void* out, int M,
                       int N, int K, int in_kind, int bn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 16 != 0 || out == nullptr ||
      M > 65535 * kBM || bn < 0 || (bn > 0 && (bn % 8 != 0 || N % bn != 0)) ||
      (in_kind == kBF16 && (plan == nullptr || !bf16_plan_matches(plan, M, N, K))))
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
      return (int)(sum ? launch_f32<true>(x, w, out, M, N, K, bn, st)
                       : launch_f32<false>(x, w, out, M, N, K, bn, st));
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
