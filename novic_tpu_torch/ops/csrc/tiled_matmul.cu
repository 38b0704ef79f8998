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
// blocks, and the kernels pick their own tiles:
//   s8    two kernels, launched by one call of the entry point:
//         `transpose_s8_kernel` copies w into a K-major w^T (N, K) (below),
//         then the port's s8 wgmma engine (int8_wgmma.cuh,
//         K2's Hopper instance) multiplies x by it, as K2 multiplies by a
//         torch-layout weight. 8-bit wgmma takes no transposed operand, and
//         w's rows run along N, so w must be K-major somewhere; a copy in
//         global memory costs 2 K N bytes (4% of make_matmul's bound) and
//         keeps the engine's shared-memory reads as K2's. w^T is made anew on
//         every call, as the Pallas kernel reads w on every call. Its two
//         epilogues here: the int32 out by TMA store (kInt32Tma), and the
//         checksum (kChecksum) by one int32 atomic per row, tile and bn-block.
//   bf16  wgmma m64n256k16 bf16 -> f32 fed by TMA (below).
//   f32   exact float32 FMA on the CUDA cores, fed by TMA (below): Hopper's
//         tensor cores have no full float32 mode, and TF32 is not the product
//         the probe computes.
// Epilogue 0 stores (M, N): int32 for s8, float32 otherwise. Epilogue 1, the
// checksum: the entry point zeroes out, and each row's sums over its
// bn-blocks are added into out[m, n / bn] by atomics. The s8 sums are int32
// (the wrapper casts them to float32 after), so their wrap is the plain
// version's and they are exact; the float32 sums run in an order that
// varies from run to run.
//
// Layout: x (M, K) and w (K, N) row-major, 16-byte aligned, K and N multiples
// of 16 (the wrapper checks); any M >= 1; the checksum's bn a multiple of 8
// that divides N.
//
// Design. s8: the transpose moves 128 x 128-byte tiles through 16 KB of
// shared memory: each thread loads four k-rows of 16 n-bytes (16-byte loads,
// 8 lanes a 128-byte row), transposes each 4 x 4 byte block in registers with
// four byte permutes and stores the words n-major, 16-byte chunks XOR-ed by
// (n / 16) % 8 so that a warp's 32 words fall in 32 banks; then 8 lanes read
// and store each 128-byte row of w^T. f32 (Hopper): persistent blocks,
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
// out, 0.1084 ms at 3.35 TB/s: the int32 out is 335.5 MB of it, so the s8
// store stream decides it and runs beside the tensor cores by TMA); bf16
// 0.2171 ms at 989 TFLOP/s (bytes 0.1166 ms). `make_mm` at M = 8192, 107.4
// GOP, writes almost nothing: f32 1.603 ms at the 67 TFLOP/s float32 rate,
// bf16 0.1086 ms, s8 0.0543 ms, all operations. The w^T copy moves 13.1 MB,
// 3.9 us at 3.35 TB/s. The f32 path issues 16 shared-memory float4 reads per
// 256 FMAs a thread, so its issue slots, not shared memory, set its ceiling
// near 94% of the FMA rate.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_common.cuh"
#include "int8_wgmma.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMaxM = 65535 * 128;  // rows the entry point takes

enum In { kS8 = 0, kBF16 = 1, kF32 = 2 };

// ---- s8 path: w^T by a transpose kernel, then the s8 wgmma engine -----------

constexpr int kTT = 128;        // a transpose block's tile: 128 k-rows by 128 n-bytes
constexpr int kTThreads = 256;  // each 4 k-rows x 16 n-bytes, then 4 rows x 16 k-bytes of w^T

// 16 bytes of w^T's tile, n-row n at k-bytes [16 c, +16): chunk c ^ (n / 16) % 8
__device__ __forceinline__ int tt_offset(int n, int c) {
  return n * kTT + ((c ^ ((n >> 4) & 7)) << 4);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kTThreads)
transpose_s8_kernel(const uint8_t* __restrict__ w, uint8_t* __restrict__ wt, int K, int N) {
  __shared__ __align__(16) uint8_t tile[kTT * kTT];  // [n][k] of the block's tile
  const int k0 = blockIdx.y * kTT, n0 = blockIdx.x * kTT, t = threadIdx.x;
  // Thread (kq, nc): k-rows 4 kq .. 4 kq + 3 at n-bytes [16 nc, +16); past K
  // or N (whole 16-byte chunks: K and N are multiples of 16) it loads zeros,
  // which nothing stores
  const int kq = t / 8, nc = t % 8;
  uint4 a[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = k0 + 4 * kq + r, n = n0 + 16 * nc;
    a[r] = k < K && n < N ? *reinterpret_cast<const uint4*>(w + (size_t)k * N + n)
                          : make_uint4(0u, 0u, 0u, 0u);
  }
  // Each 4 x 4 byte block (k-rows by n-bytes 4 j .. 4 j + 3) transposed: word
  // col[i] holds the four k of n-byte 4 j + i, little-endian in k
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t r0 = word(a[0], j), r1 = word(a[1], j), r2 = word(a[2], j), r3 = word(a[3], j);
    const uint32_t lo01 = __byte_perm(r0, r1, 0x5140), lo23 = __byte_perm(r2, r3, 0x5140);
    const uint32_t hi01 = __byte_perm(r0, r1, 0x7362), hi23 = __byte_perm(r2, r3, 0x7362);
    const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                             __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint32_t*>(tile + tt_offset(16 * nc + 4 * j + i, kq / 4) + 4 * (kq % 4)) =
          col[i];
  }
  __syncthreads();
  // 8 lanes a 128-byte row of w^T
#pragma unroll
  for (int it = 0; it < kTT * kTT / 16 / kTThreads; ++it) {
    const int idx = t + it * kTThreads, n = idx / 8, c = idx % 8;
    const int gn = n0 + n, gk = k0 + 16 * c;
    if (gn < N && gk < K)
      *reinterpret_cast<uint4*>(wt + (size_t)gn * K + gk) =
          *reinterpret_cast<const uint4*>(tile + tt_offset(n, c));
  }
}

cudaError_t launch_s8(const void* x, const void* wt, const long long* plan, void* out, int M,
                      int N, int K, int bn, cudaStream_t stream) {
  const int8_t* A = static_cast<const int8_t*>(x);
  const int8_t* B = static_cast<const int8_t*>(wt);
  return bn > 0 ? q8::launch_wgmma<q8::kChecksum>(A, B, plan, nullptr, nullptr, nullptr, out, M,
                                                  N, K, bn, stream)
                : q8::launch_wgmma<q8::kInt32Tma>(A, B, plan, nullptr, nullptr, nullptr, out, M,
                                                  N, K, 0, stream);
}

// The transpose takes w (K, N) and wt (N, K) at 16-byte aligned bases, K and
// N multiples of 16
bool transpose_takes(const void* w, const void* wt, int K, int N) {
  return K > 0 && N > 0 && K % 16 == 0 && N % 16 == 0 && K <= 65535 * kTT && wt != nullptr &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0 && reinterpret_cast<uintptr_t>(wt) % 16 == 0;
}

cudaError_t launch_transpose(const void* w, void* wt, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + kTT - 1) / kTT, (K + kTT - 1) / kTT);
  transpose_s8_kernel<<<grid, kTThreads, 0, stream>>>(static_cast<const uint8_t*>(w),
                                                      static_cast<uint8_t*>(wt), K, N);
  return cudaGetLastError();
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

// Makes `device` current for a call and the caller's device current again at
// its end (in C: a torch.cuda.device block costs the host a few µs a call,
// which small shapes wait for)
struct DeviceScope {
  int prev = -1;
  bool switched = false;
  cudaError_t err;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
      switched = err == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (switched) cudaSetDevice(prev);
  }
};

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

// Launch on `stream`; returns the CUDA error of the first launch that fails
// (0 = success).
// in_kind: 0 s8 (out int32), 1 bf16 (out float32), 2 float32 (out float32).
// bn = 0 stores (M, N); bn > 0 zeroes the (M, N / bn) out (int32 for s8) and
// adds each row's bn-block sums into it.
// wt: for s8, scratch for w's K-major copy (N, K): the call launches the
// transpose of w into it, then the s8 engine on (x, wt); unused otherwise.
// device: the card the tensors and `stream` are on; the call makes it current
// and gives the caller's current device back after.
// plan: the tensor maps, 5 values each: dims, the byte stride of dim 1, box.
//   bf16, float32: x (K, M), box (one 128-byte row, 128 rows); w (N, K), box
//     (one 128-byte row, the stage's k): bf16 (64, 128) / (64, 64), float32
//     (32, 128) / (32, 32).
//   s8: x (K, M) and wt (K, N), rows K bytes apart, box (128, 64); with bn
//     = 0 also the int32 out (N, M), rows 4 N bytes apart, box (32, 16).
int novic_tiled_matmul(const void* x, const void* w, void* wt, const long long* plan, void* out,
                       int M, int N, int K, int in_kind, int bn, int device, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 16 != 0 || out == nullptr ||
      plan == nullptr || M > kMaxM || bn < 0 || (bn > 0 && (bn % 8 != 0 || N % bn != 0)) ||
      (in_kind == kS8 &&
       (!transpose_takes(w, wt, K, N) || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        !q8::plan_matches(plan, M, N, K) ||
        (bn == 0 && !q8::out_plan_matches(plan + 2 * q8::kPlanLen, M, N)))) ||
      (in_kind == kBF16 && !plan_matches(plan, M, N, K, 64, kHBM, kHBK)) ||
      (in_kind == kF32 && !plan_matches(plan, M, N, K, 32, kFBM, kFBK)))
    return (int)cudaErrorInvalidValue;
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t st = (cudaStream_t)stream;
  const bool sum = bn > 0;
  if (sum) {
    const cudaError_t err = cudaMemsetAsync(out, 0, (size_t)M * (N / bn) * 4, st);
    if (err != cudaSuccess) return (int)err;
  }
  switch (in_kind) {
    case kS8: {
      const cudaError_t err = launch_transpose(w, wt, K, N, st);
      return (int)(err != cudaSuccess ? err : launch_s8(x, wt, plan, out, M, N, K, bn, st));
    }
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

// w (K, N) s8 row-major -> wt (N, K), its transpose, on `stream`; both 16-byte
// aligned, K and N multiples of 16. Returns the CUDA error of the launch.
int novic_transpose_s8(const void* w, void* wt, int K, int N, void* stream) {
  if (!transpose_takes(w, wt, K, N)) return (int)cudaErrorInvalidValue;
  return (int)launch_transpose(w, wt, K, N, (cudaStream_t)stream);
}

}  // extern "C"
