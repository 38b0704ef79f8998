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
//   2  bfloat16: out = bf16_rn(((float)acc * sx[m]) * sw[n]), no bias;
// rounded as int8_wgmma.cuh says, so the plain version in ops/int8_matmul.py
// is equal bit for bit.
//
// Layout: A (M, K) int8 row-major; B (N, K) int8 row-major, the torch weight
// layout (out, in): both K-major, which is the one layout 8-bit wgmma takes for
// B (it has no transpose) and the "col" operand of mma.sync m16n8k32, so the
// weight needs no transpose. Two instances, chosen by the wrapper by shape:
//
// Hopper instance (K a positive multiple of 16, A and B 16-byte aligned: every
// shape of the towers and X4): the s8 wgmma engine of int8_wgmma.cuh, which
// X3's s8 path (tiled_matmul.cu) runs too, with these three epilogues:
// persistent blocks in 2 x 2 clusters that share each A and B stage by TMA
// multicast, two consumer warpgroups taking alternate 128 x 128 tiles
// (ping-pong) so that one stores a finished tile from its registers while the
// other multiplies the next, wgmma m64n128k32 s8 -> s32 fed by a ring of six
// 32 KB stages. A tile's scales and bias are loaded as its main loop starts;
// the maps' extents zero-fill the ragged M, N and K edges; stores are masked.
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
#include "int8_wgmma.cuh"
#include "mma_common.cuh"

namespace {

using q8::col_scale;
using q8::kBF16;
using q8::kF32;
using q8::kInt32;
using q8::store_pair;

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
        reinterpret_cast<uintptr_t>(B) % 16 != 0 || !q8::plan_matches(plan, M, N, K))
      return (int)cudaErrorInvalidValue;
    switch (epilogue) {
      case kInt32:
        return (int)q8::launch_wgmma<kInt32>(A, B, plan, sx, sw, bias, out, M, N, K, 0, st);
      case kF32:
        return (int)q8::launch_wgmma<kF32>(A, B, plan, sx, sw, bias, out, M, N, K, 0, st);
      case kBF16:
        return (int)q8::launch_wgmma<kBF16>(A, B, plan, sx, sw, bias, out, M, N, K, 0, st);
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
