// Dropout for Hopper (sm_90a): y = keep ? x * inv_keep : 0, with a counter-based mask.
//
// Replaces the Pallas kernel novic_tpu/ops/dropout.py `hw_dropout` (its body
// `_dropout_kernel`, launched by `_run_kernel`) and keeps its semantics:
//   * thresh = min(round((1 - rate) * 2^32), 2^32 - 1); element i is kept where
//     its 32 random bits are < thresh;
//   * a kept element is multiplied by inv_keep = 1 / (1 - rate), rounded to the
//     tensor's float type; a dropped one is written as 0;
//   * the backward pass regenerates the same mask from the seed, so nothing but
//     the two seed words is kept between forward and backward.
// The TPU kernel drew its bits from the core's hardware generator, reseeded per
// grid block. Here the bits are Philox4x32-10 of (key = the two seed words,
// counter = (lo32(i / 4), hi32(i / 4), 0, 0)), and element i takes output word
// i mod 4. The mask is therefore a function of (seed, element index) alone: it
// does not depend on the launch configuration, on alignment, or on the device,
// and the plain version in dropout.py reproduces it bit for bit.
//
// Layout: x and y are contiguous, n elements, float32 or bfloat16. Any n.
// `offset` places x at elements [offset, offset + n) of a larger tensor whose
// mask is drawn (a data-parallel rank's rows of the global batch): local
// element i takes the bits of element offset + i.
//
// Design: one thread per group of 4 global elements (one Philox call gives 4
// words), grid-stride. Where x and y are aligned to the group's size (16 bytes
// in float32, 8 in bfloat16) and offset is a multiple of 4, a group is one
// vector load and one vector store; the ragged first and last groups, and any
// misaligned tensor or offset, take scalar accesses. bfloat16
// values are multiplied in float32 (exact: both factors are bfloat16 values)
// and rounded to nearest even once.
//
// Bound on the H100: the work is 2 * n * itemsize bytes (x read once, y written
// once), e.g. 46 MB for a (1024, 11, 512) float32 site, ~14 us at 3.35 TB/s.
// Philox costs 20 32-bit multiplies (10 rounds x 2 mul.wide) per 4 elements;
// at these sizes that is of the order of the memory time, so this simple
// version may sit above the byte bound (chip_smoke.py measures it).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// Philox4x32-10 (Salmon et al. 2011): 10 rounds, the key bumped between rounds.
__device__ __forceinline__ uint4 philox(uint64_t group, uint32_t k0, uint32_t k1) {
  uint32_t c0 = (uint32_t)group, c1 = (uint32_t)(group >> 32), c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = kPhiloxM0 * c0, hi0 = __umulhi(kPhiloxM0, c0);
    const uint32_t lo1 = kPhiloxM1 * c2, hi1 = __umulhi(kPhiloxM1, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float apply(float x, uint32_t bits, uint32_t thresh, float inv_keep) {
  return bits < thresh ? x * inv_keep : 0.0f;
}

__device__ __forceinline__ uint32_t word(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

// x's element i takes word (skip + i) % 4 of group g0 + (skip + i) / 4, where
// offset = 4 * g0 + skip. The vector path runs only with skip == 0.
template <bool kVector>
__global__ void __launch_bounds__(kThreads, 8)
dropout_f32(const float* __restrict__ x, float* __restrict__ y, int64_t n, uint64_t g0,
            int skip, uint32_t k0, uint32_t k1, uint32_t thresh, float inv_keep) {
  const int64_t groups = (n + skip + 3) / 4;
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < groups;
       g += (int64_t)gridDim.x * blockDim.x) {
    const uint4 w = philox(g0 + (uint64_t)g, k0, k1);
    const int64_t i = 4 * g - skip;  // local index of the group's word 0
    if (kVector && i + 4 <= n) {
      const float4 v = *reinterpret_cast<const float4*>(x + i);
      *reinterpret_cast<float4*>(y + i) =
          make_float4(apply(v.x, w.x, thresh, inv_keep), apply(v.y, w.y, thresh, inv_keep),
                      apply(v.z, w.z, thresh, inv_keep), apply(v.w, w.w, thresh, inv_keep));
    } else {
      for (int j = 0; j < 4 && i + j < n; ++j)
        if (i + j >= 0) y[i + j] = apply(x[i + j], word(w, j), thresh, inv_keep);
    }
  }
}

__device__ __forceinline__ __nv_bfloat16 apply_bf16(__nv_bfloat16 x, uint32_t bits,
                                                    uint32_t thresh, float inv_keep) {
  return __float2bfloat16_rn(apply(__bfloat162float(x), bits, thresh, inv_keep));
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads, 8)
dropout_bf16(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y, int64_t n,
             uint64_t g0, int skip, uint32_t k0, uint32_t k1, uint32_t thresh,
             float inv_keep) {
  const int64_t groups = (n + skip + 3) / 4;
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < groups;
       g += (int64_t)gridDim.x * blockDim.x) {
    const uint4 w = philox(g0 + (uint64_t)g, k0, k1);
    const int64_t i = 4 * g - skip;  // local index of the group's word 0
    if (kVector && i + 4 <= n) {
      const uint2 raw = *reinterpret_cast<const uint2*>(x + i);
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
      __align__(8) __nv_bfloat16 out[4];
      out[0] = apply_bf16(v[0], w.x, thresh, inv_keep);
      out[1] = apply_bf16(v[1], w.y, thresh, inv_keep);
      out[2] = apply_bf16(v[2], w.z, thresh, inv_keep);
      out[3] = apply_bf16(v[3], w.w, thresh, inv_keep);
      *reinterpret_cast<uint2*>(y + i) = *reinterpret_cast<const uint2*>(out);
    } else {
      for (int j = 0; j < 4 && i + j < n; ++j)
        if (i + j >= 0) y[i + j] = apply_bf16(x[i + j], word(w, j), thresh, inv_keep);
    }
  }
}

int grid_for(int64_t n) {
  const int64_t groups = (n + 3) / 4;
  const int64_t blocks = (groups + kThreads - 1) / kThreads;
  // Enough blocks to fill 132 SMs many times over; the grid-stride loop covers the rest
  return (int)(blocks < 65535 ? blocks : 65535);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream`; returns the CUDA error
// of the launch (0 = success).
int novic_dropout(const void* x, void* y, long long n, long long offset, int dtype,
                  unsigned int seed0, unsigned int seed1, unsigned int thresh, float inv_keep,
                  void* stream) {
  if (n <= 0 || offset < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint64_t g0 = (uint64_t)offset / 4;
  const int skip = (int)(offset % 4);
  const int grid = grid_for(n + skip);
  const uintptr_t align = dtype == 0 ? 16 : 8;
  const bool vector = ((uintptr_t)x % align == 0) && ((uintptr_t)y % align == 0) && skip == 0;
  if (dtype == 0) {
    const float* xs = (const float*)x;
    float* ys = (float*)y;
    if (vector)
      dropout_f32<true><<<grid, kThreads, 0, st>>>(xs, ys, n, g0, skip, seed0, seed1,
          thresh, inv_keep);
    else
      dropout_f32<false><<<grid, kThreads, 0, st>>>(xs, ys, n, g0, skip, seed0, seed1,
          thresh, inv_keep);
  } else {
    const __nv_bfloat16* xs = (const __nv_bfloat16*)x;
    __nv_bfloat16* ys = (__nv_bfloat16*)y;
    if (vector)
      dropout_bf16<true><<<grid, kThreads, 0, st>>>(xs, ys, n, g0, skip, seed0, seed1,
          thresh, inv_keep);
    else
      dropout_bf16<false><<<grid, kThreads, 0, st>>>(xs, ys, n, g0, skip, seed0, seed1,
          thresh, inv_keep);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
