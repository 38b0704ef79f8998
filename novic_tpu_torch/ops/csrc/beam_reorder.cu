// Beam KV-cache permutation for Hopper (sm_90a): out[b, i] = in[b, cand[b, i]].
//
// Replaces the Pallas kernels of exp/beam_reorder_kernel.py: `reorder_pallas`
// (:53, one cache per call) and `reorder_pallas_many` (:77, every cache in one
// call). Each cache is a contiguous tensor viewed as (B, H, row): B samples, H
// beam candidates, `row` bytes per candidate (G token slots x heads x hd
// elements of the token cache). cand is (B, H) int32 or int64. An index
// outside [0, H) gives a zero row, as the one-hot product of the plain
// version does.
//
// Bound on the H100: pure data movement, so bytes. Every cache is read once
// and written once: 2 x n x B x H x row bytes per step, e.g. 12 FT0 token
// caches of (640, 7, 8, 64) float32 = 220 MB, 0.066 ms at 3.35 TB/s. At the
// FT0 serving shape one launch per step costs more than the bytes, so the
// many form takes every cache of a step in one launch.
//
// Design:
//   * One block per (output row, cache): blockIdx.x is the row b*H + i,
//     blockIdx.y the cache. The block loads its own cand[b, i] (the TPU kernel
//     had it scalar-prefetched) and copies the source row.
//   * The copy is 16-byte vector loads and stores where both row pointers are
//     16-byte aligned (four in flight per thread), else 4-byte words where they
//     are 4-byte aligned; the bytes past the last whole vector or word are a
//     scalar tail. Exact for any dtype.
//   * The cache pointers travel by value in the kernel parameters (a struct of
//     up to kMaxCaches source and destination pointers, 1 KB), so a step makes
//     no host-to-device copy; the wrapper splits longer lists into launches.
//   * Out of place: candidates repeat (two candidates may take the same parent
//     row), so a row cannot be overwritten before every reader has copied it.
//     generate_beam allocates a second set of token caches once per call and
//     ping-pongs between the two sets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;
constexpr int kMaxCaches = 64;

struct CachePointers {
  const char* src[kMaxCaches];
  char* dst[kMaxCaches];
};

template <typename T>
__device__ __forceinline__ int64_t copy_words(char* __restrict__ dst,
                                              const char* __restrict__ src, int64_t nbytes) {
  const int64_t n = nbytes / (int64_t)sizeof(T);
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  for (int64_t v = threadIdx.x; v < n; v += (int64_t)kUnroll * kThreads) {
    T t[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = v + (int64_t)u * kThreads;
      if (j < n) t[u] = __ldg(s + j);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = v + (int64_t)u * kThreads;
      if (j < n) d[j] = t[u];
    }
  }
  return n * (int64_t)sizeof(T);
}

__global__ void __launch_bounds__(kThreads)
beam_reorder_kernel(const CachePointers ptrs, const void* __restrict__ cand, int cand_is_64,
                    int H, int64_t row_bytes) {
  const int64_t r = blockIdx.x;  // output row b*H + i
  const int c = blockIdx.y;      // cache
  const int64_t k = cand_is_64 ? reinterpret_cast<const int64_t*>(cand)[r]
                               : (int64_t)reinterpret_cast<const int32_t*>(cand)[r];
  char* dst = ptrs.dst[c] + r * row_bytes;
  if (k < 0 || k >= H) {
    for (int64_t j = threadIdx.x; j < row_bytes; j += kThreads) dst[j] = 0;
    return;
  }
  const char* src = ptrs.src[c] + ((r / H) * H + k) * row_bytes;
  const uintptr_t align = (uintptr_t)dst | (uintptr_t)src;
  int64_t done = 0;
  if ((align & 15) == 0)
    done = copy_words<uint4>(dst, src, row_bytes);
  else if ((align & 3) == 0)
    done = copy_words<uint32_t>(dst, src, row_bytes);
  for (int64_t j = done + threadIdx.x; j < row_bytes; j += kThreads) dst[j] = src[j];
}

}  // namespace

extern "C" {

// Permutes n caches (host arrays of n device pointers each; src and dst
// distinct) of rows = B*H rows of row_bytes bytes by cand (B*H int32, or int64
// if cand_is_64), one launch per kMaxCaches caches, on `stream`. Returns the
// CUDA error of the launches (0 = success).
int novic_beam_reorder(const void* const* src, void* const* dst, int n, const void* cand,
                       int cand_is_64, long long rows, int H, long long row_bytes,
                       void* stream) {
  if (n <= 0 || rows <= 0 || H <= 0 || rows % H != 0 || row_bytes <= 0 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  for (int first = 0; first < n; first += kMaxCaches) {
    const int count = n - first < kMaxCaches ? n - first : kMaxCaches;
    CachePointers ptrs = {};
    for (int i = 0; i < count; ++i) {
      ptrs.src[i] = static_cast<const char*>(src[first + i]);
      ptrs.dst[i] = static_cast<char*>(dst[first + i]);
    }
    const dim3 grid((unsigned)rows, (unsigned)count);
    beam_reorder_kernel<<<grid, kThreads, 0, st>>>(ptrs, cand, cand_is_64, H, row_bytes);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
