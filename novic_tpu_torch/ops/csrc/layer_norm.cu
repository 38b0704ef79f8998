// LayerNorm over the last dim for Hopper (sm_90a), computed in float32:
// y = ((x - mean) * rsqrt(var + eps)) * w + b.
//
// Replaces no TPU kernel: the JAX package writes its towers' LayerNorm in
// plain jnp, which XLA fuses into one pass. The port's plain form
// (layer_norm.py `layer_norm_reference`, the body of embedders/vit.py
// `f32_layer_norm`) is about ten PyTorch launches, each reading or writing a
// float32 copy of the activations. This kernel reads x once and writes y once.
//
// Numerics, at the plain form's rounding points: x is widened to float32
// (exact for bfloat16); mean = sum(x) / D and var = sum((x - mean)^2) / D,
// both sums taken over registers; r = rsqrtf(var + eps), the rsqrtf that
// torch.rsqrt calls on the card; y = ((x - mean) * r) * w + b with every
// product and sum rounded on its own (__fmul_rn / __fadd_rn are never
// contracted into an FMA); y is rounded to nearest even into its type. Only
// the order of the two sums differs from the plain form.
//
// Layout: x is (rows, D) with unit stride along D and a row stride `ldx` in
// elements, so a strided row view such as EVA's x[:, 0, :] is read in place;
// w and b are float32 (D,); y is (rows, D), contiguous. x is float32 or
// bfloat16, y float32 or bfloat16, 1 <= D <= 16384.
//
// Bound on the H100: bytes, rows * D * (x's + y's element size) at 3.35 TB/s:
// (50176, 768) bfloat16 -> bfloat16 is 154 MB, 46 us; (16448, 2730) float32
// -> bfloat16 is 269 MB, 80 us. The arithmetic is a few float32 operations an
// element, far under any peak.
//
// Design, one algorithm whose parameters follow D:
//   * A row lives in registers. D <= 1024: a warp a row, four rows a block of
//     128 threads. Wider rows: a block of 256 threads a row; the sums are
//     reduced by warp shuffles, then across the warps through shared memory.
//   * Thread t of a row's G threads holds chunks j = 0 .. kSlots - 1 of kV
//     elements, chunk j at elements (j * G + t) * kV, so neighbouring threads
//     read neighbouring addresses. kSlots is ceil(D / (G * kV)) rounded up to
//     a power of two (an instance each); chunks past D are masked. All of a
//     thread's loads are issued before its first sum.
//   * kV is 16 bytes of x (4 float32 or 8 bfloat16) where D is a multiple of
//     kV and the bases of x, y, w and b and x's row stride allow 16-byte
//     accesses (the wrapper decides, this file checks); else kV = 1, as for
//     EVA02-L's D = 2730.
//   * A butterfly of shuffles leaves every lane with the same sum (each adds
//     the same two values, in either order), and every thread of a block adds
//     the warps' partials in one order, so a whole row is normalised by one
//     mean and one r.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpRows = 4;        // rows a block in the warp layout
constexpr int kBlockThreads = 256;  // threads a row in the block layout
constexpr int kMaxWarpD = 1024;     // the widest row of the warp layout
constexpr int kMaxD = 16384;

struct Args {
  const void* x;
  void* y;
  const float* w;
  const float* b;
  int64_t rows;
  int D;
  int64_t ldx;
  float eps;
  cudaStream_t stream;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int kV>
__device__ __forceinline__ void load_x(const T* __restrict__ p, float* v) {
  if constexpr (kV == 1) {
    v[0] = to_float(*p);
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(kV == 4, "a 16-byte chunk of float32");
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    static_assert(kV == 8, "a 16-byte chunk of bfloat16");
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// kV float32 parameters: 16-byte loads where kV > 1 (the address is then aligned)
template <int kV>
__device__ __forceinline__ void load_params(const float* __restrict__ p, float* v) {
  if constexpr (kV == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < kV / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  }
}

template <int kV>
__device__ __forceinline__ void store_y(float* __restrict__ p, const float* v) {
  if constexpr (kV == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < kV / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                                    v[4 * i + 3]);
  }
}

template <int kV>
__device__ __forceinline__ void store_y(__nv_bfloat16* __restrict__ p, const float* v) {
  if constexpr (kV == 1) {
    *p = __float2bfloat16_rn(v[0]);
  } else {
    __align__(16) __nv_bfloat16 o[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) o[i] = __float2bfloat16_rn(v[i]);
    if constexpr (kV == 4)
      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(o);
    else
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(o);
  }
}

// The sum over a row's threads, the same in every one of them
template <bool kBlock>
__device__ __forceinline__ float row_sum(float s, float* partial) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, m));
  if constexpr (kBlock) {
    if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = s;
    __syncthreads();
    s = 0.0f;
#pragma unroll
    for (int i = 0; i < kBlockThreads / 32; ++i) s = __fadd_rn(s, partial[i]);
  }
  return s;
}

template <typename Tin, typename Tout, int kV, int kSlots, bool kBlock>
__global__ void __launch_bounds__(kBlock ? kBlockThreads : 32 * kWarpRows)
layer_norm_kernel(const Tin* __restrict__ x, Tout* __restrict__ y, const float* __restrict__ w,
                  const float* __restrict__ b, int64_t rows, int D, int64_t ldx, float eps) {
  constexpr int G = kBlock ? kBlockThreads : 32;
  // One array for each sum, so no warp can overwrite the mean's partials
  // before every warp has read them
  __shared__ float partial[2][kBlock ? kBlockThreads / 32 : 1];
  const int t = kBlock ? threadIdx.x : threadIdx.x % 32;
  const int64_t row = kBlock ? (int64_t)blockIdx.x
                             : (int64_t)blockIdx.x * kWarpRows + threadIdx.x / 32;
  if (row >= rows) return;  // a whole warp (warp layout); never in the block layout
  const Tin* xr = x + row * ldx;
  Tout* yr = y + row * (int64_t)D;

  float v[kSlots * kV];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int i = (j * G + t) * kV;
    if (i < D) load_x<Tin, kV>(xr + i, v + j * kV);
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if ((j * G + t) * kV < D) {
#pragma unroll
      for (int e = 0; e < kV; ++e) s = __fadd_rn(s, v[j * kV + e]);
    }
  }
  const float mean = __fdiv_rn(row_sum<kBlock>(s, partial[0]), (float)D);

  float q = 0.0f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if ((j * G + t) * kV < D) {
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const float d = __fsub_rn(v[j * kV + e], mean);
        q = __fadd_rn(q, __fmul_rn(d, d));
      }
    }
  }
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(row_sum<kBlock>(q, partial[1]), (float)D), eps));

#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int i = (j * G + t) * kV;
    if (i < D) {
      float wv[kV], bv[kV], o[kV];
      load_params<kV>(w + i, wv);
      load_params<kV>(b + i, bv);
#pragma unroll
      for (int e = 0; e < kV; ++e)
        o[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[j * kV + e], mean), r), wv[e]), bv[e]);
      store_y<kV>(yr + i, o);
    }
  }
}

constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// The instances a layout needs: kSlots from the narrowest row it takes to the widest
template <bool kBlock, int kV>
struct Slots {
  static constexpr int kG = kBlock ? kBlockThreads : 32;
  static constexpr int kLo = kBlock ? pow2_at_least((kMaxWarpD + kG * kV) / (kG * kV)) : 1;
  static constexpr int kHi = (kBlock ? kMaxD : kMaxWarpD) / (kG * kV);
};

template <typename Tin, typename Tout, int kV, bool kBlock, int kSlots>
void launch_slots(const Args& a, int slots) {
  if constexpr (kSlots < Slots<kBlock, kV>::kHi) {
    if (slots > kSlots) {
      launch_slots<Tin, Tout, kV, kBlock, 2 * kSlots>(a, slots);
      return;
    }
  }
  const int64_t grid = kBlock ? a.rows : (a.rows + kWarpRows - 1) / kWarpRows;
  layer_norm_kernel<Tin, Tout, kV, kSlots, kBlock>
      <<<(unsigned)grid, kBlock ? kBlockThreads : 32 * kWarpRows, 0, a.stream>>>(
          (const Tin*)a.x, (Tout*)a.y, a.w, a.b, a.rows, a.D, a.ldx, a.eps);
}

template <typename Tin, typename Tout, int kV>
void launch(const Args& a) {
  if (a.D > kMaxWarpD) {
    const int g = kBlockThreads * kV;
    launch_slots<Tin, Tout, kV, true, Slots<true, kV>::kLo>(a, (a.D + g - 1) / g);
  } else {
    launch_slots<Tin, Tout, kV, false, 1>(a, (a.D + 32 * kV - 1) / (32 * kV));
  }
}

template <typename Tin, typename Tout>
void launch_types(const Args& a, bool vector) {
  if (vector)
    launch<Tin, Tout, (int)(16 / sizeof(Tin))>(a);
  else
    launch<Tin, Tout, 1>(a);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" {

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16. vector: 16-byte accesses
// (refused unless D and every base and x's row stride allow them). Launches
// on `stream`; returns the CUDA error of the launch (0 = success).
int novic_layer_norm(const void* x, void* y, const void* w, const void* b, long long rows, int D,
                     long long ldx, float eps, int in_dtype, int out_dtype, int vector,
                     void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || D <= 0 || D > kMaxD || ldx < 0 ||
      (in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long in_size = in_dtype == 0 ? 4 : 2;
  if (vector && (D % (16 / in_size) != 0 || (ldx * in_size) % 16 != 0 || !aligned16(x) ||
                 !aligned16(y) || !aligned16(w) || !aligned16(b)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, y, (const float*)w, (const float*)b, rows, D, ldx, eps, (cudaStream_t)stream};
  if (in_dtype == 0 && out_dtype == 0)
    launch_types<float, float>(a, vector);
  else if (in_dtype == 0)
    launch_types<float, __nv_bfloat16>(a, vector);
  else if (out_dtype == 0)
    launch_types<__nv_bfloat16, float>(a, vector);
  else
    launch_types<__nv_bfloat16, __nv_bfloat16>(a, vector);
  return (int)cudaGetLastError();
}

}  // extern "C"
