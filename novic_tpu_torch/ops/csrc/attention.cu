// Tower self-attention for Hopper (sm_90a): softmax(q.k^T / sqrt(hd) + bias).v
//
// Replaces the Pallas kernel novic_tpu/ops/attention.py `fused_attention`
// (bodies `_attention_kernel` and `_attention_kernel_bias`) and computes what it
// computes, rounding where it rounds:
//   * q is scaled in float32, then rounded to bf16; k and v are rounded to bf16;
//   * scores q.k^T accumulate in float32, the optional (S, S) bias is added in
//     float32, and the softmax is float32: exp(s - max) / sum;
//   * the NORMALISED probabilities are rounded to bf16, and P.v accumulates in
//     float32. The output is float32.
// P is normalised before it is rounded, so a row's scores are either kept
// whole or walked twice (a one-pass form would round p elsewhere).
//
// Layout: q, k, v, o are (B, S, H, hd) float32, contiguous, 16-byte aligned;
// bias is (S, S) float32 or null. Any S >= 1, any hd <= 128 that is a
// multiple of 8.
//
// Design (Hopper): a pre-pass (`to_bf16_kernel`) rounds q * scale, k and v
// once into a bf16 scratch buffer (3, B, S, H, hd) that the wrapper
// allocates; the attention kernel, attention_bf16.cu's design, reads it by
// TMA through 4-D tensor maps (hd, S, H, B) that the wrapper plans
// (ops/attention_bf16.py `_tma_plan`). The pre-pass costs 1.5x the function's
// bytes (float32 read, bf16 written and read again), but every query block
// then re-reads bf16 k and v from L2 and converts nothing; converting float32
// tiles inside the kernel, in a converter warpgroup between TMA staging and
// the ring, measured slower (PERF.md). The kernel is persistent; each
// block walks work items (batch, head, query block). A producer warpgroup's
// one thread loads each item's q tile into one of two buffers and streams
// 64-key tiles through a 4-stage ring, each stage completed on a `full`
// mbarrier by its transaction bytes and released on an `empty` one by every
// consumer thread. Consumer warpgroups of 64 query rows (two, and two blocks
// an SM, where hd <= 64; else three and one block) walk the keys twice:
//   pass 1 (k tiles): S = q.k^T by wgmma m64n64k16 (both operands from shared
//     memory, B128 swizzle, K-major), the bias added in float32 straight from
//     global memory (the (S, S) bias is shared by every (b, h) and stays in
//     L2), and per row a running max and sum of exps (ex2.approx on
//     (s - m) * log2 e), merged over the four threads of a row after the pass;
//   pass 2 (k and v tiles): S again, p = exp(s - m) * (1 / l) (one reciprocal
//     per row), rounded to bf16 in registers, and O += P.v by wgmma
//     m64n{hd}k16 in its RS form (P from registers, v the MN-major B
//     operand); the first product overwrites O, so only wgmma writes it.
// The producer gives up registers (setmaxnreg) to the consumers. Keeping a
// row's scores in registers instead (one q.k^T and one exp a score, S <= 256)
// measured no faster at the serving shape.
//
// Tolerance: products of bf16 values are exact in float32; the sums run in
// another order than the plain version's, exps are approximate and p is
// multiplied by 1 / l, so a p can differ in its last float32 bits and move its
// bf16 rounding by one ulp (<= 2^-7 p): an output then differs by at most
// 2^-7 * max|v| over the keys (chip_smoke.py checks this bound, and the
// relative Frobenius error).
//
// Bound on the H100 at SigLIP-B/16 (B=64, S=196, H=12, hd=64): q, k, v and o
// in float32 are 4 x 64*196*768*4 B = 154 MB per launch, ~46 us at 3.35 TB/s;
// the work is ~7.6 GFLOP, ~8 us at the bf16 tensor-core peak; the exps (one
// per score) 0.12 G, ~30 us of the MUFU unit. At DFN5B-H-378 (32, 730, 16,
// 80): 478 MB, 0.143 ms; 21.8 GFLOP, 0.022 ms; two exps per score, 546 M,
// ~0.14 ms. So a launch is memory-bound while its I/O is float32, with the
// exps close behind.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "hopper_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kMaxHd = 128;
constexpr int kMaxDevices = 64;
constexpr int kSmemMax = 232448;   // shared memory a block can have
constexpr int kKTile = 64;         // keys per stage
constexpr int kAtom = 64;          // bf16 per 128-byte swizzled row
constexpr int kProducerRegs = 24;  // setmaxnreg of the producer warpgroup
constexpr int kPlanLen = 11;       // per map: 4 dims, 3 strides, 4 box
constexpr float kLog2e = 1.4426950408889634f;

// The shape of a block for hd in `na` 64-wide atoms, as in attention_bf16.cu:
// hd <= 64, two consumer warpgroups and two blocks an SM; else three and one
__host__ __device__ constexpr int consumers(int na) { return na == 1 ? 2 : 3; }
__host__ __device__ constexpr int blocks_per_sm(int na) { return na == 1 ? 2 : 1; }
__host__ __device__ constexpr int threads(int na) { return 128 * (consumers(na) + 1); }
__host__ __device__ constexpr int q_tile(int na) { return 64 * consumers(na); }
// setmaxnreg moves registers within a block: each thread starts with the
// launch's share of the SM's 65,536 (a multiple of 8), the producer keeps
// few, and the consumers share what it gives up
__host__ __device__ constexpr int launch_regs(int na) {
  return 65536 / (threads(na) * blocks_per_sm(na)) / 8 * 8;
}
__host__ __device__ constexpr int consumer_regs(int na) {
  return (threads(na) * launch_regs(na) - 128 * kProducerRegs) / (128 * consumers(na)) / 8 * 8;
}

// Shared memory: two q buffers (NA atoms of q_tile rows each), the ring (per
// stage: k then v, NA atoms of kKTile rows each), the barriers
template <int NA>
struct Smem {
  static constexpr int kQBytes = NA * q_tile(NA) * 128;
  static constexpr int kKVBytes = NA * kKTile * 128;
  static constexpr int kStageBytes = 2 * kKVBytes;
  // As many stages as fit, up to 4, beside the q buffers, their four
  // barriers and the alignment slack (each stage adds two barriers)
  static constexpr int kFit =
      (kSmemMax / blocks_per_sm(NA) - 2 * kQBytes - 4 * 8 - 1024) / (kStageBytes + 2 * 8);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kBarOffset = 2 * kQBytes + kStages * kStageBytes;
  static constexpr int kBytes = kBarOffset + (2 * kStages + 4) * 8 + 1024;  // + alignment
  static_assert(kStages >= 2 && kBytes <= kSmemMax / blocks_per_sm(NA), "shared memory");
};

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The pre-pass: q * scale, k and v rounded to bf16 (nearest even), blockIdx.y
// picking the tensor; out holds q's n4 quads, then k's, then v's
__global__ void __launch_bounds__(256)
to_bf16_kernel(const float4* __restrict__ q, const float4* __restrict__ k,
               const float4* __restrict__ v, uint2* __restrict__ out, long long n4, float scale) {
  const float4* src = blockIdx.y == 0 ? q : blockIdx.y == 1 ? k : v;
  const float f = blockIdx.y == 0 ? scale : 1.f;  // x * 1 is x: k and v are only rounded
  uint2* dst = out + blockIdx.y * n4;
  const long long stride = (long long)gridDim.x * 256;
  long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  for (; i + 3 * stride < n4; i += 4 * stride) {  // four loads in flight a thread
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      dst[i + u * stride] = make_uint2(pack_bf16(x[u].x * f, x[u].y * f),
                                       pack_bf16(x[u].z * f, x[u].w * f));
  }
  for (; i < n4; i += stride) {
    const float4 x = src[i];
    dst[i] = make_uint2(pack_bf16(x.x * f, x.y * f), pack_bf16(x.z * f, x.w * f));
  }
}

// A block's work item: (query block, head, batch), query blocks fastest so
// that the blocks running together share their heads' k and v in L2
struct Item {
  int q0, h, b;
  __device__ Item(int item, int nq, int H, int q_tile)
      : q0((item % nq) * q_tile), h((item / nq) % H), b(item / nq / H) {}
};

template <int KS, bool kBias>  // KS = hd / 16, rounded up: k-steps of q.k^T
__global__ void __launch_bounds__(threads((KS + 3) / 4), blocks_per_sm((KS + 3) / 4))
attention_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, float* __restrict__ o,
                 const float* __restrict__ bias, int H, int items, int S, int hd) {
  constexpr int NA = (KS + 3) / 4;  // 64-wide atoms of a row
  constexpr int HDP = 16 * KS;      // the P.v product's N
  using L = Smem<NA>;
  constexpr int kStages = L::kStages, kConsumers = consumers(NA), kQTile = q_tile(NA);
  constexpr int kSRegs = kKTile / 2, kORegs = HDP / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;  // two q buffers
  uint64_t* qempty = qfull + 2;
  const int wg = threadIdx.x / 128;
  const int nq = (S + kQTile - 1) / kQTile;
  const int ntiles = (S + kKTile - 1) / kKTile;  // key tiles of one pass
  auto stage = [&](int it) { return smem + 2 * L::kQBytes + (it % kStages) * L::kStageBytes; };
  auto parity = [](int it) { return (uint32_t)(it / kStages) & 1; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every load, running ahead into the
    // next item while the consumers finish this one. Pass 1 brings k tiles,
    // pass 2 k and v ----
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      int it = 0;
      for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
        const Item w(item, nq, H, kQTile);
        const int qb = n & 1;
        mbar_wait(&qempty[qb], ((n >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&qfull[qb], L::kQBytes);
        for (int a = 0; a < NA; ++a)
          tma_load_4d(smem + qb * L::kQBytes + a * kQTile * 128, &qmap, &qfull[qb], a * kAtom,
                      w.q0, w.h, w.b);
        for (int j = 0; j < 2 * ntiles; ++j, ++it) {
          const bool pass2 = j >= ntiles;
          const int key0 = (j % ntiles) * kKTile;
          uint64_t* bar = &full[it % kStages];
          mbar_wait(&empty[it % kStages], parity(it) ^ 1);
          uint8_t* kv = stage(it);
          mbar_arrive_expect_tx(bar, (1 + pass2) * L::kKVBytes);
          for (int a = 0; a < NA; ++a) {
            tma_load_4d(kv + a * kKTile * 128, &kmap, bar, a * kAtom, key0, w.h, w.b);
            if (pass2)
              tma_load_4d(kv + L::kKVBytes + a * kKTile * 128, &vmap, bar, a * kAtom, key0, w.h,
                          w.b);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [q0 + 64 wg, +64) of each item ----
  regs_alloc<consumer_regs(NA)>();
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;  // this thread's rows r0, r0 + 8 of the 64
  const int c2 = 2 * (lane % 4);            // its first column in each n8 block
  int it = 0;  // ring slot, counted across items as the producer counts
  for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
    const Item w(item, nq, H, kQTile);
    const int qb = n & 1;
    const uint32_t q_base = smem_addr(smem + qb * L::kQBytes) + wg * 64 * 128;
    const int row0 = w.q0 + wg * 64 + r0;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
    // O's registers are written only by wgmma (the first P.v overwrites them)
    float acc[kORegs];
    mbar_wait(&qfull[qb], (n >> 1) & 1);
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      for (int tile = 0; tile < ntiles; ++tile, ++it) {
        const int st = it % kStages;
        mbar_wait(&full[st], parity(it));
        const uint32_t k_base = smem_addr(stage(it));
        float s[kSRegs];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 k-elements into the atom
          wgmma_ss<kKTile, 0>(s, desc_b128(q_base + (kk / 4) * kQTile * 128 + off, 16, 1024),
                              desc_b128(k_base + (kk / 4) * kKTile * 128 + off, 16, 1024),
                              kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        if (pass == 0) mbar_arrive(&empty[st]);  // k is no longer read

        // The bias, added in float32, and the ragged key tail (-inf): element
        // i is row (i >> 1) & 1 of the thread's two, key 8 (i / 4) + c2 + (i & 1)
        const int key0 = tile * kKTile;
        if (kBias || key0 + kKTile > S) {
#pragma unroll
          for (int i = 0; i < kSRegs; ++i) {
            const int key = key0 + 8 * (i / 4) + c2 + (i & 1), row = row0 + 8 * ((i >> 1) & 1);
            if (key >= S) s[i] = -INFINITY;
            else if (kBias && row < S) s[i] += __ldg(bias + (size_t)row * S + key);
          }
        }

        if (pass == 0) {
          // Each thread's running max and sum of exps, rescaled once a tile
#pragma unroll
          for (int r = 0; r < 2; ++r) {  // element i is row r when (i >> 1) & 1 == r
            float tmax = -INFINITY;
#pragma unroll
            for (int j = 0; j < kKTile / 8; ++j)
              tmax = fmaxf(tmax, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
            const float m_new = fmaxf(m[r], tmax);
            if (m_new == -INFINITY) continue;  // no valid key seen yet
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kKTile / 8; ++j)
              sum += ex2((s[4 * j + 2 * r] - m_new) * kLog2e) +
                     ex2((s[4 * j + 2 * r + 1] - m_new) * kLog2e);
            l[r] = l[r] * ex2((m[r] - m_new) * kLog2e) + sum;
            m[r] = m_new;
          }
        } else {
          // P normalised and rounded to bf16, as the A operand of 16-key
          // slices: a0 row r0 keys 2c.., a1 row r0 + 8, a2 / a3 keys 8 + 2c..
          uint32_t p[kKTile / 16][4];
#pragma unroll
          for (int kk = 0; kk < kKTile / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 8 * kk + 2 * e, r = e & 1;
              p[kk][e] = pack_bf16(ex2((s[i] - m[r]) * kLog2e) * inv_l[r],
                                   ex2((s[i + 1] - m[r]) * kLog2e) * inv_l[r]);
            }
          const uint32_t v_base = k_base + L::kKVBytes;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kKTile / 16; ++kk)
            wgmma_rs<HDP>(acc, p[kk], desc_b128(v_base + kk * 16 * 128, kKTile * 128, 1024),
                          tile > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          mbar_arrive(&empty[st]);  // k and v are no longer read
        }
      }
      if (pass == 0) {
        // Merge the four threads of each row (lanes 4g .. 4g + 3)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mr = m[r];
#pragma unroll
          for (int off = 1; off < 4; off *= 2)
            mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, off));
          float lr = m[r] == -INFINITY ? 0.f : l[r] * ex2((m[r] - mr) * kLog2e);
#pragma unroll
          for (int off = 1; off < 4; off *= 2) lr += __shfl_xor_sync(0xffffffffu, lr, off);
          m[r] = mr;
          inv_l[r] = 1.f / lr;
        }
      }
    }
    mbar_arrive(&qempty[qb]);  // q is no longer read

    // acc: rows row0 (4j + 0, 1) and row0 + 8 (4j + 2, 3), features 8j + c2 + (0, 1)
    const size_t ld = (size_t)H * hd;
    float* ob = o + ((size_t)w.b * S * H + w.h) * hd;
#pragma unroll
    for (int jj = 0; jj < HDP / 8; ++jj) {
      const int col = 8 * jj + c2;
      if (col >= hd) continue;
      if (row0 < S)
        *reinterpret_cast<float2*>(ob + row0 * ld + col) = make_float2(acc[4 * jj], acc[4 * jj + 1]);
      if (row0 + 8 < S)
        *reinterpret_cast<float2*>(ob + (row0 + 8) * ld + col) =
            make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
    }
  }
}

// The plan of one map agrees with what the kernel loads: dims (hd, S, H, B)
// and a box of one 64-wide atom by `rows`
bool plan_matches(const long long* p, int B, int H, int S, int hd, int rows) {
  return p[0] == hd && p[1] == S && p[2] == H && p[3] == B && p[7] == kAtom && p[8] == rows &&
         p[9] == 1 && p[10] == 1;
}

template <int KS, bool kBias>
cudaError_t launch(const CUtensorMap (&maps)[3], float* o, const float* bias, int B, int S, int H,
                   int hd, int dev, int sms, cudaStream_t stream) {
  auto kernel = attention_kernel<KS, kBias>;
  constexpr int NA = (KS + 3) / 4;
  constexpr int kSmem = Smem<NA>::kBytes;
  static bool configured[kMaxDevices] = {};
  if (!configured[dev]) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  // Persistent: at most blocks_per_sm blocks an SM, each walking items
  // blockIdx.x, + gridDim.x, ...
  const long long items = (long long)((S + q_tile(NA) - 1) / q_tile(NA)) * H * B;
  if (items > INT32_MAX) return cudaErrorInvalidValue;
  const long long slots = (long long)sms * blocks_per_sm(NA);
  const int grid = (int)(items < slots ? items : slots);
  kernel<<<grid, threads(NA), kSmem, stream>>>(maps[0], maps[1], maps[2], o, bias, H, (int)items,
                                               S, hd);
  return cudaGetLastError();
}

template <bool kBias>
cudaError_t dispatch(const CUtensorMap (&maps)[3], float* o, const float* bias, int B, int S,
                     int H, int hd, int dev, int sms, cudaStream_t st) {
  switch ((hd + 15) / 16) {
    case 1: return launch<1, kBias>(maps, o, bias, B, S, H, hd, dev, sms, st);
    case 2: return launch<2, kBias>(maps, o, bias, B, S, H, hd, dev, sms, st);
    case 3: return launch<3, kBias>(maps, o, bias, B, S, H, hd, dev, sms, st);
    case 4: return launch<4, kBias>(maps, o, bias, B, S, H, hd, dev, sms, st);
    case 5: return launch<5, kBias>(maps, o, bias, B, S, H, hd, dev, sms, st);
    case 6: return launch<6, kBias>(maps, o, bias, B, S, H, hd, dev, sms, st);
    case 7: return launch<7, kBias>(maps, o, bias, B, S, H, hd, dev, sms, st);
    default: return launch<8, kBias>(maps, o, bias, B, S, H, hd, dev, sms, st);
  }
}

}  // namespace

extern "C" {

// Launch the pre-pass and the attention kernel on `stream`; returns the first
// CUDA error (0 = success). q, k, v and o 16-byte aligned; scratch a 16-byte
// aligned bf16 (3, B, S, H, hd) buffer, which the pre-pass fills with q *
// scale, k and v. plan: its tensor maps of q, k and v in turn, 11 values
// each: dims (hd, S, H, B), the byte strides of dims 1-3, box (64, rows, 1,
// 1), rows the query block for q (128 where hd <= 64, else 192) and 64 for k
// and v.
int novic_attention(const float* q, const float* k, const float* v, const float* bias, float* o,
                    void* scratch, const long long* plan, int B, int S, int H, int hd, float scale,
                    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > kMaxHd || hd % 8 != 0 || plan == nullptr ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (!plan_matches(plan, B, H, S, hd, q_tile(hd <= kAtom ? 1 : 2)) ||
      !plan_matches(plan + kPlanLen, B, H, S, hd, kKTile) ||
      !plan_matches(plan + 2 * kPlanLen, B, H, S, hd, kKTile))
    return (int)cudaErrorInvalidValue;
  const void* const bases[5] = {q, k, v, o, scratch};
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  static int sm_counts[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sm_counts[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_counts[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int sms = sm_counts[dev];
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * S * H * hd;  // a multiple of 8
  const long long n4 = n / 4, want = (n4 + 1023) / 1024;
  const dim3 grid((unsigned)(want < 8LL * sms ? want : 8LL * sms), 3);
  to_bf16_kernel<<<grid, 256, 0, st>>>(reinterpret_cast<const float4*>(q),
                                       reinterpret_cast<const float4*>(k),
                                       reinterpret_cast<const float4*>(v),
                                       static_cast<uint2*>(scratch), n4, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    err = encode_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     static_cast<__nv_bfloat16*>(scratch) + i * n, 4, plan + kPlanLen * i);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)(bias ? dispatch<true>(maps, o, bias, B, S, H, hd, dev, sms, st)
                    : dispatch<false>(maps, o, bias, B, S, H, hd, dev, sms, st));
}

}  // extern "C"
