// Attention over bf16 inputs in strided layouts for Hopper (sm_90a):
// softmax(scale * q.k^T over the keys < s_valid) . v, float32 or bf16 out.
//
// Replaces the Pallas kernels of exp/pallas_attn_v2.py `fused_attention2` (X1;
// def :44, pallas_call :53, body `attn_kernel` :28) and of
// exp/dfn5b_attention.py `make_attn_fullseq` (X2; :131, call :144, body
// `_fullseq_kernel`), `make_attn_allheads` (:175, :186, `_allheads_kernel`) and
// `make_attn_direct` (:246, :258, `_direct_kernel`). Each body computes, per
// (batch, head), and this kernel computes, rounding where they round:
//   * s = q.k^T over bf16 operands, accumulated in float32;
//   * s *= scale, in float32 after the product (X1: 1/sqrt(hd); X2: 1, since
//     its q arrives pre-scaled and rounded to bf16);
//   * keys at or past s_valid are masked (-1e30 there; exp gives 0 for both);
//   * p = exp(s - max) / sum, NORMALISED, then rounded to bf16;
//   * o = p.v accumulated in float32, stored as float32 or rounded to bf16.
// The Pallas kernels differ only in the layouts they read and write. This
// kernel reads q, k and v through 4-D tensor maps (hd, s_valid, H, B) whose
// byte strides the wrapper plans (`_tma_plan` in ops/attention_bf16.py), so
// X1's (B, S, E), fullseq's (B*H, SP, 1, hd) and allheads/direct's (B, SP, H,
// hd) are all read in place; the maps' extents zero-fill features past hd and
// rows past s_valid, which are never read. Queries past s_valid are not
// stored (the harnesses slice them off).
//
// Layout: q, k, v bf16, 16-byte aligned, hd contiguous, other strides
// multiples of 16 bytes; hd a multiple of 8, at most 128; any s_valid >= 1.
// o float32 or bf16 with element strides (batch, seq, head), hd contiguous.
//
// Design (Hopper): a persistent kernel; each block walks work items (batch,
// head, query block). Where hd <= 64 a block has two consumer warpgroups
// (128 queries) and two blocks share an SM; else three (192 queries) and one
// block an SM. The last warpgroup is the producer: one thread loads each
// item's q tile by TMA into one of two buffers (the next item's q lands while
// this one's is read), then streams 64-key tiles through a shared-memory
// ring (4 stages) by TMA, each stage completed on a `full` mbarrier by its
// transaction bytes and released on an `empty` mbarrier by every consumer
// thread; it runs ahead into the next item while the consumers finish this
// one. Each consumer warpgroup owns 64 query rows of an item and walks its
// keys twice:
//   pass 1: S = q.k^T by wgmma m64n64k16 (both operands from shared memory,
//     128-byte swizzled, K-major), scaled and masked in float32; each thread
//     keeps a running max and a sum of exps (ex2.approx on (s - m) * log2 e,
//     s - m taken in float32) per row, rescaled once per tile; the four
//     threads of a row merge after the pass;
//   pass 2: S again by wgmma, p = exp(s - m) * (1 / l) (one reciprocal per
//     row), rounded to bf16 in registers, where the score accumulator's layout
//     is the register A operand's; O += P.v by wgmma m64n{hd}k16 in its RS
//     form, v read from shared memory as the MN-major B operand (transpose
//     bit); the first product overwrites O, so no other instruction writes an
//     accumulator (ptxas serialises wgmmas around such writes). A row of 80
//     or 128 features lands as two 64-wide swizzle atoms.
// The consumer warpgroups (and, at hd <= 64, the other block's) take turns
// on the SM: while one computes its exps another's wgmma runs. The producer
// gives up registers (setmaxnreg) to the consumers. Issuing the next tile's
// S before this tile's exps, within a warpgroup, measured slower.
//
// Bound on the H100 at X2's shape (B=32, S=730, H=16, hd=80): the two
// products are 4*B*H*S^2*hd = 87.3 GFLOP, 0.0883 ms at the 989 TFLOP/s bf16
// peak; q, k, v in bf16 and o in float32 are 299 MB, 0.0893 ms at 3.35 TB/s
// (bf16 out: 239 MB, 0.0714 ms, so operations bound it). At X1's (256, 196,
// 12, 64): 385 MB, 0.1150 ms, bytes. The kernel reads q, k, v once from device
// memory (each query tile re-reads its head's k and v from L2) and writes o
// once in full 32-byte sectors; pass 2's recompute of q.k^T is 1.5x the
// products' operations.
//
// Tolerance: products of bf16 values are exact in float32; sums run in
// another order than the plain version's, the exps are ex2.approx and p is
// multiplied by 1 / l, so a p can differ from the plain version's in its last
// float32 bits and its bf16 rounding by one ulp (<= 2^-7 p): an output then
// differs by at most 2^-7 * max|v| over the keys, plus one bf16 ulp of the
// output where it is stored as bf16.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "hopper_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kSmemMax = 232448;                   // shared memory a block can have
constexpr int kKTile = 64;                         // keys per stage
constexpr int kAtom = 64;                          // bf16 per 128-byte swizzled row
constexpr int kMaxHd = 128;                        // as the wrapper's MAX_HD
constexpr int kMaxDevices = 64;
constexpr int kProducerRegs = 24;                  // setmaxnreg of the producer warpgroup
// The shape of a block for hd in `na` 64-wide atoms. hd <= 64: two consumer
// warpgroups of 64 query rows, two blocks an SM (97 KB of shared memory and
// 104 registers a consumer thread each), so that one block's exps overlap the
// other's products and loads. hd > 64: three consumer warpgroups, one block
// an SM (225 KB, 160 registers). Each block adds a producer warpgroup.
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
constexpr int kPlanLen = 11;                       // per map: 4 dims, 3 strides, 4 box
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // in elements; hd is contiguous
};

// Shared memory for hd in NA 64-wide atoms: two q buffers (NA atoms of
// q_tile rows each), the ring (per stage: k then v, NA atoms of kKTile rows each),
// the barriers
template <int NA>
struct Smem {
  static constexpr int kQBytes = NA * q_tile(NA) * 128;
  static constexpr int kKVBytes = NA * kKTile * 128;
  static constexpr int kStageBytes = 2 * kKVBytes;
  // As many stages as fit, up to 4 (the barriers and the alignment slack
  // take the last 1.1 KB)
  static constexpr int kFit =
      (kSmemMax / blocks_per_sm(NA) - 2 * kQBytes - 1024 - 12 * 8 - 1024) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kBarOffset = 2 * kQBytes + kStages * kStageBytes;
  static constexpr int kBytes = kBarOffset + (2 * kStages + 4) * 8 + 1024;  // + alignment
  static_assert(kStages >= 2 && kBytes <= kSmemMax, "shared memory");
};

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <bool kOutBF16>
__device__ __forceinline__ void store_pair(void* o, long long idx, float x, float y) {
  if constexpr (kOutBF16) {
    *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(o) + idx) = pack_bf16(x, y);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(o) + idx) = make_float2(x, y);
  }
}

// A block's work item: (query block, head, batch), query blocks fastest so
// that the blocks running together share their heads' k and v in L2
struct Item {
  int q0, h, b;
  __device__ Item(int item, int nq, int H, int q_tile)
      : q0((item % nq) * q_tile), h((item / nq) % H), b(item / nq / H) {}
};

template <int KS, bool kOutBF16>  // KS = hd / 16, rounded up: k-steps of q.k^T
__global__ void __launch_bounds__(threads((KS + 3) / 4), blocks_per_sm((KS + 3) / 4))
attention_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, void* __restrict__ o, Strides os,
                      int H, int items, int s_valid, int hd, float scale) {
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
  const int nq = (s_valid + kQTile - 1) / kQTile;
  const int ntiles = (s_valid + kKTile - 1) / kKTile;  // key tiles of one pass
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
    // next item while the consumers finish this one ----
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
          mbar_arrive_expect_tx(bar, (pass2 ? 2 : 1) * L::kKVBytes);
          for (int a = 0; a < NA; ++a)
            tma_load_4d(kv + a * kKTile * 128, &kmap, bar, a * kAtom, key0, w.h, w.b);
          if (pass2)
            for (int a = 0; a < NA; ++a)
              tma_load_4d(kv + L::kKVBytes + a * kKTile * 128, &vmap, bar, a * kAtom, key0, w.h,
                          w.b);
        }
      }
    }
  } else {
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
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
      // O's registers are written only by wgmma (the first P.v overwrites
      // them): ptxas serialises wgmmas around other writes to an accumulator
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

          // Scale in float32; keys at or past s_valid (zero-filled) get -inf
          const int key0 = tile * kKTile;
#pragma unroll
          for (int i = 0; i < kSRegs; ++i) s[i] *= scale;
          if (key0 + kKTile > s_valid) {
#pragma unroll
            for (int i = 0; i < kSRegs; ++i)
              if (key0 + 8 * (i / 4) + c2 + (i & 1) >= s_valid) s[i] = -INFINITY;
          }

          if (pass == 0) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {  // element i is row r when (i / 2) % 2 == r
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

      // acc: rows r0 (4j + 0, 1) and r0 + 8 (4j + 2, 3), features 8j + c2 + (0, 1)
      const int row0 = w.q0 + wg * 64 + r0, row1 = row0 + 8;
      const long long obase = w.b * os.b + w.h * os.h;
#pragma unroll
      for (int jj = 0; jj < HDP / 8; ++jj) {
        const int col = 8 * jj + c2;
        if (col >= hd) continue;
        if (row0 < s_valid)
          store_pair<kOutBF16>(o, obase + row0 * os.s + col, acc[4 * jj], acc[4 * jj + 1]);
        if (row1 < s_valid)
          store_pair<kOutBF16>(o, obase + row1 * os.s + col, acc[4 * jj + 2], acc[4 * jj + 3]);
      }
    }
  }
}

// The plan of one map agrees with what the kernel loads: dims (hd, s_valid,
// H, B) and a box of one 64-wide atom by `rows`
bool plan_matches(const long long* p, int B, int H, int s_valid, int hd, int rows) {
  return p[0] == hd && p[1] == s_valid && p[2] == H && p[3] == B && p[7] == kAtom &&
         p[8] == rows && p[9] == 1 && p[10] == 1;
}

template <int KS, bool kOutBF16>
cudaError_t launch(const void* const (&base)[3], const long long* plan, void* o, Strides os, int B,
                   int H, int s_valid, int hd, float scale, cudaStream_t stream) {
  auto kernel = attention_bf16_kernel<KS, kOutBF16>;
  constexpr int kSmem = Smem<(KS + 3) / 4>::kBytes;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    err = encode_bf16_map(&maps[i], base[i], 4, plan + kPlanLen * i);
    if (err != cudaSuccess) return err;
  }
  // Persistent: at most blocks_per_sm blocks an SM, each walking items
  // blockIdx.x, + gridDim.x, ...
  static int sms[kMaxDevices] = {};
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  constexpr int NA = (KS + 3) / 4;
  const long long items = (long long)((s_valid + q_tile(NA) - 1) / q_tile(NA)) * H * B;
  if (items > INT32_MAX) return cudaErrorInvalidValue;
  const int slots = sms[dev] * blocks_per_sm(NA);
  const int grid = (int)(items < slots ? items : slots);
  kernel<<<grid, threads(NA), kSmem, stream>>>(maps[0], maps[1], maps[2], o, os, H, (int)items,
                                            s_valid, hd, scale);
  return cudaGetLastError();
}

template <bool kOutBF16>
cudaError_t dispatch(const void* const (&base)[3], const long long* plan, void* o, Strides os,
                     int B, int H, int s_valid, int hd, float scale, cudaStream_t stream) {
  switch ((hd + 15) / 16) {
    case 1: return launch<1, kOutBF16>(base, plan, o, os, B, H, s_valid, hd, scale, stream);
    case 2: return launch<2, kOutBF16>(base, plan, o, os, B, H, s_valid, hd, scale, stream);
    case 3: return launch<3, kOutBF16>(base, plan, o, os, B, H, s_valid, hd, scale, stream);
    case 4: return launch<4, kOutBF16>(base, plan, o, os, B, H, s_valid, hd, scale, stream);
    case 5: return launch<5, kOutBF16>(base, plan, o, os, B, H, s_valid, hd, scale, stream);
    case 6: return launch<6, kOutBF16>(base, plan, o, os, B, H, s_valid, hd, scale, stream);
    case 7: return launch<7, kOutBF16>(base, plan, o, os, B, H, s_valid, hd, scale, stream);
    default: return launch<8, kOutBF16>(base, plan, o, os, B, H, s_valid, hd, scale, stream);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error of the launch (0 = success).
// plan: the tensor maps of q, k and v in turn, 11 values each: dims (hd,
// s_valid, H, B), byte strides of dims 1-3, box (64, rows, 1, 1): for q the
// query block, 128 rows where hd <= 64, else 192; 64 for k and v. ostrides: o's (batch, seq, head) element strides.
int novic_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         const long long* plan, const long long* ostrides, int B, int H,
                         int s_valid, int hd, float scale, int out_bf16, void* stream) {
  if (B <= 0 || H <= 0 || s_valid <= 0 || hd <= 0 || hd > kMaxHd || hd % 8 != 0 ||
      plan == nullptr || ostrides == nullptr)
    return (int)cudaErrorInvalidValue;
  if (!plan_matches(plan, B, H, s_valid, hd, q_tile(hd <= kAtom ? 1 : 2)) ||
      !plan_matches(plan + kPlanLen, B, H, s_valid, hd, kKTile) ||
      !plan_matches(plan + 2 * kPlanLen, B, H, s_valid, hd, kKTile))
    return (int)cudaErrorInvalidValue;
  const void* const base[3] = {q, k, v};
  const Strides os{ostrides[0], ostrides[1], ostrides[2]};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(out_bf16 ? dispatch<true>(base, plan, o, os, B, H, s_valid, hd, scale, s)
                        : dispatch<false>(base, plan, o, os, B, H, s_valid, hd, scale, s));
}

}  // extern "C"
