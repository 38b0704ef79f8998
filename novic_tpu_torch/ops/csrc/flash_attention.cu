// One-pass (online-softmax) attention with segment ids for Hopper (sm_90a):
// the forward pass of JAX's TPU flash-attention kernel as the repo calls it.
//
// Replaces jax.experimental.pallas.ops.tpu.flash_attention (pallas_call at
// flash_attention.py:758; bodies `_flash_attention_kernel_single_batch` :342
// and `_flash_attention_kernel_single_batch_single_step` :484), which the exp/
// harnesses reach through `make_attn_flash` (exp/dfn5b_attention.py:91) and
// `attn_flash` (exp/attn_variants.py:68) (X6). Per (batch, head):
//   * s = q.k^T over bf16 operands, accumulated in float32, then s *= scale;
//   * where the query's and the key's segment ids differ, s += -0.7 * FLT_MAX
//     (DEFAULT_MASK_VALUE: finite and additive, so a query whose keys are all
//     masked gets the plain average of v over every key, never NaN);
//   * online softmax per key block: m' = max(m, rowmax s), p = exp(s - m'),
//     l' = rowsum p + exp(m - m') * l, the UNNORMALISED p rounded to bf16 and
//     o' = exp(m - m') * o + bf16(p).v accumulated in float32;
//   * o / l stored as bf16 (q's dtype).
// JAX's multi-step body keeps o normalised after every block (o *= l_corr /
// l', o += bf16(p).v / l'); dividing once at the end differs from it only in
// float32 rounding. Its single-step body (block_k == kv length) rounds the
// normalised p instead; the plain version (ops/flash_attention.py) follows
// either blocking exactly.
//
// Layout: q (B, H, Sq, hd), k and v (B, H, Skv, hd) bf16 views read through
// 4-D tensor maps (hd, S, H, B) whose byte strides the wrapper plans
// (`_tma_plan` of ops/attention_bf16.py on the (B, S, H, hd) view), so the
// harnesses' (B, H, Sp, hd) views of their (B, Sp, H, hd) projections are read
// in place: 16-byte aligned, hd contiguous, other strides multiples of 16
// bytes; hd a multiple of 8, at most 128 (the maps zero-fill the 64-wide
// atom past hd); any Sq, Skv >= 1. o (B, H, Sq, hd) bf16 with element
// strides (batch, head, seq). Segment ids, when given: int32 (B, Sq) and
// (B, Skv_pad), Skv_pad the key count rounded up to the 64-key tile (the
// wrapper pads; ids past Skv are never read as keys).
//
// Design (Hopper), the structure of attention_bf16.cu walked once: a
// persistent kernel; each block walks work items (batch, head, query block).
// Where hd <= 64 a block has two consumer warpgroups (128 queries) and two
// blocks share an SM, else three (192 queries) and one block an SM. The last
// warpgroup is the producer: one thread loads each item's q tile by TMA into
// one of two buffers, then streams 64-key tiles through a ring (4 stages):
// k and v by TMA and the tile's 64 key segment ids by a bulk copy, each stage
// completed on a `full` mbarrier by its transaction bytes and released on an
// `empty` mbarrier by every consumer thread. Each consumer warpgroup owns 64
// query rows of an item and, per key tile, computes S(t) = q.k^T by wgmma
// m64n64k16 (both operands from shared memory, B128 swizzle, K-major), waits,
// and runs the tile's softmax: scale, mask, row max over the four threads of
// a row, alpha = exp(m - m'), p = exp(s - m') as ex2.approx on (s - m') *
// log2 e, l = alpha * l + sum p, O *= alpha, and p rounded to bf16 in
// registers (the score accumulator's layout is the A operand's); O += P.V is
// a wgmma m64n{hd}k16 in its RS form (P from registers, v the MN-major B
// operand). With three consumers (hd > 64, 160 registers a thread) a tile's
// S(t) is issued together with the previous tile's P.V, so each wait covers
// both; with two (hd <= 64, two blocks an SM, 104 registers) holding S, O and
// P at once would make ptxas serialise the wgmmas, so P.V follows at once. O
// is rescaled only after wgmma.wait_group has retired every product that
// writes it, so no instruction writes an accumulator while a wgmma is in
// flight (ptxas serialises wgmmas around such writes). The warpgroups run
// free: while one computes its exps, the others' products run; making them
// take turns (named barriers) measured slower (PERF.md). The producer
// gives up registers (setmaxnreg) to the consumers. The online update block
// is the 64-key tile, where the kernel rounds p as JAX's multi-step body does
// at block_k = 64.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): every one of the Sq rows is
// computed, padded queries included. At the DFN5B harness's (32, 16, 768, 80)
// the two products are 4*B*H*S^2*hd = 96.6 GFLOP, 0.0977 ms; q, k, v and o in
// bf16 are 252 MB, 0.0751 ms: operations bound it, and the 302 M exps take
// about 0.077 ms of the MUFU unit (3.9 T exp/s), which the other warpgroups'
// products overlap. At attn_variants' (256, 12, 256, 64): 51.5 GFLOP, 0.0521 ms;
// 403 MB, 0.120 ms: bytes.
//
// Tolerance against the plain version at block_k = 64: products of bf16
// values are exact in float32; sums and exp differ in their last bits, which
// can move the bf16 rounding of a p by one ulp (<= 2^-8 relative), so an
// output moves by at most 2^-7 * max|v| over the keys, plus one bf16 ulp of
// the output.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>
#include <math.h>

#include "hopper_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kSmemMax = 232448;    // shared memory a block can have
constexpr int kKTile = 64;          // keys per stage and online update (KERNEL_BLOCK_K)
constexpr int kAtom = 64;           // bf16 per 128-byte swizzled row
constexpr int kMaxHd = 128;
constexpr int kMaxDevices = 64;
constexpr int kProducerRegs = 24;   // setmaxnreg of the producer warpgroup
constexpr int kPlanLen = 11;        // per map: 4 dims, 3 strides, 4 box
constexpr float kLog2e = 1.4426950408889634f;
// flash_attention.py DEFAULT_MASK_VALUE: the product in double, then float32
constexpr float kMaskValue = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));

// The shape of a block for hd in `na` 64-wide atoms, as in attention_bf16.cu:
// hd <= 64, two consumer warpgroups and two blocks an SM; else three and one
__host__ __device__ constexpr int consumers(int na) { return na == 1 ? 2 : 3; }
__host__ __device__ constexpr int blocks_per_sm(int na) { return na == 1 ? 2 : 1; }
__host__ __device__ constexpr int threads(int na) { return 128 * (consumers(na) + 1); }
__host__ __device__ constexpr int q_tile(int na) { return 64 * consumers(na); }
__host__ __device__ constexpr int launch_regs(int na) {
  return 65536 / (threads(na) * blocks_per_sm(na)) / 8 * 8;
}
__host__ __device__ constexpr int consumer_regs(int na) {
  return (threads(na) * launch_regs(na) - 128 * kProducerRegs) / (128 * consumers(na)) / 8 * 8;
}

struct Strides {
  long long b, h, s;  // in elements; hd is contiguous
};

// Shared memory for hd in NA atoms: two q buffers (NA atoms of q_tile rows),
// the ring (per stage k then v, NA atoms of kKTile rows each, 1024-byte
// aligned), the stages' key segment ids, the barriers
template <int NA>
struct Smem {
  static constexpr int kQBytes = NA * q_tile(NA) * 128;
  static constexpr int kKVBytes = NA * kKTile * 128;
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kSegBytes = kKTile * 4;
  // As many stages as fit, up to 4, beside the q buffers, four q barriers and
  // the alignment slack (each stage adds its segment ids and two barriers)
  static constexpr int kFit = (kSmemMax / blocks_per_sm(NA) - 2 * kQBytes - 4 * 8 - 1024) /
                              (kStageBytes + kSegBytes + 2 * 8);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSegOffset = 2 * kQBytes + kStages * kStageBytes;
  static constexpr int kBarOffset = kSegOffset + kStages * kSegBytes;
  static constexpr int kBytes = kBarOffset + (2 * kStages + 4) * 8 + 1024;  // + alignment
  static_assert(kStages >= 2 && kBytes <= kSmemMax / blocks_per_sm(NA), "shared memory");
};

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A block's work item: (query block, head, batch), query blocks fastest so
// that the blocks running together share their heads' k and v in L2
struct Item {
  int q0, h, b;
  __device__ Item(int item, int nq, int H, int q_tile)
      : q0((item % nq) * q_tile), h((item / nq) % H), b(item / nq / H) {}
};

template <int KS, bool kSeg>  // KS = hd / 16, rounded up: k-steps of q.k^T
__global__ void __launch_bounds__(threads((KS + 3) / 4), blocks_per_sm((KS + 3) / 4))
flash_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                       Strides os, const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                       int H, int items, int sq, int skv, int hd, float scale) {
  constexpr int NA = (KS + 3) / 4;  // 64-wide atoms of a row
  constexpr int HDP = 16 * KS;      // the P.v product's N
  using L = Smem<NA>;
  constexpr int kStages = L::kStages, kConsumers = consumers(NA), kQTile = q_tile(NA);
  constexpr int kSRegs = kKTile / 2, kORegs = HDP / 2;
  // Three consumers (160 registers each) issue a tile's S with the previous
  // tile's P.v; two (104 each, two blocks an SM) issue them one after the
  // other, as holding S, O and P at once would serialise their wgmmas (C7512)
  constexpr bool kMerged = kConsumers == 3;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;  // two q buffers
  uint64_t* qempty = qfull + 2;
  const int wg = threadIdx.x / 128;
  const int nq = (sq + kQTile - 1) / kQTile;
  const int ntiles = (skv + kKTile - 1) / kKTile;
  auto stage = [&](int it) { return smem + 2 * L::kQBytes + (it % kStages) * L::kStageBytes; };
  auto seg_stage = [&](int it) {
    return reinterpret_cast<int*>(smem + L::kSegOffset) + (it % kStages) * kKTile;
  };
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
      const int skv_pad = ntiles * kKTile;
      int it = 0;
      for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
        const Item w(item, nq, H, kQTile);
        const int qb = n & 1;
        mbar_wait(&qempty[qb], ((n >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&qfull[qb], L::kQBytes);
        for (int a = 0; a < NA; ++a)
          tma_load_4d(smem + qb * L::kQBytes + a * kQTile * 128, &qmap, &qfull[qb], a * kAtom,
                      w.q0, w.h, w.b);
        for (int t = 0; t < ntiles; ++t, ++it) {
          const int key0 = t * kKTile;
          uint64_t* bar = &full[it % kStages];
          mbar_wait(&empty[it % kStages], parity(it) ^ 1);
          uint8_t* kv = stage(it);
          mbar_arrive_expect_tx(bar, 2 * L::kKVBytes + (kSeg ? L::kSegBytes : 0));
          for (int a = 0; a < NA; ++a) {
            tma_load_4d(kv + a * kKTile * 128, &kmap, bar, a * kAtom, key0, w.h, w.b);
            tma_load_4d(kv + L::kKVBytes + a * kKTile * 128, &vmap, bar, a * kAtom, key0, w.h,
                        w.b);
          }
          if (kSeg)
            bulk_load(seg_stage(it), kv_seg + (long long)w.b * skv_pad + key0, L::kSegBytes, bar);
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
      const int row0 = w.q0 + wg * 64 + r0, row1 = row0 + 8;
      int qseg[2] = {0, 0};
      if (kSeg) {
        qseg[0] = row0 < sq ? q_seg[(long long)w.b * sq + row0] : 0;
        qseg[1] = row1 < sq ? q_seg[(long long)w.b * sq + row1] : 0;
      }
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      float acc[kORegs];
      uint32_t p[kKTile / 16][4];  // a tile's bf16 P, A operand of 16-key slices
      mbar_wait(&qfull[qb], (n >> 1) & 1);
      for (int tile = 0; tile < ntiles + kMerged; ++tile) {
        const bool has_s = tile < ntiles, has_pv = kMerged && tile > 0;
        if (has_s) mbar_wait(&full[(it + tile) % kStages], parity(it + tile));
        float s[kSRegs];
        fence_regs(acc);
        wgmma_fence();
        if (has_s) {
          const uint32_t k_base = smem_addr(stage(it + tile));
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            const uint32_t off = (kk % 4) * 32;  // 16 k-elements into the atom
            wgmma_ss<kKTile, 0>(s, desc_b128(q_base + (kk / 4) * kQTile * 128 + off, 16, 1024),
                                desc_b128(k_base + (kk / 4) * kKTile * 128 + off, 16, 1024),
                                kk > 0);
          }
        }
        if (has_pv) {
          const uint32_t v_base = smem_addr(stage(it + tile - 1)) + L::kKVBytes;
#pragma unroll
          for (int kk = 0; kk < kKTile / 16; ++kk)
            wgmma_rs<HDP>(acc, p[kk], desc_b128(v_base + kk * 16 * 128, kKTile * 128, 1024),
                          tile > 1 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(acc);
        if (has_pv) mbar_arrive(&empty[(it + tile - 1) % kStages]);  // k and v no longer read
        if (!has_s) break;

        // Scale and mask in float32: segment ids that differ add the finite
        // mask value; keys at or past skv (zero-filled) get -inf
        const int key0 = tile * kKTile;
        const int* tseg = seg_stage(it + tile);
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < kSRegs; ++i) {
          const int key = 8 * (i / 4) + c2 + (i & 1), r = (i >> 1) & 1;  // in the tile
          float x = s[i] * scale;
          if (kSeg) x += tseg[key] == qseg[r] ? 0.f : kMaskValue;
          x = key0 + key < skv ? x : -INFINITY;
          s[i] = x;
          tmax[r] = fmaxf(tmax[r], x);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int off = 1; off < 4; off *= 2)
            tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], off));
          // Every tile holds a key, so the new max is finite: no -inf - -inf
          const float m_new = fmaxf(m[r], tmax[r]);
          alpha[r] = ex2((m[r] - m_new) * kLog2e);
          m[r] = m_new;
          l[r] *= alpha[r];
        }
        // p = exp(s - m), unnormalised, summed in float32 and rounded to bf16:
        // a0 row r0 keys 2c.., a1 row r0 + 8, a2 / a3 keys 8 + 2c..
#pragma unroll
        for (int kk = 0; kk < kKTile / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * kk + 2 * e, r = e & 1;
            const float p0 = ex2((s[i] - m[r]) * kLog2e), p1 = ex2((s[i + 1] - m[r]) * kLog2e);
            l[r] += p0 + p1;
            p[kk][e] = pack_bf16(p0, p1);
          }
        // O holds every product so far (the wait above retired them): rescale it
        if (tile > 0) {
#pragma unroll
          for (int i = 0; i < kORegs; ++i) acc[i] *= alpha[(i >> 1) & 1];
        }
        if (!kMerged) {  // this tile's P.v at once
          const uint32_t v_base = smem_addr(stage(it + tile)) + L::kKVBytes;
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kKTile / 16; ++kk)
            wgmma_rs<HDP>(acc, p[kk], desc_b128(v_base + kk * 16 * 128, kKTile * 128, 1024),
                          tile > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          mbar_arrive(&empty[(it + tile) % kStages]);  // k and v are no longer read
        }
      }
      it += ntiles;
      mbar_arrive(&qempty[qb]);  // q is no longer read

      // The row sums over the four threads of each row, then o / l in bf16.
      // acc: rows r0 (4j + 0, 1) and r0 + 8 (4j + 2, 3), features 8j + c2 + (0, 1)
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int off = 1; off < 4; off *= 2) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
        inv[r] = 1.f / l[r];
      }
      __nv_bfloat16* ob = o + w.b * os.b + w.h * os.h;
#pragma unroll
      for (int jj = 0; jj < HDP / 8; ++jj) {
        const int col = 8 * jj + c2;
        if (col >= hd) continue;
        if (row0 < sq)
          *reinterpret_cast<uint32_t*>(ob + row0 * os.s + col) =
              pack_bf16(acc[4 * jj] * inv[0], acc[4 * jj + 1] * inv[0]);
        if (row1 < sq)
          *reinterpret_cast<uint32_t*>(ob + row1 * os.s + col) =
              pack_bf16(acc[4 * jj + 2] * inv[1], acc[4 * jj + 3] * inv[1]);
      }
    }
  }
}

// The plan of one map agrees with what the kernel loads: dims (hd, n, H, B)
// and a box of one 64-wide atom by `rows`
bool plan_matches(const long long* p, int B, int H, int n, int hd, int rows) {
  return p[0] == hd && p[1] == n && p[2] == H && p[3] == B && p[7] == kAtom && p[8] == rows &&
         p[9] == 1 && p[10] == 1;
}

template <int KS, bool kSeg>
cudaError_t launch(const void* const (&base)[3], const long long* plan, __nv_bfloat16* o,
                   Strides os, const int* q_seg, const int* kv_seg, int B, int H, int sq, int skv,
                   int hd, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<KS, kSeg>;
  constexpr int NA = (KS + 3) / 4;
  constexpr int kSmem = Smem<NA>::kBytes;
  static bool configured[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    err = encode_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base[i], 4, plan + kPlanLen * i);
    if (err != cudaSuccess) return err;
  }
  // Persistent: at most blocks_per_sm blocks an SM, each walking items
  // blockIdx.x, + gridDim.x, ...
  const long long items = (long long)((sq + q_tile(NA) - 1) / q_tile(NA)) * H * B;
  if (items > INT32_MAX) return cudaErrorInvalidValue;
  const int slots = sms[dev] * blocks_per_sm(NA);
  const int grid = (int)(items < slots ? items : slots);
  kernel<<<grid, threads(NA), kSmem, stream>>>(maps[0], maps[1], maps[2], o, os, q_seg, kv_seg,
                                               H, (int)items, sq, skv, hd, scale);
  return cudaGetLastError();
}

template <bool kSeg>
cudaError_t dispatch(const void* const (&base)[3], const long long* plan, __nv_bfloat16* o,
                     Strides os, const int* q_seg, const int* kv_seg, int B, int H, int sq,
                     int skv, int hd, float scale, cudaStream_t s) {
  switch ((hd + 15) / 16) {
    case 1: return launch<1, kSeg>(base, plan, o, os, q_seg, kv_seg, B, H, sq, skv, hd, scale, s);
    case 2: return launch<2, kSeg>(base, plan, o, os, q_seg, kv_seg, B, H, sq, skv, hd, scale, s);
    case 3: return launch<3, kSeg>(base, plan, o, os, q_seg, kv_seg, B, H, sq, skv, hd, scale, s);
    case 4: return launch<4, kSeg>(base, plan, o, os, q_seg, kv_seg, B, H, sq, skv, hd, scale, s);
    case 5: return launch<5, kSeg>(base, plan, o, os, q_seg, kv_seg, B, H, sq, skv, hd, scale, s);
    case 6: return launch<6, kSeg>(base, plan, o, os, q_seg, kv_seg, B, H, sq, skv, hd, scale, s);
    case 7: return launch<7, kSeg>(base, plan, o, os, q_seg, kv_seg, B, H, sq, skv, hd, scale, s);
    default: return launch<8, kSeg>(base, plan, o, os, q_seg, kv_seg, B, H, sq, skv, hd, scale, s);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error of the launch (0 = success).
// plan: the tensor maps of q, k and v in turn, 11 values each: dims (hd, S,
// H, B) (S = sq for q, skv for k and v), byte strides of dims 1-3, box (64,
// rows, 1, 1), rows the query block for q and 64 for k and v. ostrides: o's
// (batch, head, seq) element strides. q_seg (B, sq) and kv_seg (B, skv
// rounded up to 64) are both null (no segment ids) or both set.
int novic_flash_attention(const void* q, const void* k, const void* v, void* o, const void* q_seg,
                          const void* kv_seg, const long long* plan, const long long* ostrides,
                          int B, int H, int sq, int skv, int hd, float scale, void* stream) {
  if (B <= 0 || H <= 0 || sq <= 0 || skv <= 0 || hd <= 0 || hd > kMaxHd || hd % 8 != 0 ||
      plan == nullptr || ostrides == nullptr || (q_seg == nullptr) != (kv_seg == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!plan_matches(plan, B, H, sq, hd, q_tile(hd <= kAtom ? 1 : 2)) ||
      !plan_matches(plan + kPlanLen, B, H, skv, hd, kKTile) ||
      !plan_matches(plan + 2 * kPlanLen, B, H, skv, hd, kKTile))
    return (int)cudaErrorInvalidValue;
  const void* const base[3] = {q, k, v};
  const Strides os{ostrides[0], ostrides[1], ostrides[2]};
  auto* ob = static_cast<__nv_bfloat16*>(o);
  const auto* qsg = static_cast<const int*>(q_seg);
  const auto* ksg = static_cast<const int*>(kv_seg);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(q_seg ? dispatch<true>(base, plan, ob, os, qsg, ksg, B, H, sq, skv, hd, scale, s)
                     : dispatch<false>(base, plan, ob, os, qsg, ksg, B, H, sq, skv, hd, scale, s));
}

}  // extern "C"
