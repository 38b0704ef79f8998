// The backward of one-pass attention for Hopper (sm_90a): the dQ and dK/dV
// kernels of JAX's TPU flash-attention VJP (X6b).
//
// Replaces jax.experimental.pallas.ops.tpu.flash_attention's
// `_flash_attention_dq_kernel` (flash_attention.py:1146, launched at :1456)
// and `_flash_attention_dkv_kernel` (:796, launched at :1121), which
// `_flash_attention_bwd` (:254) runs after di = sum(o * do) (:273); here the
// dQ kernel computes di itself. Both recompute the scores from q, k, ab and
// the masks, and p from the forward's residuals (csrc/flash_attention.cu):
//   di = sum over hd of o * do in float32, per query row;
//   s  = (q.k^T + ab) * scale, + -0.7 * FLT_MAX once where the segment ids
//        differ or (causal) the key lies after the query;
//   p  = exp(s - m) * (1 / l); under causal a key a row does not visit
//        (key / 128 > row / 128, JAX's `below_or_on_diag` at blocks of 128)
//        gets p = 0;
//   dp = do.v^T; ds = (dp - di) * p * scale;
//   dQ kernel:    dq = bf16(ds).k summed over the keys in float32, stored as
//        bf16; where asked, ds itself as d(ab) in ab's dtype (zeros for the
//        keys a causal row does not visit, as JAX zeroes the blocks it
//        skips); and each row's m, 1 / l and di for the dK/dV kernel;
//   dK/dV kernel: dv = bf16(p)^T.do, dk = bf16(ds)^T.q, summed over the
//        queries in float32 and stored once as bf16.
//
// Layout: q, do, o (B, H, Sq, hd) and k, v (B, H, Skv, hd) bf16 views read
// through 4-D tensor maps (hd, S, H, B), every box one 64-wide atom by 64
// rows, whose byte strides the wrapper plans (`_bwd_plans` of
// ops/flash_attention.py, on `_tma_plan` of ops/attention_bf16.py): 16-byte
// aligned, hd contiguous, other strides multiples of 16 bytes; hd a multiple
// of 8, at most 128 (the maps zero-fill the atom past hd and the rows past
// S); any Sq, Skv >= 1. ab, when given, float32 or bf16 through a map (Skv,
// Sq, H, B) with a box of one 128-byte row of keys (32 float32 or 64 bf16)
// by 64 queries. The maps are encoded once a backward
// (`novic_flash_attention_bwd_maps`) and passed to both launches. l and m
// contiguous (B, H, Sq) float32; `stats` (B, H, Sq_pad, 4) float32 with
// Sq_pad = Sq rounded up to 64: m, 1 / l, di and 0 per query row (m = +inf
// and 1 / l = 0 past Sq, so those rows get p = 0), written by the dQ kernel
// and read by the dK/dV kernel a 64-row slice at a time by bulk copies.
// Segment ids, when given: int32 (B, Sq_pad) and (B, Skv_pad), padded to
// whole 64-row tiles. dq (B, H, Sq, hd), dk and dv (B, H, Skv, hd) and dab
// (B, H, Sq, Skv) are contiguous outputs.
//
// Design (Hopper), the forward's structure: persistent kernels, one block an
// SM, each walking work items; a block is two consumer warpgroups, each
// owning 64 rows of an item (128 queries in dQ, 128 keys in dK/dV), and a
// producer warpgroup whose one thread issues every load and gives its
// registers to the consumers (setmaxnreg: 240 a consumer thread). An item's
// own rows (q and do in dQ, k and v in dK/dV) land once by TMA in a resident
// buffer (two where shared memory holds two beside three stages, so the
// next item's land while this one runs); the other axis streams through a
// ring of as many stages as fit, up to 4 (2 at hd > 64 with a float32
// bias), each completed on a `full` mbarrier by its transaction bytes and
// released on an `empty` mbarrier by every consumer thread. Every product is a wgmma on
// 128-byte-swizzled tiles, and none needs a transposed A:
//   dQ: the item's o rides the ring as its first stage; each warpgroup takes
//     di for its rows from o and do in shared memory, writes the rows' m,
//     1 / l and di to `stats`, and releases o. A stage carries a 64-key tile
//     of k and v, the keys' segment ids (bulk copy) and the (128 queries x
//     64 keys) tile of ab. Per tile: S = q.k^T and dP = do.v^T by wgmma
//     m64n64k16 (both operands K-major from shared memory); p and ds in
//     registers, where the accumulator layout is the register A operand's;
//     d(ab) stored from the registers; dQ += bf16(dS).k by wgmma
//     m64n{hd}k16 in its RS form, k the MN-major B operand (the forward's
//     P.v). A tile's S and dP are issued together with the previous tile's
//     dQ product, so one wait covers the three.
//   dK/dV: a stage carries a 64-query tile of q and do, the queries' m, 1 /
//     l and di (one bulk copy of `stats`), their segment ids and the (64
//     queries x 128 keys) tile of ab. Per tile each warpgroup computes the
//     transposed scores, its 64 keys as wgmma's rows: S^T = k.q^T and dP^T =
//     v.do^T (K-major over hd: the same tiles the next two products read
//     MN-major), P^T and dS^T in registers, then dV += bf16(P^T).do and dK
//     += bf16(dS^T).q in the RS form, do and q the MN-major B operands. Up to
//     hd 64 (80 without a bias) a tile's S^T and dP^T are issued with the
//     previous tile's dV and dK; above, dK and dV alone take 96-128
//     registers, so the products follow one another, over 32-query parts
//     of the stage from hd 112 (96 with a bias), 16-query parts at hd 128
//     with a bias.
// The resident rows are released after the item's last S and dP, before its
// last exps, products and stores, so the next item's rows land meanwhile. No
// load is issued after a wgmma wait: every tile arrives with its stage. No
// instruction writes an accumulator while a wgmma that writes it is in
// flight (the accumulators start at zero and every product adds). Causal,
// the bias and the segment ids are template flags: a launch without them
// carries no per-score work for them. Under causal, items walk only the
// tiles their 128-row causal blocks reach (dQ up to its last row's block,
// dK/dV from its first key's block on), and only the tiles that cross the
// item's diagonal apply the key <= query mask and the visited rule (a test
// that ptxas can see is uniform: one on the warpgroup's own rows made it
// serialise the wgmmas of every causal instance). Keys
// past Skv (zero-filled k and v) and queries past Sq (p = 0 by their stats)
// add nothing and are never stored. dq, dk and dv are stored from the
// registers as bf16 pairs.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): seven Sq x Skv x hd
// products (S, dP, dQ in the first kernel, S, dP, dV, dK in the second),
// 14*B*H*Sq*Skv*hd operations (halved under causal), against q, k, v, do, o,
// dq, dk and dv in bf16 and l and m in float32, read or written once (plus
// ab and dab where given): at the DFN5B harness's (32, 16, 768, 80) 338
// GFLOP, 0.342 ms, operations bound it; at attn_variants' (256, 12, 256, 64)
// 180 GFLOP, 0.182 ms, against 812 MB, 0.242 ms: bytes. Recomputing the
// scores in both kernels costs 2 of the 7 products, as in JAX; the 2 *
// B*H*Sq*Skv exps take about 0.15 ms of the MUFU unit at the first shape,
// which the other warpgroup's products overlap.
//
// Tolerance against the plain version (ops/flash_attention.py
// `flash_attention_bwd_reference`): products of bf16 values are exact in
// float32; sums run in another order and exp differs in its last bits, so a
// bf16 rounding of p or ds can land one ulp (2^-8 relative) apart, which
// moves a gradient by at most 2^-7 of the largest term it sums.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>
#include <string.h>
#include <math.h>

#include "hopper_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kSmemMax = 232448;    // shared memory a block can have
constexpr int kTile = 64;           // rows of a box, of a stage's tile and of a warpgroup
constexpr int kConsumers = 2;       // consumer warpgroups a block
constexpr int kOwn = kConsumers * kTile;  // rows an item owns: queries (dQ) or keys (dK/dV)
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kCausalBlock = 128;   // the causal skip's blocks (CAUSAL_BLOCK)
constexpr int kAtom = 64;           // bf16 per 128-byte swizzled row
constexpr int kBox = kTile * 128;   // bytes of one box: 64 rows of 128 bytes
constexpr int kMaxHd = 128;
constexpr int kMaxDevices = 64;
constexpr int kProducerRegs = 24;   // setmaxnreg of the producer warpgroup
constexpr int kConsumerRegs = (kThreads * (65536 / kThreads / 8 * 8) - 128 * kProducerRegs) /
                              (128 * kConsumers) / 8 * 8;
constexpr int kMaps = 6;            // q, k, v, do, o, ab
constexpr int kPlanLen = 11;        // per map: 4 dims, 3 strides, 4 box
constexpr float kLog2e = 1.4426950408889634f;
// flash_attention.py DEFAULT_MASK_VALUE: the product in double, then float32
constexpr float kMaskValue = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));
static_assert(kOwn == kCausalBlock, "an item's rows are one causal block");
static_assert(kConsumerRegs == 240, "the consumers' register budget");

enum Map { kQ = 0, kK, kV, kDo, kO, kAb };

// Shared memory of a kernel (kDq: the dQ kernel) for hd in NA atoms and a
// bias of AB bytes an element: the resident buffers (two tensors of NA atoms
// of kOwn rows), the ring's stages (two tensors of NA atoms of 64 rows, then
// AB boxes of the bias), each stage's side data (the 64 rows' segment ids;
// in dK/dV first the rows' stats), the barriers, 1024 bytes of alignment
template <int NA, int AB, bool kDq>
struct Smem {
  static constexpr int kResBytes = 2 * NA * kOwn * 128;
  static constexpr int kTileBytes = NA * kBox;  // one tensor of a stage
  static constexpr int kStageBytes = 2 * kTileBytes + AB * kBox;
  static constexpr int kSegBytes = kTile * 4;
  static constexpr int kStatBytes = kDq ? 0 : kTile * 16;
  static constexpr int kSideBytes = kStatBytes + kSegBytes;
  static constexpr int kPerStage = kStageBytes + kSideBytes + 2 * 8;
  // Two resident buffers where three stages still fit beside them
  static constexpr int kResBufs =
      2 * kResBytes + 3 * kPerStage + 4 * 8 + 1024 <= kSmemMax ? 2 : 1;
  static constexpr int kFit = (kSmemMax - kResBufs * kResBytes - 2 * kResBufs * 8 - 1024) /
                              kPerStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSideOffset = kResBufs * kResBytes + kStages * kStageBytes;
  static constexpr int kBarOffset = kSideOffset + kStages * kSideBytes;
  static constexpr int kBytes = kBarOffset + (2 * kStages + 2 * kResBufs) * 8 + 1024;
  static_assert(kStages >= 2 && kBytes <= kSmemMax, "shared memory");
  // The dQ kernel's o (NA atoms of kOwn rows) rides a stage
  static_assert(!kDq || 2 * kTileBytes == NA * kOwn * 128, "o fits a stage");
};

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A block's work item: (row block, head, batch), row blocks fastest so that
// the blocks running together share their heads' tensors in L2
struct Item {
  int r0, h, b;
  __device__ Item(int item, int n, int H) : r0((item % n) * kOwn), h((item / n) % H), b(item / n / H) {}
};

// The 64-key tiles a dQ item of queries [q0, q0 + kOwn) walks: all of them,
// or under causal those up to the end of the causal block of its last row
__device__ __forceinline__ int dq_tiles(int q0, int sq, int ntiles, bool causal) {
  if (!causal) return ntiles;
  const int last = min(q0 + kOwn, sq) - 1;
  return min(ntiles, (last / kCausalBlock + 1) * (kCausalBlock / kTile));
}

// The first query a dK/dV item of keys [k0, k0 + kOwn) walks from (under
// causal, the first of the keys' causal block), and its 64-query tiles
__device__ __forceinline__ int dkv_first(int k0, bool causal) { return causal ? k0 : 0; }
__device__ __forceinline__ int dkv_tiles(int k0, int sq, bool causal) {
  const int q0 = dkv_first(k0, causal);
  return q0 < sq ? (sq - q0 + kTile - 1) / kTile : 0;
}

// Where a bias element lies in boxes of 64 rows of 128 bytes (32 float32 or
// 64 bf16 keys), 16-byte chunks swizzled by (row % 8) as a B128 TMA load
// lands them; `key` counts from the first box
template <int AB>
__device__ __forceinline__ const uint8_t* bias_ptr(const uint8_t* tab, int row, int key) {
  constexpr int kKeys = 128 / AB;
  const int col = (key % kKeys) * AB;  // byte in the box's row
  return tab + (key / kKeys) * kBox + row * 128 + ((((col >> 4) ^ (row & 7))) << 4) + (col & 15);
}

// Two neighbouring keys' bias (key even) for a row
template <int AB>
__device__ __forceinline__ float2 bias_pair(const uint8_t* tab, int row, int key) {
  const uint8_t* p = bias_ptr<AB>(tab, row, key);
  if constexpr (AB == 4) {
    return *reinterpret_cast<const float2*>(p);
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
}

// One element of the bias
template <int AB>
__device__ __forceinline__ float bias_at(const uint8_t* tab, int row, int key) {
  const uint8_t* p = bias_ptr<AB>(tab, row, key);
  if constexpr (AB == 4) {
    return *reinterpret_cast<const float*>(p);
  } else {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  }
}

// di of one row of the dQ item's tiles: the sum over the NA atoms of o * do,
// this thread's 16 columns an atom, then over the row's four threads
template <int NA>
__device__ __forceinline__ float row_dot(const uint8_t* o, const uint8_t* d_o, int row, int c2) {
  float acc = 0.f;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int off = a * kOwn * 128 + row * 128 + ((j ^ (row & 7)) << 4) + c2 * 2;
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + off));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d_o + off));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// p of one score as the plain version takes it: x the float32 q.k (+ ab),
// its row's m and 1 / l; `keep` false adds the mask value; `visited` false
// gives 0
__device__ __forceinline__ float prob(float x, float scale, bool masks, bool keep, bool visited,
                                      float m, float inv_l) {
  x *= scale;
  if (masks) x += keep ? 0.f : kMaskValue;
  const float p = ex2((x - m) * kLog2e) * inv_l;
  return visited ? p : 0.f;
}

// The output rows of a warpgroup's accumulator as bf16 pairs: rows r0 (4j +
// 0, 1) and r0 + 8 (4j + 2, 3), features 8j + c2 + (0, 1); rows at or past
// `rows` and features at or past hd are not stored
template <int R>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[R],
                                           const int (&row)[2], int rows, int hd, int c2) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int col = 8 * j + c2;
    if (col >= hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < rows)
        *reinterpret_cast<uint32_t*>(out + (long long)row[r] * hd + col) =
            pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

struct Dims {
  int H, sq, skv, hd, sq_pad, skv_pad;
  float scale;
};

// ---- dQ -----------------------------------------------------------------------

// What a dQ warpgroup's rows carry through an item
struct DqRows {
  int row[2];   // the thread's rows in the sequence
  int lrow[2];  // and in its warpgroup's 64
  int qseg[2];
  float m[2], inv_l[2], di[2];
};

// A tile's p and ds from S and dP (this warpgroup's 64 rows x 64 keys from
// key0), d(ab) stored where asked, bf16(ds) packed as four A operands of 16
// keys: a0 row r0 keys 2c.., a1 row r0 + 8, a2 / a3 keys 8 + 2c..
template <bool kSeg, int AB, bool kDiag>
__device__ __forceinline__ void dq_scores(const float (&s)[32], const float (&dp)[32],
                                          uint32_t (&ds)[4][4], const DqRows& w,
                                          const uint8_t* tab, const int* tseg, int key0, int c2,
                                          const Dims& d, void* dab, long long dab0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * kk + 2 * e, r = e & 1;
      const int key = 8 * (2 * kk + (e >> 1)) + c2;  // keys key, key + 1 in the tile
      float2 bias = make_float2(0.f, 0.f);
      if constexpr (AB != 0) bias = bias_pair<AB>(tab, w.lrow[r], key);
      int2 ks = make_int2(0, 0);
      if constexpr (kSeg) ks = *reinterpret_cast<const int2*>(tseg + key);
      float g[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int kg = key0 + key + x;
        bool keep = true, visited = true;
        if constexpr (kSeg) keep = (x ? ks.y : ks.x) == w.qseg[r];
        if constexpr (kDiag) {
          keep = keep && kg <= w.row[r];
          visited = kg / kCausalBlock <= w.row[r] / kCausalBlock;
        }
        const float p = prob(s[i + x] + (x ? bias.y : bias.x), d.scale, kSeg || kDiag, keep,
                             visited, w.m[r], w.inv_l[r]);
        g[x] = (dp[i + x] - w.di[r]) * p * d.scale;
      }
      if constexpr (AB != 0) {
        if (dab != nullptr && w.row[r] < d.sq) {
          const int kg = key0 + key;
          const long long o = dab0 + (long long)w.row[r] * d.skv + kg;
          if constexpr (AB == 4) {
            float* dst = static_cast<float*>(dab) + o;
            if ((d.skv & 1) == 0 && kg + 1 < d.skv) {
              *reinterpret_cast<float2*>(dst) = make_float2(g[0], g[1]);
            } else {
              if (kg < d.skv) dst[0] = g[0];
              if (kg + 1 < d.skv) dst[1] = g[1];
            }
          } else {
            __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(dab) + o;
            if ((d.skv & 1) == 0 && kg + 1 < d.skv) {
              *reinterpret_cast<uint32_t*>(dst) = pack_bf16(g[0], g[1]);
            } else {
              if (kg < d.skv) dst[0] = __float2bfloat16_rn(g[0]);
              if (kg + 1 < d.skv) dst[1] = __float2bfloat16_rn(g[1]);
            }
          }
        }
      }
      ds[kk][e] = pack_bf16(g[0], g[1]);
    }
}

template <int KS, bool kSeg, int AB, bool kCausal>  // KS = hd / 16, rounded up
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const __grid_constant__ CUtensorMap omap,
                    const __grid_constant__ CUtensorMap abmap, const float* __restrict__ lse_l,
                    const float* __restrict__ lse_m, const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg, float4* __restrict__ stats,
                    __nv_bfloat16* __restrict__ dq_out, void* __restrict__ dab, Dims d,
                    int items) {
  constexpr int NA = (KS + 3) / 4;  // 64-wide atoms of a row
  constexpr int HDP = 16 * KS;      // the dQ product's N
  using L = Smem<NA, AB, true>;
  constexpr int kStages = L::kStages, kResBufs = L::kResBufs;
  constexpr int kAbPerRows = AB / 2;  // bias boxes of a 64-key tile for 64 rows
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* rfull = empty + kStages;  // kResBufs resident buffers
  uint64_t* rempty = rfull + kResBufs;
  const int wg = threadIdx.x / 128;
  const int nq = (d.sq + kOwn - 1) / kOwn;
  const int ntiles = (d.skv + kTile - 1) / kTile;
  auto stage = [&](int it) { return smem + kResBufs * L::kResBytes + (it % kStages) * L::kStageBytes; };
  auto side = [&](int it) { return smem + L::kSideOffset + (it % kStages) * L::kSideBytes; };
  auto parity = [](int it) { return (uint32_t)(it / kStages) & 1; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    for (int i = 0; i < kResBufs; ++i) {
      mbar_init(&rfull[i], 1);
      mbar_init(&rempty[i], 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every load, running ahead ----
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      prefetch_map(&domap);
      prefetch_map(&omap);
      if (AB) prefetch_map(&abmap);
      int it = 0;
      for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
        const Item w(item, nq, d.H);
        const int rb = n % kResBufs;
        uint8_t* res = smem + rb * L::kResBytes;
        mbar_wait(&rempty[rb], ((n / kResBufs) & 1) ^ 1);
        mbar_arrive_expect_tx(&rfull[rb], L::kResBytes);
        for (int a = 0; a < NA; ++a)
          for (int x = 0; x < kConsumers; ++x) {
            const int off = a * kOwn * 128 + x * kBox;
            tma_load_4d(res + off, &qmap, &rfull[rb], a * kAtom, w.r0 + x * kTile, w.h, w.b);
            tma_load_4d(res + NA * kOwn * 128 + off, &domap, &rfull[rb], a * kAtom,
                        w.r0 + x * kTile, w.h, w.b);
          }
        // o, for di, rides the ring as the item's first stage
        mbar_wait(&empty[it % kStages], parity(it) ^ 1);
        mbar_arrive_expect_tx(&full[it % kStages], NA * kOwn * 128);
        for (int a = 0; a < NA; ++a)
          for (int x = 0; x < kConsumers; ++x)
            tma_load_4d(stage(it) + a * kOwn * 128 + x * kBox, &omap, &full[it % kStages],
                        a * kAtom, w.r0 + x * kTile, w.h, w.b);
        ++it;
        const int tiles = dq_tiles(w.r0, d.sq, ntiles, kCausal);
        for (int t = 0; t < tiles; ++t, ++it) {
          const int key0 = t * kTile;
          uint64_t* bar = &full[it % kStages];
          mbar_wait(&empty[it % kStages], parity(it) ^ 1);
          uint8_t* st = stage(it);
          mbar_arrive_expect_tx(bar, L::kStageBytes + (kSeg ? L::kSegBytes : 0));
          for (int a = 0; a < NA; ++a) {
            tma_load_4d(st + a * kBox, &kmap, bar, a * kAtom, key0, w.h, w.b);
            tma_load_4d(st + L::kTileBytes + a * kBox, &vmap, bar, a * kAtom, key0, w.h, w.b);
          }
          for (int x = 0; x < AB; ++x) {  // boxes [rows / 64][keys / (128 / AB)]
            const int half = x / (kAbPerRows > 0 ? kAbPerRows : 1);
            const int chunk = x % (kAbPerRows > 0 ? kAbPerRows : 1);
            tma_load_4d(st + 2 * L::kTileBytes + x * kBox, &abmap, bar,
                        key0 + chunk * (128 / (AB ? AB : 1)), w.r0 + half * kTile, w.h, w.b);
          }
          if (kSeg)
            bulk_load(side(it), kv_seg + (long long)w.b * d.skv_pad + key0, L::kSegBytes, bar);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns queries [r0 + 64 wg, +64) of each item ----
    regs_alloc<kConsumerRegs>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = 16 * (t / 32) + lane / 4;  // this thread's rows r0, r0 + 8 of the 64
    const int c2 = 2 * (lane % 4);            // its first column in each n8 block
    int it = 0;
    for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
      const Item w(item, nq, d.H);
      const int rb = n % kResBufs;
      const long long bh = (long long)w.b * d.H + w.h;
      DqRows rows;
      for (int r = 0; r < 2; ++r) {
        rows.lrow[r] = r0 + 8 * r;
        const int row = w.r0 + wg * kTile + rows.lrow[r];
        const bool ok = row < d.sq;
        rows.row[r] = row;
        rows.m[r] = ok ? lse_m[bh * d.sq + row] : INFINITY;
        rows.inv_l[r] = ok ? 1.f / lse_l[bh * d.sq + row] : 0.f;
        rows.qseg[r] = kSeg && ok ? q_seg[(long long)w.b * d.sq_pad + row] : 0;
      }
      const uint8_t* res = smem + rb * L::kResBytes;
      mbar_wait(&rfull[rb], (n / kResBufs) & 1);
      // di from o (this item's first stage) and do, then the rows' stats
      mbar_wait(&full[it % kStages], parity(it));
      for (int r = 0; r < 2; ++r)
        rows.di[r] = row_dot<NA>(stage(it), res + NA * kOwn * 128, wg * kTile + rows.lrow[r], c2);
      mbar_arrive(&empty[it % kStages]);
      ++it;
      if (c2 == 0)
        for (int r = 0; r < 2; ++r)
          if (rows.row[r] < d.sq_pad)
            stats[bh * d.sq_pad + rows.row[r]] =
                make_float4(rows.m[r], rows.inv_l[r], rows.di[r], 0.f);

      const int tiles = dq_tiles(w.r0, d.sq, ntiles, kCausal);
      const uint32_t qa = smem_addr(res) + wg * kBox, da = qa + NA * kOwn * 128;
      const long long dab0 = bh * d.sq * (long long)d.skv;
      float acc[HDP / 2];
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
      uint32_t ds[4][4];  // the previous tile's bf16(dS)
      for (int tile = 0; tile <= tiles; ++tile) {
        const bool has_s = tile < tiles, has_dq = tile > 0;
        if (has_s) mbar_wait(&full[(it + tile) % kStages], parity(it + tile));
        float s[32], dp[32];
        fence_regs(acc);
        wgmma_fence();
        if (has_s) {
          const uint32_t kb = smem_addr(stage(it + tile)), vb = kb + L::kTileBytes;
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            const uint32_t off = (kk / 4) * kOwn * 128 + (kk % 4) * 32;
            const uint32_t boff = (kk / 4) * kBox + (kk % 4) * 32;
            wgmma_ss<kTile, 0>(s, desc_b128(qa + off, 16, 1024), desc_b128(kb + boff, 16, 1024),
                               kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            const uint32_t off = (kk / 4) * kOwn * 128 + (kk % 4) * 32;
            const uint32_t boff = (kk / 4) * kBox + (kk % 4) * 32;
            wgmma_ss<kTile, 0>(dp, desc_b128(da + off, 16, 1024), desc_b128(vb + boff, 16, 1024),
                               kk > 0);
          }
        }
        if (has_dq) {  // the previous tile's dQ += bf16(dS).k, k MN-major
          const uint32_t kb = smem_addr(stage(it + tile - 1));
#pragma unroll
          for (int kk = 0; kk < kTile / 16; ++kk)
            wgmma_rs<HDP>(acc, ds[kk], desc_b128(kb + kk * 16 * 128, kBox, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        fence_regs(acc);
        if (has_dq) mbar_arrive(&empty[(it + tile - 1) % kStages]);  // k, v no longer read
        if (!has_s) break;
        if (tile == tiles - 1) mbar_arrive(&rempty[rb]);  // q and do no longer read

        const int key0 = tile * kTile;
        if (key0 + kTile > d.skv) {  // keys past skv (zero-filled k and v) get p = 0
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if (key0 + 8 * (i / 4) + c2 + (i & 1) >= d.skv) s[i] = -INFINITY;
        }
        const uint8_t* tab = stage(it + tile) + 2 * L::kTileBytes + wg * kAbPerRows * kBox;
        const int* tseg = reinterpret_cast<const int*>(side(it + tile));
        // Tiles that cross the item's diagonal (a uniform test: one that
        // depends on the warpgroup makes ptxas serialise the wgmmas)
        if (kCausal && key0 + kTile - 1 > w.r0)
          dq_scores<kSeg, AB, true>(s, dp, ds, rows, tab, tseg, key0, c2, d, dab, dab0);
        else
          dq_scores<kSeg, AB, false>(s, dp, ds, rows, tab, tseg, key0, c2, d, dab, dab0);
      }
      it += tiles;
      // d(ab) is 0 past the keys walked: keys no row of the item visits
      if (kCausal && AB != 0 && dab != nullptr && tiles * kTile < d.skv) {
        const int kz = tiles * kTile, cols = d.skv - kz;
        const int row0 = w.r0 + wg * kTile, nrows = min(kTile, d.sq - row0);
        for (int i = t; i < nrows * cols; i += 128) {
          const long long o = dab0 + (long long)(row0 + i / cols) * d.skv + kz + i % cols;
          if (AB == 4)
            static_cast<float*>(dab)[o] = 0.f;
          else
            static_cast<__nv_bfloat16*>(dab)[o] = __float2bfloat16_rn(0.f);
        }
      }
      store_rows(dq_out + bh * d.sq * d.hd, acc, rows.row, d.sq, d.hd, c2);
    }
  }
}

// ---- dK/dV ----------------------------------------------------------------------

// What a dK/dV warpgroup's keys carry through an item
struct DkvRows {
  int key[2];   // the thread's keys in the sequence
  int lkey[2];  // and in the item's 128
  int kseg[2];
};

// P^T and dS^T from S^T and dP^T (this warpgroup's 64 keys x N queries
// from q_off of the stage's 64, the stage's first query q0), packed as bf16
// A operands of 16 queries; the queries' m, 1 / l and di from the stage's
// stats, their segment ids and the bias
template <bool kSeg, int AB, bool kDiag, int N>
__device__ __forceinline__ void dkv_scores(const float (&st)[N / 2], const float (&dpt)[N / 2],
                                           uint32_t (&pp)[N / 16][4], uint32_t (&dd)[N / 16][4],
                                           const DkvRows& w, const float4* stat, const int* qseg,
                                           const uint8_t* tab, int q_off, int q0, int c2,
                                           float scale) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * kk + 2 * e, r = e & 1;
      const int q = q_off + 8 * (2 * kk + (e >> 1)) + c2;  // queries q, q + 1 in the stage
      int2 qs = make_int2(0, 0);
      if constexpr (kSeg) qs = *reinterpret_cast<const int2*>(qseg + q);
      float p[2], g[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        // m and 1 / l, then di (not the record's fourth word: a register less a query)
        const float2 ml = *reinterpret_cast<const float2*>(stat + q + x);
        const float di = reinterpret_cast<const float*>(stat + q + x)[2];
        const int qg = q0 + q + x;
        float v = st[i + x];
        if constexpr (AB != 0) v += bias_at<AB>(tab, q + x, w.lkey[r]);
        bool keep = true, visited = true;
        if constexpr (kSeg) keep = (x ? qs.y : qs.x) == w.kseg[r];
        if constexpr (kDiag) {
          keep = keep && w.key[r] <= qg;
          visited = w.key[r] / kCausalBlock <= qg / kCausalBlock;
        }
        p[x] = prob(v, scale, kSeg || kDiag, keep, visited, ml.x, ml.y);
        g[x] = (dpt[i + x] - di) * p[x] * scale;
      }
      pp[kk][e] = pack_bf16(p[0], p[1]);
      dd[kk][e] = pack_bf16(g[0], g[1]);
    }
}

// S^T = k.q^T and dP^T = v.do^T for a warpgroup's 64 keys (k and v at ka,
// va: NA atoms of kOwn rows) and N queries (q and do at qb, db: NA atoms of
// 64 rows), both operands K-major over hd
template <int KS, int N>
__device__ __forceinline__ void dkv_products_s(float (&st)[N / 2], float (&dpt)[N / 2],
                                               uint32_t ka, uint32_t va, uint32_t qb,
                                               uint32_t db) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t off = (kk / 4) * kOwn * 128 + (kk % 4) * 32;
    const uint32_t boff = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_ss<N, 0>(st, desc_b128(ka + off, 16, 1024), desc_b128(qb + boff, 16, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t off = (kk / 4) * kOwn * 128 + (kk % 4) * 32;
    const uint32_t boff = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_ss<N, 0>(dpt, desc_b128(va + off, 16, 1024), desc_b128(db + boff, 16, 1024), kk > 0);
  }
}

// dV += bf16(P^T).do and dK += bf16(dS^T).q over N queries, do and q at db,
// qb the MN-major B operands
template <int HDP, int N>
__device__ __forceinline__ void dkv_products_kv(float (&dk)[HDP / 2], float (&dv)[HDP / 2],
                                                const uint32_t (&pp)[N / 16][4],
                                                const uint32_t (&dd)[N / 16][4], uint32_t qb,
                                                uint32_t db) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_rs<HDP>(dv, pp[kk], desc_b128(db + kk * 16 * 128, kBox, 1024), 1);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_rs<HDP>(dk, dd[kk], desc_b128(qb + kk * 16 * 128, kBox, 1024), 1);
}

template <int KS, bool kSeg, int AB, bool kCausal>  // KS = hd / 16, rounded up
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap domap,
                     const __grid_constant__ CUtensorMap abmap, const float4* __restrict__ stats,
                     const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                     __nv_bfloat16* __restrict__ dk_out, __nv_bfloat16* __restrict__ dv_out,
                     Dims d, int items) {
  constexpr int NA = (KS + 3) / 4;
  constexpr int HDP = 16 * KS;  // the dV and dK products' N
  using L = Smem<NA, AB, false>;
  constexpr int kStages = L::kStages, kResBufs = L::kResBufs;
  // Registers: dK and dV take HDP. Up to hd 64 (80 without a bias) a
  // tile's S^T and dP^T (64) are issued with the previous tile's dV and dK,
  // whose operands (32) stay live; above, a tile's products follow one
  // another, and from hd 112 (96 with a bias) over 32-query parts of the
  // stage (kQn), 16-query parts at hd 128 with a bias, so that no instance
  // spills
  constexpr int kQn = HDP >= 128 && AB != 0                 ? 16
                      : HDP >= 112 || (HDP >= 96 && AB != 0) ? 32
                                                              : kTile;
  constexpr bool kMerged = kQn == kTile && (HDP <= 64 || (HDP <= 80 && AB == 0));
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* rfull = empty + kStages;
  uint64_t* rempty = rfull + kResBufs;
  const int wg = threadIdx.x / 128;
  const int nk = (d.skv + kOwn - 1) / kOwn;
  auto stage = [&](int it) { return smem + kResBufs * L::kResBytes + (it % kStages) * L::kStageBytes; };
  auto side = [&](int it) { return smem + L::kSideOffset + (it % kStages) * L::kSideBytes; };
  auto parity = [](int it) { return (uint32_t)(it / kStages) & 1; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    for (int i = 0; i < kResBufs; ++i) {
      mbar_init(&rfull[i], 1);
      mbar_init(&rempty[i], 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      prefetch_map(&domap);
      if (AB) prefetch_map(&abmap);
      int it = 0, nr = 0;  // ring slots; items that load their keys
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Item w(item, nk, d.H);
        const int tiles = dkv_tiles(w.r0, d.sq, kCausal);
        if (tiles == 0) continue;  // no query reaches these keys: dk = dv = 0
        const int rb = nr % kResBufs;
        uint8_t* res = smem + rb * L::kResBytes;
        mbar_wait(&rempty[rb], ((nr / kResBufs) & 1) ^ 1);
        mbar_arrive_expect_tx(&rfull[rb], L::kResBytes);
        for (int a = 0; a < NA; ++a)
          for (int x = 0; x < kConsumers; ++x) {
            const int off = a * kOwn * 128 + x * kBox;
            tma_load_4d(res + off, &kmap, &rfull[rb], a * kAtom, w.r0 + x * kTile, w.h, w.b);
            tma_load_4d(res + NA * kOwn * 128 + off, &vmap, &rfull[rb], a * kAtom,
                        w.r0 + x * kTile, w.h, w.b);
          }
        ++nr;
        const long long bh = (long long)w.b * d.H + w.h;
        const int first = dkv_first(w.r0, kCausal);
        for (int t = 0; t < tiles; ++t, ++it) {
          const int q0 = first + t * kTile;
          uint64_t* bar = &full[it % kStages];
          mbar_wait(&empty[it % kStages], parity(it) ^ 1);
          uint8_t* st = stage(it);
          mbar_arrive_expect_tx(bar, L::kStageBytes + L::kStatBytes + (kSeg ? L::kSegBytes : 0));
          for (int a = 0; a < NA; ++a) {
            tma_load_4d(st + a * kBox, &qmap, bar, a * kAtom, q0, w.h, w.b);
            tma_load_4d(st + L::kTileBytes + a * kBox, &domap, bar, a * kAtom, q0, w.h, w.b);
          }
          for (int x = 0; x < AB; ++x)  // boxes [keys / (128 / AB)] of 64 queries
            tma_load_4d(st + 2 * L::kTileBytes + x * kBox, &abmap, bar,
                        w.r0 + x * (128 / (AB ? AB : 1)), q0, w.h, w.b);
          bulk_load(side(it), stats + bh * d.sq_pad + q0, L::kStatBytes, bar);
          if (kSeg)
            bulk_load(side(it) + L::kStatBytes, q_seg + (long long)w.b * d.sq_pad + q0,
                      L::kSegBytes, bar);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys [r0 + 64 wg, +64) of each item ----
    regs_alloc<kConsumerRegs>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = 16 * (t / 32) + lane / 4;
    const int c2 = 2 * (lane % 4);
    int it = 0, nr = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Item w(item, nk, d.H);
      const int tiles = dkv_tiles(w.r0, d.sq, kCausal);
      const long long bh = (long long)w.b * d.H + w.h;
      DkvRows keys;
      for (int r = 0; r < 2; ++r) {
        keys.lkey[r] = wg * kTile + r0 + 8 * r;
        keys.key[r] = w.r0 + keys.lkey[r];
        keys.kseg[r] = kSeg && keys.key[r] < d.skv_pad
                           ? kv_seg[(long long)w.b * d.skv_pad + keys.key[r]] : 0;
      }
      float dk[HDP / 2], dv[HDP / 2];
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) dk[i] = dv[i] = 0.f;
      if (tiles > 0) {
        const int rb = nr % kResBufs;
        const uint8_t* res = smem + rb * L::kResBytes;
        mbar_wait(&rfull[rb], (nr / kResBufs) & 1);
        const uint32_t ka = smem_addr(res) + wg * kBox, va = ka + NA * kOwn * 128;
        const int first = dkv_first(w.r0, kCausal);
        // The scores of a stage's queries [h kQn, +kQn): the diagonal test is
        // uniform (one on the warpgroup's keys makes ptxas serialise the wgmmas)
        auto scores = [&](const float (&st)[kQn / 2], const float (&dpt)[kQn / 2],
                          uint32_t (&pp)[kQn / 16][4], uint32_t (&dd)[kQn / 16][4], int slot,
                          int h, int q0) {
          const uint8_t* sd = side(slot);
          const float4* stat = reinterpret_cast<const float4*>(sd);
          const int* qseg = reinterpret_cast<const int*>(sd + L::kStatBytes);
          const uint8_t* tab = stage(slot) + 2 * L::kTileBytes;
          if (kCausal && w.r0 + kOwn - 1 > q0)  // the stage crosses the item's diagonal
            dkv_scores<kSeg, AB, true, kQn>(st, dpt, pp, dd, keys, stat, qseg, tab, h * kQn, q0,
                                            c2, d.scale);
          else
            dkv_scores<kSeg, AB, false, kQn>(st, dpt, pp, dd, keys, stat, qseg, tab, h * kQn,
                                             q0, c2, d.scale);
        };
        uint32_t pp[kQn / 16][4], dd[kQn / 16][4];  // bf16(P^T) and bf16(dS^T)
        if constexpr (kMerged) {
          // A tile's S^T and dP^T with the previous tile's dV and dK, one wait
          for (int tile = 0; tile <= tiles; ++tile) {
            const bool has_s = tile < tiles, has_kv = tile > 0;
            if (has_s) mbar_wait(&full[(it + tile) % kStages], parity(it + tile));
            float st[kQn / 2], dpt[kQn / 2];
            fence_regs(dk);
            fence_regs(dv);
            wgmma_fence();
            if (has_s) {
              const uint32_t qb = smem_addr(stage(it + tile));
              dkv_products_s<KS, kQn>(st, dpt, ka, va, qb, qb + L::kTileBytes);
            }
            if (has_kv) {
              const uint32_t qb = smem_addr(stage(it + tile - 1));
              dkv_products_kv<HDP, kQn>(dk, dv, pp, dd, qb, qb + L::kTileBytes);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(st);
            fence_regs(dpt);
            fence_regs(dk);
            fence_regs(dv);
            if (has_kv) mbar_arrive(&empty[(it + tile - 1) % kStages]);  // q, do no longer read
            if (!has_s) break;
            if (tile == tiles - 1) mbar_arrive(&rempty[rb]);  // k and v no longer read
            scores(st, dpt, pp, dd, it + tile, 0, first + tile * kTile);
          }
        } else {
          // Each product waited for at once, over the stage's kTile / kQn parts
          for (int tile = 0; tile < tiles; ++tile) {
            mbar_wait(&full[(it + tile) % kStages], parity(it + tile));
            for (int h = 0; h < kTile / kQn; ++h) {
              const uint32_t qb = smem_addr(stage(it + tile)) + h * kQn * 128;
              float st[kQn / 2], dpt[kQn / 2];
              wgmma_fence();
              dkv_products_s<KS, kQn>(st, dpt, ka, va, qb, qb + L::kTileBytes);
              wgmma_commit();
              wgmma_wait<0>();
              fence_regs(st);
              fence_regs(dpt);
              if (tile == tiles - 1 && h == kTile / kQn - 1)
                mbar_arrive(&rempty[rb]);  // k and v no longer read
              scores(st, dpt, pp, dd, it + tile, h, first + tile * kTile);
              fence_regs(dk);
              fence_regs(dv);
              wgmma_fence();
              dkv_products_kv<HDP, kQn>(dk, dv, pp, dd, qb, qb + L::kTileBytes);
              wgmma_commit();
              wgmma_wait<0>();
              fence_regs(dk);
              fence_regs(dv);
            }
            mbar_arrive(&empty[(it + tile) % kStages]);  // q, do no longer read
          }
        }
        it += tiles;
        ++nr;
      }
      store_rows(dk_out + bh * d.skv * d.hd, dk, keys.key, d.skv, d.hd, c2);
      store_rows(dv_out + bh * d.skv * d.hd, dv, keys.key, d.skv, d.hd, c2);
    }
  }
}

// ---- launch -------------------------------------------------------------------

// The plan of one map agrees with what the kernels load: dims (d0, n, H, B)
// and a box of `box0` by 64 rows
bool plan_matches(const long long* p, int B, int H, int n, int d0, int box0) {
  return p[0] == d0 && p[1] == n && p[2] == H && p[3] == B && p[7] == box0 && p[8] == kTile &&
         p[9] == 1 && p[10] == 1;
}

struct Args {
  CUtensorMap maps[kMaps];
  const float *l, *m;
  const int *q_seg, *kv_seg;
  float4* stats;
  __nv_bfloat16 *dq, *dk, *dv;
  void* dab;
  int B;
  Dims d;
  cudaStream_t stream;
};

// The SM count of the current device, read once per device
cudaError_t sm_count(int* dev, int* sms) {
  static int counts[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (counts[*dev] == 0) {
    err = cudaDeviceGetAttribute(&counts[*dev], cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
  }
  *sms = counts[*dev];
  return cudaSuccess;
}

// Persistent: at most one block an SM, each walking items blockIdx.x, +
// gridDim.x, ...; items of kOwn rows of `rows`
bool grid_of(const Args& a, int rows, int sms, int* items, int* grid) {
  const long long n = (long long)((rows + kOwn - 1) / kOwn) * a.d.H * a.B;
  if (n > INT32_MAX) return false;
  *items = (int)n;
  *grid = (int)(n < sms ? n : sms);
  return true;
}

template <bool kDq, int KS, bool kSeg, int AB, bool kCausal>
cudaError_t launch(const Args& a) {
  constexpr int NA = (KS + 3) / 4;
  constexpr int kSmem = kDq ? Smem<NA, AB, true>::kBytes : Smem<NA, AB, false>::kBytes;
  auto dq = flash_bwd_dq_kernel<KS, kSeg, AB, kCausal>;
  auto dkv = flash_bwd_dkv_kernel<KS, kSeg, AB, kCausal>;
  static bool configured[kMaxDevices] = {};  // one flag set per instance
  int dev = 0, sms = 0, items = 0, grid = 0;
  cudaError_t err = sm_count(&dev, &sms);
  if (err != cudaSuccess) return err;
  if (!configured[dev]) {
    err = kDq ? cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem)
              : cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  if (!grid_of(a, kDq ? a.d.sq : a.d.skv, sms, &items, &grid)) return cudaErrorInvalidValue;
  const CUtensorMap* mp = a.maps;
  if (kDq)
    dq<<<grid, kThreads, kSmem, a.stream>>>(mp[kQ], mp[kK], mp[kV], mp[kDo], mp[kO], mp[kAb], a.l,
                                            a.m, a.q_seg, a.kv_seg, a.stats, a.dq, a.dab, a.d,
                                            items);
  else
    dkv<<<grid, kThreads, kSmem, a.stream>>>(mp[kQ], mp[kK], mp[kV], mp[kDo], mp[kAb], a.stats,
                                             a.q_seg, a.kv_seg, a.dk, a.dv, a.d, items);
  return cudaGetLastError();
}

template <bool kDq, bool kSeg, int AB, bool kCausal>
cudaError_t dispatch_hd(const Args& a) {
  switch ((a.d.hd + 15) / 16) {
    case 1: return launch<kDq, 1, kSeg, AB, kCausal>(a);
    case 2: return launch<kDq, 2, kSeg, AB, kCausal>(a);
    case 3: return launch<kDq, 3, kSeg, AB, kCausal>(a);
    case 4: return launch<kDq, 4, kSeg, AB, kCausal>(a);
    case 5: return launch<kDq, 5, kSeg, AB, kCausal>(a);
    case 6: return launch<kDq, 6, kSeg, AB, kCausal>(a);
    case 7: return launch<kDq, 7, kSeg, AB, kCausal>(a);
    default: return launch<kDq, 8, kSeg, AB, kCausal>(a);
  }
}

template <bool kDq, bool kSeg, int AB>
cudaError_t dispatch_causal(const Args& a, int causal) {
  return causal ? dispatch_hd<kDq, kSeg, AB, true>(a) : dispatch_hd<kDq, kSeg, AB, false>(a);
}

template <bool kDq, bool kSeg>
cudaError_t dispatch_ab(const Args& a, int ab_bytes, int causal) {
  switch (ab_bytes) {
    case 0: return dispatch_causal<kDq, kSeg, 0>(a, causal);
    case 2: return dispatch_causal<kDq, kSeg, 2>(a, causal);
    default: return dispatch_causal<kDq, kSeg, 4>(a, causal);
  }
}

template <bool kDq>
cudaError_t dispatch(const Args& a, int ab_bytes, int causal) {
  return a.q_seg ? dispatch_ab<kDq, true>(a, ab_bytes, causal)
                 : dispatch_ab<kDq, false>(a, ab_bytes, causal);
}

bool valid(int B, int H, int sq, int skv, int hd, int ab_bytes, int causal) {
  return B > 0 && H > 0 && sq > 0 && skv > 0 && hd > 0 && hd <= kMaxHd && hd % 8 == 0 &&
         (causal == 0 || causal == 1) && (ab_bytes == 0 || ab_bytes == 2 || ab_bytes == 4);
}

// The launch arguments both kernels share; false where they cannot take them
bool make_args(Args* a, const void* maps, const void* q_seg, const void* kv_seg, const void* stats,
               int B, int H, int sq, int skv, int hd, int ab_bytes, int causal, float scale,
               void* stream) {
  if (maps == nullptr || stats == nullptr || (q_seg == nullptr) != (kv_seg == nullptr) ||
      !valid(B, H, sq, skv, hd, ab_bytes, causal))
    return false;
  *a = Args{};
  memcpy(a->maps, maps, sizeof(a->maps));  // 64-byte aligned here, whatever the caller's buffer
  a->q_seg = static_cast<const int*>(q_seg);
  a->kv_seg = static_cast<const int*>(kv_seg);
  a->stats = static_cast<float4*>(const_cast<void*>(stats));
  a->B = B;
  a->d = Dims{H, sq, skv, hd, (sq + kTile - 1) / kTile * kTile, (skv + kTile - 1) / kTile * kTile,
              scale};
  a->stream = (cudaStream_t)stream;
  return true;
}

}  // namespace

extern "C" {

// Encodes the backward's tensor maps once, into `maps` (6 x 128 bytes, any
// alignment): q, k, v, do, o and ab in turn. plan: 11 values a map, dims
// (hd, S, H, B) (S = sq for q, do and o, skv for k and v), byte strides of
// dims 1-3, box (64, 64, 1, 1); ab's dims (skv, sq, H, B), box (128 /
// ab_bytes, 64, 1, 1) (ignored without ab: ab null, ab_bytes 0). Returns the
// CUDA error (0 = success).
int novic_flash_attention_bwd_maps(const void* q, const void* k, const void* v, const void* d_o,
                                   const void* o, const void* ab, const long long* plan, int B,
                                   int H, int sq, int skv, int hd, int ab_bytes, void* maps) {
  if (q == nullptr || k == nullptr || v == nullptr || d_o == nullptr || o == nullptr ||
      plan == nullptr || maps == nullptr || (ab == nullptr) != (ab_bytes == 0) ||
      !valid(B, H, sq, skv, hd, ab_bytes, 0))
    return (int)cudaErrorInvalidValue;
  const void* base[kMaps] = {q, k, v, d_o, o, ab};
  const int rows[kMaps] = {sq, skv, skv, sq, sq, sq};
  CUtensorMap out[kMaps] = {};
  for (int i = 0; i < kMaps - 1; ++i) {
    if (!plan_matches(plan + kPlanLen * i, B, H, rows[i], hd, kAtom))
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = encode_map(&out[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base[i], 4,
                                       plan + kPlanLen * i);
    if (err != cudaSuccess) return (int)err;
  }
  if (ab_bytes) {
    const long long* p = plan + kPlanLen * kAb;
    if (!plan_matches(p, B, H, sq, skv, 128 / ab_bytes)) return (int)cudaErrorInvalidValue;
    const cudaError_t err = encode_map(
        &out[kAb], ab_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        ab, 4, p);
    if (err != cudaSuccess) return (int)err;
  }
  memcpy(maps, out, sizeof(out));
  return 0;
}

// The dQ kernel, launched first, on `stream`; returns the CUDA error of the
// launch (0 = success). maps: from novic_flash_attention_bwd_maps. l, m: the
// forward's (B, H, sq) float32 residuals. q_seg (B, sq rounded up to 64) and
// kv_seg (B, skv rounded up to 64) int32 are both null or both set. stats:
// (B, H, sq rounded up to 64, 4) float32, written (m, 1 / l, di, 0 a row).
// dq (B, H, sq, hd) bf16; dab null, or (B, H, sq, skv) in ab's dtype (needs
// ab). causal: 0 or 1.
int novic_flash_attention_bwd_dq(const void* maps, const void* l, const void* m,
                                 const void* q_seg, const void* kv_seg, void* stats, void* dq,
                                 void* dab, int B, int H, int sq, int skv, int hd, int ab_bytes,
                                 int causal, float scale, void* stream) {
  Args a;
  if (l == nullptr || m == nullptr || dq == nullptr || (dab != nullptr && ab_bytes == 0) ||
      !make_args(&a, maps, q_seg, kv_seg, stats, B, H, sq, skv, hd, ab_bytes, causal, scale,
                 stream))
    return (int)cudaErrorInvalidValue;
  a.l = static_cast<const float*>(l);
  a.m = static_cast<const float*>(m);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dab = dab;
  return (int)dispatch<true>(a, ab_bytes, causal);
}

// The dK/dV kernel, launched second on the same stream: the same maps,
// segment ids and shape, the stats the dQ kernel wrote; dk and dv (B, H,
// skv, hd) bf16.
int novic_flash_attention_bwd_dkv(const void* maps, const void* stats, const void* q_seg,
                                  const void* kv_seg, void* dk, void* dv, int B, int H, int sq,
                                  int skv, int hd, int ab_bytes, int causal, float scale,
                                  void* stream) {
  Args a;
  if (dk == nullptr || dv == nullptr ||
      !make_args(&a, maps, q_seg, kv_seg, stats, B, H, sq, skv, hd, ab_bytes, causal, scale,
                 stream))
    return (int)cudaErrorInvalidValue;
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  return (int)dispatch<false>(a, ab_bytes, causal);
}

}  // extern "C"
