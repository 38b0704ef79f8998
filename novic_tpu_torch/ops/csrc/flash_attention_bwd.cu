// The backward of one-pass attention for Hopper (sm_90a): the dK/dV and dQ
// kernels of JAX's TPU flash-attention VJP (X6b).
//
// Replaces jax.experimental.pallas.ops.tpu.flash_attention's
// `_flash_attention_dkv_kernel` (flash_attention.py:796, launched at :1121)
// and `_flash_attention_dq_kernel` (:1146, launched at :1456), which
// `_flash_attention_bwd` (:254) runs after di = sum(o * do) (:273, a torch
// reduction in the wrapper here). Both recompute the scores from q, k, ab and
// the masks, and p from the forward's residuals (csrc/flash_attention.cu):
//   s  = (q.k^T + ab) * scale, + -0.7 * FLT_MAX once where the segment ids
//        differ or (causal) the key lies after the query;
//   p  = exp(s - m) * (1 / l); under causal a key a row does not visit
//        (key / 128 > row / 128, JAX's `below_or_on_diag` at blocks of 128)
//        gets p = 0;
//   dp = do.v^T; ds = (dp - di) * p * scale;
//   dK/dV kernel: dv = bf16(p)^T.do, dk = bf16(ds)^T.q, summed over the
//        queries in float32 and stored once as bf16;
//   dQ kernel:    dq = bf16(ds).k summed over the keys in float32, stored as
//        bf16; where asked, ds itself as d(ab) in ab's dtype (zeros for the
//        keys a causal row does not visit, as JAX zeroes the blocks it skips).
//
// Layout: q, do (B, H, Sq, hd) and k, v (B, H, Skv, hd) bf16 views with hd
// contiguous, 16-byte aligned, (batch, head, seq) strides multiples of 8
// elements (the wrapper copies a cotangent that is not); hd a multiple of 8,
// at most 128; any Sq, Skv >= 1. ab, when given: float32 or bf16 (B, H, Sq,
// Skv) with the keys contiguous, read element by element with its strides.
// l, m, di contiguous (B, H, Sq) float32; segment ids, when given, int32
// (B, Sq) and (B, Skv). dk, dv (B, H, Skv, hd), dq (B, H, Sq, hd) and dab
// (B, H, Sq, Skv) contiguous outputs.
//
// Design: simple and right first (mma.sync m16n8k16 of mma_common.cuh, four
// warps a block, 16-byte cp.async copies into padded shared-memory rows read
// by ldmatrix); TMA, wgmma and a fused dK/dV/dQ kernel are later work.
//   dK/dV: a block per (batch, head, 64-key tile), each warp 16 keys. k and v
//     stay in shared memory; it walks the queries in steps of 32 (double
//     buffered: q, do, m, 1/l, di and the query segment ids), from the first
//     query whose causal block reaches the tile. Per step and warp: S^T =
//     k.q^T and dP^T = v.do^T (16 x 32), then P^T and dS^T in registers,
//     whose accumulator layout is the A operand's, so dv += bf16(P^T).do and
//     dk += bf16(dS^T).q follow without a trip through shared memory (do and
//     q by ldmatrix.trans).
//   dQ: a block per (batch, head, 64-query tile), each warp 16 queries. q and
//     do stay in shared memory; it walks the keys in steps of 32 (double
//     buffered: k, v and the key segment ids), up to the end of the last
//     causal block its last query visits. Per step and warp: S = q.k^T and
//     dP = do.v^T, P and dS in registers, d(ab) stored from them, dq +=
//     bf16(dS).k (k by ldmatrix.trans).
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): seven Sq x Skv x hd
// products (S, dP, dV, dK in the first kernel, S, dP, dQ in the second),
// 14*B*H*Sq*Skv*hd operations (halved under causal), against q, k, v, do, dq,
// dk and dv in bf16, l, m and di in float32, read or written once (plus ab
// and dab where given): at the DFN5B harness's (32, 16, 768, 80) 338 GFLOP,
// 0.342 ms, operations bound it; at attn_variants' (256, 12, 256, 64) 180
// GFLOP, 0.182 ms, against 0.24 ms of bytes (each tensor once). Recomputing
// the scores in both kernels costs 2 of the 7 products, as in JAX.
//
// Tolerance against the plain version (ops/flash_attention.py
// `flash_attention_bwd_reference`): products of bf16 values are exact in
// float32; sums run in another order and exp differs in its last bits, so a
// bf16 rounding of p or ds can land one ulp (2^-8 relative) apart, which
// moves a gradient by at most 2^-7 of the largest term it sums.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>
#include <math.h>

#include "mma_common.cuh"

namespace {

constexpr int kThreads = 128;      // four warps
constexpr int kTile = 64;          // keys (dK/dV) or queries (dQ) a block owns
constexpr int kStep = 32;          // queries (dK/dV) or keys (dQ) a step walks
constexpr int kCausalBlock = 128;  // the causal skip's blocks (CAUSAL_BLOCK)
constexpr int kMaxHd = 128;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));

struct Params {
  const __nv_bfloat16 *q, *k, *v, *d_o;
  const void* ab;
  const float *l, *m, *di;
  const int *q_seg, *kv_seg;
  __nv_bfloat16 *dq, *dk, *dv;
  void* dab;
  long long qs[3], ks[3], vs[3], dos[3], abst[3];  // (batch, head, seq) element strides
  int B, H, sq, skv, hd, ab_bytes, causal;
  float scale;
};

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory: rows of HDP bf16 (hd rounded up to 16) padded by 16 bytes,
// so that the eight rows an ldmatrix reads fall in different banks
template <int KS>
struct Rows {
  static constexpr int kHdp = 16 * KS;
  static constexpr int kStride = kHdp + 8;  // elements
  static constexpr int kBytes = kStride * 2;
};

// n rows of a (seq, hd) slice from global (row stride `ss` elements) into
// shared rows, 16-byte copies; rows at or past `valid` and features past hd
// are zero-filled
template <int KS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ss, int n, int valid, int hd) {
  constexpr int kChunks = Rows<KS>::kHdp / 8;
  for (int i = threadIdx.x; i < n * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < valid && 8 * c < hd;
    cp_async16(smem_u32(dst + r * Rows<KS>::kStride + 8 * c), ok ? src + r * ss + 8 * c : src,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ float bias_at(const Params& p, int b, int h, int qg, int kg) {
  if (p.ab == nullptr || qg >= p.sq || kg >= p.skv) return 0.f;
  const long long i = b * p.abst[0] + h * p.abst[1] + qg * p.abst[2] + kg;
  return p.ab_bytes == 4 ? static_cast<const float*>(p.ab)[i]
                         : __bfloat162float(static_cast<const __nv_bfloat16*>(p.ab)[i]);
}

// p and ds of one score, as the plain version computes them: s the float32
// q.k (and, for ds, dp the float32 do.v) of query qg and key kg
struct Grad {
  float p, ds;
};
__device__ __forceinline__ Grad score_grad(const Params& p, int b, int h, int qg, int kg, float s,
                                           float dp, bool seg_same, float m, float inv_l,
                                           float di) {
  float x = (s + bias_at(p, b, h, qg, kg)) * p.scale;
  bool keep = seg_same;
  if (p.causal) keep = keep && kg <= qg;
  if (p.q_seg != nullptr || p.causal) x += keep ? 0.f : kMaskValue;
  const bool visited = kg < p.skv && (!p.causal || kg / kCausalBlock <= qg / kCausalBlock);
  const float pr = visited ? ex2((x - m) * kLog2e) * inv_l : 0.f;
  return {pr, (dp - di) * pr * p.scale};
}

// ---- dK/dV ------------------------------------------------------------------

template <int KS>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Params p, int ntiles) {
  using R = Rows<KS>;
  constexpr int S = R::kStride;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTile * S;
  __nv_bfloat16* qs = vs + kTile * S;     // [2][kStep * S]
  __nv_bfloat16* dos = qs + 2 * kStep * S;  // [2][kStep * S]
  float* ms = reinterpret_cast<float*>(dos + 2 * kStep * S);  // [2][kStep]
  float* ls = ms + 2 * kStep;   // 1 / l
  float* dis = ls + 2 * kStep;
  int* qsg = reinterpret_cast<int*>(dis + 2 * kStep);

  const int kt = blockIdx.x % ntiles, h = (blockIdx.x / ntiles) % p.H;
  const int b = blockIdx.x / ntiles / p.H;
  const int key0 = kt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int kw = warp * 16;  // this warp's keys in the tile
  const long long bh = (long long)b * p.H + h;

  load_rows<KS>(ks, p.k + b * p.ks[0] + h * p.ks[1] + key0 * p.ks[2], p.ks[2], kTile,
                p.skv - key0, p.hd);
  load_rows<KS>(vs, p.v + b * p.vs[0] + h * p.vs[1] + key0 * p.vs[2], p.vs[2], kTile,
                p.skv - key0, p.hd);
  // Queries from the first whose causal block reaches this tile's keys
  const int q_begin = p.causal ? key0 / kCausalBlock * kCausalBlock : 0;
  const int nsteps = q_begin < p.sq ? (p.sq - q_begin + kStep - 1) / kStep : 0;
  auto load_step = [&](int step, int buf) {
    const int q0 = q_begin + step * kStep;
    load_rows<KS>(qs + buf * kStep * S, p.q + b * p.qs[0] + h * p.qs[1] + q0 * p.qs[2], p.qs[2],
                  kStep, p.sq - q0, p.hd);
    load_rows<KS>(dos + buf * kStep * S, p.d_o + b * p.dos[0] + h * p.dos[1] + q0 * p.dos[2],
                  p.dos[2], kStep, p.sq - q0, p.hd);
    if (threadIdx.x < kStep) {  // a query past sq gets p = 0: m = +inf, 1 / l = 0
      const int qg = q0 + threadIdx.x, i = buf * kStep + threadIdx.x;
      const bool ok = qg < p.sq;
      ms[i] = ok ? p.m[bh * p.sq + qg] : INFINITY;
      ls[i] = ok ? 1.f / p.l[bh * p.sq + qg] : 0.f;
      dis[i] = ok ? p.di[bh * p.sq + qg] : 0.f;
      qsg[i] = ok && p.q_seg != nullptr ? p.q_seg[(long long)b * p.sq + qg] : 0;
    }
  };
  if (nsteps > 0) load_step(0, 0);
  cp_async_commit();
  int kseg[2] = {0, 0};  // the segment ids of this thread's keys kw + g, kw + g + 8
  if (p.kv_seg != nullptr)
    for (int r = 0; r < 2; ++r) {
      const int kg = key0 + kw + g + 8 * r;
      kseg[r] = kg < p.skv ? p.kv_seg[(long long)b * p.skv + kg] : 0;
    }

  float dk[2 * KS][4] = {}, dv[2 * KS][4] = {};
  for (int step = 0; step < nsteps; ++step) {
    const int buf = step & 1, q0 = q_begin + step * kStep;
    if (step + 1 < nsteps) {
      load_step(step + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qb = qs + buf * kStep * S;
    const __nv_bfloat16* db = dos + buf * kStep * S;
    // S^T = k.q^T and dP^T = v.do^T, 16 keys x 32 queries: 4 n8 blocks
    float st[4][4] = {}, dpt[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      const int arow = kw + lane % 16, acol = 16 * kk + 8 * (lane / 16);
      ldmatrix_x4(ka, smem_u32(ks + arow * S + acol));
      ldmatrix_x4(va, smem_u32(vs + arow * S + acol));
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t bq[4], bd[4];
        const int brow = 16 * nb + lane % 8 + 8 * (lane / 16), bcol = 16 * kk + 8 * ((lane / 8) % 2);
        ldmatrix_x4(bq, smem_u32(qb + brow * S + bcol));
        ldmatrix_x4(bd, smem_u32(db + brow * S + bcol));
        mma_bf16(st[2 * nb], ka, bq[0], bq[1]);
        mma_bf16(st[2 * nb + 1], ka, bq[2], bq[3]);
        mma_bf16(dpt[2 * nb], va, bd[0], bd[1]);
        mma_bf16(dpt[2 * nb + 1], va, bd[2], bd[3]);
      }
    }
    // P^T and dS^T: rows the keys kw + g (+ 8), columns the queries 8j + 2c (+ 1)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, ql = 8 * j + 2 * c + (e & 1), i = buf * kStep + ql;
        const int kg = key0 + kw + g + 8 * r, qg = q0 + ql;
        const Grad gr = score_grad(p, b, h, qg, kg, st[j][e], dpt[j][e], kseg[r] == qsg[i],
                                   ms[i], ls[i], dis[i]);
        st[j][e] = gr.p;
        dpt[j][e] = gr.ds;
      }
    // dv += bf16(P^T).do and dk += bf16(dS^T).q over the step's 32 queries
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t sa[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
      const int brow = 16 * kk + lane % 8 + 8 * ((lane / 8) % 2);
#pragma unroll
      for (int nb = 0; nb < KS; ++nb) {
        uint32_t bd[4], bq[4];
        const int bcol = 16 * nb + 8 * (lane / 16);
        ldmatrix_x4_trans(bd, smem_u32(db + brow * S + bcol));
        ldmatrix_x4_trans(bq, smem_u32(qb + brow * S + bcol));
        mma_bf16(dv[2 * nb], pa, bd[0], bd[1]);
        mma_bf16(dv[2 * nb + 1], pa, bd[2], bd[3]);
        mma_bf16(dk[2 * nb], sa, bq[0], bq[1]);
        mma_bf16(dk[2 * nb + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();  // the buffer is refilled two steps on
  }
  if (nsteps == 0) cp_async_wait<0>();

  // dk and dv as bf16: rows kw + g (+ 8), features 8j + 2c (+ 1)
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j) {
    const int col = 8 * j + 2 * c;
    if (col >= p.hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kg = key0 + kw + g + 8 * r;
      if (kg >= p.skv) continue;
      const long long o = (bh * p.skv + kg) * p.hd + col;
      *reinterpret_cast<uint32_t*>(p.dk + o) = pack_bf16(dk[j][2 * r], dk[j][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(p.dv + o) = pack_bf16(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// ---- dQ ---------------------------------------------------------------------

__device__ __forceinline__ void store_dab(const Params& p, long long i, float x) {
  if (p.ab_bytes == 4)
    static_cast<float*>(p.dab)[i] = x;
  else
    static_cast<__nv_bfloat16*>(p.dab)[i] = __float2bfloat16_rn(x);
}

template <int KS>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p, int ntiles) {
  using R = Rows<KS>;
  constexpr int S = R::kStride;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kTile * S;
  __nv_bfloat16* ks = dos + kTile * S;    // [2][kStep * S]
  __nv_bfloat16* vs = ks + 2 * kStep * S;  // [2][kStep * S]
  int* ksg = reinterpret_cast<int*>(vs + 2 * kStep * S);  // [2][kStep]

  const int qt = blockIdx.x % ntiles, h = (blockIdx.x / ntiles) % p.H;
  const int b = blockIdx.x / ntiles / p.H;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int qw = warp * 16;  // this warp's queries in the tile
  const long long bh = (long long)b * p.H + h;

  load_rows<KS>(qs, p.q + b * p.qs[0] + h * p.qs[1] + q0 * p.qs[2], p.qs[2], kTile, p.sq - q0,
                p.hd);
  load_rows<KS>(dos, p.d_o + b * p.dos[0] + h * p.dos[1] + q0 * p.dos[2], p.dos[2], kTile,
                p.sq - q0, p.hd);
  // Keys up to the end of the last causal block the tile's last query visits
  const int last = min(q0 + kTile, p.sq) - 1;
  const int k_end = p.causal ? min(p.skv, (last / kCausalBlock + 1) * kCausalBlock) : p.skv;
  const int nsteps = (k_end + kStep - 1) / kStep;
  auto load_step = [&](int step, int buf) {
    const int k0 = step * kStep;
    load_rows<KS>(ks + buf * kStep * S, p.k + b * p.ks[0] + h * p.ks[1] + k0 * p.ks[2], p.ks[2],
                  kStep, p.skv - k0, p.hd);
    load_rows<KS>(vs + buf * kStep * S, p.v + b * p.vs[0] + h * p.vs[1] + k0 * p.vs[2], p.vs[2],
                  kStep, p.skv - k0, p.hd);
    if (threadIdx.x < kStep) {
      const int kg = k0 + threadIdx.x;
      ksg[buf * kStep + threadIdx.x] =
          kg < p.skv && p.kv_seg != nullptr ? p.kv_seg[(long long)b * p.skv + kg] : 0;
    }
  };
  load_step(0, 0);
  cp_async_commit();
  // This thread's queries qw + g (+ 8): m, 1 / l, di and segment ids; a query
  // past sq gets p = 0
  float m[2], inv_l[2], di[2];
  int qseg[2];
  for (int r = 0; r < 2; ++r) {
    const int qg = q0 + qw + g + 8 * r;
    const bool ok = qg < p.sq;
    m[r] = ok ? p.m[bh * p.sq + qg] : INFINITY;
    inv_l[r] = ok ? 1.f / p.l[bh * p.sq + qg] : 0.f;
    di[r] = ok ? p.di[bh * p.sq + qg] : 0.f;
    qseg[r] = ok && p.q_seg != nullptr ? p.q_seg[(long long)b * p.sq + qg] : 0;
  }

  float dq[2 * KS][4] = {};
  for (int step = 0; step < nsteps; ++step) {
    const int buf = step & 1, k0 = step * kStep;
    if (step + 1 < nsteps) {
      load_step(step + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kb = ks + buf * kStep * S;
    const __nv_bfloat16* vb = vs + buf * kStep * S;
    // S = q.k^T and dP = do.v^T, 16 queries x 32 keys: 4 n8 blocks
    float sc[4][4] = {}, dp[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], da[4];
      const int arow = qw + lane % 16, acol = 16 * kk + 8 * (lane / 16);
      ldmatrix_x4(qa, smem_u32(qs + arow * S + acol));
      ldmatrix_x4(da, smem_u32(dos + arow * S + acol));
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t bk[4], bv[4];
        const int brow = 16 * nb + lane % 8 + 8 * (lane / 16), bcol = 16 * kk + 8 * ((lane / 8) % 2);
        ldmatrix_x4(bk, smem_u32(kb + brow * S + bcol));
        ldmatrix_x4(bv, smem_u32(vb + brow * S + bcol));
        mma_bf16(sc[2 * nb], qa, bk[0], bk[1]);
        mma_bf16(sc[2 * nb + 1], qa, bk[2], bk[3]);
        mma_bf16(dp[2 * nb], da, bv[0], bv[1]);
        mma_bf16(dp[2 * nb + 1], da, bv[2], bv[3]);
      }
    }
    // dS: rows the queries qw + g (+ 8), columns the keys 8j + 2c (+ 1); d(ab)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kl = 8 * j + 2 * c + (e & 1);
        const int qg = q0 + qw + g + 8 * r, kg = k0 + kl;
        const Grad gr = score_grad(p, b, h, qg, kg, sc[j][e], dp[j][e],
                                   qseg[r] == ksg[buf * kStep + kl], m[r], inv_l[r], di[r]);
        dp[j][e] = gr.ds;
        if (p.dab != nullptr && qg < p.sq && kg < p.skv)
          store_dab(p, (bh * p.sq + qg) * p.skv + kg, gr.ds);
      }
    // dq += bf16(dS).k over the step's 32 keys
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      const uint32_t sa[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      const int brow = 16 * kk + lane % 8 + 8 * ((lane / 8) % 2);
#pragma unroll
      for (int nb = 0; nb < KS; ++nb) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, smem_u32(kb + brow * S + 16 * nb + 8 * (lane / 16)));
        mma_bf16(dq[2 * nb], sa, bk[0], bk[1]);
        mma_bf16(dq[2 * nb + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();  // the buffer is refilled two steps on
  }
  // d(ab) is 0 past the keys walked (keys no query of the tile visits)
  const int kz = nsteps * kStep;
  if (p.dab != nullptr && kz < p.skv) {
    const int rows = min(kTile, p.sq - q0), cols = p.skv - kz;
    for (int i = threadIdx.x; i < rows * cols; i += kThreads)
      store_dab(p, (bh * p.sq + q0 + i / cols) * p.skv + kz + i % cols, 0.f);
  }

  // dq as bf16: rows qw + g (+ 8), features 8j + 2c (+ 1)
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j) {
    const int col = 8 * j + 2 * c;
    if (col >= p.hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qg = q0 + qw + g + 8 * r;
      if (qg >= p.sq) continue;
      *reinterpret_cast<uint32_t*>(p.dq + (bh * p.sq + qg) * p.hd + col) =
          pack_bf16(dq[j][2 * r], dq[j][2 * r + 1]);
    }
  }
}

// ---- launch -------------------------------------------------------------------

template <int KS>
constexpr int dkv_smem() {
  return (2 * kTile + 4 * kStep) * Rows<KS>::kBytes + 2 * kStep * 4 * 4;
}
template <int KS>
constexpr int dq_smem() {
  return (2 * kTile + 4 * kStep) * Rows<KS>::kBytes + 2 * kStep * 4;
}

template <bool kDq, int KS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = kDq ? &dq_kernel<KS> : &dkv_kernel<KS>;
  constexpr int kSmem = kDq ? dq_smem<KS>() : dkv_smem<KS>();
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
  const int ntiles = ((kDq ? p.sq : p.skv) + kTile - 1) / kTile;
  const long long blocks = (long long)ntiles * p.H * p.B;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  kernel<<<(int)blocks, kThreads, kSmem, stream>>>(p, ntiles);
  return cudaGetLastError();
}

template <bool kDq>
cudaError_t dispatch(const Params& p, cudaStream_t s) {
  switch ((p.hd + 15) / 16) {
    case 1: return launch<kDq, 1>(p, s);
    case 2: return launch<kDq, 2>(p, s);
    case 3: return launch<kDq, 3>(p, s);
    case 4: return launch<kDq, 4>(p, s);
    case 5: return launch<kDq, 5>(p, s);
    case 6: return launch<kDq, 6>(p, s);
    case 7: return launch<kDq, 7>(p, s);
    default: return launch<kDq, 8>(p, s);
  }
}

bool aligned(const void* ptr, const long long* strides) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && strides[0] % 8 == 0 &&
         strides[1] % 8 == 0 && strides[2] % 8 == 0;
}

// Checks the arguments and fills Params; false where the kernels cannot take them
bool make_params(Params* p, const void* q, const void* k, const void* v, const void* d_o,
                 const void* ab, const void* l, const void* m, const void* di, const void* q_seg,
                 const void* kv_seg, const long long* strides, int B, int H, int sq, int skv,
                 int hd, int ab_bytes, int causal, float scale) {
  if (B <= 0 || H <= 0 || sq <= 0 || skv <= 0 || hd <= 0 || hd > kMaxHd || hd % 8 != 0 ||
      q == nullptr || k == nullptr || v == nullptr || d_o == nullptr || l == nullptr ||
      m == nullptr || di == nullptr || strides == nullptr ||
      (q_seg == nullptr) != (kv_seg == nullptr) || (causal != 0 && causal != 1) ||
      (ab_bytes != 0 && ab_bytes != 2 && ab_bytes != 4) || (ab == nullptr) != (ab_bytes == 0))
    return false;
  // A size-1 dimension is never stepped: its stride is not checked
  long long st[15];
  const int dims[5][3] = {{B, H, sq}, {B, H, skv}, {B, H, skv}, {B, H, sq}, {B, H, sq}};
  for (int t = 0; t < 5; ++t)
    for (int d = 0; d < 3; ++d) st[3 * t + d] = dims[t][d] > 1 ? strides[3 * t + d] : 0;
  if (!aligned(q, st) || !aligned(k, st + 3) || !aligned(v, st + 6) || !aligned(d_o, st + 9))
    return false;
  *p = Params{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(d_o), ab,
              static_cast<const float*>(l), static_cast<const float*>(m),
              static_cast<const float*>(di), static_cast<const int*>(q_seg),
              static_cast<const int*>(kv_seg), nullptr, nullptr, nullptr, nullptr,
              {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
              {st[9], st[10], st[11]}, {strides[12], strides[13], strides[14]},
              B, H, sq, skv, hd, ab_bytes, causal, scale};
  return true;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error of the launch (0 = success).
// strides: the (batch, head, seq) element strides of q, k, v, do and ab in
// turn (ab's ignored without ab). ab: null with ab_bytes 0, else float32 (4)
// or bf16 (2). l, m, di: (B, H, sq) float32. q_seg (B, sq) and kv_seg (B,
// skv) int32 are both null or both set. causal: 0 or 1.
int novic_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* d_o,
                                  const void* ab, const void* l, const void* m, const void* di,
                                  const void* q_seg, const void* kv_seg, void* dk, void* dv,
                                  const long long* strides, int B, int H, int sq, int skv, int hd,
                                  int ab_bytes, int causal, float scale, void* stream) {
  Params p;
  if (dk == nullptr || dv == nullptr ||
      !make_params(&p, q, k, v, d_o, ab, l, m, di, q_seg, kv_seg, strides, B, H, sq, skv, hd,
                   ab_bytes, causal, scale))
    return (int)cudaErrorInvalidValue;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  return (int)dispatch<false>(p, (cudaStream_t)stream);
}

// The same inputs; dq (B, H, sq, hd) bf16 and, where not null (needs ab),
// dab (B, H, sq, skv) in ab's dtype.
int novic_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* d_o,
                                 const void* ab, const void* l, const void* m, const void* di,
                                 const void* q_seg, const void* kv_seg, void* dq, void* dab,
                                 const long long* strides, int B, int H, int sq, int skv, int hd,
                                 int ab_bytes, int causal, float scale, void* stream) {
  Params p;
  if (dq == nullptr || (dab != nullptr && ab == nullptr) ||
      !make_params(&p, q, k, v, d_o, ab, l, m, di, q_seg, kv_seg, strides, B, H, sq, skv, hd,
                   ab_bytes, causal, scale))
    return (int)cudaErrorInvalidValue;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dab = dab;
  return (int)dispatch<true>(p, (cudaStream_t)stream);
}

}  // extern "C"
