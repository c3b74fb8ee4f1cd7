// Flash-attention backward (non-causal) over pre-normed, pre-rotated Q and K.
//
// Replaces: ladcast_tpu/ops/pallas/flash_attention.py:279 _fa_bwd_dq_kernel
// and :318 _fa_bwd_dkv_kernel (launched by _fa_bwd_impl, :366; dispatched
// by _fnra_bwd, :506).
//
// Inputs: qn and g (B, Sq, H, 128), kn and v (B, Sk, H, 128), all bf16 or
// all fp32; lse and delta (B, H, Sq) fp32, the forward's logsumexp rows and
// rowsum(g * out). Per (b, head), in the TPU kernels' order:
//   P  = exp(scale * qn.kn^T - lse)      keys >= Sk and rows >= Sq masked
//   dS = P o (g.v^T - delta)
//   dq = scale * dS.kn,  dk = scale * dS^T.qn,  dv = P^T.g
// Operands are in the input dtype, products accumulate in fp32, and P and
// dS are cast to the input dtype before the products they feed.
// Two kernels, as on the TPU: the dq kernel walks the key tiles for one
// query tile, the dk/dv kernel walks the query tiles for one key tile. No
// block writes what another writes, so there are no atomics and the result
// does not change from run to run.
//
// Bound on an H100: the dq kernel does three products of 2*Sq*Sk*D flop per
// (b, head), the dk/dv kernel four (P^T and dS^T are recomputed there): at
// the training shapes B=4, H=12, Sq=Sk=2250 that is 6*B*H*S^2*D = 1.87e11
// and 8*B*H*S^2*D = 2.49e11 flop, 0.19 ms and 0.25 ms at 989 TFLOP/s bf16,
// against 5 (B, S, H, D) tensors of traffic each (0.14 GB, 41 us):
// compute-bound, as the forward is.
// Design (bf16): one block of 4 warps per 64-row tile and b*head, each warp
// owning 16 rows of the tile it keeps (query rows in dq, key rows in
// dk/dv). The kept tiles sit in shared memory; the walked tiles stream
// through two cp.async stages, so one tile's copy overlaps the products on
// the other. Every product runs on the tensor cores as mma.sync.m16n8k16
// (bf16 in, fp32 accumulate): the logits and g.v^T with both operands from
// ldmatrix, then P or dS, cast from their fp32 accumulators in registers,
// times a walked tile read through ldmatrix.trans. The same 136-element
// padded rows as the forward keep ldmatrix free of bank conflicts; the
// 105 KB of shared memory is above the 48 KB default, so the launches opt
// in. wgmma/TMA and a fused single-pass dq+dk/dv design are the known next
// steps.
// fp32 (the parity dtype) runs plain FMA kernels of the same structure,
// 32x32 tiles, on the CUDA cores: TF32 would miss the fp32 check.

#include <math.h>

#include "mma.cuh"
#include "norm_rope.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ladcast::cp_async16;
using ladcast::cp_async_commit;
using ladcast::cp_async_wait;
using ladcast::ldmatrix_x4;
using ladcast::ldmatrix_x4_trans;
using ladcast::mma_bf16;
using ladcast::pack_bf16;
constexpr int D = ladcast::kHeadDim;

// ----------------------------------------------------------------- bf16 ---
constexpr int T = 64, kWarps = 4, LDS = D + 8;  // tile rows, padded row
constexpr int kStages = 2;                       // walked tiles in flight
constexpr int kTile = T * LDS;                   // elements of one tile
constexpr int kSmemDq = (2 + 2 * kStages) * kTile * (int)sizeof(bf16);
constexpr int kSmemDkv = kSmemDq + 2 * kStages * T * (int)sizeof(float);
constexpr float kLog2e = 1.4426950408889634f;

// Start the copy of rows [r0, r0 + T) of one head's (S, D) slice (row
// stride rs) into a T x LDS tile. Rows >= S are zero-filled with plain
// stores (visible after the next barrier). Commits no group.
__device__ __forceinline__ void load_tile(bf16* s, const bf16* src, int r0,
                                          int S, long long rs) {
  for (int c = threadIdx.x; c < T * (D / 8); c += kWarps * 32) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    if (r0 + r < S)
      cp_async16(s + r * LDS + col, src + (r0 + r) * rs + col);
    else
      *reinterpret_cast<uint4*>(s + r * LDS + col) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// acc (16 x T, mma C fragments) = rows [16*warp, 16*warp + 16) of sA times
// the T rows of sB, transposed: both operands through ldmatrix.
__device__ __forceinline__ void gemm_abt(float acc[T / 8][4], const bf16* sA,
                                         const bf16* sB, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < T / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sA + (warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < T / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, sB + (np * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * LDS +
                         kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += p (16 x T, fp32 C fragments cast to bf16 as the A
// operand) times the T x D tile sB, read through ldmatrix.trans.
__device__ __forceinline__ void gemm_pb(float acc[D / 8][4], const float p[T / 8][4],
                                        const bf16* sB, int lane) {
#pragma unroll
  for (int kk = 0; kk < T / 16; ++kk) {
    const uint32_t pa[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]),
        pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sB + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                               np * 16 + ((lane >> 4) & 1) * 8);
      mma_bf16(acc[2 * np], pa, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
    }
  }
}

// Store the 16 x D fragment accumulator times `mul` to rows r0 (C values 0,
// 1) and r0 + 8 (values 2, 3) of a (S, D) slice with row stride rs.
__device__ __forceinline__ void store_rows(bf16* dst, const float acc[D / 8][4],
                                           float mul, int r0, int S, long long rs,
                                           int lane) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + (lane & 3) * 2;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + r0 * rs + col) =
          __floats2bfloat162_rn(acc[dt][0] * mul, acc[dt][1] * mul);
    if (r0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + (r0 + 8) * rs + col) =
          __floats2bfloat162_rn(acc[dt][2] * mul, acc[dt][3] * mul);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
bwd_dq_bf16_kernel(const bf16* __restrict__ qn, const bf16* __restrict__ kn,
                   const bf16* __restrict__ v, const bf16* __restrict__ g,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int Sq, int Sk, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + kTile;
  bf16* sK = sG + kTile;               // kStages tiles
  bf16* sV = sK + kStages * kTile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * T;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long rs = (long long)H * D;
  const long long qoff = ((long long)b * Sq * H + h) * D;
  const bf16* kb = kn + ((long long)b * Sk * H + h) * D;
  const bf16* vb = v + ((long long)b * Sk * H + h) * D;

  load_tile(sQ, qn + qoff, q0, Sq, rs);
  load_tile(sG, g + qoff, q0, Sq, rs);
  cp_async_commit();
  const int n_tiles = (Sk + T - 1) / T;
#pragma unroll
  for (int st = 0; st < kStages; ++st)
    if (st < n_tiles) {
      load_tile(sK + st * kTile, kb, st * T, Sk, rs);
      load_tile(sV + st * kTile, vb, st * T, Sk, rs);
      cp_async_commit();
    }

  // rows r0 and r0 + 8 of the tile are this lane's; padded rows get zero
  // statistics, so their dS is zero (and they are not stored)
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const float* lrow = lse + ((long long)b * H + h) * Sq;
  const float* drow = delta + ((long long)b * H + h) * Sq;
  const float l0 = r0 < Sq ? lrow[r0] * kLog2e : 0.f;
  const float l1 = r0 + 8 < Sq ? lrow[r0 + 8] * kLog2e : 0.f;
  const float d0 = r0 < Sq ? drow[r0] : 0.f;
  const float d1 = r0 + 8 < Sq ? drow[r0 + 8] : 0.f;
  const float sl = scale * kLog2e;  // exp(scale*s - lse) == exp2(sl*s - lse*log2e)

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * T;
    if (kt + 1 < n_tiles) cp_async_wait<kStages - 1>(); else cp_async_wait<0>();
    __syncthreads();  // the Q/G tiles and K/V tile kt have landed
    const bf16* tK = sK + (kt % kStages) * kTile;
    const bf16* tV = sV + (kt % kStages) * kTile;

    float s[T / 8][4], dp[T / 8][4];
    gemm_abt(s, sQ, tK, warp, lane);
    gemm_abt(dp, sG, tV, warp, lane);
#pragma unroll
    for (int nt = 0; nt < T / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + nt * 8 + (lane & 3) * 2 + (j & 1);
        const float p = col < Sk ? exp2f(sl * s[nt][j] - (j < 2 ? l0 : l1)) : 0.f;
        s[nt][j] = p * (dp[nt][j] - (j < 2 ? d0 : d1));  // dS, fp32
      }
    gemm_pb(acc, s, tK, lane);  // dq += dS.kn
    __syncthreads();  // every warp is done with this stage
    if (kt + kStages < n_tiles) {
      load_tile(sK + (kt % kStages) * kTile, kb, (kt + kStages) * T, Sk, rs);
      load_tile(sV + (kt % kStages) * kTile, vb, (kt + kStages) * T, Sk, rs);
      cp_async_commit();
    }
  }
  store_rows(dq + qoff, acc, scale, r0, Sq, rs, lane);
}

__global__ void __launch_bounds__(kWarps * 32)
bwd_dkv_bf16_kernel(const bf16* __restrict__ qn, const bf16* __restrict__ kn,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
                    int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kTile;
  bf16* sQ = sV + kTile;               // kStages tiles
  bf16* sG = sQ + kStages * kTile;
  float* sL = reinterpret_cast<float*>(sG + kStages * kTile);  // kStages x T
  float* sD = sL + kStages * T;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * T;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long rs = (long long)H * D;
  const long long koff = ((long long)b * Sk * H + h) * D;
  const bf16* qb = qn + ((long long)b * Sq * H + h) * D;
  const bf16* gb = g + ((long long)b * Sq * H + h) * D;
  const float* lrow = lse + ((long long)b * H + h) * Sq;
  const float* drow = delta + ((long long)b * H + h) * Sq;

  load_tile(sK, kn + koff, k0, Sk, rs);
  load_tile(sV, v + koff, k0, Sk, rs);
  cp_async_commit();
  const int n_tiles = (Sq + T - 1) / T;
  // query tile qt into stage st: Q, G and their row statistics (in log2
  // units for the exp2; zero for padded rows, which the mask drops)
  auto load_q_tile = [&](int qt, int st) {
    load_tile(sQ + st * kTile, qb, qt * T, Sq, rs);
    load_tile(sG + st * kTile, gb, qt * T, Sq, rs);
    for (int i = threadIdx.x; i < T; i += kWarps * 32) {
      const int row = qt * T + i;
      sL[st * T + i] = row < Sq ? lrow[row] * kLog2e : 0.f;
      sD[st * T + i] = row < Sq ? drow[row] : 0.f;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages; ++st)
    if (st < n_tiles) load_q_tile(st, st);
  const float sl = scale * kLog2e;

  float ak[D / 8][4], av[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    ak[i][0] = ak[i][1] = ak[i][2] = ak[i][3] = 0.f;
    av[i][0] = av[i][1] = av[i][2] = av[i][3] = 0.f;
  }

  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * T;
    if (qt + 1 < n_tiles) cp_async_wait<kStages - 1>(); else cp_async_wait<0>();
    __syncthreads();  // the K/V tiles and Q/G tile qt have landed
    const bf16* tQ = sQ + (qt % kStages) * kTile;
    const bf16* tG = sG + (qt % kStages) * kTile;
    const float* tL = sL + (qt % kStages) * T;
    const float* tD = sD + (qt % kStages) * T;

    // P^T: this warp's 16 keys x the tile's T queries
    float p[T / 8][4];
    gemm_abt(p, sK, tQ, warp, lane);
#pragma unroll
    for (int nt = 0; nt < T / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = nt * 8 + (lane & 3) * 2 + (j & 1);
        p[nt][j] = q0 + c < Sq ? exp2f(sl * p[nt][j] - tL[c]) : 0.f;
      }
    gemm_pb(av, p, tG, lane);  // dv += P^T.g
    float ds[T / 8][4];
    gemm_abt(ds, sV, tG, warp, lane);
#pragma unroll
    for (int nt = 0; nt < T / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = nt * 8 + (lane & 3) * 2 + (j & 1);
        ds[nt][j] = p[nt][j] * (ds[nt][j] - tD[c]);  // dS^T, fp32
      }
    gemm_pb(ak, ds, tQ, lane);  // dk += dS^T.qn
    __syncthreads();  // every warp is done with this stage
    if (qt + kStages < n_tiles) load_q_tile(qt + kStages, qt % kStages);
  }
  const int r0 = k0 + warp * 16 + (lane >> 2);
  store_rows(dk + koff, ak, scale, r0, Sk, rs, lane);
  store_rows(dv + koff, av, 1.f, r0, Sk, rs, lane);
}

// ----------------------------------------------------------------- fp32 ---
constexpr int F = 32, kFThreads = 256;           // tile rows, threads
constexpr int LA = D + 4, LB = D + 1, LP = F + 1;  // padded smem strides
constexpr int kSmemF32 = (2 * F * LA + 2 * F * LB + 2 * F * LP + 2 * F) * (int)sizeof(float);

// Rows [r0, r0 + F) of a (S, D) slice into an F x LA tile (16-byte stores;
// rows >= S zero).
__device__ __forceinline__ void load_rows_a(float* s, const float* src, int r0,
                                            int S, long long rs) {
  for (int c = threadIdx.x; c < F * (D / 4); c += kFThreads) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < S) ladcast::load4(src + (r0 + r) * rs + col, x);
    ladcast::store4(s + r * LA + col, x);
  }
}

// The same into an F x LB tile (odd stride, scalar stores).
__device__ __forceinline__ void load_rows_b(float* s, const float* src, int r0,
                                            int S, long long rs) {
  for (int c = threadIdx.x; c < F * (D / 4); c += kFThreads) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < S) ladcast::load4(src + (r0 + r) * rs + col, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) s[r * LB + col + i] = x[i];
  }
}

__device__ __forceinline__ float dot_row(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// Thread (r = tid / 8, part = tid % 8) owns row r of the kept tile, the
// walked-tile columns part + 8j (j < 4) of its scores and the output
// columns part + 8i (i < 16); the 8 threads of a row are consecutive lanes.
__global__ void __launch_bounds__(kFThreads)
bwd_dq_f32_kernel(const float* __restrict__ qn, const float* __restrict__ kn,
                  const float* __restrict__ v, const float* __restrict__ g,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int Sq, int Sk, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sG = sQ + F * LA;
  float* sK = sG + F * LA;
  float* sV = sK + F * LB;
  float* sS = sV + F * LB;

  const int tid = threadIdx.x, r = tid >> 3, part = tid & 7;
  const int q0 = blockIdx.x * F;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long rs = (long long)H * D;
  const long long qoff = ((long long)b * Sq * H + h) * D;
  const float* kb = kn + ((long long)b * Sk * H + h) * D;
  const float* vb = v + ((long long)b * Sk * H + h) * D;
  const long long srow = ((long long)b * H + h) * Sq + q0 + r;
  const float lr = q0 + r < Sq ? lse[srow] : 0.f;
  const float dr = q0 + r < Sq ? delta[srow] : 0.f;

  load_rows_a(sQ, qn + qoff, q0, Sq, rs);
  load_rows_a(sG, g + qoff, q0, Sq, rs);
  float acc[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i] = 0.f;

  const int n_tiles = (Sk + F - 1) / F;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * F;
    __syncthreads();  // the previous tile is no longer read
    load_rows_b(sK, kb, k0, Sk, rs);
    load_rows_b(sV, vb, k0, Sk, rs);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < F / 8; ++j) {
      const int c = part + 8 * j;
      const float s = dot_row(sQ + r * LA, sK + c * LB);
      const float dp = dot_row(sG + r * LA, sV + c * LB);
      const float p = k0 + c < Sk ? expf(s * scale - lr) : 0.f;
      sS[r * LP + c] = p * (dp - dr);
    }
    __syncwarp();  // a row's dS is written and read by the same 8 lanes
    for (int c = 0; c < F; ++c) {
      const float ds = sS[r * LP + c];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) acc[i] = fmaf(ds, sK[c * LB + part + 8 * i], acc[i]);
    }
  }
  if (q0 + r < Sq) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) dq[qoff + (q0 + r) * rs + part + 8 * i] = acc[i] * scale;
  }
}

__global__ void __launch_bounds__(kFThreads)
bwd_dkv_f32_kernel(const float* __restrict__ qn, const float* __restrict__ kn,
                   const float* __restrict__ v, const float* __restrict__ g,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
                   int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + F * LA;
  float* sQ = sV + F * LA;
  float* sG = sQ + F * LB;
  float* sP = sG + F * LB;
  float* sS = sP + F * LP;
  float* sL = sS + F * LP;
  float* sD = sL + F;

  const int tid = threadIdx.x, r = tid >> 3, part = tid & 7;
  const int k0 = blockIdx.x * F;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long rs = (long long)H * D;
  const long long koff = ((long long)b * Sk * H + h) * D;
  const float* qb = qn + ((long long)b * Sq * H + h) * D;
  const float* gb = g + ((long long)b * Sq * H + h) * D;
  const long long srow = ((long long)b * H + h) * Sq;

  load_rows_a(sK, kn + koff, k0, Sk, rs);
  load_rows_a(sV, v + koff, k0, Sk, rs);
  float ak[D / 8], av[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) ak[i] = av[i] = 0.f;

  const int n_tiles = (Sq + F - 1) / F;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * F;
    __syncthreads();  // the previous tile is no longer read
    load_rows_b(sQ, qb, q0, Sq, rs);
    load_rows_b(sG, gb, q0, Sq, rs);
    if (tid < F) {
      sL[tid] = q0 + tid < Sq ? lse[srow + q0 + tid] : 0.f;
      sD[tid] = q0 + tid < Sq ? delta[srow + q0 + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < F / 8; ++j) {
      const int c = part + 8 * j;
      const float s = dot_row(sK + r * LA, sQ + c * LB);
      const float dp = dot_row(sV + r * LA, sG + c * LB);
      const float p = q0 + c < Sq ? expf(s * scale - sL[c]) : 0.f;
      sP[r * LP + c] = p;
      sS[r * LP + c] = p * (dp - sD[c]);
    }
    __syncwarp();  // a row's P and dS are written and read by the same 8 lanes
    for (int c = 0; c < F; ++c) {
      const float p = sP[r * LP + c], ds = sS[r * LP + c];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        av[i] = fmaf(p, sG[c * LB + part + 8 * i], av[i]);
        ak[i] = fmaf(ds, sQ[c * LB + part + 8 * i], ak[i]);
      }
    }
  }
  if (k0 + r < Sk) {
    const long long o = koff + (k0 + r) * rs + part;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      dk[o + 8 * i] = ak[i] * scale;
      dv[o + 8 * i] = av[i];
    }
  }
}

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// qn, g, dq: (B, Sq, H, 128); kn, v: (B, Sk, H, 128); contiguous, one dtype;
// lse, delta: (B, H, Sq) fp32. Returns cudaGetLastError().
extern "C" int ladcast_flash_bwd_dq(const void* qn, const void* kn, const void* v,
                                    const void* g, const float* lse,
                                    const float* delta, void* dq, int B, int Sq,
                                    int Sk, int H, float scale, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ladcast::kDtypeBF16) {
    static const cudaError_t attr = opt_in(bwd_dq_bf16_kernel, kSmemDq);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sq + T - 1) / T, B * H);
    bwd_dq_bf16_kernel<<<grid, kWarps * 32, kSmemDq, st>>>(
        static_cast<const bf16*>(qn), static_cast<const bf16*>(kn),
        static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, delta,
        static_cast<bf16*>(dq), Sq, Sk, H, scale);
  } else if (dtype == ladcast::kDtypeF32) {
    static const cudaError_t attr = opt_in(bwd_dq_f32_kernel, kSmemF32);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sq + F - 1) / F, B * H);
    bwd_dq_f32_kernel<<<grid, kFThreads, kSmemF32, st>>>(
        static_cast<const float*>(qn), static_cast<const float*>(kn),
        static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
        static_cast<float*>(dq), Sq, Sk, H, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// As ladcast_flash_bwd_dq; dk, dv: (B, Sk, H, 128).
extern "C" int ladcast_flash_bwd_dkv(const void* qn, const void* kn, const void* v,
                                     const void* g, const float* lse,
                                     const float* delta, void* dk, void* dv, int B,
                                     int Sq, int Sk, int H, float scale, int dtype,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ladcast::kDtypeBF16) {
    static const cudaError_t attr = opt_in(bwd_dkv_bf16_kernel, kSmemDkv);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sk + T - 1) / T, B * H);
    bwd_dkv_bf16_kernel<<<grid, kWarps * 32, kSmemDkv, st>>>(
        static_cast<const bf16*>(qn), static_cast<const bf16*>(kn),
        static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, delta,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H, scale);
  } else if (dtype == ladcast::kDtypeF32) {
    static const cudaError_t attr = opt_in(bwd_dkv_f32_kernel, kSmemF32);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sk + F - 1) / F, B * H);
    bwd_dkv_f32_kernel<<<grid, kFThreads, kSmemF32, st>>>(
        static_cast<const float*>(qn), static_cast<const float*>(kn),
        static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
