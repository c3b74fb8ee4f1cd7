// Fused Q-side RMS-norm + RoPE + flash attention (non-causal, forward).
//
// Replaces: ladcast_tpu/ops/pallas/flash_attention.py:113 _fa_fused_kernel
// (launched by _fused_impl, :179), with its lse-returning variant (:163-167,
// :247-263) for the training path.
//
// Inputs: q (B, Sq, H, 128), kn and v (B, Sk, H, 128), all bf16 or all fp32;
// kn has already been through the K-side norm+RoPE pass (norm_rope.cu).
// Q tables qw, qcos, qsin are (Sq, 128) fp32. Per (b, head, q row), in the
// TPU kernel's order: Q is RMS-normed x weight row and rotated in fp32,
// scaled by 1/sqrt(D), then cast to the input dtype; an online softmax runs
// over all keys with keys >= Sk masked; P is cast to the input dtype before
// P.V; m, l and the accumulator are fp32; the output is acc / l in the
// input dtype. Given an `lse` pointer (B, H, Sq) fp32, each row also writes
// its logsumexp m + log(l) in natural-log units, the statistic the flash
// backward (flash_bwd.cu) recomputes P from; rows >= Sq are not written.
// A null `lse` is the lean inference kernel.
//
// Bound on an H100: at the main path's B=20, H=12, Sq=Sk=2250, the two
// products are 4*B*H*Sq*Sk*D = 6.2e11 flop, 0.63 ms at 989 TFLOP/s bf16,
// against 110 MB of q/k/v/o traffic (33 us): compute-bound. At the
// refiner's S=450 the products shrink 25-fold and the traffic 5-fold, and
// the kernel sits near the ridge.
// Design (bf16): one block of 4 warps per (64-row Q tile, b*head); each
// warp owns 16 Q rows. The normed Q tile goes through shared memory into
// registers once (ldmatrix). K and V stream through shared memory in
// 64-key tiles, two tiles in flight by cp.async (the first two load while
// Q is normed), so the copies overlap the products. S = Q.K^T and
// O += P.V run on the tensor cores with mma.sync.m16n8k16 (bf16 in, fp32
// accumulate), P staying in registers between the two products; the
// softmax works in log2 units (one exp2 per score). Shared-memory rows are
// padded by 16 bytes so that ldmatrix reads are free of bank conflicts;
// Q plus two K/V stages take 87 KB, above the 48 KB default, so the launch
// opts in. A wgmma/TMA pipeline is the known next step.
// fp32 (the parity dtype) runs a plain FMA kernel of the same structure,
// 32x32 tiles, on the CUDA cores.

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
constexpr float kNegInf = -1e30f;  // as the TPU kernel: exp(kNegInf - m) == 0

// ----------------------------------------------------------------- bf16 ---
constexpr int BM = 64, BN = 64, kWarps = 4, LDS = D + 8;
constexpr int kStages = 2;  // K/V tiles in flight
constexpr int kSmemBf16 = (BM + 2 * kStages * BN) * LDS * (int)sizeof(bf16);
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Start the copy of K/V rows [k0, k0 + BN) into one stage; rows past Sk
// are zero-filled with plain stores (visible after the next barrier).
__device__ __forceinline__ void load_kv_tile(bf16* sK, bf16* sV, const bf16* kb,
                                             const bf16* vb, int k0, int Sk,
                                             long long rs) {
  for (int c = threadIdx.x; c < BN * (D / 8); c += kWarps * 32) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    if (k0 + r < Sk) {
      cp_async16(sK + r * LDS + col, kb + (k0 + r) * rs + col);
      cp_async16(sV + r * LDS + col, vb + (k0 + r) * rs + col);
    } else {
      *reinterpret_cast<uint4*>(sK + r * LDS + col) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(sV + r * LDS + col) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kWarps * 32)
fa_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kn,
               const bf16* __restrict__ v, const float* __restrict__ qcos,
               const float* __restrict__ qsin, const float* __restrict__ qw,
               bf16* __restrict__ out, float* __restrict__ lse, int Sq, int Sk,
               int H, float eps, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BM * LDS;              // kStages tiles of BN rows
  bf16* sV = sK + kStages * BN * LDS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long rs = (long long)H * D;  // elements between sequence rows
  const bf16* qb = q + ((long long)b * Sq * H + h) * D;
  const bf16* kb = kn + ((long long)b * Sk * H + h) * D;
  const bf16* vb = v + ((long long)b * Sk * H + h) * D;
  bf16* ob = out + ((long long)b * Sq * H + h) * D;

  // The first K/V tiles load while the Q tile is normed.
  const int n_tiles = (Sk + BN - 1) / BN;
#pragma unroll
  for (int st = 0; st < kStages; ++st)
    if (st < n_tiles)
      load_kv_tile(sK + st * BN * LDS, sV + st * BN * LDS, kb, vb, st * BN, Sk, rs);

  // Q tile: norm + RoPE in fp32, scale, cast; padded rows are zero.
  for (int r = warp; r < BM; r += kWarps) {
    const int s = q0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (s < Sq) {
      ladcast::load4(qb + s * rs + lane * 4, x);
      const long long t = (long long)s * D;
      ladcast::norm_rope4(x, qw + t, qcos + t, qsin + t, lane, eps);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] *= scale;
    }
    ladcast::store4(sQ + r * LDS + lane * 4, x);
  }
  __syncthreads();

  uint32_t qf[D / 16][4];  // this warp's 16 rows as mma A fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // running max (in log2 units) and sum of rows g and g+8 of the warp
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    if (kt + 1 < n_tiles) cp_async_wait<kStages - 1>(); else cp_async_wait<0>();
    __syncthreads();  // tile kt has landed for every thread
    const bf16* tK = sK + (kt % kStages) * BN * LDS;
    const bf16* tV = sV + (kt % kStages) * BN * LDS;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys.
    float sc[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, tK + (np * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * LDS +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }
    // log2 units, so that exp(s - m) is one exp2; keys >= Sk masked
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sc[nt][j] = (k0 + nt * 8 + (lane & 3) * 2 + (j & 1) < Sk)
                        ? sc[nt][j] * kLog2e : kNegInf;

    // Online softmax; each row's values are spread over a quad of lanes.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      sc[nt][0] = exp2f(sc[nt][0] - mx0);
      sc[nt][1] = exp2f(sc[nt][1] - mx0);
      sc[nt][2] = exp2f(sc[nt][2] - mx1);
      sc[nt][3] = exp2f(sc[nt][3] - mx1);
      l0 += sc[nt][0] + sc[nt][1];
      l1 += sc[nt][2] + sc[nt][3];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= a0; o[dt][1] *= a0;
      o[dt][2] *= a1; o[dt][3] *= a1;
    }

    // O += P V: P (16 x 64, bf16) from the S accumulators, V via ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, tV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                  np * 16 + ((lane >> 4) & 1) * 8);
        mma_bf16(o[2 * np], pa, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (kt + kStages < n_tiles)
      load_kv_tile(sK + (kt % kStages) * BN * LDS, sV + (kt % kStages) * BN * LDS,
                   kb, vb, (kt + kStages) * BN, Sk, rs);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + (lane & 3) * 2;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * rs + col) =
          __floats2bfloat162_rn(o[dt][0] / l0, o[dt][1] / l0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * rs + col) =
          __floats2bfloat162_rn(o[dt][2] / l1, o[dt][3] / l1);
  }
  if (lse != nullptr && (lane & 3) == 0) {  // m is in log2 units
    float* lb = lse + ((long long)b * H + h) * Sq;
    if (r0 < Sq) lb[r0] = (m0 + log2f(l0)) * kLn2;
    if (r1 < Sq) lb[r1] = (m1 + log2f(l1)) * kLn2;
  }
}

// ----------------------------------------------------------------- fp32 ---
constexpr int FM = 32, FN = 32, kFThreads = 256;
constexpr int LQ = D + 4, LK = D + 1, LP = FN + 1;  // padded smem strides
constexpr int kSmemF32 = (FM * LQ + FN * LK + FN * D + FM * LP) * (int)sizeof(float);

// Thread (r = tid / 8, part = tid % 8) owns S[r][part + 8j], j < 4, and
// O[r][part + 8i], i < 16; the 8 threads of a row are consecutive lanes.
__global__ void __launch_bounds__(kFThreads)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ kn,
              const float* __restrict__ v, const float* __restrict__ qcos,
              const float* __restrict__ qsin, const float* __restrict__ qw,
              float* __restrict__ out, float* __restrict__ lse, int Sq, int Sk,
              int H, float eps, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + FM * LQ;
  float* sV = sK + FN * LK;
  float* sP = sV + FN * D;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * FM;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long rs = (long long)H * D;
  const float* qb = q + ((long long)b * Sq * H + h) * D;
  const float* kb = kn + ((long long)b * Sk * H + h) * D;
  const float* vb = v + ((long long)b * Sk * H + h) * D;
  float* ob = out + ((long long)b * Sq * H + h) * D;

  for (int r = warp; r < FM; r += kFThreads / 32) {
    const int s = q0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (s < Sq) {
      ladcast::load4(qb + s * rs + lane * 4, x);
      const long long t = (long long)s * D;
      ladcast::norm_rope4(x, qw + t, qcos + t, qsin + t, lane, eps);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] *= scale;
    }
    ladcast::store4(sQ + r * LQ + lane * 4, x);
  }

  const int r = tid >> 3, part = tid & 7;
  float o[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const int n_tiles = (Sk + FN - 1) / FN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * FN;
    __syncthreads();
    for (int c = tid; c < FN * (D / 4); c += kFThreads) {
      const int kr = c / (D / 4), col = (c % (D / 4)) * 4;
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + kr < Sk) {
        ladcast::load4(kb + (k0 + kr) * rs + col, kx);
        ladcast::load4(vb + (k0 + kr) * rs + col, vx);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) sK[kr * LK + col + i] = kx[i];
      ladcast::store4(sV + kr * D + col, vx);
    }
    __syncthreads();

    float s[FN / 8];
#pragma unroll
    for (int j = 0; j < FN / 8; ++j) {
      const int c = part + 8 * j;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(sQ[r * LQ + d], sK[c * LK + d], acc);
      s[j] = (k0 + c < Sk) ? acc : kNegInf;
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < FN / 8; ++j) mx = fmaxf(mx, s[j]);
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float alpha = expf(m - mx);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < FN / 8; ++j) {
      const float p = expf(s[j] - mx);
      sP[r * LP + part + 8 * j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l = l * alpha + sum;
    __syncwarp();  // a row's P is written and read by the same 8 lanes
#pragma unroll
    for (int i = 0; i < D / 8; ++i) o[i] *= alpha;
    for (int c = 0; c < FN; ++c) {
      const float p = sP[r * LP + c];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) o[i] = fmaf(p, sV[c * D + part + 8 * i], o[i]);
    }
  }

  if (q0 + r < Sq) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) ob[(q0 + r) * rs + part + 8 * i] = o[i] / l;
    if (lse != nullptr && part == 0)
      lse[((long long)b * H + h) * Sq + q0 + r] = m + logf(l);
  }
}

}  // namespace

// q, out: (B, Sq, H, 128); kn, v: (B, Sk, H, 128); contiguous, one dtype;
// lse: null, or (B, H, Sq) fp32. Returns cudaGetLastError().
extern "C" int ladcast_fused_attention(const void* q, const void* kn, const void* v,
                                       const float* qcos, const float* qsin,
                                       const float* qw, void* out, float* lse,
                                       int B, int Sq, int Sk, int H, float eps,
                                       float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ladcast::kDtypeBF16) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        fa_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBf16);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sq + BM - 1) / BM, B * H);
    fa_bf16_kernel<<<grid, kWarps * 32, kSmemBf16, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kn),
        static_cast<const bf16*>(v), qcos, qsin, qw, static_cast<bf16*>(out),
        lse, Sq, Sk, H, eps, scale);
  } else if (dtype == ladcast::kDtypeF32) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        fa_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemF32);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sq + FM - 1) / FM, B * H);
    fa_f32_kernel<<<grid, kFThreads, kSmemF32, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(kn),
        static_cast<const float*>(v), qcos, qsin, qw, static_cast<float*>(out),
        lse, Sq, Sk, H, eps, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
