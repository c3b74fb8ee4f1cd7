// The loop of the plain flash attention with fp32 products (K6,
// flash_plain.cu), shared with the fp32 fused attention (K1,
// fused_attention.cu), which runs it on the three bf16 planes of its
// normed, rotated and scaled Q and asks for the lse rows. The design is
// described in flash_plain.cu; each including source defines its own
// __global__ kernels around `attention`.
#pragma once

#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace ladcast {
namespace flash_plain {

namespace hp = ladcast::hopper;
using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;  // as the TPU kernel: exp(kNegInf - m) == 0
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kPTerms = 3;          // bf16 terms that carry P
constexpr int kPlanesF32 = 3;       // bf16 planes that carry an fp32 input
constexpr int kStages = 2;          // K/V tiles in the ring
constexpr int kRows = 64;           // Q rows per consumer warpgroup
constexpr int kKeysBf16 = 64;       // keys per tile from one plane
constexpr int kKeysSplit = 32;      // keys per tile from three planes, DP <= 128
constexpr int kKeysSplitWide = 16;  // keys per tile from three planes, DP = 256
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// DP: the padded head size; NP: bf16 planes per input (1 or 3). Two
// consumer warpgroups: at DP <= 128 each takes 64 Q rows; at DP = 256 both
// take the same 64 rows, each computing S, and half of O's columns each.
template <int DP, int NP>
struct Cfg {
  using TOut = std::conditional_t<NP == kPlanesF32, float, bf16>;
  static constexpr bool kColSplit = DP == 256;
  static constexpr int kQTiles = kColSplit ? 1 : 2;  // 64-row Q tiles a block
  static constexpr int kBlockRows = kQTiles * kRows;
  static constexpr int kOCols = kColSplit ? DP / 2 : DP;  // a consumer's O
  static constexpr int kThreads = 3 * 128;  // consumers 0 and 1, producer 2
  static constexpr int BN = NP == 1 ? kKeysBf16 : DP == 256 ? kKeysSplitWide : kKeysSplit;
  static constexpr int kBoxes = DP / 64;         // 128-byte boxes per row
  static constexpr int kQBox = kRows * 128;      // bytes of a Q box
  static constexpr int kKBox = BN * 128;         // bytes of a K or V box
  static constexpr int kQPlane = kBoxes * kQBox;
  static constexpr int kKPlane = kBoxes * kKBox;
  static constexpr int kQBytes = kQTiles * NP * kQPlane;
  static constexpr int kStageBytes = NP * kKPlane;  // the K (or V) of a stage
  static constexpr int kSmem = kQBytes + 2 * kStages * kStageBytes
                               + 1024 + 1024;  // barriers, alignment
  static_assert(kSmem <= 232448, "shared memory of a block");
};

// S (64 x N fp32) = A.B (+ S), both K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_logits(float* d, uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 64) hp::wgmma_m64n64k16_ss(d, a, b, acc);
  else if constexpr (N == 32) hp::wgmma_m64n32k16_ss(d, a, b, acc);
  else hp::wgmma_m64n16k16_ss(d, a, b, acc);
}

// O (64 x N fp32) = A.B (+ O), A from registers, B MN-major in shared
// memory.
template <int N>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t b, int acc) {
  if constexpr (N == 128) hp::wgmma_m64n128k16_rs_tnsp_b(d, a, b, acc);
  else hp::wgmma_m64n64k16_rs_tnsp_b(d, a, b, acc);
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_one(bf16* p, float x) { *p = __float2bfloat16(x); }

// Softmax attention of one block (kBlockRows Q rows of head blockIdx.y % H,
// batch blockIdx.y / H) over the planes the three tensor maps read; the
// body of a kernel launched with Cfg<DP, NP>::kThreads threads and kSmem
// bytes of dynamic shared memory. Logits are scaled by `scale` (in natural
// units); out is (B, Sq, H, D); lse, when not null, (B, H, Sq) fp32 gets
// each row's m + log(l) in natural-log units.
template <int DP, int NP>
__device__ __forceinline__ void attention(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                          const CUtensorMap& tm_v,
                                          typename Cfg<DP, NP>::TOut* __restrict__ out,
                                          float* __restrict__ lse, int B, int Sq, int Sk,
                                          int H, int D, float scale) {
  using C = Cfg<DP, NP>;
  constexpr int BN = C::BN, ON = C::kOCols;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  unsigned char* sQ = smem_raw + ((1024 - (hp::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sQ + C::kQBytes;
  unsigned char* sV = sK + kStages * C::kStageBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sV + kStages * C::kStageBytes);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * C::kBlockRows;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n_tiles = (Sk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    hp::mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full_k[s], 1);
      hp::mbar_init(&full_v[s], 1);
      hp::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ---- producer: one thread keeps the ring full
    hp::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      // plane p of batch b is batch p B + b of the map
      hp::mbar_arrive_expect_tx(full_q, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kQTiles; ++c)
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int x = 0; x < C::kBoxes; ++x)
            hp::tma_load_4d(sQ + (c * NP + p) * C::kQPlane + x * C::kQBox, &tm_q,
                            full_q, 64 * x, h, q0 + c * kRows, p * B + b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        hp::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(&full_k[s], C::kStageBytes);
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int x = 0; x < C::kBoxes; ++x)
            hp::tma_load_4d(sK + s * C::kStageBytes + p * C::kKPlane + x * C::kKBox,
                            &tm_k, &full_k[s], 64 * x, h, kt * BN, p * B + b);
        hp::mbar_arrive_expect_tx(&full_v[s], C::kStageBytes);
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int x = 0; x < C::kBoxes; ++x)
            hp::tma_load_4d(sV + s * C::kStageBytes + p * C::kKPlane + x * C::kKBox,
                            &tm_v, &full_v[s], 64 * x, h, kt * BN, p * B + b);
      }
    }
    return;
  }

  // ---- consumers 0 and 1: 64 Q rows and ON columns of O each
  hp::setmaxnreg_inc<kConsumerRegs>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row0 = q0 + (C::kColSplit ? 0 : wg * kRows);
  const int col0 = C::kColSplit ? wg * ON : 0;
  // descriptor offsets in the 16-byte units of the start address field
  const uint64_t desc_q =
      hp::smem_desc_sw128(sQ + (C::kColSplit ? 0 : wg) * NP * C::kQPlane, 16, 1024);
  const uint64_t desc_k = hp::smem_desc_sw128(sK, 16, 1024);
  const uint64_t desc_v =  // MN-major, this consumer's columns
      hp::smem_desc_sw128(sV + (col0 / 64) * C::kKBox, C::kKBox, 1024);
  const float sl = scale * kLog2e;  // logits to log2 units

  // O: 64 rows x ON columns over 128 threads; ot: one tile's P.V
  float o[ON / 2], ot[ON / 2];
#pragma unroll
  for (int i = 0; i < ON / 2; ++i) o[i] = 0.f;
  // running max (log2 units) and sum of this thread's rows r and r + 8
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float sc[BN / 2];
  uint32_t pk[kPTerms][BN / 4];

  hp::mbar_wait(full_q, 0);
  if (wg == 1) hp::named_arrive(1, 256);  // consumer 0 takes the first turn

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % kStages;
    const uint32_t parity = (kt / kStages) & 1;

    // S = sum of Qi.Kj^T over i + j <= 2 (i, j < NP), smallest terms
    // first: 64 rows x BN keys, DP / 16 k-steps each
    hp::mbar_wait(&full_k[s], parity);
    hp::named_sync(1 + wg, 256);  // this consumer's turn
    hp::wgmma_fence();
    {
      int acc = 0;
#pragma unroll
      for (int ij = 2; ij >= 0; --ij)
#pragma unroll
        for (int i = ij; i >= 0; --i) {
          const int j = ij - i;
          if (i < NP && j < NP) {
#pragma unroll
            for (int kk = 0; kk < DP / 16; ++kk) {
              const int step = (kk & 3) * 2;  // 16 bf16 = 32 bytes
              wgmma_logits<BN>(
                  sc, desc_q + (i * C::kQPlane + (kk >> 2) * C::kQBox) / 16 + step,
                  desc_k + (s * C::kStageBytes + j * C::kKPlane + (kk >> 2) * C::kKBox) / 16
                      + step,
                  acc);
              acc = 1;
            }
          }
        }
    }
    hp::wgmma_commit();
    hp::named_arrive(2 - wg, 256);  // the other consumer's turn
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);

    // logits in log2 units; keys >= Sk (the ragged last tile) masked
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] *= sl;
    const int k0 = kt * BN;
    if (k0 + BN > Sk) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + 8 * j + 2 * (lane & 3) + (i & 1) >= Sk) sc[4 * j + i] = kNegInf;
    }
    // online softmax; a row's BN scores are spread over a quad of lanes
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    mx0 = fmaxf(m0, mx0);
    mx1 = fmaxf(m1, mx1);
    const float a0 = hp::exp2_ftz(m0 - mx0), a1 = hp::exp2_ftz(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
    // fp32 P, summed into l and split into kPTerms bf16 terms, each packed
    // as an A fragment: key k-step kk is n-blocks 2kk, 2kk + 1 of S, that
    // is pk[n][4kk .. 4kk + 3]
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = hp::exp2_ftz(sc[4 * j + i] - (i < 2 ? mx0 : mx1));
      l0 += p[0] + p[1];
      l1 += p[2] + p[3];
#pragma unroll
      for (int n = 0; n < kPTerms; ++n) {
        pk[n][2 * j] = ladcast::take_bf16x2(p[0], p[1]);
        pk[n][2 * j + 1] = ladcast::take_bf16x2(p[2], p[3]);
      }
    }

    // ot = sum of Pi.Vj over i + j <= 2 (j < NP), smallest terms first:
    // BN / 16 k-steps of 16 keys. wgmma's accumulation is coarser than fp32
    // rounding, so O itself is summed here: O = O alpha + ot.
    hp::mbar_wait(&full_v[s], parity);
    hp::named_sync(1 + wg, 256);
    hp::fence_regs(ot);
#pragma unroll
    for (int n = 0; n < kPTerms; ++n) hp::fence_regs(pk[n]);
    hp::wgmma_fence();
    {
      int acc = 0;
#pragma unroll
      for (int ij = 2; ij >= 0; --ij)
#pragma unroll
        for (int i = ij; i >= 0; --i) {
          const int j = ij - i;
          if (i < kPTerms && j < NP) {
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) {
              wgmma_pv<ON>(ot, &pk[i][4 * kk],
                           desc_v + (s * C::kStageBytes + j * C::kKPlane + kk * 16 * 128) / 16,
                           acc);
              acc = 1;
            }
          }
        }
    }
    hp::wgmma_commit();
    // every sync of one consumer is matched by one arrival of the other:
    // consumer 1 skips its last, consumer 0 had one from the start
    if (wg == 0 || kt + 1 < n_tiles) hp::named_arrive(2 - wg, 256);
    hp::wgmma_wait<0>();
    hp::fence_regs(ot);
    if (lane == 0) hp::mbar_arrive(&empty[s]);  // this warp is done with stage s
    __syncwarp();
#pragma unroll
    for (int i = 0; i < ON / 2; ++i) o[i] = fmaf(o[i], (i & 2) ? a1 : a0, ot[i]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = row0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const long long rs = (long long)H * D;  // elements between sequence rows
  typename C::TOut* ob = out + ((long long)b * Sq * H + h) * D;
#pragma unroll
  for (int j = 0; j < ON / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? r1 : r0;
      const int col = col0 + 8 * j + 2 * (lane & 3);
      const float l = half ? l1 : l0;
      const float x = o[4 * j + 2 * half] / l, y = o[4 * j + 2 * half + 1] / l;
      if (row >= Sq || col >= D) continue;
      if ((D & 1) == 0) {  // col and the row offset even: an aligned pair
        store_pair(ob + row * rs + col, x, y);
      } else {
        store_one(ob + row * rs + col, x);
        if (col + 1 < D) store_one(ob + row * rs + col + 1, y);
      }
    }
  // m is in log2 units; with the columns split, consumer 0 writes the rows
  if (lse != nullptr && col0 == 0 && (lane & 3) == 0) {
    float* lb = lse + ((long long)b * H + h) * Sq;
    if (r0 < Sq) lb[r0] = (m0 + log2f(l0)) * kLn2;
    if (r1 < Sq) lb[r1] = (m1 + log2f(l1)) * kLn2;
  }
}

}  // namespace flash_plain
}  // namespace ladcast
