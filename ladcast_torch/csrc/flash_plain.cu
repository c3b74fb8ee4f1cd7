// Plain non-causal flash attention (forward) with fp32 products, no norm
// and no RoPE.
//
// Replaces: ladcast_tpu/ops/pallas/flash_attention.py:601 _fa_plain_kernel
// (launched by _flash_attention_impl, :565; public entry flash_attention,
// :645).
//
// Inputs: q (B, Sq, H, D), k and v (B, Sk, H, D), all bf16 or all fp32, D
// <= 256, Sq and Sk independent. The contract is the TPU kernel's: logits,
// the online softmax (keys >= Sk masked with -1e30), P, P.V, m, l and the
// accumulator are fp32, and no product of Q, K or V, and no P, is rounded
// to bf16; the output is acc / l, cast to the input dtype at the store. One
// change of order: the TPU kernel scales Q by 1/sqrt(D) before Q.K^T, this
// kernel scales the fp32 logits (log2(e) folded in, for exp2); the two
// differ by fp32 rounding only.
//
// Bound on an H100: the products run on the tensor cores in bf16 passes of
// 2 B H Sq Sk D flop each. bf16 inputs: 4 passes (Q.K^T, and P.V once per
// bf16 term of P), 0.126 ms at (2, 2250, 12, 128) at 989 TFLOP/s; fp32
// inputs: 12 bf16 passes (as many flop as 6 TF32 passes at 494.7), 0.377 ms;
// against 28 MB (bf16) or 55 MB (fp32) of q/k/v/o traffic, 8 or 17 us:
// operations.
// Design: the shape of the attention forward (fused_attention.cu) on Hopper
// (sm_90a), with the contract's arithmetic in split-precision products.
//  - Products of bf16 values are exact in fp32, and wgmma sums them in an
//    fp32 accumulator. So a value is carried by bf16 terms: t0 = bf16(x),
//    t1 = bf16(x - t0), t2 = bf16(x - t0 - t1) hold fp32 x's 24
//    significant bits.
//  - bf16 inputs: S = Q.K^T is one bf16 wgmma pass. P is split in
//    registers into kPTerms = 3 terms, each packed as the A fragment of a
//    P.V pass: O += p0.V + p1.V + p2.V, smallest first.
//  - fp32 inputs: a split pass (fa_plain_split_kernel, launched by the same
//    entry, its time part of the kernel's) writes q, k and v once as three
//    bf16 planes each. S sums the six plane products Qi.Kj^T with i + j <=
//    2, and O the six Pi.Vj: the dropped terms are below 2^-26 of the
//    product. The loop is the bf16 one with more terms.
//  - wgmma's additions into its fp32 accumulator lose more than an fp32
//    add's rounding, so the error of a long sum grows with its length: O
//    summed over every key tile on the tensor cores missed the fp32 check,
//    by more at Sk = 2250 than at 450. So a tile's P.V products go into a
//    fresh accumulator, and O = O alpha + that is summed in registers.
//  - A block is one producer warpgroup, whose one thread issues every TMA
//    load, and two consumer warpgroups; setmaxnreg moves registers from the
//    producer (24 a thread) to the consumers (240). The consumers take turns
//    issuing their products (named barriers 1 and 2), so one's softmax
//    overlaps the other's products.
//  - Q is loaded once; K and V tiles of BN keys stream through a ring of
//    kStages stages, each with "full" mbarriers for K and V (expect_tx
//    bytes) and an "empty" one on which every consumer warp arrives once
//    the P.V that read the stage has retired.
//  - The 4-D tensor maps over (D, H, S, B) (planes: (DP, H, S, NP B)), with
//    boxes of 64 columns and 128-byte swizzle, zero-fill rows past Sq or Sk
//    and columns past D: a head size is padded inside the tile to DP = 64,
//    128 or 256 columns. Keys >= Sk are still masked to -1e30, since a
//    zero-filled key gives exp2(0 - m), not 0. Stores are masked at Sq and D.
//  - S = Q.K^T reads both operands K-major from shared memory; P.V takes P
//    from registers and reads V MN-major through the transpose bit, so V is
//    never transposed in memory.
//  - Tile sizes follow shared memory and registers. A consumer holds O and
//    a tile's P.V for 64 rows and at most 128 columns: at DP <= 128 each
//    consumer takes 64 Q rows, at DP = 256 both take the same 64 rows and
//    half of O's columns each (each computing S). 64 keys a tile from one
//    plane, 32 from three at DP <= 128, 16 at DP = 256 (Q's three planes of
//    256 columns take 96 KB).
//  - TMA needs strides (D and H D element bytes) that are multiples of 16.
//    bf16 inputs whose D is no multiple of 8 go through the split pass too,
//    with one plane: a copy padded to DP columns.

#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

namespace hp = ladcast::hopper;
using bf16 = __nv_bfloat16;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr float kNegInf = -1e30f;  // as the TPU kernel: exp(kNegInf - m) == 0
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kPTerms = 3;          // bf16 terms that carry P
constexpr int kPlanesF32 = 3;       // bf16 planes that carry an fp32 input
constexpr int kStages = 2;          // K/V tiles in the ring
constexpr int kRows = 64;           // Q rows per consumer warpgroup
constexpr int kKeysBf16 = 64;       // keys per tile from one plane
constexpr int kKeysSplit = 32;      // keys per tile from three planes, DP <= 128
constexpr int kKeysSplitWide = 16;  // keys per tile from three planes, DP = 256
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kSplitThreads = 256;

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
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// x (rows, D) -> NP bf16 planes (NP, rows, DP), columns >= D zero: plane n
// holds the bf16 rounding of what planes < n left of x (exact in fp32).
template <typename T, int NP>
__global__ void __launch_bounds__(kSplitThreads)
fa_plain_split_kernel(const T* __restrict__ x, bf16* __restrict__ planes,
                      long long rows, int D, int dp_shift) {
  const long long n = rows << dp_shift;
  const int dp_mask = (1 << dp_shift) - 1;
  for (long long e = blockIdx.x * (long long)kSplitThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kSplitThreads) {
    const long long r = e >> dp_shift;
    const int c = (int)(e & dp_mask);
    float v = c < D ? to_float(x[r * D + c]) : 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const bf16 t = __float2bfloat16(v);
      planes[p * n + e] = t;
      v -= __bfloat162float(t);
    }
  }
}

// One block per (kBlockRows Q rows, b * H + h).
template <int DP, int NP>
__global__ void __launch_bounds__(Cfg<DP, NP>::kThreads, 1)
fa_plain_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                      __grid_constant__ const CUtensorMap tm_k,
                      __grid_constant__ const CUtensorMap tm_v,
                      typename Cfg<DP, NP>::TOut* __restrict__ out, int B, int Sq,
                      int Sk, int H, int D, float scale) {
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
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p[0], p[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2], p[3]);
        pk[n][2 * j] = *reinterpret_cast<const uint32_t*>(&lo);
        pk[n][2 * j + 1] = *reinterpret_cast<const uint32_t*>(&hi);
        p[0] -= __low2float(lo);
        p[1] -= __high2float(lo);
        p[2] -= __low2float(hi);
        p[3] -= __high2float(hi);
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
}

template <typename T, int NP>
int split(const void* x, void* planes, long long rows, int D, int dp_shift,
          cudaStream_t st) {
  const long long n = rows << dp_shift;
  const long long blocks = (n + kSplitThreads - 1) / kSplitThreads;
  fa_plain_split_kernel<T, NP><<<(unsigned)(blocks < 2112 ? blocks : 2112),
                                 kSplitThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<bf16*>(planes), rows, D, dp_shift);
  return (int)cudaGetLastError();
}

template <int DP, int NP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
           int Sk, int H, int D, float scale, bool planes, cudaStream_t st) {
  using C = Cfg<DP, NP>;
  // planes are (NP B, S, H, DP); inputs read as they are, (B, S, H, D)
  const int mb = planes ? NP * B : B, md = planes ? DP : D;
  CUtensorMap tm_q, tm_k, tm_v;
  int rc = hp::encode_bshd_bf16(&tm_q, q, mb, Sq, H, md, kRows);
  if (rc == 0) rc = hp::encode_bshd_bf16(&tm_k, k, mb, Sk, H, md, C::BN);
  if (rc == 0) rc = hp::encode_bshd_bf16(&tm_v, v, mb, Sk, H, md, C::BN);
  if (rc != 0) return rc;
  // once per instantiation: the shared memory passes the 48 KB default
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_plain_wgmma_kernel<DP, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + C::kBlockRows - 1) / C::kBlockRows, B * H);
  fa_plain_wgmma_kernel<DP, NP><<<grid, C::kThreads, C::kSmem, st>>>(
      tm_q, tm_k, tm_v, static_cast<typename C::TOut*>(out), B, Sq, Sk, H, D, scale);
  return (int)cudaGetLastError();
}

template <int NP>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
             int Sk, int H, int D, float scale, bool planes, cudaStream_t st) {
  if (D <= 64) return launch<64, NP>(q, k, v, out, B, Sq, Sk, H, D, scale, planes, st);
  if (D <= 128) return launch<128, NP>(q, k, v, out, B, Sq, Sk, H, D, scale, planes, st);
  return launch<256, NP>(q, k, v, out, B, Sq, Sk, H, D, scale, planes, st);
}

}  // namespace

// q, out: (B, Sq, H, D); k, v: (B, Sk, H, D); contiguous, 16-byte aligned,
// one dtype, D <= 256, B * H <= 65535. q_planes, k_planes and v_planes are
// bf16 scratch of (NP B, Sq or Sk, H, DP) elements, DP the head size padded
// to 64, 128 or 256, NP = 3 for fp32 inputs and 1 for bf16; they may be null
// for bf16 inputs whose D is a multiple of 8 (strides TMA can load), and
// then the kernel reads the inputs as they are. Returns cudaGetLastError(),
// or the driver's error code when a tensor map cannot be encoded.
extern "C" int ladcast_flash_attention(const void* q, const void* k, const void* v,
                                       void* out, void* q_planes, void* k_planes,
                                       void* v_planes, int B, int Sq, int Sk, int H,
                                       int D, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H > 65535 || D < 1 || D > 256 || Sk < 1) return (int)cudaErrorInvalidValue;
  if (dtype != kDtypeF32 && dtype != kDtypeBF16) return (int)cudaErrorInvalidValue;
  const bool planes = q_planes != nullptr;
  if (planes != (k_planes != nullptr) || planes != (v_planes != nullptr)
      || (!planes && (dtype != kDtypeBF16 || D % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  if (planes) {
    const int dp_shift = D <= 64 ? 6 : D <= 128 ? 7 : 8;
    const long long rq = (long long)B * Sq * H, rk = (long long)B * Sk * H;
    int rc = 0;
    if (dtype == kDtypeF32) {
      rc = split<float, kPlanesF32>(q, q_planes, rq, D, dp_shift, st);
      if (rc == 0) rc = split<float, kPlanesF32>(k, k_planes, rk, D, dp_shift, st);
      if (rc == 0) rc = split<float, kPlanesF32>(v, v_planes, rk, D, dp_shift, st);
    } else {
      rc = split<bf16, 1>(q, q_planes, rq, D, dp_shift, st);
      if (rc == 0) rc = split<bf16, 1>(k, k_planes, rk, D, dp_shift, st);
      if (rc == 0) rc = split<bf16, 1>(v, v_planes, rk, D, dp_shift, st);
    }
    if (rc != 0) return rc;
    q = q_planes;
    k = k_planes;
    v = v_planes;
  }
  if (dtype == kDtypeF32)
    return dispatch<kPlanesF32>(q, k, v, out, B, Sq, Sk, H, D, scale, planes, st);
  return dispatch<1>(q, k, v, out, B, Sq, Sk, H, D, scale, planes, st);
}
