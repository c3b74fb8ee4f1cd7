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
// The loop lives in flash_plain.cuh, which the fp32 fused attention
// (fused_attention.cu) runs too, on the planes of its normed Q.

#include "flash_plain.cuh"

namespace {

using namespace ladcast::flash_plain;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kSplitThreads = 256;

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

// One block per (kBlockRows Q rows, b * H + h): the loop of flash_plain.cuh.
template <int DP, int NP>
__global__ void __launch_bounds__(Cfg<DP, NP>::kThreads, 1)
fa_plain_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                      __grid_constant__ const CUtensorMap tm_k,
                      __grid_constant__ const CUtensorMap tm_v,
                      typename Cfg<DP, NP>::TOut* __restrict__ out, int B, int Sq,
                      int Sk, int H, int D, float scale) {
  attention<DP, NP>(tm_q, tm_k, tm_v, out, nullptr, B, Sq, Sk, H, D, scale);
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
