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
// Design (bf16): the FA3 shape on Hopper (sm_90a). One block of three
// warpgroups per (128-row Q tile, b*head): two consumer warpgroups of 64 Q
// rows each, and a producer warpgroup whose one thread issues the TMA loads;
// setmaxnreg moves registers from the producer (24 a thread) to the
// consumers (240). What it does about the four limits of the mma.sync
// design it replaced (4 warps of 16 rows, cp.async tiles of 64 keys):
//  1. Tensor-core rate: both products are wgmma.m64n128k16 (bf16 in, fp32
//     accumulate) issued by a whole warpgroup. S = Q.K^T reads Q and K from
//     shared memory, K-major (D is contiguous). O += P.V takes P from
//     registers: the fp32 S accumulator of an m64nN product is laid out as
//     the A fragment of the next, so P is S rescaled, exponentiated and
//     packed to bf16x2 in place. V is read MN-major through the
//     descriptor's transpose bit and is never transposed in memory.
//  2. Shared-memory reads: a wgmma reads a K or V tile once per 64 rows,
//     where ldmatrix reloaded it once per warp of 16 rows (4x the traffic).
//  3. Softmax overlap: the two consumers take turns issuing their products
//     (named barriers 1 and 2, "ping-pong"), so that one's exp2 softmax runs
//     while the other's products occupy the tensor cores. Not done:
//     intra-warpgroup pipelining (issuing the next tile's Q.K^T with this
//     tile's P.V, so that a consumer's softmax also overlaps its own
//     products); a first version of it, on a 3-stage ring, ran slower than
//     this loop on the H100.
//  4. Copies: no consumer thread copies K or V. The producer streams tiles
//     of 128 keys by TMA into a ring of kStages stages; each stage has a
//     "full" mbarrier for K and one for V (expect_tx byte counts) and an
//     "empty" one that each consumer warp arrives on once the P.V that read
//     the stage has retired. The 4-D tensor maps over (D, H, S, B), with a
//     box of (64, 1, 128, 1) and 128-byte swizzle (two boxes per head row),
//     zero-fill the ragged last tile (2250 = 17*128 + 74) instead of reading
//     the next batch's rows. Keys >= Sk are still masked to -1e30 in the
//     softmax; the zero-filled V rows keep 0 * garbage out of the sum.
// The Q prologue runs in the consumers: a warp per row (kQBatch rows' loads
// in flight at once) norms, rotates and scales it in fp32 (norm_rope4) and
// writes bf16 into shared memory in the 128-byte-swizzled K-major layout
// that TMA gives K, then fences the async proxy before the first wgmma. Shared memory rather than
// register A fragments, so that Q costs no registers beside the 64 + 64 + 32
// of S, O and P, and Q and K share one descriptor form. Rows >= Sq are zero
// and are not stored. The epilogue divides by l and stores bf16x2 pairs
// straight from the fragments (no TMA store), and writes the lse rows.
// Shared memory: Q 32 KB + 2 stages x (K + V) 128 KB = 160 KB, one block
// per SM; at S=2250, B=20 the grid is 18 x 240 blocks.
// fp32 (the parity dtype, and `train_ar --compute_dtype float32`): wgmma
// has no fp32 inputs and TF32 would round every product, so the products
// run on bf16 terms, as in the plain flash attention (K6, flash_plain.cu):
// a split pass (fa_f32_split_kernel, its time part of the kernel's) norms,
// rotates and scales each Q row in fp32 (norm_rope4, as the prologue above)
// and writes it, kn and v as three bf16 planes each (hi, mid, lo, each the
// rounding to nearest of what the planes before it left); then
// fa_f32_wgmma_kernel runs K6's loop (flash_plain.cuh) at D = 128 on the
// planes: S sums the six plane products Qi.Kj^T with i + j <= 2, P is split
// in registers into three bf16 terms, and each 32-key tile's six Pi.Vj go
// into a fresh accumulator that is added to O in registers (one
// accumulator over all tiles is coarser than fp32 adds); its epilogue
// writes the lse rows. Bound: 6 bf16 passes of each product, 3.77 ms at B=20,
// S=2250 (against 9.29 ms for fp32 on the CUDA cores), beside about 2 GB of
// split traffic (0.6 ms). Shared memory: Q's three planes of 128 rows (96
// KB) and 2 stages of K and V planes (96 KB).

#include <math.h>

#include "flash_plain.cuh"
#include "hopper.cuh"
#include "norm_rope.cuh"

namespace {

namespace hp = ladcast::hopper;
using bf16 = __nv_bfloat16;
using ladcast::pack_bf16;
constexpr int D = ladcast::kHeadDim;
constexpr float kNegInf = -1e30f;  // as the TPU kernel: exp(kNegInf - m) == 0

// ----------------------------------------------------------------- bf16 ---
constexpr int WM = 64;                 // Q rows per consumer warpgroup
constexpr int BM = 2 * WM;             // Q rows per block
constexpr int BN = 128;                // keys per K/V tile
constexpr int kStages = 2;             // K/V tiles in the ring
constexpr int kQBatch = 8;             // Q rows a warp loads at once
constexpr int kThreads = 3 * 128;      // consumers 0 and 1, producer 2
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kRowBytes = 128;         // a swizzled row: half a head row
constexpr int kQBytes = WM * D * 2;    // one consumer's Q tile, 16 KB
constexpr int kTileBytes = BN * D * 2; // one K or V tile, 32 KB
constexpr int kSmemBf16 = 2 * kQBytes + 2 * kStages * kTileBytes
                          + 3 * kStages * 8 + 1024;  // + barriers, alignment
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Descriptor offsets, in the 16-byte units of the start address field.
constexpr uint64_t kDescHalfQ = WM * kRowBytes / 16;   // Q's second half row
constexpr uint64_t kDescHalfK = BN * kRowBytes / 16;   // a tile's second half
constexpr uint64_t kDescStage = kTileBytes / 16;
constexpr uint64_t kDescK16 = 32 / 16;                 // 16 bf16 along D
constexpr uint64_t kDescKeys16 = 16 * kRowBytes / 16;  // 16 keys of V

__global__ void __launch_bounds__(kThreads, 1)
fa_bf16_wgmma_kernel(__grid_constant__ const CUtensorMap tm_k,
                     __grid_constant__ const CUtensorMap tm_v,
                     const bf16* __restrict__ q, const float* __restrict__ qcos,
                     const float* __restrict__ qsin, const float* __restrict__ qw,
                     bf16* __restrict__ out, float* __restrict__ lse, int Sq,
                     int Sk, int H, float eps, float scale) {
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  unsigned char* sQ = smem_raw + ((1024 - (hp::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sQ + 2 * kQBytes;
  unsigned char* sV = sK + kStages * kTileBytes;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sV + kStages * kTileBytes);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n_tiles = (Sk + BN - 1) / BN;

  if (threadIdx.x == 0) {
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
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        hp::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(&full_k[s], kTileBytes);
        unsigned char* k_dst = sK + s * kTileBytes;
        hp::tma_load_4d(k_dst, &tm_k, &full_k[s], 0, h, kt * BN, b);
        hp::tma_load_4d(k_dst + kTileBytes / 2, &tm_k, &full_k[s], 64, h, kt * BN, b);
        hp::mbar_arrive_expect_tx(&full_v[s], kTileBytes);
        unsigned char* v_dst = sV + s * kTileBytes;
        hp::tma_load_4d(v_dst, &tm_v, &full_v[s], 0, h, kt * BN, b);
        hp::tma_load_4d(v_dst + kTileBytes / 2, &tm_v, &full_v[s], 64, h, kt * BN, b);
      }
    }
    return;
  }

  // ---- consumers 0 and 1: 64 Q rows each
  hp::setmaxnreg_inc<kConsumerRegs>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const long long rs = (long long)H * D;  // elements between sequence rows
  unsigned char* sQw = sQ + wg * kQBytes;

  // Q prologue: norm + RoPE in fp32, scale, cast, into the swizzled layout
  // (16-byte chunk c of row r at chunk c ^ (r % 8)); padded rows are zero.
  // Warp w takes rows w, w + 4, ..., kQBatch at a time, every load of a
  // batch issued before the first is used: one row at a time, a warp's 16
  // rows would wait out 16 load latencies in a row.
  {
    const bf16* qb = q + ((long long)b * Sq * H + h) * D;
    const int half = lane >> 4, chunk = (lane & 15) >> 1;
    for (int i0 = 0; i0 < WM / 4; i0 += kQBatch) {
      float x[kQBatch][4], wv[kQBatch][4], c[kQBatch][4], sn[kQBatch][4];
#pragma unroll
      for (int i = 0; i < kQBatch; ++i) {
        const int s = q0 + wg * WM + warp + 4 * (i0 + i);
#pragma unroll
        for (int k = 0; k < 4; ++k) x[i][k] = wv[i][k] = c[i][k] = sn[i][k] = 0.f;
        if (s < Sq) {
          const long long tr = (long long)s * D + lane * 4;
          ladcast::load4(qb + s * rs + lane * 4, x[i]);
          ladcast::load4(qw + tr, wv[i]);
          ladcast::load4(qcos + tr, c[i]);
          ladcast::load4(qsin + tr, sn[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kQBatch; ++i) {
        const int r = warp + 4 * (i0 + i);
        if (q0 + wg * WM + r < Sq) {  // the same for the whole warp
          ladcast::norm_rope4(x[i], wv[i], c[i], sn[i], eps);
#pragma unroll
          for (int k = 0; k < 4; ++k) x[i][k] *= scale;
        }
        *reinterpret_cast<uint2*>(sQw + half * WM * kRowBytes + r * kRowBytes
                                  + ((chunk ^ (r & 7)) << 4) + (lane & 1) * 8) =
            make_uint2(pack_bf16(x[i][0], x[i][1]), pack_bf16(x[i][2], x[i][3]));
      }
    }
  }
  hp::fence_proxy_async();
  hp::named_sync(3 + wg, 128);
  if (wg == 1) hp::named_arrive(1, 256);  // consumer 0 takes the first turn

  const uint64_t desc_q = hp::smem_desc_sw128(sQw, 16, 1024);
  const uint64_t desc_k = hp::smem_desc_sw128(sK, 16, 1024);
  const uint64_t desc_v = hp::smem_desc_sw128(sV, kTileBytes / 2, 1024);
  const int my_turn = 1 + wg, their_turn = 2 - wg;

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  // running max (log2 units) and sum of this thread's rows r and r + 8
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float sc[64];
  uint32_t p[32];

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % kStages;
    const uint32_t parity = (kt / kStages) & 1;

    // S = Q K^T: 64 rows x 128 keys, 8 k-steps of 16 along D.
    hp::mbar_wait(&full_k[s], parity);
    hp::named_sync(my_turn, 256);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::wgmma_m64n128k16_ss(
          sc, desc_q + (kk >> 2) * kDescHalfQ + (kk & 3) * kDescK16,
          desc_k + s * kDescStage + (kk >> 2) * kDescHalfK + (kk & 3) * kDescK16,
          kk > 0);
    hp::wgmma_commit();
    hp::named_arrive(their_turn, 256);
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);

    // keys >= Sk (the ragged last tile) masked
    const int k0 = kt * BN;
    if (k0 + BN > Sk) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + 8 * j + 2 * (lane & 3) + (i & 1) >= Sk) sc[4 * j + i] = kNegInf;
    }
    // Online softmax in log2 units; a row's 128 scores are spread over a
    // quad of lanes. P goes to bf16 before P.V, l sums the fp32 values.
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
    mx0 = fmaxf(m0, mx0 * kLog2e);
    mx1 = fmaxf(m1, mx1 * kLog2e);
    const float a0 = hp::exp2_ftz(m0 - mx0), a1 = hp::exp2_ftz(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float p0 = hp::exp2_ftz(fmaf(sc[4 * j], kLog2e, -mx0));
      const float p1 = hp::exp2_ftz(fmaf(sc[4 * j + 1], kLog2e, -mx0));
      const float p2 = hp::exp2_ftz(fmaf(sc[4 * j + 2], kLog2e, -mx1));
      const float p3 = hp::exp2_ftz(fmaf(sc[4 * j + 3], kLog2e, -mx1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      p[2 * j] = pack_bf16(p0, p1);
      p[2 * j + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }

    // O += P V: 8 k-steps of 16 keys; P's k-step kk is n-blocks 2kk, 2kk+1
    // of S, that is p[4kk .. 4kk+3].
    hp::mbar_wait(&full_v[s], parity);
    hp::named_sync(my_turn, 256);
    hp::fence_regs(o);
    hp::fence_regs(p);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hp::wgmma_m64n128k16_rs_tnsp_b(o, &p[4 * kk],
                                     desc_v + s * kDescStage + kk * kDescKeys16, 1);
    hp::wgmma_commit();
    // every sync of one consumer is matched by one arrival of the other:
    // consumer 1 skips its last, consumer 0 had one from the start
    if (wg == 0 || kt + 1 < n_tiles) hp::named_arrive(their_turn, 256);
    hp::wgmma_wait<0>();
    hp::fence_regs(o);
    if (lane == 0) hp::mbar_arrive(&empty[s]);  // this warp is done with stage s
    __syncwarp();
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + wg * WM + warp * 16 + (lane >> 2), r1 = r0 + 8;
  bf16* ob = out + ((long long)b * Sq * H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * rs + col) =
          __floats2bfloat162_rn(o[4 * j] / l0, o[4 * j + 1] / l0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * rs + col) =
          __floats2bfloat162_rn(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
  }
  if (lse != nullptr && (lane & 3) == 0) {  // m is in log2 units
    float* lb = lse + ((long long)b * H + h) * Sq;
    if (r0 < Sq) lb[r0] = (m0 + log2f(l0)) * kLn2;
    if (r1 < Sq) lb[r1] = (m1 + log2f(l1)) * kLn2;
  }
}

// ----------------------------------------------------------------- fp32 ---
namespace fp = ladcast::flash_plain;
using F32 = fp::Cfg<D, fp::kPlanesF32>;  // K6's loop at D = 128, three planes
static_assert(fp::kPlanesF32 == ladcast::kPlanes, "one split for both");
constexpr int kSplitWarps = 8;           // rows a split block takes at once

struct SplitArgs {
  const float* x[3];  // q, kn, v: (B, Sq or Sk, H, 128)
  bf16* planes[3];    // each (3 B, Sq or Sk, H, 128)
  long long rows[3];  // B S H of each
};

// Every (b, s, head) row of q, kn and v (blockIdx.y 0, 1, 2) as three bf16
// planes: a warp per row, 4 values a lane. q's rows are normed, rotated and
// scaled in fp32 first, as the bf16 kernel's prologue does; kn and v are
// split as they are.
__global__ void __launch_bounds__(kSplitWarps * 32)
fa_f32_split_kernel(SplitArgs a, int Sq, int H, const float* __restrict__ qw,
                    const float* __restrict__ qcos, const float* __restrict__ qsin,
                    float eps, float scale) {
  const int which = blockIdx.y, lane = threadIdx.x % 32;
  const long long rows = a.rows[which];
  for (long long r = blockIdx.x * (long long)kSplitWarps + threadIdx.x / 32; r < rows;
       r += (long long)gridDim.x * kSplitWarps) {
    float x[4];
    ladcast::load4(a.x[which] + r * D + lane * 4, x);
    if (which == 0) {  // the same for the whole block
      const long long t = (r / H) % Sq * D;
      ladcast::norm_rope4(x, qw + t, qcos + t, qsin + t, lane, eps);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] *= scale;
    }
    ladcast::store_planes4(a.planes[which] + r * D + lane * 4, rows * D, x);
  }
}

// One block per (128 Q rows, b * H + h): K6's loop over the planes, Q
// already scaled, with the lse rows.
__global__ void __launch_bounds__(F32::kThreads, 1)
fa_f32_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                    __grid_constant__ const CUtensorMap tm_k,
                    __grid_constant__ const CUtensorMap tm_v, float* __restrict__ out,
                    float* __restrict__ lse, int B, int Sq, int Sk, int H) {
  fp::attention<D, fp::kPlanesF32>(tm_q, tm_k, tm_v, out, lse, B, Sq, Sk, H, D, 1.f);
}

// The fp32 path: the split pass, then the loop. `planes` is bf16 scratch of
// 3 * 128 * B * H * (Sq + 2 Sk) elements.
int fused_attention_f32(const float* q, const float* kn, const float* v,
                        const float* qcos, const float* qsin, const float* qw,
                        float* out, float* lse, bf16* planes, int B, int Sq, int Sk,
                        int H, float eps, float scale, cudaStream_t st) {
  const long long rq = (long long)B * Sq * H, rk = (long long)B * Sk * H;
  bf16* pq = planes;
  bf16* pk = pq + fp::kPlanesF32 * rq * D;
  bf16* pv = pk + fp::kPlanesF32 * rk * D;
  const SplitArgs a{{q, kn, v}, {pq, pk, pv}, {rq, rk, rk}};
  const long long blocks = ((rq > rk ? rq : rk) + kSplitWarps - 1) / kSplitWarps;
  fa_f32_split_kernel<<<dim3((unsigned)(blocks < 2112 ? blocks : 2112), 3),
                        kSplitWarps * 32, 0, st>>>(a, Sq, H, qw, qcos, qsin, eps, scale);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  // plane p of batch b is batch p B + b of each map
  CUtensorMap tm_q, tm_k, tm_v;
  rc = hp::encode_bshd_bf16(&tm_q, pq, fp::kPlanesF32 * B, Sq, H, D, fp::kRows);
  if (rc == 0) rc = hp::encode_bshd_bf16(&tm_k, pk, fp::kPlanesF32 * B, Sk, H, D, F32::BN);
  if (rc == 0) rc = hp::encode_bshd_bf16(&tm_v, pv, fp::kPlanesF32 * B, Sk, H, D, F32::BN);
  if (rc != 0) return rc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_f32_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F32::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + F32::kBlockRows - 1) / F32::kBlockRows, B * H);
  fa_f32_wgmma_kernel<<<grid, F32::kThreads, F32::kSmem, st>>>(tm_q, tm_k, tm_v, out, lse,
                                                                B, Sq, Sk, H);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, Sq, H, 128); kn, v: (B, Sk, H, 128); contiguous, one dtype;
// lse: null, or (B, H, Sq) fp32; planes: null for bf16 inputs, bf16
// scratch of 3 * 128 * B * H * (Sq + 2 Sk) elements for fp32 ones. Returns
// cudaGetLastError(), or the driver's error code when a tensor map cannot
// be encoded.
extern "C" int ladcast_fused_attention(const void* q, const void* kn, const void* v,
                                       const float* qcos, const float* qsin,
                                       const float* qw, void* out, float* lse,
                                       void* planes, int B, int Sq, int Sk, int H,
                                       float eps, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ladcast::kDtypeF32) {
    if (planes == nullptr) return (int)cudaErrorInvalidValue;
    return fused_attention_f32(static_cast<const float*>(q), static_cast<const float*>(kn),
                               static_cast<const float*>(v), qcos, qsin, qw,
                               static_cast<float*>(out), lse, static_cast<bf16*>(planes),
                               B, Sq, Sk, H, eps, scale, st);
  }
  if (dtype != ladcast::kDtypeBF16) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_k, tm_v;
  int rc = hp::encode_bshd_bf16(&tm_k, kn, B, Sk, H, D, BN);
  if (rc != 0) return rc;
  rc = hp::encode_bshd_bf16(&tm_v, v, B, Sk, H, D, BN);
  if (rc != 0) return rc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_bf16_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBf16);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + BM - 1) / BM, B * H);
  fa_bf16_wgmma_kernel<<<grid, kThreads, kSmemBf16, st>>>(
      tm_k, tm_v, static_cast<const bf16*>(q), qcos, qsin, qw,
      static_cast<bf16*>(out), lse, Sq, Sk, H, eps, scale);
  return (int)cudaGetLastError();
}
