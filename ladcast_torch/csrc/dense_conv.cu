// Dense kh x kw convolution, NHWC x HWIO, as an implicit GEMM (forward).
//
// Replaces: ladcast_tpu/ops/pallas/dense_conv.py:83 _kernel (launched by
// _pallas_dense, :172; public entry dense_conv, :232).
//
// Inputs: x (B, H, W, Cin) and the weight w[dy, dx, c, o], both bf16 or
// both fp32, contiguous: bf16 in this kernel's packed layout (below), fp32
// HWIO (kh, kw, Cin, Cout). out[b, h, w, o] = sum over (dy, dx, c) of
// xp[b, h + dy, w + dx, c] * w[dy, dx, c, o], where xp is x padded by
// (ph0, ph1) zero rows in H and, in W, either by (pw0, pw1) zero columns or
// circularly (the sphere's longitude wrap: column (w + dx - pw0) mod W). No
// padded copy exists: an out-of-range row or column reads as zero inside
// the kernel, a wrapped column is an index. fp32 accumulation, one cast at
// the store.
//
// Bound on an H100: the DCAE's 3x3 convs do 2*9*Cin*Cout flop per output
// pixel. At B=80 frames, (120, 240, 252) -> 252 is 2.6e12 flop, 2.7 ms at
// 989 TFLOP/s bf16, against 2.3 GB of x, w and out (0.7 ms): operations
// bound, as every conv of 252 channels and more is. Only (.., 89) -> 252
// and 252 -> 89 sit near the ridge.
// Design (bf16): warp-specialised wgmma on Hopper (sm_90a), one block of
// three warpgroups per (M tile of at most 128 output pixels of one frame,
// N tile of output channels): two consumer warpgroups of 64 pixel rows
// each, which share the work (both multiply every B tile, each for its own
// 64 rows; no turns), and a producer warpgroup; setmaxnreg moves registers
// from the producer (56 a thread) to the consumers (224). What it does
// about the four limits of the mma.sync design it replaced (8 warps of
// 64 x 32 on 128 x 128 tiles, every tap's A tile gathered from L2):
//  1. Re-gathering: the M tile is TR whole output rows of TC columns (W <=
//     128: W = 30 is 4 rows, 60 is 2, 120 is 1, 120 pixels each; W = 240
//     is two tiles of half a row), so 8 of the 128 rows stay idle at those
//     widths. For each step of 64 input channels the producer copies once
//     the strip of input pixels that the tile's taps touch: TR + kh - 1
//     rows of TC + kw - 1 columns, rows outside H zero-filled, the W pads
//     zero or, circular, the wrapped columns themselves (an index at the
//     copy). All kh * kw taps then read their A from that strip: tap (dy,
//     dx) of tile pixel (r, c) is strip pixel (r + dy, c + dx), so the
//     shift, the row ends and the wrap are address arithmetic in the
//     consumers' ldmatrix (per-lane row addresses), as the TPU kernel
//     derives its taps from one halo'd tile. The N tile is as wide as the
//     output allows, up to wgmma's 256 (96 for <= 96 outputs, 128 for <=
//     128), so Cout = 252 is one N tile and a strip is copied once per M
//     tile, not once per 128 outputs.
//  2. Tensor-core rate: the products are wgmma.m64nNk16 (bf16 in, fp32
//     accumulate), A from registers (ldmatrix of the strip: the fragment of
//     mma.sync's m16n8k16, per warp), B from shared memory by descriptor,
//     K-major in the 128-byte swizzle. A consumer loads a tap's A once its
//     previous tap's products have retired (loaded while they run, ptxas
//     serialises all products: its note C7513); the other consumer's
//     products keep the tensor cores busy meanwhile.
//  3. Copies: no consumer thread copies. Producer warp 0 (one thread)
//     loads B tiles, each one bulk copy (cp.async.bulk) into a ring of 3 to
//     8 stages; warps 1-3 copy the strips with cp.async into a ring of 2
//     stages and signal each stage's "full" mbarrier with
//     cp.async.mbarrier.arrive.noinc. Each ring has its own "full" and
//     "empty" mbarriers; a consumer warp frees a B stage once the products
//     that read it have retired and a strip stage after its last tap's
//     ldmatrix. The loop runs over channel steps and, inside each, the
//     kh * kw taps.
//  4. TMA does not fit: activations of 84, 89, 126 or 252 channels have
//     pixel strides of 168, 178, 252 or 504 bytes, no multiple of 16, and
//     HWIO weights of those output counts the same row strides. So the
//     strip's copies are cp.async of 16, 8 or 4 bytes, as wide as the
//     channel count keeps a pixel aligned, and 2 bytes synchronously for an
//     odd count (89); and the weight is packed once per weight version
//     (ops/dense_conv.py pack_dense_weight) into this kernel's own layout:
//     for each N tile, channel step and tap, in the loop's order, a (BN,
//     64) tile K-major (64 input channels of one output contiguous),
//     zero-padded to the N tile and to whole steps, pre-swizzled, so each
//     stage is one contiguous bulk copy.
// Shared memory: the strip ring (2 x (TR + 2) x (TC + 2) pixels of 144
// bytes: a 64-channel row padded by 16 bytes against ldmatrix bank
// conflicts; 105 KB at W = 240 and 120, 71 KB at 60, 55 KB at 30) and the B
// ring, BN x 128 bytes a stage, as many stages as the rest of the 227 KB
// holds, up to 8 (at BN = 256: 3 beside the 105 KB strips, 4 at W = 60, 5
// at W = 30; 7 or 8 at BN = 96 and 128): one block per SM. The epilogue stores bf16 pairs straight from the accumulator
// fragments (rows of 252 channels are 504 bytes: no TMA store); padded
// rows and columns are not stored. Not done: a split of the channel steps
// for the small grids at B = 1 (the encoder's (15, 30, 1008) -> 84 is 4
// blocks), a TMA store, a persistent grid.
// fp32 (the parity dtype) runs an FMA kernel on the CUDA cores: 64 x 64
// tiles, 4 x 4 outputs per thread, K in steps of 16.

#include <algorithm>

#include "hopper.cuh"

namespace {

namespace hp = ladcast::hopper;
using bf16 = __nv_bfloat16;
using ladcast::cp_async16_zfill;

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

struct ConvShape {
  int H, W, Cin, Cout, kh, kw, ph0, pw0, Ho, Wo, circular;
};

// The input column read by output column `ow` through tap column `dx`, or
// -1 where the tap lands on zero padding.
__device__ __forceinline__ int in_col(const ConvShape& s, int ow, int dx) {
  const int iw = ow + dx - s.pw0;
  // the caller keeps the W pads within W, so one step wraps
  if (s.circular) return iw < 0 ? iw + s.W : (iw >= s.W ? iw - s.W : iw);
  return (iw >= 0 && iw < s.W) ? iw : -1;
}

// ----------------------------------------------------------------- bf16 ---
constexpr int BK = 64;                  // input channels per step
constexpr int WM = 64;                  // pixel rows per consumer warpgroup
constexpr int BM = 2 * WM;              // pixel rows per block
constexpr int kThreads = 3 * 128;       // consumers 0 and 1, producer 2
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kMaxBStages = 8, kStripStages = 2;
constexpr int kStripThreads = 96;       // producer warps 1-3
constexpr int kRowBytes = BK * 2;       // a B tile row: 64 channels of one output
constexpr int kPixBytes = kRowBytes + 16;  // a strip pixel, padded
constexpr int kSmemLimit = 232448;      // the most a block may ask for

// The M tile and its strip, chosen by the launcher (plan()).
struct Tiling {
  int TR, TC;              // output rows and columns of the M tile, TR * TC <= BM
  int SW;                  // strip pixels per strip row: TC + kw - 1
  int n_col_tiles;         // M tiles across Wo
  int strip_bytes;         // one strip stage: (TR + kh - 1) * SW * kPixBytes
  int b_stages;            // B tiles in the ring: as many as shared memory holds, <= 8
};

// The widest copy that a row of `channels` bf16 values keeps aligned:
// 8, 4, 2 or 1 values (16, 8, 4 or 2 bytes).
__device__ __forceinline__ int copy_width(int channels) {
  return (channels % 8 == 0) ? 8 : (channels % 4 == 0) ? 4 : (channels % 2 == 0) ? 2 : 1;
}

// 8 values of `src` (those below `n_valid`; the rest zero) into 16 aligned
// bytes of shared memory, in asynchronous copies of `width` values, which
// divides the row length (so a copy is all inside the row or all outside);
// width 1 reads 2 bytes at a time and stores synchronously. `src` is read
// only where values are valid; `safe` is any address inside the tensor.
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* src, const bf16* safe,
                                           int n_valid, int width) {
  if (width == 8) {
    cp_async16_zfill(dst, n_valid > 0 ? src : safe, n_valid > 0);
  } else if (width == 4) {
#pragma unroll
    for (int e = 0; e < 8; e += 4)
      ladcast::cp_async_small_zfill<8>(dst + e, e < n_valid ? src + e : safe, e < n_valid);
  } else if (width == 2) {
#pragma unroll
    for (int e = 0; e < 8; e += 2)
      ladcast::cp_async_small_zfill<4>(dst + e, e < n_valid ? src + e : safe, e < n_valid);
  } else {
    __align__(16) bf16 tmp[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) tmp[e] = (e < n_valid) ? src[e] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(tmp);
  }
}

template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t a[4],
                                         uint64_t b_desc) {
  if constexpr (BN == 256) hp::wgmma_m64n256k16_rs(d, a, b_desc, 1);
  else if constexpr (BN == 128) hp::wgmma_m64n128k16_rs(d, a, b_desc, 1);
  else hp::wgmma_m64n96k16_rs(d, a, b_desc, 1);
}

// x (B, H, W, Cin); wp the packed weight: for N tile nt, channel step cs
// and tap (dy, dx), in that order, a (BN, 64) tile whose row n holds input
// channels 64 cs .. 64 cs + 63 of output BN nt + n, its 16-byte chunk j
// stored at chunk j ^ (n % 8) (the 128-byte swizzle of a wgmma K-major
// operand); zero past Cin and Cout. Grid: (N tiles, M tiles of a frame, B).
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_bf16_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                       bf16* __restrict__ out, ConvShape s, Tiling t) {
  constexpr int kBTileBytes = BN * kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  // swizzled B tiles start on 1024-byte boundaries
  unsigned char* sB = smem_raw + ((1024 - (hp::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sS = sB + t.b_stages * kBTileBytes;
  uint64_t* full_b = reinterpret_cast<uint64_t*>(sS + kStripStages * t.strip_bytes);
  uint64_t* empty_b = full_b + kMaxBStages;
  uint64_t* full_s = empty_b + kMaxBStages;
  uint64_t* empty_s = full_s + kStripStages;

  const int wg = threadIdx.x / 128;
  const int oh0 = (blockIdx.y / t.n_col_tiles) * t.TR;
  const int ow0 = (blockIdx.y % t.n_col_tiles) * t.TC;
  const int b = blockIdx.z;
  const int taps = s.kh * s.kw;
  const int n_steps = (s.Cin + BK - 1) / BK;
  const int n_iters = n_steps * taps;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxBStages; ++i) {
      hp::mbar_init(&full_b[i], 1);
      hp::mbar_init(&empty_b[i], 8);  // one arrival per consumer warp
    }
#pragma unroll
    for (int i = 0; i < kStripStages; ++i) {
      hp::mbar_init(&full_s[i], kStripThreads);
      hp::mbar_init(&empty_s[i], 8);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ---- producer
    hp::setmaxnreg_dec<kProducerRegs>();
    const int pt = threadIdx.x - 2 * 128;
    if (pt == 0) {  // B tiles: one bulk copy each
      const bf16* src = wp + (long long)blockIdx.x * n_iters * BN * BK;
      int st = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_iters; ++it) {
        hp::mbar_wait(&empty_b[st], phase ^ 1);
        hp::mbar_arrive_expect_tx(&full_b[st], kBTileBytes);
        hp::bulk_load(sB + st * kBTileBytes, src + (long long)it * BN * BK, kBTileBytes,
                      &full_b[st]);
        if (++st == t.b_stages) {
          st = 0;
          phase ^= 1;
        }
      }
    } else if (pt >= 32) {  // strips: thread q copies chunk q % 8 of pixels q / 8 + 12 i
      const int q = pt - 32, chunk = q & 7;
      const int rows = min(t.TR, s.Ho - oh0) + s.kh - 1;   // strip rows any output reads
      const int cols = min(t.TC, s.Wo - ow0) + s.kw - 1;
      const int n_pix = rows * t.SW;
      const int width = copy_width(s.Cin);
      const bf16* xb = x + (long long)b * s.H * s.W * s.Cin;
      for (int cs = 0; cs < n_steps; ++cs) {
        const int st = cs % kStripStages;
        hp::mbar_wait(&empty_s[st], ((cs / kStripStages) & 1) ^ 1);
        unsigned char* dst = sS + st * t.strip_bytes + chunk * 16;
        const int c = cs * BK + chunk * 8;
        int sr = (q >> 3) / t.SW, sc = (q >> 3) % t.SW;
        for (int px = q >> 3; px < n_pix; px += kStripThreads / 8) {
          const int ih = oh0 - s.ph0 + sr;
          const int iw = in_col(s, ow0, sc);
          const bool ok = sc < cols && ih >= 0 && ih < s.H && iw >= 0;
          // an offset inside one frame fits 32 bits (the launcher checks)
          const bf16* src = xb + (ih * s.W + iw) * s.Cin + c;
          copy_chunk(reinterpret_cast<bf16*>(dst + px * kPixBytes), src, xb,
                     ok ? s.Cin - c : 0, width);
          sc += kStripThreads / 8;
          while (sc >= t.SW) { sc -= t.SW; ++sr; }
        }
        if (width == 1) hp::mbar_arrive(&full_s[st]);  // synchronous stores
        else hp::cp_async_mbar_arrive_noinc(&full_s[st]);
      }
      // no thread leaves with copies in flight
      ladcast::cp_async_commit();
      ladcast::cp_async_wait<0>();
    }
    return;
  }

  // ---- consumers 0 and 1: pixel rows 64 wg .. 64 wg + 63 of the M tile
  hp::setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  // This lane's ldmatrix row: tile pixel m = (r, c) reads strip pixel
  // (r + dy, c + dx) through tap (dy, dx); an idle row reads pixel 0.
  int pix0 = 0;
  {
    const int m = wg * WM + warp * 16 + (lane & 15), r = m / t.TC, c = m % t.TC;
    if (r < t.TR && oh0 + r < s.Ho && ow0 + c < s.Wo) pix0 = r * t.SW + c;
  }
  const uint32_t a_lane = hp::smem_addr(sS) + pix0 * kPixBytes + (lane >> 4) * 16;
  const uint64_t desc_b = hp::smem_desc_sw128(sB, 16, 1024);
  constexpr uint64_t kDescStage = kBTileBytes / 16, kDescK16 = 32 / 16;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // The K loop: channel steps, and the kh * kw taps inside each. A tap's A
  // fragments (4 k-steps of 16 channels) are loaded once its previous
  // products have retired: ptxas serialises the products when their input
  // registers are written while a product is in flight. The other consumer's
  // products fill the tensor cores meanwhile.
  uint32_t a[16];
  int cs = 0, tap = 0, dy = 0, dx = 0, bst = 0;
  uint32_t b_phase = 0;
  for (int it = 0; it < n_iters; ++it) {
    const int sst = cs % kStripStages;
    if (tap == 0) hp::mbar_wait(&full_s[sst], (cs / kStripStages) & 1);
    const uint32_t a_addr = a_lane + sst * t.strip_bytes + (dy * t.SW + dx) * kPixBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hp::ldmatrix_x4_at(&a[4 * kk], a_addr + kk * 32);
    if (tap == taps - 1) {  // this warp is done with the strip stage
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty_s[sst]);
    }
    hp::mbar_wait(&full_b[bst], b_phase);
    hp::fence_regs(a);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<BN>(acc, &a[4 * kk], desc_b + bst * kDescStage + kk * kDescK16);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    if (lane == 0) hp::mbar_arrive(&empty_b[bst]);  // this warp is done with the B stage
    if (++bst == t.b_stages) {
      bst = 0;
      b_phase ^= 1;
    }
    if (++dx == s.kw) {
      dx = 0;
      if (++dy == s.kh) dy = 0;
    }
    if (++tap == taps) {
      tap = 0;
      ++cs;
    }
  }

  // Thread t holds, for n-block j, acc[4j + i] at pixel row 16 warp + lane / 4
  // + 8 (i / 2) and output n0 + 8j + 2 (lane % 4) + i % 2.
  const int n0 = blockIdx.x * BN;
  const bool pair = (s.Cout % 2) == 0;  // 4-byte aligned bf16 pairs
  bf16* ob = out + (long long)b * s.Ho * s.Wo * s.Cout;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = wg * WM + warp * 16 + (lane >> 2) + 8 * h, r = m / t.TC, c = m % t.TC;
    const int oh = oh0 + r, ow = ow0 + c;
    if (r >= t.TR || oh >= s.Ho || ow >= s.Wo) continue;
    bf16* dst = ob + (oh * s.Wo + ow) * s.Cout + n0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n >= s.Cout) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pair) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(v0, v1);
      } else {
        dst[8 * j] = __float2bfloat16(v0);
        if (n + 1 < s.Cout) dst[8 * j + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// The M tile for a shape: whole output rows where Wo <= BM, else the
// fewest column tiles of equal width; narrower while the rings would not
// fit in shared memory with at least 3 B stages. The B ring then takes
// what the strips leave, up to 8 stages: a tile of N = 96 is a tenth of
// the products of one of 256, and needs the deeper look-ahead. Returns the
// block's dynamic shared memory.
int plan(const ConvShape& s, int bn, Tiling* t) {
  const int fixed = 1024 + 2 * (kMaxBStages + kStripStages) * 8;  // alignment, barriers
  for (int n_ct = (s.Wo + BM - 1) / BM;; n_ct *= 2) {
    t->TC = (s.Wo + n_ct - 1) / n_ct;
    t->n_col_tiles = (s.Wo + t->TC - 1) / t->TC;
    t->TR = std::min(BM / t->TC, s.Ho);
    t->SW = t->TC + s.kw - 1;
    t->strip_bytes = (t->TR + s.kh - 1) * t->SW * kPixBytes;
    const int left = kSmemLimit - fixed - kStripStages * t->strip_bytes;
    t->b_stages = std::min(kMaxBStages, left / (bn * kRowBytes));
    if (t->b_stages >= 3)
      return fixed + kStripStages * t->strip_bytes + t->b_stages * bn * kRowBytes;
    if (t->TC == 1) return -1;
  }
}

template <int BN>
int launch_bf16(const bf16* x, const bf16* wp, bf16* out, int B, const ConvShape& s,
                cudaStream_t st) {
  Tiling t;
  const int smem = plan(s, BN, &t);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const long long m_tiles = (long long)((s.Ho + t.TR - 1) / t.TR) * t.n_col_tiles;
  if (m_tiles > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_bf16_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((s.Cout + BN - 1) / BN, (unsigned)m_tiles, B);
  conv_bf16_wgmma_kernel<BN><<<grid, kThreads, smem, st>>>(x, wp, out, s, t);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- fp32 ---
constexpr int FM = 64, FN = 64, FK = 16, kFThreads = 256;
constexpr int LFA = FM + 4, LFB = FN + 4;  // k-major tiles, padded rows

__global__ void __launch_bounds__(kFThreads)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, ConvShape s) {
  __shared__ __align__(16) float sA[FK * LFA];  // [k][pixel]
  __shared__ __align__(16) float sB[FK * LFB];  // [k][cout]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * FM, n0 = blockIdx.y * FN;
  const int b = blockIdx.z;
  const int n_pix = s.Ho * s.Wo;
  const float* xb = x + (long long)b * s.H * s.W * s.Cin;

  // A loads: thread -> channel tid % 16 of pixels tid / 16 + 16 i
  const int a_k = tid & 15;
  int a_oh[4], a_ow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = m0 + (tid >> 4) + i * 16;
    a_oh[i] = (p < n_pix) ? p / s.Wo : -1;
    a_ow[i] = (p < n_pix) ? p % s.Wo : 0;
  }
  // B loads: thread -> cout tid % 64 of channels tid / 64 + 4 i
  const int b_n = tid & 63;

  const int ty = (tid >> 4) * 4, tx = (tid & 15) * 4;  // 4 x 4 outputs
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_c = (s.Cin + FK - 1) / FK;
  const int n_k = s.kh * s.kw * n_c;
  for (int kt = 0; kt < n_k; ++kt) {
    const int tap = kt / n_c, c0 = (kt % n_c) * FK;
    const int dy = tap / s.kw, dx = tap % s.kw;
    __syncthreads();  // the previous step's tiles are consumed
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ih = a_oh[i] + dy - s.ph0;
      const int iw = in_col(s, a_ow[i], dx);
      const int c = c0 + a_k;
      float v = 0.f;
      if (a_oh[i] >= 0 && ih >= 0 && ih < s.H && iw >= 0 && c < s.Cin)
        v = xb[((long long)ih * s.W + iw) * s.Cin + c];
      sA[a_k * LFA + (tid >> 4) + i * 16] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = (tid >> 6) + i * 4;
      const int ck = c0 + kk, n = n0 + b_n;
      float v = 0.f;
      if (ck < s.Cin && n < s.Cout) v = w[((long long)tap * s.Cin + ck) * s.Cout + n];
      sB[kk * LFB + b_n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(sA + kk * LFA + ty);
      const float4 bb = *reinterpret_cast<const float4*>(sB + kk * LFB + tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* ob = out + (long long)b * n_pix * s.Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = m0 + ty + i;
    if (p >= n_pix) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + tx + j < s.Cout) ob[(long long)p * s.Cout + n0 + tx + j] = acc[i][j];
  }
}

}  // namespace

// x (B, H, W, Cin), out (B, Ho, Wo, Cout), contiguous, one dtype; w is, in
// bf16, the packed weight of N tile `bn` (96, 128 or 256; see
// conv_bf16_wgmma_kernel), in fp32 HWIO (kh, kw, Cin, Cout). Ho = H + ph0 +
// ph1 - kh + 1 and Wo likewise (Wo = W when circular), computed by the
// caller. Returns cudaGetLastError().
extern "C" int ladcast_dense_conv(const void* x, const void* w, void* out, int B,
                                  int H, int W, int Cin, int Cout, int kh, int kw,
                                  int ph0, int pw0, int Ho, int Wo, int circular,
                                  int bn, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ConvShape s{H, W, Cin, Cout, kh, kw, ph0, pw0, Ho, Wo, circular};
  const long long n_pix = (long long)Ho * Wo;
  if (B > 65535) return (int)cudaErrorInvalidValue;  // grid.z
  // 32-bit offsets inside one frame and inside the fp32 weights
  if ((long long)H * W * Cin > 2147483647LL || n_pix * Cout > 2147483647LL ||
      (long long)kh * kw * Cin * Cout > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (dtype == kDtypeBF16) {
    const bf16* xp = static_cast<const bf16*>(x);
    const bf16* wp = static_cast<const bf16*>(w);
    bf16* op = static_cast<bf16*>(out);
    switch (bn) {
      case 96: return launch_bf16<96>(xp, wp, op, B, s, st);
      case 128: return launch_bf16<128>(xp, wp, op, B, s, st);
      case 256: return launch_bf16<256>(xp, wp, op, B, s, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == kDtypeF32) {
    const dim3 grid((unsigned)((n_pix + FM - 1) / FM), (Cout + FN - 1) / FN, B);
    conv_f32_kernel<<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), s);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
