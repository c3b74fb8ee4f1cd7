// Dense kh x kw convolution, NHWC x HWIO, as an implicit GEMM (forward).
//
// Replaces: ladcast_tpu/ops/pallas/dense_conv.py:83 _kernel (launched by
// _pallas_dense, :172; public entry dense_conv, :232).
//
// Inputs: x (B, H, W, Cin), bf16 or fp32, contiguous, and the weight
// w[dy, dx, c, o] in this kernel's packed bf16 layout (below; for fp32 x,
// three bf16 planes of the fp32 weight). out[b, h, w, o] = sum over (dy, dx, c) of
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
// fp32 (the scorer's decode and the parity checks) runs the same structure
// on three bf16 planes of each value, six plane products per product
// (conv_f32_wgmma_kernel, below): 6 bf16 passes, 3.99 ms at B = 20 for
// (120, 240, 252) -> 252 (N tiles of 128: as many products as one of 256),
// where the CUDA cores' fp32 rate gives 9.8 ms.

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

// The widest copy that a row of `channels` values of T keeps aligned, in
// values: 16, 8, 4 or 2 bytes (bf16: 8, 4, 2, 1 values; fp32: 4, 2, 1).
template <typename T>
__device__ __forceinline__ int copy_width(int channels) {
  constexpr int kVec = 16 / sizeof(T);
  return (channels % kVec == 0) ? kVec
         : (channels % (kVec / 2) == 0) ? kVec / 2
         : (kVec >= 4 && channels % (kVec / 4) == 0) ? kVec / 4 : 1;
}

// 16 bytes of `src` (the values below `n_valid`; the rest zero) into 16
// aligned bytes of shared memory, in asynchronous copies of `width` values,
// which divides the row length (so a copy is all inside the row or all
// outside); 2-byte values one at a time (bf16 at width 1) are read and
// stored synchronously. `src` is read only where values are valid; `safe`
// is any address inside the tensor.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, const T* safe,
                                           int n_valid, int width) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const int bytes = width * (int)sizeof(T);
  if (width == kVec) {
    cp_async16_zfill(dst, n_valid > 0 ? src : safe, n_valid > 0);
  } else if (bytes == 8) {
#pragma unroll
    for (int e = 0; e < kVec; e += 8 / (int)sizeof(T))
      ladcast::cp_async_small_zfill<8>(dst + e, e < n_valid ? src + e : safe, e < n_valid);
  } else if (bytes == 4) {
#pragma unroll
    for (int e = 0; e < kVec; e += 4 / (int)sizeof(T))
      ladcast::cp_async_small_zfill<4>(dst + e, e < n_valid ? src + e : safe, e < n_valid);
  } else {
    __align__(16) T tmp[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) tmp[e] = (e < n_valid) ? src[e] : T(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(tmp);
  }
}

// The strip producer (warps 1-3 of the producer warpgroup, `q` = 0..95):
// for each channel step of 128 bytes of values (64 bf16 or 32 fp32) one
// strip of the M tile's input pixels into the ring, thread q copying 16-byte
// chunk q % 8 of pixels q / 8 + 12 i; each stage's "full" mbarrier counts
// the 96 threads' arrivals once their copies have landed.
template <typename T>
__device__ __forceinline__ void copy_strips(const T* __restrict__ x, unsigned char* sS,
                                            uint64_t* full_s, uint64_t* empty_s,
                                            const ConvShape& s, const Tiling& t, int q,
                                            int oh0, int ow0, int b) {
  constexpr int kVec = 16 / (int)sizeof(T), kStep = 8 * kVec;
  const int chunk = q & 7;
  const int rows = min(t.TR, s.Ho - oh0) + s.kh - 1;   // strip rows any output reads
  const int cols = min(t.TC, s.Wo - ow0) + s.kw - 1;
  const int n_pix = rows * t.SW;
  const int n_steps = (s.Cin + kStep - 1) / kStep;
  const int width = copy_width<T>(s.Cin);
  const bool sync_copies = sizeof(T) == 2 && width == 1;
  const T* xb = x + (long long)b * s.H * s.W * s.Cin;
  for (int cs = 0; cs < n_steps; ++cs) {
    const int st = cs % kStripStages;
    hp::mbar_wait(&empty_s[st], ((cs / kStripStages) & 1) ^ 1);
    unsigned char* dst = sS + st * t.strip_bytes + chunk * 16;
    const int c = cs * kStep + chunk * kVec;
    int sr = (q >> 3) / t.SW, sc = (q >> 3) % t.SW;
    for (int px = q >> 3; px < n_pix; px += kStripThreads / 8) {
      const int ih = oh0 - s.ph0 + sr;
      const int iw = in_col(s, ow0, sc);
      const bool ok = sc < cols && ih >= 0 && ih < s.H && iw >= 0;
      // an offset inside one frame fits 32 bits (the launcher checks)
      const T* src = xb + (ih * s.W + iw) * s.Cin + c;
      copy_chunk<T>(reinterpret_cast<T*>(dst + px * kPixBytes), src, xb,
                    ok ? s.Cin - c : 0, width);
      sc += kStripThreads / 8;
      while (sc >= t.SW) { sc -= t.SW; ++sr; }
    }
    if (sync_copies) hp::mbar_arrive(&full_s[st]);
    else hp::cp_async_mbar_arrive_noinc(&full_s[st]);
  }
  // no thread leaves with copies in flight
  ladcast::cp_async_commit();
  ladcast::cp_async_wait<0>();
}

// d = a.b + d (scale_d 1) or a.b (scale_d 0)
template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t a[4],
                                         uint64_t b_desc, int scale_d = 1) {
  if constexpr (BN == 256) hp::wgmma_m64n256k16_rs(d, a, b_desc, scale_d);
  else if constexpr (BN == 128) hp::wgmma_m64n128k16_rs(d, a, b_desc, scale_d);
  else hp::wgmma_m64n96k16_rs(d, a, b_desc, scale_d);
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
    } else if (pt >= 32) {
      copy_strips<bf16>(x, sS, full_s, empty_s, s, t, pt - 32, oh0, ow0, b);
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
// fit in shared memory with at least `min_b_stages` B stages of
// `b_stage_bytes`. The B ring then takes what the strips leave, up to 8
// stages: a tile of N = 96 is a tenth of the products of one of 256, and
// needs the deeper look-ahead. Returns the block's dynamic shared memory.
int plan(const ConvShape& s, int b_stage_bytes, int min_b_stages, Tiling* t) {
  const int fixed = 1024 + 2 * (kMaxBStages + kStripStages) * 8;  // alignment, barriers
  for (int n_ct = (s.Wo + BM - 1) / BM;; n_ct *= 2) {
    t->TC = (s.Wo + n_ct - 1) / n_ct;
    t->n_col_tiles = (s.Wo + t->TC - 1) / t->TC;
    t->TR = std::min(BM / t->TC, s.Ho);
    t->SW = t->TC + s.kw - 1;
    t->strip_bytes = (t->TR + s.kh - 1) * t->SW * kPixBytes;
    const int left = kSmemLimit - fixed - kStripStages * t->strip_bytes;
    t->b_stages = std::min(kMaxBStages, left / b_stage_bytes);
    if (t->b_stages >= min_b_stages)
      return fixed + kStripStages * t->strip_bytes + t->b_stages * b_stage_bytes;
    if (t->TC == 1) return -1;
  }
}

// Sets the kernel's shared-memory limit and launches it on the grid of (N
// tiles, M tiles of a frame, B) that `plan` gives.
template <typename T, typename K>
int launch(K kernel, const T* x, const bf16* wp, T* out, int B, const ConvShape& s,
           int bn, int b_stage_bytes, int min_b_stages, cudaStream_t st) {
  Tiling t;
  const int smem = plan(s, b_stage_bytes, min_b_stages, &t);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const long long m_tiles = (long long)((s.Ho + t.TR - 1) / t.TR) * t.n_col_tiles;
  if (m_tiles > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((s.Cout + bn - 1) / bn, (unsigned)m_tiles, B);
  kernel<<<grid, kThreads, smem, st>>>(x, wp, out, s, t);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- fp32 ---
// The bf16 kernel's structure on fp32 values: products of bf16 values are
// exact in fp32, so each fp32 value v is carried by three bf16 planes, each
// rounded to nearest, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
// mid), whose sum is v (8 + 8 + 8 significant bits), and every product of
// x and w is six plane products on the tensor cores, the smallest first:
// lo.Whi, hi.Wlo, mid.Wmid, mid.Whi, hi.Wmid, hi.Whi (the three dropped
// ones are below 2^-24 of it). What differs from the bf16 kernel:
//  - Channel steps of 32: a strip pixel of 32 fp32 values is 128 bytes
//    padded to 144, the bf16 strip's size, so the strip ring is as large
//    (105 KB at W = 240); a 64-channel fp32 strip (272-byte pixels) would
//    leave no room for the weight ring at W = 240.
//  - The weight is packed once per weight version (ops/dense_conv.py
//    pack_dense_weight of an fp32 weight): for each N tile, channel step
//    and tap, the three planes' (BN, 32) tiles, each K-major in 64-byte
//    rows and the 64-byte swizzle, so a stage (24 KB at BN = 128; 5 stages
//    beside the strips at W = 240) is one bulk copy.
//  - The activations are split in registers, not by a pass over x: nine
//    taps read one strip, and a split pass would triple its bytes in HBM and
//    in shared memory. A consumer thread reads its A fragments' fp32 values
//    with ld.shared.v4 (ldmatrix moves 16-bit values only): the K order of
//    a step is permuted (the packer permutes the weight to match) so that
//    thread t's values of one pixel row, fragment columns 2 (t % 4), +1, +8,
//    +9 of both k-steps, are the 8 contiguous channels 8 (t % 4) .. +7: two
//    16-byte loads per row, and the 8 lanes of a quarter warp (two pixel
//    rows of 144 bytes) cover the 32 banks once. Then three cvt.rn.bf16x2
//    and four subtractions per pair of values make the three A planes (24
//    registers beside the two m64n128 accumulators' 128).
//  - A fresh accumulator per tap, added to the sum in registers: wgmma adds
//    each k-step into its accumulator more coarsely than an fp32 add (the
//    plain flash attention's kernel found it first), with an error that
//    grows with the number of additions. One accumulator over the whole K
//    loop (12 additions a tap) missed the fp32 check's |d| <= 1e-4 on an
//    H100 at every decoder shape of 504 input channels and more.
//    Two accumulators fit the consumers' 224 registers only at N tiles of
//    at most 128 (2 x 64 registers), so the fp32 kernel is built for N =
//    96 and 128, and 252 outputs take two N tiles.
// Values of |v| below about 2^-100 lose bits of lo to bf16's subnormals; an
// infinite input gives NaN where the plain version gives an infinity.
constexpr int BKF = 32;                  // input channels per step (fp32)
constexpr int kPlanes = 3;               // bf16 planes of an fp32 value
constexpr int kRowBytesF = BKF * 2;      // a plane row: 32 bf16 values of one output

// (v0, v1) as three bf16 pairs, each the rounding to nearest of what the
// planes before it left: hi, mid, lo.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// x (B, H, W, Cin) fp32; wp the packed weight: for N tile nt, channel step
// cs and tap (dy, dx), in that order, the planes hi, mid, lo, each a (BN,
// 32) bf16 tile whose row n holds the step's 32 input channels of output BN
// nt + n in the permuted K order (position 16 k + 8 h + 2 j + e holds
// channel 8 j + 4 k + 2 h + e), its 16-byte chunk c stored at chunk c ^ ((n
// / 2) % 4); zero past Cin and Cout. Grid: (N tiles, M tiles of a frame, B).
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_f32_wgmma_kernel(const float* __restrict__ x, const bf16* __restrict__ wp,
                      float* __restrict__ out, ConvShape s, Tiling t) {
  constexpr int kPlaneBytes = BN * kRowBytesF;
  constexpr int kStageBytes = kPlanes * kPlaneBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sB = smem_raw + ((1024 - (hp::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sS = sB + t.b_stages * kStageBytes;
  uint64_t* full_b = reinterpret_cast<uint64_t*>(sS + kStripStages * t.strip_bytes);
  uint64_t* empty_b = full_b + kMaxBStages;
  uint64_t* full_s = empty_b + kMaxBStages;
  uint64_t* empty_s = full_s + kStripStages;

  const int wg = threadIdx.x / 128;
  const int oh0 = (blockIdx.y / t.n_col_tiles) * t.TR;
  const int ow0 = (blockIdx.y % t.n_col_tiles) * t.TC;
  const int b = blockIdx.z;
  const int taps = s.kh * s.kw;
  const int n_iters = (s.Cin + BKF - 1) / BKF * taps;

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
    if (pt == 0) {  // the three planes of a step and tap: one bulk copy
      const bf16* src = wp + (long long)blockIdx.x * n_iters * kPlanes * BN * BKF;
      int st = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_iters; ++it) {
        hp::mbar_wait(&empty_b[st], phase ^ 1);
        hp::mbar_arrive_expect_tx(&full_b[st], kStageBytes);
        hp::bulk_load(sB + st * kStageBytes, src + (long long)it * kPlanes * BN * BKF,
                      kStageBytes, &full_b[st]);
        if (++st == t.b_stages) {
          st = 0;
          phase ^= 1;
        }
      }
    } else if (pt >= 32) {
      copy_strips<float>(x, sS, full_s, empty_s, s, t, pt - 32, oh0, ow0, b);
    }
    return;
  }

  // ---- consumers 0 and 1: pixel rows 64 wg .. 64 wg + 63 of the M tile
  hp::setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  // This thread's two fragment rows, pixel rows lane / 4 and + 8 of the
  // warp's 16: tile pixel m = (r, c) reads strip pixel (r + dy, c + dx)
  // through tap (dy, dx); an idle row reads pixel 0. Its 8 channels start
  // at byte 32 (lane % 4) of the pixel.
  uint32_t a_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = wg * WM + warp * 16 + (lane >> 2) + 8 * h, r = m / t.TC, c = m % t.TC;
    const int pix = (r < t.TR && oh0 + r < s.Ho && ow0 + c < s.Wo) ? r * t.SW + c : 0;
    a_row[h] = hp::smem_addr(sS) + pix * kPixBytes + (lane & 3) * 32;
  }
  const uint64_t desc_b = hp::smem_desc_sw64(sB, 16, 512);
  constexpr uint64_t kDescStage = kStageBytes / 16, kDescPlane = kPlaneBytes / 16;
  constexpr uint64_t kDescK16 = 32 / 16;

  float acc[BN / 2], part[BN / 2];  // the sum, and the current tap's products
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // The K loop: channel steps, and the kh * kw taps inside each; a tap's A
  // planes are made once its previous products have retired (as in the
  // bf16 kernel: ptxas serialises the products when their input registers
  // are written while a product is in flight).
  uint32_t a[kPlanes * 8];  // plane p, k-step k: a[8 p + 4 k .. + 3]
  int cs = 0, tap = 0, dy = 0, dx = 0, bst = 0;
  uint32_t b_phase = 0;
  for (int it = 0; it < n_iters; ++it) {
    const int sst = cs % kStripStages;
    if (tap == 0) hp::mbar_wait(&full_s[sst], (cs / kStripStages) & 1);
    const uint32_t off = sst * t.strip_bytes + (dy * t.SW + dx) * kPixBytes;
    float v[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      hp::lds128(*reinterpret_cast<float(*)[4]>(&v[h][0]), a_row[h] + off);
      hp::lds128(*reinterpret_cast<float(*)[4]>(&v[h][4]), a_row[h] + off + 16);
    }
    if (tap == taps - 1) {  // this warp is done with the strip stage
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty_s[sst]);
    }
    // fragment register i of k-step k: row lane / 4 + 8 (i % 2), columns
    // 2 (lane % 4) + 8 (i / 2) and +1, which are values 4 k + 2 (i / 2), +1
    // of that row's 8
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* pv = &v[i % 2][4 * k + 2 * (i / 2)];
        split3(pv[0], pv[1], a[4 * k + i], a[8 + 4 * k + i], a[16 + 4 * k + i]);
      }
    hp::mbar_wait(&full_b[bst], b_phase);
    hp::fence_regs(a);
    hp::wgmma_fence();
    const uint64_t whi = desc_b + bst * kDescStage, wmid = whi + kDescPlane,
                   wlo = whi + 2 * kDescPlane;
    // the six plane products, smallest first, over both k-steps, into a
    // fresh accumulator (the first product does not read it)
#pragma unroll
    for (int k = 0; k < 2; ++k) wgmma_rs<BN>(part, &a[16 + 4 * k], whi + k * kDescK16, k);
#pragma unroll
    for (int k = 0; k < 2; ++k) wgmma_rs<BN>(part, &a[4 * k], wlo + k * kDescK16);
#pragma unroll
    for (int k = 0; k < 2; ++k) wgmma_rs<BN>(part, &a[8 + 4 * k], wmid + k * kDescK16);
#pragma unroll
    for (int k = 0; k < 2; ++k) wgmma_rs<BN>(part, &a[8 + 4 * k], whi + k * kDescK16);
#pragma unroll
    for (int k = 0; k < 2; ++k) wgmma_rs<BN>(part, &a[4 * k], wmid + k * kDescK16);
#pragma unroll
    for (int k = 0; k < 2; ++k) wgmma_rs<BN>(part, &a[4 * k], whi + k * kDescK16);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
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

  // The accumulator's layout as in the bf16 kernel; fp32 pairs stored
  // where Cout is even (8-byte aligned), single values otherwise.
  const int n0 = blockIdx.x * BN;
  const bool pair = (s.Cout % 2) == 0;
  float* ob = out + (long long)b * s.Ho * s.Wo * s.Cout;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = wg * WM + warp * 16 + (lane >> 2) + 8 * h, r = m / t.TC, c = m % t.TC;
    const int oh = oh0 + r, ow = ow0 + c;
    if (r >= t.TR || oh >= s.Ho || ow >= s.Wo) continue;
    float* dst = ob + (oh * s.Wo + ow) * s.Cout + n0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n >= s.Cout) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pair) {
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(v0, v1);
      } else {
        dst[8 * j] = v0;
        if (n + 1 < s.Cout) dst[8 * j + 1] = v1;
      }
    }
  }
}

}  // namespace

// x (B, H, W, Cin), out (B, Ho, Wo, Cout), contiguous, one dtype; w is the
// packed bf16 weight of N tile `bn`: for bf16 x one plane in 64-channel
// steps, bn 96, 128 or 256 (see conv_bf16_wgmma_kernel); for fp32 x three
// planes in 32-channel steps, bn 96 or 128 (see conv_f32_wgmma_kernel). Ho = H + ph0 + ph1 - kh +
// 1 and Wo likewise (Wo = W when circular), computed by the caller. Returns
// cudaGetLastError().
extern "C" int ladcast_dense_conv(const void* x, const void* w, void* out, int B,
                                  int H, int W, int Cin, int Cout, int kh, int kw,
                                  int ph0, int pw0, int Ho, int Wo, int circular,
                                  int bn, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ConvShape s{H, W, Cin, Cout, kh, kw, ph0, pw0, Ho, Wo, circular};
  if (B > 65535) return (int)cudaErrorInvalidValue;  // grid.z
  // 32-bit offsets inside one frame
  if ((long long)H * W * Cin > 2147483647LL || (long long)Ho * Wo * Cout > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const bf16* wp = static_cast<const bf16*>(w);
  if (dtype == kDtypeBF16) {
    const bf16* xp = static_cast<const bf16*>(x);
    bf16* op = static_cast<bf16*>(out);
    switch (bn) {
      case 96: return launch(conv_bf16_wgmma_kernel<96>, xp, wp, op, B, s, 96, 96 * kRowBytes, 3, st);
      case 128: return launch(conv_bf16_wgmma_kernel<128>, xp, wp, op, B, s, 128, 128 * kRowBytes, 3, st);
      case 256: return launch(conv_bf16_wgmma_kernel<256>, xp, wp, op, B, s, 256, 256 * kRowBytes, 3, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == kDtypeF32) {
    const float* xp = static_cast<const float*>(x);
    float* op = static_cast<float*>(out);
    constexpr int kB = kPlanes * kRowBytesF;  // bytes of a stage per output
    switch (bn) {
      case 96: return launch(conv_f32_wgmma_kernel<96>, xp, wp, op, B, s, 96, 96 * kB, 2, st);
      case 128: return launch(conv_f32_wgmma_kernel<128>, xp, wp, op, B, s, 128, 128 * kB, 2, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
