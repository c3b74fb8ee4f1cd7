// Dense kh x kw convolution, NHWC x HWIO, as an implicit GEMM (forward).
//
// Replaces: ladcast_tpu/ops/pallas/dense_conv.py:83 _kernel (launched by
// _pallas_dense, :172; public entry dense_conv, :232).
//
// Inputs: x (B, H, W, Cin) and w (kh, kw, Cin, Cout), both bf16 or both
// fp32, contiguous. out[b, h, w, o] = sum over (dy, dx, c) of
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
// Design (bf16): M = 128 consecutive output pixels of one frame (the tile
// runs across image rows: W = 30 is narrower than any tile), N = 128 output
// channels, K = the kh*kw taps x Cin in steps of 64 channels. 8 warps, each
// 64 x 32 of the tile, on mma.sync.m16n8k16 with fp32 accumulators. A tap's
// A tile is gathered pixel row by pixel row (each a contiguous channel run
// of x), the B tile is a (64, 128) block of w[dy, dx]; two stages in
// flight by cp.async, zero-filled where a pixel is padding or a channel is
// past Cin / Cout. The copies are as wide as the channel count keeps a
// row aligned: 16 bytes for multiples of 8 (504, 1008, 2016), 8 for
// multiples of 4 (252, 84), 4 for even counts (126); an odd count (89) is
// read 2 bytes at a time. The gathering of the tiles, not the products,
// takes most of the kernel's time (with the loads taken out it runs at
// 2.4x the speed): tile sizes and deeper rings measured no better. Shared-
// memory rows are padded by 16 bytes against ldmatrix bank conflicts; the
// two stages take 70 KB, so the launch opts in. A wgmma/TMA pipeline with
// im2col descriptors is the known next step.
// fp32 (the parity dtype) runs an FMA kernel on the CUDA cores: 64 x 64
// tiles, 4 x 4 outputs per thread, K in steps of 16.

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ladcast::cp_async16_zfill;
using ladcast::cp_async_commit;
using ladcast::cp_async_wait;
using ladcast::ldmatrix_x4;
using ladcast::ldmatrix_x4_trans;
using ladcast::mma_bf16;

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
constexpr int BM = 128, BN = 128, BK = 64, kStages = 2, kThreads = 256;
constexpr int LDA = BK + 8, LDB = BN + 8;
constexpr int kStageA = BM * LDA, kStageB = BK * LDB;
constexpr int kSmemBf16 = kStages * (kStageA + kStageB) * (int)sizeof(bf16);
constexpr int kChunksK = BK / 8, kChunksN = BN / 8;  // 16-byte chunks per row
constexpr int kRowsA = BM * kChunksK / kThreads;     // chunks per thread
constexpr int kRowsB = BK * kChunksN / kThreads;
constexpr int WM = BM / 2, WN = BN / 4;  // a warp's tile: 8 warps as 2 x 4
constexpr int MT = WM / 16, NP = WN / 16;
static_assert(kRowsA * kThreads == BM * kChunksK && kRowsB * kThreads == BK * kChunksN,
              "tile loads must divide among the threads");

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

__global__ void __launch_bounds__(kThreads)
conv_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 bf16* __restrict__ out, ConvShape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // kStages tiles of (BM, LDA)
  bf16* sB = sA + kStages * kStageA;         // kStages tiles of (BK, LDB)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int n_pix = s.Ho * s.Wo;
  const int a_width = copy_width(s.Cin), b_width = copy_width(s.Cout);
  const bf16* xb = x + (long long)b * s.H * s.W * s.Cin;

  // This thread's A rows (output pixels) and its channel chunk in the step.
  const int a_chunk = (tid % kChunksK) * 8;
  int a_oh[kRowsA], a_ow[kRowsA];
#pragma unroll
  for (int i = 0; i < kRowsA; ++i) {
    const int p = m0 + tid / kChunksK + i * (kThreads / kChunksK);
    a_oh[i] = (p < n_pix) ? p / s.Wo : -1;
    a_ow[i] = (p < n_pix) ? p % s.Wo : 0;
  }
  const int b_chunk = (tid % kChunksN) * 8;

  const int n_c = (s.Cin + BK - 1) / BK;
  const int n_k = s.kh * s.kw * n_c;

  // Tiles are loaded in the order of kt = (dy, dx, channel step); the next
  // load's position is kept in counters.
  int ld_dy = 0, ld_dx = 0, ld_c0 = 0;
  auto load_tile = [&](int stage) {
    const int dy = ld_dy, dx = ld_dx, c0 = ld_c0;
    const int tap = dy * s.kw + dx;
    ld_c0 += BK;
    if (ld_c0 >= s.Cin) {
      ld_c0 = 0;
      if (++ld_dx == s.kw) { ld_dx = 0; ++ld_dy; }
    }
    bf16* tA = sA + stage * kStageA;
    bf16* tB = sB + stage * kStageB;
    const int c = c0 + a_chunk;
#pragma unroll
    for (int i = 0; i < kRowsA; ++i) {
      const int r = tid / kChunksK + i * (kThreads / kChunksK);
      const int ih = a_oh[i] + dy - s.ph0;
      const int iw = in_col(s, a_ow[i], dx);
      const bool pix = a_oh[i] >= 0 && ih >= 0 && ih < s.H && iw >= 0;
      // an offset inside one frame fits 32 bits (the wrapper checks)
      const bf16* src = xb + (ih * s.W + iw) * s.Cin + c;
      copy_chunk(tA + r * LDA + a_chunk, src, xb, pix ? s.Cin - c : 0, a_width);
    }
    const int n = n0 + b_chunk;
#pragma unroll
    for (int i = 0; i < kRowsB; ++i) {
      const int kk = tid / kChunksN + i * (kThreads / kChunksN);
      const int ck = c0 + kk;
      const bf16* src = w + (tap * s.Cin + ck) * s.Cout + n;
      copy_chunk(tB + kk * LDB + b_chunk, src, w, ck < s.Cin ? s.Cout - n : 0, b_width);
    }
    cp_async_commit();
  };

  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;  // the warp's corner
  float acc[MT][2 * NP][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // A ring of kStages tiles: kStages - 1 loads are in flight while one tile
  // is multiplied. Every iteration commits one group (an empty one past the
  // last tile), so that "all but the newest kStages - 2 groups are done"
  // always means "tile kt has landed".
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_k) load_tile(st); else cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    if (kt + kStages - 1 < n_k) load_tile((kt + kStages - 1) % kStages);
    else cp_async_commit();
    const bf16* tA = sA + (kt % kStages) * kStageA;
    const bf16* tB = sB + (kt % kStages) * kStageB;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MT][4], bfr[NP][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], tA + (wm + mt * 16 + (lane & 15)) * LDA + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NP; ++np)
        ldmatrix_x4_trans(bfr[np], tB + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB +
                                       wn + np * 16 + ((lane >> 4) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          mma_bf16(acc[mt][2 * np], af[mt], bfr[np][0], bfr[np][1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[np][2], bfr[np][3]);
        }
    }
  }

  bf16* ob = out + (long long)b * n_pix * s.Cout;
  const bool pair = (s.Cout % 2) == 0;  // 4-byte aligned bf16 pairs
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * NP; ++nt) {
      const int col = n0 + wn + nt * 8 + (lane & 3) * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = m0 + wm + mt * 16 + (lane >> 2) + half * 8;
        if (p >= n_pix || col >= s.Cout) continue;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        bf16* dst = ob + (long long)p * s.Cout + col;
        if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (col + 1 < s.Cout) dst[1] = __float2bfloat16(v1);
        }
      }
    }
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

// x (B, H, W, Cin), w (kh, kw, Cin, Cout), out (B, Ho, Wo, Cout), contiguous,
// one dtype; Ho = H + ph0 + ph1 - kh + 1 and Wo likewise (Wo = W when
// circular), computed by the caller. Returns cudaGetLastError().
extern "C" int ladcast_dense_conv(const void* x, const void* w, void* out, int B,
                                  int H, int W, int Cin, int Cout, int kh, int kw,
                                  int ph0, int pw0, int Ho, int Wo, int circular,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ConvShape s{H, W, Cin, Cout, kh, kw, ph0, pw0, Ho, Wo, circular};
  const long long n_pix = (long long)Ho * Wo;
  if (B > 65535) return (int)cudaErrorInvalidValue;  // grid.z
  // 32-bit offsets inside one frame and inside the weights
  if ((long long)H * W * Cin > 2147483647LL || n_pix * Cout > 2147483647LL ||
      (long long)kh * kw * Cin * Cout > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (dtype == kDtypeBF16) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBf16);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((unsigned)((n_pix + BM - 1) / BM), (Cout + BN - 1) / BN, B);
    conv_bf16_kernel<<<grid, kThreads, kSmemBf16, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), s);
  } else if (dtype == kDtypeF32) {
    const dim3 grid((unsigned)((n_pix + FM - 1) / FM), (Cout + FN - 1) / FN, B);
    conv_f32_kernel<<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
