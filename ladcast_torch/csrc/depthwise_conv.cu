// Depthwise k x k convolution, NHWC, padding inside the kernel (forward).
//
// Replaces: ladcast_tpu/ops/pallas/depthwise_conv.py:101 _kernel (launched
// by _pallas_depthwise, :142; public entry depthwise_same_conv, :190).
//
// Inputs: x (B, H, W, C) and k (K, K, C) with K = 3 or 5, both bf16 or both
// fp32, contiguous. out[b, h, w, c] = sum over (dy, dx) of
// xp[b, h + dy, w + dx, c] * k[dy, dx, c], where xp is x padded by
// (ph0, ph1) zero rows in H and, in W, either by (pw0, pw1) zero columns or
// circularly (column (w + dx - pw0) mod W). No padded copy exists in
// device memory: a padded row or column is zero-filled in shared memory, a
// wrapped column is an index. fp32 accumulation, one cast at the store.
//
// Bound on an H100: one multiply-add per tap at one read and one write per
// element, so bytes: the GLUMBConv 3x3 at (80, 30, 60, 4032) moves 2.3 GB
// (0.69 ms at 3.35 TB/s) for 1.0e10 flop (0.16 ms of fp32 FMA); the 5x5 at
// (80, 30, 60, 1440) moves 0.83 GB (0.25 ms) for 1.0e10 flop.
// Design: no tensor cores. A block of 8 warps takes CB channels of a tile
// of 32 output columns and walks down a run of RH output rows of one frame
// (RH <= 16: the frame's rows split evenly). Each input row of the walk,
// its 32 + K - 1 columns x CB channels, is copied once into a ring of K + 2
// rows in shared memory by cp.async of 16 bytes (8 or 4 where the channel
// count keeps no 16-byte alignment, 2 synchronously for an odd bf16
// count), two rows ahead of the row being used; so each input element is
// read from device memory (32 + K - 1) / 32 x (RH + K - 1) / RH times: 1.2
// for the 3x3 at 30 x 60 (the old kernel's threads read their own windows,
// 4.5 times, from L1 and L2, and 10 times at 5x5). Lane l of warp w owns V
// channels, V l .. V l + V - 1, and output columns 4w .. 4w + 3: per output
// row it reads K x (K + 3) vectors of V channels from the ring (a warp
// reads 32 V contiguous values: no bank conflict) and feeds every output
// they touch, with its K x K x V weights in registers for the whole walk.
// Register pressure: V = 4 (CB = 128) at 3x3; at 5x5, V = 4 would hold 100
// fp32 registers of weights and leave one block per SM, so V = 2 (CB = 64,
// 50 registers). The ring decouples the copies from the threads' channels:
// the device-memory reads stay 16 bytes wide either way. fp32 (the parity
// dtype) runs the same kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int TW = 4;                // output columns per thread
constexpr int TC = kWarps * TW;      // output columns per block
constexpr int kAhead = 2;            // rows in flight beyond the window
constexpr int kMaxRows = 16;         // output rows per walk, at most

// V values of a ring pixel as floats, in one shared-memory load (V times
// the value's size, aligned to it).
template <int V>
__device__ __forceinline__ void loadv(const float* p, float (&f)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    f[0] = t.x; f[1] = t.y;
  }
}

template <int V>
__device__ __forceinline__ void loadv(const bf16* p, float (&f)[V]) {
  __align__(8) __nv_bfloat162 h[V / 2];
  if constexpr (V == 4) *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(p);
  else h[0] = *reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float2 a = __bfloat1622float2(h[i]);
    f[2 * i] = a.x;
    f[2 * i + 1] = a.y;
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16(v); }

// Out values c .. c + V - 1 of a pixel: one store where the channel count
// keeps them aligned (`vec`), else one value at a time up to C.
template <int V>
__device__ __forceinline__ void storev(float* p, const float (&f)[V], int n_valid, bool vec) {
  if (vec && n_valid >= V) {
    if constexpr (V == 4) *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    else *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
    return;
  }
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (i < n_valid) p[i] = f[i];
}

template <int V>
__device__ __forceinline__ void storev(bf16* p, const float (&f)[V], int n_valid, bool vec) {
  if (vec && n_valid >= V) {
    __align__(8) __nv_bfloat162 h[V / 2];
#pragma unroll
    for (int i = 0; i < V / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    if constexpr (V == 4) *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
    else *reinterpret_cast<__nv_bfloat162*>(p) = h[0];
    return;
  }
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (i < n_valid) p[i] = __float2bfloat16(f[i]);
}

// 16 bytes of shared memory from `src` (the values below `n_valid`; the
// rest zero), in copies of `bytes` (16, 8, 4: cp.async; 2: synchronous),
// which divides a pixel's row of channels; `safe` is any address inside x.
template <typename T>
__device__ __forceinline__ void stage16(T* dst, const T* src, const T* safe, int n_valid,
                                        int bytes) {
  constexpr int E = 16 / sizeof(T);
  if (bytes == 16) {
    ladcast::cp_async16_zfill(dst, n_valid > 0 ? src : safe, n_valid > 0);
  } else if (bytes == 8) {
    constexpr int e = 8 / sizeof(T);
#pragma unroll
    for (int i = 0; i < E; i += e)
      ladcast::cp_async_small_zfill<8>(dst + i, i < n_valid ? src + i : safe, i < n_valid);
  } else if (bytes == 4) {
    constexpr int e = 4 / sizeof(T);
#pragma unroll
    for (int i = 0; i < E; i += e)
      ladcast::cp_async_small_zfill<4>(dst + i, i < n_valid ? src + i : safe, i < n_valid);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) dst[i] = i < n_valid ? src[i] : from_float<T>(0.f);
  }
}

// V: channels per thread, CB = 32 V per block.
template <typename T, int K, int V>
__global__ void __launch_bounds__(kThreads)
dw_rows_kernel(const T* __restrict__ x, const T* __restrict__ k, T* __restrict__ out,
               int H, int W, int C, int ph0, int pw0, int Ho, int Wo, int circular,
               int rows_per_walk, int walks, int copy_bytes) {
  constexpr int CB = 32 * V;                 // channels per block
  constexpr int kSlots = K + kAhead;
  constexpr int SWc = TC + K - 1;            // pixels of a ring row
  constexpr int E = 16 / sizeof(T);          // values per 16-byte chunk
  constexpr int kChunks = CB / E;            // chunks per pixel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // kSlots rows of SWc pixels of CB

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * CB, w0 = blockIdx.y * TC;
  const int b = blockIdx.z / walks, oh0 = (blockIdx.z % walks) * rows_per_walk;
  const int n_out = min(rows_per_walk, Ho - oh0);
  const int n_in = n_out + K - 1;              // input rows of the walk
  const int n_cols = min(TC, Wo - w0) + K - 1;  // ring pixels any output reads
  const T* xb = x + (long long)b * H * W * C;

  // Input row r of the walk (ih = oh0 - ph0 + r) into its ring slot.
  auto stage_row = [&](int r) {
    T* slot = ring + (r % kSlots) * SWc * CB;
    const int ih = oh0 - ph0 + r;
    for (int i = tid; i < n_cols * kChunks; i += kThreads) {
      const int j = i / kChunks, c = c0 + (i % kChunks) * E;
      int iw = w0 + j - pw0;
      if (circular) iw = iw < 0 ? iw + W : (iw >= W ? iw - W : iw);
      const bool ok = ih >= 0 && ih < H && iw >= 0 && iw < W;
      // an offset inside one frame fits 32 bits (the launcher checks)
      stage16(slot + j * CB + (i % kChunks) * E, xb + (ih * W + iw) * C + c, xb,
              ok ? C - c : 0, copy_bytes);
    }
  };

  // this thread's channels and weights
  const int c = c0 + V * lane;
  float wt[K][K][V];
#pragma unroll
  for (int dy = 0; dy < K; ++dy)
#pragma unroll
    for (int dx = 0; dx < K; ++dx)
#pragma unroll
      for (int v = 0; v < V; ++v)
        wt[dy][dx][v] = c + v < C ? to_float(k[(dy * K + dx) * C + c + v]) : 0.f;

  // Rows 0 .. K + kAhead - 2 in flight, one commit group per row (empty
  // past the walk), so that before output row i the groups still
  // outstanding are exactly the kAhead - 1 rows after the window.
#pragma unroll
  for (int r = 0; r < K + kAhead - 1; ++r) {
    if (r < n_in) stage_row(r);
    ladcast::cp_async_commit();
  }
  T* ob = out + ((long long)b * Ho + oh0) * Wo * C;
  const int ow = w0 + TW * warp;
  for (int i = 0; i < n_out; ++i) {
    ladcast::cp_async_wait<kAhead - 1>();
    __syncthreads();  // rows i .. i + K - 1 have landed; row i - 1's slot is free
    if (i + K + kAhead - 1 < n_in) stage_row(i + K + kAhead - 1);
    ladcast::cp_async_commit();

    float acc[TW][V];
#pragma unroll
    for (int t = 0; t < TW; ++t)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[t][v] = 0.f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const T* row = ring + ((i + dy) % kSlots) * SWc * CB + TW * warp * CB + V * lane;
#pragma unroll
      for (int j = 0; j < TW + K - 1; ++j) {
        float xv[V];
        loadv<V>(row + j * CB, xv);
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const int t = j - dx;  // compile-time after unrolling
          if (t >= 0 && t < TW) {
#pragma unroll
            for (int v = 0; v < V; ++v) acc[t][v] = fmaf(xv[v], wt[dy][dx][v], acc[t][v]);
          }
        }
      }
    }
    if (c < C) {
#pragma unroll
      for (int t = 0; t < TW; ++t)
        if (ow + t < Wo)
          storev<V>(ob + ((long long)i * Wo + ow + t) * C + c, acc[t], C - c, C % V == 0);
    }
  }
}

// 4 channels a thread at 3x3, 2 at 5x5, where 4 would take 100 registers
// of weights and leave one block per SM.
template <typename T, int K, int V = (K == 5 ? 2 : 4)>
int launch(const void* x, const void* k, void* out, int B, int H, int W, int C, int ph0,
           int pw0, int Ho, int Wo, int circular, cudaStream_t st) {
  constexpr int CB = 32 * V;
  constexpr int kSmem = (K + kAhead) * (TC + K - 1) * CB * (int)sizeof(T);
  const int walks = (Ho + kMaxRows - 1) / kMaxRows;
  const int rows = (Ho + walks - 1) / walks;
  const long long z = (long long)B * walks;
  if (z > 65535 || (long long)H * W * C > 2147483647LL) return (int)cudaErrorInvalidValue;
  // the widest copy that keeps a pixel's channels 16-byte-chunk aligned
  const int row_bytes = C * (int)sizeof(T);
  const int copy_bytes = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8
                         : row_bytes % 4 == 0 ? 4 : 2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dw_rows_kernel<T, K, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((C + CB - 1) / CB, (Wo + TC - 1) / TC, (unsigned)z);
  dw_rows_kernel<T, K, V><<<grid, kThreads, kSmem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<T*>(out), H, W, C,
      ph0, pw0, Ho, Wo, circular, rows, walks, copy_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, C), k (K, K, C), out (B, Ho, Wo, C), contiguous, one dtype;
// K (kh == kw) is 3 or 5; Ho = H + ph0 + ph1 - K + 1 and Wo likewise (Wo =
// W when circular), computed by the caller. Returns cudaGetLastError().
extern "C" int ladcast_depthwise_conv(const void* x, const void* k, void* out, int B,
                                      int H, int W, int C, int kh, int kw, int ph0,
                                      int pw0, int Ho, int Wo, int circular,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((long long)B * Ho * Wo * C == 0) return (int)cudaSuccess;
  if (kh != kw || (kw != 3 && kw != 5)) return (int)cudaErrorInvalidValue;
  if (dtype == kDtypeBF16)
    return kw == 3 ? launch<bf16, 3>(x, k, out, B, H, W, C, ph0, pw0, Ho, Wo, circular, st)
                   : launch<bf16, 5>(x, k, out, B, H, W, C, ph0, pw0, Ho, Wo, circular, st);
  if (dtype == kDtypeF32)
    return kw == 3 ? launch<float, 3>(x, k, out, B, H, W, C, ph0, pw0, Ho, Wo, circular, st)
                   : launch<float, 5>(x, k, out, B, H, W, C, ph0, pw0, Ho, Wo, circular, st);
  return (int)cudaErrorInvalidValue;
}
