// Depthwise kh x kw convolution, NHWC, padding inside the kernel (forward).
//
// Replaces: ladcast_tpu/ops/pallas/depthwise_conv.py:101 _kernel (launched
// by _pallas_depthwise, :142; public entry depthwise_same_conv, :190).
//
// Inputs: x (B, H, W, C) and k (kh, kw, C), both bf16 or both fp32,
// contiguous. out[b, h, w, c] = sum over (dy, dx) of
// xp[b, h + dy, w + dx, c] * k[dy, dx, c], where xp is x padded by
// (ph0, ph1) zero rows in H and, in W, either by (pw0, pw1) zero columns or
// circularly (column (w + dx - pw0) mod W). No padded copy exists: a tap on
// padding is skipped, a wrapped column is an index. fp32 accumulation, one
// cast at the store.
//
// Bound on an H100: one multiply-add per tap at one read and one write per
// element, so bytes: the GLUMBConv 3x3 at (80, 30, 60, 4032) moves 2.3 GB
// (0.69 ms at 3.35 TB/s) for 1.0e10 flop (0.16 ms of fp32 FMA).
// Design: no tensor cores. One thread owns V adjacent channels (16 bytes:
// 8 bf16 or 4 fp32, so a warp reads 512 contiguous bytes of a pixel) of TW
// = 4 adjacent output pixels of one row. Per kernel row it holds the row's
// kw weight vectors in registers, reads the TW + kw - 1 input vectors of
// its window once each and feeds every output they touch, so an input
// vector is fetched from L1/L2 (kw + 3) / 4 times per kernel row and not
// kw times. Channel counts that are no multiple of V run with V = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kThreads = 128;
constexpr int TW = 4;  // output pixels per thread, along W

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&f)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const bf16* p, float (&f)[V]) {
  if constexpr (V == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(h[i]);
      f[2 * i] = a.x;
      f[2 * i + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = __bfloat162float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&f)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = f[i];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(bf16* p, const float (&f)[V]) {
  if constexpr (V == 8) {
    __align__(16) __nv_bfloat162 h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16(f[i]);
  }
}

template <typename T, int V, int KW>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ x, const T* __restrict__ k, T* __restrict__ out,
          long long total, int H, int W, int C, int kh, int ph0, int pw0, int Ho,
          int Wo, int circular) {
  long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int CV = C / V, WT = (Wo + TW - 1) / TW;
  const int c = (int)(idx % CV) * V;
  idx /= CV;
  const int w0 = (int)(idx % WT) * TW;
  idx /= WT;
  const int h = (int)(idx % Ho);
  const long long b = idx / Ho;

  // input column of each window position, -1 on zero padding
  int col[TW + KW - 1];
#pragma unroll
  for (int j = 0; j < TW + KW - 1; ++j) {
    int iw = w0 + j - pw0;
    if (circular) {
      iw %= W;
      if (iw < 0) iw += W;
    } else if (iw < 0 || iw >= W) {
      iw = -1;
    }
    col[j] = iw;
  }

  float acc[TW][V];
#pragma unroll
  for (int t = 0; t < TW; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[t][v] = 0.f;

  for (int dy = 0; dy < kh; ++dy) {
    const int ih = h + dy - ph0;
    if (ih < 0 || ih >= H) continue;
    float wv[KW][V];
#pragma unroll
    for (int dx = 0; dx < KW; ++dx) load_vec<V>(k + (long long)(dy * KW + dx) * C + c, wv[dx]);
    const T* row = x + ((b * H + ih) * W) * C + c;
#pragma unroll
    for (int j = 0; j < TW + KW - 1; ++j) {
      if (col[j] < 0) continue;
      float xv[V];
      load_vec<V>(row + (long long)col[j] * C, xv);
#pragma unroll
      for (int dx = 0; dx < KW; ++dx) {
        const int t = j - dx;  // compile-time after unrolling
        if (t >= 0 && t < TW) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[t][v] = fmaf(xv[v], wv[dx][v], acc[t][v]);
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < TW; ++t)
    if (w0 + t < Wo) store_vec<V>(out + ((b * Ho + h) * Wo + w0 + t) * C + c, acc[t]);
}

template <typename T, int V>
int launch(const void* x, const void* k, void* out, int B, int H, int W, int C, int kh,
           int kw, int ph0, int pw0, int Ho, int Wo, int circular, cudaStream_t st) {
  const long long total = (long long)B * Ho * ((Wo + TW - 1) / TW) * (C / V);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* kp = static_cast<const T*>(k);
  T* op = static_cast<T*>(out);
#define LADCAST_DW(KW)                                                          \
  dw_kernel<T, V, KW><<<(unsigned)blocks, kThreads, 0, st>>>(                   \
      xp, kp, op, total, H, W, C, kh, ph0, pw0, Ho, Wo, circular)
  switch (kw) {
    case 3: LADCAST_DW(3); break;
    case 5: LADCAST_DW(5); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LADCAST_DW
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, C), k (kh, kw, C), out (B, Ho, Wo, C), contiguous, one dtype;
// kw is 3 or 5; Ho = H + ph0 + ph1 - kh + 1 and Wo likewise (Wo = W
// when circular), computed by the caller. Returns cudaGetLastError().
extern "C" int ladcast_depthwise_conv(const void* x, const void* k, void* out, int B,
                                      int H, int W, int C, int kh, int kw, int ph0,
                                      int pw0, int Ho, int Wo, int circular,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((long long)B * Ho * Wo * C == 0) return (int)cudaSuccess;
  if (dtype == kDtypeBF16) {
    if (C % 8 == 0)
      return launch<bf16, 8>(x, k, out, B, H, W, C, kh, kw, ph0, pw0, Ho, Wo, circular, st);
    return launch<bf16, 1>(x, k, out, B, H, W, C, kh, kw, ph0, pw0, Ho, Wo, circular, st);
  }
  if (dtype == kDtypeF32) {
    if (C % 4 == 0)
      return launch<float, 4>(x, k, out, B, H, W, C, kh, kw, ph0, pw0, Ho, Wo, circular, st);
    return launch<float, 1>(x, k, out, B, H, W, C, kh, kw, ph0, pw0, Ho, Wo, circular, st);
  }
  return (int)cudaErrorInvalidValue;
}
