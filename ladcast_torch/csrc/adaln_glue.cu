// K7: the DiT block glue -- LayerNorm, AdaLN modulation, gate and residual
// add -- in one pass over each token row.
//
// Replaces: no TPU kernel. The JAX package leaves these steps to XLA, which
// fuses them; run as separate PyTorch passes (F.layer_norm, then a broadcast
// multiply, add, multiply and add, most of them PyTorch's non-vectorised
// broadcast kernel) they read and write each value of the residual stream
// once per step: 22 passes of a dual-stream block and 11 of a single-stream
// block where these entries need 9 and 5. Called by
// models/ladcast_dit.py: AdaLayerNormZero, AdaLayerNormZeroSingle, the
// dual-stream block's residuals, the single-stream block's residual and the
// head.
//
// Computes, for every (b, s) row of x (B, S, D), with every intermediate in
// fp32 registers and one rounding to the stream's dtype at each store:
//   ln_modulate                 h  = LN(x) * (1 + scale[b]) + shift[b]
//   gated_residual_ln_modulate  x' = x + y * gate[b];
//                               h  = LN(x') * (1 + scale[b]) + shift[b]
//   gated_residual              x' = x + y * gate[b]
// LN is LayerNorm without affine: (v - mean) / sqrt(var + eps), var the
// biased variance, as F.layer_norm.
//
// Bound on an H100: memory. About 10 flops a value against 4 to 8 bytes
// (bf16), far below the ~295 flop/B at which compute would bound.
// ln_modulate on the 375M latent stream (20 x 1800 x 1536, bf16) reads and
// writes 110.6 MB each, 221 MB, about 66 us at 3.35 TB/s;
// gated_residual_ln_modulate moves four such passes, gated_residual three.
// The (B, D) modulation rows (at most 80 KB each) stay in L1 and L2.
// Design: one warp per row, as K2; each lane holds its share of the row in
// registers, in 16-byte chunks with consecutive lanes on consecutive
// chunks, at most kLaneVals fp32 values a lane (so D <= 2048); the mean and
// then the variance by warp shuffles over those registers (two passes over
// registers, one read of memory; each lane sums into one partial per value
// of its chunk, so the adds do not wait on one another); no shared memory.
// The rows are streamed: loads and stores of the (B, S, D) tensors are
// evict-first (__ldcs, __stcs), and blocks are 4 warps. On the card (bf16,
// B = 20) that took ln_modulate from 68 % to 79 % of its bound at S = 1800,
// D = 1536, and from 56 % to 80 % at the 1.6B's S = 2250, D = 2048; a copy
// reaches 86-88 % there. A persistent loop that loads the next row during
// this one's reductions, or more warps a block, did not help. The row's
// batch index is row / S, and every row is bounds-checked: S = 1800, 450
// and 2250 fit no tile. x and y take a batch and a token stride (the
// head's input is a view of the joint stream); shift, scale and gate are
// (B, D) rows with a batch stride (views of the AdaLN linear's chunks,
// never copied), read through the read-only cache; outputs are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDtypeF32 = 0;  // ops/_launch.py DTYPE_CODES
constexpr int kDtypeBF16 = 1;
constexpr int kRowsPerBlock = 4;  // one warp a row
constexpr int kLaneVals = 64;     // fp32 values a lane holds at most

// the C entry's mode (ops/adaln_glue.py _MODES)
enum Mode { kLnModulate, kGatedResidualLnModulate, kGatedResidual };

struct Glue {
  const void* x;
  long long x_sb, x_st;  // batch and token strides, in elements
  const void* y;
  long long y_sb, y_st;
  const void* gate;
  long long gate_sb;
  const void* shift;
  long long shift_sb;
  const void* scale;
  long long scale_sb;
  void* x_out;  // (B, S, D) contiguous: x'
  void* h_out;  // (B, S, D) contiguous: h
  long long rows;
  int S, D;
  float eps;
};

template <typename T>
struct Chunk {
  static constexpr int n = 16 / sizeof(T);  // values in 16 bytes
};

__device__ __forceinline__ void unpack(const uint4 t, float v[8]) {
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> fp32 is exact: the high half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the (B, S, D) rows: read once, evict-first
__device__ __forceinline__ void load_chunk(const float* p, float v[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float v[8]) {
  unpack(__ldcs(reinterpret_cast<const uint4*>(p)), v);
}

// the (B, D) modulation rows: read-only, shared by every row of a batch
__device__ __forceinline__ void load_row_chunk(const float* p, float v[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load_row_chunk(const __nv_bfloat16* p, float v[8]) {
  unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
}

// the outputs: written once, evict-first
__device__ __forceinline__ void store_chunk(float* p, const float v[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float v[8]) {
  __stcs(reinterpret_cast<uint4*>(p),
         make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                    pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7])));
}

template <int V>
__device__ __forceinline__ float lane_sum(const float part[V]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) s += part[j];
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NCH: 16-byte chunks a lane holds, ceil(D / (32 * Chunk<T>::n)) or more
template <typename T, int NCH, int MODE>
__global__ void __launch_bounds__(kRowsPerBlock * 32) adaln_glue_kernel(const Glue g) {
  constexpr int V = Chunk<T>::n;
  static_assert(NCH * V <= kLaneVals, "a lane holds at most kLaneVals values");
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= g.rows) return;  // whole warps leave together
  const long long b = row / g.S, s = row - b * g.S;
  const int chunks = g.D / V;
  float v[NCH][V];
  const T* xr = static_cast<const T*>(g.x) + b * g.x_sb + s * g.x_st;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
    if (c * 32 + lane < chunks) load_chunk(xr + (c * 32 + lane) * V, v[c]);
  if (MODE != kLnModulate) {
    const T* yr = static_cast<const T*>(g.y) + b * g.y_sb + s * g.y_st;
    const T* gr = static_cast<const T*>(g.gate) + b * g.gate_sb;
    T* xo = static_cast<T*>(g.x_out) + row * g.D;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int i = c * 32 + lane;
      if (i < chunks) {
        float yv[V], gv[V];
        load_chunk(yr + i * V, yv);
        load_row_chunk(gr + i * V, gv);
#pragma unroll
        for (int j = 0; j < V; ++j)  // rounded as x + y * gate, unfused
          v[c][j] = __fadd_rn(v[c][j], __fmul_rn(yv[j], gv[j]));
        store_chunk(xo + i * V, v[c]);
      }
    }
    if (MODE == kGatedResidual) return;
  }
  float part[V];  // this lane's sums, one partial per value of a chunk
#pragma unroll
  for (int j = 0; j < V; ++j) part[j] = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
    if (c * 32 + lane < chunks) {
#pragma unroll
      for (int j = 0; j < V; ++j) part[j] += v[c][j];
    }
  const float mean = warp_sum(lane_sum<V>(part)) / g.D;
#pragma unroll
  for (int j = 0; j < V; ++j) part[j] = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
    if (c * 32 + lane < chunks) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[c][j] -= mean;
        part[j] += v[c][j] * v[c][j];
      }
    }
  const float rstd = 1.0f / sqrtf(warp_sum(lane_sum<V>(part)) / g.D + g.eps);
  const T* shr = static_cast<const T*>(g.shift) + b * g.shift_sb;
  const T* scr = static_cast<const T*>(g.scale) + b * g.scale_sb;
  T* ho = static_cast<T*>(g.h_out) + row * g.D;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int i = c * 32 + lane;
    if (i < chunks) {
      float sh[V], sc[V];
      load_row_chunk(shr + i * V, sh);
      load_row_chunk(scr + i * V, sc);
#pragma unroll
      for (int j = 0; j < V; ++j) v[c][j] = v[c][j] * rstd * (1.0f + sc[j]) + sh[j];
      store_chunk(ho + i * V, v[c]);
    }
  }
}

template <typename T, int MODE, int NCH>
cudaError_t run(const Glue& g, cudaStream_t st) {
  const unsigned blocks = (unsigned)((g.rows + kRowsPerBlock - 1) / kRowsPerBlock);
  adaln_glue_kernel<T, NCH, MODE><<<blocks, kRowsPerBlock * 32, 0, st>>>(g);
  return cudaSuccess;
}

// The smallest instance that holds the row, of three: a lane holding a
// quarter, three quarters or all of kLaneVals values (bf16 NCH 2, 6, 8;
// fp32 4, 12, 16). The DiT's D = 1536 and 2048 take the two larger.
template <typename T, int MODE>
cudaError_t launch(const Glue& g, cudaStream_t st) {
  constexpr int kMax = kLaneVals / Chunk<T>::n;  // chunks a lane holds at most
  const int need = (g.D / Chunk<T>::n + 31) / 32;
  if (g.D <= 0 || g.D % Chunk<T>::n || need > kMax || g.S <= 0) return cudaErrorInvalidValue;
  if (need <= kMax / 4) return run<T, MODE, kMax / 4>(g, st);
  if (need <= kMax * 3 / 4) return run<T, MODE, kMax * 3 / 4>(g, st);
  return run<T, MODE, kMax>(g, st);
}

template <typename T>
cudaError_t launch_mode(int mode, const Glue& g, cudaStream_t st) {
  switch (mode) {
    case kLnModulate: return launch<T, kLnModulate>(g, st);
    case kGatedResidualLnModulate: return launch<T, kGatedResidualLnModulate>(g, st);
    case kGatedResidual: return launch<T, kGatedResidual>(g, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 ln_modulate (x, shift, scale -> h_out), 1 gated residual and
// ln_modulate (x, y, gate, shift, scale -> x_out, h_out), 2 gated residual
// (x, y, gate -> x_out); operands a mode does not take are null. x and y
// (B, S, D) with unit stride on D, a batch and a token stride; gate, shift
// and scale (B, D) rows `*_sb` apart; x_out and h_out (B, S, D)
// contiguous. Every row start 16-byte aligned. Returns cudaGetLastError().
extern "C" int ladcast_adaln_glue(int mode, const void* x, long long x_sb, long long x_st,
                                  const void* y, long long y_sb, long long y_st,
                                  const void* gate, long long gate_sb, const void* shift,
                                  long long shift_sb, const void* scale, long long scale_sb,
                                  void* x_out, void* h_out, long long B, int S, int D,
                                  float eps, int dtype, void* stream) {
  const Glue g{x, x_sb, x_st, y, y_sb, y_st, gate, gate_sb, shift, shift_sb,
               scale, scale_sb, x_out, h_out, B * S, S, D, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == kDtypeBF16 ? launch_mode<__nv_bfloat16>(mode, g, st)
                        : dtype == kDtypeF32 ? launch_mode<float>(mode, g, st)
                                             : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
