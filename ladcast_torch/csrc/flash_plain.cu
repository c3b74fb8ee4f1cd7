// Plain non-causal flash attention in fp32 (forward), no norm and no RoPE.
//
// Replaces: ladcast_tpu/ops/pallas/flash_attention.py:601 _fa_plain_kernel
// (launched by _flash_attention_impl, :565; public entry flash_attention,
// :645).
//
// Inputs: q (B, Sq, H, D), k and v (B, Sk, H, D), all bf16 or all fp32, D
// <= 256. As the TPU kernel: every input is upcast to fp32 on load, Q is
// scaled by 1/sqrt(D) in fp32, logits, the online softmax (keys >= Sk
// masked), P.V, m, l and the accumulator are all fp32; the output is
// acc / l, cast to the input dtype at the store.
//
// Bound on an H100: both products are fp32 on the CUDA cores (the
// kernel's contract: no bf16 rounding of Q, K, V products or of P), 4 B H
// Sq Sk D flop at 67 TFLOP/s: 0.93 ms at (2, 2250, 12, 128) against 28 MB
// of traffic (8 us), so operations.
// Design: fa_f32_kernel of fused_attention.cu without its Q prologue and
// with a runtime head size: 32 x 32 tiles, 256 threads, 8 threads per
// query row, each owning 4 logits of a key tile and D/8 output columns;
// K, V and P tiles go through shared memory. Head sizes are padded to 64,
// 128 or 256 columns of zeros in shared memory only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr float kNegInf = -1e30f;  // as the TPU kernel: exp(kNegInf - m) == 0
constexpr int FM = 32, FN = 32, kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(bf16* p, float v) { *p = __float2bfloat16(v); }

template <int DP>
constexpr int smem_bytes() {
  return (FM * (DP + 4) + FN * (DP + 1) + FN * DP + FM * (FN + 1)) * (int)sizeof(float);
}

// Thread (r = tid / 8, part = tid % 8) owns S[r][part + 8j], j < 4, and
// O[r][part + 8i], i < DP / 8; the 8 threads of a row are consecutive lanes.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
fa_plain_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
                int H, int D, float scale) {
  constexpr int LQ = DP + 4, LK = DP + 1, LP = FN + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + FM * LQ;
  float* sV = sK + FN * LK;
  float* sP = sV + FN * DP;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * FM;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long rs = (long long)H * D;  // elements between sequence rows
  const T* qb = q + ((long long)b * Sq * H + h) * D;
  const T* kb = k + ((long long)b * Sk * H + h) * D;
  const T* vb = v + ((long long)b * Sk * H + h) * D;
  T* ob = out + ((long long)b * Sq * H + h) * D;

  for (int e = tid; e < FM * DP; e += kThreads) {
    const int r = e / DP, d = e % DP;
    sQ[r * LQ + d] = (q0 + r < Sq && d < D) ? to_float(qb[(q0 + r) * rs + d]) * scale : 0.f;
  }

  const int r = tid >> 3, part = tid & 7;
  float o[DP / 8];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) o[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const int n_tiles = (Sk + FN - 1) / FN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * FN;
    __syncthreads();
    for (int e = tid; e < FN * DP; e += kThreads) {
      const int kr = e / DP, d = e % DP;
      const bool in = k0 + kr < Sk && d < D;
      sK[kr * LK + d] = in ? to_float(kb[(k0 + kr) * rs + d]) : 0.f;
      sV[kr * DP + d] = in ? to_float(vb[(k0 + kr) * rs + d]) : 0.f;
    }
    __syncthreads();

    float s[FN / 8];
#pragma unroll
    for (int j = 0; j < FN / 8; ++j) {
      const int c = part + 8 * j;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) acc = fmaf(sQ[r * LQ + d], sK[c * LK + d], acc);
      s[j] = (k0 + c < Sk) ? acc : kNegInf;
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < FN / 8; ++j) mx = fmaxf(mx, s[j]);
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float alpha = expf(m - mx);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < FN / 8; ++j) {
      const float p = expf(s[j] - mx);
      sP[r * LP + part + 8 * j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l = l * alpha + sum;
    __syncwarp();  // a row's P is written and read by the same 8 lanes
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) o[i] *= alpha;
    for (int c = 0; c < FN; ++c) {
      const float p = sP[r * LP + c];
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) o[i] = fmaf(p, sV[c * DP + part + 8 * i], o[i]);
    }
  }

  if (q0 + r < Sq) {
#pragma unroll
    for (int i = 0; i < DP / 8; ++i)
      if (part + 8 * i < D) from_float(ob + (q0 + r) * rs + part + 8 * i, o[i] / l);
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
           int Sk, int H, int D, float scale, cudaStream_t st) {
  // once per instantiation: the larger head sizes pass the 48 KB default
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_plain_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<DP>());
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + FM - 1) / FM, B * H);
  fa_plain_kernel<T, DP><<<grid, kThreads, smem_bytes<DP>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, D, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
             int Sk, int H, int D, float scale, cudaStream_t st) {
  if (D <= 64) return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, D, scale, st);
  if (D <= 128) return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, D, scale, st);
  if (D <= 256) return launch<T, 256>(q, k, v, out, B, Sq, Sk, H, D, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out: (B, Sq, H, D); k, v: (B, Sk, H, D); contiguous, one dtype, D <=
// 256, B * H <= 65535. Returns cudaGetLastError().
extern "C" int ladcast_flash_attention(const void* q, const void* k, const void* v,
                                       void* out, int B, int Sq, int Sk, int H, int D,
                                       float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == kDtypeBF16) return dispatch<bf16>(q, k, v, out, B, Sq, Sk, H, D, scale, st);
  if (dtype == kDtypeF32) return dispatch<float>(q, k, v, out, B, Sq, Sk, H, D, scale, st);
  return (int)cudaErrorInvalidValue;
}
