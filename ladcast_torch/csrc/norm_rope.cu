// K-side RMS-norm + interleaved RoPE pass of the DiT attention.
//
// Replaces: ladcast_tpu/ops/pallas/flash_attention.py:70 _norm_rope_kernel
// (launched by _preprocess_packed, :83).
//
// Computes, for every (b, s, head) row of x (B, S, H, D=128), in fp32:
//   n = x * rsqrt(mean(x^2) + eps) * w[s];  out = n*cos[s] + rot(n)*sin[s]
// and stores it in x's dtype (bf16 or fp32). Tables are (S, D) fp32.
//
// Bound on an H100: memory. Each row reads 256 B (bf16) and writes 256 B
// for ~10 flops per value, far below the ~295 flop/B at which the tensor
// cores, let alone the CUDA cores, would be the limit. At the main path's
// B=20, S=2250, H=12 that is 2 x 138 MB, about 83 us at 3.35 TB/s.
// Design: one warp per row, 4 contiguous values per lane (one 8- or 16-byte
// load and store, consecutive lanes on consecutive addresses), the mean of
// squares by warp shuffle, no shared memory. Table rows are re-read per
// head but stay in L2 (S x D x 12 B = 14 MB at S = 2250). The grid covers
// every row with a bounds check: S = 2250 is a multiple of no tile, and a
// pass that leaves the tail rows raw is the fault this layout rules out.

#include "norm_rope.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // 8 warps

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
norm_rope_kernel(const T* __restrict__ x, T* __restrict__ out,
                 const float* __restrict__ w, const float* __restrict__ cos,
                 const float* __restrict__ sin, long long rows, int S, int H,
                 float eps) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const long long s = (row / H) % S;
  const long long off = row * ladcast::kHeadDim + lane * 4;
  const long long toff = s * ladcast::kHeadDim;
  float v[4];
  ladcast::load4(x + off, v);
  ladcast::norm_rope4(v, w + toff, cos + toff, sin + toff, lane, eps);
  ladcast::store4(out + off, v);
}

}  // namespace

// x, out: (B, S, H, 128) contiguous, `rows` = B*S*H. Returns cudaGetLastError().
extern "C" int ladcast_norm_rope(const void* x, void* out, const float* w,
                                 const float* cos, const float* sin,
                                 long long rows, int S, int H, float eps,
                                 int dtype, void* stream) {
  const dim3 grid((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock));
  const dim3 block(kRowsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ladcast::kDtypeBF16) {
    norm_rope_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        w, cos, sin, rows, S, H, eps);
  } else if (dtype == ladcast::kDtypeF32) {
    norm_rope_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), w, cos, sin,
        rows, S, H, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
