// Flash-attention backward (non-causal) over pre-normed, pre-rotated Q and K.
//
// Replaces: ladcast_tpu/ops/pallas/flash_attention.py:279 _fa_bwd_dq_kernel
// and :318 _fa_bwd_dkv_kernel (launched by _fa_bwd_impl, :366; dispatched
// by _fnra_bwd, :506).
//
// Inputs: qn and g (B, Sq, H, 128), kn and v (B, Sk, H, 128), all bf16 or
// all fp32; lse and delta (B, H, Sq) fp32, the forward's logsumexp rows and
// rowsum(g * out). Per (b, head), in the TPU kernels' order:
//   P  = exp(scale * qn.kn^T - lse)      keys >= Sk and rows >= Sq masked
//   dS = P o (g.v^T - delta)
//   dq = scale * dS.kn,  dk = scale * dS^T.qn,  dv = P^T.g
// Operands are in the input dtype, products accumulate in fp32, and P and
// dS are cast to the input dtype before the products they feed.
// Two kernels, as on the TPU: the dq kernel walks the key tiles for one
// query tile, the dk/dv kernel walks the query tiles for one key tile. No
// block writes what another writes, so there are no atomics and the result
// does not change from run to run.
//
// Bound on an H100: the dq kernel does three products of 2*Sq*Sk*D flop per
// (b, head), the dk/dv kernel four (P^T and dS^T are recomputed there): at
// the training shapes B=4, H=12, Sq=Sk=2250 that is 6*B*H*S^2*D = 1.87e11
// and 8*B*H*S^2*D = 2.49e11 flop, 0.19 ms and 0.25 ms at 989 TFLOP/s bf16,
// against 5 (B, S, H, D) tensors of traffic each (0.14 GB, 41 us):
// compute-bound, as the forward is.
// Design (bf16): the shape of the attention forward (fused_attention.cu)
// on Hopper (sm_90a). A block is three warpgroups: two consumers of 64
// rows each and a producer whose first warp keeps a ring of kStages
// stages full; setmaxnreg moves registers from the producer (24 a thread)
// to the consumers (240). Every tile is 64 rows of one head (two TMA boxes
// of (64, 1, 64, 1) over the (D, H, S, B) tensor map, one per half of D,
// in the 128-byte swizzle that wgmma's descriptors read).
//  - dq kernel: a block per (128 query rows, b*head). TMA loads each
//    consumer's qn and g tiles once; tiles of kDqKeys keys of kn and v
//    stream through the ring. Per key tile a consumer issues S = qn.kn^T
//    and dP = g.v^T as wgmma m64n64k16 with both operands K-major in shared
//    memory (the forward's logits form), forms P = exp2 and dS = P o (dP -
//    delta) in registers, packs dS to bf16 in place as the A fragment of
//    dq += dS.kn, wgmma m64n128k16 with kn read MN-major through the
//    descriptor's transpose bit (the forward's P.V form).
//  - dk/dv kernel: a block per (128 keys, b*head). TMA loads each
//    consumer's kn and v tiles once; tiles of kDkvRows query rows of qn and
//    g, with their lse and delta rows, stream through the ring. Per query
//    tile: S^T = kn.qn^T and dP^T = v.g^T (m64n64k16, shared memory), P^T
//    and dS^T in registers, then dv += bf16(P^T).g and dk += bf16(dS^T).qn
//    (m64n128k16, A from registers, g and qn MN-major).
// Registers set the 64-wide walked tiles: a consumer holds its 64 x 128
// fp32 output (dq: 64 a thread; dk and dv: 128) beside S and dP (32 each
// at 64 columns, 64 each at 128, which would not fit in 240 beside dk
// and dv).
// The lse and delta rows of a head start 4*Sq bytes apart (9000 at
// Sq=2250), no multiple of 16, so no bulk copy takes them: the dk/dv
// producer's 32 lanes load a tile's 64 values of each with ordinary loads
// into the stage, and each lane arrives on the stage's "full" barrier
// (33 arrivals with the one that expects the TMA bytes). The dq consumers
// read their own rows' values once.
// The ragged tail: the tensor maps zero-fill rows past S (2250 = 35*64 +
// 10) and P is still masked by index, since a zero-filled key gives
// exp(0 - lse) != 0; padded query rows get zero lse and delta, so their
// dS is zero, and they are not stored.
// The ring: each stage has a "full" mbarrier and an "empty" one, on which
// every consumer warp arrives once the products that read the stage have
// retired, so the producer never refills a stage still being read. The
// consumers take turns issuing their products (named barriers 1 and 2),
// so one's exp2 and dS work overlaps the other's products.
// Design (fp32: the parity dtype, and `train_ar --compute_dtype float32`):
// the same two kernels on wgmma over bf16 terms, as the plain flash
// attention (flash_plain.cu) carries fp32. No product of an input, and no P
// or dS, is rounded to bf16:
//  - a split pass (bwd_f32_split_kernel, run by each entry, its time part
//    of the kernel's) writes qn, kn, v and g once as kPlanes = 3 bf16 planes
//    (hi, mid, lo: each the rounding to nearest of what the planes before
//    it left); products of bf16 values are exact in fp32, so S and dP are
//    the six plane products Ai.Bj^T with i + j <= 2 (the dropped terms are
//    below 2^-26 of a product; dP - delta cancels, so dP keeps all six);
//  - P and dS are formed in fp32 registers and split into three bf16 terms
//    each, packed as A fragments; dq (or dv, then dk) gets the six products
//    Ti.Bj of a walked tile into a fresh accumulator, added to the running
//    sum in registers: wgmma's accumulation is coarser than fp32 adds, and
//    one accumulator over 2250 keys is expected to miss the fp32 check, as
//    it missed the plain attention's;
//  - shared memory: three planes of a kept tile take 3x the bytes, so a
//    block keeps kF32Rows = 64 rows of its two kept tensors (qn and g, or
//    kn and v: 96 KB) and walks tiles of kF32Walk = 32 rows through a ring
//    of kF32Stages = 2 stages of 48 KB. The two consumers share the kept
//    rows and take the walked tiles in turn (a stage is always the same
//    consumer's), since splitting D's columns would compute S and dP
//    twice; each keeps its own sums, which are added through the drained
//    ring's bytes at the end, in a fixed order (no atomics, the same bits
//    every run). No ping-pong: each consumer's softmax and split overlap
//    the other's products;
//  - registers: S and dP are m64n32 (16 a thread each); the dq consumer
//    holds dq and a fresh m64n128 accumulator (64 + 64); the dk/dv consumer
//    holds dk and dv (64 + 64) and issues each fresh product in two m64n64
//    halves (32), with P^T split into terms before dS^T, which waits in
//    fp32;
//  - the tails: the maps zero-fill rows past S, P is still masked by index,
//    and the dk/dv producer's lanes load a walked tile's lse and delta rows
//    (one row a lane), as in bf16.
// Bound: 6 bf16 passes of each product, 1.13 ms (dq) and 1.51 ms (dk/dv)
// at B=4, H=12, S=2250, against 2.79 and 3.71 ms in fp32 on the CUDA cores,
// beside about 0.18 GB of split traffic per entry (0.06 ms).

#include <math.h>

#include "hopper.cuh"
#include "norm_rope.cuh"

namespace {

namespace hp = ladcast::hopper;
using bf16 = __nv_bfloat16;
using ladcast::pack_bf16;
constexpr int D = ladcast::kHeadDim;
constexpr float kLog2e = 1.4426950408889634f;

// ----------------------------------------------------------------- bf16 ---
constexpr int kRows = 64;              // rows of a tile, and of a consumer
constexpr int kDqRows = 2 * kRows;     // query rows of a dq block
constexpr int kDqKeys = kRows;         // keys of a dq key tile
constexpr int kDkvKeys = 2 * kRows;    // keys of a dk/dv block
constexpr int kDkvRows = kRows;        // query rows of a dk/dv query tile
constexpr int kStages = 2;             // walked tiles in the ring
constexpr int kThreads = 3 * 128;      // consumers 0 and 1, producer 2
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kHalfBytes = kRows * 128;  // a box: 64 rows of half a head row
constexpr int kTileBytes = 2 * kHalfBytes;
constexpr int kBarBytes = 1024;        // mbarriers, and the alignment slack
constexpr int kSmemDq = (4 + 2 * kStages) * kTileBytes + 2 * kBarBytes;
constexpr int kSmemDkv = (4 + 2 * kStages) * kTileBytes
                         + 2 * kStages * kDkvRows * (int)sizeof(float) + 2 * kBarBytes;

// Descriptor offsets, in the 16-byte units of the start address field.
constexpr uint64_t kDescTile = kTileBytes / 16;
constexpr uint64_t kDescK16 = 32 / 16;            // 16 bf16 along D
constexpr uint64_t kDescRows16 = 16 * 128 / 16;   // 16 rows, read MN-major

// K-major k-step kk (16 of D) of a tile of ROWS rows whose descriptor is
// `desc`.
template <int ROWS = kRows>
__device__ __forceinline__ uint64_t k_step(uint64_t desc, int kk) {
  return desc + (kk >> 2) * (ROWS * 128 / 16) + (kk & 3) * kDescK16;
}

// Rows [r0, r0 + ROWS) of head h, batch b of a (B, S, H, 128) map into a
// tile: two boxes, one per half of D; rows past S read as zeros.
template <int ROWS = kRows>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int h, int r0, int b) {
  hp::tma_load_4d(dst, map, bar, 0, h, r0, b);
  hp::tma_load_4d(dst + ROWS * 128, map, bar, 64, h, r0, b);
}

// The 64 x 128 fp32 fragment accumulator (m64n128 layout) times `mul`,
// rows >= S dropped, into rows [r0, r0 + 64) of a (S, D) slice with row
// stride rs.
__device__ __forceinline__ void store_tile(bf16* dst, const float (&acc)[64], float mul,
                                           int r0, int S, long long rs) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int ra = r0 + warp * 16 + (lane >> 2), rb = ra + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    if (ra < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + ra * rs + col) =
          __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (rb < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + rb * rs + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// The same into an fp32 slice.
__device__ __forceinline__ void store_tile(float* dst, const float (&acc)[64], float mul,
                                           int r0, int S, long long rs) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int ra = r0 + warp * 16 + (lane >> 2), rb = ra + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    if (ra < S)
      *reinterpret_cast<float2*>(dst + ra * rs + col) =
          make_float2(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (rb < S)
      *reinterpret_cast<float2*>(dst + rb * rs + col) =
          make_float2(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_bf16_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                         __grid_constant__ const CUtensorMap tm_k,
                         __grid_constant__ const CUtensorMap tm_v,
                         __grid_constant__ const CUtensorMap tm_g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int Sq, int Sk, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  unsigned char* sQ = smem_raw + ((1024 - (hp::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sG = sQ + 2 * kTileBytes;        // a tile per consumer
  unsigned char* sK = sG + 2 * kTileBytes;        // kStages tiles
  unsigned char* sV = sK + kStages * kTileBytes;
  uint64_t* full_qg = reinterpret_cast<uint64_t*>(sV + kStages * kTileBytes);
  uint64_t* full = full_qg + 1;
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * kDqRows;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n_tiles = (Sk + kDqKeys - 1) / kDqKeys;

  if (threadIdx.x == 0) {
    hp::mbar_init(full_qg, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ---- producer: one thread keeps the ring full
    hp::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      hp::mbar_arrive_expect_tx(full_qg, 4 * kTileBytes);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        load_tile(sQ + c * kTileBytes, &tm_q, full_qg, h, q0 + c * kRows, b);
        load_tile(sG + c * kTileBytes, &tm_g, full_qg, h, q0 + c * kRows, b);
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        hp::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(&full[s], 2 * kTileBytes);
        load_tile(sK + s * kTileBytes, &tm_k, &full[s], h, kt * kDqKeys, b);
        load_tile(sV + s * kTileBytes, &tm_v, &full[s], h, kt * kDqKeys, b);
      }
    }
    return;
  }

  // ---- consumers 0 and 1: 64 query rows each
  hp::setmaxnreg_inc<kConsumerRegs>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  // rows r0 and r0 + 8 of the tile are this thread's; padded rows get zero
  // statistics, so their dS is zero (and they are not stored)
  const int r0 = q0 + wg * kRows + warp * 16 + (lane >> 2);
  const float* lrow = lse + ((long long)b * H + h) * Sq;
  const float* drow = delta + ((long long)b * H + h) * Sq;
  const float l0 = r0 < Sq ? lrow[r0] * kLog2e : 0.f;
  const float l1 = r0 + 8 < Sq ? lrow[r0 + 8] * kLog2e : 0.f;
  const float d0 = r0 < Sq ? drow[r0] : 0.f;
  const float d1 = r0 + 8 < Sq ? drow[r0 + 8] : 0.f;
  const float sl = scale * kLog2e;  // exp(scale*s - lse) == exp2(sl*s - lse*log2e)

  const uint64_t desc_q = hp::smem_desc_sw128(sQ + wg * kTileBytes, 16, 1024);
  const uint64_t desc_g = hp::smem_desc_sw128(sG + wg * kTileBytes, 16, 1024);
  const uint64_t desc_k = hp::smem_desc_sw128(sK, 16, 1024);
  const uint64_t desc_v = hp::smem_desc_sw128(sV, 16, 1024);
  const uint64_t desc_kt = hp::smem_desc_sw128(sK, kHalfBytes, 1024);  // MN-major
  const int my_turn = 1 + wg, their_turn = 2 - wg;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float sc[32], dp[32];
  uint32_t ds[16];

  hp::mbar_wait(full_qg, 0);
  if (wg == 1) hp::named_arrive(1, 256);  // consumer 0 takes the first turn

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % kStages;
    const uint32_t parity = (kt / kStages) & 1;

    // S = qn kn^T and dP = g v^T: 64 rows x 64 keys, 8 k-steps of 16 along D
    hp::mbar_wait(&full[s], parity);
    hp::named_sync(my_turn, 256);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::wgmma_m64n64k16_ss(sc, k_step(desc_q, kk),
                             k_step(desc_k + s * kDescTile, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::wgmma_m64n64k16_ss(dp, k_step(desc_g, kk),
                             k_step(desc_v + s * kDescTile, kk), kk > 0);
    hp::wgmma_commit();
    hp::named_arrive(their_turn, 256);
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    hp::fence_regs(dp);

    // P = exp(scale s - lse), keys >= Sk (the ragged last tile) masked;
    // dS = P (dP - delta) in fp32, packed to bf16 as the A fragment: key
    // k-step kk is n-blocks 2kk, 2kk + 1, that is ds[4kk .. 4kk+3]
    const int k0 = kt * kDqKeys;
    const bool tail = k0 + kDqKeys > Sk;
#pragma unroll
    for (int j = 0; j < kDqKeys / 8; ++j) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = hp::exp2_ftz(fmaf(sc[4 * j + i], sl, -(i < 2 ? l0 : l1)));
        if (tail && k0 + 8 * j + 2 * (lane & 3) + (i & 1) >= Sk) p = 0.f;
        v[i] = p * (dp[4 * j + i] - (i < 2 ? d0 : d1));
      }
      ds[2 * j] = pack_bf16(v[0], v[1]);
      ds[2 * j + 1] = pack_bf16(v[2], v[3]);
    }

    // dq += dS kn: 4 k-steps of 16 keys
    hp::named_sync(my_turn, 256);
    hp::fence_regs(acc);
    hp::fence_regs(ds);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk)
      hp::wgmma_m64n128k16_rs_tnsp_b(acc, &ds[4 * kk],
                                     desc_kt + s * kDescTile + kk * kDescRows16, 1);
    hp::wgmma_commit();
    // every sync of one consumer is matched by one arrival of the other:
    // consumer 1 skips its last, consumer 0 had one from the start
    if (wg == 0 || kt + 1 < n_tiles) hp::named_arrive(their_turn, 256);
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    if (lane == 0) hp::mbar_arrive(&empty[s]);  // this warp is done with stage s
    __syncwarp();
  }
  store_tile(dq + ((long long)b * Sq * H + h) * D, acc, scale, q0 + wg * kRows, Sq,
             (long long)H * D);
}

__global__ void __launch_bounds__(kThreads, 1)
bwd_dkv_bf16_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                          __grid_constant__ const CUtensorMap tm_k,
                          __grid_constant__ const CUtensorMap tm_v,
                          __grid_constant__ const CUtensorMap tm_g,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
                          int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = smem_raw + ((1024 - (hp::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sV = sK + 2 * kTileBytes;        // a tile per consumer
  unsigned char* sQ = sV + 2 * kTileBytes;        // kStages tiles
  unsigned char* sG = sQ + kStages * kTileBytes;
  float* sL = reinterpret_cast<float*>(sG + kStages * kTileBytes);  // kStages x 64
  float* sD = sL + kStages * kDkvRows;
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sD + kStages * kDkvRows);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kDkvKeys;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n_tiles = (Sq + kDkvRows - 1) / kDkvRows;

  if (threadIdx.x == 0) {
    hp::mbar_init(full_kv, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 33);  // the producer warp's lanes + the TMA bytes
      hp::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ---- producer: its first warp keeps the ring full
    hp::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 2 * 128 + 32) {
      if (lane == 0) {
        hp::mbar_arrive_expect_tx(full_kv, 4 * kTileBytes);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          load_tile(sK + c * kTileBytes, &tm_k, full_kv, h, k0 + c * kRows, b);
          load_tile(sV + c * kTileBytes, &tm_v, full_kv, h, k0 + c * kRows, b);
        }
      }
      const float* lrow = lse + ((long long)b * H + h) * Sq;
      const float* drow = delta + ((long long)b * H + h) * Sq;
      for (int qt = 0; qt < n_tiles; ++qt) {
        const int s = qt % kStages;
        hp::mbar_wait(&empty[s], ((qt / kStages) & 1) ^ 1);
        if (lane == 0) {
          hp::mbar_arrive_expect_tx(&full[s], 2 * kTileBytes);
          load_tile(sQ + s * kTileBytes, &tm_q, &full[s], h, qt * kDkvRows, b);
          load_tile(sG + s * kTileBytes, &tm_g, &full[s], h, qt * kDkvRows, b);
        }
        // the rows' statistics (lse in log2 units for the exp2; zero for
        // padded rows, which the mask drops)
#pragma unroll
        for (int i = lane; i < kDkvRows; i += 32) {
          const int row = qt * kDkvRows + i;
          sL[s * kDkvRows + i] = row < Sq ? lrow[row] * kLog2e : 0.f;
          sD[s * kDkvRows + i] = row < Sq ? drow[row] : 0.f;
        }
        hp::mbar_arrive(&full[s]);  // releases this lane's stores
      }
    }
    return;
  }

  // ---- consumers 0 and 1: 64 keys each
  hp::setmaxnreg_inc<kConsumerRegs>();
  const float sl = scale * kLog2e;
  const uint64_t desc_k = hp::smem_desc_sw128(sK + wg * kTileBytes, 16, 1024);
  const uint64_t desc_v = hp::smem_desc_sw128(sV + wg * kTileBytes, 16, 1024);
  const uint64_t desc_q = hp::smem_desc_sw128(sQ, 16, 1024);
  const uint64_t desc_g = hp::smem_desc_sw128(sG, 16, 1024);
  const uint64_t desc_qt = hp::smem_desc_sw128(sQ, kHalfBytes, 1024);  // MN-major
  const uint64_t desc_gt = hp::smem_desc_sw128(sG, kHalfBytes, 1024);
  const int my_turn = 1 + wg, their_turn = 2 - wg;

  float ak[64], av[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) ak[i] = av[i] = 0.f;
  float st[32], dpt[32];
  uint32_t pp[16], ds[16];

  hp::mbar_wait(full_kv, 0);
  if (wg == 1) hp::named_arrive(1, 256);  // consumer 0 takes the first turn

  for (int qt = 0; qt < n_tiles; ++qt) {
    const int s = qt % kStages;
    const uint32_t parity = (qt / kStages) & 1;

    // S^T = kn qn^T and dP^T = v g^T: 64 keys x 64 query rows
    hp::mbar_wait(&full[s], parity);
    hp::named_sync(my_turn, 256);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::wgmma_m64n64k16_ss(st, k_step(desc_k, kk),
                             k_step(desc_q + s * kDescTile, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::wgmma_m64n64k16_ss(dpt, k_step(desc_v, kk),
                             k_step(desc_g + s * kDescTile, kk), kk > 0);
    hp::wgmma_commit();
    hp::named_arrive(their_turn, 256);
    hp::wgmma_wait<0>();
    hp::fence_regs(st);
    hp::fence_regs(dpt);

    // P^T and dS^T: a column is a query row, whose statistics the stage
    // holds; rows >= Sq (the ragged last tile) masked
    const float* tl = sL + s * kDkvRows;
    const float* td = sD + s * kDkvRows;
    const int q0 = qt * kDkvRows;
    const bool tail = q0 + kDkvRows > Sq;
#pragma unroll
    for (int j = 0; j < kDkvRows / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 lc = *reinterpret_cast<const float2*>(tl + c);
      const float2 dc = *reinterpret_cast<const float2*>(td + c);
      float p[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = hp::exp2_ftz(fmaf(st[4 * j + i], sl, -((i & 1) ? lc.y : lc.x)));
        if (tail && q0 + c + (i & 1) >= Sq) p[i] = 0.f;
        v[i] = p[i] * (dpt[4 * j + i] - ((i & 1) ? dc.y : dc.x));
      }
      pp[2 * j] = pack_bf16(p[0], p[1]);
      pp[2 * j + 1] = pack_bf16(p[2], p[3]);
      ds[2 * j] = pack_bf16(v[0], v[1]);
      ds[2 * j + 1] = pack_bf16(v[2], v[3]);
    }

    // dv += P^T g and dk += dS^T qn: 4 k-steps of 16 query rows each
    hp::named_sync(my_turn, 256);
    hp::fence_regs(av);
    hp::fence_regs(ak);
    hp::fence_regs(pp);
    hp::fence_regs(ds);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDkvRows / 16; ++kk)
      hp::wgmma_m64n128k16_rs_tnsp_b(av, &pp[4 * kk],
                                     desc_gt + s * kDescTile + kk * kDescRows16, 1);
#pragma unroll
    for (int kk = 0; kk < kDkvRows / 16; ++kk)
      hp::wgmma_m64n128k16_rs_tnsp_b(ak, &ds[4 * kk],
                                     desc_qt + s * kDescTile + kk * kDescRows16, 1);
    hp::wgmma_commit();
    if (wg == 0 || qt + 1 < n_tiles) hp::named_arrive(their_turn, 256);
    hp::wgmma_wait<0>();
    hp::fence_regs(av);
    hp::fence_regs(ak);
    if (lane == 0) hp::mbar_arrive(&empty[s]);  // this warp is done with stage s
    __syncwarp();
  }
  const long long koff = ((long long)b * Sk * H + h) * D;
  store_tile(dk + koff, ak, scale, k0 + wg * kRows, Sk, (long long)H * D);
  store_tile(dv + koff, av, 1.f, k0 + wg * kRows, Sk, (long long)H * D);
}

// ----------------------------------------------------------------- fp32 ---
using ladcast::kPlanes;             // bf16 planes of an operand, terms of P and dS
constexpr int kF32Rows = 64;        // rows a block keeps: query rows, or keys
constexpr int kF32Walk = 32;        // rows of a walked tile
constexpr int kF32Stages = 2;       // walked tiles in the ring
constexpr int kKeepBox = kF32Rows * 128;  // a kept box: half a head row a row
constexpr int kWalkBox = kF32Walk * 128;
constexpr int kKeepPlane = 2 * kKeepBox;  // one plane of a kept tile, 16 KB
constexpr int kWalkPlane = 2 * kWalkBox;  // one plane of a walked tile, 8 KB
constexpr int kKeepBytes = kPlanes * kKeepPlane;  // a kept tensor's planes
constexpr int kWalkBytes = kPlanes * kWalkPlane;  // a walked tensor's planes
constexpr int kF32StageBytes = 2 * kWalkBytes;    // two walked tensors
constexpr int kSmemF32 = 2 * kKeepBytes + kF32Stages * kF32StageBytes
                         + 2 * kF32Stages * kF32Walk * (int)sizeof(float) + 2 * kBarBytes;
static_assert(kSmemF32 <= 232448, "shared memory of a block");
// the consumers take the walked tiles in turn, so each stage is one's
static_assert(kF32Stages % 2 == 0, "a stage belongs to one consumer");
// the dk/dv producer's lanes load one row's lse and delta each
static_assert(kF32Walk == 32, "a walked row a lane");

// S (64 x 32) = sum of Ai.Bj^T over the plane pairs i + j <= 2, smallest
// terms first, into a fresh accumulator: A a kept tile's planes (64 rows),
// B a walked tile's (32 rows), both K-major in shared memory from plane 0.
__device__ __forceinline__ void plane_logits(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b) {
  int acc = 0;
#pragma unroll
  for (int ij = 2; ij >= 0; --ij)
#pragma unroll
    for (int i = ij; i >= 0; --i) {
      const int j = ij - i;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hp::wgmma_m64n32k16_ss(d, k_step<kF32Rows>(desc_a + i * (kKeepPlane / 16), kk),
                               k_step<kF32Walk>(desc_b + j * (kWalkPlane / 16), kk), acc);
        acc = 1;
      }
    }
}

// x (a 64 x 32 fragment) as kPlanes bf16 terms, each the rounding to
// nearest of what the terms before it left, packed as A fragments: walked
// k-step kk is n-blocks 2kk, 2kk + 1, that is t[n][4kk .. 4kk + 3].
__device__ __forceinline__ void split_terms(const float (&x)[16],
                                            uint32_t (&t)[kPlanes][8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v[4] = {x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]};
#pragma unroll
    for (int n = 0; n < kPlanes; ++n) {
      t[n][2 * j] = ladcast::take_bf16x2(v[0], v[1]);
      t[n][2 * j + 1] = ladcast::take_bf16x2(v[2], v[3]);
    }
  }
}

// acc (64 x 128) += sum of Ti.Bj over i + j <= 2, smallest terms first: T
// the terms in registers, B a walked tile's planes read MN-major from plane
// 0 (desc_bt). wgmma's accumulation is coarser than fp32 adds, so the
// tile's products go into a fresh accumulator fr, added to acc in
// registers: in one product of N = 128 columns, or two of 64 (fr then
// holds half the columns, which leaves the dk/dv consumer registers for
// both of its sums).
template <int N>
__device__ __forceinline__ void add_plane_products(float (&acc)[64], float (&fr)[N / 2],
                                                   uint32_t (&t)[kPlanes][8],
                                                   uint64_t desc_bt) {
#pragma unroll
  for (int part = 0; part < D / N; ++part) {
    hp::fence_regs(fr);
#pragma unroll
    for (int n = 0; n < kPlanes; ++n) hp::fence_regs(t[n]);
    hp::wgmma_fence();
    int a = 0;
#pragma unroll
    for (int ij = 2; ij >= 0; --ij)
#pragma unroll
      for (int i = ij; i >= 0; --i) {
        const int j = ij - i;
#pragma unroll
        for (int kk = 0; kk < kF32Walk / 16; ++kk) {
          const uint64_t bd =
              desc_bt + (j * kWalkPlane + part * kWalkBox) / 16 + kk * kDescRows16;
          if constexpr (N == 128) hp::wgmma_m64n128k16_rs_tnsp_b(fr, &t[i][4 * kk], bd, a);
          else hp::wgmma_m64n64k16_rs_tnsp_b(fr, &t[i][4 * kk], bd, a);
          a = 1;
        }
      }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(fr);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[part * (N / 2) + i] += fr[i];
  }
}

// A block per (kF32Rows query rows, b*head), over the planes of qn, kn, v
// and g (plane p of batch b is batch p B + b of each map).
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_f32_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                        __grid_constant__ const CUtensorMap tm_k,
                        __grid_constant__ const CUtensorMap tm_v,
                        __grid_constant__ const CUtensorMap tm_g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int B, int Sq, int Sk, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (hp::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sG = sQ + kKeepBytes;
  unsigned char* sW = sG + kKeepBytes;  // stages: kn's planes, then v's
  uint64_t* full_qg = reinterpret_cast<uint64_t*>(sW + kF32Stages * kF32StageBytes);
  uint64_t* full = full_qg + 1;
  uint64_t* empty = full + kF32Stages;

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * kF32Rows;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n_tiles = (Sk + kF32Walk - 1) / kF32Walk;

  if (threadIdx.x == 0) {
    hp::mbar_init(full_qg, 1);
#pragma unroll
    for (int s = 0; s < kF32Stages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 4);  // one arrival per warp of its consumer
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ---- producer: one thread keeps the ring full
    hp::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      hp::mbar_arrive_expect_tx(full_qg, 2 * kKeepBytes);
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        load_tile<kF32Rows>(sQ + p * kKeepPlane, &tm_q, full_qg, h, q0, p * B + b);
        load_tile<kF32Rows>(sG + p * kKeepPlane, &tm_g, full_qg, h, q0, p * B + b);
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kF32Stages;
        unsigned char* stage = sW + s * kF32StageBytes;
        hp::mbar_wait(&empty[s], ((kt / kF32Stages) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(&full[s], kF32StageBytes);
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          load_tile<kF32Walk>(stage + p * kWalkPlane, &tm_k, &full[s], h, kt * kF32Walk,
                              p * B + b);
          load_tile<kF32Walk>(stage + kWalkBytes + p * kWalkPlane, &tm_v, &full[s], h,
                              kt * kF32Walk, p * B + b);
        }
      }
    }
    return;
  }

  // ---- consumers 0 and 1: the same 64 query rows, alternate key tiles
  hp::setmaxnreg_inc<kConsumerRegs>();
  const int t = threadIdx.x % 128, lane = t % 32, warp = t / 32;
  // rows r0 and r0 + 8 are this thread's; padded rows get zero statistics,
  // so their dS is zero (g's rows there are zero too), and are not stored
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const float* lrow = lse + ((long long)b * H + h) * Sq;
  const float* drow = delta + ((long long)b * H + h) * Sq;
  const float l0 = r0 < Sq ? lrow[r0] * kLog2e : 0.f;
  const float l1 = r0 + 8 < Sq ? lrow[r0 + 8] * kLog2e : 0.f;
  const float d0 = r0 < Sq ? drow[r0] : 0.f;
  const float d1 = r0 + 8 < Sq ? drow[r0 + 8] : 0.f;
  const float sl = scale * kLog2e;  // exp(scale*s - lse) == exp2(sl*s - lse*log2e)

  const uint64_t desc_q = hp::smem_desc_sw128(sQ, 16, 1024);
  const uint64_t desc_g = hp::smem_desc_sw128(sG, 16, 1024);
  const uint64_t desc_w = hp::smem_desc_sw128(sW, 16, 1024);
  const uint64_t desc_wt = hp::smem_desc_sw128(sW, kWalkBox, 1024);  // MN-major

  float acc[64], fr[64], sc[16], dp[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t ds[kPlanes][8];

  hp::mbar_wait(full_qg, 0);
  for (int kt = wg; kt < n_tiles; kt += 2) {
    const int s = kt % kF32Stages;
    const uint64_t stage = s * kF32StageBytes / 16;

    // S = qn kn^T and dP = g v^T: 64 rows x 32 keys, six plane products
    // each (dP - delta cancels, so dP keeps all six)
    hp::mbar_wait(&full[s], (kt / kF32Stages) & 1);
    hp::wgmma_fence();
    plane_logits(sc, desc_q, desc_w + stage);
    plane_logits(dp, desc_g, desc_w + stage + kWalkBytes / 16);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    hp::fence_regs(dp);

    // P = exp(scale s - lse), keys >= Sk (the ragged last tile) masked;
    // dS = P (dP - delta) in fp32, in place of S
    const int k0 = kt * kF32Walk;
    const bool tail = k0 + kF32Walk > Sk;
#pragma unroll
    for (int j = 0; j < kF32Walk / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = hp::exp2_ftz(fmaf(sc[4 * j + i], sl, -(i < 2 ? l0 : l1)));
        if (tail && k0 + 8 * j + 2 * (lane & 3) + (i & 1) >= Sk) p = 0.f;
        sc[4 * j + i] = p * (dp[4 * j + i] - (i < 2 ? d0 : d1));
      }
    split_terms(sc, ds);

    // dq += dS kn: six plane products of 2 k-steps of 16 keys
    add_plane_products<128>(acc, fr, ds, desc_wt + stage);
    if (lane == 0) hp::mbar_arrive(&empty[s]);  // this warp is done with stage s
    __syncwarp();
  }

  // dq = (consumer 0's sum + consumer 1's) scale; the ring is drained, so
  // its bytes carry consumer 1's sum
  float* xch = reinterpret_cast<float*>(sW);
  hp::named_sync(1, 256);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 64; ++i) xch[i * 128 + t] = acc[i];
  }
  hp::named_sync(1, 256);
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += xch[i * 128 + t];
    store_tile(dq + ((long long)b * Sq * H + h) * D, acc, scale, q0, Sq, (long long)H * D);
  }
}

// A block per (kF32Rows keys, b*head), over the planes as the dq kernel.
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkv_f32_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                         __grid_constant__ const CUtensorMap tm_k,
                         __grid_constant__ const CUtensorMap tm_v,
                         __grid_constant__ const CUtensorMap tm_g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int B, int Sq,
                         int Sk, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = smem_raw + ((1024 - (hp::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sV = sK + kKeepBytes;
  unsigned char* sW = sV + kKeepBytes;  // stages: qn's planes, then g's
  float* sL = reinterpret_cast<float*>(sW + kF32Stages * kF32StageBytes);
  float* sD = sL + kF32Stages * kF32Walk;
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sD + kF32Stages * kF32Walk);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + kF32Stages;

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kF32Rows;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n_tiles = (Sq + kF32Walk - 1) / kF32Walk;

  if (threadIdx.x == 0) {
    hp::mbar_init(full_kv, 1);
#pragma unroll
    for (int s = 0; s < kF32Stages; ++s) {
      hp::mbar_init(&full[s], 33);  // the producer warp's lanes + the TMA bytes
      hp::mbar_init(&empty[s], 4);  // one arrival per warp of its consumer
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ---- producer: its first warp keeps the ring full
    hp::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 2 * 128 + 32) {
      if (lane == 0) {
        hp::mbar_arrive_expect_tx(full_kv, 2 * kKeepBytes);
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          load_tile<kF32Rows>(sK + p * kKeepPlane, &tm_k, full_kv, h, k0, p * B + b);
          load_tile<kF32Rows>(sV + p * kKeepPlane, &tm_v, full_kv, h, k0, p * B + b);
        }
      }
      const float* lrow = lse + ((long long)b * H + h) * Sq;
      const float* drow = delta + ((long long)b * H + h) * Sq;
      for (int qt = 0; qt < n_tiles; ++qt) {
        const int s = qt % kF32Stages;
        unsigned char* stage = sW + s * kF32StageBytes;
        hp::mbar_wait(&empty[s], ((qt / kF32Stages) & 1) ^ 1);
        if (lane == 0) {
          hp::mbar_arrive_expect_tx(&full[s], kF32StageBytes);
#pragma unroll
          for (int p = 0; p < kPlanes; ++p) {
            load_tile<kF32Walk>(stage + p * kWalkPlane, &tm_q, &full[s], h, qt * kF32Walk,
                                p * B + b);
            load_tile<kF32Walk>(stage + kWalkBytes + p * kWalkPlane, &tm_g, &full[s], h,
                                qt * kF32Walk, p * B + b);
          }
        }
        // this lane's row's statistics (lse in log2 units for the exp2;
        // zero for padded rows, which the mask drops)
        const int row = qt * kF32Walk + lane;
        sL[s * kF32Walk + lane] = row < Sq ? lrow[row] * kLog2e : 0.f;
        sD[s * kF32Walk + lane] = row < Sq ? drow[row] : 0.f;
        hp::mbar_arrive(&full[s]);  // releases this lane's stores
      }
    }
    return;
  }

  // ---- consumers 0 and 1: the same 64 keys, alternate query tiles
  hp::setmaxnreg_inc<kConsumerRegs>();
  const int t = threadIdx.x % 128;
  const float sl = scale * kLog2e;
  const uint64_t desc_k = hp::smem_desc_sw128(sK, 16, 1024);
  const uint64_t desc_v = hp::smem_desc_sw128(sV, 16, 1024);
  const uint64_t desc_w = hp::smem_desc_sw128(sW, 16, 1024);
  const uint64_t desc_wt = hp::smem_desc_sw128(sW, kWalkBox, 1024);  // MN-major

  float ak[64], av[64], fr[32], st[16], dpt[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) ak[i] = av[i] = 0.f;
  uint32_t terms[kPlanes][8];

  hp::mbar_wait(full_kv, 0);
  for (int qt = wg; qt < n_tiles; qt += 2) {
    const int s = qt % kF32Stages;
    const uint64_t stage = s * kF32StageBytes / 16;

    // S^T = kn qn^T and dP^T = v g^T: 64 keys x 32 query rows
    hp::mbar_wait(&full[s], (qt / kF32Stages) & 1);
    hp::wgmma_fence();
    plane_logits(st, desc_k, desc_w + stage);
    plane_logits(dpt, desc_v, desc_w + stage + kWalkBytes / 16);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(st);
    hp::fence_regs(dpt);

    // P^T and dS^T in fp32 (in place): a column is a query row, whose
    // statistics the stage holds; rows >= Sq (the ragged last tile) masked
    const float* tl = sL + s * kF32Walk;
    const float* td = sD + s * kF32Walk;
    const int q0 = qt * kF32Walk;
    const bool tail = q0 + kF32Walk > Sq;
#pragma unroll
    for (int j = 0; j < kF32Walk / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 lc = *reinterpret_cast<const float2*>(tl + c);
      const float2 dc = *reinterpret_cast<const float2*>(td + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = hp::exp2_ftz(fmaf(st[4 * j + i], sl, -((i & 1) ? lc.y : lc.x)));
        if (tail && q0 + c + (i & 1) >= Sq) p = 0.f;
        st[4 * j + i] = p;
        dpt[4 * j + i] = p * (dpt[4 * j + i] - ((i & 1) ? dc.y : dc.x));
      }
    }

    // dv += P^T g, then dk += dS^T qn: six plane products each, in halves
    split_terms(st, terms);
    add_plane_products<64>(av, fr, terms, desc_wt + stage + kWalkBytes / 16);
    split_terms(dpt, terms);
    add_plane_products<64>(ak, fr, terms, desc_wt + stage);
    if (lane == 0) hp::mbar_arrive(&empty[s]);  // this warp is done with stage s
    __syncwarp();
  }

  // dk and dv are the two consumers' sums: consumer 1 hands over its dk,
  // consumer 0 its dv, through the drained ring; 0 stores dk, 1 stores dv
  float* xch = reinterpret_cast<float*>(sW);
  hp::named_sync(1, 256);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 64; ++i) xch[i * 128 + t] = ak[i];
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) xch[(64 + i) * 128 + t] = av[i];
  }
  hp::named_sync(1, 256);
  const long long koff = ((long long)b * Sk * H + h) * D;
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) ak[i] += xch[i * 128 + t];
    store_tile(dk + koff, ak, scale, k0, Sk, (long long)H * D);
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) av[i] += xch[(64 + i) * 128 + t];
    store_tile(dv + koff, av, 1.f, k0, Sk, (long long)H * D);
  }
}

struct SplitArgs {
  const float* x[4];  // qn, kn, v, g
  bf16* planes[4];
  long long n4[4];    // values of each / 4
};

// qn, kn, v and g (blockIdx.y 0..3) as kPlanes bf16 planes each, 4 values
// a thread.
__global__ void __launch_bounds__(256) bwd_f32_split_kernel(SplitArgs a) {
  const int which = blockIdx.y;
  const long long n4 = a.n4[which];
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < n4; e += gridDim.x * 256LL) {
    float v[4];
    ladcast::load4(a.x[which] + 4 * e, v);
    ladcast::store_planes4(a.planes[which] + 4 * e, 4 * n4, v);
  }
}

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The four bf16 tensor maps of a launch: qn, g over Sq rows, kn, v over Sk,
// each with 64-row boxes. Returns 0 or the driver's error code.
int encode_maps(CUtensorMap (&m)[4], const void* qn, const void* kn, const void* v,
                const void* g, int B, int Sq, int Sk, int H) {
  const void* base[4] = {qn, kn, v, g};
  for (int i = 0; i < 4; ++i) {
    const int rc = hp::encode_bshd_bf16(&m[i], base[i], B, (i == 0 || i == 3) ? Sq : Sk,
                                        H, D, kRows);
    if (rc != 0) return rc;
  }
  return 0;
}

// The fp32 kernels' split pass: qn, kn, v and g as kPlanes bf16 planes each,
// (3 B, Sq or Sk, H, 128) one after another in `planes`, and the four tensor
// maps over them, whose boxes are `rows_q` rows of qn and g and `rows_k`
// of kn and v. Returns 0, a launch error or the driver's error code.
int split_f32(CUtensorMap (&m)[4], const void* qn, const void* kn, const void* v,
              const void* g, void* planes, int B, int Sq, int Sk, int H, int rows_q,
              int rows_k, cudaStream_t st) {
  const long long nq = (long long)B * Sq * H * D, nk = (long long)B * Sk * H * D;
  const long long n[4] = {nq, nk, nk, nq};
  SplitArgs a{{static_cast<const float*>(qn), static_cast<const float*>(kn),
               static_cast<const float*>(v), static_cast<const float*>(g)},
              {},
              {nq / 4, nk / 4, nk / 4, nq / 4}};
  a.planes[0] = static_cast<bf16*>(planes);
  for (int i = 1; i < 4; ++i) a.planes[i] = a.planes[i - 1] + kPlanes * n[i - 1];
  const long long blocks = ((nq > nk ? nq : nk) / 4 + 255) / 256;
  bwd_f32_split_kernel<<<dim3((unsigned)(blocks < 2112 ? blocks : 2112), 4), 256, 0, st>>>(a);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  for (int i = 0; i < 4; ++i) {
    const bool q_side = i == 0 || i == 3;
    const int err = hp::encode_bshd_bf16(&m[i], a.planes[i], kPlanes * B, q_side ? Sq : Sk,
                                         H, D, q_side ? rows_q : rows_k);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// qn, g, dq: (B, Sq, H, 128); kn, v: (B, Sk, H, 128); contiguous, one dtype;
// lse, delta: (B, H, Sq) fp32; planes: null for bf16 inputs, bf16 scratch of
// 3 * 128 * B * H * (2 Sq + 2 Sk) elements for fp32 ones. Returns
// cudaGetLastError(), or the driver's error code when a tensor map cannot be
// encoded.
extern "C" int ladcast_flash_bwd_dq(const void* qn, const void* kn, const void* v,
                                    const void* g, const float* lse,
                                    const float* delta, void* dq, void* planes, int B,
                                    int Sq, int Sk, int H, float scale, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap m[4];
  if (dtype == ladcast::kDtypeBF16) {
    const int rc = encode_maps(m, qn, kn, v, g, B, Sq, Sk, H);
    if (rc != 0) return rc;
    static const cudaError_t attr = opt_in(bwd_dq_bf16_wgmma_kernel, kSmemDq);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sq + kDqRows - 1) / kDqRows, B * H);
    bwd_dq_bf16_wgmma_kernel<<<grid, kThreads, kSmemDq, st>>>(
        m[0], m[1], m[2], m[3], lse, delta, static_cast<bf16*>(dq), Sq, Sk, H, scale);
  } else if (dtype == ladcast::kDtypeF32 && planes != nullptr) {
    const int rc = split_f32(m, qn, kn, v, g, planes, B, Sq, Sk, H, kF32Rows, kF32Walk, st);
    if (rc != 0) return rc;
    static const cudaError_t attr = opt_in(bwd_dq_f32_wgmma_kernel, kSmemF32);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sq + kF32Rows - 1) / kF32Rows, B * H);
    bwd_dq_f32_wgmma_kernel<<<grid, kThreads, kSmemF32, st>>>(
        m[0], m[1], m[2], m[3], lse, delta, static_cast<float*>(dq), B, Sq, Sk, H, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// As ladcast_flash_bwd_dq; dk, dv: (B, Sk, H, 128).
extern "C" int ladcast_flash_bwd_dkv(const void* qn, const void* kn, const void* v,
                                     const void* g, const float* lse,
                                     const float* delta, void* dk, void* dv,
                                     void* planes, int B, int Sq, int Sk, int H,
                                     float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap m[4];
  if (dtype == ladcast::kDtypeBF16) {
    const int rc = encode_maps(m, qn, kn, v, g, B, Sq, Sk, H);
    if (rc != 0) return rc;
    static const cudaError_t attr = opt_in(bwd_dkv_bf16_wgmma_kernel, kSmemDkv);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sk + kDkvKeys - 1) / kDkvKeys, B * H);
    bwd_dkv_bf16_wgmma_kernel<<<grid, kThreads, kSmemDkv, st>>>(
        m[0], m[1], m[2], m[3], lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), Sq, Sk, H, scale);
  } else if (dtype == ladcast::kDtypeF32 && planes != nullptr) {
    const int rc = split_f32(m, qn, kn, v, g, planes, B, Sq, Sk, H, kF32Walk, kF32Rows, st);
    if (rc != 0) return rc;
    static const cudaError_t attr = opt_in(bwd_dkv_f32_wgmma_kernel, kSmemF32);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sk + kF32Rows - 1) / kF32Rows, B * H);
    bwd_dkv_f32_wgmma_kernel<<<grid, kThreads, kSmemF32, st>>>(
        m[0], m[1], m[2], m[3], lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), B, Sq, Sk, H, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
