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
// fp32 (the parity dtype) runs plain FMA kernels of the same structure,
// 32x32 tiles, on the CUDA cores: TF32 would miss the fp32 check.

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
constexpr uint64_t kDescHalf = kHalfBytes / 16;   // a tile's second half of D
constexpr uint64_t kDescTile = kTileBytes / 16;
constexpr uint64_t kDescK16 = 32 / 16;            // 16 bf16 along D
constexpr uint64_t kDescRows16 = 16 * 128 / 16;   // 16 rows, read MN-major

// K-major k-step kk (16 of D) of a tile whose descriptor is `desc`.
__device__ __forceinline__ uint64_t k_step(uint64_t desc, int kk) {
  return desc + (kk >> 2) * kDescHalf + (kk & 3) * kDescK16;
}

// Rows [r0, r0 + 64) of head h, batch b of a (B, S, H, 128) map into a
// tile: two boxes, one per half of D; rows past S read as zeros.
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int h, int r0, int b) {
  hp::tma_load_4d(dst, map, bar, 0, h, r0, b);
  hp::tma_load_4d(dst + kHalfBytes, map, bar, 64, h, r0, b);
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
constexpr int F = 32, kFThreads = 256;           // tile rows, threads
constexpr int LA = D + 4, LB = D + 1, LP = F + 1;  // padded smem strides
constexpr int kSmemF32 = (2 * F * LA + 2 * F * LB + 2 * F * LP + 2 * F) * (int)sizeof(float);

// Rows [r0, r0 + F) of a (S, D) slice into an F x LA tile (16-byte stores;
// rows >= S zero).
__device__ __forceinline__ void load_rows_a(float* s, const float* src, int r0,
                                            int S, long long rs) {
  for (int c = threadIdx.x; c < F * (D / 4); c += kFThreads) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < S) ladcast::load4(src + (r0 + r) * rs + col, x);
    ladcast::store4(s + r * LA + col, x);
  }
}

// The same into an F x LB tile (odd stride, scalar stores).
__device__ __forceinline__ void load_rows_b(float* s, const float* src, int r0,
                                            int S, long long rs) {
  for (int c = threadIdx.x; c < F * (D / 4); c += kFThreads) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < S) ladcast::load4(src + (r0 + r) * rs + col, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) s[r * LB + col + i] = x[i];
  }
}

__device__ __forceinline__ float dot_row(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// Thread (r = tid / 8, part = tid % 8) owns row r of the kept tile, the
// walked-tile columns part + 8j (j < 4) of its scores and the output
// columns part + 8i (i < 16); the 8 threads of a row are consecutive lanes.
__global__ void __launch_bounds__(kFThreads)
bwd_dq_f32_kernel(const float* __restrict__ qn, const float* __restrict__ kn,
                  const float* __restrict__ v, const float* __restrict__ g,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int Sq, int Sk, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sG = sQ + F * LA;
  float* sK = sG + F * LA;
  float* sV = sK + F * LB;
  float* sS = sV + F * LB;

  const int tid = threadIdx.x, r = tid >> 3, part = tid & 7;
  const int q0 = blockIdx.x * F;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long rs = (long long)H * D;
  const long long qoff = ((long long)b * Sq * H + h) * D;
  const float* kb = kn + ((long long)b * Sk * H + h) * D;
  const float* vb = v + ((long long)b * Sk * H + h) * D;
  const long long srow = ((long long)b * H + h) * Sq + q0 + r;
  const float lr = q0 + r < Sq ? lse[srow] : 0.f;
  const float dr = q0 + r < Sq ? delta[srow] : 0.f;

  load_rows_a(sQ, qn + qoff, q0, Sq, rs);
  load_rows_a(sG, g + qoff, q0, Sq, rs);
  float acc[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i] = 0.f;

  const int n_tiles = (Sk + F - 1) / F;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * F;
    __syncthreads();  // the previous tile is no longer read
    load_rows_b(sK, kb, k0, Sk, rs);
    load_rows_b(sV, vb, k0, Sk, rs);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < F / 8; ++j) {
      const int c = part + 8 * j;
      const float s = dot_row(sQ + r * LA, sK + c * LB);
      const float dp = dot_row(sG + r * LA, sV + c * LB);
      const float p = k0 + c < Sk ? expf(s * scale - lr) : 0.f;
      sS[r * LP + c] = p * (dp - dr);
    }
    __syncwarp();  // a row's dS is written and read by the same 8 lanes
    for (int c = 0; c < F; ++c) {
      const float ds = sS[r * LP + c];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) acc[i] = fmaf(ds, sK[c * LB + part + 8 * i], acc[i]);
    }
  }
  if (q0 + r < Sq) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) dq[qoff + (q0 + r) * rs + part + 8 * i] = acc[i] * scale;
  }
}

__global__ void __launch_bounds__(kFThreads)
bwd_dkv_f32_kernel(const float* __restrict__ qn, const float* __restrict__ kn,
                   const float* __restrict__ v, const float* __restrict__ g,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
                   int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + F * LA;
  float* sQ = sV + F * LA;
  float* sG = sQ + F * LB;
  float* sP = sG + F * LB;
  float* sS = sP + F * LP;
  float* sL = sS + F * LP;
  float* sD = sL + F;

  const int tid = threadIdx.x, r = tid >> 3, part = tid & 7;
  const int k0 = blockIdx.x * F;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long rs = (long long)H * D;
  const long long koff = ((long long)b * Sk * H + h) * D;
  const float* qb = qn + ((long long)b * Sq * H + h) * D;
  const float* gb = g + ((long long)b * Sq * H + h) * D;
  const long long srow = ((long long)b * H + h) * Sq;

  load_rows_a(sK, kn + koff, k0, Sk, rs);
  load_rows_a(sV, v + koff, k0, Sk, rs);
  float ak[D / 8], av[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) ak[i] = av[i] = 0.f;

  const int n_tiles = (Sq + F - 1) / F;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * F;
    __syncthreads();  // the previous tile is no longer read
    load_rows_b(sQ, qb, q0, Sq, rs);
    load_rows_b(sG, gb, q0, Sq, rs);
    if (tid < F) {
      sL[tid] = q0 + tid < Sq ? lse[srow + q0 + tid] : 0.f;
      sD[tid] = q0 + tid < Sq ? delta[srow + q0 + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < F / 8; ++j) {
      const int c = part + 8 * j;
      const float s = dot_row(sK + r * LA, sQ + c * LB);
      const float dp = dot_row(sV + r * LA, sG + c * LB);
      const float p = q0 + c < Sq ? expf(s * scale - sL[c]) : 0.f;
      sP[r * LP + c] = p;
      sS[r * LP + c] = p * (dp - sD[c]);
    }
    __syncwarp();  // a row's P and dS are written and read by the same 8 lanes
    for (int c = 0; c < F; ++c) {
      const float p = sP[r * LP + c], ds = sS[r * LP + c];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        av[i] = fmaf(p, sG[c * LB + part + 8 * i], av[i]);
        ak[i] = fmaf(ds, sQ[c * LB + part + 8 * i], ak[i]);
      }
    }
  }
  if (k0 + r < Sk) {
    const long long o = koff + (k0 + r) * rs + part;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      dk[o + 8 * i] = ak[i] * scale;
      dv[o + 8 * i] = av[i];
    }
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

}  // namespace

// qn, g, dq: (B, Sq, H, 128); kn, v: (B, Sk, H, 128); contiguous, one dtype;
// lse, delta: (B, H, Sq) fp32. Returns cudaGetLastError(), or the driver's
// error code when a bf16 tensor map cannot be encoded.
extern "C" int ladcast_flash_bwd_dq(const void* qn, const void* kn, const void* v,
                                    const void* g, const float* lse,
                                    const float* delta, void* dq, int B, int Sq,
                                    int Sk, int H, float scale, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ladcast::kDtypeBF16) {
    CUtensorMap m[4];
    const int rc = encode_maps(m, qn, kn, v, g, B, Sq, Sk, H);
    if (rc != 0) return rc;
    static const cudaError_t attr = opt_in(bwd_dq_bf16_wgmma_kernel, kSmemDq);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sq + kDqRows - 1) / kDqRows, B * H);
    bwd_dq_bf16_wgmma_kernel<<<grid, kThreads, kSmemDq, st>>>(
        m[0], m[1], m[2], m[3], lse, delta, static_cast<bf16*>(dq), Sq, Sk, H, scale);
  } else if (dtype == ladcast::kDtypeF32) {
    static const cudaError_t attr = opt_in(bwd_dq_f32_kernel, kSmemF32);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sq + F - 1) / F, B * H);
    bwd_dq_f32_kernel<<<grid, kFThreads, kSmemF32, st>>>(
        static_cast<const float*>(qn), static_cast<const float*>(kn),
        static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
        static_cast<float*>(dq), Sq, Sk, H, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// As ladcast_flash_bwd_dq; dk, dv: (B, Sk, H, 128).
extern "C" int ladcast_flash_bwd_dkv(const void* qn, const void* kn, const void* v,
                                     const void* g, const float* lse,
                                     const float* delta, void* dk, void* dv, int B,
                                     int Sq, int Sk, int H, float scale, int dtype,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ladcast::kDtypeBF16) {
    CUtensorMap m[4];
    const int rc = encode_maps(m, qn, kn, v, g, B, Sq, Sk, H);
    if (rc != 0) return rc;
    static const cudaError_t attr = opt_in(bwd_dkv_bf16_wgmma_kernel, kSmemDkv);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sk + kDkvKeys - 1) / kDkvKeys, B * H);
    bwd_dkv_bf16_wgmma_kernel<<<grid, kThreads, kSmemDkv, st>>>(
        m[0], m[1], m[2], m[3], lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), Sq, Sk, H, scale);
  } else if (dtype == ladcast::kDtypeF32) {
    static const cudaError_t attr = opt_in(bwd_dkv_f32_kernel, kSmemF32);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sk + F - 1) / F, B * H);
    bwd_dkv_f32_kernel<<<grid, kFThreads, kSmemF32, st>>>(
        static_cast<const float*>(qn), static_cast<const float*>(kn),
        static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
