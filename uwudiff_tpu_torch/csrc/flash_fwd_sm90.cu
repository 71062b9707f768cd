// Flash-attention forward for Hopper (sm_90a) at head dims 40, 64, 72, 80,
// 128 and 160: TMA loads into an mbarrier ring, one producer warp, two or three
// consumer warpgroups on wgmma; one template over the head dim.
//
// Replaces the TPU kernel uwudiff_tpu/ops/flash_attention.py::_fwd_kernel
// (:152; online softmax in the exp2 domain, out + natural-log lse, bias
// none / key / full). D = 64 is SDXL's, CLIP's, T5's and the SD3 MMDiT's;
// 40, 80 and 160 are SD1.5's three levels; 128 is Flux's (3072 / 24 heads);
// 72 is DiT-XL/2's (1152 / 16 heads). flash_fwd.cu (mma.sync) computes
// the same function at 40/80/160 and stays built as the yardstick; no path
// launches it.
//
// What bounds it on an H100: per query-key pair the two products take
// 2 * (D' + D) flop on the tensor cores (D' = D rounded up to 16, the
// depth of Q.K^T) and the softmax one exp2 on the SFU (16 a clock per SM).
// At D = 64 the two are alike (at [8, 4096, 4096, 10, 64] 0.347 ms of bf16
// tensor time at 989 TF/s and ~0.32 ms of exp2 at 1,980 MHz); at D = 40
// the SFU would be the floor with every exp2 on it (at [16, 4096, 4096, 8,
// 40] 0.514 ms of exp2 beside 0.417 ms of tensor time with D' = 48), but
// an exp2 on the FMA pipe (exp2_fma, 6 operations at 128 a clock) takes
// it below the tensor time; at 80, 128 and 160 the tensor cores are the
// floor (at Flux's [1, 4608, 4608, 24, 128] 0.264 ms of tensor time beside
// 0.122 ms of exp2 on the SFU alone).
// So the kernel comes near its bound only if the softmax of one tile runs
// while the tensor cores work on another, and at D = 40 only if part of
// the exp2 leaves the SFU. The design:
//   - a persistent grid of one block per SM walks over work items of
//     BLOCK_M query rows of one (batch, head); warpgroup 0 is the producer
//     (24 registers after setmaxnreg; one thread issues every TMA load),
//     the others are consumers of 64 rows each: two (BLOCK_M 128, 384
//     threads, 168 registers at launch, 240 after setmaxnreg) at D = 64,
//     72, 80, 128 and 160; three at D = 40 (BLOCK_M 192, 512 threads, 128
//     registers), where a third warpgroup's softmax beside the other two
//     keeps the SFU and the tensor cores busier than two could (11 %
//     faster at [16, 4096, 4096, 8, 40]);
//   - shared tiles are D = 64's at every head dim (as in flash_bwd_sm90.cu):
//     rows of 64 columns, 128 bytes, 128B-swizzled, one TMA box per
//     64-column block (one at D = 40 and 64, two at 72, 80 and 128, three
//     at 160), TMA zero-filling the columns past D. Q.K^T reads D up to the
//     next multiple of 16 (3, 4, 5, 5, 8, 10 k16 steps; a step past a
//     block's 64 columns goes through the block stride; at D = 72 the fifth
//     step's columns 72-79 are those zeros), P.V writes N = D columns (at 72
//     the first block's 64 and 8 of the second's, so no store reaches past
//     column 72 into the next head of a fused tensor);
//   - Q goes by TMA into one of Q_STAGES buffers, so the next item's Q can
//     load while this one is consumed; K and V tiles go through a ring of
//     STAGES stages that runs on across items, each stage with a full
//     mbarrier (TMA transaction bytes) and an empty one (one arrival per
//     consumer warpgroup, made after wgmma.wait_group has retired every
//     product that reads the stage). The tensor maps are rank 4 over (D, H,
//     S, B) with the views' own strides, so strided head views go in
//     uncopied, and TMA zero-fills keys >= Sk and rows >= Sq. The shared
//     memory of each head dim is in Cfg: a key tile is 128 keys, 64 at
//     D = 160, where a 128-key stage does not fit beside Q;
//   - S = Q.K^T is wgmma.m64nNk16 (N the key tile) with both operands in
//     shared memory (K-major); O += P.V is wgmma.m64nDk16 with P in
//     registers (the fp32 S fragment re-packed to bf16, as flash::pack_a
//     does) and V MN-major in shared memory (the transpose bit). S, O, m
//     and l stay in registers;
//   - inside a warpgroup, tile j's Q.K^T is issued together with tile
//     j-1's P.V, and the softmax of tile j runs while that P.V is in flight;
//     between the consumer warpgroups, named barriers order the issue in a
//     round robin (a ping-pong of two), so one warpgroup's exp2 and rescale
//     run while the others' products are on the tensor cores;
//   - one n8-tile in eight takes its exp2 on the FMA pipe (exp2_fma), which
//     takes that share off the SFU; with no bias the scale folds into the
//     exp2's FMA;
//   - the logit x = S * scale * LOG2E + bias * LOG2E is taken on the fp32 S
//     tile, p = exp2(x - m), lse = m * LN2 + log(l), as in flash_fwd.cu, so
//     the backward kernels rebuild the same P from the lse; keys >= Sk get
//     -inf in registers, the bias is clamped as it is loaded (bias_at), rows
//     >= Sq are never stored;
//   - no atomics and no split over keys: out and lse are the same bits from
//     run to run.
// ptxas (CUDA 12.9) reports each instance's registers (chip_smoke.py prints
// them); PERF.md has them and the times. At D = 64, a version that issued
// the next item's first Q.K^T with this item's last P.V, or ran the two
// loops as one, got its wgmmas serialised for lack of registers (warnings
// C7511/C7517), 20-45 % slower.

#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int CONSUMER_THREADS = 256;  // a named barrier's count: the waiting warpgroup and the one that frees it
constexpr int COLS = 64;  // columns a tile's row: one 128-byte swizzle row
constexpr int ROW_BYTES = 2 * COLS;
constexpr uint32_t SBO = 8 * ROW_BYTES;  // bytes between 8-row groups of a 128B-swizzled tile
constexpr int SMEM_MAX = 232448;         // dynamic shared memory a block may have (227 KB)
constexpr int MAX_STAGES = 3;

// The shared layout and constants of head dim D. CONSUMERS warpgroups of
// 64 query rows each share a work item of BLOCK_M rows: three at D = 40,
// whose small O leaves room for a third in the 128 registers a thread of a
// 512-thread block, two elsewhere (O of 32-80 registers beside S and P
// would spill at 128). A tile is NBLK column blocks of rows x 128 bytes.
// BLOCK_N keys a K/V tile: 128, or 64 at D = 160 (a 128-key stage of 96 KB
// would leave room for one stage only). Q_STAGES Q buffers: two at D = 40
// and 64, so the next item's Q loads during this one; one at 72, 80, 128
// and 160, where a second would cost a K/V stage (at 128: Q 32 KB and three
// stages of 64 KB). At D = 128 a consumer holds S and O, 64 fp32 registers
// each, and P, 32, of its 240. As many K/V stages as fit beside
// them, at most MAX_STAGES. EMU_EVERY: one n8-tile of S in EMU_EVERY takes
// its exp2 on the FMA pipe, at every head dim (at D = 40, where the SFU is
// the floor, one in four or two was slower beside three consumers' softmax
// on the same FMA pipe). Each choice is the one the card measured fastest
// (flash_variants.py, at the repo's root, times each against the others).
template <int D>
struct Cfg {
  static_assert(D == 40 || D == 64 || D == 72 || D == 80 || D == 128 || D == 160,
                "head dims 40, 64, 72, 80, 128, 160");
  static constexpr int CONSUMERS = D == 40 ? 3 : 2;
  static constexpr int BLOCK_M = 64 * CONSUMERS;  // query rows a work item
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr int CONSUMER_REGS = CONSUMERS == 3 ? 160 : 240;  // after setmaxnreg; the producer keeps 24
  static constexpr int NBLK = (D + COLS - 1) / COLS;
  static constexpr int KSTEPS = (D + 15) / 16;
  static constexpr int BLOCK_N = D > 128 ? 64 : 128;
  static constexpr int Q_STAGES = D > 64 ? 1 : 2;
  static constexpr int EMU_EVERY = 8;
  static constexpr int Q_BYTES = NBLK * BLOCK_M * ROW_BYTES;
  static constexpr int TILE_BYTES = NBLK * BLOCK_N * ROW_BYTES;  // one K or V tile
  static constexpr int FIT = (SMEM_MAX - 1024 - 8 * 2 * (Q_STAGES + MAX_STAGES) - Q_STAGES * Q_BYTES) /
                             (2 * TILE_BYTES);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int BAR_BYTES = 8 * 2 * (Q_STAGES + STAGES);
  static constexpr int SMEM = 1024 + Q_STAGES * Q_BYTES + 2 * STAGES * TILE_BYTES + BAR_BYTES;  // + alignment
  static_assert(STAGES >= 2 && SMEM <= SMEM_MAX, "the K/V ring needs two stages");
};

// the K-major step to k16 slice kk of a tile of ROWS rows, in 16-byte
// units: 32 bytes along the 128-byte row, the next column block after four
template <int ROWS>
__host__ __device__ constexpr uint32_t kmajor_step(int kk) {
  return ((kk * 16 / COLS) * ROWS * ROW_BYTES + (kk * 16 % COLS) * 2) >> 4;
}

// s = Q.K^T over one k16 slice, N = the key tile
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&s)[N / 2], uint64_t desc_q, uint64_t desc_k, int accumulate) {
  if constexpr (N == 128) wgmma_m64n128k16_ss(s, desc_q, desc_k, accumulate);
  else wgmma_m64n64k16_ss(s, desc_q, desc_k, accumulate);
}

// o += P.V over one k16 slice of keys, N = D
template <int D>
__device__ __forceinline__ void wgmma_rs_tb(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t desc_v) {
  if constexpr (D == 40) wgmma_m64n40k16_rs_tb(o, a, desc_v);
  else if constexpr (D == 64) wgmma_m64n64k16_rs_tb(o, a, desc_v);
  else if constexpr (D == 72) wgmma_m64n72k16_rs_tb(o, a, desc_v);
  else if constexpr (D == 80) wgmma_m64n80k16_rs_tb(o, a, desc_v);
  else if constexpr (D == 128) wgmma_m64n128k16_rs_tb(o, a, desc_v);
  else wgmma_m64n160k16_rs_tb(o, a, desc_v);
}

// One S tile of N keys before the softmax, in place. FOLD (no bias, scale >
// 0): s stays raw and the softmax folds the scale into its exp2's FMA;
// otherwise s becomes x = s * qk_scale (+ bias * LOG2E). Keys >= Sk get
// -inf (RAGGED: the tile reaches past Sk). brow is this item's bias: keys
// for BIAS 1, rows of Sk keys for BIAS 2.
template <int N, int BIAS, bool FOLD, bool RAGGED>
__device__ __forceinline__ void logits(float (&s)[N / 2], const float* __restrict__ brow, int Sq, int Sk, int n0,
                                       int row_a, int lane, float qk_scale) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int col = n0 + nt * 8 + (lane % 4) * 2 + e2;
      const bool key_ok = !RAGGED || col < Sk;
      float kb = 0.f;
      if (BIAS == 1 && key_ok) kb = bias_at(brow + col) * LOG2E;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = s[4 * nt + 2 * r + e2];
        if (!FOLD) x *= qk_scale;
        if (BIAS == 1) x += kb;
        if (BIAS == 2) {
          const int row = row_a + 8 * r;
          if (key_ok && row < Sq) x = fmaf(bias_at(brow + (long long)row * Sk + col), LOG2E, x);
        }
        if (!key_ok) x = -INFINITY;
      }
    }
  }
}

// exp2 on the FMA pipe, for a share of the probabilities: moving every
// EMU_EVERY-th n8-tile off the SFU shortens the softmax where the SFU is
// its floor. x is clamped at -126 (exp2(-inf) gives a denormal, below any
// bf16 P); 2^frac(x) is a cubic on [-0.5, 0.5] within 7.8e-5 relative,
// below a bf16 step of P (2^-8) and within the lse's 1e-3; the integer part
// goes straight into the exponent (t's low mantissa bits hold round(x)).
__device__ __forceinline__ float exp2_fma(float x) {
  x = fmaxf(x, -126.f);
  const float t = x + 12582912.f;  // 1.5 * 2^23: rounds x to an integer in the low mantissa bits
  const float f = x - (t - 12582912.f);
  const float p = fmaf(fmaf(fmaf(0.05508868396282196f, f, 0.24260404706001282f), f, 0.6932762265205383f), f,
                       0.9999289512634277f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

// online softmax of one tile of N keys: s becomes p = exp2(s * mul - m_new),
// mul > 0 (qk_scale with FOLD, else 1); alpha = exp2(m_old - m_new) is for
// the O rescale, which waits for the P.V in flight
template <int N, int EMU_EVERY>
__device__ __forceinline__ void softmax(float (&s)[N / 2], float (&m_r)[2], float (&l_r)[2], float (&alpha)[2],
                                        float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mq[4];  // four independent chains, then a tree
#pragma unroll
    for (int i = 0; i < 4; ++i) mq[i] = fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]);
#pragma unroll
    for (int nt = 4; nt < N / 8; ++nt)
      mq[nt % 4] = fmaxf(mq[nt % 4], fmaxf(s[4 * nt + 2 * r], s[4 * nt + 2 * r + 1]));
    float mx = fmaxf(fmaxf(mq[0], mq[1]), fmaxf(mq[2], mq[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // key 0 lies in tile 0 and its logit is finite, so m_new is finite
    const float m_new = fmaxf(m_r[r], mx * mul);
    alpha[r] = exp2_approx(m_r[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const bool fma_pipe = EMU_EVERY > 0 && nt % EMU_EVERY == EMU_EVERY - 1;
      const float x0 = fmaf(s[4 * nt + 2 * r], mul, -m_new), x1 = fmaf(s[4 * nt + 2 * r + 1], mul, -m_new);
      const float p0 = fma_pipe ? exp2_fma(x0) : exp2_approx(x0);
      const float p1 = fma_pipe ? exp2_fma(x1) : exp2_approx(x1);
      s[4 * nt + 2 * r] = p0;
      s[4 * nt + 2 * r + 1] = p1;
      sum += p0 + p1;
    }
    l_r[r] = l_r[r] * alpha[r] + sum;
    m_r[r] = m_new;
  }
}

// P (bf16 A fragments of the P.V product) from the probability tile s:
// k-slice kk covers keys [16 kk, 16 kk + 16), the n8-tiles 2 kk and 2 kk + 1
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&p)[N / 16][4], const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// rows [row, row + ROWS) of q, k or v at head h, batch b: one box per
// column block, reported to bar
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int h, int row,
                                          int b) {
#pragma unroll
  for (int kb = 0; kb < Cfg<D>::NBLK; ++kb) tma_load_4d(dst + kb * ROWS * ROW_BYTES, map, bar, kb * COLS, h, row, b);
}

// A persistent grid: block i takes work items i, i + gridDim.x, ...; an item
// is BLOCK_M query rows of one (batch, head), item = bh * ceil(Sq / BLOCK_M)
// + m, so the blocks in flight share K/V in L2. The K/V ring runs on across items,
// and Q is double-buffered where it fits, so the producer loads the next
// item while the consumers finish this one.
// BIAS: 0 none, 1 key bias [B, Sk] fp32, 2 full bias fp32 with rows of Sk
// keys, item (b, h) at bias + b * bias_sb + h * bias_sh (elements; a stride
// of 0 where the bias broadcasts, as CLIP's [B, 1, Sq, Sk] does over heads).
template <int D, int BIAS, bool FOLD>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Sk,
                          long long bias_sb, long long bias_sh, int n_items, float qk_scale) {
  using C = Cfg<D>;
  constexpr int N = C::BLOCK_N, BLOCK_M = C::BLOCK_M, NC = C::CONSUMERS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = base;
  unsigned char* sK = sQ + C::Q_STAGES * C::Q_BYTES;
  unsigned char* sV = sK + C::STAGES * C::TILE_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + C::STAGES * C::TILE_BYTES);
  uint64_t* q_empty = q_full + C::Q_STAGES;
  uint64_t* full = q_empty + C::Q_STAGES;
  uint64_t* empty = full + C::STAGES;

  const int n_m = (Sq + BLOCK_M - 1) / BLOCK_M;
  const int n_tiles = (Sk + N - 1) / N;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::Q_STAGES; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], NC);  // one arrival per consumer warpgroup
    }
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      int kv = 0;  // K/V tiles loaded so far, across items
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / n_m, b = bh / H, h = bh % H;
        const int qs = it % C::Q_STAGES;
        mbar_wait(&q_empty[qs], ((it / C::Q_STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(&q_full[qs], C::Q_BYTES);
        load_rows<D, BLOCK_M>(sQ + qs * C::Q_BYTES, &tm_q, &q_full[qs], h, (item % n_m) * BLOCK_M, b);
        for (int j = 0; j < n_tiles; ++j, ++kv) {
          const int st = kv % C::STAGES;
          mbar_wait(&empty[st], ((kv / C::STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], 2 * C::TILE_BYTES);
          load_rows<D, N>(sK + st * C::TILE_BYTES, &tm_k, &full[st], h, j * N, b);
          load_rows<D, N>(sV + st * C::TILE_BYTES, &tm_v, &full[st], h, j * N, b);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int my_bar = 1 + c, next_bar = 1 + (c + 1) % NC;  // round robin: issue on mine, then free the next's
    const float mul = FOLD ? qk_scale : 1.f;

    float s[N / 2];
    float o[D / 2];
    uint32_t p[N / 16][4];
    float m_r[2], l_r[2], alpha[2];

    auto issue_qk = [&](uint64_t desc_q, int stage) {  // s = Q K^T over the k16 slices of D
      const uint64_t desc_k = desc_sw128(sK + stage * C::TILE_BYTES, 16, SBO);
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk)
        wgmma_ss<N>(s, desc_q + kmajor_step<BLOCK_M>(kk), desc_k + kmajor_step<N>(kk), kk > 0);
    };
    auto issue_pv = [&](int stage) {  // o += P V over the k16 slices of the keys
      // MN-major V: LBO is the column blocks' stride (unused where one block spans D)
      const uint64_t desc_v = desc_sw128(sV + stage * C::TILE_BYTES, C::NBLK > 1 ? N * ROW_BYTES : 16, SBO);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) wgmma_rs_tb<D>(o, p[kk], desc_v + ((kk * 16 * ROW_BYTES) >> 4));
    };

    if (c == NC - 1) named_arrive(1, CONSUMER_THREADS);  // consumer 0 issues first
    int kv = 0;  // K/V tiles consumed so far, across items
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / n_m, b = bh / H, h = bh % H;
      const int row_a = (item % n_m) * BLOCK_M + 64 * c + 16 * warp + lane / 4;  // rows row_a, row_a + 8
      const bool last_item = item + gridDim.x >= n_items;
      const int qs = it % C::Q_STAGES;
      // this consumer's 64 rows of every column block of Q
      const uint64_t desc_q = desc_sw128(sQ + qs * C::Q_BYTES + c * 64 * ROW_BYTES, 16, SBO);
      const float* brow = BIAS ? bias + b * bias_sb + h * bias_sh : nullptr;
      auto tile_logits = [&](int j) {
        const int n0 = j * N;
        if (n0 + N > Sk)
          logits<N, BIAS, FOLD, true>(s, brow, Sq, Sk, n0, row_a, lane, qk_scale);
        else
          logits<N, BIAS, FOLD, false>(s, brow, Sq, Sk, n0, row_a, lane, qk_scale);
      };
      // the last issue of the block's last item frees no one: the named
      // barriers end balanced
      auto hand_over = [&](int j) {
        if (!(c == NC - 1 && last_item && j == n_tiles - 1)) named_arrive(next_bar, CONSUMER_THREADS);
      };
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m_r[0] = m_r[1] = -INFINITY;
      l_r[0] = l_r[1] = 0.f;  // per-thread partial row sums, quad-reduced at the end

      mbar_wait(&q_full[qs], (it / C::Q_STAGES) & 1);
      // tile 0: S alone
      mbar_wait(&full[kv % C::STAGES], (kv / C::STAGES) & 1);
      named_sync(my_bar, CONSUMER_THREADS);
      wgmma_fence();
      issue_qk(desc_q, kv % C::STAGES);
      wgmma_commit();
      hand_over(0);
      wgmma_wait<0>();
      fence_regs(s);
      if (n_tiles == 1 && tid == 0) mbar_arrive(&q_empty[qs]);  // Q read for the last time
      tile_logits(0);
      softmax<N, C::EMU_EVERY>(s, m_r, l_r, alpha, mul);  // alpha = 0; o is still 0
      pack_p<N>(p, s);

      for (int j = 1; j < n_tiles; ++j) {
        const int cur = kv + j, prev = (cur - 1) % C::STAGES;
        mbar_wait(&full[cur % C::STAGES], (cur / C::STAGES) & 1);
        named_sync(my_bar, CONSUMER_THREADS);
        wgmma_fence();  // the rescaled o and the new p are written before the products read them
        issue_qk(desc_q, cur % C::STAGES);
        wgmma_commit();
        issue_pv(prev);
        wgmma_commit();
        hand_over(j);
        wgmma_wait<1>();  // S of tile j is in; P.V of tile j-1 runs on
        fence_regs(s);
        if (j == n_tiles - 1 && tid == 0) mbar_arrive(&q_empty[qs]);
        tile_logits(j);
        softmax<N, C::EMU_EVERY>(s, m_r, l_r, alpha, mul);
        wgmma_wait<0>();  // P.V of tile j-1 retired: its stage can be refilled
        fence_regs(o);
        if (tid == 0) mbar_arrive(&empty[prev]);
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          o[4 * dt + 0] *= alpha[0];
          o[4 * dt + 1] *= alpha[0];
          o[4 * dt + 2] *= alpha[1];
          o[4 * dt + 3] *= alpha[1];
        }
        pack_p<N>(p, s);
      }
      const int last = (kv + n_tiles - 1) % C::STAGES;
      wgmma_fence();
      issue_pv(last);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (tid == 0) mbar_arrive(&empty[last]);
      kv += n_tiles;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_r[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int row = row_a + 8 * r;
        if (row < Sq) {
          const float inv = 1.f / l;  // l >= 1: the row maximum contributes exp2(0)
          __nv_bfloat16* orow = out + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
          for (int dt = 0; dt < D / 8; ++dt) {
            const int col = dt * 8 + (lane % 4) * 2;
            *reinterpret_cast<uint32_t*>(orow + col) =
                pack_bf16(o[4 * dt + 2 * r] * inv, o[4 * dt + 2 * r + 1] * inv);
          }
          if (lane % 4 == 0) lse[(long long)bh * Sq + row] = m_r[r] * LN2 + logf(l);
        }
      }
    }
  }
}

// ----------------------------------------------------------------- host

struct Maps {
  CUtensorMap q, k, v;
  long long bias_sb, bias_sh;
};

struct Args {
  const void* bias;
  void *out, *lse;
  int B, H, Sq, Sk;
  float qk_scale;
  cudaStream_t stream;
};

template <int D, int BIAS, bool FOLD>
int launch(const Maps& m, const Args& a) {
  using C = Cfg<D>;
  auto kern = flash_fwd_sm90_kernel<D, BIAS, FOLD>;
  constexpr int SMEM = C::SMEM;
  // set once per device and instantiation: the wrapper's host time is most
  // of a call at the small shapes (CLIP's 77 tokens)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  static int sms[64];
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      sms[dev] = 0;
      return static_cast<int>(err);
    }
  }
  const long long n_items = (long long)((a.Sq + C::BLOCK_M - 1) / C::BLOCK_M) * a.B * a.H;
  if (n_items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_items < sms[dev] ? n_items : sms[dev]);  // one block per SM, persistent
  kern<<<grid, C::THREADS, SMEM, a.stream>>>(m.q, m.k, m.v, static_cast<const float*>(a.bias),
                                          static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.lse), a.H, a.Sq,
                                          a.Sk, m.bias_sb, m.bias_sh, static_cast<int>(n_items), a.qk_scale);
  return static_cast<int>(cudaGetLastError());
}

// encode the three maps, each checked against the layout of head dim D (its
// head dim, 64-column boxes, BLOCK_M rows for q and BLOCK_N for k and v),
// and launch the instance of the bias mode
template <int D>
int run(const void* q, const void* k, const void* v, const unsigned long long* maps, int bias_mode,
        const Args& a) {
  for (int i = 0; i < 3; ++i) {
    const unsigned long long* spec = maps + i * MAP_WORDS;
    if (spec[0] != D || box_cols(spec) != COLS ||
        box_rows(spec) != static_cast<unsigned long long>(i == 0 ? Cfg<D>::BLOCK_M : Cfg<D>::BLOCK_N))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  Maps m;
  int rc = encode(&m.q, q, maps);
  if (rc == 0) rc = encode(&m.k, k, maps + MAP_WORDS);
  if (rc == 0) rc = encode(&m.v, v, maps + 2 * MAP_WORDS);
  if (rc != 0) return rc;
  m.bias_sb = static_cast<long long>(maps[3 * MAP_WORDS]);
  m.bias_sh = static_cast<long long>(maps[3 * MAP_WORDS + 1]);
  switch (bias_mode) {
    case 0: return a.qk_scale > 0.f ? launch<D, 0, true>(m, a) : launch<D, 0, false>(m, a);
    case 1: return launch<D, 1, false>(m, a);
    case 2: return launch<D, 2, false>(m, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/k/v: bf16 [B, S, H, D] views, D = 40, 64, 72, 80, 128 or 160; maps: three
// tensor-map specs of MAP_WORDS words each (q, k, v), then the bias's batch
// and head strides in elements. out: contiguous bf16 [B, Sq, H, D]; lse:
// contiguous fp32 [B, H, Sq]. Returns 0, a cudaError_t code, or
// ENCODE_FAILED + the CUresult of a tensor map the driver refused.
extern "C" int uwu_flash_fwd_sm90(const void* q, const void* k, const void* v, const void* bias, void* out,
                                  void* lse, int B, int H, int Sq, int Sk, int head_dim, int bias_mode,
                                  const unsigned long long* maps, float scale, void* stream) {
  const Args a{bias, out, lse, B, H, Sq, Sk, scale * flash::LOG2E, static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 40: return run<40>(q, k, v, maps, bias_mode, a);
    case 64: return run<64>(q, k, v, maps, bias_mode, a);
    case 72: return run<72>(q, k, v, maps, bias_mode, a);
    case 80: return run<80>(q, k, v, maps, bias_mode, a);
    case 128: return run<128>(q, k, v, maps, bias_mode, a);
    case 160: return run<160>(q, k, v, maps, bias_mode, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
