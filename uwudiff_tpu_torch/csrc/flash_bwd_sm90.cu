// Flash-attention backward for Hopper (sm_90a) at head dims 40, 64 and 80:
// dQ and dK/dV, each a persistent, warp-specialised kernel on TMA, an
// mbarrier ring and wgmma, one template over the head dim.
//
// Replaces the TPU kernels uwudiff_tpu/ops/flash_attention.py::_bwd_dq_kernel
// (:271, K4: flash_bwd_dq_sm90) and ::_bwd_dkv_kernel (:365, K6:
// flash_bwd_dkv_sm90). D = 64 is SDXL's, CLIP's, T5's and the SD3 MMDiT's;
// 40 and 80 are SD1.5's first two levels. The dQ + dBias kernel (K5) and
// D = 160 keep the mma.sync kernels of flash_bwd.cu; the wrappers dispatch
// on the head dim.
//
// The backward is split in two as in flash_bwd.cu, so that no output is
// summed across blocks: no atomics, and dQ, dK and dV are the same bits from
// run to run (each work item owns its output rows and walks its tiles in a
// fixed order). delta = rowsum(dO * O) arrives precomputed, fp32 [B, H, Sq].
//   dQ  : an item is 128 query rows of one (batch, head); Q and dO come in
//         once, the loop runs over key tiles of 64: S = Q.K^T and
//         dP = dO.V^T, dS = P (dP - delta), dQ += dS.K; dQ *= scale.
//   dK/dV: an item is 128 keys; K and V come in once, the loop runs over
//         query tiles of 64: S^T = K.Q^T and dP^T = V.dO^T, so that each
//         consumer's 64 keys are the rows of its fragments, dS^T = P^T
//         (dP^T - delta), dV += P^T.dO and dK += dS^T.Q; dK *= scale.
// The products over D (S, dP and their transposes) are wgmma.m64n64k16 with
// A from registers: the item's own operand (Q and dO, or K and V), read from
// shared memory into wgmma fragments once an item (ldmatrix through the
// swizzle); B the streamed tile, K-major. The products into dQ, dV and dK
// are wgmma.m64nDk16 (N = 40, 64, 80) with A the fp32 P and dS (P^T, dS^T)
// re-packed to bf16, B the streamed tile MN-major (the transpose bit).
// P is the P the forward normalised (flash_fwd_sm90.cu, flash_fwd.cu): the
// logit scale and the bias's LOG2E are applied to the fp32 S tile, never
// folded into bf16 q; the bias is clamped at -1e30 as it is loaded;
// p = exp2(x - lse * LOG2E).
//
// What bounds it on an H100: per query-key pair the three (dQ) or four
// (dK/dV) products take 6 D or 8 D flop on the tensor cores and the
// recompute one exp2 on the SFU (16 a clock per SM). At D = 40 the exp2 is
// as long as dQ's products (at [16, 4096, 4096, 8, 40]: 0.514 ms of exp2 at
// 1,980 MHz beside 0.521 / 0.695 ms of bf16 tensor time at 989 TF/s for dQ
// / dK/dV), far above the byte bound. Measured (PERF.md), neither bounds
// these kernels: without the exp2 they take as long, and without any tile
// math 80 % as long. The products do: a commit-to-wait round trip of a
// group of wgmma costs ~400 clocks of latency beside its products (4
// m64n64k16 a group run at 45 % of the tensor rate, 10 at 77 %;
// m64n40k16 at 64 %), and a D = 40 tile's products are fewer to hide it
// behind than D = 64's. The design:
//   - a persistent grid of one 384-thread block per SM; warpgroup 0 is the
//     producer (40 registers after setmaxnreg; its first warp loads),
//     warpgroups 1 and 2 consume 64 rows of the item each (232);
//   - shared tiles are D = 64's at every head dim: rows of 64 columns, 128
//     bytes, 128B-swizzled, one TMA box per 64-column block (one at D = 40
//     and 64, two at 80), TMA zero-filling the columns past D. The products
//     over D read only up to the next multiple of 16 (3, 4, 5 k16 steps;
//     columns 40-47 at D = 40 are those zeros), the products into dQ, dK,
//     dV write N = D columns. Boxes of 16 columns under a 32-byte swizzle,
//     the tile no wider than D, took 3-5 % longer at D = 40: three small
//     TMA rows for each of D = 64's one;
//   - the item's own block (Q and dO, or K and V) goes by TMA into one of two
//     buffers, freed as soon as both consumers hold it in registers, so the
//     next item's loads early; the streamed tiles (K and V, or Q and dO) go
//     through a ring of 5 stages (3 at D = 80, whose tiles are two blocks
//     wide) that runs on across items, each with a full mbarrier (TMA
//     transaction bytes plus the vectors' copies) and an empty one (one
//     arrival per consumer warpgroup, made after wgmma.wait_group has retired
//     every product that reads the stage). Tensor maps are rank 4 over (D,
//     H, S, B) with the views' own strides: strided head views go in
//     uncopied, and TMA zero-fills rows past Sq or Sk;
//   - A from registers halves the shared-memory reads of the products over
//     D. Where the fragments do not fit beside the accumulators (dK/dV at
//     D = 80: 40 registers beside 176; dK/dV with a full bias, whose loads
//     need the room) K and V stay in the item's buffer and those products
//     read A from shared memory too; the buffer is freed when the item's
//     last product retires;
//   - the fp32 vectors beside a tile (the key bias for dQ; lse and delta for
//     dK/dV) have rows of Sk or Sq entries, not multiples of 16 bytes, so TMA
//     cannot take them: the producer warp's 32 lanes copy them with 4-byte
//     cp.async into the stage, and each lane's copies arrive on the stage's
//     full barrier when they land (cp.async.mbarrier.arrive.noinc). dQ's lse
//     and delta (two rows a thread) and dK/dV's key bias (two keys a
//     thread) are per item and sit in registers; a full bias (CLIP's causal
//     one, T5's) is read in place through its batch and head strides (0
//     where it broadcasts) by plain loads;
//   - inside a consumer, tile j's S, its dP (S^T, dP^T) and tile j-1's dQ
//     (dV, dK) products are issued as three groups: P's exp2 runs as soon as
//     S is in, beside the other two, and dS once dP is. In dQ, named
//     barriers also order the two consumers' issues (ping-pong), so one's
//     exp2 runs while the other's products are on the tensor cores. Measured
//     and not kept: the same ping-pong in dK/dV (within the noise at D =
//     40/64, slower at 80) and one n8-tile in 8 or 4 taking its exp2 on the
//     FMA pipe (flash_fwd_sm90.cu's exp2_fma: 2-5 % slower, the SFU is not
//     the bound);
//   - ragged edges: keys >= Sk get p = 0 in dQ, query rows >= Sq get p = 0 in
//     dK/dV (their lse is never read as garbage: rows past Sq get lse = +inf
//     in dQ); no row past Sq or Sk is written.
// Tiles of 128 would need 128 accumulator registers a thread for S and dP
// alone, past what the launch gives with the accumulators beside them.
// ptxas (CUDA 12.9): 168 registers at launch, no spills, no serialised
// wgmma at every instance (chip_smoke.py prints the report); times are in
// PERF.md.

#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int THREADS = 384;
constexpr int CONSUMER_THREADS = 256;
constexpr int ITEM_ROWS = 128;  // rows an item owns: query rows (dQ) or keys (dK/dV), 64 a consumer warpgroup
constexpr int TILE = 64;        // rows a streamed tile: keys (dQ) or query rows (dK/dV)
constexpr int VEC_BYTES = TILE * 4;   // one fp32 vector beside a tile
constexpr int VEC_ARRIVALS = 1 + 32;  // expect_tx by lane 0, then every lane's cp.async arrival
constexpr int COLS = 64;              // columns a tile's row: one 128-byte swizzle row
constexpr int ROW_BYTES = 2 * COLS;
constexpr uint32_t SBO = 8 * ROW_BYTES;  // bytes between 8-row groups

// The shared layout of head dim D (40, 64 or 80): at every D the 128-byte
// swizzle of D = 64, a tile's row 64 columns. A tile is NBLK column blocks
// of rows x 128 bytes, one TMA box each (one block at D = 40 and 64, two at
// 80); TMA zero-fills the columns past D, which the products over D read
// only up to the next multiple of 16 (KSTEPS k16 steps: 3, 4, 5; columns
// 40-47 at D = 40 are zeros). The products into dQ, dK and dV run at N = D
// (wgmma.m64n40k16 / m64n64k16 / m64n80k16). D = 80's two blocks leave room
// for 3 stages of the ring, not 5.
template <int D>
struct Geo {
  static_assert(D == 40 || D == 64 || D == 80, "head dims 40, 64, 80");
  static constexpr int NBLK = (D + COLS - 1) / COLS;
  static constexpr int KSTEPS = (D + 15) / 16;
  static constexpr int STAGES = NBLK > 1 ? 3 : 5;
  static constexpr int ITEM_BYTES = NBLK * ITEM_ROWS * ROW_BYTES;  // one of the item's two inputs
  static constexpr int TILE_BYTES = NBLK * TILE * ROW_BYTES;       // one of a stage's two inputs
  static constexpr int BAR_BYTES = 8 * 2 * (2 + STAGES);
  static constexpr int SMEM = 1024 + 4 * ITEM_BYTES + STAGES * (2 * TILE_BYTES + 2 * VEC_BYTES) + BAR_BYTES;
};

// K-major B (the products over D, S = Q.K^T and dP = dO.V^T and their
// transposes) of a streamed tile, and the step to its k16 slice kk in
// 16-byte units: 32 bytes along the 128-byte row, the next column block
// after four
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile) { return desc_sw128(tile, 16, SBO); }

template <int D, int ROWS = TILE>
__host__ __device__ constexpr uint32_t kmajor_step(int kk) {
  using G = Geo<D>;
  return ((kk * 16 / COLS) * ROWS * ROW_BYTES + (kk * 16 % COLS) * 2) >> 4;
}

// MN-major B (the products into dQ, dK, dV, over a tile's rows) of a
// streamed tile: LBO is the column blocks' stride (unused where one block
// spans N); the k16 slice kk starts 16 rows down
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(const void* tile) {
  return desc_sw128(tile, Geo<D>::NBLK > 1 ? TILE * ROW_BYTES : 16, SBO);
}

template <int D>
struct Smem {
  using G = Geo<D>;
  unsigned char* base;
  uint64_t *item_full, *item_empty, *full, *empty;
  __device__ explicit Smem(unsigned char* raw) : base(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023)) {
    item_full =
        reinterpret_cast<uint64_t*>(base + 4 * G::ITEM_BYTES + G::STAGES * (2 * G::TILE_BYTES + 2 * VEC_BYTES));
    item_empty = item_full + 2;
    full = item_empty + 2;
    empty = full + G::STAGES;
  }
  __device__ unsigned char* item(int buf, int input) const { return base + (2 * buf + input) * G::ITEM_BYTES; }
  __device__ unsigned char* tile(int stage, int input) const {
    return base + 4 * G::ITEM_BYTES + (2 * stage + input) * G::TILE_BYTES;
  }
  __device__ float* vec(int stage, int which) const {
    return reinterpret_cast<float*>(base + 4 * G::ITEM_BYTES + G::STAGES * 2 * G::TILE_BYTES +
                                    (2 * stage + which) * VEC_BYTES);
  }
  // barriers: the item buffers' full (TMA bytes) and empty (one arrival per
  // consumer warpgroup), the ring's full (vec_arrivals) and empty
  __device__ void init(int vec_arrivals) const {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&item_full[i], 1);
      mbar_init(&item_empty[i], 2);
    }
    for (int i = 0; i < G::STAGES; ++i) {
      mbar_init(&full[i], vec_arrivals);
      mbar_init(&empty[i], 2);
    }
    mbar_fence_init();
  }
};

// rows [row, row + ROWS) of one input at head h, batch b: one box per
// column block, reported to bar (ROWS * D' * 2 bytes, D' = NBLK * COLS)
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int h, int row,
                                          int b) {
#pragma unroll
  for (int kb = 0; kb < Geo<D>::NBLK; ++kb)
    tma_load_4d(dst + kb * ROWS * ROW_BYTES, map, bar, kb * COLS, h, row, b);
}

// a lane's share of one vector beside a tile: entries [r0, r0 + TILE) of
// src, zero past n
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int r0, int n, int lane) {
#pragma unroll
  for (int i = lane; i < TILE; i += 32) {
    const bool ok = r0 + i < n;
    cp_async4(dst + i, ok ? src + r0 + i : src, ok);
  }
}

template <int D>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (D == 40) wgmma_m64n40k16_rs_tb(d, a, desc_b);
  else if constexpr (D == 64) wgmma_m64n64k16_rs_tb(d, a, desc_b);
  else wgmma_m64n80k16_rs_tb(d, a, desc_b);
}

// acc += A.B over the four k16 slices of a tile's 64 rows; A the bf16
// fragments, B [64 rows, D] MN-major
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], uint32_t (&a)[TILE / 16][4], uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) wgmma_rs_tb<D>(acc, a[kk], desc_b + ((kk * 16 * ROW_BYTES) >> 4));
}

// acc = A.B^T over D: A the item's fragments, B a streamed tile K-major
template <int D>
__device__ __forceinline__ void issue_over_d(float (&acc)[32], uint32_t (&a)[Geo<D>::KSTEPS][4], uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < Geo<D>::KSTEPS; ++kk) wgmma_m64n64k16_rs(acc, a[kk], desc_b + kmajor_step<D>(kk), kk > 0);
}

// the same with A, 64 rows of an item's buffer, K-major in shared memory too
template <int D>
__device__ __forceinline__ void issue_over_d_ss(float (&acc)[32], uint64_t desc_a, uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < Geo<D>::KSTEPS; ++kk)
    wgmma_m64n64k16_ss(acc, desc_a + kmajor_step<D, ITEM_ROWS>(kk), desc_b + kmajor_step<D>(kk), kk > 0);
}

// the bf16 A fragments of an fp32 accumulator tile (k16 slice kk covers
// columns [16 kk, 16 kk + 16), the n8-tiles 2 kk and 2 kk + 1)
__device__ __forceinline__ void pack_frag(uint32_t (&a)[TILE / 16][4], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// the wgmma A fragments (the mma.sync m16n8k16 A layout of rows row0 + 16
// warp .. + 15, KSTEPS k16 slices of D) of an item's buffer: ldmatrix.x4,
// each lane addressing one row's 16-byte chunk where the swizzle put it
// (chunk ^ row % 8)
template <int D>
__device__ __forceinline__ void load_frags(uint32_t (&f)[Geo<D>::KSTEPS][4], const unsigned char* item, int row0,
                                           int warp, int lane) {
  using G = Geo<D>;
  const int mi = lane / 8, r = lane % 8;  // lane mi*8 + r addresses row r of 8x8 matrix mi
  const int row = row0 + 16 * warp + (mi % 2) * 8 + r;
#pragma unroll
  for (int kk = 0; kk < G::KSTEPS; ++kk) {
    const int chunk = 2 * kk + mi / 2;  // 16-byte chunk along D: block chunk / 8, chunk % 8 in its row
    ldmatrix_x4(f[kk],
                item + (chunk / 8) * ITEM_ROWS * ROW_BYTES + row * ROW_BYTES + (((chunk % 8) ^ (row % 8)) * 16));
  }
}

// rows row_a, row_a + 8 of a [B, S, H, D] output, times mul, as bf16; rows
// >= S are not written
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[D / 2], int row_a, int S, int H,
                                           int b, int h, float mul, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* drow = dst + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(drow + dt * 8 + (lane % 4) * 2) =
          pack_bf16(acc[4 * dt + 2 * r] * mul, acc[4 * dt + 2 * r + 1] * mul);
  }
}

// ------------------------------------------------------------------- dQ

// P of one key tile, in place of s: keys n0 + [0, 64). BIAS: 0 none, 1 key
// bias (kb: this tile's 64 entries in shared memory), 2 full bias (brow:
// this item's rows of Sk keys). lse2 is +inf on rows >= Sq.
template <int BIAS, bool RAGGED>
__device__ __forceinline__ void dq_tile_p(float (&s)[32], const float* kb, const float* __restrict__ brow,
                                          const float (&lse2)[2], int row_a, int Sq, int Sk, int n0, int lane,
                                          float qk_scale) {
#pragma unroll
  for (int i = 0; i < TILE / 8; ++i) {
    const int c0 = i * 8 + (lane % 4) * 2;
    float2 kb2 = make_float2(0.f, 0.f);
    if (BIAS == 1) {
      kb2 = *reinterpret_cast<const float2*>(kb + c0);
      kb2.x = fmaxf(kb2.x, -1e30f) * LOG2E;
      kb2.y = fmaxf(kb2.y, -1e30f) * LOG2E;
    }
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int col = n0 + c0 + e2;
      const bool key_ok = !RAGGED || col < Sk;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int idx = 4 * i + 2 * r + e2;
        float x;
        if (BIAS == 0) {
          x = fmaf(s[idx], qk_scale, -lse2[r]);
        } else if (BIAS == 1) {
          x = fmaf(s[idx], qk_scale, e2 ? kb2.y : kb2.x) - lse2[r];
        } else {
          const int row = row_a + 8 * r;
          const float bb = key_ok && row < Sq ? bias_at(brow + (long long)row * Sk + col) : 0.f;
          x = fmaf(bb, LOG2E, s[idx] * qk_scale) - lse2[r];
        }
        s[idx] = key_ok ? exp2_approx(x) : 0.f;
      }
    }
  }
}

// dS = P (dP - delta), in place of P
__device__ __forceinline__ void dq_tile_ds(float (&s)[32], const float (&dp)[32], const float (&dl)[2]) {
#pragma unroll
  for (int idx = 0; idx < 32; ++idx) s[idx] *= dp[idx] - dl[(idx / 2) % 2];
}

// item = bh * ceil(Sq / 128) + m: the blocks in flight share K/V in L2.
// bias (BIAS 1: [B, Sk], row b at bias + b * bias_sb; BIAS 2: item (b, h)
// at bias + b * bias_sb + h * bias_sh, rows of Sk keys)
template <int D, int BIAS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ bias, const float* __restrict__ lse,
                             const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H, int Sq,
                             int Sk, long long bias_sb, long long bias_sh, int n_items, float qk_scale,
                             float scale) {
  using G = Geo<D>;
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  const int n_m = (Sq + ITEM_ROWS - 1) / ITEM_ROWS;
  const int n_tiles = (Sk + TILE - 1) / TILE;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) sm.init(BIAS == 1 ? VEC_ARRIVALS : 1);
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        tma_prefetch_map(&tm_q);
        tma_prefetch_map(&tm_k);
        tma_prefetch_map(&tm_v);
        tma_prefetch_map(&tm_do);
      }
      int t = 0;  // tiles loaded so far, across items
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / n_m, b = bh / H, h = bh % H;
        const int ib = it & 1;
        mbar_wait(&sm.item_empty[ib], ((it >> 1) & 1) ^ 1);  // the first round passes at once
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.item_full[ib], 2 * G::ITEM_BYTES);
          load_rows<D, ITEM_ROWS>(sm.item(ib, 0), &tm_q, &sm.item_full[ib], h, (item % n_m) * ITEM_ROWS, b);
          load_rows<D, ITEM_ROWS>(sm.item(ib, 1), &tm_do, &sm.item_full[ib], h, (item % n_m) * ITEM_ROWS, b);
        }
        for (int j = 0; j < n_tiles; ++j, ++t) {
          const int st = t % G::STAGES;
          mbar_wait(&sm.empty[st], ((t / G::STAGES) & 1) ^ 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(&sm.full[st], 2 * G::TILE_BYTES);
            load_rows<D, TILE>(sm.tile(st, 0), &tm_k, &sm.full[st], h, j * TILE, b);
            load_rows<D, TILE>(sm.tile(st, 1), &tm_v, &sm.full[st], h, j * TILE, b);
          }
          if (BIAS == 1) {
            stage_vec(sm.vec(st, 0), bias + b * bias_sb, j * TILE, Sk, lane);
            cp_async_arrive(&sm.full[st]);
          }
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int my_bar = 1 + c, other_bar = 2 - c;  // ping-pong: issue on mine, then free the other's

    float s[32], dp[32], acc[D / 2];
    uint32_t ds[TILE / 16][4], qf[G::KSTEPS][4], of[G::KSTEPS][4];

    if (c == 1) named_arrive(1, CONSUMER_THREADS);  // consumer 0 issues first
    int t = 0;  // tiles consumed so far, across items
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / n_m, b = bh / H, h = bh % H;
      const int row_a = (item % n_m) * ITEM_ROWS + 64 * c + 16 * warp + lane / 4;  // rows row_a, row_a + 8
      const int ib = it & 1;
      const bool last_item = item + gridDim.x >= n_items;
      float lse2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        lse2[r] = row < Sq ? lse[(long long)bh * Sq + row] * LOG2E : INFINITY;  // p = 0 on zero-filled rows
        dl[r] = row < Sq ? delta[(long long)bh * Sq + row] : 0.f;
      }
      const float* brow = BIAS == 2 ? bias + b * bias_sb + h * bias_sh : nullptr;
      auto issue_s_dp = [&](int st) {  // two groups: S, then dP
        issue_over_d<D>(s, qf, kmajor_desc(sm.tile(st, 0)));  // S = Q K^T
        wgmma_commit();
        issue_over_d<D>(dp, of, kmajor_desc(sm.tile(st, 1)));  // dP = dO V^T
      };
      auto issue_dq = [&](int st) { issue_rs<D>(acc, ds, mnmajor_desc<D>(sm.tile(st, 0))); };  // dQ += dS K
      auto tile_p = [&](int j, int st) {
        const int n0 = j * TILE;
        if (n0 + TILE > Sk)
          dq_tile_p<BIAS, true>(s, sm.vec(st, 0), brow, lse2, row_a, Sq, Sk, n0, lane, qk_scale);
        else
          dq_tile_p<BIAS, false>(s, sm.vec(st, 0), brow, lse2, row_a, Sq, Sk, n0, lane, qk_scale);
      };
      // the last issue of the block's last item frees no one: the named
      // barriers end balanced
      auto hand_over = [&](bool last_issue) {
        if (!(c == 1 && last_item && last_issue)) named_arrive(other_bar, CONSUMER_THREADS);
      };
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      // Q and dO into registers once an item; their buffer is free for the
      // next item's as soon as every warp of both warpgroups has them
      mbar_wait(&sm.item_full[ib], (it >> 1) & 1);
      load_frags<D>(qf, sm.item(ib, 0), 64 * c, warp, lane);
      load_frags<D>(of, sm.item(ib, 1), 64 * c, warp, lane);
      named_sync(3 + c, 128);
      if (tid == 0) mbar_arrive(&sm.item_empty[ib]);

      // tile 0: S and dP alone
      mbar_wait(&sm.full[t % G::STAGES], (t / G::STAGES) & 1);
      named_sync(my_bar, CONSUMER_THREADS);
      wgmma_fence();
      issue_s_dp(t % G::STAGES);
      wgmma_commit();
      hand_over(false);
      wgmma_wait<1>();  // S is in; dP runs on
      fence_regs(s);
      tile_p(0, t % G::STAGES);
      wgmma_wait<0>();
      fence_regs(dp);
      dq_tile_ds(s, dp, dl);
      pack_frag(ds, s);

      for (int j = 1; j < n_tiles; ++j) {
        const int cur = t + j, st = cur % G::STAGES, prev = (cur - 1) % G::STAGES;
        mbar_wait(&sm.full[st], (cur / G::STAGES) & 1);
        named_sync(my_bar, CONSUMER_THREADS);
        wgmma_fence();  // dS of tile j-1 is written before the product reads it
        issue_s_dp(st);
        wgmma_commit();
        issue_dq(prev);
        wgmma_commit();
        hand_over(false);
        wgmma_wait<2>();  // S of tile j is in; its dP and dQ += dS K of tile j-1 run on
        fence_regs(s);
        tile_p(j, st);
        wgmma_wait<1>();  // dP of tile j is in; dQ += dS K of tile j-1 runs on
        fence_regs(dp);
        dq_tile_ds(s, dp, dl);
        wgmma_wait<0>();  // tile j-1's product retired: its stage can be refilled, ds rewritten
        fence_regs(acc);
        fence_regs(ds);
        if (tid == 0) mbar_arrive(&sm.empty[prev]);
        pack_frag(ds, s);
      }
      const int last = (t + n_tiles - 1) % G::STAGES;
      named_sync(my_bar, CONSUMER_THREADS);
      wgmma_fence();
      issue_dq(last);
      wgmma_commit();
      hand_over(true);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ds);
      if (tid == 0) mbar_arrive(&sm.empty[last]);
      t += n_tiles;
      store_rows<D>(dq, acc, row_a, Sq, H, b, h, scale, lane);
    }
  }
}

// ----------------------------------------------------------------- dK/dV

// P^T of one query tile, in place of sT: query rows m0 + [0, 64) are the
// columns, this thread's keys key_a, key_a + 8 the rows. L: the tile's lse
// in shared memory. BIAS 1: kb2 the keys' bias * LOG2E; BIAS 2: brow this
// item's rows of Sk keys.
template <int BIAS, bool RAGGED>
__device__ __forceinline__ void dkv_tile_p(float (&sT)[32], const float* L, const float (&kb2)[2],
                                           const float* __restrict__ brow, int key_a, int Sq, int Sk, int m0,
                                           int lane, float qk_scale) {
#pragma unroll
  for (int i = 0; i < TILE / 8; ++i) {
    const int c0 = i * 8 + (lane % 4) * 2;
    const float2 l2 = *reinterpret_cast<const float2*>(L + c0);
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = m0 + c0 + e2;  // query row
      const bool row_ok = !RAGGED || row < Sq;
      const float lse2 = (e2 ? l2.y : l2.x) * LOG2E;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int idx = 4 * i + 2 * r + e2;
        float x;
        if (BIAS == 0) {
          x = fmaf(sT[idx], qk_scale, -lse2);
        } else if (BIAS == 1) {
          x = fmaf(sT[idx], qk_scale, kb2[r]) - lse2;
        } else {
          const int key = key_a + 8 * r;
          const float bb = row_ok && key < Sk ? bias_at(brow + (long long)row * Sk + key) : 0.f;
          x = fmaf(bb, LOG2E, sT[idx] * qk_scale) - lse2;
        }
        sT[idx] = row_ok ? exp2_approx(x) : 0.f;  // zero-filled rows' lse (0) is never used
      }
    }
  }
}

// dS^T = P^T (dP^T - delta), in place of dP^T; Dl the tile's delta in
// shared memory
__device__ __forceinline__ void dkv_tile_ds(const float (&sT)[32], float (&dpT)[32], const float* Dl, int lane) {
#pragma unroll
  for (int i = 0; i < TILE / 8; ++i) {
    const float2 d2 = *reinterpret_cast<const float2*>(Dl + i * 8 + (lane % 4) * 2);
#pragma unroll
    for (int idx = 4 * i; idx < 4 * i + 4; ++idx) dpT[idx] = sT[idx] * (dpT[idx] - (idx % 2 ? d2.y : d2.x));
  }
}

// item = bh * ceil(Sk / 128) + kt; bias as in the dQ kernel
template <int D, int BIAS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ bias, const float* __restrict__ lse,
                              const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int H, int Sq, int Sk, long long bias_sb,
                              long long bias_sh, int n_items, float qk_scale, float scale) {
  using G = Geo<D>;
  // S^T = K.Q^T and dP^T = V.dO^T take K and V from the item's buffer in
  // shared memory, not from registers, where the fragments do not fit: at
  // D = 80 (40 registers beside the 176 of S^T, dP^T, P^T, dS^T and the
  // accumulators, in the consumers' 232), and with a full bias, whose loads
  // in the tile math need the room
  constexpr bool A_SMEM = D == 80 || BIAS == 2;
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  const int n_kt = (Sk + ITEM_ROWS - 1) / ITEM_ROWS;
  const int n_tiles = (Sq + TILE - 1) / TILE;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) sm.init(VEC_ARRIVALS);
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        tma_prefetch_map(&tm_q);
        tma_prefetch_map(&tm_k);
        tma_prefetch_map(&tm_v);
        tma_prefetch_map(&tm_do);
      }
      int t = 0;
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / n_kt, b = bh / H, h = bh % H;
        const int ib = it & 1;
        mbar_wait(&sm.item_empty[ib], ((it >> 1) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.item_full[ib], 2 * G::ITEM_BYTES);
          load_rows<D, ITEM_ROWS>(sm.item(ib, 0), &tm_k, &sm.item_full[ib], h, (item % n_kt) * ITEM_ROWS, b);
          load_rows<D, ITEM_ROWS>(sm.item(ib, 1), &tm_v, &sm.item_full[ib], h, (item % n_kt) * ITEM_ROWS, b);
        }
        for (int j = 0; j < n_tiles; ++j, ++t) {
          const int st = t % G::STAGES;
          mbar_wait(&sm.empty[st], ((t / G::STAGES) & 1) ^ 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(&sm.full[st], 2 * G::TILE_BYTES);
            load_rows<D, TILE>(sm.tile(st, 0), &tm_q, &sm.full[st], h, j * TILE, b);
            load_rows<D, TILE>(sm.tile(st, 1), &tm_do, &sm.full[st], h, j * TILE, b);
          }
          stage_vec(sm.vec(st, 0), lse + (long long)bh * Sq, j * TILE, Sq, lane);
          stage_vec(sm.vec(st, 1), delta + (long long)bh * Sq, j * TILE, Sq, lane);
          cp_async_arrive(&sm.full[st]);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;

    float sT[32], dpT[32], acc_k[D / 2], acc_v[D / 2];
    uint32_t pf[TILE / 16][4], dsf[TILE / 16][4], kf[G::KSTEPS][4], vf[G::KSTEPS][4];

    int t = 0;
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / n_kt, b = bh / H, h = bh % H;
      const int key_a = (item % n_kt) * ITEM_ROWS + 64 * c + 16 * warp + lane / 4;  // keys key_a, key_a + 8
      const int ib = it & 1;
      float kb2[2] = {0.f, 0.f};
      if (BIAS == 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (key_a + 8 * r < Sk) kb2[r] = bias_at(bias + b * bias_sb + key_a + 8 * r) * LOG2E;
      }
      const float* brow = BIAS == 2 ? bias + b * bias_sb + h * bias_sh : nullptr;
      auto issue_st = [&](int st) {  // two groups: S^T = K Q^T, then dP^T = V dO^T
        if constexpr (A_SMEM) {
          const int rows = 64 * c * ROW_BYTES;  // this consumer's 64 keys of the item
          issue_over_d_ss<D>(sT, kmajor_desc(sm.item(ib, 0) + rows), kmajor_desc(sm.tile(st, 0)));
          wgmma_commit();
          issue_over_d_ss<D>(dpT, kmajor_desc(sm.item(ib, 1) + rows), kmajor_desc(sm.tile(st, 1)));
        } else {
          issue_over_d<D>(sT, kf, kmajor_desc(sm.tile(st, 0)));
          wgmma_commit();
          issue_over_d<D>(dpT, vf, kmajor_desc(sm.tile(st, 1)));
        }
      };
      auto issue_kv = [&](int st) {  // dV += P^T dO, dK += dS^T Q
        issue_rs<D>(acc_v, pf, mnmajor_desc<D>(sm.tile(st, 1)));
        issue_rs<D>(acc_k, dsf, mnmajor_desc<D>(sm.tile(st, 0)));
      };
      auto tile_p = [&](int j, int st) {
        const int m0 = j * TILE;
        if (m0 + TILE > Sq)
          dkv_tile_p<BIAS, true>(sT, sm.vec(st, 0), kb2, brow, key_a, Sq, Sk, m0, lane, qk_scale);
        else
          dkv_tile_p<BIAS, false>(sT, sm.vec(st, 0), kb2, brow, key_a, Sq, Sk, m0, lane, qk_scale);
      };
      auto retire_kv = [&]() {
        fence_regs(acc_v);
        fence_regs(acc_k);
        fence_regs(pf);
        fence_regs(dsf);
      };
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

      // K and V into registers once an item; their buffer is free for the
      // next item's as soon as every warp of both warpgroups has them (with
      // A_SMEM, once the item's last product has retired)
      mbar_wait(&sm.item_full[ib], (it >> 1) & 1);
      if constexpr (!A_SMEM) {
        load_frags<D>(kf, sm.item(ib, 0), 64 * c, warp, lane);
        load_frags<D>(vf, sm.item(ib, 1), 64 * c, warp, lane);
        named_sync(3 + c, 128);
        if (tid == 0) mbar_arrive(&sm.item_empty[ib]);
      }

      // tile 0: S^T and dP^T alone
      mbar_wait(&sm.full[t % G::STAGES], (t / G::STAGES) & 1);
      wgmma_fence();
      issue_st(t % G::STAGES);
      wgmma_commit();
      wgmma_wait<1>();  // S^T is in; dP^T runs on
      fence_regs(sT);
      tile_p(0, t % G::STAGES);
      wgmma_wait<0>();
      fence_regs(dpT);
      dkv_tile_ds(sT, dpT, sm.vec(t % G::STAGES, 1), lane);
      pack_frag(pf, sT);
      pack_frag(dsf, dpT);

      for (int j = 1; j < n_tiles; ++j) {
        const int cur = t + j, st = cur % G::STAGES, prev = (cur - 1) % G::STAGES;
        mbar_wait(&sm.full[st], (cur / G::STAGES) & 1);
        wgmma_fence();  // P^T, dS^T of tile j-1 are written before the products read them
        issue_st(st);
        wgmma_commit();
        issue_kv(prev);
        wgmma_commit();
        wgmma_wait<2>();  // S^T of tile j is in; its dP^T and tile j-1's dV, dK products run on
        fence_regs(sT);
        tile_p(j, st);
        wgmma_wait<1>();  // dP^T of tile j is in; tile j-1's dV, dK products run on
        fence_regs(dpT);
        dkv_tile_ds(sT, dpT, sm.vec(st, 1), lane);
        wgmma_wait<0>();  // tile j-1's products retired: its stage can be refilled
        retire_kv();
        if (tid == 0) mbar_arrive(&sm.empty[prev]);
        pack_frag(pf, sT);
        pack_frag(dsf, dpT);
      }
      const int last = (t + n_tiles - 1) % G::STAGES;
      wgmma_fence();
      issue_kv(last);
      wgmma_commit();
      wgmma_wait<0>();
      retire_kv();
      if (tid == 0) mbar_arrive(&sm.empty[last]);
      if constexpr (A_SMEM) {
        named_sync(3 + c, 128);  // every warp's products that read the item have retired
        if (tid == 0) mbar_arrive(&sm.item_empty[ib]);
      }
      t += n_tiles;
      store_rows<D>(dk, acc_k, key_a, Sk, H, b, h, scale, lane);
      store_rows<D>(dv, acc_v, key_a, Sk, H, b, h, 1.f, lane);
    }
  }
}

// ----------------------------------------------------------------- host

// the SM count of the current device, after allowing `kern` its dynamic
// shared memory; both once per device and kernel, since the wrapper's host
// time is most of a call at the small shapes (CLIP's 77 tokens)
template <auto kern, int SMEM>
int sm_count(int* out) {
  static int sms[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      sms[dev] = 0;
      return static_cast<int>(err);
    }
  }
  *out = sms[dev];
  return 0;
}

struct Maps {
  CUtensorMap q, k, v, dout;
  long long bias_sb, bias_sh;
};

// maps: the specs of q, k, v and dout, then the bias's batch and head
// strides; each spec's head dim must be D, its box columns the layout's
// swizzle row and its box rows the kernel's tiles (q_rows for q and dout,
// k_rows for k and v)
template <int D>
int encode_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout,
                const unsigned long long* maps, unsigned long long q_rows, unsigned long long k_rows) {
  for (int i = 0; i < 4; ++i) {
    const unsigned long long* spec = maps + i * MAP_WORDS;
    if (spec[0] != D || box_cols(spec) != COLS || box_rows(spec) != (i == 1 || i == 2 ? k_rows : q_rows))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = encode(&m->q, q, maps);
  if (rc == 0) rc = encode(&m->k, k, maps + MAP_WORDS);
  if (rc == 0) rc = encode(&m->v, v, maps + 2 * MAP_WORDS);
  if (rc == 0) rc = encode(&m->dout, dout, maps + 3 * MAP_WORDS);
  m->bias_sb = static_cast<long long>(maps[4 * MAP_WORDS]);
  m->bias_sh = static_cast<long long>(maps[4 * MAP_WORDS + 1]);
  return rc;
}

struct Args {
  const void *bias, *lse, *delta;
  void *out0, *out1;  // dq; or dk, dv
  int B, H, Sq, Sk;
  float scale;
  cudaStream_t stream;
};

template <int D, int BIAS>
int launch_dq(const Maps& m, const Args& a) {
  int sms = 0;
  const int rc = sm_count<flash_bwd_dq_sm90_kernel<D, BIAS>, Geo<D>::SMEM>(&sms);
  if (rc != 0) return rc;
  const long long n_items = (long long)((a.Sq + ITEM_ROWS - 1) / ITEM_ROWS) * a.B * a.H;
  if (n_items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);  // one block per SM, persistent
  flash_bwd_dq_sm90_kernel<D, BIAS><<<grid, THREADS, Geo<D>::SMEM, a.stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(a.bias), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0), a.H, a.Sq, a.Sk, m.bias_sb,
      m.bias_sh, static_cast<int>(n_items), a.scale * LOG2E, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BIAS>
int launch_dkv(const Maps& m, const Args& a) {
  int sms = 0;
  const int rc = sm_count<flash_bwd_dkv_sm90_kernel<D, BIAS>, Geo<D>::SMEM>(&sms);
  if (rc != 0) return rc;
  const long long n_items = (long long)((a.Sk + ITEM_ROWS - 1) / ITEM_ROWS) * a.B * a.H;
  if (n_items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);
  flash_bwd_dkv_sm90_kernel<D, BIAS><<<grid, THREADS, Geo<D>::SMEM, a.stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(a.bias), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0), static_cast<__nv_bfloat16*>(a.out1),
      a.H, a.Sq, a.Sk, m.bias_sb, m.bias_sh, static_cast<int>(n_items), a.scale * LOG2E, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// encode the maps (q and dout in boxes of Q_ROWS rows, k and v of K_ROWS)
// and launch the instance of head dim D and the bias mode
template <int D, bool DKV>
int run(const void* q, const void* k, const void* v, const void* dout, const unsigned long long* maps, int bias_mode,
        const Args& a) {
  Maps m;
  const int rc = DKV ? encode_maps<D>(&m, q, k, v, dout, maps, TILE, ITEM_ROWS)
                     : encode_maps<D>(&m, q, k, v, dout, maps, ITEM_ROWS, TILE);
  if (rc != 0) return rc;
  switch (bias_mode) {
    case 0: return DKV ? launch_dkv<D, 0>(m, a) : launch_dq<D, 0>(m, a);
    case 1: return DKV ? launch_dkv<D, 1>(m, a) : launch_dq<D, 1>(m, a);
    case 2: return DKV ? launch_dkv<D, 2>(m, a) : launch_dq<D, 2>(m, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool DKV>
int dispatch(int head_dim, const void* q, const void* k, const void* v, const void* dout,
             const unsigned long long* maps, int bias_mode, const Args& a) {
  switch (head_dim) {
    case 40: return run<40, DKV>(q, k, v, dout, maps, bias_mode, a);
    case 64: return run<64, DKV>(q, k, v, dout, maps, bias_mode, a);
    case 80: return run<80, DKV>(q, k, v, dout, maps, bias_mode, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, dout: bf16 [B, Sq, H, D] and k, v: bf16 [B, Sk, H, D] views, D = 40,
// 64 or 80; maps: four tensor-map specs of MAP_WORDS words (q, k, v, dout),
// then the bias's batch and head strides in elements (bias_mode 1: [B, Sk]
// key bias; 2: full, rows of Sk keys). lse, delta: contiguous fp32 [B, H,
// Sq]. Outputs contiguous bf16 [B, S, H, D]. Each returns 0, a cudaError_t
// code, or ENCODE_FAILED + the CUresult of a tensor map cuTensorMapEncodeTiled
// refused.
extern "C" int uwu_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* bias,
                                     const void* dout, const void* lse, const void* delta, void* dq, int B, int H,
                                     int Sq, int Sk, int head_dim, int bias_mode, const unsigned long long* maps,
                                     float scale, void* stream) {
  const Args a{bias, lse, delta, dq, nullptr, B, H, Sq, Sk, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(head_dim, q, k, v, dout, maps, bias_mode, a);
}

extern "C" int uwu_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* bias,
                                      const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                                      int B, int H, int Sq, int Sk, int head_dim, int bias_mode,
                                      const unsigned long long* maps, float scale, void* stream) {
  const Args a{bias, lse, delta, dk, dv, B, H, Sq, Sk, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(head_dim, q, k, v, dout, maps, bias_mode, a);
}
