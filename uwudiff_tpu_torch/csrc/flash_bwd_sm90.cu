// Flash-attention backward for Hopper (sm_90a) at head dims 40, 64, 80, 128
// and 160: dQ and dK/dV, each a persistent, warp-specialised kernel on TMA,
// an mbarrier ring and wgmma, one template over the head dim.
//
// Replaces the TPU kernels uwudiff_tpu/ops/flash_attention.py::_bwd_dq_kernel
// (:271, K4: flash_bwd_dq_sm90) and ::_bwd_dkv_kernel (:365, K6:
// flash_bwd_dkv_sm90). D = 64 is SDXL's, CLIP's, T5's and the SD3 MMDiT's;
// 40, 80 and 160 are SD1.5's three levels; 128 is Flux's (the flux_1b
// training step, 12 heads of 128). The dQ + dBias kernel (K5) is
// flash_bwd.cu's at every head dim; flash_bwd.cu's mma.sync dQ and dK/dV
// compute the same function at D = 160 and stay built as the yardstick, on
// no path.
//
// The backward is split in two as in flash_bwd.cu, so that no output is
// summed across blocks: no atomics, and dQ, dK and dV are the same bits from
// run to run (each work item owns its output rows and walks its tiles in a
// fixed order). delta = rowsum(dO * O) arrives precomputed, fp32 [B, H, Sq].
//   dQ  : an item is 128 query rows of one (batch, head); Q and dO come in
//         once, the loop runs over key tiles of 64: S = Q.K^T and
//         dP = dO.V^T, dS = P (dP - delta), dQ += dS.K; dQ *= scale.
//   dK/dV: an item is 128 keys (64 at D = 128 and 160); K and V come in once, the
//         loop runs over query tiles of 64: S^T = K.Q^T and dP^T = V.dO^T,
//         so that each consumer's 64 keys are the rows of its fragments,
//         dS^T = P^T (dP^T - delta), dV += P^T.dO and dK += dS^T.Q; dK *=
//         scale.
// The products over D (S, dP and their transposes) are wgmma.m64n64k16 with
// A from registers: the item's own operand (Q and dO, or K and V), read from
// shared memory into wgmma fragments once an item (ldmatrix through the
// swizzle); B the streamed tile, K-major. The products into dQ, dV and dK
// are wgmma.m64nDk16 (N = 40, 64, 80, 128, 160) with A the fp32 P and dS (P^T,
// dS^T) re-packed to bf16, B the streamed tile MN-major (the transpose bit).
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
// behind than D = 64's. At SD1.5's D = 160 shapes (256 or 64 query rows,
// 256, 77 or 64 keys) the bytes bound both kernels. At the flux_1b step's
// [8, 1101, 1101, 12, 128] the tensor cores do (0.090 / 0.120 ms for dQ /
// dK/dV at 989 TF/s, the bytes 0.04); dK/dV, split, computes S^T twice
// (5 products a tile, 0.151 ms). The design:
//   - a persistent grid of one 384-thread block per SM; warpgroup 0 is the
//     producer (40 registers after setmaxnreg; its first warp loads),
//     warpgroups 1 and 2 consume 64 rows of the item each (232; 224 and
//     240 where dK/dV's consumers split by role, below);
//   - shared tiles are D = 64's at every head dim: rows of 64 columns, 128
//     bytes, 128B-swizzled, one TMA box per 64-column block (one at D = 40
//     and 64, two at 80 and 128, three at 160), TMA zero-filling the columns
//     past D. The products over D read only up to the next multiple of 16
//     (3, 4, 5, 8, 10 k16 steps; columns 40-47 at D = 40 are those zeros), the
//     products into dQ, dK, dV write N = D columns. Boxes of 16 columns
//     under a 32-byte swizzle, the tile no wider than D, took 3-5 % longer
//     at D = 40: three small TMA rows for each of D = 64's one;
//   - the item's own block (Q and dO, or K and V) goes by TMA into one of two
//     buffers, freed as soon as both consumers hold it in registers, so the
//     next item's loads early; the streamed tiles (K and V, or Q and dO) go
//     through a ring of as many stages as fit, at most 5 (5 at D = 40 and
//     64, 3 at 80, 3 (dQ) or 4 (dK/dV) at 128, 2 or 3 at 160), that runs on
//     across items, each with a full
//     mbarrier (TMA transaction bytes plus the vectors' copies) and an empty
//     one (one arrival per consumer warpgroup, made after wgmma.wait_group
//     has retired every product that reads the stage). Tensor maps are rank
//     4 over (D, H, S, B) with the views' own strides: strided head views go
//     in uncopied, and TMA zero-fills rows past Sq or Sk;
//   - A from registers halves the shared-memory reads of the products over
//     D. Where the fragments do not fit beside the accumulators (dK/dV at
//     D = 80: 40 registers beside 176; dK/dV with a full bias, whose loads
//     need the room; both kernels at 128 and 160) the item's operands stay in its
//     buffer and those products read A from shared memory too; the buffer
//     is freed when the item's last product that reads it retires;
//   - D = 160 (Cfg): dQ's 128-row item of Q and dO is 96 KB, so it has one
//     buffer, not two, beside two stages, freed once the item's last S and
//     dP are in, before its last dQ product; dK/dV's item (below) has one
//     too, beside three. dK and dV at m64n160 are 80 fp32 registers each, and the two
//     beside S^T and dP^T (32 + 32) would fill the consumers' 232: so a
//     dK/dV item is 64 keys that both consumers share, split by role. One
//     computes S^T, P^T and dV (128 accumulator and fragment registers),
//     the other S^T, dP^T, dS^T and dK (160): S^T is computed twice, 5
//     products a tile where one consumer would issue 4, but no P^T goes
//     through shared memory and neither waits for the other;
//   - D = 128 (Cfg) takes D = 160's choices where the registers force them
//     and keeps two item buffers where shared memory allows. dK/dV: dK and
//     dV at m64n128 are 64 fp32 registers each, and the two beside S^T,
//     dP^T (32 + 32) and the bf16 P^T and dS^T (16 + 16) are 224 of the
//     consumers' 232 before an address: so the consumers split by role over
//     64 shared keys as at 160 (dV role: S^T, P^T, dV, 112 registers; dK
//     role: S^T, dP^T, dS^T, dK, 144), K and V read from the item's buffer,
//     which holds 32 KB, so two buffers beside four stages. dQ: the Q and
//     dO fragments (8 k16 steps, 64 registers) beside dQ (64), S and dP
//     (64) and dS (16) would leave 24 for the rest, so Q and dO are read
//     from the item's 64 KB buffer, two of them beside three stages.
//     Measured against this (flash_variants.py, [8, 1101, 1101, 12, 128]):
//     dK/dV unsplit spills and serialises its wgmma, 10 % slower; dQ with
//     Q and dO in registers the same, 28 % slower; one item buffer (4 and 5
//     stages) level within 2 %;
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
// wgmma at every instance, D = 128's too (chip_smoke.py prints the report);
// times are in PERF.md.

#include <math.h>

#include <type_traits>

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
constexpr int SMEM_MAX = 232448;         // dynamic shared memory a block may have (227 KB)
constexpr int MAX_STAGES = 5;

// The tiles of head dim D (40, 64, 80, 128 or 160): at every D the 128-byte
// swizzle of D = 64, a tile's row 64 columns. A tile is NBLK column blocks
// of rows x 128 bytes, one TMA box each (one block at D = 40 and 64, two at
// 80 and 128, three at 160); TMA zero-fills the columns past D, which the
// products over D read only up to the next multiple of 16 (KSTEPS k16
// steps: 3, 4, 5, 8, 10; columns 40-47 at D = 40 are zeros). The products
// into dQ, dK and dV run at N = D (wgmma.m64n40k16 / m64n64k16 / m64n80k16 /
// m64n128k16 / m64n160k16).
template <int D>
struct Geo {
  static_assert(D == 40 || D == 64 || D == 80 || D == 128 || D == 160, "head dims 40, 64, 80, 128, 160");
  static constexpr int NBLK = (D + COLS - 1) / COLS;
  static constexpr int KSTEPS = (D + 15) / 16;
};

// The shared memory of one kernel (dQ, or dK/dV with DKV) at head dim D.
// SPLIT (dK/dV at D = 128 and 160): the two consumers share an item of 64
// keys, one accumulating dV and the other dK, where each would otherwise
// hold both (at m64n128 128 registers, at m64n160 160, beside S^T, dP^T,
// P^T and dS^T). ITEM_BUFS buffers of the item's two inputs: two, so the
// next item loads during this one (at D = 128 dQ's 64 KB of Q + dO twice
// beside three stages, dK/dV's 32 KB of K + V twice beside four), but one
// at D = 160: dQ's 128-row Q + dO is 96 KB, and dK/dV's 48 KB of K and V
// in one buffer leave room for a third stage, which the card measured
// faster than a second buffer beside two (flash_variants.py). As many ring
// stages as fit beside them, at most MAX_STAGES: 5 at D = 40 and 64, 3 at
// 80, 3 (dQ) and 4 (dK/dV) at 128, 2 (dQ) and 3 (dK/dV) at 160.
template <int D, bool DKV>
struct Cfg : Geo<D> {
  static constexpr bool SPLIT = DKV && D >= 128;
  static constexpr int ITEM = SPLIT ? 64 : ITEM_ROWS;  // rows an item owns
  static constexpr int ITEM_BUFS = D > 128 ? 1 : 2;
  // K and V (dK/dV) or Q and dO (dQ) read by the products over D from the
  // item's buffer, not from registers: where the fragments do not fit
  // beside the accumulators (dK/dV at D = 80: 40 registers beside the 176
  // of S^T, dP^T, P^T, dS^T and the accumulators; both kernels at 128: 64
  // beside 144 in dQ; at 160: 80)
  static constexpr bool A_SMEM = D > 64 && (DKV || D >= 128);
  static constexpr int ITEM_BYTES = Geo<D>::NBLK * ITEM * ROW_BYTES;  // one of the item's two inputs
  static constexpr int TILE_BYTES = Geo<D>::NBLK * TILE * ROW_BYTES;  // one of a stage's two inputs
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + 2 * VEC_BYTES;
  static constexpr int FIT =
      (SMEM_MAX - 1024 - 8 * 2 * (ITEM_BUFS + MAX_STAGES) - ITEM_BUFS * 2 * ITEM_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int BAR_BYTES = 8 * 2 * (ITEM_BUFS + STAGES);
  static constexpr int SMEM = 1024 + ITEM_BUFS * 2 * ITEM_BYTES + STAGES * STAGE_BYTES + BAR_BYTES;
  static_assert(STAGES >= 2 && SMEM <= SMEM_MAX, "the ring needs two stages");
};

// K-major B (the products over D, S = Q.K^T and dP = dO.V^T and their
// transposes) of a streamed tile, and the step to its k16 slice kk in
// 16-byte units: 32 bytes along the 128-byte row, the next column block
// after four (ROWS: the rows of the tile or buffer the operand lies in)
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile) { return desc_sw128(tile, 16, SBO); }

template <int ROWS>
__host__ __device__ constexpr uint32_t kmajor_step(int kk) {
  return ((kk * 16 / COLS) * ROWS * ROW_BYTES + (kk * 16 % COLS) * 2) >> 4;
}

// MN-major B (the products into dQ, dK, dV, over a tile's rows) of a
// streamed tile: LBO is the column blocks' stride (unused where one block
// spans N); the k16 slice kk starts 16 rows down
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(const void* tile) {
  return desc_sw128(tile, Geo<D>::NBLK > 1 ? TILE * ROW_BYTES : 16, SBO);
}

template <class C>
struct Smem {
  unsigned char* base;
  uint64_t *item_full, *item_empty, *full, *empty;
  __device__ explicit Smem(unsigned char* raw) : base(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023)) {
    item_full = reinterpret_cast<uint64_t*>(base + C::ITEM_BUFS * 2 * C::ITEM_BYTES + C::STAGES * C::STAGE_BYTES);
    item_empty = item_full + C::ITEM_BUFS;
    full = item_empty + C::ITEM_BUFS;
    empty = full + C::STAGES;
  }
  __device__ unsigned char* item(int buf, int input) const { return base + (2 * buf + input) * C::ITEM_BYTES; }
  __device__ unsigned char* tile(int stage, int input) const {
    return base + C::ITEM_BUFS * 2 * C::ITEM_BYTES + (2 * stage + input) * C::TILE_BYTES;
  }
  __device__ float* vec(int stage, int which) const {
    return reinterpret_cast<float*>(base + C::ITEM_BUFS * 2 * C::ITEM_BYTES + C::STAGES * 2 * C::TILE_BYTES +
                                    (2 * stage + which) * VEC_BYTES);
  }
  // barriers: the item buffers' full (TMA bytes) and empty (one arrival per
  // consumer warpgroup), the ring's full (vec_arrivals) and empty
  __device__ void init(int vec_arrivals) const {
    for (int i = 0; i < C::ITEM_BUFS; ++i) {
      mbar_init(&item_full[i], 1);
      mbar_init(&item_empty[i], 2);
    }
    for (int i = 0; i < C::STAGES; ++i) {
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
  else if constexpr (D == 80) wgmma_m64n80k16_rs_tb(d, a, desc_b);
  else if constexpr (D == 128) wgmma_m64n128k16_rs_tb(d, a, desc_b);
  else if constexpr (D == 160) wgmma_m64n160k16_rs_tb(d, a, desc_b);
  else static_assert(D == 160, "a head dim with no product into dQ, dK, dV");
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
  for (int kk = 0; kk < Geo<D>::KSTEPS; ++kk) wgmma_m64n64k16_rs(acc, a[kk], desc_b + kmajor_step<TILE>(kk), kk > 0);
}

// the same with A, 64 rows of an item's buffer of A_ROWS rows, K-major in
// shared memory too
template <int D, int A_ROWS>
__device__ __forceinline__ void issue_over_d_ss(float (&acc)[32], uint64_t desc_a, uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < Geo<D>::KSTEPS; ++kk)
    wgmma_m64n64k16_ss(acc, desc_a + kmajor_step<A_ROWS>(kk), desc_b + kmajor_step<TILE>(kk), kk > 0);
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
// warp .. + 15, KSTEPS k16 slices of D) of an item's buffer of ITEM_ROWS
// rows: ldmatrix.x4, each lane addressing one row's 16-byte chunk where the
// swizzle put it (chunk ^ row % 8)
template <int D>
__device__ __forceinline__ void load_frags(uint32_t (&f)[Geo<D>::KSTEPS][4], const unsigned char* item, int row0,
                                           int warp, int lane) {
  const int mi = lane / 8, r = lane % 8;  // lane mi*8 + r addresses row r of 8x8 matrix mi
  const int row = row0 + 16 * warp + (mi % 2) * 8 + r;
#pragma unroll
  for (int kk = 0; kk < Geo<D>::KSTEPS; ++kk) {
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
  using C = Cfg<D, false>;
  extern __shared__ unsigned char smem_raw[];
  const Smem<C> sm(smem_raw);
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
        const int ib = it % C::ITEM_BUFS;
        mbar_wait(&sm.item_empty[ib], ((it / C::ITEM_BUFS) & 1) ^ 1);  // the first round passes at once
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.item_full[ib], 2 * C::ITEM_BYTES);
          load_rows<D, ITEM_ROWS>(sm.item(ib, 0), &tm_q, &sm.item_full[ib], h, (item % n_m) * ITEM_ROWS, b);
          load_rows<D, ITEM_ROWS>(sm.item(ib, 1), &tm_do, &sm.item_full[ib], h, (item % n_m) * ITEM_ROWS, b);
        }
        for (int j = 0; j < n_tiles; ++j, ++t) {
          const int st = t % C::STAGES;
          mbar_wait(&sm.empty[st], ((t / C::STAGES) & 1) ^ 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(&sm.full[st], 2 * C::TILE_BYTES);
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
    uint32_t ds[TILE / 16][4];
    // Q and dO as A fragments, or (A_SMEM) read from the item's buffer
    uint32_t qf[C::A_SMEM ? 1 : C::KSTEPS][4], of[C::A_SMEM ? 1 : C::KSTEPS][4];

    if (c == 1) named_arrive(1, CONSUMER_THREADS);  // consumer 0 issues first
    int t = 0;  // tiles consumed so far, across items
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / n_m, b = bh / H, h = bh % H;
      const int row_a = (item % n_m) * ITEM_ROWS + 64 * c + 16 * warp + lane / 4;  // rows row_a, row_a + 8
      const int ib = it % C::ITEM_BUFS;
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
        if constexpr (C::A_SMEM) {
          const int rows = 64 * c * ROW_BYTES;  // this consumer's 64 rows of the item
          issue_over_d_ss<D, ITEM_ROWS>(s, kmajor_desc(sm.item(ib, 0) + rows), kmajor_desc(sm.tile(st, 0)));
          wgmma_commit();
          issue_over_d_ss<D, ITEM_ROWS>(dp, kmajor_desc(sm.item(ib, 1) + rows), kmajor_desc(sm.tile(st, 1)));
        } else {
          issue_over_d<D>(s, qf, kmajor_desc(sm.tile(st, 0)));  // S = Q K^T
          wgmma_commit();
          issue_over_d<D>(dp, of, kmajor_desc(sm.tile(st, 1)));  // dP = dO V^T
        }
      };
      // with A_SMEM the item's buffer is free once its last S and dP are in
      auto free_item = [&](int j) {
        if (C::A_SMEM && j == n_tiles - 1) {
          named_sync(3 + c, 128);  // every warp's products that read the item have retired
          if (tid == 0) mbar_arrive(&sm.item_empty[ib]);
        }
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
      mbar_wait(&sm.item_full[ib], (it / C::ITEM_BUFS) & 1);
      if constexpr (!C::A_SMEM) {
        load_frags<D>(qf, sm.item(ib, 0), 64 * c, warp, lane);
        load_frags<D>(of, sm.item(ib, 1), 64 * c, warp, lane);
        named_sync(3 + c, 128);
        if (tid == 0) mbar_arrive(&sm.item_empty[ib]);
      }

      // tile 0: S and dP alone
      mbar_wait(&sm.full[t % C::STAGES], (t / C::STAGES) & 1);
      named_sync(my_bar, CONSUMER_THREADS);
      wgmma_fence();
      issue_s_dp(t % C::STAGES);
      wgmma_commit();
      hand_over(false);
      wgmma_wait<1>();  // S is in; dP runs on
      fence_regs(s);
      tile_p(0, t % C::STAGES);
      wgmma_wait<0>();
      fence_regs(dp);
      free_item(0);
      dq_tile_ds(s, dp, dl);
      pack_frag(ds, s);

      for (int j = 1; j < n_tiles; ++j) {
        const int cur = t + j, st = cur % C::STAGES, prev = (cur - 1) % C::STAGES;
        mbar_wait(&sm.full[st], (cur / C::STAGES) & 1);
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
        free_item(j);
        dq_tile_ds(s, dp, dl);
        wgmma_wait<0>();  // tile j-1's product retired: its stage can be refilled, ds rewritten
        fence_regs(acc);
        fence_regs(ds);
        if (tid == 0) mbar_arrive(&sm.empty[prev]);
        pack_frag(ds, s);
      }
      const int last = (t + n_tiles - 1) % C::STAGES;
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

// what a dK/dV consumer accumulates: both dK and dV over its own 64 keys,
// or (Cfg::SPLIT) one of them over the 64 keys both consumers share
enum Role { BOTH, DV_ONLY, DK_ONLY };

// item = bh * ceil(Sk / Cfg::ITEM) + kt; bias as in the dQ kernel
template <int D, int BIAS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ bias, const float* __restrict__ lse,
                              const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int H, int Sq, int Sk, long long bias_sb,
                              long long bias_sh, int n_items, float qk_scale, float scale) {
  using C = Cfg<D, true>;
  // S^T = K.Q^T and dP^T = V.dO^T take K and V from the item's buffer in
  // shared memory, not from registers, where the fragments do not fit
  // (Cfg::A_SMEM), and with a full bias, whose loads in the tile math need
  // the room
  constexpr bool A_SMEM = C::A_SMEM || BIAS == 2;
  extern __shared__ unsigned char smem_raw[];
  const Smem<C> sm(smem_raw);
  const int n_kt = (Sk + C::ITEM - 1) / C::ITEM;
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
        const int ib = it % C::ITEM_BUFS;
        mbar_wait(&sm.item_empty[ib], ((it / C::ITEM_BUFS) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.item_full[ib], 2 * C::ITEM_BYTES);
          load_rows<D, C::ITEM>(sm.item(ib, 0), &tm_k, &sm.item_full[ib], h, (item % n_kt) * C::ITEM, b);
          load_rows<D, C::ITEM>(sm.item(ib, 1), &tm_v, &sm.item_full[ib], h, (item % n_kt) * C::ITEM, b);
        }
        for (int j = 0; j < n_tiles; ++j, ++t) {
          const int st = t % C::STAGES;
          mbar_wait(&sm.empty[st], ((t / C::STAGES) & 1) ^ 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(&sm.full[st], 2 * C::TILE_BYTES);
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
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row0 = C::SPLIT ? 0 : 64 * c;  // this consumer's first key of the item

    auto consume = [&](auto role_tag) {
      constexpr Role R = decltype(role_tag)::value;
      constexpr bool WITH_DV = R != DK_ONLY, WITH_DK = R != DV_ONLY;
      float sT[32], dpT[32], acc_k[D / 2], acc_v[D / 2];
      uint32_t pf[TILE / 16][4], dsf[TILE / 16][4];
      uint32_t kf[A_SMEM ? 1 : C::KSTEPS][4], vf[A_SMEM ? 1 : C::KSTEPS][4];

      int t = 0;
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / n_kt, b = bh / H, h = bh % H;
        const int key_a = (item % n_kt) * C::ITEM + row0 + 16 * warp + lane / 4;  // keys key_a, key_a + 8
        const int ib = it % C::ITEM_BUFS;
        float kb2[2] = {0.f, 0.f};
        if (BIAS == 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (key_a + 8 * r < Sk) kb2[r] = bias_at(bias + b * bias_sb + key_a + 8 * r) * LOG2E;
        }
        const float* brow = BIAS == 2 ? bias + b * bias_sb + h * bias_sh : nullptr;
        // one group, S^T = K Q^T, then (with dK) a second, dP^T = V dO^T
        auto issue_st = [&](int st) {
          if constexpr (A_SMEM) {
            const int rows = row0 * ROW_BYTES;  // this consumer's 64 keys of the item
            issue_over_d_ss<D, C::ITEM>(sT, kmajor_desc(sm.item(ib, 0) + rows), kmajor_desc(sm.tile(st, 0)));
            if constexpr (WITH_DK) {
              wgmma_commit();
              issue_over_d_ss<D, C::ITEM>(dpT, kmajor_desc(sm.item(ib, 1) + rows), kmajor_desc(sm.tile(st, 1)));
            }
          } else {
            issue_over_d<D>(sT, kf, kmajor_desc(sm.tile(st, 0)));
            if constexpr (WITH_DK) {
              wgmma_commit();
              issue_over_d<D>(dpT, vf, kmajor_desc(sm.tile(st, 1)));
            }
          }
        };
        auto issue_kv = [&](int st) {  // dV += P^T dO, dK += dS^T Q
          if constexpr (WITH_DV) issue_rs<D>(acc_v, pf, mnmajor_desc<D>(sm.tile(st, 1)));
          if constexpr (WITH_DK) issue_rs<D>(acc_k, dsf, mnmajor_desc<D>(sm.tile(st, 0)));
        };
        auto tile_p = [&](int j, int st) {
          const int m0 = j * TILE;
          if (m0 + TILE > Sq)
            dkv_tile_p<BIAS, true>(sT, sm.vec(st, 0), kb2, brow, key_a, Sq, Sk, m0, lane, qk_scale);
          else
            dkv_tile_p<BIAS, false>(sT, sm.vec(st, 0), kb2, brow, key_a, Sq, Sk, m0, lane, qk_scale);
        };
        auto retire_kv = [&]() {
          if constexpr (WITH_DV) {
            fence_regs(acc_v);
            fence_regs(pf);
          }
          if constexpr (WITH_DK) {
            fence_regs(acc_k);
            fence_regs(dsf);
          }
        };
        auto pack = [&]() {
          if constexpr (WITH_DV) pack_frag(pf, sT);
          if constexpr (WITH_DK) pack_frag(dsf, dpT);
        };
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

        // K and V into registers once an item; their buffer is free for the
        // next item's as soon as every warp of both warpgroups has them
        // (with A_SMEM, once the item's last product has retired)
        mbar_wait(&sm.item_full[ib], (it / C::ITEM_BUFS) & 1);
        if constexpr (!A_SMEM) {
          load_frags<D>(kf, sm.item(ib, 0), row0, warp, lane);
          load_frags<D>(vf, sm.item(ib, 1), row0, warp, lane);
          named_sync(3 + c, 128);
          if (tid == 0) mbar_arrive(&sm.item_empty[ib]);
        }

        // tile 0: S^T and dP^T alone
        mbar_wait(&sm.full[t % C::STAGES], (t / C::STAGES) & 1);
        wgmma_fence();
        issue_st(t % C::STAGES);
        wgmma_commit();
        wgmma_wait<WITH_DK ? 1 : 0>();  // S^T is in; dP^T runs on
        fence_regs(sT);
        tile_p(0, t % C::STAGES);
        if constexpr (WITH_DK) {
          wgmma_wait<0>();
          fence_regs(dpT);
          dkv_tile_ds(sT, dpT, sm.vec(t % C::STAGES, 1), lane);
        }
        pack();

        for (int j = 1; j < n_tiles; ++j) {
          const int cur = t + j, st = cur % C::STAGES, prev = (cur - 1) % C::STAGES;
          mbar_wait(&sm.full[st], (cur / C::STAGES) & 1);
          wgmma_fence();  // P^T, dS^T of tile j-1 are written before the products read them
          issue_st(st);
          wgmma_commit();
          issue_kv(prev);
          wgmma_commit();
          wgmma_wait<WITH_DK ? 2 : 1>();  // S^T of tile j is in; its dP^T and tile j-1's dV, dK products run on
          fence_regs(sT);
          tile_p(j, st);
          if constexpr (WITH_DK) {
            wgmma_wait<1>();  // dP^T of tile j is in; tile j-1's dV, dK products run on
            fence_regs(dpT);
            dkv_tile_ds(sT, dpT, sm.vec(st, 1), lane);
          }
          wgmma_wait<0>();  // tile j-1's products retired: its stage can be refilled
          retire_kv();
          if (tid == 0) mbar_arrive(&sm.empty[prev]);
          pack();
        }
        const int last = (t + n_tiles - 1) % C::STAGES;
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
        if constexpr (WITH_DK) store_rows<D>(dk, acc_k, key_a, Sk, H, b, h, scale, lane);
        if constexpr (WITH_DV) store_rows<D>(dv, acc_v, key_a, Sk, H, b, h, 1.f, lane);
      }
    };
    // split, the dK role (S^T, dP^T, dS^T and dK: 160 accumulator and
    // fragment registers at D = 160, 144 at 128, beside a full bias's loads)
    // takes 8 registers a thread of the dV role's (S^T, P^T and dV: 128 at
    // 160, 112 at 128)
    if constexpr (!C::SPLIT) {
      setmaxnreg_inc<232>();
      consume(std::integral_constant<Role, BOTH>());
    } else if (c == 0) {
      setmaxnreg_inc<224>();
      consume(std::integral_constant<Role, DV_ONLY>());
    } else {
      setmaxnreg_inc<240>();
      consume(std::integral_constant<Role, DK_ONLY>());
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
  using C = Cfg<D, false>;
  int sms = 0;
  const int rc = sm_count<flash_bwd_dq_sm90_kernel<D, BIAS>, C::SMEM>(&sms);
  if (rc != 0) return rc;
  const long long n_items = (long long)((a.Sq + C::ITEM - 1) / C::ITEM) * a.B * a.H;
  if (n_items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);  // one block per SM, persistent
  flash_bwd_dq_sm90_kernel<D, BIAS><<<grid, THREADS, C::SMEM, a.stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(a.bias), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0), a.H, a.Sq, a.Sk, m.bias_sb,
      m.bias_sh, static_cast<int>(n_items), a.scale * LOG2E, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BIAS>
int launch_dkv(const Maps& m, const Args& a) {
  using C = Cfg<D, true>;
  int sms = 0;
  const int rc = sm_count<flash_bwd_dkv_sm90_kernel<D, BIAS>, C::SMEM>(&sms);
  if (rc != 0) return rc;
  const long long n_items = (long long)((a.Sk + C::ITEM - 1) / C::ITEM) * a.B * a.H;
  if (n_items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);
  flash_bwd_dkv_sm90_kernel<D, BIAS><<<grid, THREADS, C::SMEM, a.stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(a.bias), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0), static_cast<__nv_bfloat16*>(a.out1),
      a.H, a.Sq, a.Sk, m.bias_sb, m.bias_sh, static_cast<int>(n_items), a.scale * LOG2E, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// encode the maps (dK/dV: q and dout in boxes of a tile's rows, k and v of
// an item's; dQ the other way round) and launch the instance of head dim D
// and the bias mode
template <int D, bool DKV>
int run(const void* q, const void* k, const void* v, const void* dout, const unsigned long long* maps, int bias_mode,
        const Args& a) {
  constexpr int ITEM = Cfg<D, DKV>::ITEM;
  Maps m;
  const int rc = DKV ? encode_maps<D>(&m, q, k, v, dout, maps, TILE, ITEM)
                     : encode_maps<D>(&m, q, k, v, dout, maps, ITEM, TILE);
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
    case 128: return run<128, DKV>(q, k, v, dout, maps, bias_mode, a);
    case 160: return run<160, DKV>(q, k, v, dout, maps, bias_mode, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, dout: bf16 [B, Sq, H, D] and k, v: bf16 [B, Sk, H, D] views, D = 40,
// 64, 80, 128 or 160; maps: four tensor-map specs of MAP_WORDS words (q, k, v, dout),
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
