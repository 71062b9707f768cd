// Flash-attention backward for Hopper (sm_90a) at head dim 64: dQ and dK/dV,
// each a persistent, warp-specialised kernel on TMA, an mbarrier ring and
// wgmma.
//
// Replaces the TPU kernels uwudiff_tpu/ops/flash_attention.py::_bwd_dq_kernel
// (:271, K4: flash_bwd_dq_sm90) and ::_bwd_dkv_kernel (:365, K6:
// flash_bwd_dkv_sm90). The dQ + dBias kernel (K5) and the head dims 40/80
// keep the mma.sync kernels of flash_bwd.cu; the wrappers dispatch on the
// head dim.
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
// Every product is wgmma.m64n64k16 with A from registers: the item's own
// operand (Q and dO, or K and V) is read from shared memory into wgmma
// fragments once an item (ldmatrix through the swizzle), P and dS (P^T and
// dS^T) are the fp32 accumulators re-packed to bf16; B is the streamed tile,
// K-major for S and dP (S^T and dP^T), MN-major (the transpose bit) for the
// products into dQ, dV and dK.
// P is the P the forward normalised (flash_fwd_sm90.cu): the logit scale and
// the bias's LOG2E are applied to the fp32 S tile, never folded into bf16 q;
// the bias is clamped at -1e30 as it is loaded; p = exp2(x - lse * LOG2E).
//
// What bounds it on an H100: per query-key pair the three (dQ) or four
// (dK/dV) products take 6 * 64 or 8 * 64 flop on the tensor cores and the
// recompute one exp2 on the SFU (16 a clock per SM). At the MMDiT's
// [8, 1357, 1357, 24, 64] that is 0.137 / 0.183 ms of bf16 tensor time at
// 989 TF/s and ~0.085 ms of exp2 at 1,980 MHz, far above the byte bound, so
// the design keeps the tensor cores fed and runs the recompute beside them:
//   - a persistent grid of one 384-thread block per SM; warpgroup 0 is the
//     producer (40 registers after setmaxnreg; its first warp loads),
//     warpgroups 1 and 2 consume 64 rows of the item each;
//   - the item's own block (Q and dO, or K and V: 2 x 16 KB) goes by TMA into
//     one of two buffers, freed as soon as both consumers hold it in
//     registers, so the next item's loads early; the streamed tiles (K and V,
//     or Q and dO: 2 x 8 KB) go through a ring of STAGES stages that runs on
//     across items, 128B-swizzled, each with a full mbarrier (TMA transaction
//     bytes plus the vectors' copies) and an empty one (one arrival per
//     consumer warpgroup, made after wgmma.wait_group has retired every
//     product that reads the stage). Tensor maps are rank 4 over (D, H, S, B)
//     with the views' own strides: strided head views go in uncopied, and TMA
//     zero-fills rows past Sq or Sk;
//   - A from registers halves the shared-memory reads of the S and dP
//     products: with both operands in shared memory an m64n64k16 reads 4 KB
//     per 64 x 64 x 16 step, about what the SM's 128 bytes a clock deliver
//     in the time the tensor cores take for it;
//   - the fp32 vectors beside a tile (the key bias for dQ; lse and delta for
//     dK/dV) have rows of Sk or Sq entries, not multiples of 16 bytes, so TMA
//     cannot take them: the producer warp's 32 lanes copy them with 4-byte
//     cp.async into the stage, and each lane's copies arrive on the stage's
//     full barrier when they land (cp.async.mbarrier.arrive.noinc). So the
//     MMDiT's key bias is read from shared memory, not per logit from global;
//     dQ's lse and delta (two rows a thread) and dK/dV's key bias (two keys a
//     thread) are per item and sit in registers; a full bias (CLIP's causal
//     one, T5's) is read in place through its batch and head strides (0
//     where it broadcasts) by plain loads;
//   - inside a consumer, tile j's S and dP (S^T and dP^T) are issued
//     together with tile j-1's dQ (dV, dK) products, and tile j's dS is
//     computed while those are in flight; in dQ, named barriers also order
//     the two consumers' issues (ping-pong), so one's exp2 runs while the
//     other's products are on the tensor cores (in dK/dV that measured
//     slower: four products a tile keep the tensor cores busier);
//   - ragged edges: keys >= Sk get p = 0 in dQ, query rows >= Sq get p = 0 in
//     dK/dV (their lse is never read as garbage: rows past Sq get lse = +inf
//     in dQ); no row past Sq or Sk is written.
// Tiles of 128 would need 128 accumulator registers a thread for S and dP
// alone, past the 168 the launch gives with dK and dV beside them. ptxas
// (CUDA 12.9): 168 registers, no spills, no serialised wgmma (chip_smoke.py
// prints the report); design variants and times are in PERF.md.

#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int D = 64;
constexpr int THREADS = 384;
constexpr int CONSUMER_THREADS = 256;
constexpr int ITEM_ROWS = 128;  // rows an item owns: query rows (dQ) or keys (dK/dV), 64 a consumer warpgroup
constexpr int TILE = 64;        // rows a streamed tile: keys (dQ) or query rows (dK/dV)
constexpr int STAGES = 5;
constexpr int ITEM_BYTES = ITEM_ROWS * D * 2;  // one of the item's two inputs
constexpr int TILE_BYTES = TILE * D * 2;       // one of a stage's two inputs
constexpr int VEC_BYTES = TILE * 4;            // one fp32 vector beside a tile
constexpr int VEC_ARRIVALS = 1 + 32;           // expect_tx by lane 0, then every lane's cp.async arrival
constexpr int BAR_BYTES = 8 * 2 * (2 + STAGES);
constexpr int SMEM = 1024 + 4 * ITEM_BYTES + STAGES * (2 * TILE_BYTES + 2 * VEC_BYTES) + BAR_BYTES;
constexpr uint32_t SBO = 8 * 128;  // bytes between 8-row groups of a 128B-swizzled tile

struct Smem {
  unsigned char* base;
  uint64_t *item_full, *item_empty, *full, *empty;
  __device__ explicit Smem(unsigned char* raw) : base(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023)) {
    item_full = reinterpret_cast<uint64_t*>(base + 4 * ITEM_BYTES + STAGES * (2 * TILE_BYTES + 2 * VEC_BYTES));
    item_empty = item_full + 2;
    full = item_empty + 2;
    empty = full + STAGES;
  }
  __device__ unsigned char* item(int buf, int input) const { return base + (2 * buf + input) * ITEM_BYTES; }
  __device__ unsigned char* tile(int stage, int input) const {
    return base + 4 * ITEM_BYTES + (2 * stage + input) * TILE_BYTES;
  }
  __device__ float* vec(int stage, int which) const {
    return reinterpret_cast<float*>(base + 4 * ITEM_BYTES + STAGES * 2 * TILE_BYTES + (2 * stage + which) * VEC_BYTES);
  }
  // barriers: the item buffers' full (TMA bytes) and empty (one arrival per
  // consumer warpgroup), the ring's full (vec_arrivals) and empty
  __device__ void init(int vec_arrivals) const {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&item_full[i], 1);
      mbar_init(&item_empty[i], 2);
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], vec_arrivals);
      mbar_init(&empty[i], 2);
    }
    mbar_fence_init();
  }
};

// a lane's share of one vector beside a tile: entries [r0, r0 + TILE) of
// src, zero past n
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int r0, int n, int lane) {
#pragma unroll
  for (int i = lane; i < TILE; i += 32) {
    const bool ok = r0 + i < n;
    cp_async4(dst + i, ok ? src + r0 + i : src, ok);
  }
}

// acc += A.B over the four k16 slices of a tile's 64 rows; A the bf16
// fragments, B [64 rows, 64] MN-major
__device__ __forceinline__ void issue_rs(float (&acc)[32], uint32_t (&a)[TILE / 16][4], uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) wgmma_m64n64k16_rs_tb(acc, a[kk], desc_b + ((kk * 16 * 128) >> 4));
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

// the wgmma A fragments (the mma.sync m16n8k16 A layout of rows 16 warp ..
// 16 warp + 15, four k16 slices of D) of a 64-row slice of a 128B-swizzled
// tile: ldmatrix.x4, each lane addressing one row's 16-byte chunk where
// the swizzle put it (chunk ^ row % 8)
__device__ __forceinline__ void load_frags(uint32_t (&f)[D / 16][4], const unsigned char* slice, int warp,
                                           int lane) {
  const int mi = lane / 8, r = lane % 8;  // lane mi*8 + r addresses row r of 8x8 matrix mi
  const int row = 16 * warp + (mi % 2) * 8 + r;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(f[kk], slice + row * 128 + (((2 * kk + mi / 2) ^ r) * 16));
}

// rows row_a, row_a + 8 of a [B, S, H, 64] output, times mul, as bf16; rows
// >= S are not written
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[32], int row_a, int S, int H,
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

// dS of one key tile, in place of s: keys n0 + [0, 64). BIAS: 0 none, 1 key
// bias (kb: this tile's 64 entries in shared memory), 2 full bias (brow:
// this item's rows of Sk keys). lse2 is +inf on rows >= Sq.
template <int BIAS, bool RAGGED>
__device__ __forceinline__ void dq_tile_ds(float (&s)[32], const float (&dp)[32], const float* kb,
                                           const float* __restrict__ brow, const float (&lse2)[2],
                                           const float (&dl)[2], int row_a, int Sq, int Sk, int n0, int lane,
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
        const float p = key_ok ? exp2_approx(x) : 0.f;
        s[idx] = p * (dp[idx] - dl[r]);
      }
    }
  }
}

// item = bh * ceil(Sq / 128) + m: the blocks in flight share K/V in L2.
// bias (BIAS 1: [B, Sk], row b at bias + b * bias_sb; BIAS 2: item (b, h)
// at bias + b * bias_sb + h * bias_sh, rows of Sk keys)
template <int BIAS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ bias, const float* __restrict__ lse,
                             const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H, int Sq,
                             int Sk, long long bias_sb, long long bias_sh, int n_items, float qk_scale,
                             float scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
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
          mbar_arrive_expect_tx(&sm.item_full[ib], 2 * ITEM_BYTES);
          tma_load_4d(sm.item(ib, 0), &tm_q, &sm.item_full[ib], 0, h, (item % n_m) * ITEM_ROWS, b);
          tma_load_4d(sm.item(ib, 1), &tm_do, &sm.item_full[ib], 0, h, (item % n_m) * ITEM_ROWS, b);
        }
        for (int j = 0; j < n_tiles; ++j, ++t) {
          const int st = t % STAGES;
          mbar_wait(&sm.empty[st], ((t / STAGES) & 1) ^ 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(&sm.full[st], 2 * TILE_BYTES);
            tma_load_4d(sm.tile(st, 0), &tm_k, &sm.full[st], 0, h, j * TILE, b);
            tma_load_4d(sm.tile(st, 1), &tm_v, &sm.full[st], 0, h, j * TILE, b);
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

    float s[32], dp[32], acc[32];
    uint32_t ds[TILE / 16][4], qf[D / 16][4], of[D / 16][4];

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
      auto issue_s_dp = [&](int st) {
        const uint64_t desc_k = desc_sw128(sm.tile(st, 0), 16, SBO), desc_v = desc_sw128(sm.tile(st, 1), 16, SBO);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_m64n64k16_rs(s, qf[kk], desc_k + 2 * kk, kk > 0);  // S = Q K^T
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_m64n64k16_rs(dp, of[kk], desc_v + 2 * kk, kk > 0);  // dP = dO V^T
      };
      auto issue_dq = [&](int st) { issue_rs(acc, ds, desc_sw128(sm.tile(st, 0), 16, SBO)); };  // dQ += dS K
      auto tile_ds = [&](int j, int st) {
        const int n0 = j * TILE;
        if (n0 + TILE > Sk)
          dq_tile_ds<BIAS, true>(s, dp, sm.vec(st, 0), brow, lse2, dl, row_a, Sq, Sk, n0, lane, qk_scale);
        else
          dq_tile_ds<BIAS, false>(s, dp, sm.vec(st, 0), brow, lse2, dl, row_a, Sq, Sk, n0, lane, qk_scale);
      };
      // the last issue of the block's last item frees no one: the named
      // barriers end balanced
      auto hand_over = [&](bool last_issue) {
        if (!(c == 1 && last_item && last_issue)) named_arrive(other_bar, CONSUMER_THREADS);
      };
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;

      // Q and dO into registers once an item; their buffer is free for the
      // next item's as soon as every warp of both warpgroups has them
      mbar_wait(&sm.item_full[ib], (it >> 1) & 1);
      load_frags(qf, sm.item(ib, 0) + c * 64 * D * 2, warp, lane);
      load_frags(of, sm.item(ib, 1) + c * 64 * D * 2, warp, lane);
      named_sync(3 + c, 128);
      if (tid == 0) mbar_arrive(&sm.item_empty[ib]);

      // tile 0: S and dP alone
      mbar_wait(&sm.full[t % STAGES], (t / STAGES) & 1);
      named_sync(my_bar, CONSUMER_THREADS);
      wgmma_fence();
      issue_s_dp(t % STAGES);
      wgmma_commit();
      hand_over(false);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      tile_ds(0, t % STAGES);
      pack_frag(ds, s);

      for (int j = 1; j < n_tiles; ++j) {
        const int cur = t + j, st = cur % STAGES, prev = (cur - 1) % STAGES;
        mbar_wait(&sm.full[st], (cur / STAGES) & 1);
        named_sync(my_bar, CONSUMER_THREADS);
        wgmma_fence();  // dS of tile j-1 is written before the product reads it
        issue_s_dp(st);
        wgmma_commit();
        issue_dq(prev);
        wgmma_commit();
        hand_over(false);
        wgmma_wait<1>();  // S, dP of tile j are in; dQ += dS K of tile j-1 runs on
        fence_regs(s);
        fence_regs(dp);
        tile_ds(j, st);
        wgmma_wait<0>();  // tile j-1's product retired: its stage can be refilled, ds rewritten
        fence_regs(acc);
        fence_regs(ds);
        if (tid == 0) mbar_arrive(&sm.empty[prev]);
        pack_frag(ds, s);
      }
      const int last = (t + n_tiles - 1) % STAGES;
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
      store_rows(dq, acc, row_a, Sq, H, b, h, scale, lane);
    }
  }
}

// ----------------------------------------------------------------- dK/dV

// P^T and dS^T of one query tile, in place of sT and dpT: query rows m0 +
// [0, 64) are the columns, this thread's keys key_a, key_a + 8 the rows. L,
// Dl: the tile's lse and delta in shared memory. BIAS 1: kb2 the keys' bias
// * LOG2E; BIAS 2: brow this item's rows of Sk keys.
template <int BIAS, bool RAGGED>
__device__ __forceinline__ void dkv_tile(float (&sT)[32], float (&dpT)[32], const float* L, const float* Dl,
                                         const float (&kb2)[2], const float* __restrict__ brow, int key_a, int Sq,
                                         int Sk, int m0, int lane, float qk_scale) {
#pragma unroll
  for (int i = 0; i < TILE / 8; ++i) {
    const int c0 = i * 8 + (lane % 4) * 2;
    const float2 l2 = *reinterpret_cast<const float2*>(L + c0);
    const float2 d2 = *reinterpret_cast<const float2*>(Dl + c0);
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = m0 + c0 + e2;  // query row
      const bool row_ok = !RAGGED || row < Sq;
      const float lse2 = (e2 ? l2.y : l2.x) * LOG2E, dl = e2 ? d2.y : d2.x;
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
        const float p = row_ok ? exp2_approx(x) : 0.f;  // zero-filled rows' lse (0) is never used
        sT[idx] = p;
        dpT[idx] = p * (dpT[idx] - dl);
      }
    }
  }
}

// item = bh * ceil(Sk / 128) + kt; bias as in the dQ kernel
template <int BIAS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ bias, const float* __restrict__ lse,
                              const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int H, int Sq, int Sk, long long bias_sb,
                              long long bias_sh, int n_items, float qk_scale, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
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
          mbar_arrive_expect_tx(&sm.item_full[ib], 2 * ITEM_BYTES);
          tma_load_4d(sm.item(ib, 0), &tm_k, &sm.item_full[ib], 0, h, (item % n_kt) * ITEM_ROWS, b);
          tma_load_4d(sm.item(ib, 1), &tm_v, &sm.item_full[ib], 0, h, (item % n_kt) * ITEM_ROWS, b);
        }
        for (int j = 0; j < n_tiles; ++j, ++t) {
          const int st = t % STAGES;
          mbar_wait(&sm.empty[st], ((t / STAGES) & 1) ^ 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(&sm.full[st], 2 * TILE_BYTES);
            tma_load_4d(sm.tile(st, 0), &tm_q, &sm.full[st], 0, h, j * TILE, b);
            tma_load_4d(sm.tile(st, 1), &tm_do, &sm.full[st], 0, h, j * TILE, b);
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

    float sT[32], dpT[32], acc_k[32], acc_v[32];
    uint32_t pf[TILE / 16][4], dsf[TILE / 16][4], kf[D / 16][4], vf[D / 16][4];

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
      auto issue_st = [&](int st) {  // S^T = K Q^T, dP^T = V dO^T
        const uint64_t desc_q = desc_sw128(sm.tile(st, 0), 16, SBO), desc_do = desc_sw128(sm.tile(st, 1), 16, SBO);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_m64n64k16_rs(sT, kf[kk], desc_q + 2 * kk, kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_m64n64k16_rs(dpT, vf[kk], desc_do + 2 * kk, kk > 0);
      };
      auto issue_kv = [&](int st) {  // dV += P^T dO, dK += dS^T Q
        issue_rs(acc_v, pf, desc_sw128(sm.tile(st, 1), 16, SBO));
        issue_rs(acc_k, dsf, desc_sw128(sm.tile(st, 0), 16, SBO));
      };
      auto tile_math = [&](int j, int st) {
        const int m0 = j * TILE;
        if (m0 + TILE > Sq)
          dkv_tile<BIAS, true>(sT, dpT, sm.vec(st, 0), sm.vec(st, 1), kb2, brow, key_a, Sq, Sk, m0, lane, qk_scale);
        else
          dkv_tile<BIAS, false>(sT, dpT, sm.vec(st, 0), sm.vec(st, 1), kb2, brow, key_a, Sq, Sk, m0, lane,
                                qk_scale);
      };
      auto retire_kv = [&]() {
        fence_regs(acc_v);
        fence_regs(acc_k);
        fence_regs(pf);
        fence_regs(dsf);
      };
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;

      // K and V into registers once an item; their buffer is free for the
      // next item's as soon as every warp of both warpgroups has them
      mbar_wait(&sm.item_full[ib], (it >> 1) & 1);
      load_frags(kf, sm.item(ib, 0) + c * 64 * D * 2, warp, lane);
      load_frags(vf, sm.item(ib, 1) + c * 64 * D * 2, warp, lane);
      named_sync(3 + c, 128);
      if (tid == 0) mbar_arrive(&sm.item_empty[ib]);

      // tile 0: S^T and dP^T alone
      mbar_wait(&sm.full[t % STAGES], (t / STAGES) & 1);
      wgmma_fence();
      issue_st(t % STAGES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sT);
      fence_regs(dpT);
      tile_math(0, t % STAGES);
      pack_frag(pf, sT);
      pack_frag(dsf, dpT);

      for (int j = 1; j < n_tiles; ++j) {
        const int cur = t + j, st = cur % STAGES, prev = (cur - 1) % STAGES;
        mbar_wait(&sm.full[st], (cur / STAGES) & 1);
        wgmma_fence();  // P^T, dS^T of tile j-1 are written before the products read them
        issue_st(st);
        wgmma_commit();
        issue_kv(prev);
        wgmma_commit();
        wgmma_wait<1>();  // S^T, dP^T of tile j are in; tile j-1's dV, dK products run on
        fence_regs(sT);
        fence_regs(dpT);
        tile_math(j, st);
        wgmma_wait<0>();  // tile j-1's products retired: its stage can be refilled
        retire_kv();
        if (tid == 0) mbar_arrive(&sm.empty[prev]);
        pack_frag(pf, sT);
        pack_frag(dsf, dpT);
      }
      const int last = (t + n_tiles - 1) % STAGES;
      wgmma_fence();
      issue_kv(last);
      wgmma_commit();
      wgmma_wait<0>();
      retire_kv();
      if (tid == 0) mbar_arrive(&sm.empty[last]);
      t += n_tiles;
      store_rows(dk, acc_k, key_a, Sk, H, b, h, scale, lane);
      store_rows(dv, acc_v, key_a, Sk, H, b, h, 1.f, lane);
    }
  }
}

// ----------------------------------------------------------------- host

// the SM count of the current device, after allowing `kern` its dynamic
// shared memory; both once per device and kernel, since the wrapper's host
// time is most of a call at the small shapes (CLIP's 77 tokens)
template <auto kern>
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
// strides; the box rows must be the kernel's tiles (q_rows for q and dout,
// k_rows for k and v)
int encode_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout,
                const unsigned long long* maps, unsigned long long q_rows, unsigned long long k_rows) {
  if (box_rows(maps) != q_rows || box_rows(maps + MAP_WORDS) != k_rows ||
      box_rows(maps + 2 * MAP_WORDS) != k_rows || box_rows(maps + 3 * MAP_WORDS) != q_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = encode(&m->q, q, maps);
  if (rc == 0) rc = encode(&m->k, k, maps + MAP_WORDS);
  if (rc == 0) rc = encode(&m->v, v, maps + 2 * MAP_WORDS);
  if (rc == 0) rc = encode(&m->dout, dout, maps + 3 * MAP_WORDS);
  m->bias_sb = static_cast<long long>(maps[4 * MAP_WORDS]);
  m->bias_sh = static_cast<long long>(maps[4 * MAP_WORDS + 1]);
  return rc;
}

template <int BIAS>
int launch_dq(const Maps& m, const void* bias, const void* lse, const void* delta, void* dq, int B, int H, int Sq,
              int Sk, float scale, cudaStream_t stream) {
  int sms = 0;
  const int rc = sm_count<flash_bwd_dq_sm90_kernel<BIAS>>(&sms);
  if (rc != 0) return rc;
  const long long n_items = (long long)((Sq + ITEM_ROWS - 1) / ITEM_ROWS) * B * H;
  if (n_items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);  // one block per SM, persistent
  flash_bwd_dq_sm90_kernel<BIAS><<<grid, THREADS, SMEM, stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(bias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), H, Sq, Sk, m.bias_sb, m.bias_sh,
      static_cast<int>(n_items), scale * LOG2E, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int BIAS>
int launch_dkv(const Maps& m, const void* bias, const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int Sq, int Sk, float scale, cudaStream_t stream) {
  int sms = 0;
  const int rc = sm_count<flash_bwd_dkv_sm90_kernel<BIAS>>(&sms);
  if (rc != 0) return rc;
  const long long n_items = (long long)((Sk + ITEM_ROWS - 1) / ITEM_ROWS) * B * H;
  if (n_items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);
  flash_bwd_dkv_sm90_kernel<BIAS><<<grid, THREADS, SMEM, stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(bias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Sq,
      Sk, m.bias_sb, m.bias_sh, static_cast<int>(n_items), scale * LOG2E, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout: bf16 [B, Sq, H, 64] and k, v: bf16 [B, Sk, H, 64] views; maps:
// four tensor-map specs of MAP_WORDS words (q, k, v, dout), then the bias's
// batch and head strides in elements (bias_mode 1: [B, Sk] key bias; 2:
// full, rows of Sk keys). lse, delta: contiguous fp32 [B, H, Sq]. Outputs
// contiguous bf16 [B, S, H, 64]. Each returns 0, a cudaError_t code, or
// ENCODE_FAILED + the CUresult of a tensor map the driver refused.
extern "C" int uwu_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* bias,
                                     const void* dout, const void* lse, const void* delta, void* dq, int B, int H,
                                     int Sq, int Sk, int head_dim, int bias_mode, const unsigned long long* maps,
                                     float scale, void* stream) {
  if (head_dim != D) return static_cast<int>(cudaErrorInvalidValue);
  Maps m;
  const int rc = encode_maps(&m, q, k, v, dout, maps, ITEM_ROWS, TILE);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bias_mode) {
    case 0: return launch_dq<0>(m, bias, lse, delta, dq, B, H, Sq, Sk, scale, s);
    case 1: return launch_dq<1>(m, bias, lse, delta, dq, B, H, Sq, Sk, scale, s);
    case 2: return launch_dq<2>(m, bias, lse, delta, dq, B, H, Sq, Sk, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int uwu_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* bias,
                                      const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                                      int B, int H, int Sq, int Sk, int head_dim, int bias_mode,
                                      const unsigned long long* maps, float scale, void* stream) {
  if (head_dim != D) return static_cast<int>(cudaErrorInvalidValue);
  Maps m;
  const int rc = encode_maps(&m, q, k, v, dout, maps, TILE, ITEM_ROWS);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bias_mode) {
    case 0: return launch_dkv<0>(m, bias, lse, delta, dk, dv, B, H, Sq, Sk, scale, s);
    case 1: return launch_dkv<1>(m, bias, lse, delta, dk, dv, B, H, Sq, Sk, scale, s);
    case 2: return launch_dkv<2>(m, bias, lse, delta, dk, dv, B, H, Sq, Sk, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
