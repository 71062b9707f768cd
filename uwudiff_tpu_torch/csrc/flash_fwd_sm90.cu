// Flash-attention forward for Hopper (sm_90a) at head dim 64: TMA loads into
// an mbarrier ring, one producer warp, two consumer warpgroups on wgmma.
//
// Replaces the TPU kernel uwudiff_tpu/ops/flash_attention.py::_fwd_kernel
// (:152; online softmax in the exp2 domain, out + natural-log lse, bias
// none / key / full). The head dims 40/80/160 keep the mma.sync kernel of
// flash_fwd.cu; the wrapper dispatches on the head dim.
//
// What bounds it on an H100 at D = 64: per query-key pair the two products
// take 4 * 64 = 256 flop on the tensor cores and the softmax one exp2 on the
// SFU (16 a clock per SM). At [8, 4096, 4096, 10, 64] that is 0.347 ms of
// bf16 tensor-core time at 989 TF/s and ~0.32-0.34 ms of exp2 at the SM
// clock, so the kernel comes near its bound only if the softmax of one tile
// runs while the tensor cores work on another. The design:
//   - a persistent grid of one block per SM walks over work items of 128
//     query rows of one (batch, head); warpgroup 0 is the producer (24
//     registers after setmaxnreg; one thread issues every TMA load),
//     warpgroups 1 and 2 are consumers of 64 rows each (240 registers),
//     __launch_bounds__(384, 1);
//   - Q goes by TMA into one of two buffers, so the next item's Q loads
//     while this one is consumed; K and V tiles of 128 keys go through a
//     ring of 3 stages (32 KB each) that runs on across items, 128B-swizzled,
//     each stage with a full mbarrier (TMA transaction bytes) and an empty
//     one (one arrival per consumer warpgroup, made after wgmma.wait_group
//     has retired every product that reads the stage). The tensor maps are
//     rank 4 over (D, H, S, B) with the views' own strides, so strided head
//     views go in uncopied, and TMA zero-fills keys >= Sk and rows >= Sq;
//   - S = Q.K^T is wgmma.m64n128k16 with both operands in shared memory
//     (K-major); O += P.V is wgmma.m64n64k16 with P in registers (the fp32 S
//     fragment re-packed to bf16, as flash::pack_a does) and V MN-major in
//     shared memory (the transpose bit). S, O, m and l stay in registers;
//   - inside a warpgroup, tile j's Q.K^T is issued together with tile
//     j-1's P.V, and the softmax of tile j runs while that P.V is in flight;
//     between the two warpgroups, named barriers order the issue (ping-pong),
//     so one warpgroup's exp2 and rescale run while the other's products are
//     on the tensor cores;
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
// ptxas (CUDA 12.9): 168 registers at launch, no spills, no serialised
// wgmma. ptxas fits the consumers' code in the launch's 168 registers: a
// version that issued the next item's first Q.K^T with this item's last
// P.V, or ran the two loops as one, needed more and got its wgmmas
// serialised (warnings C7511/C7517), 20-45 % slower. On one H100 80GB HBM3
// at 700 W: 0.74-0.76 ms at [8, 4096, 4096, 10, 64] (cuDNN's sm90 flash
// kernel behind SDPA: 0.76-0.79), 0.107-0.115 ms at [8, 1024, 1024, 20, 64]
// (0.105-0.110); PERF.md has the rest.

#include <math.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int D = 64;
constexpr int BLOCK_M = 128;  // query rows a work item (64 a consumer warpgroup)
constexpr int BLOCK_N = 128;  // keys a K/V tile
constexpr int STAGES = 3;     // K/V ring
constexpr int Q_STAGES = 2;   // Q is double-buffered across work items
constexpr int THREADS = 384;
constexpr int CONSUMER_THREADS = 256;
constexpr int TILE_BYTES = BLOCK_N * D * 2;  // one K or V tile
constexpr int Q_BYTES = BLOCK_M * D * 2;
constexpr int BAR_BYTES = 8 * 2 * (Q_STAGES + STAGES);
constexpr int SMEM = 1024 + Q_STAGES * Q_BYTES + 2 * STAGES * TILE_BYTES + BAR_BYTES;  // + 1024-byte alignment
constexpr uint32_t SBO = 8 * 128;  // bytes between 8-row groups of a 128B-swizzled tile
constexpr int EMU_EVERY = 8;       // one n8-tile in 8 takes its exp2 on the FMA pipe (exp2_fma)

// One S tile before the softmax, in place. FOLD (no bias, scale > 0): s
// stays raw and the softmax folds the scale into its exp2's FMA; otherwise
// s becomes x = s * qk_scale (+ bias * LOG2E). Keys >= Sk get -inf
// (RAGGED: the tile reaches past Sk). brow is this item's bias: keys for
// BIAS 1, rows of Sk keys for BIAS 2.
template <int BIAS, bool FOLD, bool RAGGED>
__device__ __forceinline__ void logits(float (&s)[64], const float* __restrict__ brow, int Sq, int Sk, int n0,
                                       int row_a, int lane, float qk_scale) {
#pragma unroll
  for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
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

// exp2 on the FMA pipe, for a share of the probabilities: the SFU's 16
// exp2 a clock per SM match the tensor cores' rate at D = 64, so moving
// every EMU_EVERY-th n8-tile off it shortens the softmax. x is clamped at
// -126 (exp2(-inf) gives a denormal, below any bf16 P); 2^frac(x) is a
// cubic on [-0.5, 0.5] within 7.8e-5 relative, below a bf16 step of P
// (2^-8) and within the lse's 1e-3; the integer part goes straight into
// the exponent (t's low mantissa bits hold round(x)).
__device__ __forceinline__ float exp2_fma(float x) {
  x = fmaxf(x, -126.f);
  const float t = x + 12582912.f;  // 1.5 * 2^23: rounds x to an integer in the low mantissa bits
  const float f = x - (t - 12582912.f);
  const float p = fmaf(fmaf(fmaf(0.05508868396282196f, f, 0.24260404706001282f), f, 0.6932762265205383f), f,
                       0.9999289512634277f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

// online softmax of one tile: s becomes p = exp2(s * mul - m_new), mul > 0
// (qk_scale with FOLD, else 1); alpha = exp2(m_old - m_new) is for the O
// rescale, which waits for the P.V in flight
__device__ __forceinline__ void softmax(float (&s)[64], float (&m_r)[2], float (&l_r)[2], float (&alpha)[2],
                                        float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mq[4];  // four independent chains, then a tree
#pragma unroll
    for (int i = 0; i < 4; ++i) mq[i] = fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]);
#pragma unroll
    for (int nt = 4; nt < BLOCK_N / 8; ++nt)
      mq[nt % 4] = fmaxf(mq[nt % 4], fmaxf(s[4 * nt + 2 * r], s[4 * nt + 2 * r + 1]));
    float mx = fmaxf(fmaxf(mq[0], mq[1]), fmaxf(mq[2], mq[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // key 0 lies in tile 0 and its logit is finite, so m_new is finite
    const float m_new = fmaxf(m_r[r], mx * mul);
    alpha[r] = exp2_approx(m_r[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
      const bool fma_pipe = nt % EMU_EVERY == EMU_EVERY - 1;
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
__device__ __forceinline__ void pack_p(uint32_t (&p)[BLOCK_N / 16][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// A persistent grid: block i takes work items i, i + gridDim.x, ...; an item
// is 128 query rows of one (batch, head), item = bh * ceil(Sq / 128) + m, so
// the blocks in flight share K/V in L2. The K/V ring runs on across items,
// and Q is double-buffered, so the producer loads the next item while the
// consumers finish this one.
// BIAS: 0 none, 1 key bias [B, Sk] fp32, 2 full bias fp32 with rows of Sk
// keys, item (b, h) at bias + b * bias_sb + h * bias_sh (elements; a stride
// of 0 where the bias broadcasts, as CLIP's [B, 1, Sq, Sk] does over heads).
template <int BIAS, bool FOLD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Sk,
                          long long bias_sb, long long bias_sh, int n_items, float qk_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = base;
  unsigned char* sK = sQ + Q_STAGES * Q_BYTES;
  unsigned char* sV = sK + STAGES * TILE_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * TILE_BYTES);
  uint64_t* q_empty = q_full + Q_STAGES;
  uint64_t* full = q_empty + Q_STAGES;
  uint64_t* empty = full + STAGES;

  const int n_m = (Sq + BLOCK_M - 1) / BLOCK_M;
  const int n_tiles = (Sk + BLOCK_N - 1) / BLOCK_N;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < Q_STAGES; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 2);  // one arrival per consumer warpgroup
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
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
        const int qs = it % Q_STAGES;
        mbar_wait(&q_empty[qs], ((it / Q_STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(&q_full[qs], Q_BYTES);
        tma_load_4d(sQ + qs * Q_BYTES, &tm_q, &q_full[qs], 0, h, (item % n_m) * BLOCK_M, b);
        for (int j = 0; j < n_tiles; ++j, ++kv) {
          const int st = kv % STAGES;
          mbar_wait(&empty[st], ((kv / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], 2 * TILE_BYTES);
          tma_load_4d(sK + st * TILE_BYTES, &tm_k, &full[st], 0, h, j * BLOCK_N, b);
          tma_load_4d(sV + st * TILE_BYTES, &tm_v, &full[st], 0, h, j * BLOCK_N, b);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int my_bar = 1 + c, other_bar = 2 - c;  // ping-pong: issue on mine, then free the other's
    const float mul = FOLD ? qk_scale : 1.f;

    float s[64];
    float o[32];
    uint32_t p[BLOCK_N / 16][4];
    float m_r[2], l_r[2], alpha[2];

    auto issue_qk = [&](uint64_t desc_q, int stage) {  // s = Q K^T over the four k16 slices of D
      const uint64_t desc_k = desc_sw128(sK + stage * TILE_BYTES, 16, SBO);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_m64n128k16_ss(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
    };
    auto issue_pv = [&](int stage) {  // o += P V over the eight k16 slices of the keys
      const uint64_t desc_v = desc_sw128(sV + stage * TILE_BYTES, 16, SBO);
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) wgmma_m64n64k16_rs_tb(o, p[kk], desc_v + ((kk * 16 * 128) >> 4));
    };

    if (c == 1) named_arrive(1, CONSUMER_THREADS);  // consumer 0 issues first
    int kv = 0;  // K/V tiles consumed so far, across items
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / n_m, b = bh / H, h = bh % H;
      const int row_a = (item % n_m) * BLOCK_M + 64 * c + 16 * warp + lane / 4;  // rows row_a, row_a + 8
      const bool last_item = item + gridDim.x >= n_items;
      const int qs = it % Q_STAGES;
      const uint64_t desc_q = desc_sw128(sQ + qs * Q_BYTES + c * 64 * D * 2, 16, SBO);
      const float* brow = BIAS ? bias + b * bias_sb + h * bias_sh : nullptr;
      auto tile_logits = [&](int j) {
        const int n0 = j * BLOCK_N;
        if (n0 + BLOCK_N > Sk)
          logits<BIAS, FOLD, true>(s, brow, Sq, Sk, n0, row_a, lane, qk_scale);
        else
          logits<BIAS, FOLD, false>(s, brow, Sq, Sk, n0, row_a, lane, qk_scale);
      };
      // the last issue of the block's last item frees no one: the named
      // barriers end balanced
      auto hand_over = [&](int j) {
        if (!(c == 1 && last_item && j == n_tiles - 1)) named_arrive(other_bar, CONSUMER_THREADS);
      };
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      m_r[0] = m_r[1] = -INFINITY;
      l_r[0] = l_r[1] = 0.f;  // per-thread partial row sums, quad-reduced at the end

      mbar_wait(&q_full[qs], (it / Q_STAGES) & 1);
      // tile 0: S alone
      mbar_wait(&full[kv % STAGES], (kv / STAGES) & 1);
      named_sync(my_bar, CONSUMER_THREADS);
      wgmma_fence();
      issue_qk(desc_q, kv % STAGES);
      wgmma_commit();
      hand_over(0);
      wgmma_wait<0>();
      fence_regs(s);
      if (n_tiles == 1 && tid == 0) mbar_arrive(&q_empty[qs]);  // Q read for the last time
      tile_logits(0);
      softmax(s, m_r, l_r, alpha, mul);  // alpha = 0; o is still 0
      pack_p(p, s);

      for (int j = 1; j < n_tiles; ++j) {
        const int cur = kv + j, prev = (cur - 1) % STAGES;
        mbar_wait(&full[cur % STAGES], (cur / STAGES) & 1);
        named_sync(my_bar, CONSUMER_THREADS);
        wgmma_fence();  // the rescaled o and the new p are written before the products read them
        issue_qk(desc_q, cur % STAGES);
        wgmma_commit();
        issue_pv(prev);
        wgmma_commit();
        hand_over(j);
        wgmma_wait<1>();  // S of tile j is in; P.V of tile j-1 runs on
        fence_regs(s);
        if (j == n_tiles - 1 && tid == 0) mbar_arrive(&q_empty[qs]);
        tile_logits(j);
        softmax(s, m_r, l_r, alpha, mul);
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
        pack_p(p, s);
      }
      const int last = (kv + n_tiles - 1) % STAGES;
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

template <int BIAS, bool FOLD>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, const void* bias, void* out,
           void* lse, int B, int H, int Sq, int Sk, long long bias_sb, long long bias_sh, float qk_scale,
           cudaStream_t stream) {
  auto kern = flash_fwd_sm90_kernel<BIAS, FOLD>;
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
  const long long n_items = (long long)((Sq + BLOCK_M - 1) / BLOCK_M) * B * H;
  if (n_items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_items < sms[dev] ? n_items : sms[dev]);  // one block per SM, persistent
  kern<<<grid, THREADS, SMEM, stream>>>(mq, mk, mv, static_cast<const float*>(bias),
                                        static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, Sq, Sk,
                                        bias_sb, bias_sh, static_cast<int>(n_items), qk_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v: bf16 [B, S, H, 64] views; maps: three tensor-map specs of
// MAP_WORDS words each (q, k, v), then the bias's batch and head strides in
// elements. out: contiguous bf16 [B, Sq, H, 64]; lse:
// contiguous fp32 [B, H, Sq]. Returns 0, a cudaError_t code, or
// ENCODE_FAILED + the CUresult of a tensor map the driver refused.
extern "C" int uwu_flash_fwd_sm90(const void* q, const void* k, const void* v, const void* bias, void* out,
                                  void* lse, int B, int H, int Sq, int Sk, int head_dim, int bias_mode,
                                  const unsigned long long* maps, float scale, void* stream) {
  if (head_dim != D) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int rc = hopper::encode(&mq, q, maps);
  if (rc == 0) rc = hopper::encode(&mk, k, maps + hopper::MAP_WORDS);
  if (rc == 0) rc = hopper::encode(&mv, v, maps + 2 * hopper::MAP_WORDS);
  if (rc != 0) return rc;
  const float qk_scale = scale * flash::LOG2E;
  const long long sb = static_cast<long long>(maps[3 * hopper::MAP_WORDS]);
  const long long sh = static_cast<long long>(maps[3 * hopper::MAP_WORDS + 1]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bias_mode) {
    case 0:
      return qk_scale > 0.f ? launch<0, true>(mq, mk, mv, bias, out, lse, B, H, Sq, Sk, sb, sh, qk_scale, s)
                            : launch<0, false>(mq, mk, mv, bias, out, lse, B, H, Sq, Sk, sb, sh, qk_scale, s);
    case 1: return launch<1, false>(mq, mk, mv, bias, out, lse, B, H, Sq, Sk, sb, sh, qk_scale, s);
    case 2: return launch<2, false>(mq, mk, mv, bias, out, lse, B, H, Sq, Sk, sb, sh, qk_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
