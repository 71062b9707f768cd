// Flash-attention backward on mma.sync (sm_90a): dQ + dBias (K5) at head
// dims 40/64/80/128/160, dQ and dK/dV at 160 only (at 40/64/80/128 they are
// flash_bwd_sm90.cu's Hopper kernels); bf16 q/k/v/dO, fp32 softmax
// recompute and accumulators.
//
// Replaces the TPU kernels uwudiff_tpu/ops/flash_attention.py::_bwd_dq_kernel
// (K4), ::_bwd_dq_dbias_kernel (K5) and ::_bwd_dkv_kernel (K6), the FA2
// backward split in two so that no output is summed across blocks: no
// atomics, and dQ/dBias/dK/dV are bitwise the same from run to run.
//   flash_bwd_dq  : one block owns a 64-row query tile and loops over K/V
//                   tiles: S = Q K^T, P = exp2(S*scale*LOG2E + bias*LOG2E
//                   - lse*LOG2E), dP = dO V^T, dS = P (dP - delta),
//                   dQ += dS K; dQ *= scale at the end.
//   flash_bwd_dq_dbias : the same kernel compiled with DBIAS (K5, for a
//                   learned full bias such as T5's relative position bias):
//                   each block also stores its fp32 dS fragment of every K/V
//                   tile to dbias [B*H, Sq, Sk]. Each (query tile, key tile)
//                   pair is visited by one block once, so the stores need no
//                   atomics. The logits are S*scale + bias in natural-log
//                   units (the scale and LOG2E are applied to the fp32 S tile
//                   here, never folded into the bias), so dBias is dS itself,
//                   with none of the TPU kernel's LN2 bookkeeping. q, k, dO
//                   and V are bf16 and mma.sync sums their exact products in
//                   fp32, so dS needs no extra-precision pass (the TPU kernel
//                   needed Precision.HIGHEST for its fp32-scaled q). It is
//                   bound by bytes: the fp32 bias read and dBias write are
//                   [B*H, Sq, Sk] each, 4x the bf16 q/k/v/dO traffic at T5's
//                   256 x 256, D = 64. Stores are direct: 8 bytes a lane (two
//                   neighbouring keys) where Sk is even, 4 otherwise; rows >=
//                   Sq and keys >= Sk are never written.
//   flash_bwd_dkv : one block owns a 64-key K/V tile and loops over query
//                   tiles, computing the transposed tiles S^T = K Q^T and
//                   dP^T = V dO^T so that each warp's 16 keys are the rows of
//                   its fragments: dV += P^T dO, dK += dS^T Q; dK *= scale.
// delta = rowsum(dO * O) arrives precomputed (PyTorch, [B, H, Sq] fp32).
//
// P must be exactly the P that the forward kernel (flash_fwd.cu) normalised:
// the logit scale and the bias's LOG2E are applied to the fp32 S tile the
// same way (never folded into bf16 q, which would round q), the bias is
// clamped at -1e30 as it is loaded, and p = exp2(x - lse*LOG2E) with the
// forward's ex2.approx, so P's rows sum to 1 to fp32 rounding.
//
// What bounds it on an H100: at the training path's shapes (Sq = 256 or 1024
// image tokens, D = 64) the four (dK/dV) or three (dQ) products are far above
// the ridge, so it is bound by tensor-core issue plus the exp2 recompute. The
// TPU's sequential grid axis becomes the in-block loop; the running dQ (or
// dK, dV) accumulators stay in fp32 registers; the streamed tiles are staged
// in shared memory by cp.async, two stages deep; P and dS never leave
// registers (re-packed in place as the A operand of the next mma.sync).
// Ragged edges are zero-filled in shared memory and masked in registers:
// keys >= Sk get p = 0, query rows >= Sq get p = 0 in the dK/dV kernel, and
// no row past Sq or Sk is written. Head dims 40 and 80 (K5's) are
// zero-padded to 48 and 80 in shared memory only.
//
// D = 160 (SD1.5's third level, 1280 channels over 8 heads) does not fit the
// registers of that design: a warp's dK and dV for its 16 keys would take
// 160 fp32 registers a thread, and the K/V (dK/dV) or Q/dO (dQ) fragments
// held beside them 80 more. Nor does K5 at Flux's D = 128: Q and dO's
// fragments, 64 registers, beside a 64-register dQ and 64-key S and dP
// (64). So at D = 128 (K5 only) and 160
//   - no operand fragment is held: each product reads its A fragments from
//     the shared tile one k-step at a time (mma_abt_smem), which costs an
//     ldmatrix per k-step and saves 64 or 80 registers;
//   - dQ takes a 32-key tile (BN), so S and dP take 32 registers, not 64,
//     beside its 64- or 80-register accumulator; shared memory 68 or 86 KB,
//     two blocks an SM;
//   - dK/dV runs 8 warps, two per 16 keys: both warps of a pair compute the
//     same S^T and dP^T over the full depth (the repeated products are half
//     again the work of the dK/dV sums), and each accumulates one half of
//     dK's and dV's 160 columns (80 registers).
// flash_bwd_sm90.cu redesigns dQ and dK/dV at D = 40/64/80/128/160 on TMA and
// wgmma.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int BLOCK = 64;  // rows a block owns: query rows (dQ) or keys (dK/dV), 16 per warp

struct Strides {  // elements, (batch, sequence, head) of q, k, v, dO; unit stride over D
  long long q[3], k[3], v[3], o[3];
};

template <int D>
struct Cfg {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to the mma depth
  static constexpr int STRIDE = DP + 8;          // smem row pitch; the skew spreads ldmatrix rows over banks
  static constexpr int CHUNKS = DP / 8;
  static constexpr int D_CHUNKS = D / 8;
  static constexpr bool HOLD = DP <= 96;         // A fragments held in registers across the loop (D <= 80)
  static constexpr int SPLIT = HOLD ? 1 : 2;     // dK/dV: warps sharing 16 keys, each a slice of the columns
  static constexpr int DKV_THREADS = NUM_THREADS * SPLIT;
  static constexpr int DH = DP / SPLIT;          // dK/dV columns one warp accumulates
  static constexpr int BN = HOLD ? 64 : 32;      // key tile of the dQ kernel (registers)
  static constexpr int BM = DP > 64 ? 32 : 64;   // query tile of the dK/dV kernel (registers)
  static constexpr int SMEM_DQ = (2 * BLOCK + 4 * BN) * STRIDE * 2;  // Q, dO + two stages of K and V
  static constexpr int SMEM_DKV = (2 * BLOCK + 4 * BM) * STRIDE * 2 + 4 * BM * 4;  // + lse, delta stages
};

// acc[NT][4] += A (16 x DP) . T^T as flash::mma_abt, with A read from the
// row-major shared tile a_tile one k-step at a time instead of held in
// registers: the same products in the same order
template <int DP, int NT, int STRIDE>
__device__ __forceinline__ void mma_abt_smem(float acc[][4], const __nv_bfloat16* a_tile, const __nv_bfloat16* t,
                                             int lane) {
  const int l8 = lane % 8, mi = lane / 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    load_a<STRIDE>(a, a_tile, kk, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, t + (np * 16 + l8 + (mi / 2) * 8) * STRIDE + kk * 16 + (mi % 2) * 8);
      mma_16816(acc[2 * np], a, bf[0], bf[1]);
      mma_16816(acc[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float a[][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

// rows of a [B, S, H, D] output tile, scaled, as bf16: NC columns from col0;
// rows >= S and columns >= D not written
template <int D, int NC>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, float acc[][4], int row_a, int S, int H,
                                           int b, int h, float mul, int lane, int col0 = 0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= S) continue;
    __nv_bfloat16* drow = dst + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < NC / 8; ++dt) {
      const int col = col0 + dt * 8 + (lane % 4) * 2;
      if (col < D)
        *reinterpret_cast<uint32_t*>(drow + col) = pack_bf16(acc[dt][2 * r] * mul, acc[dt][2 * r + 1] * mul);
    }
  }
}

// BIAS: 0 none, 1 key bias [B, Sk] fp32, 2 full bias [B*H, Sq, Sk] fp32;
// natural-log units, clamped at -1e30 as loaded. DBIAS (with BIAS 2 only): also write
// dS to dbias [B*H, Sq, Sk] fp32.
template <int D, int BIAS, bool DBIAS>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                        float* __restrict__ dbias, int H, int Sq, int Sk, Strides st, float qk_scale,
                        float scale) {
  using C = Cfg<D>;
  constexpr int BN = C::BN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sO = sQ + BLOCK * C::STRIDE;
  __nv_bfloat16* sK = sO + BLOCK * C::STRIDE;
  __nv_bfloat16* sV = sK + 2 * BN * C::STRIDE;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BLOCK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const __nv_bfloat16* qb = q + b * st.q[0] + h * st.q[2];
  const __nv_bfloat16* kb = k + b * st.k[0] + h * st.k[2];
  const __nv_bfloat16* vb = v + b * st.v[0] + h * st.v[2];
  const __nv_bfloat16* ob = dout + b * st.o[0] + h * st.o[2];

  load_tile<BLOCK, C::CHUNKS, C::D_CHUNKS, C::STRIDE, NUM_THREADS>(sQ, qb, st.q[1], q0, Sq, tid);
  load_tile<BLOCK, C::CHUNKS, C::D_CHUNKS, C::STRIDE, NUM_THREADS>(sO, ob, st.o[1], q0, Sq, tid);
  auto load_kv = [&](int stage, int n0) {
    load_tile<BN, C::CHUNKS, C::D_CHUNKS, C::STRIDE, NUM_THREADS>(sK + stage * BN * C::STRIDE, kb, st.k[1], n0,
                                                                   Sk, tid);
    load_tile<BN, C::CHUNKS, C::D_CHUNKS, C::STRIDE, NUM_THREADS>(sV + stage * BN * C::STRIDE, vb, st.v[1], n0,
                                                                   Sk, tid);
  };
  load_kv(0, 0);
  cp_async_commit();

  const int row_a = q0 + warp * 16 + lane / 4;  // this thread's rows: row_a and row_a + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    lse2[r] = row < Sq ? lse[(long long)bh * Sq + row] * LOG2E : 0.f;
    dl[r] = row < Sq ? delta[(long long)bh * Sq + row] : 0.f;
  }
  uint32_t qf[C::HOLD ? C::DP / 16 : 1][4], of[C::HOLD ? C::DP / 16 : 1][4];  // held at D <= 80 only
  float acc[C::DP / 8][4];
  zero<C::DP / 8>(acc);
  const __nv_bfloat16* wQ = sQ + warp * 16 * C::STRIDE;  // this warp's 16 rows of Q and dO
  const __nv_bfloat16* wO = sO + warp * 16 * C::STRIDE;

  const int n_tiles = (Sk + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) load_kv(stage ^ 1, (j + 1) * BN);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (C::HOLD) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < C::DP / 16; ++kk) {
          load_a<C::STRIDE>(qf[kk], wQ, kk, lane);
          load_a<C::STRIDE>(of[kk], wO, kk, lane);
        }
      }
    }
    const __nv_bfloat16* tK = sK + stage * BN * C::STRIDE;
    const __nv_bfloat16* tV = sV + stage * BN * C::STRIDE;

    float s[BN / 8][4], dp[BN / 8][4];
    zero<BN / 8>(s);
    zero<BN / 8>(dp);
    if constexpr (C::HOLD) {
      mma_abt<C::DP, BN / 8, C::STRIDE>(s, qf, tK, lane);   // S = Q K^T
      mma_abt<C::DP, BN / 8, C::STRIDE>(dp, of, tV, lane);  // dP = dO V^T
    } else {
      mma_abt_smem<C::DP, BN / 8, C::STRIDE>(s, wQ, tK, lane);
      mma_abt_smem<C::DP, BN / 8, C::STRIDE>(dp, wO, tV, lane);
    }

    const int n0 = j * BN;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_a + (e / 2) * 8;
        const int col = n0 + nt * 8 + (lane % 4) * 2 + (e % 2);
        float p = 0.f;
        if (col < Sk) {
          float x = s[nt][e] * qk_scale;
          if (BIAS == 1) {
            x = fmaf(bias_at(bias + (long long)b * Sk + col), LOG2E, x);
          } else if (BIAS == 2) {
            if (row < Sq) x = fmaf(bias_at(bias + ((long long)bh * Sq + row) * Sk + col), LOG2E, x);
          }
          p = exp2_approx(x - lse2[e / 2]);
        }
        s[nt][e] = p * (dp[nt][e] - dl[e / 2]);  // dS
      }
    }
    if constexpr (DBIAS) {  // this tile's dS, natural-log units, fp32
      float* dbh = dbias + (long long)bh * Sq * Sk;
      const bool even_sk = (Sk & 1) == 0;  // then (row*Sk + col) is even: 8-byte aligned pairs
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int col = n0 + nt * 8 + (lane % 4) * 2;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_a + r * 8;
          if (row >= Sq || col >= Sk) continue;
          float* dst = dbh + (long long)row * Sk + col;
          if (even_sk) {
            *reinterpret_cast<float2*>(dst) = make_float2(s[nt][2 * r], s[nt][2 * r + 1]);
          } else {
            dst[0] = s[nt][2 * r];
            if (col + 1 < Sk) dst[1] = s[nt][2 * r + 1];
          }
        }
      }
    }
    mma_ab<C::DP, BN, C::STRIDE>(acc, s, tK, lane);  // dQ += dS K
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_rows<D, C::DP>(dq, acc, row_a, Sq, H, b, h, scale, lane);
}

// Built at D = 160 only (at 40/64/80 dK/dV is flash_bwd_sm90.cu's): SPLIT
// = 2 warps share each 16 keys, warp w takes keys 16 * (w % 4) and columns
// [DH * (w / 4), DH * (w / 4 + 1)) of dK and dV, and no K/V fragment is
// held (mma_abt_smem)
template <int D, int BIAS>
__global__ void __launch_bounds__(Cfg<D>::DKV_THREADS)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int Sq, int Sk, Strides st, float qk_scale,
                         float scale) {
  using C = Cfg<D>;
  constexpr int BM = C::BM;
  constexpr int THREADS = C::DKV_THREADS;
  constexpr int DH = C::DH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BLOCK * C::STRIDE;
  __nv_bfloat16* sQ = sV + BLOCK * C::STRIDE;  // two stages
  __nv_bfloat16* sO = sQ + 2 * BM * C::STRIDE;  // two stages
  float* sL = reinterpret_cast<float*>(sO + 2 * BM * C::STRIDE);  // lse*LOG2E, two stages
  float* sD = sL + 2 * BM;                                         // delta, two stages

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int n0 = blockIdx.x * BLOCK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kw = warp % NUM_WARPS;          // this warp's 16 keys
  const int col0 = (warp / NUM_WARPS) * DH;  // and its dK/dV columns
  const __nv_bfloat16* qb = q + b * st.q[0] + h * st.q[2];
  const __nv_bfloat16* kb = k + b * st.k[0] + h * st.k[2];
  const __nv_bfloat16* vb = v + b * st.v[0] + h * st.v[2];
  const __nv_bfloat16* ob = dout + b * st.o[0] + h * st.o[2];
  const float* lse_bh = lse + (long long)bh * Sq;
  const float* delta_bh = delta + (long long)bh * Sq;

  load_tile<BLOCK, C::CHUNKS, C::D_CHUNKS, C::STRIDE, THREADS>(sK, kb, st.k[1], n0, Sk, tid);
  load_tile<BLOCK, C::CHUNKS, C::D_CHUNKS, C::STRIDE, THREADS>(sV, vb, st.v[1], n0, Sk, tid);
  auto load_q = [&](int stage, int m0) {
    load_tile<BM, C::CHUNKS, C::D_CHUNKS, C::STRIDE, THREADS>(sQ + stage * BM * C::STRIDE, qb, st.q[1], m0,
                                                               Sq, tid);
    load_tile<BM, C::CHUNKS, C::D_CHUNKS, C::STRIDE, THREADS>(sO + stage * BM * C::STRIDE, ob, st.o[1], m0,
                                                               Sq, tid);
    // the previous readers of this stage passed the loop's closing barrier
    for (int i = tid; i < BM; i += THREADS) {
      const bool ok = m0 + i < Sq;
      sL[stage * BM + i] = ok ? lse_bh[m0 + i] * LOG2E : 0.f;
      sD[stage * BM + i] = ok ? delta_bh[m0 + i] : 0.f;
    }
  };
  load_q(0, 0);
  cp_async_commit();

  const int key_a = n0 + kw * 16 + lane / 4;  // this thread's keys: key_a and key_a + 8
  float kbias[2] = {0.f, 0.f};
  if (BIAS == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_a + r * 8;
      if (key < Sk) kbias[r] = bias_at(bias + (long long)b * Sk + key);
    }
  }
  const __nv_bfloat16* wK = sK + kw * 16 * C::STRIDE;
  const __nv_bfloat16* wV = sV + kw * 16 * C::STRIDE;
  float acc_k[DH / 8][4], acc_v[DH / 8][4];
  zero<DH / 8>(acc_k);
  zero<DH / 8>(acc_v);

  const int m_tiles = (Sq + BM - 1) / BM;
  for (int j = 0; j < m_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < m_tiles) load_q(stage ^ 1, (j + 1) * BM);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* tQ = sQ + stage * BM * C::STRIDE;
    const __nv_bfloat16* tO = sO + stage * BM * C::STRIDE;
    const float* tL = sL + stage * BM;
    const float* tD = sD + stage * BM;

    float s[BM / 8][4], dp[BM / 8][4];
    zero<BM / 8>(s);
    zero<BM / 8>(dp);
    mma_abt_smem<C::DP, BM / 8, C::STRIDE>(s, wK, tQ, lane);   // S^T = K Q^T
    mma_abt_smem<C::DP, BM / 8, C::STRIDE>(dp, wV, tO, lane);  // dP^T = V dO^T

    const int m0 = j * BM;
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_a + (e / 2) * 8;
        const int i = nt * 8 + (lane % 4) * 2 + (e % 2);  // query row within the tile
        float p = 0.f;
        if (m0 + i < Sq && key < Sk) {
          float x = s[nt][e] * qk_scale;
          if (BIAS == 1) {
            x = fmaf(kbias[e / 2], LOG2E, x);
          } else if (BIAS == 2) {
            x = fmaf(bias_at(bias + ((long long)bh * Sq + m0 + i) * Sk + key), LOG2E, x);
          }
          p = exp2_approx(x - tL[i]);
        }
        s[nt][e] = p;                         // P^T
        dp[nt][e] = p * (dp[nt][e] - tD[i]);  // dS^T
      }
    }
    mma_ab<DH, BM, C::STRIDE>(acc_v, s, tO + col0, lane);   // dV += P^T dO
    mma_ab<DH, BM, C::STRIDE>(acc_k, dp, tQ + col0, lane);  // dK += dS^T Q
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_rows<D, DH>(dk, acc_k, key_a, Sk, H, b, h, scale, lane, col0);
  store_rows<D, DH>(dv, acc_v, key_a, Sk, H, b, h, 1.f, lane, col0);
}

struct Args {
  const void *q, *k, *v, *bias, *dout, *lse, *delta;
  void *out0, *out1;  // dq | dq, dbias | dk, dv
  int B, H, Sq, Sk;
  Strides st;
  float scale;
  cudaStream_t stream;
};

template <int D, int BIAS, bool DBIAS>
int launch_dq(const Args& a) {
  using C = Cfg<D>;
  auto kern = flash_bwd_dq_kernel<D, BIAS, DBIAS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_DQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + BLOCK - 1) / BLOCK, a.B * a.H);
  kern<<<grid, NUM_THREADS, C::SMEM_DQ, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const float*>(a.bias),
      static_cast<const __nv_bfloat16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0), static_cast<float*>(a.out1),
      a.H, a.Sq, a.Sk, a.st, a.scale * LOG2E, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BIAS>
int launch_dkv(const Args& a) {
  using C = Cfg<D>;
  auto kern = flash_bwd_dkv_kernel<D, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_DKV);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sk + BLOCK - 1) / BLOCK, a.B * a.H);
  kern<<<grid, C::DKV_THREADS, C::SMEM_DKV, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const float*>(a.bias),
      static_cast<const __nv_bfloat16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0),
      static_cast<__nv_bfloat16*>(a.out1), a.H, a.Sq, a.Sk, a.st, a.scale * LOG2E, a.scale);
  return static_cast<int>(cudaGetLastError());
}

enum Kind { DQ, DQ_DBIAS, DKV };

template <int KIND, int D, int BIAS>
int launch(const Args& a) {
  if constexpr (KIND == DKV) return launch_dkv<D, BIAS>(a);
  else return launch_dq<D, BIAS, KIND == DQ_DBIAS>(a);
}

template <int KIND, int D>
int dispatch_bias(int bias_mode, const Args& a) {
  if constexpr (KIND == DQ_DBIAS) {  // dBias is the gradient of a full bias only
    return bias_mode == 2 ? launch<KIND, D, 2>(a) : static_cast<int>(cudaErrorInvalidValue);
  } else {
    switch (bias_mode) {
      case 0: return launch<KIND, D, 0>(a);
      case 1: return launch<KIND, D, 1>(a);
      case 2: return launch<KIND, D, 2>(a);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

// K5 is built at every head dim; dQ and dK/dV at D = 160 only (at 40, 64,
// 80 and 128 they are flash_bwd_sm90.cu's)
template <int KIND>
int dispatch(int D, int bias_mode, const Args& a) {
  if constexpr (KIND == DQ_DBIAS) {
    switch (D) {
      case 40: return dispatch_bias<KIND, 40>(bias_mode, a);
      case 64: return dispatch_bias<KIND, 64>(bias_mode, a);
      case 80: return dispatch_bias<KIND, 80>(bias_mode, a);
      case 128: return dispatch_bias<KIND, 128>(bias_mode, a);
      case 160: return dispatch_bias<KIND, 160>(bias_mode, a);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return D == 160 ? dispatch_bias<KIND, 160>(bias_mode, a) : static_cast<int>(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* bias, const void* dout, const void* lse,
               const void* delta, void* out0, void* out1, int B, int H, int Sq, int Sk, const long long* strides,
               float scale, void* stream) {
  Args a{q, k, v, bias, dout, lse, delta, out0, out1, B, H, Sq, Sk, {}, scale, static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = strides[i];
    a.st.k[i] = strides[3 + i];
    a.st.v[i] = strides[6 + i];
    a.st.o[i] = strides[9 + i];
  }
  return a;
}

}  // namespace

// q, dout: bf16 [B, Sq, H, D] and k, v: bf16 [B, Sk, H, D] views with unit
// stride over D; strides (elements) {q_b, q_s, q_h, k_*, v_*, dout_*}. lse,
// delta: contiguous fp32 [B, H, Sq]; bias as in uwu_flash_fwd. Outputs are
// contiguous bf16 [B, S, H, D]; dbias is contiguous fp32 [B*H, Sq, Sk] and
// needs bias_mode 2. Each returns a cudaError_t code.
extern "C" int uwu_flash_bwd_dq(const void* q, const void* k, const void* v, const void* bias, const void* dout,
                                const void* lse, const void* delta, void* dq, int B, int H, int Sq, int Sk, int D,
                                int bias_mode, const long long* strides, float scale, void* stream) {
  const Args a = make_args(q, k, v, bias, dout, lse, delta, dq, nullptr, B, H, Sq, Sk, strides, scale, stream);
  return dispatch<DQ>(D, bias_mode, a);
}

extern "C" int uwu_flash_bwd_dq_dbias(const void* q, const void* k, const void* v, const void* bias,
                                      const void* dout, const void* lse, const void* delta, void* dq, void* dbias,
                                      int B, int H, int Sq, int Sk, int D, int bias_mode,
                                      const long long* strides, float scale, void* stream) {
  const Args a = make_args(q, k, v, bias, dout, lse, delta, dq, dbias, B, H, Sq, Sk, strides, scale, stream);
  return dispatch<DQ_DBIAS>(D, bias_mode, a);
}

extern "C" int uwu_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* bias, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int B, int H, int Sq,
                                 int Sk, int D, int bias_mode, const long long* strides, float scale,
                                 void* stream) {
  const Args a = make_args(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Sq, Sk, strides, scale, stream);
  return dispatch<DKV>(D, bias_mode, a);
}
