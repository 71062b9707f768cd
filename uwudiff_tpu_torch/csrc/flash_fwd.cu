// Flash-attention forward with mma.sync for the head dims 40, 80 and 160
// (SD1.5's): bf16 q/k/v, fp32 softmax state. Every path runs the Hopper
// kernel of flash_fwd_sm90.cu at every head dim; this one stays built and
// tested as its yardstick (chip_smoke.py times both).
//
// Replaces the TPU kernel uwudiff_tpu/ops/flash_attention.py::_fwd_kernel
// (online softmax in the exp2 domain, out + natural-log lse, bias none /
// key / full).
//
// What bounds it on an H100: at the serving path's shapes (Sq = 1024 or 4096
// image tokens, D = 64) the two products Q.K^T and P.V are ~128 operations per
// byte of q/k/v, far above the ridge, so it is bound by tensor-core issue and
// by the softmax's exp2 work between the two products. The design keeps the
// [Sq, Sk] logits out of device memory entirely:
//   - one block of 4 warps owns a 64-row query tile (16 rows per warp) of one
//     (batch, head), and loops over 64-key (32 for D > 128) K/V tiles;
//   - K/V tiles are staged in shared memory by cp.async, two stages deep, so
//     the next tile's copy overlaps this tile's products;
//   - both products run on the tensor cores through mma.sync m16n8k16
//     (bf16 in, fp32 accumulate); P never leaves registers: the fp32 S
//     accumulator fragment is re-packed in place as the A operand of P.V;
//   - m, l and the output accumulator stay in fp32 registers; the logit scale
//     scale*LOG2E and the bias's LOG2E are applied to the fp32 S tile (one
//     FMA per logit) rather than folded into bf16 q, which would round q;
//   - head dims that are not a multiple of 16 (40) are zero-padded in shared
//     memory only; rows beyond Sq / keys beyond Sk are zero-filled by
//     cp.async and masked with -inf in registers, so nothing is padded in
//     device memory;
//   - the no-bias instantiation loads no bias at all.
// flash_fwd_sm90.cu is the TMA/wgmma/warp-specialised design that took
// these head dims over, 2.1x faster at SD1.5's level 0 (PERF.md).

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BLOCK_M = 64;
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;

template <int D>
struct Cfg {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to the mma depth
  static constexpr int STRIDE = DP + 8;          // smem row pitch; the skew spreads ldmatrix rows over banks
  static constexpr int BLOCK_N = DP > 128 ? 32 : 64;
  static constexpr int CHUNKS = DP / 8;          // 16-byte chunks per padded row
  static constexpr int D_CHUNKS = D / 8;         // chunks that hold real data
  static constexpr int SMEM = (BLOCK_M + 4 * BLOCK_N) * STRIDE * 2;  // Q + two stages of K and V
};

// BIAS: 0 none, 1 key bias [B, Sk] fp32, 2 full bias [B*H, Sq, Sk] fp32.
// Natural-log units; clamped at -1e30 as they are loaded.
template <int D, int BIAS>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Sk,
                     long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss, long long v_sh, float qk_scale) {
  using C = Cfg<D>;
  constexpr int BN = C::BLOCK_N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BLOCK_M * C::STRIDE;
  __nv_bfloat16* sV = sK + 2 * BN * C::STRIDE;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BLOCK_M;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  load_tile<BLOCK_M, C::CHUNKS, C::D_CHUNKS, C::STRIDE, NUM_THREADS>(sQ, qb, q_ss, q0, Sq, tid);
  auto load_kv = [&](int stage, int n0) {
    load_tile<BN, C::CHUNKS, C::D_CHUNKS, C::STRIDE, NUM_THREADS>(sK + stage * BN * C::STRIDE, kb, k_ss, n0, Sk,
                                                                   tid);
    load_tile<BN, C::CHUNKS, C::D_CHUNKS, C::STRIDE, NUM_THREADS>(sV + stage * BN * C::STRIDE, vb, v_ss, n0, Sk,
                                                                   tid);
  };
  load_kv(0, 0);
  cp_async_commit();

  const int n_tiles = (Sk + BN - 1) / BN;
  const int row_a = q0 + warp * 16 + lane / 4;  // this thread's rows: row_a and row_a + 8
  uint32_t qf[C::DP / 16][4];
  float o[C::DP / 8][4];
#pragma unroll
  for (int i = 0; i < C::DP / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};  // per-thread partial row sums, quad-reduced at the end

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) load_kv(stage ^ 1, (j + 1) * BN);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < C::DP / 16; ++kk) load_a<C::STRIDE>(qf[kk], sQ + warp * 16 * C::STRIDE, kk, lane);
    }
    const __nv_bfloat16* tK = sK + stage * BN * C::STRIDE;
    const __nv_bfloat16* tV = sV + stage * BN * C::STRIDE;

    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    mma_abt<C::DP, BN / 8, C::STRIDE>(s, qf, tK, lane);

    const int n0 = j * BN;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_a + (e / 2) * 8;
        const int col = n0 + nt * 8 + (lane % 4) * 2 + (e % 2);
        float x = s[nt][e] * qk_scale;
        if (col >= Sk) {
          x = -INFINITY;
        } else if (BIAS == 1) {
          x = fmaf(bias_at(bias + (long long)b * Sk + col), LOG2E, x);
        } else if (BIAS == 2) {
          if (row < Sq) x = fmaf(bias_at(bias + ((long long)bh * Sq + row) * Sk + col), LOG2E, x);
        }
        s[nt][e] = x;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // key 0 lies in tile 0 and its logit is finite, so m_new is finite
      const float m_new = fmaxf(m_r[r], mx);
      const float alpha = exp2_approx(m_r[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const float p0 = exp2_approx(s[nt][2 * r] - m_new);
        const float p1 = exp2_approx(s[nt][2 * r + 1] - m_new);
        s[nt][2 * r] = p0;
        s[nt][2 * r + 1] = p1;
        sum += p0 + p1;
      }
      l_r[r] = l_r[r] * alpha + sum;
      m_r[r] = m_new;
#pragma unroll
      for (int dt = 0; dt < C::DP / 8; ++dt) {
        o[dt][2 * r] *= alpha;
        o[dt][2 * r + 1] *= alpha;
      }
    }

    mma_ab<C::DP, BN, C::STRIDE>(o, s, tV, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row_a + r * 8;
    if (row < Sq) {
      const float inv = 1.f / l;  // l >= 1: the row maximum contributes exp2(0)
      __nv_bfloat16* orow = out + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int dt = 0; dt < C::DP / 8; ++dt) {
        const int col = dt * 8 + (lane % 4) * 2;
        if (col < D)
          *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
      }
      if (lane % 4 == 0) lse[(long long)bh * Sq + row] = m_r[r] * LN2 + logf(l);
    }
  }
}

template <int D, int BIAS>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, void* lse, int B, int H,
           int Sq, int Sk, const long long* st, float qk_scale, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kern = flash_fwd_kernel<D, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, B * H);
  kern<<<grid, NUM_THREADS, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      qk_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_bias(int bias_mode, const void* q, const void* k, const void* v, const void* bias, void* out,
                  void* lse, int B, int H, int Sq, int Sk, const long long* st, float qk_scale,
                  cudaStream_t stream) {
  switch (bias_mode) {
    case 0: return launch<D, 0>(q, k, v, bias, out, lse, B, H, Sq, Sk, st, qk_scale, stream);
    case 1: return launch<D, 1>(q, k, v, bias, out, lse, B, H, Sq, Sk, st, qk_scale, stream);
    case 2: return launch<D, 2>(q, k, v, bias, out, lse, B, H, Sq, Sk, st, qk_scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/k/v: bf16 [B, S, H, D] views with unit stride over D; strides (elements) are
// given as {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h}. out: contiguous bf16
// [B, Sq, H, D]; lse: contiguous fp32 [B, H, Sq]. Returns a cudaError_t code.
extern "C" int uwu_flash_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                             void* lse, int B, int H, int Sq, int Sk, int D, int bias_mode,
                             const long long* strides, float scale, void* stream) {
  const float qk_scale = scale * flash::LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return dispatch_bias<40>(bias_mode, q, k, v, bias, out, lse, B, H, Sq, Sk, strides, qk_scale, s);
    case 80: return dispatch_bias<80>(bias_mode, q, k, v, bias, out, lse, B, H, Sq, Sk, strides, qk_scale, s);
    case 160: return dispatch_bias<160>(bias_mode, q, k, v, bias, out, lse, B, H, Sq, Sk, strides, qk_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
