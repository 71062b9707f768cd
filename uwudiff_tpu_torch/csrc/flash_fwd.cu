// Flash-attention forward for Hopper (sm_90a): bf16 q/k/v, fp32 softmax state.
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
// wgmma/TMA warp specialisation is the later step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to the mma depth
  static constexpr int STRIDE = DP + 8;          // smem row pitch; the skew spreads ldmatrix rows over banks
  static constexpr int BLOCK_N = DP > 128 ? 32 : 64;
  static constexpr int CHUNKS = DP / 8;          // 16-byte chunks per padded row
  static constexpr int D_CHUNKS = D / 8;         // chunks that hold real data
  static constexpr int SMEM = (BLOCK_M + 4 * BLOCK_N) * STRIDE * 2;  // Q + two stages of K and V
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;  // 0 -> the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// BIAS: 0 none, 1 key bias [B, Sk] fp32, 2 full bias [B*H, Sq, Sk] fp32.
// Biases arrive clamped at -1e30 (natural-log units).
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

  for (int i = tid; i < BLOCK_M * C::CHUNKS; i += NUM_THREADS) {
    const int r = i / C::CHUNKS, c = i % C::CHUNKS;
    const bool ok = (q0 + r < Sq) && (c < C::D_CHUNKS);
    cp_async16(sQ + r * C::STRIDE + c * 8, ok ? qb + (q0 + r) * q_ss + c * 8 : qb, ok);
  }
  auto load_kv = [&](int stage, int n0) {
    __nv_bfloat16* dK = sK + stage * BN * C::STRIDE;
    __nv_bfloat16* dV = sV + stage * BN * C::STRIDE;
    for (int i = tid; i < BN * C::CHUNKS; i += NUM_THREADS) {
      const int r = i / C::CHUNKS, c = i % C::CHUNKS;
      const bool ok = (n0 + r < Sk) && (c < C::D_CHUNKS);
      cp_async16(dK + r * C::STRIDE + c * 8, ok ? kb + (n0 + r) * k_ss + c * 8 : kb, ok);
      cp_async16(dV + r * C::STRIDE + c * 8, ok ? vb + (n0 + r) * v_ss + c * 8 : vb, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  const int n_tiles = (Sk + BN - 1) / BN;
  const int l8 = lane % 8, mi = lane / 8;
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
      for (int kk = 0; kk < C::DP / 16; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + lane % 16) * C::STRIDE + kk * 16 + (lane / 16) * 8);
    }
    const __nv_bfloat16* tK = sK + stage * BN * C::STRIDE;
    const __nv_bfloat16* tV = sV + stage * BN * C::STRIDE;

    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::DP / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, tK + (np * 16 + l8 + (mi / 2) * 8) * C::STRIDE + kk * 16 + (mi % 2) * 8);
        mma_16816(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_16816(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

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
          x = fmaf(bias[(long long)b * Sk + col], LOG2E, x);
        } else if (BIAS == 2) {
          if (row < Sq) x = fmaf(bias[((long long)bh * Sq + row) * Sk + col], LOG2E, x);
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

#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      a[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      a[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      a[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int dp = 0; dp < C::DP / 16; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, tV + (kt * 16 + l8 + (mi % 2) * 8) * C::STRIDE + dp * 16 + (mi / 2) * 8);
        mma_16816(o[2 * dp], a, bf[0], bf[1]);
        mma_16816(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
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
  const float qk_scale = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return dispatch_bias<40>(bias_mode, q, k, v, bias, out, lse, B, H, Sq, Sk, strides, qk_scale, s);
    case 64: return dispatch_bias<64>(bias_mode, q, k, v, bias, out, lse, B, H, Sq, Sk, strides, qk_scale, s);
    case 80: return dispatch_bias<80>(bias_mode, q, k, v, bias, out, lse, B, H, Sq, Sk, strides, qk_scale, s);
    case 160: return dispatch_bias<160>(bias_mode, q, k, v, bias, out, lse, B, H, Sq, Sk, strides, qk_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
