// Building blocks shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): cp.async staging, ldmatrix fragment loads, the bf16
// mma.sync m16n8k16 product, exp2 and bf16 packing.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = threadIdx.x % 32):
//   A 16x16 row-major: a[0] (row lane/4, cols 2*(lane%4)+{0,1}), a[1] row +8,
//                      a[2] cols +8, a[3] row +8 and cols +8;
//   B 16x8 "col":      b0 (k rows 2*(lane%4)+{0,1}, col lane/4), b1 k rows +8;
//   C 16x8 fp32:       c[0..1] (row lane/4, cols 2*(lane%4)+{0,1}), c[2..3] row +8.
// An fp32 C fragment of two neighbouring n-tiles re-packs in place as the A
// fragment of the next product (pack_a), so a probability tile never leaves
// registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// a bias element (natural-log units) clamped at -1e30, so that a bias
// holding -inf (CLIP adds finfo.min twice) gives no NaN; the wrappers pass
// the caller's fp32 bias uncopied
__device__ __forceinline__ float bias_at(const float* p) { return fmaxf(*p, -1e30f); }

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment (16 rows x 16 k) of n-tiles 2*kt and 2*kt + 1 of a C tile
__device__ __forceinline__ void pack_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Stage rows [r0, r0 + ROWS) of a [n_rows, D] bf16 matrix (row stride
// row_stride elements, unit stride over D) into a shared tile with row pitch
// STRIDE, padded to CHUNKS 16-byte chunks a row: rows >= n_rows and the
// columns past D are zero-filled, so nothing is padded in device memory.
template <int ROWS, int CHUNKS, int D_CHUNKS, int STRIDE, int NTHREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, long long row_stride,
                                          int r0, int n_rows, int tid) {
  for (int i = tid; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = (r0 + r < n_rows) && (c < D_CHUNKS);
    cp_async16(dst + r * STRIDE + c * 8, ok ? src + (r0 + r) * row_stride + c * 8 : src, ok);
  }
}

// Tile products over shared-memory tiles with row pitch STRIDE (elements).
// load_a loads the A fragment of rows [0, 16) x cols [kk*16, kk*16 + 16)
// of a row-major tile (lanes 0-15 address rows at col kk*16, 16-31 at +8).
template <int STRIDE>
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* tile, int kk, int lane) {
  ldmatrix_x4(a, tile + (lane % 16) * STRIDE + kk * 16 + (lane / 16) * 8);
}

// acc[NT][4] += A (16 x DP, in registers as DP/16 fragments) . T^T, where T
// is an [NT*8, DP] row-major tile: the "S = Q K^T" product.
template <int DP, int NT, int STRIDE>
__device__ __forceinline__ void mma_abt(float acc[][4], uint32_t a[][4], const __nv_bfloat16* t, int lane) {
  const int l8 = lane % 8, mi = lane / 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, t + (np * 16 + l8 + (mi / 2) * 8) * STRIDE + kk * 16 + (mi % 2) * 8);
      mma_16816(acc[2 * np], a[kk], bf[0], bf[1]);
      mma_16816(acc[2 * np + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// acc[DP/8][4] += P (16 x K, an fp32 C tile of K/8 n-tiles, packed to bf16)
// . T, where T is a [K, DP] row-major tile: the "O = P V" product.
template <int DP, int K, int STRIDE>
__device__ __forceinline__ void mma_ab(float acc[][4], float p[][4], const __nv_bfloat16* t, int lane) {
  const int l8 = lane % 8, mi = lane / 8;
#pragma unroll
  for (int kt = 0; kt < K / 16; ++kt) {
    uint32_t a[4];
    pack_a(a, p[2 * kt], p[2 * kt + 1]);
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, t + (kt * 16 + l8 + (mi % 2) * 8) * STRIDE + dp * 16 + (mi / 2) * 8);
      mma_16816(acc[2 * dp], a, bf[0], bf[1]);
      mma_16816(acc[2 * dp + 1], a, bf[2], bf[3]);
    }
  }
}

}  // namespace flash
