// GroupNorm (+ SiLU) forward for tiles that do not fit a cluster's shared
// memory, and the backward, for Hopper (sm_90a) over a [N, HW, C] view.
//
// Forward, the chunked route (ops/groupnorm_silu.py::plan_gn sends a shape
// here when its (sample, slab) tile does not fit 16 blocks' shared memory;
// every other shape takes the single-pass kernel of groupnorm_silu_sm90.cu):
//   gn_stats : replaces uwudiff_tpu/ops/groupnorm_silu.py::_gn_stats_kernel
//              (per-channel sums over HW chunks). One launch: per-(n, HW
//              chunk, channel) sums; the last block of each set of 64 chunks
//              to finish (found by a counter that the same block resets, so
//              no memset) merges the set's partials in a fixed order in fp64,
//              and the last of those merges the sets and writes per-(n,
//              channel) scale = inv*gamma and shift = beta - mean*scale (and
//              the per-(n, group) mean and inv)
//   gn_apply : y = silu(x*scale + shift) (or the affine alone), elementwise:
//              the XLA apply of _gn_silu_fwd_chunked in the JAX package
//
// Backward, the pair route (ops/groupnorm_silu.py::plan_gn_bwd sends a shape
// here when its x and dy tiles do not fit a cluster's shared memory; every
// other shape takes the single-pass kernel of groupnorm_silu_bwd_sm90.cu).
// Replaces ::_gn_bwd_partials_kernel (K7) and ::_gn_bwd_dx_kernel (K8); the
// TPU's pass A (stats recomputed by _gn_stats_kernel) is not needed: the
// autograd function keeps the forward's [N, C]/[N, G] stats.
//   gn_bwd_partials : dz = g*silu'(z) (dz = g without SiLU), per-(n, channel)
//                     t1 = sum_hw dz and t2 = sum_hw dz*xhat; one launch,
//                     split over HW chunks and merged like gn_stats (fp64,
//                     fixed order); the last merge also takes the group means
//                     of the GN backward and writes gn_bwd_dx's per-(n,
//                     channel) coefficients, so nothing runs between the two
//   gn_bwd_dx       : dx = scale*dz + P*x + Q, elementwise, on fixed channel
//                     columns like gn_apply
//
// What bounds it on an H100: bytes. Chunked forward, each element is read
// twice (stats, apply) and written once; backward, x and g are read twice
// (partials, dx) and dx written once; a few dozen flops per element against
// 6-10 bytes, far below the ridge. The design therefore:
//   - reads 16 bytes per thread per load, neighbouring threads on neighbouring
//     addresses (channels are the contiguous axis);
//   - splits HW across many blocks so the reduction passes (stats, backward
//     partials) fill all 132 SMs even at N = 1 (the VAE's [1, 1048576, 128]);
//     each block accumulates fp32 sums in registers, adds its row-threads'
//     sums in shared memory in a fixed order, and writes one partial row per
//     (n, chunk): no atomics on data, so a result is bitwise the same from
//     run to run;
//   - merges the partials in fp64 and computes var = E[x^2] - mean^2 there
//     (the TPU kernels do the same in fp32);
//   - keeps each thread of the elementwise passes (the apply, the backward's
//     sums and dx) on fixed channel columns, its per-channel coefficients in
//     registers (loaded once), with 32-bit offsets inside a sample and several
//     rows' 16-byte loads in flight before any math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_COLS_PER_THREAD = 3;  // C <= 6144 in bf16, 3072 in fp32

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// thread layout of the chunked kernels: tx_n threads across a row's
// 16-byte vector columns (cpt columns each), ty_n rows at a time; a block
// is tx_n * ty_n threads (at most THREADS)
__host__ __device__ inline void partial_layout(int vecs, int* cpt, int* tx_n, int* ty_n) {
  *cpt = (vecs + THREADS - 1) / THREADS;
  *tx_n = (vecs + *cpt - 1) / *cpt;
  *ty_n = THREADS / *tx_n;
}

__device__ __forceinline__ float load_affine(const void* p, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// grid (n_chunks, N), block tx_n * ty_n; dynamic smem max(2*ty_n*C floats,
// 2*C doubles + 2*G floats). partial: [N, n_chunks, 2, C] fp32 scratch (sum,
// sum of squares over the chunk's rows); merged: [N, n_sets, 2, C] fp64
// scratch, one row per set of MERGE_SET chunks; counter: [N, n_sets + 1]
// zeros, left zero. The last block of a set to finish merges the set's
// partials; the last of those merges the sets and writes the statistics.
constexpr int MERGE_SET = 64;

// the calling block is the last of `total` to arrive at `*count`; the count
// is reset for the next call when it is
__device__ __forceinline__ bool last_to_arrive(unsigned int* count, unsigned int total) {
  __shared__ unsigned int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(count, 1u) == total - 1;
    if (last) *count = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gn_stats_kernel(const T* __restrict__ x, const void* __restrict__ gamma, const void* __restrict__ beta,
                    int affine_bf16, float* __restrict__ partial, double* __restrict__ merged,
                    unsigned int* __restrict__ counter, float* __restrict__ scale, float* __restrict__ shift,
                    float* __restrict__ stats, int HW, int C, int G, int rows_per_chunk, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) float red[];  // [ty_n, 2, C], summed in a fixed order
  const int vecs = C / VEC;
  int cpt, tx_n, ty_n;
  partial_layout(vecs, &cpt, &tx_n, &ty_n);
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int n = blockIdx.y, chunk = blockIdx.x, n_chunks = gridDim.x;
  const int n_sets = (n_chunks + MERGE_SET - 1) / MERGE_SET;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(HW, r0 + rows_per_chunk);

  float s1[MAX_COLS_PER_THREAD][VEC], s2[MAX_COLS_PER_THREAD][VEC];
#pragma unroll
  for (int c = 0; c < MAX_COLS_PER_THREAD; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e) s1[c][e] = s2[c][e] = 0.f;

  const T* xn = x + (long long)n * HW * C;
  for (int r = r0 + ty; r < r1; r += ty_n) {
    const uint4* row = reinterpret_cast<const uint4*>(xn + (long long)r * C);
#pragma unroll
    for (int c = 0; c < MAX_COLS_PER_THREAD; ++c) {
      const int col = tx + c * tx_n;
      if (c < cpt && col < vecs) {
        const uint4 raw = row[col];
        const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = to_f(vals[e]);
          s1[c][e] += f;
          s2[c][e] = fmaf(f, f, s2[c][e]);
        }
      }
    }
  }
  float* mine = red + ty * 2 * C;
#pragma unroll
  for (int c = 0; c < MAX_COLS_PER_THREAD; ++c) {
    const int col = tx + c * tx_n;
    if (c < cpt && col < vecs) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        mine[col * VEC + e] = s1[c][e];
        mine[C + col * VEC + e] = s2[c][e];
      }
    }
  }
  __syncthreads();
  float* out = partial + ((long long)n * n_chunks + chunk) * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < ty_n; ++t) acc += red[t * 2 * C + i];
    out[i] = acc;
  }

  // the last block of this chunk's set merges the set's partials in order
  const int set = chunk / MERGE_SET, k0 = set * MERGE_SET, k1 = min(n_chunks, k0 + MERGE_SET);
  unsigned int* count = counter + (long long)n * (n_sets + 1);
  if (!last_to_arrive(count + set, k1 - k0)) return;
  const float* pn = partial + (long long)n * n_chunks * 2 * C;
  double* mn = merged + (long long)n * n_sets * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    double acc = 0.0;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) acc += __ldcg(pn + (long long)k * 2 * C + i);
    mn[(long long)set * 2 * C + i] = acc;
  }
  // the last set's merger of sample n merges the sets and writes its statistics
  if (!last_to_arrive(count + n_sets, n_sets)) return;
  double* ch = reinterpret_cast<double*>(red);  // [2, C] fp64 channel sums
  float* gmi = reinterpret_cast<float*>(ch + 2 * C);  // [2, G] mean, inv
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    double acc = 0.0;
    for (int k = 0; k < n_sets; ++k) acc += __ldcg(mn + (long long)k * 2 * C + i);
    ch[i] = acc;
  }
  __syncthreads();
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    double t1 = 0.0, t2 = 0.0;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      t1 += ch[c];
      t2 += ch[C + c];
    }
    const double cnt = (double)HW * cg;
    const double mean = t1 / cnt;
    const double var = fmax(t2 / cnt - mean * mean, 0.0);
    gmi[g] = (float)mean;
    gmi[G + g] = (float)(1.0 / sqrt(var + (double)eps));
    if (stats != nullptr) {  // [N, 2, G]: mean, inv
      stats[(long long)n * 2 * G + g] = gmi[g];
      stats[(long long)n * 2 * G + G + g] = gmi[G + g];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float sc = gmi[G + c / cg] * load_affine(gamma, c, affine_bf16);
    scale[(long long)n * C + c] = sc;
    shift[(long long)n * C + c] = load_affine(beta, c, affine_bf16) - gmi[c / cg] * sc;
  }
}

constexpr int APPLY_ROWS = 4;  // rows a thread loads before it computes

// VEC consecutive per-channel floats, 16-byte aligned, as float4 loads
template <int VEC>
__device__ __forceinline__ void load_vec(float out[VEC], const float* p) {
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    out[4 * i] = v.x;
    out[4 * i + 1] = v.y;
    out[4 * i + 2] = v.z;
    out[4 * i + 3] = v.w;
  }
}

// grid (blocks, N), block tx_n * ty_n (partial_layout): thread (tx, ty) keeps
// vector columns tx + c*tx_n (c < CPT) and walks rows ty, ty + ty_n, ...
// APPLY_ROWS at a time; offsets inside a sample are 32-bit (HW*C/VEC < 2^31,
// checked by the wrapper).
template <typename T, int CPT>
__global__ void __launch_bounds__(THREADS)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ shift,
                    T* __restrict__ y, int HW, int C, int silu) {
  constexpr int VEC = 16 / sizeof(T);
  const int vecs = C / VEC;
  const int tx_n = (vecs + CPT - 1) / CPT, ty_n = THREADS / tx_n;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int n = blockIdx.y;
  float sc[CPT][VEC], sh[CPT][VEC];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = min(tx + c * tx_n, vecs - 1);
    load_vec<VEC>(sc[c], scale + (long long)n * C + col * VEC);
    load_vec<VEC>(sh[c], shift + (long long)n * C + col * VEC);
  }
  const uint4* xs = reinterpret_cast<const uint4*>(x + (long long)n * HW * C);
  uint4* ys = reinterpret_cast<uint4*>(y + (long long)n * HW * C);
  const int step = ty_n * APPLY_ROWS;
  for (int r0 = blockIdx.x * step + ty; r0 < HW; r0 += gridDim.x * step) {
    uint4 v[APPLY_ROWS][CPT];
#pragma unroll
    for (int u = 0; u < APPLY_ROWS; ++u)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int r = r0 + u * ty_n, col = tx + c * tx_n;
        if (r < HW && col < vecs) v[u][c] = xs[r * vecs + col];
      }
#pragma unroll
    for (int u = 0; u < APPLY_ROWS; ++u)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int r = r0 + u * ty_n, col = tx + c * tx_n;
        if (r < HW && col < vecs) {
          const T* vals = reinterpret_cast<const T*>(&v[u][c]);
          uint4 res;
          T* outv = reinterpret_cast<T*>(&res);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            float z = fmaf(to_f(vals[e]), sc[c][e], sh[c][e]);
            if (silu) z = __fdividef(z, 1.f + __expf(-z));
            outv[e] = from_f<T>(z);
          }
          ys[r * vecs + col] = res;
        }
      }
  }
}

// ------------------------------------------------------------------ backward

// rows whose loads a thread of the backward's kernels has in flight before
// any math: APPLY_ROWS shared among its CPT columns
template <int CPT>
__host__ __device__ constexpr int rows_in_flight() {
  return APPLY_ROWS / CPT > 0 ? APPLY_ROWS / CPT : 1;
}

// dz of y = silu(z), z = x*scale + shift: g * s * (1 + z*(1 - s)), s = sigmoid(z)
__device__ __forceinline__ float silu_dz(float x, float g, float sc, float sh) {
  const float z = fmaf(x, sc, sh);
  const float s = __fdividef(1.f, 1.f + __expf(-z));
  return g * s * fmaf(z, 1.f - s, 1.f);
}

// the same for gn_bwd_dx: for a bf16 output the sigmoid is 0.5 (1 + tanh(z/2))
// with the SFU's tanh.approx (one operation, absolute error below 2^-12)
template <typename T>
__device__ __forceinline__ float silu_dz_out(float x, float g, float sc, float sh);
template <>
__device__ __forceinline__ float silu_dz_out<float>(float x, float g, float sc, float sh) {
  return silu_dz(x, g, sc, sh);
}
template <>
__device__ __forceinline__ float silu_dz_out<__nv_bfloat16>(float x, float g, float sc, float sh) {
  const float z = fmaf(x, sc, sh);
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * z));
  const float s = fmaf(0.5f, t, 0.5f);
  return g * s * fmaf(z, 1.f - s, 1.f);
}

// grid (n_chunks, N), block tx_n * ty_n (partial_layout); dynamic smem
// max(2*ty_n*C floats, 2*C doubles + (2*G + C) floats). Inputs: the forward's
// fp32 scale/shift [N, C] and per-group mean/inv [N, G] (rows stat_stride
// apart), gamma [C] in its dtype. partial: [N, n_chunks, 2, C] fp32 scratch
// (t1 = sum dz, t2 = sum dz*xhat over the chunk's rows, xhat = x*inv -
// mean*inv); merged: [N, n_sets, 2, C] fp64 scratch; counter: [N, n_sets + 1]
// zeros, left zero. As gn_stats: the last block of a set of MERGE_SET chunks
// merges the set in fp64, the last of those merges the sets and writes t
// [N, 2, C] and K8's coefficients coef [N, 4, C] = (scale, shift, P, Q),
// which fold the group means a_g = sum gamma t1 / m, b_g = sum gamma t2 / m
// into dx = scale*dz + P*x + Q. Each thread keeps its channels'
// coefficients in registers and loads U rows before it adds any; offsets
// inside a sample are 32-bit (HW*C/VEC < 2^31, checked by the wrapper).
template <typename T, int CPT>
__global__ void __launch_bounds__(THREADS)
    gn_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ g, const void* __restrict__ gamma,
                          int affine_bf16, const float* __restrict__ scale, const float* __restrict__ shift,
                          const float* __restrict__ mean, const float* __restrict__ inv, int stat_stride,
                          float* __restrict__ partial, double* __restrict__ merged, unsigned int* __restrict__ counter,
                          float* __restrict__ t_out, float* __restrict__ coef_out, int HW, int C, int G,
                          int rows_per_chunk, int silu) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = rows_in_flight<CPT>();
  extern __shared__ __align__(16) float red[];  // [ty_n, 2, C], summed in a fixed order
  const int vecs = C / VEC, cg = C / G;
  const int tx_n = (vecs + CPT - 1) / CPT, ty_n = THREADS / tx_n;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int n = blockIdx.y, chunk = blockIdx.x, n_chunks = gridDim.x;
  const int n_sets = (n_chunks + MERGE_SET - 1) / MERGE_SET;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(HW, r0 + rows_per_chunk);
  const float* mn = mean + (long long)n * stat_stride;
  const float* ivn = inv + (long long)n * stat_stride;

  float t1[CPT][VEC], t2[CPT][VEC], sc[CPT][VEC], sh[CPT][VEC], iv[CPT][VEC], nm[CPT][VEC];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = min(tx + c * tx_n, vecs - 1);  // this thread's channels, loaded once
    load_vec<VEC>(sc[c], scale + (long long)n * C + col * VEC);
    load_vec<VEC>(sh[c], shift + (long long)n * C + col * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int grp = (col * VEC + e) / cg;
      iv[c][e] = ivn[grp];
      nm[c][e] = -mn[grp] * iv[c][e];
      t1[c][e] = t2[c][e] = 0.f;
    }
  }

  if (ty < ty_n) {
    const uint4* xs = reinterpret_cast<const uint4*>(x + (long long)n * HW * C);
    const uint4* gs = reinterpret_cast<const uint4*>(g + (long long)n * HW * C);
    for (int rb = r0 + ty; rb < r1; rb += U * ty_n) {
      uint4 xv[U][CPT], gv[U][CPT];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int r = rb + u * ty_n, col = tx + c * tx_n;
          if (r < r1 && col < vecs) {
            xv[u][c] = xs[r * vecs + col];
            gv[u][c] = gs[r * vecs + col];
          }
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int r = rb + u * ty_n, col = tx + c * tx_n;
          if (r < r1 && col < vecs) {
            const T* xe = reinterpret_cast<const T*>(&xv[u][c]);
            const T* ge = reinterpret_cast<const T*>(&gv[u][c]);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float xf = to_f(xe[e]), gf = to_f(ge[e]);
              const float dz = silu ? silu_dz(xf, gf, sc[c][e], sh[c][e]) : gf;
              t1[c][e] += dz;
              t2[c][e] = fmaf(dz, fmaf(xf, iv[c][e], nm[c][e]), t2[c][e]);
            }
          }
        }
    }
    float* mine = red + ty * 2 * C;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + c * tx_n;
      if (col < vecs) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          mine[col * VEC + e] = t1[c][e];
          mine[C + col * VEC + e] = t2[c][e];
        }
      }
    }
  }
  __syncthreads();
  float* out = partial + ((long long)n * n_chunks + chunk) * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < ty_n; ++t) acc += red[t * 2 * C + i];
    out[i] = acc;
  }

  // the last block of this chunk's set merges the set's partials in order
  const int set = chunk / MERGE_SET, k0 = set * MERGE_SET, k1 = min(n_chunks, k0 + MERGE_SET);
  unsigned int* count = counter + (long long)n * (n_sets + 1);
  if (!last_to_arrive(count + set, k1 - k0)) return;
  const float* pn = partial + (long long)n * n_chunks * 2 * C;
  double* md = merged + (long long)n * n_sets * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    double acc = 0.0;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) acc += __ldcg(pn + (long long)k * 2 * C + i);
    md[(long long)set * 2 * C + i] = acc;
  }
  // the last set's merger of sample n merges the sets, writes t and K8's coefficients
  if (!last_to_arrive(count + n_sets, n_sets)) return;
  double* ch = reinterpret_cast<double*>(red);  // [2, C] fp64 channel sums
  float* ab = reinterpret_cast<float*>(ch + 2 * C);  // [2, G] a, b
  float* gm = ab + 2 * G;  // [C] gamma
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    double acc = 0.0;
    for (int k = 0; k < n_sets; ++k) acc += __ldcg(md + (long long)k * 2 * C + i);
    ch[i] = acc;
    t_out[(long long)n * 2 * C + i] = (float)acc;
    if (i < C) gm[i] = load_affine(gamma, i, affine_bf16);
  }
  __syncthreads();
  for (int grp = threadIdx.x; grp < G; grp += blockDim.x) {
    double a = 0.0, b = 0.0;
    for (int c = grp * cg; c < (grp + 1) * cg; ++c) {
      a += (double)gm[c] * ch[c];
      b += (double)gm[c] * ch[C + c];
    }
    const double m = (double)HW * cg;
    ab[grp] = (float)(a / m);
    ab[G + grp] = (float)(b / m);
  }
  __syncthreads();
  float* cn = coef_out + (long long)n * 4 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int grp = c / cg;
    const float ivc = ivn[grp], nmc = -mn[grp] * ivc;
    const float a = ab[grp], b = ab[G + grp];
    cn[c] = scale[(long long)n * C + c];
    cn[C + c] = shift[(long long)n * C + c];
    cn[2 * C + c] = -ivc * ivc * b;
    cn[3 * C + c] = -ivc * fmaf(b, nmc, a);
  }
}

// coef: [N, 4, C] fp32 (scale, shift, P, Q per channel); dx = scale*dz + P*x + Q.
// grid (blocks, N), block tx_n * ty_n (partial_layout): as gn_apply_kernel,
// thread (tx, ty) keeps vector columns tx + c*tx_n (c < CPT), their four
// coefficients in registers (loaded once), and walks rows ty, ty + ty_n, ...
// U rows' loads in flight before any math; 32-bit offsets inside a sample.
template <typename T, int CPT>
__global__ void __launch_bounds__(THREADS)
    gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ coef,
                     T* __restrict__ dx, int HW, int C, int silu) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = rows_in_flight<CPT>();
  const int vecs = C / VEC;
  const int tx_n = (vecs + CPT - 1) / CPT, ty_n = THREADS / tx_n;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int n = blockIdx.y;
  float sc[CPT][VEC], sh[CPT][VEC], pc[CPT][VEC], qc[CPT][VEC];
  const float* cn = coef + (long long)n * 4 * C;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = min(tx + c * tx_n, vecs - 1);
    load_vec<VEC>(sc[c], cn + col * VEC);
    load_vec<VEC>(sh[c], cn + C + col * VEC);
    load_vec<VEC>(pc[c], cn + 2 * C + col * VEC);
    load_vec<VEC>(qc[c], cn + 3 * C + col * VEC);
  }
  const long long base = (long long)n * HW * C;
  const uint4* xs = reinterpret_cast<const uint4*>(x + base);
  const uint4* gs = reinterpret_cast<const uint4*>(g + base);
  uint4* ds = reinterpret_cast<uint4*>(dx + base);
  const int step = ty_n * U;
  for (int r0 = blockIdx.x * step + ty; r0 < HW; r0 += gridDim.x * step) {
    uint4 xv[U][CPT], gv[U][CPT];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int r = r0 + u * ty_n, col = tx + c * tx_n;
        if (r < HW && col < vecs) {
          xv[u][c] = xs[r * vecs + col];
          gv[u][c] = gs[r * vecs + col];
        }
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int r = r0 + u * ty_n, col = tx + c * tx_n;
        if (r < HW && col < vecs) {
          const T* xe = reinterpret_cast<const T*>(&xv[u][c]);
          const T* ge = reinterpret_cast<const T*>(&gv[u][c]);
          uint4 res;
          T* outv = reinterpret_cast<T*>(&res);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float xf = to_f(xe[e]), gf = to_f(ge[e]);
            const float dz = silu ? silu_dz_out<T>(xf, gf, sc[c][e], sh[c][e]) : gf;
            outv[e] = from_f<T>(fmaf(sc[c][e], dz, fmaf(pc[c][e], xf, qc[c][e])));
          }
          ds[r * vecs + col] = res;
        }
      }
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

struct BwdArgs {
  const void *x, *g, *gamma, *scale, *shift, *mean, *inv;
  void *partial, *merged, *counter, *t, *coef;
  int affine_bf16, stat_stride, N, HW, C, G, n_chunks, silu;
};

template <typename T, int CPT>
int launch_bwd_partial(const BwdArgs& a, cudaStream_t s) {
  const int vecs = a.C / (16 / (int)sizeof(T));
  const int tx_n = (vecs + CPT - 1) / CPT, ty_n = THREADS / tx_n;
  const size_t red = 2 * (size_t)ty_n * a.C * sizeof(float);
  const size_t merge = 2 * (size_t)a.C * sizeof(double) + (2 * (size_t)a.G + a.C) * sizeof(float);
  const int smem = (int)(red > merge ? red : merge);
  auto kernel = gn_bwd_partial_kernel<T, CPT>;
  static int smem_set = 48 * 1024;  // per instantiation
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  kernel<<<dim3(a.n_chunks, a.N), tx_n * ty_n, smem, s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.gamma, a.affine_bf16,
      static_cast<const float*>(a.scale), static_cast<const float*>(a.shift), static_cast<const float*>(a.mean),
      static_cast<const float*>(a.inv), a.stat_stride, static_cast<float*>(a.partial),
      static_cast<double*>(a.merged), static_cast<unsigned int*>(a.counter), static_cast<float*>(a.t),
      static_cast<float*>(a.coef), a.HW, a.C, a.G, (a.HW + a.n_chunks - 1) / a.n_chunks, a.silu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_partial_cpt(const BwdArgs& a, cudaStream_t s) {
  int cpt, tx_n, ty_n;
  partial_layout(a.C / (16 / (int)sizeof(T)), &cpt, &tx_n, &ty_n);
  switch (cpt) {
    case 1: return launch_bwd_partial<T, 1>(a, s);
    case 2: return launch_bwd_partial<T, 2>(a, s);
    case 3: return launch_bwd_partial<T, 3>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int CPT>
void launch_bwd_dx(const void* x, const void* g, const void* coef, void* dx, int N, int HW, int C, int silu,
                   cudaStream_t s) {
  const int vecs = C / (16 / (int)sizeof(T));
  const int tx_n = (vecs + CPT - 1) / CPT, ty_n = THREADS / tx_n;
  const int rows_per_block = ty_n * rows_in_flight<CPT>();
  // ~8 blocks an SM over the whole grid; each block strides over its sample
  const int want = (HW + rows_per_block - 1) / rows_per_block;
  const int cap = (sm_count() * 8 + N - 1) / N;
  gn_bwd_dx_kernel<T, CPT><<<dim3(want < cap ? want : cap, N), tx_n * ty_n, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(coef), static_cast<T*>(dx), HW,
      C, silu);
}

template <typename T>
int bwd_dx_cpt(const void* x, const void* g, const void* coef, void* dx, int N, int HW, int C, int silu,
               cudaStream_t s) {
  int cpt, tx_n, ty_n;
  partial_layout(C / (16 / (int)sizeof(T)), &cpt, &tx_n, &ty_n);
  switch (cpt) {
    case 1: launch_bwd_dx<T, 1>(x, g, coef, dx, N, HW, C, silu, s); break;
    case 2: launch_bwd_dx<T, 2>(x, g, coef, dx, N, HW, C, silu, s); break;
    case 3: launch_bwd_dx<T, 3>(x, g, coef, dx, N, HW, C, silu, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous [N, HW, C] (dtype 0 = fp32, 1 = bf16); gamma/beta [C] in
// fp32 (affine_bf16 = 0) or bf16 (1); partial: fp32 scratch
// [N, n_chunks, 2, C]; merged: fp64 scratch [N, ceil(n_chunks / 64), 2, C];
// counter: [N, ceil(n_chunks / 64) + 1] unsigned zeros (left zero);
// scale/shift: fp32 [N, C] outputs; stats: null or an fp32 [N, 2, G] output
// (per-group mean, inv). One launch.
extern "C" int uwu_gn_stats(const void* x, const void* gamma, const void* beta, void* partial, void* merged,
                            void* counter, void* scale, void* shift, void* stats, int dtype, int affine_bf16, int N,
                            int HW, int C, int G, int n_chunks, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || C % vec || C / vec > THREADS * MAX_COLS_PER_THREAD || C % G)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_chunk = (HW + n_chunks - 1) / n_chunks;
  int cpt, tx_n, ty_n;
  partial_layout(C / vec, &cpt, &tx_n, &ty_n);
  const size_t red = 2 * (size_t)ty_n * C * sizeof(float);
  const size_t merge = 2 * (size_t)C * sizeof(double) + 2 * (size_t)G * sizeof(float);
  const int smem = (int)(red > merge ? red : merge);
  const dim3 grid(n_chunks, N), block(tx_n * ty_n);
  cudaError_t err = cudaSuccess;
  if (dtype == 1) {
    static int smem_set = 48 * 1024;
    if (smem > smem_set) {
      err = cudaFuncSetAttribute(gn_stats_kernel<__nv_bfloat16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = smem;
    }
    gn_stats_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), gamma, beta, affine_bf16, static_cast<float*>(partial),
        static_cast<double*>(merged), static_cast<unsigned int*>(counter), static_cast<float*>(scale),
        static_cast<float*>(shift), static_cast<float*>(stats), HW, C, G, rows_per_chunk, eps);
  } else {
    static int smem_set = 48 * 1024;
    if (smem > smem_set) {
      err = cudaFuncSetAttribute(gn_stats_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = smem;
    }
    gn_stats_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(x), gamma, beta, affine_bf16, static_cast<float*>(partial),
        static_cast<double*>(merged), static_cast<unsigned int*>(counter), static_cast<float*>(scale),
        static_cast<float*>(shift), static_cast<float*>(stats), HW, C, G, rows_per_chunk, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <typename T, int CPT>
void launch_apply(const void* x, const void* scale, const void* shift, void* y, int N, int HW, int C, int silu,
                  cudaStream_t s) {
  const int vecs = C / (16 / (int)sizeof(T));
  const int tx_n = (vecs + CPT - 1) / CPT, ty_n = THREADS / tx_n;
  const int rows_per_block = ty_n * APPLY_ROWS;
  // ~8 blocks an SM over the whole grid; each block strides over its sample
  const int want = (HW + rows_per_block - 1) / rows_per_block;
  const int cap = (sm_count() * 8 + N - 1) / N;
  gn_apply_kernel<T, CPT><<<dim3(want < cap ? want : cap, N), tx_n * ty_n, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<T*>(y), HW, C, silu);
}

template <typename T>
int apply_cpt(const void* x, const void* scale, const void* shift, void* y, int N, int HW, int C, int silu,
              cudaStream_t s) {
  int cpt, tx_n, ty_n;
  partial_layout(C / (16 / (int)sizeof(T)), &cpt, &tx_n, &ty_n);
  switch (cpt) {
    case 1: launch_apply<T, 1>(x, scale, shift, y, N, HW, C, silu, s); break;
    case 2: launch_apply<T, 2>(x, scale, shift, y, N, HW, C, silu, s); break;
    case 3: launch_apply<T, 3>(x, scale, shift, y, N, HW, C, silu, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = silu(x*scale[n, c] + shift[n, c]) (silu = 1) or the affine alone
// (silu = 0); x, y contiguous [N, HW, C] with HW*C/VEC < 2^31.
extern "C" int uwu_gn_apply(const void* x, const void* scale, const void* shift, void* y, int dtype, int N,
                            int HW, int C, int silu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return apply_cpt<__nv_bfloat16>(x, scale, shift, y, N, HW, C, silu, s);
  if (dtype == 0) return apply_cpt<float>(x, scale, shift, y, N, HW, C, silu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, g: contiguous [N, HW, C] of one dtype (0 = fp32, 1 = bf16), HW*C/VEC <
// 2^31; gamma [C] in fp32 (affine_bf16 = 0) or bf16 (1); scale, shift: the
// forward's fp32 [N, C]; mean, inv: fp32 [N, G], rows stat_stride elements
// apart; partial: fp32 scratch [N, n_chunks, 2, C]; merged: fp64 scratch
// [N, ceil(n_chunks / 64), 2, C]; counter: [N, ceil(n_chunks / 64) + 1]
// unsigned zeros (left zero); t: fp32 [N, 2, C] output (t1 = sum dz, t2 =
// sum dz*xhat); coef: fp32 [N, 4, C] output (scale, shift, P, Q) for
// uwu_gn_bwd_dx. One launch.
extern "C" int uwu_gn_bwd_partials(const void* x, const void* g, const void* gamma, const void* scale,
                                   const void* shift, const void* mean, const void* inv, void* partial, void* merged,
                                   void* counter, void* t, void* coef, int dtype, int affine_bf16, int stat_stride,
                                   int N, int HW, int C, int G, int n_chunks, int silu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || C % vec || C / vec > THREADS * MAX_COLS_PER_THREAD || C % G ||
      stat_stride < G || n_chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{x, g, gamma, scale, shift, mean, inv, partial, merged, counter, t, coef,
                  affine_bf16, stat_stride, N, HW, C, G, n_chunks, silu};
  return dtype == 1 ? bwd_partial_cpt<__nv_bfloat16>(a, s) : bwd_partial_cpt<float>(a, s);
}

// x, g, dx: contiguous [N, HW, C] of one dtype, HW*C/VEC < 2^31; coef: fp32
// [N, 4, C] (scale, shift, P, Q): dx = scale*dz + P*x + Q.
extern "C" int uwu_gn_bwd_dx(const void* x, const void* g, const void* coef, void* dx, int dtype, int N, int HW,
                             int C, int silu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return bwd_dx_cpt<__nv_bfloat16>(x, g, coef, dx, N, HW, C, silu, s);
  if (dtype == 0) return bwd_dx_cpt<float>(x, g, coef, dx, N, HW, C, silu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
