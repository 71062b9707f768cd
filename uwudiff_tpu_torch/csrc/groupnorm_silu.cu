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
// Backward. Replaces ::_gn_bwd_partials_kernel (K7) and ::_gn_bwd_dx_kernel
// (K8); the TPU's pass A (stats recomputed by _gn_stats_kernel) is not
// needed: the autograd function keeps the forward's [N, C]/[N, G] stats.
//   gn_bwd_partials : dz = g*silu'(z) (dz = g without SiLU), per-(n, channel)
//                     t1 = sum_hw dz and t2 = sum_hw dz*xhat, split over HW
//                     chunks like gn_stats and merged in a fixed order in fp64
//   gn_bwd_dx       : dx = scale*dz + P*x + Q, elementwise, where the
//                     per-(n, channel) P, Q fold the group means of the GN
//                     backward (PyTorch glue on [N, C] between the two)
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
//   - keeps each thread of the elementwise apply on fixed channel columns,
//     its scale/shift in registers (loaded once), with 32-bit offsets inside
//     a sample and four rows' 16-byte loads in flight before any math.

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

// dz of y = silu(z), z = x*scale + shift: g * sigmoid(z) * (1 + z*(1 - sigmoid(z)))
__device__ __forceinline__ float silu_dz(float x, float g, float sc, float sh) {
  const float z = fmaf(x, sc, sh);
  const float sig = 1.f / (1.f + __expf(-z));
  return g * sig * fmaf(z, 1.f - sig, 1.f);
}

// grid (n_chunks, N); dynamic smem 2*ty_n*C floats. coef: [N, 4, C] fp32
// (scale, shift, inv, -mean*inv per channel), so xhat = x*inv - mean*inv.
// partial: [N, n_chunks, 2, C] fp32 (t1 = sum dz, t2 = sum dz*xhat).
template <typename T, int CPT>
__global__ void __launch_bounds__(THREADS)
    gn_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ coef,
                          float* __restrict__ partial, int HW, int C, int rows_per_chunk, int silu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float red[];  // [ty_n, 2, C], summed in a fixed order
  const int vecs = C / VEC;
  const int tx_n = (vecs + CPT - 1) / CPT, ty_n = THREADS / tx_n;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(HW, r0 + rows_per_chunk);
  const float* cn = coef + (long long)n * 4 * C;

  float t1[CPT][VEC], t2[CPT][VEC], sc[CPT][VEC], sh[CPT][VEC], iv[CPT][VEC], nm[CPT][VEC];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) t1[c][e] = t2[c][e] = 0.f;
    const int col = tx + c * tx_n;
    if (ty < ty_n && col < vecs) {  // this thread's channels, loaded once
      load_vec<VEC>(sc[c], cn + col * VEC);
      load_vec<VEC>(sh[c], cn + C + col * VEC);
      load_vec<VEC>(iv[c], cn + 2 * C + col * VEC);
      load_vec<VEC>(nm[c], cn + 3 * C + col * VEC);
    }
  }

  if (ty < ty_n) {
    const long long base = (long long)n * HW * C;
    for (int r = r0 + ty; r < r1; r += ty_n) {
      const uint4* xrow = reinterpret_cast<const uint4*>(x + base + (long long)r * C);
      const uint4* grow = reinterpret_cast<const uint4*>(g + base + (long long)r * C);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tx + c * tx_n;
        if (col < vecs) {
          const uint4 xr = xrow[col], gr = grow[col];
          const T* xv = reinterpret_cast<const T*>(&xr);
          const T* gv = reinterpret_cast<const T*>(&gr);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float xf = to_f(xv[e]), gf = to_f(gv[e]);
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
  float* out = partial + ((long long)n * gridDim.x + chunk) * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += THREADS) {
    float acc = 0.f;
    for (int t = 0; t < ty_n; ++t) acc += red[t * 2 * C + i];
    out[i] = acc;
  }
}

// grid (ceil(2C / THREADS), N): out[n, :, c] = sum over chunks, in order, in fp64
__global__ void __launch_bounds__(THREADS)
    gn_bwd_merge_kernel(const float* __restrict__ partial, float* __restrict__ out, int C, int n_chunks) {
  const int i = blockIdx.x * THREADS + threadIdx.x, n = blockIdx.y;
  if (i >= 2 * C) return;
  const float* p = partial + (long long)n * n_chunks * 2 * C + i;
  double acc = 0.0;
  for (int k = 0; k < n_chunks; ++k) acc += p[(long long)k * 2 * C];
  out[(long long)n * 2 * C + i] = (float)acc;
}

// coef: [N, 4, C] fp32 (scale, shift, P, Q per channel); dx = scale*dz + P*x + Q
template <typename T>
__global__ void __launch_bounds__(THREADS)
    gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ coef,
                     T* __restrict__ dx, long long total_vecs, long long vecs_per_sample, int C, int silu) {
  constexpr int VEC = 16 / sizeof(T);
  const int vecs_per_row = C / VEC;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total_vecs; i += stride) {
    const long long n = i / vecs_per_sample;
    const int c0 = (int)(i % vecs_per_row) * VEC;
    const uint4 xr = reinterpret_cast<const uint4*>(x)[i];
    const uint4 gr = reinterpret_cast<const uint4*>(g)[i];
    const T* xv = reinterpret_cast<const T*>(&xr);
    const T* gv = reinterpret_cast<const T*>(&gr);
    const float* cn = coef + n * 4 * C + c0;
    float sc[VEC], sh[VEC], pc[VEC], qc[VEC];
    load_vec<VEC>(sc, cn);
    load_vec<VEC>(sh, cn + C);
    load_vec<VEC>(pc, cn + 2 * C);
    load_vec<VEC>(qc, cn + 3 * C);
    uint4 res;
    T* outv = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float xf = to_f(xv[e]), gf = to_f(gv[e]);
      const float dz = silu ? silu_dz(xf, gf, sc[e], sh[e]) : gf;
      outv[e] = from_f<T>(fmaf(sc[e], dz, fmaf(pc[e], xf, qc[e])));
    }
    reinterpret_cast<uint4*>(dx)[i] = res;
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename T, int CPT>
void launch_bwd_partial(const void* x, const void* g, const void* coef, void* partial, int N, int HW, int C,
                        int n_chunks, int silu, cudaStream_t s) {
  const int vecs = C / (16 / (int)sizeof(T));
  const int ty_n = THREADS / ((vecs + CPT - 1) / CPT);
  const size_t smem = 2 * (size_t)ty_n * C * sizeof(float);
  gn_bwd_partial_kernel<T, CPT><<<dim3(n_chunks, N), THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(coef),
      static_cast<float*>(partial), HW, C, (HW + n_chunks - 1) / n_chunks, silu);
}

template <typename T>
int bwd_partial_cpt(const void* x, const void* g, const void* coef, void* partial, int N, int HW, int C,
                    int n_chunks, int silu, cudaStream_t s) {
  int cpt, tx_n, ty_n;
  partial_layout(C / (16 / (int)sizeof(T)), &cpt, &tx_n, &ty_n);
  switch (cpt) {
    case 1: launch_bwd_partial<T, 1>(x, g, coef, partial, N, HW, C, n_chunks, silu, s); break;
    case 2: launch_bwd_partial<T, 2>(x, g, coef, partial, N, HW, C, n_chunks, silu, s); break;
    case 3: launch_bwd_partial<T, 3>(x, g, coef, partial, N, HW, C, n_chunks, silu, s); break;
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

// x, g: contiguous [N, HW, C] of one dtype (0 = fp32, 1 = bf16); coef: fp32
// [N, 4, C] (scale, shift, inv, -mean*inv); partial: fp32 scratch
// [N, n_chunks, 2, C]; out: fp32 [N, 2, C] (t1 = sum dz, t2 = sum dz*xhat).
extern "C" int uwu_gn_bwd_partials(const void* x, const void* g, const void* coef, void* partial, void* out,
                                   int dtype, int N, int HW, int C, int n_chunks, int silu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 1) {
    err = bwd_partial_cpt<__nv_bfloat16>(x, g, coef, partial, N, HW, C, n_chunks, silu, s);
  } else if (dtype == 0) {
    err = bwd_partial_cpt<float>(x, g, coef, partial, N, HW, C, n_chunks, silu, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return err;
  gn_bwd_merge_kernel<<<dim3((2 * C + THREADS - 1) / THREADS, N), THREADS, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), C, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// x, g, dx: contiguous [N, HW, C] of one dtype; coef: fp32 [N, 4, C]
// (scale, shift, P, Q): dx = scale*dz + P*x + Q.
extern "C" int uwu_gn_bwd_dx(const void* x, const void* g, const void* coef, void* dx, int dtype, int N, int HW,
                             int C, int silu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 1 ? 8 : 4;
  const long long per_sample = (long long)HW * C / vec;
  const long long total = per_sample * N;
  const long long want = (total + THREADS - 1) / THREADS;
  const int blocks = (int)(want < (long long)sm_count() * 16 ? want : (long long)sm_count() * 16);
  if (dtype == 1) {
    gn_bwd_dx_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
        static_cast<const float*>(coef), static_cast<__nv_bfloat16*>(dx), total, per_sample, C, silu);
  } else if (dtype == 0) {
    gn_bwd_dx_kernel<float><<<blocks, THREADS, 0, s>>>(static_cast<const float*>(x), static_cast<const float*>(g),
                                                       static_cast<const float*>(coef), static_cast<float*>(dx),
                                                       total, per_sample, C, silu);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
