// GroupNorm (+ SiLU) backward in one pass for Hopper (sm_90a): the x and dy
// tiles of a (sample, channel slab) stay in the shared memory of one
// thread-block cluster while the two per-channel sums and the group means
// of the backward are taken, and x and dy are read from device memory once
// and dx written once.
//
// Replaces uwudiff_tpu/ops/groupnorm_silu.py::_gn_bwd_partials_kernel (K7,
// per-(n, channel) t1 = sum_hw dz and t2 = sum_hw dz*xhat) and
// ::_gn_bwd_dx_kernel (K8, dx = inv*(gamma*dz - a - xhat*b)), and the XLA
// glue between them (the group means a, b): on the TPU three passes over x
// and two over dy around [N, C] glue; here one launch.
//
//   inputs     the forward's saved statistics: fp32 scale = inv*gamma and
//              shift = beta - mean*scale [N, C] (so z = x*scale + shift),
//              and the per-group mean and inv [N, G] (rows `stat_stride`
//              apart); gamma in its own dtype. Each block reads its slab's
//              once.
//   work unit  (n, slab), as the forward's (groupnorm_silu_sm90.cu): a slab
//              is a whole number of groups whose width is a multiple of 16
//              bytes; one cluster of `cluster` blocks per unit, block r
//              holding rows [r*R, (r+1)*R) of x and of dy (R = rows_per_cta).
//   load       TMA over rank-3 maps of x and dy as [N, HW, C] (boxes of
//              [box_rows, slab], no swizzle), one mbarrier per box for the
//              pair, so the sums start while later boxes are in flight. Rows
//              past HW are zero-filled and skipped.
//   sums       dz = dy*silu'(z) (dz = dy without SiLU); per-channel
//              t1 = sum dz, t2 = sum dz*xhat (xhat = x*inv - mean*inv) in a
//              fixed order: per-thread sums, then row segments, then
//              channels; the blocks' per-channel sums go through distributed
//              shared memory and are added in rank order, so every block of
//              the cluster has the same t1, t2 (and group means) and the
//              result is bitwise the same from run to run. No atomics.
//   means      a_g = sum_{c in g} gamma_c t1_c / m, b_g = sum gamma_c t2_c / m
//              (m = HW * channels of a group), folded per channel into
//              dx = scale*dz + P*x + Q with P = -inv^2 b, Q = -inv (a + b*(-mean*inv)).
//   dx         from the resident tiles, written in place over the x tile and
//              stored box by box by TMA (rows past HW are clipped by the map).
//   outputs    dx; block 0 of each cluster writes t1, t2 as fp32 [N, 2, C]
//              (dbeta = sum_n t1 and dgamma = sum_n t2 are one small
//              reduction in the wrapper's caller).
//
// What bounds it on an H100: bytes in principle (2 + 2 bytes read and 2
// written per bf16 element against ~20 flops and two SFU operations, far
// below the ridge); in practice the chain of phases inside a block (the
// tiles' arrival, the sums pass, the block and cluster sums, the dx pass and
// its stores: ~16-18 us a block at [8,4096,320], timed on the card), which
// only the other block sharing the SM overlaps. 512 threads of 8 bytes each
// (64 registers, two blocks an SM) keep twice the warps of 256 x 16 bytes in
// those phases. In the sums pass the sigmoid is exact (__expf and a fast
// divide: the sums feed dgamma, dbeta and every dx of a group); in the dx
// pass, for a bf16 output, it is 0.5 (1 + tanh(z/2)) with the SFU's
// tanh.approx (one operation, absolute error below 2^-12, an eighth of
// bf16's step at the largest dx). The plan (ops/groupnorm_silu.py::
// plan_gn_bwd) applies the forward's cluster rules to the two tiles
// together: under TILE_TWO_PER_SM two blocks share an SM; a pair of tiles
// that does not fit 16 blocks of TILE_MAX bytes, or a multi-wave grid of
// tiles over TILE_TWO_PER_SM, takes the chunked pair (groupnorm_silu.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int THREAD_BYTES = 8;      // bytes of a row (of x, and of dy) a thread takes at a time
constexpr int MAX_BOX_ROWS = 256;      // a TMA box dim holds at most 256 elements
constexpr int MAX_BOXES = 64;          // boxes (and mbarriers) of one block
constexpr int MAX_SLAB = 256;          // channels of a slab: one box's inner dim
constexpr int MAX_SLAB_GROUPS = 8;     // groups of a slab
constexpr int MAX_CLUSTER = 16;        // 8 is portable; 16 needs the non-portable attribute
constexpr int TILE_MAX = 208896;       // 204 KB: both tiles, the 227 KB a block may have less the static buffers
constexpr int TILE_TWO_PER_SM = 92160;  // 90 KB: two blocks (and their static buffers) fit an SM's 228 KB
constexpr int TILE_ALIGN = 128;        // TMA's shared-memory alignment
constexpr int SEG = 512;               // row-segment sums: at least THREADS and 2 * MAX_SLAB
static_assert(SEG >= THREADS && SEG >= 2 * MAX_SLAB, "the row segments hold every value of a slab");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float load_affine(const void* p, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// dz of y = silu(z), z = x*sc + sh: g * s * (1 + z (1 - s)), s = sigmoid(z)
__device__ __forceinline__ float silu_dz_exact(float x, float g, float sc, float sh) {
  const float z = fmaf(x, sc, sh);
  const float s = __fdividef(1.f, 1.f + __expf(-z));
  return g * s * fmaf(z, 1.f - s, 1.f);
}

// the same for the dx pass: for a bf16 output the sigmoid is 0.5 (1 + tanh(z/2))
template <typename T>
__device__ __forceinline__ float silu_dz_out(float x, float g, float sc, float sh);
template <>
__device__ __forceinline__ float silu_dz_out<float>(float x, float g, float sc, float sh) {
  return silu_dz_exact(x, g, sc, sh);
}
template <>
__device__ __forceinline__ float silu_dz_out<__nv_bfloat16>(float x, float g, float sc, float sh) {
  const float z = fmaf(x, sc, sh);
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * z));
  const float s = fmaf(0.5f, t, 0.5f);
  return g * s * fmaf(z, 1.f - s, 1.f);
}

// Sum this block's rows of the per-thread accumulators (t1, t2 of VEC
// channels) into out[2][slab] in a fixed order: each row-thread's sums go
// to red[ty][2][slab] (the first `rows` row-threads hold any); THREADS /
// (2 slab) threads per value (at least one) each add every S-th of those
// rows into seg[s][value]; one thread per value adds the segments. `out`
// may be `red` itself: every read of red is done before the first write.
template <int VEC>
__device__ __forceinline__ void block_channel_sums(const float (&t1)[VEC], const float (&t2)[VEC], float* red,
                                                   float* seg, float* out, int tx, int ty, int rows, int slab) {
  const int vals = 2 * slab;
  if (ty < rows) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      red[ty * vals + tx * VEC + e] = t1[e];
      red[ty * vals + slab + tx * VEC + e] = t2[e];
    }
  }
  __syncthreads();
  const int segs = max(1, THREADS / vals);
  for (int j = threadIdx.x; j < segs * vals; j += THREADS) {
    const int i = j % vals, s = j / vals;
    float a = 0.f;
    for (int t = s; t < rows; t += segs) a += red[t * vals + i];
    seg[j] = a;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < vals; i += THREADS) {
    float a = 0.f;
    for (int s = 0; s < segs; ++s) a += seg[s * vals + i];
    out[i] = a;
  }
}

// grid (cluster * n_slabs, N), clusters of `cluster` along x; dynamic shared
// memory: the x tile then the dy tile, rows_per_cta x slab elements each
// (+ alignment).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    gn_silu_bwd_fused_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap g_map,
                             const __grid_constant__ CUtensorMap dx_map, const void* __restrict__ gamma,
                             int affine_bf16, const float* __restrict__ scale, const float* __restrict__ shift,
                             const float* __restrict__ mean, const float* __restrict__ inv, int stat_stride,
                             float* __restrict__ t_out, int HW, int C, int slab, int cg, int rows_per_cta,
                             int box_rows, int silu) {
  constexpr int VEC = THREAD_BYTES / sizeof(T);
  extern __shared__ uint8_t dyn[];
  // [rows][2][slab] per-row-thread sums; then this block's t1, t2 [2][slab],
  // which the whole cluster reads
  __shared__ __align__(16) float red[THREADS * VEC * 2];
  __shared__ float seg[SEG];  // row-segment sums; then the cluster's t1, t2 [2][slab]
  // per channel: scale then gamma, shift, inv then P, -mean*inv then Q
  __shared__ float sc_s[MAX_SLAB], sh_s[MAX_SLAB], p_s[MAX_SLAB], q_s[MAX_SLAB];
  __shared__ float ab[2 * MAX_SLAB_GROUPS];  // per group: a, then b
  __shared__ __align__(8) uint64_t bars[MAX_BOXES];

  uint8_t* xt = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dyn) + TILE_ALIGN - 1) & ~static_cast<uintptr_t>(TILE_ALIGN - 1));
  const uint32_t cs = hopper::cluster_nctarank();
  const uint32_t rank = hopper::cluster_ctarank();
  const int n = blockIdx.y;
  const int c0 = (blockIdx.x / cs) * slab;
  const int gps = slab / cg;
  const int row0 = rank * rows_per_cta;
  const int valid = max(0, min(rows_per_cta, HW - row0));
  const int n_boxes = (valid + box_rows - 1) / box_rows;
  const int row_bytes = slab * (int)sizeof(T);
  const int box_bytes = box_rows * row_bytes;
  uint8_t* gt = xt + rows_per_cta * row_bytes;  // 128-byte aligned: rows_per_cta % 8 == 0, row_bytes % 16 == 0

  if (threadIdx.x == 0) {
    hopper::tma_prefetch_map(&x_map);
    hopper::tma_prefetch_map(&g_map);
    for (int b = 0; b < n_boxes; ++b) hopper::mbar_init(&bars[b], 1);
    hopper::mbar_fence_init();
    for (int b = 0; b < n_boxes; ++b) {
      hopper::mbar_arrive_expect_tx(&bars[b], 2 * box_bytes);
      hopper::tma_load_3d(xt + b * box_bytes, &x_map, &bars[b], c0, row0 + b * box_rows, n);
      hopper::tma_load_3d(gt + b * box_bytes, &g_map, &bars[b], c0, row0 + b * box_rows, n);
    }
  }
  // the slab's per-channel coefficients while the boxes are in flight
  float gm = 0.f;  // gamma of channel threadIdx.x, kept for the group means
  if (threadIdx.x < slab) {
    const int c = c0 + threadIdx.x;
    const long long s = (long long)n * stat_stride + c / cg;
    const float iv = inv[s];
    gm = load_affine(gamma, c, affine_bf16);
    sc_s[threadIdx.x] = scale[(long long)n * C + c];
    sh_s[threadIdx.x] = shift[(long long)n * C + c];
    p_s[threadIdx.x] = iv;
    q_s[threadIdx.x] = -mean[s] * iv;
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them

  // thread layout: vpr 8-byte vectors a row, rpi rows at a time; a thread
  // stays on one vector column (VEC channels) throughout
  const int vpr = row_bytes / THREAD_BYTES;
  const int rpi = THREADS / vpr;
  const int tx = threadIdx.x % vpr, ty = threadIdx.x / vpr;
  const bool active = ty < rpi;
  const int rows = min(rpi, valid);  // row-threads that hold any sum
  const int k0 = active ? tx * VEC : 0;

  // pass 1: t1 = sum dz, t2 = sum dz*xhat per channel
  float sc[VEC], sh[VEC], iv[VEC], nm[VEC], t1[VEC], t2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    sc[e] = sc_s[k0 + e];
    sh[e] = sh_s[k0 + e];
    iv[e] = p_s[k0 + e];
    nm[e] = q_s[k0 + e];
    t1[e] = t2[e] = 0.f;
  }
  for (int b = 0; b < n_boxes; ++b) {
    hopper::mbar_wait(&bars[b], 0);
    const int r_end = min(box_rows, valid - b * box_rows);
    if (active) {
#pragma unroll 4
      for (int r = ty; r < r_end; r += rpi) {
        const int off = (b * box_rows + r) * row_bytes + tx * THREAD_BYTES;
        const uint2 xr = *reinterpret_cast<const uint2*>(xt + off);
        const uint2 gr = *reinterpret_cast<const uint2*>(gt + off);
        const T* xv = reinterpret_cast<const T*>(&xr);
        const T* gv = reinterpret_cast<const T*>(&gr);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xf = to_f(xv[e]), gf = to_f(gv[e]);
          const float dz = silu ? silu_dz_exact(xf, gf, sc[e], sh[e]) : gf;
          t1[e] += dz;
          t2[e] = fmaf(dz, fmaf(xf, iv[e], nm[e]), t2[e]);
        }
      }
    }
  }
  block_channel_sums<VEC>(t1, t2, red, seg, red, tx, ty, rows, slab);
  if (threadIdx.x < slab) sc_s[threadIdx.x] = gm;  // every thread has read its scale (the sums' barriers)

  // the cluster's sums: every block adds every block's [2][slab] in rank order
  hopper::cluster_arrive();
  hopper::cluster_wait();
  for (int i = threadIdx.x; i < 2 * slab; i += THREADS) {
    float a = 0.f;
    for (uint32_t r = 0; r < cs; ++r) a += hopper::ld_dsmem(&red[i], r);
    seg[i] = a;
  }
  __syncthreads();
  // this block reads no other block's shared memory from here on; it must
  // not exit before the others are done reading its sums (the wait at the end)
  hopper::cluster_arrive();

  if (threadIdx.x < gps) {
    float a = 0.f, b = 0.f;
    for (int k = threadIdx.x * cg; k < (threadIdx.x + 1) * cg; ++k) {
      a = fmaf(sc_s[k], seg[k], a);
      b = fmaf(sc_s[k], seg[slab + k], b);
    }
    const float m = (float)HW * (float)cg;
    ab[threadIdx.x] = a / m;
    ab[MAX_SLAB_GROUPS + threadIdx.x] = b / m;
  }
  if (rank == 0) {  // [N, 2, C]: t1, t2
    for (int i = threadIdx.x; i < 2 * slab; i += THREADS)
      t_out[((long long)n * 2 + i / slab) * C + c0 + i % slab] = seg[i];
  }
  __syncthreads();
  if (threadIdx.x < slab) {
    const int g = threadIdx.x / cg;
    const float ivc = p_s[threadIdx.x], nmc = q_s[threadIdx.x];
    const float a = ab[g], b = ab[MAX_SLAB_GROUPS + g];
    p_s[threadIdx.x] = -ivc * ivc * b;
    q_s[threadIdx.x] = -ivc * fmaf(b, nmc, a);
  }
  __syncthreads();

  // pass 2: dx = scale*dz + P*x + Q in place over the x tile; each box
  // leaves by a TMA store as soon as every thread has written it
  float pc[VEC], qc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    pc[e] = p_s[k0 + e];
    qc[e] = q_s[k0 + e];
  }
  for (int b = 0; b < n_boxes; ++b) {
    const int r_end = min(box_rows, valid - b * box_rows);
    if (active) {
#pragma unroll 4
      for (int r = ty; r < r_end; r += rpi) {
        const int off = (b * box_rows + r) * row_bytes + tx * THREAD_BYTES;
        uint2* px = reinterpret_cast<uint2*>(xt + off);
        uint2 xr = *px;
        const uint2 gr = *reinterpret_cast<const uint2*>(gt + off);
        T* xv = reinterpret_cast<T*>(&xr);
        const T* gv = reinterpret_cast<const T*>(&gr);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xf = to_f(xv[e]), gf = to_f(gv[e]);
          const float dz = silu ? silu_dz_out<T>(xf, gf, sc[e], sh[e]) : gf;
          xv[e] = from_f<T>(fmaf(sc[e], dz, fmaf(pc[e], xf, qc[e])));
        }
        *px = xr;
      }
    }
    hopper::fence_proxy_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) hopper::tma_store_3d(&dx_map, xt + b * box_bytes, c0, row0 + b * box_rows, n);
  }
  if (threadIdx.x == 0) {
    hopper::bulk_commit();
    hopper::bulk_wait_read();
  }
  hopper::cluster_wait();
}

template <typename T>
int launch_bwd_fused(const CUtensorMap& x_map, const CUtensorMap& g_map, const CUtensorMap& dx_map,
                     const void* gamma, int affine_bf16, const float* scale, const float* shift, const float* mean,
                     const float* inv, int stat_stride, float* t, int N, int HW, int C, int slab, int cg,
                     int cluster, int rows_per_cta, int box_rows, int silu, cudaStream_t s) {
  auto kernel = gn_silu_bwd_fused_kernel<T>;
  const int smem = 2 * rows_per_cta * slab * (int)sizeof(T) + TILE_ALIGN;
  static int smem_set = 0;  // per instantiation
  static bool nonportable_set = false;
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  if (cluster > 8 && !nonportable_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    nonportable_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * (C / slab), N, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x_map, g_map, dx_map, gamma, affine_bf16, scale, shift, mean, inv,
                           stat_stride, t, HW, C, slab, cg, rows_per_cta, box_rows, silu);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, g (the incoming gradient), dx: contiguous [N, HW, C] of one dtype
// (0 = fp32, 1 = bf16); gamma [C] in fp32 (affine_bf16 = 0) or bf16 (1);
// scale, shift: fp32 [N, C] (the forward's z = x*scale + shift); mean, inv:
// fp32 [N, G] rows `stat_stride` elements apart; t: an fp32 [N, 2, C]
// output (t1 = sum_hw dz, t2 = sum_hw dz*xhat). spec: the rank-3 map
// geometry of x, g and dx (hopper::encode_dense3), from the plan: box
// (slab, box_rows, 1). Returns a cudaError_t, or hopper::ENCODE_FAILED +
// the CUresult when the driver refuses a map.
extern "C" int uwu_gn_silu_bwd_fused(const void* x, const void* g, void* dx, const void* gamma, const void* scale,
                                     const void* shift, const void* mean, const void* inv, void* t,
                                     const unsigned long long* spec, int dtype, int affine_bf16, int N, int HW, int C,
                                     int G, int stat_stride, int slab, int cluster, int rows_per_cta, int box_rows,
                                     int silu, void* stream) {
  const int es = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || C % G || slab <= 0 || C % slab || slab % (C / G) || slab > MAX_SLAB ||
      (slab * es) % 16 || slab / (C / G) > MAX_SLAB_GROUPS || cluster < 1 || cluster > MAX_CLUSTER ||
      box_rows < 8 || box_rows > MAX_BOX_ROWS || box_rows % 8 || rows_per_cta % box_rows ||
      rows_per_cta / box_rows > MAX_BOXES || (long long)rows_per_cta * cluster < HW ||
      2 * rows_per_cta * slab * es > TILE_MAX || stat_stride < G || (long long)spec[5] != slab ||
      (long long)spec[6] != box_rows || spec[7] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType map_type = dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap x_map, g_map, dx_map;
  int rc = hopper::encode_dense3(&x_map, x, map_type, spec);
  if (rc != 0) return rc;
  rc = hopper::encode_dense3(&g_map, g, map_type, spec);
  if (rc != 0) return rc;
  rc = hopper::encode_dense3(&dx_map, dx, map_type, spec);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* mu = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  float* tt = static_cast<float*>(t);
  if (dtype == 1)
    return launch_bwd_fused<__nv_bfloat16>(x_map, g_map, dx_map, gamma, affine_bf16, sc, sh, mu, iv, stat_stride, tt,
                                           N, HW, C, slab, C / G, cluster, rows_per_cta, box_rows, silu, s);
  return launch_bwd_fused<float>(x_map, g_map, dx_map, gamma, affine_bf16, sc, sh, mu, iv, stat_stride, tt, N, HW, C,
                                 slab, C / G, cluster, rows_per_cta, box_rows, silu, s);
}
