// GroupNorm (+ SiLU) forward in one pass for Hopper (sm_90a): the tile of a
// (sample, channel slab) stays in the shared memory of one thread-block
// cluster while its statistics are taken, and x is read from device memory
// once and y written once.
//
// Replaces uwudiff_tpu/ops/groupnorm_silu.py::_gn_silu_kernel, the TPU's
// single-pass kernel that keeps one sample's [HW, C] tile resident in VMEM
// (1 read + 1 write). The Hopper counterpart of "the tile stays in VMEM":
//
//   work unit  (n, slab): a slab is a whole number of groups whose width is
//              a multiple of 16 bytes (a legal TMA box); one cluster of
//              `cluster` blocks per unit, block r holding rows
//              [r*R, (r+1)*R) of the slab (R = rows_per_cta) in shared memory.
//   load       TMA over a rank-3 map of x as [N, HW, C] (boxes of
//              [box_rows, slab], no swizzle: rows land row-major at the
//              slab's pitch), one mbarrier per box, so the first sums start
//              while later boxes are still in flight. Rows past HW are
//              zero-filled by TMA and skipped by every pass.
//   statistics two-pass, from shared memory: per-channel fp32 sums -> per-
//              group partials of the block -> exchanged across the cluster
//              through distributed shared memory (mapa + ld.shared::cluster
//              after barrier.cluster) and added in rank order, so every block
//              gets the same mean and the result is bitwise the same from run
//              to run; then the sum of (x - mean)^2 the same way. The data is
//              resident, so the variance costs no device-memory pass and has
//              none of E[x^2] - mean^2's cancellation.
//   apply      y = silu(x*scale + shift) (or the affine alone) in fp32, in
//              place in shared memory, then each box goes out by a TMA store
//              (rows past HW are clipped by the map).
//   affine     gamma/beta are read in their own dtype (fp32 or bf16) inside
//              the kernel; block 0 of each cluster writes the fp32 scale/shift
//              [N, C] and mean/inv [N, 2, G] that the autograd function saves,
//              when it is given somewhere to put them.
//
// What bounds it on an H100: bytes (2 bytes read + 2 written per bf16
// element, ~15 flops), far below the ridge; at small HW the launch and the
// cluster barriers. The plan (ops/groupnorm_silu.py::plan_gn) picks the
// cluster size so that a block's tile stays under TILE_TWO_PER_SM bytes
// where it can (two blocks an SM: one's stores overlap the other's loads)
// and the grid has a block for every SM; a tile that does not fit 16 blocks
// of TILE_MAX bytes takes the chunked pair (groupnorm_silu.cu) instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int MAX_BOX_ROWS = 256;      // a TMA box dim holds at most 256 elements
constexpr int MAX_BOXES = 64;          // boxes (and mbarriers) of one block
constexpr int MAX_SLAB = 256;          // channels of a slab: one box's inner dim
constexpr int MAX_SLAB_GROUPS = 8;     // groups of a slab: 16 bytes of channels at most
constexpr int MAX_CLUSTER = 16;        // 8 is portable; 16 needs the non-portable attribute
constexpr int TILE_MAX = 208896;       // 204 KB: the 227 KB a block may have, less the static buffers
constexpr int TILE_TWO_PER_SM = 92160;  // 90 KB: two blocks (and their static buffers) fit an SM's 228 KB
constexpr int TILE_ALIGN = 128;        // TMA's shared-memory alignment

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// silu(z): for a bf16 output as 0.5 z (1 + tanh(z/2)) with the SFU's
// tanh.approx (relative error ~2^-11, below bf16's 2^-8 step), one SFU
// operation instead of exp and a reciprocal; for fp32 as z / (1 + e^-z)
template <typename T>
__device__ __forceinline__ float silu_f(float z);
template <>
__device__ __forceinline__ float silu_f<float>(float z) { return __fdividef(z, 1.f + __expf(-z)); }
template <>
__device__ __forceinline__ float silu_f<__nv_bfloat16>(float z) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * z));
  return 0.5f * z * (1.f + t);
}

__device__ __forceinline__ float load_affine(const void* p, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// Sum this block's rows of the per-thread accumulators `acc` into the
// per-group partials `out[gps]`, in a fixed order: each row-thread's VEC
// channel sums go to red[ty][channel] (the first `rows` row-threads hold
// any); THREADS / slab threads per channel each add every S-th of those
// rows into seg[s][channel]; one thread per channel adds the segments, and
// one thread per group its channels.
template <int VEC>
__device__ __forceinline__ void block_group_sums(const float (&acc)[VEC], float* red, float* seg, float* chan,
                                                 float* out, int tx, int ty, int rows, int slab, int cg, int gps) {
  if (ty < rows) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[ty * slab + tx * VEC + e] = acc[e];
  }
  __syncthreads();
  const int segs = THREADS / slab;
  const int c = threadIdx.x % slab, s = threadIdx.x / slab;
  if (s < segs) {
    float a = 0.f;
    for (int t = s; t < rows; t += segs) a += red[t * slab + c];
    seg[s * slab + c] = a;
  }
  __syncthreads();
  if (threadIdx.x < slab) {
    float a = 0.f;
    for (int t = 0; t < segs; ++t) a += seg[t * slab + threadIdx.x];
    chan[threadIdx.x] = a;
  }
  __syncthreads();
  if (threadIdx.x < gps) {
    float a = 0.f;
    for (int k = threadIdx.x * cg; k < (threadIdx.x + 1) * cg; ++k) a += chan[k];
    out[threadIdx.x] = a;
  }
}

// every block of the cluster has written its partials `part[gps]`: one
// thread per (group, rank) reads them into `all[group][rank]`, then one
// thread per group adds them in rank order, so every block gets the same sum
__device__ __forceinline__ void cluster_group_sums(const float* part, float* all, float* total, uint32_t cs,
                                                   int gps) {
  hopper::cluster_arrive();
  hopper::cluster_wait();
  if (threadIdx.x < gps * cs) {
    const int g = threadIdx.x / cs, r = threadIdx.x % cs;
    all[g * MAX_CLUSTER + r] = hopper::ld_dsmem(&part[g], r);
  }
  __syncthreads();
  if (threadIdx.x < gps) {
    float a = 0.f;
    for (uint32_t r = 0; r < cs; ++r) a += all[threadIdx.x * MAX_CLUSTER + r];
    total[threadIdx.x] = a;
  }
  __syncthreads();
}

// grid (cluster * n_slabs, N), clusters of `cluster` along x; dynamic
// shared memory: the tile, rows_per_cta x slab elements (+ alignment).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    gn_silu_fused_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap y_map,
                         const void* __restrict__ gamma, const void* __restrict__ beta, int affine_bf16,
                         float* __restrict__ scale_out, float* __restrict__ shift_out, float* __restrict__ stats_out,
                         int HW, int C, int G, int slab, int cg, int rows_per_cta, int box_rows, float eps,
                         int silu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ uint8_t dyn[];
  __shared__ __align__(16) float red[THREADS * VEC];  // [rpi, slab] per-row-thread channel sums
  __shared__ float seg[THREADS], chan[MAX_SLAB], sc_s[MAX_SLAB], sh_s[MAX_SLAB];
  __shared__ float part_sum[MAX_SLAB_GROUPS], part_m2[MAX_SLAB_GROUPS];  // read by the whole cluster
  __shared__ float all[MAX_SLAB_GROUPS * MAX_CLUSTER], g_mean[MAX_SLAB_GROUPS], g_inv[MAX_SLAB_GROUPS];
  __shared__ __align__(8) uint64_t bars[MAX_BOXES];

  uint8_t* tile = reinterpret_cast<uint8_t*>(
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

  if (threadIdx.x == 0) {
    hopper::tma_prefetch_map(&x_map);
    for (int b = 0; b < n_boxes; ++b) hopper::mbar_init(&bars[b], 1);
    hopper::mbar_fence_init();
    for (int b = 0; b < n_boxes; ++b) {
      hopper::mbar_arrive_expect_tx(&bars[b], box_bytes);
      hopper::tma_load_3d(tile + b * box_bytes, &x_map, &bars[b], c0, row0 + b * box_rows, n);
    }
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them

  // thread layout: vpr 16-byte vectors a row, rpi rows at a time; a thread
  // stays on one vector column (VEC channels) throughout
  const int vpr = row_bytes / 16;
  const int rpi = THREADS / vpr;
  const int tx = threadIdx.x % vpr, ty = threadIdx.x / vpr;
  const bool active = ty < rpi;
  const int rows = min(rpi, valid);  // row-threads that hold any sum

  // pass 1: per-channel sums
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int b = 0; b < n_boxes; ++b) {
    hopper::mbar_wait(&bars[b], 0);
    const int r_end = min(box_rows, valid - b * box_rows);
    if (active) {
#pragma unroll 4
      for (int r = ty; r < r_end; r += rpi) {
        const uint4 raw = *reinterpret_cast<const uint4*>(tile + (b * box_rows + r) * row_bytes + tx * 16);
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += to_f(v[e]);
      }
    }
  }
  block_group_sums<VEC>(acc, red, seg, chan, part_sum, tx, ty, rows, slab, cg, gps);
  cluster_group_sums(part_sum, all, g_mean, cs, gps);
  const float count = (float)HW * (float)cg;
  if (threadIdx.x < gps) g_mean[threadIdx.x] /= count;
  __syncthreads();

  // pass 2: per-channel sums of (x - mean)^2 over the same rows
  float mu[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    mu[e] = active ? g_mean[(tx * VEC + e) / cg] : 0.f;
    acc[e] = 0.f;
  }
  if (active) {
#pragma unroll 4
    for (int r = ty; r < valid; r += rpi) {
      const uint4 raw = *reinterpret_cast<const uint4*>(tile + r * row_bytes + tx * 16);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = to_f(v[e]) - mu[e];
        acc[e] = fmaf(d, d, acc[e]);
      }
    }
  }
  block_group_sums<VEC>(acc, red, seg, chan, part_m2, tx, ty, rows, slab, cg, gps);
  cluster_group_sums(part_m2, all, g_inv, cs, gps);
  if (threadIdx.x < gps) {
    const float inv = 1.f / sqrtf(g_inv[threadIdx.x] / count + eps);
    g_inv[threadIdx.x] = inv;
    if (rank == 0 && stats_out != nullptr) {  // [N, 2, G]: mean, inv
      const int g = c0 / cg + threadIdx.x;
      stats_out[(long long)n * 2 * G + g] = g_mean[threadIdx.x];
      stats_out[(long long)n * 2 * G + G + g] = inv;
    }
  }
  __syncthreads();
  // this block reads no other block's shared memory from here on; it must
  // not exit before the others are done reading its partials (the wait at
  // the end)
  hopper::cluster_arrive();

  if (threadIdx.x < slab) {
    const int c = c0 + threadIdx.x;
    const int g = threadIdx.x / cg;
    const float sc = g_inv[g] * load_affine(gamma, c, affine_bf16);
    const float sh = load_affine(beta, c, affine_bf16) - g_mean[g] * sc;
    sc_s[threadIdx.x] = sc;
    sh_s[threadIdx.x] = sh;
    if (rank == 0 && scale_out != nullptr) {
      scale_out[(long long)n * C + c] = sc;
      shift_out[(long long)n * C + c] = sh;
    }
  }
  __syncthreads();

  // apply in place, box by box; each box leaves by a TMA store as soon as
  // every thread has written it
  float sc[VEC], sh[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    sc[e] = active ? sc_s[tx * VEC + e] : 0.f;
    sh[e] = active ? sh_s[tx * VEC + e] : 0.f;
  }
  for (int b = 0; b < n_boxes; ++b) {
    const int r_end = min(box_rows, valid - b * box_rows);
    if (active) {
#pragma unroll 4
      for (int r = ty; r < r_end; r += rpi) {
        uint4* p = reinterpret_cast<uint4*>(tile + (b * box_rows + r) * row_bytes + tx * 16);
        uint4 raw = *p;
        T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float z = fmaf(to_f(v[e]), sc[e], sh[e]);
          if (silu) z = silu_f<T>(z);
          v[e] = from_f<T>(z);
        }
        *p = raw;
      }
    }
    hopper::fence_proxy_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) hopper::tma_store_3d(&y_map, tile + b * box_bytes, c0, row0 + b * box_rows, n);
  }
  if (threadIdx.x == 0) {
    hopper::bulk_commit();
    hopper::bulk_wait_read();
  }
  hopper::cluster_wait();
}

template <typename T>
int launch_fused(const CUtensorMap& x_map, const CUtensorMap& y_map, const void* gamma, const void* beta,
                 int affine_bf16, float* scale, float* shift, float* stats, int N, int HW, int C, int G, int slab,
                 int cg, int cluster, int rows_per_cta, int box_rows, float eps, int silu, cudaStream_t s) {
  auto kernel = gn_silu_fused_kernel<T>;
  const int tile_bytes = rows_per_cta * slab * (int)sizeof(T);
  const int smem = tile_bytes + TILE_ALIGN;
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
  err = cudaLaunchKernelEx(&cfg, kernel, x_map, y_map, gamma, beta, affine_bf16, scale, shift, stats, HW, C, G,
                           slab, cg, rows_per_cta, box_rows, eps, silu);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: contiguous [N, HW, C] (dtype 0 = fp32, 1 = bf16); gamma/beta [C] in
// fp32 (affine_bf16 = 0) or bf16 (1); scale/shift: null or fp32 [N, C]
// outputs; stats: null or an fp32 [N, 2, G] output (per-group mean, inv).
// spec: the rank-3 map geometry of x and y (hopper::encode_dense3), from
// the plan: box (slab, box_rows, 1). Returns a cudaError_t, or
// hopper::ENCODE_FAILED + the CUresult when the driver refuses a map.
extern "C" int uwu_gn_silu_fused(const void* x, void* y, const void* gamma, const void* beta, void* scale,
                                 void* shift, void* stats, const unsigned long long* spec, int dtype,
                                 int affine_bf16, int N, int HW, int C, int G, int slab, int cluster,
                                 int rows_per_cta, int box_rows, float eps, int silu, void* stream) {
  const int es = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || C % G || slab <= 0 || C % slab || slab % (C / G) || slab > MAX_SLAB ||
      (slab * es) % 16 || slab / (C / G) > MAX_SLAB_GROUPS || cluster < 1 || cluster > MAX_CLUSTER ||
      box_rows < 8 || box_rows > MAX_BOX_ROWS || box_rows % 8 || rows_per_cta % box_rows ||
      rows_per_cta / box_rows > MAX_BOXES || (long long)rows_per_cta * cluster < HW ||
      rows_per_cta * slab * es > TILE_MAX || (long long)spec[5] != slab || (long long)spec[6] != box_rows ||
      spec[7] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType map_type = dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap x_map, y_map;
  int rc = hopper::encode_dense3(&x_map, x, map_type, spec);
  if (rc != 0) return rc;
  rc = hopper::encode_dense3(&y_map, y, map_type, spec);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scale);
  float* sh = static_cast<float*>(shift);
  float* st = static_cast<float*>(stats);
  if (dtype == 1)
    return launch_fused<__nv_bfloat16>(x_map, y_map, gamma, beta, affine_bf16, sc, sh, st, N, HW, C, G, slab, C / G,
                                       cluster, rows_per_cta, box_rows, eps, silu, s);
  return launch_fused<float>(x_map, y_map, gamma, beta, affine_bf16, sc, sh, st, N, HW, C, G, slab, C / G, cluster,
                             rows_per_cta, box_rows, eps, silu, s);
}
