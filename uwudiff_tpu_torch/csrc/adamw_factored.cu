// The training step's whole parameter update for Hopper (sm_90a): the global
// gradient norm and clip, adamw_factored (Adafactor's factored second moment,
// the per-leaf update-RMS clip, the bf16 momentum, lr-scaled weight decay),
// the stochastically rounded bf16 parameter update and the weight EMA, over
// every leaf of the model at once, in a fixed handful of launches (O1); and
// adamw_fp16 (O2: bf16 moments, fp32 master parameters and their bf16
// working copy), the global norm's kernel followed by one elementwise pass.
//
// Replaces no Pallas kernel: the JAX step (uwudiff_tpu/training/trainer.py
// _train_step_impl) runs optax's chain (uwudiff_tpu/training/optimizers.py:48,
// adamw_factored; :136, adamw_fp16_state) inside one jit, where XLA fuses it.
// The plain version is uwudiff_tpu_torch/training/optimizers.py::apply_update_
// (AdamWFactored._leaf or AdamWFP16.update leaf by leaf); this file repeats
// its arithmetic stage for stage, each fp32
// operation correctly rounded and never contracted into an fma (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), each stage rounded to the parameter
// dtype where the plain version rounds it. Only the order of the sums differs.
//
// Multi-tensor layout (ops/fused_optim.py builds it once, resident on the
// device): a table of leaves, and one flat space of tiles over all of them.
//   factored leaf  viewed as [K, slow, fast] by its element strides: the
//                  factored axes d1 (rows, R) and d0 (columns, C), one of them
//                  contiguous (the fast axis, F elements) and the other the
//                  slow one (S); the leaf's other axes merged into K (a 3x3
//                  conv's kernel taps). A tile is 64 slow rows by one warp's
//                  width of 16-byte vectors along the fast axis, for one k:
//                  channels_last conv weights and transposed Linear weights
//                  are walked in their own memory order.
//   dense leaf     (1-D, or a second axis below min_dim_size_to_factor):
//                  flat tiles of DENSE_TILE elements.
// Only the gradient pointers change from step to step (with the optional
// given rounding bits and the EMA tensors): one small copy a step.
//
// Passes, one launch each:
//   adamw_norm   (with a global-norm clip only) per-tile sums of g^2; the
//                last tile of a leaf takes its norm, the last leaf the
//                global norm, which the clip needs before g^2 is taken.
//   adamw_stats  g (clipped), gsq = g*g + eps in the param dtype; per tile
//                the fast-axis sums of gsq for each slow row and the slow-axis
//                sums for each fast column, written as partials; dense leaves
//                update v in place; without a clip, also the norm's partials.
//   adamw_finish each row or column statistic merges its partials in a fixed
//                order -> the mean -> v_row / v_col with beta2, the column
//                factor; the last block of a leaf takes the row means and the
//                row factors (and the leaf's norm, and the last leaf the
//                global norm).
//   adamw_rms    (with clipping_threshold) per-tile sums of u^2; the last
//                tile of a leaf takes max(rms / threshold, 1).
//   adamw_apply  u, its clip, lr, the momentum, weight decay, p + u rounded
//                stochastically (bf16) and the EMA, element by element.
//   adamw_fp16_apply (O2, after adamw_norm; every leaf dense) the clip, both
//                moments through fp32 (stored bf16, rounded to nearest),
//                -lr * sqrt(1 - b2^t) * m / (sqrt(v) + eps), the leaf's
//                accumulated weight decay, p + u into the fp32 master and its
//                bf16 working copy, element by element: 20 bytes a parameter.
// No float atomics: every sum is per-tile partials merged in a fixed order,
// and the "last block" of a leaf is found with an integer counter that the
// same block resets, so two runs are bitwise equal.
//
// Stochastic-rounding bits: a pure function of (seed, step, leaf, stream,
// element offset), splitmix64 as training/optimizers.py::draw_sr_bits draws
// them, or read from given int32 tensors laid out like the parameter.
//
// What bounds it on an H100: bytes. A bf16 step with the RMS clip reads g
// three times (stats, rms, apply), p and the momentum once, and writes p and
// the momentum: 14 bytes a parameter, ~3 flops a byte. The design reads and
// writes 16 bytes a thread along the contiguous axis, keeps every statistic
// in small fp32 buffers that stay in L2, and launches one block per tile so
// that ~157k tiles keep every SM busy whatever the leaf sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_SLOW = 64;                     // slow rows of a factored tile
constexpr int ROWS = TILE_SLOW / WARPS;           // of them, one warp's
constexpr int DENSE_PER_THREAD = 32;
constexpr int DENSE_TILE = THREADS * DENSE_PER_THREAD;
constexpr int STAT_TILE = THREADS;                // finish: statistics a block

enum Flag : long long { CLIP = 1, RMS = 2, WD = 4, EMA = 8, NORM_IN_STATS = 16 };

constexpr unsigned long long GOLDEN = 0x9E3779B97F4A7C15ull;

// ops/fused_optim.py::LEAF_FIELDS, one 64-bit word each, in this order
struct Leaf {
  long long p, mu, v_a, v_b, rf, cf, row_mean;  // device addresses (v_a: v or v_row; v_b: v_col)
  long long numel, factored, K, S, F, sk, ss, fast_is_c, R, C;
  long long tile0, n_tiles, n_ts, n_tf, stat0, n_stat, part_f, part_s;
};
constexpr int LEAF_WORDS = sizeof(Leaf) / sizeof(long long);

// ops/fused_optim.py::_Args
struct Args {
  const Leaf* leaves;
  const long long* ptrs;  // [n_leaves][4]: grad, given param bits, given EMA bits (0: drawn), EMA tensor
  const int* tile_leaf;
  const int* stat_leaf;
  float* part_f;
  float* part_s;
  float* tile_sq;
  float* tile_u2;
  float* leaf_norm;
  float* leaf_denom;
  unsigned int* counters;  // [n_leaves + 1], zeros; every pass leaves them zero
  float* out;              // [1]: the global gradient norm
  const float* decay;      // [n_leaves]: adamw_fp16's weight decay this step (0 where it does not fire)
  long long n_leaves;
  long long flags;
  unsigned long long seed, step;
  // adamw_fp16 reads eps, b2, omb2, c_u (1 - b1), c_m (b1), clip and step_size
  // (-lr * sqrt(1 - b2^t)), all fp32 as optax's update computes them
  float eps, b2, omb2, lr, c_u, c_m, lrwd, thr, clip, ema_dw, ema_c, step_size;
};

template <typename T>
struct Vec;  // elements of one 16-byte vector
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
// x rounded to T, as a float (torch's .to(dtype))
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }
__device__ __forceinline__ float rsqrt_rn(float x) { return __fdiv_rn(1.0f, __fsqrt_rn(x)); }

// N elements of T at p[e] (16-byte aligned) -> floats
template <typename T, int N>
__device__ __forceinline__ void load(const T* p, long long e, float (&v)[N]) {
  static_assert(N * sizeof(T) == 16 || N * sizeof(T) == 8, "one 8- or 16-byte vector");
  if constexpr (N * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + e);
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = to_f(x[j]);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p + e);
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = to_f(x[j]);
  }
}

// one tile row's vectors of g, 16 raw bytes a thread each (zeros where the
// row or the column lies past the leaf), all in flight before any math
template <typename T>
__device__ __forceinline__ void preload(const T* g, const Leaf& L, long long k, long long s0, long long f0,
                                        uint4 (&raw)[ROWS]) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const long long s = s0 + i;
    raw[i] = (f0 < L.F && s < L.S) ? *reinterpret_cast<const uint4*>(g + k * L.sk + s * L.ss + f0)
                                   : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int N>
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[N]) {
  static_assert(N * sizeof(T) == 16, "one 16-byte vector");
  const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = to_f(x[j]);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, long long e, const float (&v)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    uint4 raw;
    T* x = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = from_f<T>(v[j]);
    *reinterpret_cast<uint4*>(p + e) = raw;
  } else {
    uint2 raw;
    T* x = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = from_f<T>(v[j]);
    *reinterpret_cast<uint2*>(p + e) = raw;
  }
}

// ------------------------------------------------------- rounding bits

__host__ __device__ __forceinline__ unsigned long long mix64(unsigned long long z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// training/optimizers.py::sr_key
__device__ __forceinline__ unsigned long long leaf_key(const Args& a, long long leaf, unsigned long long stream) {
  unsigned long long z = 0;
  z = mix64((z ^ a.seed) + GOLDEN);
  z = mix64((z ^ a.step) + GOLDEN);
  z = mix64((z ^ static_cast<unsigned long long>(leaf)) + GOLDEN);
  return mix64((z ^ stream) + GOLDEN);
}

// the 16 bits of element e: 16-bit slice e % 4 of splitmix64's output e / 4
__device__ __forceinline__ unsigned drawn_bits(unsigned long long key, long long e) {
  const unsigned long long h = mix64(key + static_cast<unsigned long long>(e / 4 + 1) * GOLDEN);
  return static_cast<unsigned>(h >> (16 * (e & 3))) & 0xFFFFu;
}

// N elements from e0 (a multiple of 4): drawn, or read from a given int32 tensor
template <int N>
__device__ __forceinline__ void bits_of(unsigned long long key, const int* given, long long e0, unsigned (&b)[N]) {
  if (given) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const int4 raw = *reinterpret_cast<const int4*>(given + e0 + 4 * q);
      b[4 * q] = raw.x & 0xFFFF;
      b[4 * q + 1] = raw.y & 0xFFFF;
      b[4 * q + 2] = raw.z & 0xFFFF;
      b[4 * q + 3] = raw.w & 0xFFFF;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const unsigned long long h = mix64(key + static_cast<unsigned long long>(e0 / 4 + q + 1) * GOLDEN);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[4 * q + j] = static_cast<unsigned>(h >> (16 * j)) & 0xFFFFu;
  }
}

// training/optimizers.py::stochastic_round_add on x = param + update
__device__ __forceinline__ float sr_round(float x, unsigned bits) {
  return __uint_as_float((__float_as_uint(x) + bits) & 0xFFFF0000u);
}

// ------------------------------------------------------------ block sums

// the same value in every lane: each butterfly level adds the same pair
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's sum in every thread, in a fixed order
__device__ __forceinline__ float block_sum(float v, float* sh) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += sh[w];
  return t;
}

// the calling block is the last of `total` to arrive at `*count`; the count
// is reset for the next pass when it is
__device__ __forceinline__ bool last_to_arrive(unsigned int* count, long long total) {
  __shared__ unsigned int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(count, 1u) == static_cast<unsigned int>(total - 1);
    if (last) *count = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ void load_leaf(const Args& a, int li, Leaf* L) {
  if (threadIdx.x < LEAF_WORDS)
    reinterpret_cast<long long*>(L)[threadIdx.x] = reinterpret_cast<const long long*>(a.leaves + li)[threadIdx.x];
  __syncthreads();
}

// ------------------------------------------------------------ elementwise

// optax.clip_by_global_norm as the plain version runs it: g / norm * clip,
// each stage in the param dtype, unless norm < clip
struct GClip {
  bool on;
  float norm_t, clip;
};

template <typename T>
__device__ __forceinline__ GClip grad_clip(const Args& a) {
  GClip c{false, 1.f, 1.f};
  if (a.flags & CLIP) {
    const float n = a.out[0];
    c.on = !(n < a.clip);
    c.norm_t = rnd<T>(n);
    c.clip = a.clip;
  }
  return c;
}

template <typename T>
__device__ __forceinline__ float clipped(float g, const GClip& c) {
  return c.on ? rnd<T>(__fmul_rn(rnd<T>(__fdiv_rn(g, c.norm_t)), c.clip)) : g;
}

// (g * g + eps) in the param dtype
template <typename T>
__device__ __forceinline__ float gsq_of(float g, float eps) {
  return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(g, g)), eps));
}

// the statistic's EMA: b2 * v + (1 - b2) * x, in the param dtype
template <typename T>
__device__ __forceinline__ float ema_stat(const Args& a, float v, float x) {
  return rnd<T>(__fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(a.omb2, x)));
}

// factored tile coordinates
struct FTile {
  long long k, ts, tf;
};
__device__ __forceinline__ FTile ftile(const Leaf& L, long long t) {
  FTile f;
  f.tf = t % L.n_tf;
  t /= L.n_tf;
  f.ts = t % L.n_ts;
  f.k = t / L.n_ts;
  return f;
}

// a factored vector's u (before the RMS clip): g * row factor * column
// factor, fp32, rounded once. `fast` holds the factors along the vector, `slow`
// the one of its row
template <typename T, int N>
__device__ __forceinline__ void u_factored(const Leaf& L, const float (&g)[N], const float (&fast)[N], float slow,
                                           float (&u)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    u[j] = L.fast_is_c ? rnd<T>(__fmul_rn(__fmul_rn(g[j], slow), fast[j]))
                       : rnd<T>(__fmul_rn(__fmul_rn(g[j], fast[j]), slow));
}

// the factors of a factored vector at (k, s, f0): along the fast axis and of the slow row
template <int N>
__device__ __forceinline__ void factors(const Leaf& L, long long k, long long s, long long f0, float (&fast)[N],
                                        float* slow) {
  const float* rf = reinterpret_cast<const float*>(L.rf);
  const float* cf = reinterpret_cast<const float*>(L.cf);
  const float* fv = L.fast_is_c ? cf + k * L.C + f0 : rf + k * L.R + f0;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 x = *reinterpret_cast<const float4*>(fv + 4 * q);
    fast[4 * q] = x.x;
    fast[4 * q + 1] = x.y;
    fast[4 * q + 2] = x.z;
    fast[4 * q + 3] = x.w;
  }
  *slow = L.fast_is_c ? rf[k * L.R + s] : cf[k * L.C + s];
}

// ------------------------------------------------------------- adamw_norm

// the leaf's norm from its tiles' sums of g^2; the last leaf to finish takes
// the global norm (the plain version's norm of the per-leaf norms)
__device__ void merge_norm(const Args& a, int li, const Leaf& L, float* sh) {
  float acc = 0.f;
  for (long long i = threadIdx.x; i < L.n_tiles; i += THREADS) acc += __ldcg(a.tile_sq + L.tile0 + i);
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) a.leaf_norm[li] = __fsqrt_rn(acc);
  if (!last_to_arrive(a.counters + a.n_leaves, a.n_leaves)) return;
  float t = 0.f;
  for (long long i = threadIdx.x; i < a.n_leaves; i += THREADS) {
    const float n = __ldcg(a.leaf_norm + i);
    t = __fadd_rn(t, __fmul_rn(n, n));
  }
  t = block_sum(t, sh);
  if (threadIdx.x == 0) a.out[0] = __fsqrt_rn(t);
}

// the sum of g^2 over the thread's elements of tile t (raw gradients)
template <typename T>
__device__ __forceinline__ float tile_sum_sq(const Leaf& L, const T* g, long long t) {
  constexpr int N = Vec<T>::N;
  float acc = 0.f;
  if (L.factored) {
    const FTile ft = ftile(L, t);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long f0 = ft.tf * 32 * N + lane * N;
    uint4 raw[ROWS];
    preload(g, L, ft.k, ft.ts * TILE_SLOW + warp * ROWS, f0, raw);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float v[N];
      unpack<T>(raw[i], v);
#pragma unroll
      for (int j = 0; j < N; ++j) acc = __fadd_rn(acc, __fmul_rn(v[j], v[j]));
    }
  } else {
    const long long base = t * DENSE_TILE + threadIdx.x;
    for (int i = 0; i < DENSE_PER_THREAD; ++i) {
      const long long e = base + static_cast<long long>(i) * THREADS;
      if (e < L.numel) {
        const float x = to_f(g[e]);
        acc = __fadd_rn(acc, __fmul_rn(x, x));
      }
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) adamw_norm_kernel(const Args a) {
  __shared__ Leaf L;
  __shared__ float sh[WARPS];
  const int tile = blockIdx.x;
  const int li = a.tile_leaf[tile];
  load_leaf(a, li, &L);
  const T* g = reinterpret_cast<const T*>(a.ptrs[4 * li]);
  const float acc = block_sum(tile_sum_sq(L, g, tile - L.tile0), sh);
  if (threadIdx.x == 0) a.tile_sq[tile] = acc;
  if (last_to_arrive(a.counters + li, L.n_tiles)) merge_norm(a, li, L, sh);
}

// ------------------------------------------------------------ adamw_stats

template <typename T>
__global__ void __launch_bounds__(THREADS) adamw_stats_kernel(const Args a) {
  constexpr int N = Vec<T>::N;
  __shared__ Leaf L;
  __shared__ float sh[WARPS];
  __shared__ float col[WARPS][32 * N];
  const int tile = blockIdx.x;
  const int li = a.tile_leaf[tile];
  load_leaf(a, li, &L);
  const T* g = reinterpret_cast<const T*>(a.ptrs[4 * li]);
  const long long t = tile - L.tile0;
  const GClip c = grad_clip<T>(a);
  float nacc = 0.f;  // the norm's partial, of the raw gradients
  if (L.factored) {
    const FTile ft = ftile(L, t);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long f0 = ft.tf * 32 * N + lane * N;
    const bool fok = f0 < L.F;
    uint4 raw[ROWS];
    preload(g, L, ft.k, ft.ts * TILE_SLOW + warp * ROWS, f0, raw);
    float colacc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) colacc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const long long s = ft.ts * TILE_SLOW + warp * ROWS + i;
      const bool ok = fok && s < L.S;
      float v[N];
      unpack<T>(raw[i], v);
      float row = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        nacc = __fadd_rn(nacc, __fmul_rn(v[j], v[j]));
        const float q = ok ? gsq_of<T>(clipped<T>(v[j], c), a.eps) : 0.f;
        row += q;
        colacc[j] += q;
      }
      row = warp_sum(row);
      if (lane == 0 && s < L.S) a.part_f[L.part_f + (ft.k * L.S + s) * L.n_tf + ft.tf] = row;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) col[warp][lane * N + j] = colacc[j];
    __syncthreads();
    if (threadIdx.x < 32 * N) {
      const long long f = ft.tf * 32 * N + threadIdx.x;
      if (f < L.F) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += col[w][threadIdx.x];
        a.part_s[L.part_s + (ft.k * L.F + f) * L.n_ts + ft.ts] = s;
      }
    }
  } else {
    T* vv = reinterpret_cast<T*>(L.v_a);
    const long long base = t * DENSE_TILE + threadIdx.x;
    for (int i = 0; i < DENSE_PER_THREAD; ++i) {
      const long long e = base + static_cast<long long>(i) * THREADS;
      if (e < L.numel) {
        const float x = to_f(g[e]);
        nacc = __fadd_rn(nacc, __fmul_rn(x, x));
        vv[e] = from_f<T>(ema_stat<T>(a, to_f(vv[e]), gsq_of<T>(clipped<T>(x, c), a.eps)));
      }
    }
  }
  if (a.flags & NORM_IN_STATS) {
    nacc = block_sum(nacc, sh);
    if (threadIdx.x == 0) a.tile_sq[tile] = nacc;
  }
}

// ----------------------------------------------------------- adamw_finish

// the sum of n partials from p, in order
__device__ __forceinline__ float sum_parts(const float* p, long long n) {
  float s = 0.f;
  for (long long j = 0; j < n; ++j) s += __ldcg(p + j);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) adamw_finish_kernel(const Args a) {
  __shared__ Leaf L;
  __shared__ float sh[WARPS];
  const int st = blockIdx.x;
  const int li = a.stat_leaf[st];
  load_leaf(a, li, &L);
  if (L.factored) {
    const long long ent = (st - L.stat0) * STAT_TILE + threadIdx.x;
    const long long n_row = L.K * L.R, n_col = L.K * L.C;
    if (ent < n_row) {  // v_row[k, r]: the mean over the columns
      const long long k = ent / L.R, r = ent % L.R;
      const float s = L.fast_is_c ? sum_parts(a.part_f + L.part_f + (k * L.S + r) * L.n_tf, L.n_tf)
                                  : sum_parts(a.part_s + L.part_s + (k * L.F + r) * L.n_ts, L.n_ts);
      T* vr = reinterpret_cast<T*>(L.v_a);
      vr[ent] = from_f<T>(ema_stat<T>(a, to_f(vr[ent]), rnd<T>(__fdiv_rn(s, static_cast<float>(L.C)))));
    } else if (ent < n_row + n_col) {  // v_col[k, c]: the mean over the rows, and its factor
      const long long e = ent - n_row;
      const long long k = e / L.C, cc = e % L.C;
      const float s = L.fast_is_c ? sum_parts(a.part_s + L.part_s + (k * L.F + cc) * L.n_ts, L.n_ts)
                                  : sum_parts(a.part_f + L.part_f + (k * L.S + cc) * L.n_tf, L.n_tf);
      T* vc = reinterpret_cast<T*>(L.v_b);
      const float v = ema_stat<T>(a, to_f(vc[e]), rnd<T>(__fdiv_rn(s, static_cast<float>(L.R))));
      vc[e] = from_f<T>(v);
      reinterpret_cast<float*>(L.cf)[e] = rnd<T>(rsqrt_rn(v));
    }
  }
  if (!last_to_arrive(a.counters + li, L.n_stat)) return;
  if (L.factored) {  // the row means over the rows of each k, then the row factors
    const T* vr = reinterpret_cast<const T*>(L.v_a);
    float* rm = reinterpret_cast<float*>(L.row_mean);
    for (long long k = 0; k < L.K; ++k) {
      float s = 0.f;
      for (long long r = threadIdx.x; r < L.R; r += THREADS) s += to_f(__ldcg(vr + k * L.R + r));
      s = block_sum(s, sh);
      if (threadIdx.x == 0) rm[k] = rnd<T>(__fdiv_rn(s, static_cast<float>(L.R)));
    }
    __syncthreads();
    float* rf = reinterpret_cast<float*>(L.rf);
    for (long long e = threadIdx.x; e < L.K * L.R; e += THREADS)
      rf[e] = rnd<T>(rsqrt_rn(__fdiv_rn(to_f(__ldcg(vr + e)), rm[e / L.R])));
  }
  if (a.flags & NORM_IN_STATS) merge_norm(a, li, L, sh);
}

// ---------------------------------------------------- adamw_rms, adamw_apply

// p + u for one element: the RMS clip, lr, the momentum (returned in *m),
// weight decay; returns the fp32 sum before the parameter's rounding
template <typename T>
__device__ __forceinline__ float step_elem(const Args& a, float u, float denom, float p, float mu, float* m) {
  if (a.flags & RMS) u = rnd<T>(__fdiv_rn(u, denom));
  u = rnd<T>(__fmul_rn(a.lr, u));
  *m = __fadd_rn(__fmul_rn(a.c_u, u), __fmul_rn(a.c_m, mu));
  float d = -rnd<T>(*m);  // the momentum in the promoted dtype, negated
  if (a.flags & WD) d = __fsub_rn(d, __fmul_rn(a.lrwd, p));
  return __fadd_rn(p, d);
}

// the new parameter from the fp32 sum; the new EMA from it
template <typename T>
__device__ __forceinline__ float round_param(float x, unsigned bits) {
  if constexpr (sizeof(T) == 2) return sr_round(x, bits);
  return x;
}

template <typename T>
__device__ __forceinline__ float ema_elem(const Args& a, float e, float p, unsigned bits) {
  if constexpr (sizeof(T) == 2) return sr_round(__fadd_rn(e, __fmul_rn(a.ema_c, __fsub_rn(p, e))), bits);
  return __fadd_rn(__fmul_rn(a.ema_dw, e), __fmul_rn(a.ema_c, p));
}

// adamw_rms (APPLY false) and adamw_apply (true): u of each element of the
// block's tile, then its square's sum, or the update
template <typename T, bool APPLY>
__device__ __forceinline__ void update_tile(const Args& a) {
  constexpr int N = Vec<T>::N;
  __shared__ Leaf L;
  __shared__ float sh[WARPS];
  const int tile = blockIdx.x;
  const int li = a.tile_leaf[tile];
  load_leaf(a, li, &L);
  const long long* ptr = a.ptrs + 4 * li;
  const T* g = reinterpret_cast<const T*>(ptr[0]);
  const long long t = tile - L.tile0;
  const GClip c = grad_clip<T>(a);
  const float denom = (APPLY && (a.flags & RMS)) ? a.leaf_denom[li] : 1.f;
  const bool bf16 = sizeof(T) == 2;
  const bool ema = APPLY && (a.flags & EMA);
  const unsigned long long key0 = (APPLY && bf16) ? leaf_key(a, li, 0) : 0;
  const unsigned long long key1 = (ema && bf16) ? leaf_key(a, li, 1) : 0;
  const int* given0 = reinterpret_cast<const int*>(ptr[1]);
  const int* given1 = reinterpret_cast<const int*>(ptr[2]);
  T* ep = reinterpret_cast<T*>(ptr[3]);
  T* pp = reinterpret_cast<T*>(L.p);
  __nv_bfloat16* mp = reinterpret_cast<__nv_bfloat16*>(L.mu);
  float uacc = 0.f;
  if (L.factored) {
    const FTile ft = ftile(L, t);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long f0 = ft.tf * 32 * N + lane * N;
    if (f0 < L.F) {
#pragma unroll 2
      for (int i = 0; i < ROWS; ++i) {
        const long long s = ft.ts * TILE_SLOW + warp * ROWS + i;
        if (s >= L.S) break;
        const long long e0 = ft.k * L.sk + s * L.ss + f0;
        float gv[N], fast[N], slow, u[N];
        load(g, e0, gv);
        factors(L, ft.k, s, f0, fast, &slow);
#pragma unroll
        for (int j = 0; j < N; ++j) gv[j] = clipped<T>(gv[j], c);
        u_factored<T>(L, gv, fast, slow, u);
        if constexpr (!APPLY) {
#pragma unroll
          for (int j = 0; j < N; ++j) uacc = __fadd_rn(uacc, __fmul_rn(u[j], u[j]));
        } else {
          float pv[N], mv[N], ev[N];
          unsigned b0[N] = {}, b1[N] = {};
          load(pp, e0, pv);
          load(mp, e0, mv);
          if (ema) load(static_cast<const T*>(ep), e0, ev);
          if (bf16) bits_of(key0, given0, e0, b0);
          if (ema && bf16) bits_of(key1, given1, e0, b1);
#pragma unroll
          for (int j = 0; j < N; ++j) {
            float m;
            pv[j] = round_param<T>(step_elem<T>(a, u[j], denom, pv[j], mv[j], &m), b0[j]);
            mv[j] = m;
            if (ema) ev[j] = ema_elem<T>(a, ev[j], pv[j], b1[j]);
          }
          store(pp, e0, pv);
          store(mp, e0, mv);
          if (ema) store(ep, e0, ev);
        }
      }
    }
  } else {
    const T* vv = reinterpret_cast<const T*>(L.v_a);
    const long long base = t * DENSE_TILE + threadIdx.x;
    for (int i = 0; i < DENSE_PER_THREAD; ++i) {
      const long long e = base + static_cast<long long>(i) * THREADS;
      if (e >= L.numel) break;
      const float u = rnd<T>(__fmul_rn(clipped<T>(to_f(g[e]), c), rsqrt_rn(to_f(vv[e]))));
      if constexpr (!APPLY) {
        uacc = __fadd_rn(uacc, __fmul_rn(u, u));
      } else {
        float m;
        const float pn = round_param<T>(step_elem<T>(a, u, denom, to_f(pp[e]), __bfloat162float(mp[e]), &m),
                                        bf16 ? (given0 ? given0[e] & 0xFFFF : drawn_bits(key0, e)) : 0u);
        pp[e] = from_f<T>(pn);
        mp[e] = __float2bfloat16_rn(m);
        if (ema)
          ep[e] = from_f<T>(ema_elem<T>(a, to_f(ep[e]), pn,
                                        bf16 ? (given1 ? given1[e] & 0xFFFF : drawn_bits(key1, e)) : 0u));
      }
    }
  }
  if constexpr (!APPLY) {  // adamw_rms: the leaf's max(rms(u) / threshold, 1)
    uacc = block_sum(uacc, sh);
    if (threadIdx.x == 0) a.tile_u2[tile] = uacc;
    if (!last_to_arrive(a.counters + li, L.n_tiles)) return;
    float s = 0.f;
    for (long long i = threadIdx.x; i < L.n_tiles; i += THREADS) s += __ldcg(a.tile_u2 + L.tile0 + i);
    s = block_sum(s, sh);
    if (threadIdx.x == 0) {
      const float rms = __fsqrt_rn(__fdiv_rn(s, static_cast<float>(L.numel)));
      a.leaf_denom[li] = fmaxf(__fdiv_rn(rms, a.thr), 1.0f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) adamw_rms_kernel(const Args a) {
  update_tile<T, false>(a);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) adamw_apply_kernel(const Args a) {
  update_tile<T, true>(a);
}

// ------------------------------------------------------- adamw_fp16_apply

// one element of adamw_fp16_state's update and optax.apply_updates, in the
// plain version's order: returns the new fp32 parameter, updates m and v
__device__ __forceinline__ float fp16_elem(const Args& a, float g, float* m, float* v, float p, float d, bool clip,
                                           float norm) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, norm), a.clip);
  *m = __fadd_rn(__fmul_rn(*m, a.c_m), __fmul_rn(g, a.c_u));
  *v = __fadd_rn(__fmul_rn(*v, a.b2), __fmul_rn(__fmul_rn(g, g), a.omb2));
  float u = __fdiv_rn(__fmul_rn(a.step_size, *m), __fadd_rn(__fsqrt_rn(*v), a.eps));
  u = __fsub_rn(u, __fmul_rn(d, p));
  return __fadd_rn(p, u);
}

// A dense tile of 8192 elements a block, 4 a thread at a time (8-byte bf16
// and 16-byte fp32 vectors), the leaf's last partial vector element by
// element. Leaf.p is the fp32 master, mu and v_a the bf16 moments, v_b the
// bf16 working copy; the bf16 gradient is ptrs[4 * leaf].
__global__ void __launch_bounds__(THREADS) adamw_fp16_apply_kernel(const Args a) {
  __shared__ Leaf L;
  const int tile = blockIdx.x;
  const int li = a.tile_leaf[tile];
  load_leaf(a, li, &L);
  const __nv_bfloat16* g = reinterpret_cast<const __nv_bfloat16*>(a.ptrs[4 * li]);
  float* p = reinterpret_cast<float*>(L.p);
  __nv_bfloat16* mp = reinterpret_cast<__nv_bfloat16*>(L.mu);
  __nv_bfloat16* vp = reinterpret_cast<__nv_bfloat16*>(L.v_a);
  __nv_bfloat16* wp = reinterpret_cast<__nv_bfloat16*>(L.v_b);
  const float d = a.decay[li];
  const float norm = (a.flags & CLIP) ? a.out[0] : 1.f;
  const bool clip = (a.flags & CLIP) && !(norm < a.clip);  // optax: select(norm < max_norm, g, g / norm * max_norm)
  const long long base = (tile - L.tile0) * static_cast<long long>(DENSE_TILE);
  for (int i = 0; i < DENSE_PER_THREAD / 4; ++i) {
    const long long e0 = base + 4 * (threadIdx.x + static_cast<long long>(i) * THREADS);
    if (e0 >= L.numel) break;
    if (e0 + 4 <= L.numel) {
      float gv[4], mv[4], vv[4], pv[4];
      load(g, e0, gv);
      load(mp, e0, mv);
      load(vp, e0, vv);
      load(p, e0, pv);
#pragma unroll
      for (int j = 0; j < 4; ++j) pv[j] = fp16_elem(a, gv[j], &mv[j], &vv[j], pv[j], d, clip, norm);
      store(p, e0, pv);
      store(mp, e0, mv);
      store(vp, e0, vv);
      store(wp, e0, pv);
    } else {
      for (long long e = e0; e < L.numel; ++e) {
        float m = __bfloat162float(mp[e]), v = __bfloat162float(vp[e]);
        const float pn = fp16_elem(a, __bfloat162float(g[e]), &m, &v, p[e], d, clip, norm);
        p[e] = pn;
        mp[e] = __float2bfloat16_rn(m);
        vp[e] = __float2bfloat16_rn(v);
        wp[e] = __float2bfloat16_rn(pn);
      }
    }
  }
}

template <typename K>
int launch(K kernel, long long grid, const Args* a, void* stream) {
  if (grid < 1 || grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(grid), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// args: the Args block (host memory; a plain pointer, so that the C symbols
// keep external linkage); grid: the tiles of the flat tile space
// (adamw_finish: the statistics tiles); bf16: 1 for bf16 parameters, 0 for
// fp32. Each returns the launch's cudaError.
extern "C" int uwu_adamw_norm(const void* args, long long grid, int bf16, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  return bf16 ? launch(adamw_norm_kernel<__nv_bfloat16>, grid, a, stream)
              : launch(adamw_norm_kernel<float>, grid, a, stream);
}

extern "C" int uwu_adamw_stats(const void* args, long long grid, int bf16, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  return bf16 ? launch(adamw_stats_kernel<__nv_bfloat16>, grid, a, stream)
              : launch(adamw_stats_kernel<float>, grid, a, stream);
}

extern "C" int uwu_adamw_finish(const void* args, long long grid, int bf16, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  return bf16 ? launch(adamw_finish_kernel<__nv_bfloat16>, grid, a, stream)
              : launch(adamw_finish_kernel<float>, grid, a, stream);
}

extern "C" int uwu_adamw_rms(const void* args, long long grid, int bf16, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  return bf16 ? launch(adamw_rms_kernel<__nv_bfloat16>, grid, a, stream)
              : launch(adamw_rms_kernel<float>, grid, a, stream);
}

extern "C" int uwu_adamw_apply(const void* args, long long grid, int bf16, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  return bf16 ? launch(adamw_apply_kernel<__nv_bfloat16>, grid, a, stream)
              : launch(adamw_apply_kernel<float>, grid, a, stream);
}

// bf16 must be 1: bf16 gradients, moments and working copy over fp32 masters
extern "C" int uwu_adamw_fp16_apply(const void* args, long long grid, int bf16, void* stream) {
  if (!bf16) return static_cast<int>(cudaErrorInvalidValue);
  return launch(adamw_fp16_apply_kernel, grid, static_cast<const Args*>(args), stream);
}
