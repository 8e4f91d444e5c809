// AdamW for Hopper (sm_90a): the gradients' global norm and the update of
// every parameter and both moments, in place, over a table of leaves.
//
// Replaces no TPU kernel.  The reference's update (src/repro/optim/adamw.py
// `adamw_update`) is element-wise `jax.numpy` that XLA fuses under `jax.jit`;
// the port's plain version (kernels/adamw.py `adamw_plain`) runs it leaf by
// leaf as some fifteen PyTorch kernels over full-size float32 tensors, two of
// them alive at once, and `global_norm_plain` another float32 copy a leaf.
// These kernels compute the same arithmetic:
//
//     g     = grad * min(1, clip / max(|grads|, 1e-9))
//     mu    = b1 mu + (1 - b1) g
//     nu    = b2 nu + (1 - b2) g^2
//     step  = (mu / bias1) / (sqrt(nu / bias2) + eps),  bias_i = 1 - b_i^count
//     p     = p - lr (step + wd p)          (rounded once to p's dtype)
//
// in float32, each operation rounded where the plain version rounds it (`mu *
// b1` then a fused `+ (1 - b1) g`, as PyTorch's `add_(x, alpha=)` compiles),
// with IEEE division and square root (the build has no fast math).
//
// Bound on this card: bytes.  The update reads p and g (bf16 on the main
// path) and mu and nu (fp32) and writes p, mu and nu: 22 B a parameter; the
// norm reads g once more, 2 B.  Some 60 instructions a parameter (two IEEE
// divisions and a square root among them) are under 3 a byte, far below the
// 20 float32 operations a byte at which the card's arithmetic would bind, so
// the design is about bytes alone: each element is read once and written
// once, 16 bytes a thread a load or store (8 elements), no intermediate
// reaches device memory, and every SM holds as many blocks as fit to keep
// the loads in flight.
//
// Leaves travel by value in a table (`__grid_constant__`, up to kMaxLeaves a
// launch) cut into tiles of kTile elements; a block walks the tiles
// blockIdx.x, + gridDim.x, ... in order and finds each tile's leaf by
// advancing through the table.  A tile that is whole and whose leaf's four
// pointers lie on 16-byte boundaries takes the vector path; the rest go
// element by element.
//
// The norm, deterministic (no atomics, every sum in a fixed order):
//   * `norm`, kNormBlocks blocks a table: each squares its tiles' gradient
//     elements in float32 (as the plain `x.float().square()`), sums eight at
//     a time in float32 and those sums in double, and writes one double
//     partial a block;
//   * `norm_finish`, one block: sums every partial in a fixed order and
//     writes the 0-d float32 norm, sqrt of the total rounded to float32.
// The update reads the norm, lr and the step count from device memory and
// computes the clip scale and the bias corrections on the device, so the
// step never waits on the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kVec = 8;                              // elements a thread a chunk: 16 B of bf16
constexpr int kChunks = 2;                           // chunks a thread a tile
constexpr int kTile = kThreads * kVec * kChunks;     // 4,096 elements
constexpr int kMaxLeaves = 32;                       // leaves a launch (the table: 2 KiB)
constexpr int kNormBlocks = 1024;                    // partials a table

struct Leaf {
  void* p;             // bf16 or fp32
  const void* g;       // bf16 or fp32
  float* mu;
  float* nu;
  long long n;         // elements
  long long tile0;     // the leaf's first tile in the launch
  long long tile_end;  // one past its last
  int p_bf16, g_bf16;
  int vec;             // all four pointers on 16-byte boundaries
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int count;
  long long tiles;
};

struct Hyper {
  const float* gnorm;  // 0-d
  const float* lr;     // 0-d
  const int* count;    // 0-d, the step's count (already advanced)
  float b1, b2, ab1, ab2, eps, wd, clip;
};

struct Scalars {
  float scale, b1, b2, ab1, ab2, bias1, bias2, eps, wd, lr;
};

// ---------------------------------------------------------------------------
// 8-element loads and stores (16 B of bf16, 32 B of fp32)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load8(const bf16* src, float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* src, float (&x)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* dst, const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

__device__ __forceinline__ void store8(float* dst, const float (&x)[kVec]) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void put(bf16* dst, float v) { *dst = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(float* dst, float v) { *dst = v; }

// the leaf of tile `t`, advancing `li` (a block's tiles rise)
__device__ __forceinline__ const Leaf& leaf_of(const Table& tab, long long t, int& li) {
  while (t >= tab.leaf[li].tile_end) ++li;
  return tab.leaf[li];
}

// a block's sum, in thread 0; every block sums in the same order
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  return total;
}

// ---------------------------------------------------------------------------
// the norm
// ---------------------------------------------------------------------------

template <typename GT>
__device__ __forceinline__ double square_sum_tile(const Leaf& L, long long start) {
  const GT* g = static_cast<const GT*>(L.g);
  double acc = 0.0;
  if (L.vec && start + kTile <= L.n) {
    float x[kChunks][kVec];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      load8(g + start + (long long)(c * kThreads + threadIdx.x) * kVec, x[c]);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      float s[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) s[k] = __fmul_rn(x[c][k], x[c][k]);
#pragma unroll
      for (int w = kVec / 2; w > 0; w >>= 1)
#pragma unroll
        for (int k = 0; k < w; ++k) s[k] = __fadd_rn(s[k], s[k + w]);
      acc += (double)s[0];
    }
  } else {
    const long long end = min(start + (long long)kTile, L.n);
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      const float v = to_float(g[i]);
      acc += (double)__fmul_rn(v, v);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
adamw_norm_kernel(const __grid_constant__ Table tab, double* partials) {
  double acc = 0.0;
  int li = 0;
  for (long long t = blockIdx.x; t < tab.tiles; t += gridDim.x) {
    const Leaf& L = leaf_of(tab, t, li);
    const long long start = (t - L.tile0) * kTile;
    acc += L.g_bf16 ? square_sum_tile<bf16>(L, start) : square_sum_tile<float>(L, start);
  }
  const double total = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
adamw_norm_finish_kernel(const double* partials, int n, float* gnorm) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  const double total = block_sum(acc);
  if (threadIdx.x == 0) *gnorm = __fsqrt_rn((float)total);
}

// ---------------------------------------------------------------------------
// the update
// ---------------------------------------------------------------------------

// one element, in the plain version's order and roundings; returns the new p
__device__ __forceinline__ float adam(float g, float& mu, float& nu, float p, const Scalars& s) {
  g = __fmul_rn(g, s.scale);
  mu = __fmaf_rn(s.ab1, g, __fmul_rn(mu, s.b1));
  nu = __fmaf_rn(s.ab2, __fmul_rn(g, g), __fmul_rn(nu, s.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, s.bias2)), s.eps);
  const float step = __fdiv_rn(__fdiv_rn(mu, s.bias1), den);
  return __fsub_rn(p, __fmul_rn(__fmaf_rn(s.wd, p, step), s.lr));
}

template <typename PT, typename GT>
__device__ __forceinline__ void update_tile(const Leaf& L, long long start, const Scalars& s) {
  PT* p = static_cast<PT*>(L.p);
  const GT* g = static_cast<const GT*>(L.g);
  if (L.vec && start + kTile <= L.n) {
    float pv[kChunks][kVec], gv[kChunks][kVec], mv[kChunks][kVec], nv[kChunks][kVec];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const long long i = start + (long long)(c * kThreads + threadIdx.x) * kVec;
      load8(g + i, gv[c]);
      load8(p + i, pv[c]);
      load8(L.mu + i, mv[c]);
      load8(L.nu + i, nv[c]);
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const long long i = start + (long long)(c * kThreads + threadIdx.x) * kVec;
#pragma unroll
      for (int k = 0; k < kVec; ++k) pv[c][k] = adam(gv[c][k], mv[c][k], nv[c][k], pv[c][k], s);
      store8(p + i, pv[c]);
      store8(L.mu + i, mv[c]);
      store8(L.nu + i, nv[c]);
    }
  } else {
    const long long end = min(start + (long long)kTile, L.n);
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      float mu = L.mu[i], nu = L.nu[i];
      put(p + i, adam(to_float(g[i]), mu, nu, to_float(p[i]), s));
      L.mu[i] = mu;
      L.nu[i] = nu;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const __grid_constant__ Table tab, const Hyper h) {
  // the step's scalars, as the plain version computes them in float32:
  // scale = min(1, (1 / max(gnorm, 1e-9)) * clip) (PyTorch's `clip / x` is
  // `x.reciprocal() * clip`), bias_i = 1 - b_i ** count
  Scalars s;
  const float gn = *h.gnorm;
  s.scale = fminf(1.0f, __fmul_rn(__frcp_rn(fmaxf(gn, 1e-9f)), h.clip));
  const float c = (float)*h.count;
  s.bias1 = __fsub_rn(1.0f, powf(h.b1, c));
  s.bias2 = __fsub_rn(1.0f, powf(h.b2, c));
  s.b1 = h.b1; s.b2 = h.b2; s.ab1 = h.ab1; s.ab2 = h.ab2;
  s.eps = h.eps; s.wd = h.wd; s.lr = *h.lr;
  int li = 0;
  for (long long t = blockIdx.x; t < tab.tiles; t += gridDim.x) {
    const Leaf& L = leaf_of(tab, t, li);
    const long long start = (t - L.tile0) * kTile;
    if (L.p_bf16) {
      if (L.g_bf16) update_tile<bf16, bf16>(L, start, s);
      else update_tile<bf16, float>(L, start, s);
    } else {
      if (L.g_bf16) update_tile<float, bf16>(L, start, s);
      else update_tile<float, float>(L, start, s);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

// leaves [first, first + count) of the arrays into a table; 0, or -1 for a
// negative element count
int make_table(Table& tab, int first, int count, void* const* params, const void* const* grads,
               void* const* mus, void* const* nus, const long long* numel, const int* p_bf16,
               const int* g_bf16) {
  tab = Table{};
  long long tiles = 0;
  for (int j = 0; j < count; ++j) {
    const int i = first + j;
    if (numel[i] < 0) return -1;
    Leaf& L = tab.leaf[j];
    L.p = params ? params[i] : nullptr;
    L.g = grads[i];
    L.mu = mus ? static_cast<float*>(mus[i]) : nullptr;
    L.nu = nus ? static_cast<float*>(nus[i]) : nullptr;
    L.n = numel[i];
    L.p_bf16 = p_bf16 ? p_bf16[i] : 0;
    L.g_bf16 = g_bf16[i];
    L.vec = aligned16(L.p) && aligned16(L.g) && aligned16(L.mu) && aligned16(L.nu);
    L.tile0 = tiles;
    tiles += (L.n + kTile - 1) / kTile;
    L.tile_end = tiles;
  }
  tab.count = count;
  tab.tiles = tiles;
  return 0;
}

int groups(int n_leaves) { return (n_leaves + kMaxLeaves - 1) / kMaxLeaves; }

// `update` blocks the current device holds at once (its SMs times the blocks
// an SM holds), asked of the runtime once a device and kept: the inputs never
// change, and the step should not pay for the queries.
constexpr int kDevices = 64;

cudaError_t resident_blocks(long long* out) {
  static long long by_device[kDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kDevices && by_device[device] > 0) {
    *out = by_device[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adamw_update_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  *out = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (device < kDevices) by_device[device] = *out;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Doubles of scratch the norm of `n_leaves` leaves writes.
long long repro_adamw_partials(int n_leaves) {
  return (long long)groups(n_leaves) * kNormBlocks;
}

// Enqueues the global norm of `n_leaves` gradients on `stream`: one `norm`
// launch a kMaxLeaves leaves, each writing kNormBlocks double partials into
// `partials` (repro_adamw_partials(n_leaves) of them), then one `norm_finish`
// that writes sqrt(sum) as float32 into `gnorm` (0-d).  grads[i] is
// contiguous, bf16 (g_bf16[i] = 1) or fp32, of numel[i] elements.
// `*launches` counts the kernels launched.  Returns cudaGetLastError() (0 =
// launched), -1 for no leaves or a negative count.  Never synchronises,
// allocates nothing.
int repro_adamw_norm(const void* const* grads, const long long* numel, const int* g_bf16,
                     int n_leaves, void* partials, void* gnorm, void* stream, int* launches) {
  *launches = 0;
  if (n_leaves <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(partials);
  for (int first = 0, k = 0; first < n_leaves; first += kMaxLeaves, ++k) {
    Table tab;
    const int count = n_leaves - first < kMaxLeaves ? n_leaves - first : kMaxLeaves;
    if (make_table(tab, first, count, nullptr, grads, nullptr, nullptr, numel, nullptr, g_bf16))
      return -1;
    adamw_norm_kernel<<<kNormBlocks, kThreads, 0, s>>>(tab, part + (long long)k * kNormBlocks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  adamw_norm_finish_kernel<<<1, kThreads, 0, s>>>(part, groups(n_leaves) * kNormBlocks,
                                                  static_cast<float*>(gnorm));
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return (int)err;
}

// Enqueues the update of `n_leaves` leaves on `stream`, one `update` launch a
// kMaxLeaves leaves, in place: params[i] (bf16 if p_bf16[i], else fp32),
// mus[i] and nus[i] (fp32) are written; grads[i] (bf16 if g_bf16[i], else
// fp32) is read; all contiguous, numel[i] elements each.  gnorm, lr (float32)
// and count (int32, the step's, already advanced) are 0-d device tensors read
// by every block.  ab1 = 1 - b1 and ab2 = 1 - b2 as the caller rounds them.
// A table of empty leaves launches nothing; `*launches` counts the kernels
// launched.  Returns cudaGetLastError() (0 = launched), -1 for no leaves or a
// negative count.  Never synchronises, allocates nothing.
int repro_adamw_update(void* const* params, const void* const* grads, void* const* mus,
                       void* const* nus, const long long* numel, const int* p_bf16,
                       const int* g_bf16, int n_leaves, const void* gnorm, const void* lr,
                       const void* count, float b1, float b2, float ab1, float ab2, float eps,
                       float wd, float clip, void* stream, int* launches) {
  *launches = 0;
  if (n_leaves <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Hyper h;
  h.gnorm = static_cast<const float*>(gnorm);
  h.lr = static_cast<const float*>(lr);
  h.count = static_cast<const int*>(count);
  h.b1 = b1; h.b2 = b2; h.ab1 = ab1; h.ab2 = ab2; h.eps = eps; h.wd = wd; h.clip = clip;
  long long resident = 0;
  cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return (int)err;
  for (int first = 0; first < n_leaves; first += kMaxLeaves) {
    Table tab;
    const int count = n_leaves - first < kMaxLeaves ? n_leaves - first : kMaxLeaves;
    if (make_table(tab, first, count, params, grads, mus, nus, numel, p_bf16, g_bf16)) return -1;
    if (tab.tiles == 0) continue;
    const int blocks = (int)(tab.tiles < resident ? tab.tiles : resident);
    adamw_update_kernel<<<blocks, kThreads, 0, s>>>(tab, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return 0;
}

}  // extern "C"
