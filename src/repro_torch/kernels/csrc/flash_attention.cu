// Flash attention for Hopper (sm_90a): online softmax over KV tiles with the
// running state kept on chip.
//
// Replaces the TPU kernel `_attention_kernel` launched by `flash_attention_bh`
// (src/repro/kernels/flash_attention.py).  It computes the same function,
//
//     out = softmax(q k^T / sqrt(dh) + mask) v
//     mask: kp >= 0 and kp <= qp and kp > qp - window and kp // chunk == qp // chunk
//
// by the same recurrence (m = running max, l = normaliser, acc = output
// accumulator; masked scores are the finite NEG_INF = -1e30, so a row whose
// every key is masked yields the mean of the v rows), but is laid out for this
// card rather than carried over block by block:
//
//   * grid (ceil(Sq / BQ), B * Hq); the loop over KV tiles runs INSIDE the block
//     (the TPU's sequential third grid axis has no counterpart on a GPU), and
//     m / l / acc live in registers across it and never touch device memory.
//     That placement is the register-demotion decision this repository is about:
//     the accumulators take RM * (NJ + NKJ) registers a thread, the K / V / P
//     tiles take shared memory, and the tile chooser on the Python side trades
//     the two against occupancy;
//   * q, k, v and out are read and written in the model layout (B, S, H, Dh)
//     through their strides: no transpose copy, and no copy of K / V per query
//     group (kv_head = q_head / (Hq / Hkv)); positions are (B, S), one row per
//     batch entry, possibly with stride 0;
//   * ragged Sq / Skv are handled by masked loads and stores, not by padding;
//   * window and chunk are runtime integers (1 << 30 = unrestricted) and scale a
//     runtime float, so one build serves every layer kind;
//   * inputs (float or bf16) are upcast to fp32; both products accumulate in
//     fp32 with plain FMAs on the CUDA cores (no TF32), and p stays fp32.
//
// What bounds it on an H100: decode (Sq = 1) is bound by the bytes of K and V,
// each read once; prefill is bound by the operations of the two products.  This
// first version addresses the first by reading K and V exactly once per
// (batch, head, q block) with the whole block cooperating in coalesced loads
// (16 bytes a thread, four in flight, where every row start is 16-byte aligned;
// element by element otherwise), and by idling the threads whose query rows do
// not exist.  It does not yet address the second (no tensor cores, no
// asynchronous copies): the products run on the CUDA cores.
//
// Thread layout: 256 threads as 16 (ty, rows) x 16 (tx, columns).  Thread
// (ty, tx) owns query rows ty*RM .. ty*RM+RM-1 and the strided columns
// tx + 16*j, both of the score tile (j < NKJ) and of the output (j < NJ).  The 16
// threads of one row group are half a warp, so row reductions are shuffles and
// the P tile needs only a warp-level barrier between its writers and readers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* qpos;
  const int* kpos;
  int B, Sq, Skv, Hq, Hkv, dh;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t qp_sb, qp_ss, kp_sb, kp_ss;
  int window, chunk;
  float scale;
  int vec;  // every row of q, k and v starts on a 16-byte boundary
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch does
}

// 16 bytes of T as floats (bf16 -> fp32 is a 16-bit shift)
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4], float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8], __nv_bfloat16) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Copies a tile of `rows` rows of `dh` elements from device memory (row stride
// `src_stride` elements) into shared memory as fp32 (row stride `dst_stride`
// floats); rows from `valid` on are zero.  All threads of the block take part.
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int dst_stride,
                                          const T* __restrict__ src, int64_t src_stride,
                                          int rows, int valid, int dh, bool vec) {
  if (vec) {
    constexpr int VE = 16 / sizeof(T);  // elements in 16 bytes
    constexpr int U = 4;                // loads in flight a thread
    const int per_row = dh / VE;
    const int total = rows * per_row;
    for (int c0 = threadIdx.x; c0 < total; c0 += kThreads * U) {
      uint4 raw[U];
      int row[U], col[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + u * kThreads;
        row[u] = c / per_row;
        col[u] = (c - row[u] * per_row) * VE;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (c < total && row[u] < valid)
          raw[u] = *reinterpret_cast<const uint4*>(src + (int64_t)row[u] * src_stride + col[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (c0 + u * kThreads < total) {
          float f[VE];
          unpack(raw[u], f, T());
          float* d = dst + row[u] * dst_stride + col[u];
#pragma unroll
          for (int e = 0; e < VE; ++e) d[e] = f[e];
        }
      }
    }
  } else {
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
      const bool ok = r < valid;
      const T* srow = src + (int64_t)r * src_stride;
      for (int d = lane; d < dh; d += 32) dst[r * dst_stride + d] = ok ? to_float(srow[d]) : 0.f;
    }
  }
}

// Python's //: rounds toward minus infinity (C's / truncates).  d > 0.
__device__ __forceinline__ int floor_div(int a, int d) {
  int q = a / d;
  return (a % d < 0) ? q - 1 : q;
}

__host__ __device__ inline size_t smem_bytes_for(int dh, int bq, int bkv) {
  // Q tile, K tile (row stride dh + 1: conflict-free column reads), V tile,
  // P tile, then the two position tiles.
  size_t floats = (size_t)bq * dh + (size_t)bkv * (dh + 1) + (size_t)bkv * dh + (size_t)bq * bkv;
  return floats * sizeof(float) + (size_t)(bq + bkv) * sizeof(int);
}

template <typename T, int NJ, int RM, int NKJ>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Params p) {
  constexpr int BQ = kTY * RM;
  constexpr int BKV = kTX * NKJ;
  extern __shared__ float smem[];

  const int dh = p.dh;
  const int kstride = dh + 1;
  float* Qs = smem;
  float* Ks = Qs + BQ * dh;
  float* Vs = Ks + BKV * kstride;
  float* Ps = Vs + BKV * dh;
  int* qpos_s = reinterpret_cast<int*>(Ps + BQ * BKV);
  int* kpos_s = qpos_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & (kTX - 1);
  const int ty = tid >> 4;
  const bool vec = p.vec != 0;

  const int b = blockIdx.y / p.Hq;
  const int h = blockIdx.y % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, p.Sq - q0);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + (int64_t)q0 * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh + (int64_t)q0 * p.o_ss;

  // ---- the query tile, upcast once ------------------------------------------
  load_tile(Qs, dh, qg, p.q_ss, BQ, nq, dh, vec);
  if (tid < BQ)
    qpos_s[tid] = tid < nq ? p.qpos[b * p.qp_sb + (int64_t)(q0 + tid) * p.qp_ss] : -1;
  __syncthreads();

  const int row0 = ty * RM;
  // threads whose rows lie past Sq do no arithmetic (decode: one live row)
  const bool active = row0 < nq;

  int qp[RM];
  float m[RM], l[RM], acc[RM][NJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    qp[i] = qpos_s[row0 + i];
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < p.Skv; kv0 += BKV) {
    const int nkv = min(BKV, p.Skv - kv0);

    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, kstride, kg + (int64_t)kv0 * p.k_ss, p.k_ss, BKV, nkv, dh, vec);
    load_tile(Vs, dh, vg + (int64_t)kv0 * p.v_ss, p.v_ss, BKV, nkv, dh, vec);
    if (tid < BKV)
      kpos_s[tid] = tid < nkv ? p.kpos[b * p.kp_sb + (int64_t)(kv0 + tid) * p.kp_ss] : -1;
    __syncthreads();

    // ---- s = q k^T ------------------------------------------------------------
    float s[RM][NKJ];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < NKJ; ++j) s[i][j] = 0.f;

    if (active) {
#pragma unroll 4
      for (int d = 0; d < dh; ++d) {
        float qv[RM], kv[NKJ];
#pragma unroll
        for (int i = 0; i < RM; ++i) qv[i] = Qs[(row0 + i) * dh + d];
#pragma unroll
        for (int j = 0; j < NKJ; ++j) kv[j] = Ks[(tx + kTX * j) * kstride + d];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < NKJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

    // ---- mask, online softmax (every thread takes part in the shuffles) --------
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < NKJ; ++j) {
        const int col = tx + kTX * j;
        const int kp = kpos_s[col];
        // kp >= 0 first: C's division differs from Python's only below zero
        bool ok = col < nkv && kp >= 0 && kp <= qp[i] && kp > qp[i] - p.window;
        ok = ok && (kp / p.chunk == floor_div(qp[i], p.chunk));
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));

      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < NKJ; ++j) {
        const int col = tx + kTX * j;
        // a column past Skv does not exist: it adds nothing, masked or not
        const float pij = col < nkv ? expf(s[i][j] - m_new) : 0.f;
        Ps[(row0 + i) * BKV + col] = pij;
        rsum += pij;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);

      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a row of P is written and read by one half warp

    // ---- acc += p v -------------------------------------------------------------
    if (active) {
      for (int kk = 0; kk < nkv; ++kk) {
        float pv[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) pv[i] = Ps[(row0 + i) * BKV + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (kTX * j < dh) {  // uniform: dh is a multiple of 16
            const float vv = Vs[kk * dh + tx + kTX * j];
#pragma unroll
            for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
          }
        }
      }
    }
  }

  // ---- out = acc / max(l, 1e-30), in q's type ---------------------------------
  if (active) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = row0 + i;
      if (row < nq) {
        const float denom = fmaxf(l[i], 1e-30f);
        T* orow = og + (int64_t)row * p.o_ss;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (kTX * j < dh) orow[tx + kTX * j] = from_float<T>(acc[i][j] / denom);
      }
    }
  }
}

template <typename T, int NJ, int RM, int NKJ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int BQ = kTY * RM;
  constexpr int BKV = kTX * NKJ;
  const size_t smem = smem_bytes_for(p.dh, BQ, BKV);
  auto kernel = flash_attention_kernel<T, NJ, RM, NKJ>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.Hq);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int NJ>
int launch_tile(const Params& p, int bq, int bkv, cudaStream_t stream) {
  if (bq == 64 && bkv == 64) return (int)launch<T, NJ, 4, 4>(p, stream);
  if (bq == 64 && bkv == 32) return (int)launch<T, NJ, 4, 2>(p, stream);
  if (bq == 16 && bkv == 64) return (int)launch<T, NJ, 1, 4>(p, stream);
  if (bq == 16 && bkv == 32) return (int)launch<T, NJ, 1, 2>(p, stream);
  return -2;  // a tile this build does not have
}

template <typename T>
int launch_dh(const Params& p, int bq, int bkv, cudaStream_t stream) {
  // NJ = output columns a thread owns: the smallest class that covers dh / 16
  if (p.dh <= 0 || p.dh % 16 != 0 || p.dh > 256) return -1;
  if (p.dh <= 64) return launch_tile<T, 4>(p, bq, bkv, stream);
  if (p.dh == 80) return launch_tile<T, 5>(p, bq, bkv, stream);
  if (p.dh <= 128) return launch_tile<T, 8>(p, bq, bkv, stream);
  return launch_tile<T, 16>(p, bq, bkv, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the (bq, bkv) tile takes at head width dh.
long long repro_flash_attention_smem_bytes(int dh, int bq, int bkv) {
  return (long long)smem_bytes_for(dh, bq, bkv);
}

// Enqueues the kernel on `stream` and returns cudaGetLastError() (0 = launched),
// or a negative code for arguments no instantiation takes: -1 head width,
// -2 tile, -3 element type, -4 shape.  `vec` non-zero promises that q, k and v
// and all their strides are multiples of 16 bytes.  Never synchronises,
// allocates nothing.
int repro_flash_attention(
    const void* q, const void* k, const void* v, const void* qpos, const void* kpos, void* out,
    int B, int Sq, int Skv, int Hq, int Hkv, int dh,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int64_t qp_sb, int64_t qp_ss, int64_t kp_sb, int64_t kp_ss,
    int window, int chunk, float scale, int dtype, int bq, int bkv, int vec, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -4;
  if ((long long)B * Hq > 65535 || window <= 0 || chunk <= 0) return -4;
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.Hq = Hq; p.Hkv = Hkv; p.dh = dh;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.qp_sb = qp_sb; p.qp_ss = qp_ss; p.kp_sb = kp_sb; p.kp_ss = kp_ss;
  p.window = window; p.chunk = chunk; p.scale = scale; p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(p, bq, bkv, s);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(p, bq, bkv, s);
  return -3;
}

}  // extern "C"
