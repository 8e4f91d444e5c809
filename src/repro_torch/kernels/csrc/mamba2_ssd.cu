// Mamba-2 SSD chunk scan for Hopper (sm_90a), with the recurrent state kept on
// chip across the whole sequence.
//
// Replaces the TPU kernel `_ssd_kernel` launched by `ssd_pallas`
// (src/repro/kernels/mamba2_ssd.py:37).  It computes the same function, per
// (batch, head), with da = dt * a:
//
//     within each chunk      da_cum = cumsum(da), da_total = da_cum[last]
//     y  = ((C B^T) o L o dt_j) x + exp(da_cum) o (C h^T),
//          L[i][j] = exp(da_cum[i] - da_cum[j]) for i >= j, else 0
//     h <- exp(da_total) h + B^T (dt o exp(da_total - da_cum) o x)
//
// starting from h = 0 or from a given h0, and emits y and the last h (fp32).
// Beyond the reference kernel it takes any S >= 1 (the ragged tail is masked:
// its dt and x rows are zero, which adds exactly nothing), an initial state,
// and writes y in fp32 or in x's type.  It is laid out for this card rather
// than carried over grid step by grid step:
//
//   * grid (P / PS, H, B): a block owns PS rows of one head's state.  Row p of
//     h evolves on its own and y[:, p] needs only h[p, :] and x[:, p], so the
//     split is exact; it fills the card at prefill (B = 1: 32 heads x 4 = 128
//     blocks for mamba2_370m, 320 for zamba2_2_7b) at the price of computing
//     C B^T once per block instead of once per head;
//   * the loop over chunks runs INSIDE the block (the TPU's sequential grid
//     axis has no counterpart on a GPU: blocks run in no order), and h stays
//     in registers across it, PS * N / 256 floats a thread, never touching
//     device memory until the end.  That placement is the register-demotion
//     decision this repository is about; `ptxas -v` (the build phase of
//     chip_smoke.py) reports whether it spills.  Each chunk publishes a
//     snapshot of h to shared memory, because C h^T needs every thread to read
//     whole rows of it;
//   * the chunk is 64 rows, not the reference's 256: 256 rows of fp32 B and C
//     at N = 128 are 256 KB, more than a block's 227 KB.  The result does not
//     depend on the chunk length in exact arithmetic (it is the state-passing
//     form at a smaller chunk), and the plain version (ssd_plain) walks the
//     same 64-row chunks;
//   * da_cum is a warp-shuffle prefix sum (warp 0, two rows a lane);
//   * x, dt, B, C and y are read and written in the model's layout through
//     their strides, so the column slices of the convolution's output that the
//     model hands over are not copied;
//   * all products are fp32 FMAs on the CUDA cores (no TF32, no bf16
//     products), so fp32 inputs meet the reference's 2e-4.
//
// What bounds it on an H100: at the main path's shapes (one prompt of up to 512
// tokens, mamba2_370m: H = 32, P = 64, N = 128) the bytes that must move are
// about 7.7 MB and the operations of the 256-row dual form about 1.1 GFLOP, so
// the bound is set by bytes (about 2.3 us).  This first version moves each
// input about once from device memory (B and C are re-read per block, but from
// L2) and keeps h out of device memory entirely; it does not yet address the
// arithmetic, which it does with CUDA-core FMAs fed from shared memory, not with
// the tensor cores, and without asynchronous copies.
//
// Thread layout: 256 threads as 16 (ty) x 16 (tx).  C B^T: thread (ty, tx)
// owns rows ty + 16 r and columns tx + 16 c (r, c < 4) of the 64 x 64 tile;
// y: rows ty + 16 r, state rows tx + 16 c (c < PS / 16); h: column
// n = tid % N of state rows tid / N + k * (256 / N).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;   // rows of a chunk
constexpr int kTX = 16;
constexpr int kTY = 16;

struct Params {
  const void* x;
  const void* dt;
  const float* a;
  const void* bm;
  const void* cm;
  const float* h0;  // null: start from zero
  void* y;
  float* h_last;
  int B, S, H, P;
  int64_t x_sb, x_ss, x_sh;
  int64_t dt_sb, dt_ss, dt_sh;
  int64_t b_sb, b_ss, c_sb, c_ss;
  int64_t y_sb, y_ss, y_sh;
  int dt_bf16, out_bf16;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ inline size_t smem_floats(int n, int ps) {
  // B and C tiles (row stride n + 1), the weight tile (row stride kQ + 1), the
  // x and u tiles, the state snapshot (row stride n + 1), then cum, exp(cum),
  // coef and dt: one float a row each.
  return 2 * (size_t)kQ * (n + 1) + (size_t)kQ * (kQ + 1) + 2 * (size_t)kQ * ps +
         (size_t)ps * (n + 1) + 4 * (size_t)kQ;
}

template <typename T, int N, int PS>
__global__ void __launch_bounds__(kThreads) mamba2_ssd_kernel(const Params p) {
  constexpr int NS = N + 1;                 // row stride of Bs, Cs, Hs
  constexpr int WS = kQ + 1;                // row stride of Ws
  constexpr int HN = PS * N / kThreads;     // state elements a thread owns
  constexpr int PSTEP = kThreads / N;       // state rows between them
  constexpr int R = kQ / kTY;               // rows of a thread's tiles
  constexpr int C = kQ / kTX;               // columns of its C B^T tile
  constexpr int YC = PS / kTX;              // state rows of its y tile
  static_assert(HN >= 1 && HN * kThreads == PS * N, "state must split evenly");

  extern __shared__ float smem[];
  float* Bs = smem;
  float* Cs = Bs + kQ * NS;
  float* Ws = Cs + kQ * NS;
  float* Xs = Ws + kQ * WS;
  float* Us = Xs + kQ * PS;
  float* Hs = Us + kQ * PS;
  float* cum = Hs + PS * NS;
  float* efs = cum + kQ;   // exp(da_cum): decay from the chunk's start
  float* coef = efs + kQ;  // dt * exp(da_total - da_cum): decay to its end
  float* dts = coef + kQ;

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int p0 = blockIdx.x * PS;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const float a = p.a[head];

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + head * p.x_sh + p0;
  const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb;
  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb;
  const int64_t dt0 = b * p.dt_sb + head * p.dt_sh;
  const int64_t y0 = b * p.y_sb + head * p.y_sh + p0;

  // ---- the state, in registers: h[k] is h[hp + k * PSTEP][hn] ---------------
  const int hn = tid % N;
  const int hp = tid / N;
  const int64_t hbase = ((int64_t)(b * p.H + head) * p.P + p0) * N;
  float h[HN];
#pragma unroll
  for (int k = 0; k < HN; ++k)
    h[k] = p.h0 ? p.h0[hbase + (int64_t)(hp + k * PSTEP) * N + hn] : 0.f;

  for (int c0 = 0; c0 < p.S; c0 += kQ) {
    const int nq = min(kQ, p.S - c0);

    __syncthreads();  // the previous chunk's readers are done
    // ---- tiles of this chunk, upcast once; rows past nq are zero ---------------
    for (int e = tid; e < kQ * N; e += kThreads) {
      const int r = e / N, n = e % N;
      const bool ok = r < nq;
      Bs[r * NS + n] = ok ? to_float(bg[(int64_t)(c0 + r) * p.b_ss + n]) : 0.f;
      Cs[r * NS + n] = ok ? to_float(cg[(int64_t)(c0 + r) * p.c_ss + n]) : 0.f;
    }
    for (int e = tid; e < kQ * PS; e += kThreads) {
      const int r = e / PS, q = e % PS;
      Xs[e] = r < nq ? to_float(xg[(int64_t)(c0 + r) * p.x_ss + q]) : 0.f;
    }
    if (tid < kQ) {
      float d = 0.f;
      if (tid < nq) {
        const int64_t off = dt0 + (int64_t)(c0 + tid) * p.dt_ss;
        d = p.dt_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.dt)[off])
                      : static_cast<const float*>(p.dt)[off];
      }
      dts[tid] = d;
    }
    __syncthreads();

    // ---- da_cum: prefix sum over the chunk, warp 0, rows 2l and 2l + 1 a lane ---
    if (tid < 32) {
      const float v0 = dts[2 * tid] * a;
      const float v1 = dts[2 * tid + 1] * a;
      float s = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, s, off);
        if (tid >= off) s += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) excl = 0.f;
      const float c_0 = excl + v0;
      const float c_1 = c_0 + v1;
      const float total = __shfl_sync(0xffffffffu, c_1, 31);
      cum[2 * tid] = c_0;
      cum[2 * tid + 1] = c_1;
      efs[2 * tid] = expf(c_0);
      efs[2 * tid + 1] = expf(c_1);
      coef[2 * tid] = dts[2 * tid] * expf(total - c_0);
      coef[2 * tid + 1] = dts[2 * tid + 1] * expf(total - c_1);
    }
    __syncthreads();
    const float total = cum[kQ - 1];

    // ---- publish h (the state before this chunk); u = x * coef -----------------
#pragma unroll
    for (int k = 0; k < HN; ++k) Hs[(hp + k * PSTEP) * NS + hn] = h[k];
    for (int e = tid; e < kQ * PS; e += kThreads) Us[e] = Xs[e] * coef[e / PS];

    // ---- W = (C B^T) o L o dt, lower triangle -----------------------------------
    {
      float g[R][C];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) g[r][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[R], bv[C];
#pragma unroll
        for (int r = 0; r < R; ++r) cv[r] = Cs[(ty + kTY * r) * NS + n];
#pragma unroll
        for (int c = 0; c < C; ++c) bv[c] = Bs[(tx + kTX * c) * NS + n];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = ty + kTY * r;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = tx + kTX * c;
          // a select, not a product with a 0/1 mask: exp of the upper triangle
          // may be inf
          Ws[i * WS + j] = (i >= j) ? g[r][c] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = W x + exp(da_cum) o (C h^T) --------------------------------------
    {
      float acc[R][YC], inter[R][YC];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < YC; ++c) acc[r][c] = inter[r][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < nq; ++j) {
        float wv[R], xv[YC];
#pragma unroll
        for (int r = 0; r < R; ++r) wv[r] = Ws[(ty + kTY * r) * WS + j];
#pragma unroll
        for (int c = 0; c < YC; ++c) xv[c] = Xs[j * PS + tx + kTX * c];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < YC; ++c) acc[r][c] = fmaf(wv[r], xv[c], acc[r][c]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[R], hv[YC];
#pragma unroll
        for (int r = 0; r < R; ++r) cv[r] = Cs[(ty + kTY * r) * NS + n];
#pragma unroll
        for (int c = 0; c < YC; ++c) hv[c] = Hs[(tx + kTX * c) * NS + n];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < YC; ++c) inter[r][c] = fmaf(cv[r], hv[c], inter[r][c]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = ty + kTY * r;
        if (i < nq) {
          const int64_t row = y0 + (int64_t)(c0 + i) * p.y_ss;
#pragma unroll
          for (int c = 0; c < YC; ++c) {
            const float v = acc[r][c] + efs[i] * inter[r][c];
            if (p.out_bf16)
              static_cast<__nv_bfloat16*>(p.y)[row + tx + kTX * c] = __float2bfloat16(v);
            else
              static_cast<float*>(p.y)[row + tx + kTX * c] = v;
          }
        }
      }
    }

    // ---- h <- exp(da_total) h + B^T u (reads Bs and Us only: no barrier) --------
    {
      float s[HN];
#pragma unroll
      for (int k = 0; k < HN; ++k) s[k] = 0.f;
#pragma unroll 4
      for (int j = 0; j < nq; ++j) {
        const float bv = Bs[j * NS + hn];
#pragma unroll
        for (int k = 0; k < HN; ++k) s[k] = fmaf(bv, Us[j * PS + hp + k * PSTEP], s[k]);
      }
      const float dec = expf(total);
#pragma unroll
      for (int k = 0; k < HN; ++k) h[k] = h[k] * dec + s[k];
    }
  }

#pragma unroll
  for (int k = 0; k < HN; ++k) p.h_last[hbase + (int64_t)(hp + k * PSTEP) * N + hn] = h[k];
}

template <typename T, int N, int PS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats(N, PS) * sizeof(float);
  auto kernel = mamba2_ssd_kernel<T, N, PS>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(p.P / PS, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int N>
int launch_ps(const Params& p, int ps, cudaStream_t stream) {
  if (ps <= 0 || p.P % ps != 0) return -2;
  if (ps == 16) return (int)launch<T, N, 16>(p, stream);
  if (ps == 32) return (int)launch<T, N, 32>(p, stream);
  if (ps == 64) return (int)launch<T, N, 64>(p, stream);
  return -2;  // a p_block this build does not have
}

template <typename T>
int launch_n(const Params& p, int n, int ps, cudaStream_t stream) {
  if (n == 16) return launch_ps<T, 16>(p, ps, stream);
  if (n == 32) return launch_ps<T, 32>(p, ps, stream);
  if (n == 64) return launch_ps<T, 64>(p, ps, stream);
  if (n == 128) return launch_ps<T, 128>(p, ps, stream);
  return -1;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block takes at state width n and p_block ps.
long long repro_mamba2_ssd_smem_bytes(int n, int ps) {
  return (long long)(smem_floats(n, ps) * sizeof(float));
}

// Enqueues the kernel on `stream` and returns cudaGetLastError() (0 = launched),
// or a negative code for arguments no instantiation takes: -1 state width,
// -2 p_block, -3 element type, -4 shape.  dtype codes: 0 float32, 1 bfloat16
// (x, bm and cm share `dtype`; a is float32; h0 and h_last are float32 and
// contiguous (B, H, P, N); h0 may be null).  Never synchronises, allocates
// nothing.
int repro_mamba2_ssd(
    const void* x, const void* dt, const void* a, const void* bm, const void* cm,
    const void* h0, void* y, void* h_last,
    int B, int S, int H, int P, int N,
    int64_t x_sb, int64_t x_ss, int64_t x_sh,
    int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,
    int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,
    int64_t y_sb, int64_t y_ss, int64_t y_sh,
    int dtype, int dt_dtype, int out_dtype, int p_block, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || B > 65535 || H > 65535) return -4;
  if (dt_dtype < 0 || dt_dtype > 1 || out_dtype < 0 || out_dtype > 1) return -3;
  if (out_dtype == 1 && dtype != 1) return -3;  // y in fp32 or in x's type
  Params p;
  p.x = x; p.dt = dt; p.a = static_cast<const float*>(a); p.bm = bm; p.cm = cm;
  p.h0 = static_cast<const float*>(h0);
  p.y = y; p.h_last = static_cast<float*>(h_last);
  p.B = B; p.S = S; p.H = H; p.P = P;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh;
  p.dt_sb = dt_sb; p.dt_ss = dt_ss; p.dt_sh = dt_sh;
  p.b_sb = b_sb; p.b_ss = b_ss; p.c_sb = c_sb; p.c_ss = c_ss;
  p.y_sb = y_sb; p.y_ss = y_ss; p.y_sh = y_sh;
  p.dt_bf16 = dt_dtype; p.out_bf16 = out_dtype;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_n<float>(p, N, p_block, s);
  if (dtype == 1) return launch_n<__nv_bfloat16>(p, N, p_block, s);
  return -3;
}

}  // extern "C"
