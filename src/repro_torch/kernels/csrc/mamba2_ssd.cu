// Mamba-2 SSD chunk scan for Hopper (sm_90a), with the recurrent state kept on
// chip across the whole sequence, in two paths chosen per call by the wrapper.
//
// Replaces the TPU kernel `_ssd_kernel` launched by `ssd_pallas`
// (src/repro/kernels/mamba2_ssd.py:37).  Both paths compute the same function,
// per (batch, head), with da = dt * a:
//
//     within each chunk      da_cum = cumsum(da), da_total = da_cum[last]
//     y  = ((C B^T) o L o dt_j) x + exp(da_cum) o (C h^T),
//          L[i][j] = exp(da_cum[i] - da_cum[j]) for i >= j, else 0
//     h <- exp(da_total) h + B^T (dt o exp(da_total - da_cum) o x)
//
// starting from h = 0 or from a given h0, and emit y and the last h (fp32).
// Beyond the reference kernel they take any S >= 1 (the ragged tail is masked:
// its dt and x rows are zero, which adds exactly nothing), an initial state,
// and write y in fp32 or in x's type.  Common to both:
//
//   * grid (P / PS, H, B): a block owns PS rows of one head's state.  Row p of
//     h evolves on its own and y[:, p] needs only h[p, :] and x[:, p], so the
//     split is exact; it fills the card at prefill (B = 1) at the price of
//     computing C B^T once per block instead of once per head.  The wrapper
//     chooses PS from the block count against the card's 132 SMs;
//   * the loop over chunks of 64 rows runs INSIDE the block (the TPU's
//     sequential grid axis has no counterpart on a GPU: blocks run in no
//     order), and h stays in registers across it, never touching device memory
//     until the end.  That placement is the register-demotion decision this
//     repository is about; `ptxas -v` (the build phase of chip_smoke.py)
//     reports whether it spills.  64 rows, not the reference's 256: the result
//     does not depend on the chunk in exact arithmetic (it is the
//     state-passing form at a smaller chunk), and the plain version
//     (ssd_plain) walks the same 64-row chunks;
//   * x, dt, B, C and y are read and written in the model's layout through
//     their strides, so the column slices of the convolution's output that the
//     model hands over are not copied.
//
// What bounds it on an H100: at the main path's shapes (one prompt of 512
// tokens; mamba2_370m: H = 32, P = 64, N = 128; zamba2_2_7b: H = 80, P = 64,
// N = 64) the bytes that must move are 7.7 / 17.3 MB and the operations of the
// 64-row dual form 0.61 / 0.84 GFLOP, so bytes bound it (2.3 / 5.2 us).  Yet
// the chunks of one head run in series inside a block, so what a block does
// per chunk, and how long it waits, sets the time.
//
// Path "fma" (fp32 x, B, C: every fp32 call).  All products are fp32 FMAs on
// the CUDA cores (no TF32, no bf16 products), so fp32 inputs meet the
// reference's 2e-4.  256 threads as 16 (ty) x 16 (tx): C B^T, thread (ty, tx)
// owns rows ty + 16 r and columns tx + 16 c (r, c < 4) of the 64 x 64 tile; y:
// rows ty + 16 r, state rows tx + 16 c (c < PS / 16); h: column n = tid % N of
// state rows tid / N + k * (256 / N).  Tiles are upcast to fp32 in shared
// memory; h is published there once a chunk for C h^T; da_cum is a
// warp-shuffle prefix sum (warp 0, two rows a lane).
//
// Path "mma" (bf16 x, B and C: the model's call, with fp32 or bf16 dt).  Eight
// warps, two a 16-row tile of the chunk.  Every product runs on the tensor
// cores as mma.sync m16n8k16 with bf16 operands and fp32 accumulators:
//
//   * C B^T for the row tile's 16 rows, the 16-column tiles above the
//     diagonal skipped and the others shared out between the two warps; the
//     scores are scaled in registers by L o dt and repacked into A fragments
//     for W x.  Left of the diagonal tile L is the product of two decays
//     through the tile's first row, exp(da_cum[i] - da_cum[m]) (two a lane)
//     and exp(da_cum[m] - da_cum[j]) dt[j] (computed once a chunk with the
//     prefix sum), both at most 1; on it, one exp2 an element under a select,
//     never a product with a 0/1 mask (exp of the upper triangle may be inf);
//   * C h^T from C's A fragments (shared with C B^T) and a snapshot of h in
//     shared memory, its k-steps shared out between the two warps; scaled by
//     exp(da_cum) in the y accumulators, which W x then adds to.  The second
//     warp's partial y reaches the first through shared memory;
//   * h <- exp(da_total) h + u^T B with u = dt exp(da_total - da_cum) x, where
//     h is the accumulator fragment that stays in registers across the whole
//     chunk loop; the warps share out its 16 x 16 tiles.  u^T comes from x by
//     ldmatrix.trans, B^T likewise.
//
//   bf16 x, B and C are exact mma operands.  W, u and the snapshot of h are
//   fp32; each goes in as two bf16 operands, hi = bf16(v) and lo = bf16(v - hi),
//   two mma's each, which keeps about 16 bits of each value: the path stays
//   near fp32 accuracy and the plain version needs no rounding of its own.
//
//   The next chunk's B, C and x rows (bf16, rows padded by 16 bytes so that
//   ldmatrix is free of bank conflicts) and dt come in by cp.async into a
//   two-stage ring while this chunk computes; the ragged tail is zero-filled;
//   an operand that is not 16-byte aligned (and a bf16 dt) takes an
//   element-wise fill instead.  Every warp computes da_cum itself by shuffles
//   into its own shared row, and the snapshot of h is double-buffered, so a
//   chunk needs one block barrier and one barrier of each warp pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // fma path
constexpr int kQ = 64;            // rows of a chunk
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kMmaThreads = 256;  // mma path: eight warps, two a 16-row tile
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kRowTiles = 4;      // 16-row tiles of a chunk
constexpr int kPad = 8;           // bf16 elements of padding a shared row

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
  int vec;  // x, B and C rows start on 16-byte boundaries (mma path)
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

// One stage of the mma path's ring: B and C rows (stride n + 8), x rows
// (stride ps + 8), all bf16, then dt (fp32).
__host__ __device__ inline size_t mma_stage_bytes(int n, int ps) {
  return 2 * (size_t)kQ * (n + kPad) * 2 + (size_t)kQ * (ps + kPad) * 2 + (size_t)kQ * 4;
}

// The mma path's block: two stages, two snapshots of h as hi and lo bf16
// halves (stride n + 8), the partial y of each row tile's second warp (fp32),
// and each warp's da_cum, coefficient and decay rows.
__host__ __device__ inline size_t mma_smem_bytes(int n, int ps) {
  return 2 * mma_stage_bytes(n, ps) + 2 * 2 * (size_t)ps * (n + kPad) * 2 +
         (size_t)kQ * ps * 4 + (size_t)kMmaWarps * 3 * kQ * 4;
}

// ---------------------------------------------------------------------------
// Path "fma": fp32 operands on the CUDA cores (instantiated for float only)
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// Path "mma": bf16 operands on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (lower address)
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two fp32 values as two bf16 pairs: hi = bf16(v), lo = bf16(v - hi).  hi + lo
// keeps about 16 bits of v, so two mma's with hi and lo are near an fp32 product.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float h0 = __uint_as_float(hi << 16);
  const float h1 = __uint_as_float(hi & 0xffff0000u);
  lo = pack_bf16(v0 - h0, v1 - h1);
}

// A packed bf16 pair as two floats (bf16 -> fp32 is a 16-bit shift)
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Copies `rows` rows of `width` bf16 from device memory (row stride
// `src_stride` elements) into shared memory (row stride `dst_stride`); rows
// from `valid` on are zero.  With `vec` as 16-byte cp.async copies (the caller
// commits and waits), else element by element (visible after the caller's
// barrier).  A thread keeps one 16-byte column of the rows and steps over
// rows, so the loop holds no division.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int dst_stride,
                                           const __nv_bfloat16* src, int64_t src_stride,
                                           int rows, int valid, int width, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int per_row = width / 8;
    const int rstep = kMmaThreads / per_row;  // width <= 128: at least 16
    const int r0 = tid / per_row;
    const int col = (tid - r0 * per_row) * 8;
    for (int r = r0; r < rows; r += rstep) {
      __nv_bfloat16* d = dst + r * dst_stride + col;
      if (r < valid)
        cp_async16(d, src + (int64_t)r * src_stride + col);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const int total = rows * width;
    for (int c = tid; c < total; c += kMmaThreads) {
      const int r = c / width;
      const int col = c - r * width;
      dst[r * dst_stride + col] =
          r < valid ? src[(int64_t)r * src_stride + col] : __float2bfloat16(0.f);
    }
  }
}

// exp2 on the special-function unit: ex2(-inf) = 0, relative error about 2^-22
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// the two warps of row tile `rt` meet here (named barrier 1 + rt, 64 threads)
__device__ __forceinline__ void pair_sync(int rt) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rt) : "memory");
}

// Fragments: in an m16n8 accumulator a lane (g = lane / 4, t = lane % 4) holds
// rows g and g + 8, columns 2t and 2t + 1.
//
// Eight warps, two a row tile: warp w owns chunk rows 16 rt .. 16 rt + 15
// (rt = w % 4) with its partner w ^ 4, and the pair splits the row tile's
// work in halves (hf = w / 4): the 16-column score tiles j2 = 2 s + hf
// (s < 2) of the lower triangle, W x over those tiles, and the k-steps kk of
// C h^T with kk % 2 == hf.  The second warp's partial y goes through shared
// memory to the first, which adds its own and stores y.  Two warps a row tile
// rather than one: a block is bound by latency (one or two blocks an SM at
// the main path's shapes), and a second warp on each scheduler hides some of
// it (PERF.md).  The state h (PS x N) is cut into 16 x 16 tiles, tile q =
// (q / (N / 16), q % (N / 16)) in (state row, column) tiles; warp w owns the
// tiles q = w, w + 8, ... .
// Narrow states (N <= 64, PS <= 32) are held to 128 registers a thread, so
// that an SM holds two blocks (ptxas fits them without spilling); the others
// take what they need, one block an SM.
template <int N, int PS>
__global__ void __launch_bounds__(kMmaThreads, (N <= 64 && PS <= 32) ? 2 : 1)
    mamba2_ssd_mma_kernel(const Params p) {
  constexpr int SB = N + kPad;       // row stride of B, C and the snapshots
  constexpr int SX = PS + kPad;      // row stride of x
  constexpr int KN = N / 16;         // k-steps over the state width
  constexpr int NP = PS / 16;        // 16-column tiles of a block's state rows
  constexpr int NT = PS / 8;         // 8-column tiles of y
  constexpr int NC = N / 16;         // 16-column tiles of h
  constexpr int T2 = NP * NC;        // 16 x 16 tiles of h
  constexpr int QP = (T2 + kMmaWarps - 1) / kMmaWarps;  // tiles of h a warp owns
  using bf16 = __nv_bfloat16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t stage = mma_stage_bytes(N, PS);
  auto Bs = [&](int s) { return reinterpret_cast<bf16*>(smem_raw + s * stage); };
  auto Cs = [&](int s) { return Bs(s) + kQ * SB; };
  auto Xs = [&](int s) { return Cs(s) + kQ * SB; };
  auto Ds = [&](int s) { return reinterpret_cast<float*>(Xs(s) + kQ * SX); };
  bf16* Hs = reinterpret_cast<bf16*>(smem_raw + 2 * stage);  // [buffer][hi, lo][PS][SB]
  float* ybuf = reinterpret_cast<float*>(Hs + 2 * 2 * PS * SB);  // [row tile][NT * 4][32]
  float* rows_w = ybuf + kQ * PS + (threadIdx.x >> 5) * 3 * kQ;
  float* cum_w = rows_w;            // da_cum of the chunk, this warp's copy
  float* coef_w = rows_w + kQ;      // dt * exp(da_total - da_cum)
  float* gdt_w = rows_w + 2 * kQ;   // dt * exp(da_cum[16 rt] - da_cum), left of the row tile

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rt = warp % kRowTiles, hf = warp / kRowTiles;
  const int g = lane >> 2, t4 = lane & 3;
  const int p0 = blockIdx.x * PS;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const float a = p.a[head];
  const bool vec = p.vec != 0;

  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + head * p.x_sh + p0;
  const bf16* bg = static_cast<const bf16*>(p.bm) + b * p.b_sb;
  const bf16* cg = static_cast<const bf16*>(p.cm) + b * p.c_sb;
  const int64_t dt0 = b * p.dt_sb + head * p.dt_sh;
  const int64_t y0 = b * p.y_sb + head * p.y_sh + p0;
  const int64_t hbase = ((int64_t)(b * p.H + head) * p.P + p0) * N;

  auto issue = [&](int c0, int s) {
    const int nq = min(kQ, p.S - c0);
    stage_rows(Bs(s), SB, bg + (int64_t)c0 * p.b_ss, p.b_ss, kQ, nq, N, vec);
    stage_rows(Cs(s), SB, cg + (int64_t)c0 * p.c_ss, p.c_ss, kQ, nq, N, vec);
    stage_rows(Xs(s), SX, xg + (int64_t)c0 * p.x_ss, p.x_ss, kQ, nq, PS, vec);
    if (tid < kQ) {
      float* d = Ds(s) + tid;
      const int64_t off = dt0 + (int64_t)(c0 + tid) * p.dt_ss;
      if (tid >= nq)
        *d = 0.f;
      else if (p.dt_bf16)
        *d = __bfloat162float(static_cast<const bf16*>(p.dt)[off]);
      else
        cp_async4(d, static_cast<const float*>(p.dt) + off);
    }
  };

  // ---- the state, in registers: hr[i][nt] is the 16 x 8 accumulator of tile
  // q = warp + 8 i, column half nt ------------------------------------------
  float hr[QP][2][4];
#pragma unroll
  for (int i = 0; i < QP; ++i) {
    const int q = warp + kMmaWarps * i;
    const int pr = (q / NC) * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = (q % NC) * 16 + nt * 8 + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = pr + (e >> 1) * 8;
        hr[i][nt][e] = (q < T2 && p.h0) ? p.h0[hbase + (int64_t)r * N + n + (e & 1)] : 0.f;
      }
    }
  }

  // the snapshot of h that C h^T reads, as hi and lo bf16 halves
  auto publish = [&](int buf) {
    bf16* hi = Hs + buf * 2 * PS * SB;
    bf16* lo = hi + PS * SB;
#pragma unroll
    for (int i = 0; i < QP; ++i) {
      const int q = warp + kMmaWarps * i;
      if (q < T2) {
        const int pr = (q / NC) * 16 + g;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int n = (q % NC) * 16 + nt * 8 + 2 * t4;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t vh, vl;
            split_bf16(hr[i][nt][2 * half], hr[i][nt][2 * half + 1], vh, vl);
            const int off = (pr + 8 * half) * SB + n;
            *reinterpret_cast<uint32_t*>(hi + off) = vh;
            *reinterpret_cast<uint32_t*>(lo + off) = vl;
          }
        }
      }
    }
  };

  issue(0, 0);
  cp_async_commit();
  publish(0);

  const int m0 = 16 * rt;        // the row tile's first row
  const int i0 = m0 + g;         // this lane's chunk rows: i0 and i0 + 8
  float* ypart = ybuf + rt * NT * 4 * 32 + lane;
  for (int c = 0, c0 = 0; c0 < p.S; ++c, c0 += kQ) {
    const int s = c & 1;
    const int nq = min(kQ, p.S - c0);
    cp_async_wait_all();  // this chunk's copies (this thread's) have landed
    __syncthreads();      // ... everyone's; the other slot and snapshot are free
    if (c0 + kQ < p.S) issue(c0 + kQ, s ^ 1);
    cp_async_commit();

    const bf16* Bt = Bs(s);
    const bf16* Ct = Cs(s);
    const bf16* Xt = Xs(s);
    const float* Dt = Ds(s);

    // ---- da_cum: every warp its own prefix sum, rows 2l and 2l + 1 a lane ----
    {
      const float d0 = Dt[2 * lane], d1 = Dt[2 * lane + 1];
      const float v0 = d0 * a, v1 = d1 * a;
      float sum = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, sum, off);
        if (lane >= off) sum += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, sum, 1);
      if (lane == 0) excl = 0.f;
      const float c_0 = excl + v0;
      const float c_1 = c_0 + v1;
      const float total = __shfl_sync(0xffffffffu, c_1, 31);
      const float cm = __shfl_sync(0xffffffffu, c_0, 8 * rt);  // da_cum[m0]
      cum_w[2 * lane] = c_0;
      cum_w[2 * lane + 1] = c_1;
      coef_w[2 * lane] = d0 * expf(total - c_0);
      coef_w[2 * lane + 1] = d1 * expf(total - c_1);
      // decay from row j to the row tile's first row m0 (j < m0: at most 1)
      gdt_w[2 * lane] = 2 * lane < m0 ? d0 * ex2((cm - c_0) * kLog2e) : 0.f;
      gdt_w[2 * lane + 1] = 2 * lane + 1 < m0 ? d1 * ex2((cm - c_1) * kLog2e) : 0.f;
    }
    __syncwarp();
    const float total = cum_w[kQ - 1];
    const float cum0 = cum_w[i0], cum1 = cum_w[i0 + 8];

    // ---- scores C B^T (this warp's lower tiles) and its half of C h^T --------
    const bf16* Hhi = Hs + s * 2 * PS * SB;
    const bf16* Hlo = Hhi + PS * SB;
    float sc[2][2][4], yacc[NT][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < 2; ++j) sc[t][j][0] = sc[t][j][1] = sc[t][j][2] = sc[t][j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, Ct + (m0 + (lane & 15)) * SB + kk * 16 + (lane >> 4) * 8);
      const int boff = ((lane & 7) + ((lane >> 4) << 3)) * SB + kk * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j2 = 2 * t + hf;
        if (j2 <= rt) {  // the tiles above the diagonal are skipped
          uint32_t bk[4];
          ldmatrix_x4(bk, Bt + 16 * j2 * SB + boff);
          mma_bf16(sc[t][0], af, bk[0], bk[1]);
          mma_bf16(sc[t][1], af, bk[2], bk[3]);
        }
      }
      if (kk % 2 == hf && (c > 0 || p.h0)) {  // h = 0 before the first chunk
#pragma unroll
        for (int j2 = 0; j2 < NP; ++j2) {
          uint32_t hh[4], hl[4];
          ldmatrix_x4(hh, Hhi + 16 * j2 * SB + boff);
          ldmatrix_x4(hl, Hlo + 16 * j2 * SB + boff);
          mma_bf16(yacc[2 * j2], af, hh[0], hh[1]);
          mma_bf16(yacc[2 * j2 + 1], af, hh[2], hh[3]);
          mma_bf16(yacc[2 * j2], af, hl[0], hl[1]);
          mma_bf16(yacc[2 * j2 + 1], af, hl[2], hl[3]);
        }
      }
    }

    // ---- y = exp(da_cum) o (C h^T) + W x, W = (C B^T) o L o dt ---------------
    const float e0 = expf(cum0), e1 = expf(cum1);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      yacc[j][0] *= e0;
      yacc[j][1] *= e0;
      yacc[j][2] *= e1;
      yacc[j][3] *= e1;
    }
    // left of the diagonal L[i][j] = exp(da_cum[i] - da_cum[m0]) exp(da_cum[m0] -
    // da_cum[j]), both factors at most 1; on it exp(da_cum[i] - da_cum[j]) with
    // a select, not a product with a 0/1 mask: exp of the upper triangle may be inf
    const float f0 = ex2((cum0 - cum_w[m0]) * kLog2e), f1 = ex2((cum1 - cum_w[m0]) * kLog2e);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j2 = 2 * t + hf;
      if (j2 < rt) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float gj = gdt_w[16 * j2 + 8 * nt + 2 * t4 + e];
            sc[t][nt][e] *= f0 * gj;
            sc[t][nt][2 + e] *= f1 * gj;
          }
      } else if (j2 == rt) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 16 * j2 + 8 * nt + 2 * t4 + e;
            const float cj = cum_w[j], dj = Dt[j];
            sc[t][nt][e] = i0 >= j ? sc[t][nt][e] * ex2((cum0 - cj) * kLog2e) * dj : 0.f;
            sc[t][nt][2 + e] = i0 + 8 >= j ? sc[t][nt][2 + e] * ex2((cum1 - cj) * kLog2e) * dj : 0.f;
          }
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j2 = 2 * t + hf;
      if (j2 <= rt) {
        uint32_t wh[4], wl[4];
        split_bf16(sc[t][0][0], sc[t][0][1], wh[0], wl[0]);
        split_bf16(sc[t][0][2], sc[t][0][3], wh[1], wl[1]);
        split_bf16(sc[t][1][0], sc[t][1][1], wh[2], wl[2]);
        split_bf16(sc[t][1][2], sc[t][1][3], wh[3], wl[3]);
#pragma unroll
        for (int jp = 0; jp < NP; ++jp) {
          uint32_t bx[4];
          ldmatrix_x4_trans(bx, Xt + (16 * j2 + (lane & 7) + ((lane >> 3) & 1) * 8) * SX +
                                    16 * jp + (lane >> 4) * 8);
          mma_bf16(yacc[2 * jp], wh, bx[0], bx[1]);
          mma_bf16(yacc[2 * jp + 1], wh, bx[2], bx[3]);
          mma_bf16(yacc[2 * jp], wl, bx[0], bx[1]);
          mma_bf16(yacc[2 * jp + 1], wl, bx[2], bx[3]);
        }
      }
    }
    // ---- the pair's partial sums meet; the half-0 warp stores y -------------
    if (hf) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ypart[(j * 4 + e) * 32] = yacc[j][e];
    }
    pair_sync(rt);
    if (!hf) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] += ypart[(j * 4 + e) * 32];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + 8 * half;
        if (i < nq) {
          const int64_t row = y0 + (int64_t)(c0 + i) * p.y_ss;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = 8 * j + 2 * t4;
            const float v0 = yacc[j][2 * half], v1 = yacc[j][2 * half + 1];
            if (p.out_bf16)
              *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.y) + row + col) =
                  __floats2bfloat162_rn(v0, v1);
            else
              *reinterpret_cast<float2*>(static_cast<float*>(p.y) + row + col) =
                  make_float2(v0, v1);
          }
        }
      }
    }

    // ---- h <- exp(da_total) h + u^T B, u = coef o x --------------------------
    const float dec = expf(total);
#pragma unroll
    for (int i = 0; i < QP; ++i)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hr[i][nt][e] *= dec;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int j = 16 * kk + 2 * t4;
      const float cf0 = coef_w[j], cf1 = coef_w[j + 1], cf8 = coef_w[j + 8],
                  cf9 = coef_w[j + 9];
      const int xrow = 16 * kk + (lane & 7) + ((lane >> 4) & 1) * 8;
      const int brow = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int i = 0; i < QP; ++i) {
        const int q = warp + kMmaWarps * i;
        if (q < T2) {
          // x^T as A fragments: (state row g / g + 8, chunk rows 2t, 2t + 1 / + 8)
          uint32_t xa[4], uh[4], ul[4], bb[4];
          ldmatrix_x4_trans(xa, Xt + xrow * SX + (q / NC) * 16 + ((lane >> 3) & 1) * 8);
          split_bf16(bf16_lo(xa[0]) * cf0, bf16_hi(xa[0]) * cf1, uh[0], ul[0]);
          split_bf16(bf16_lo(xa[1]) * cf0, bf16_hi(xa[1]) * cf1, uh[1], ul[1]);
          split_bf16(bf16_lo(xa[2]) * cf8, bf16_hi(xa[2]) * cf9, uh[2], ul[2]);
          split_bf16(bf16_lo(xa[3]) * cf8, bf16_hi(xa[3]) * cf9, uh[3], ul[3]);
          ldmatrix_x4_trans(bb, Bt + brow * SB + (q % NC) * 16 + (lane >> 4) * 8);
          mma_bf16(hr[i][0], uh, bb[0], bb[1]);
          mma_bf16(hr[i][1], uh, bb[2], bb[3]);
          mma_bf16(hr[i][0], ul, bb[0], bb[1]);
          mma_bf16(hr[i][1], ul, bb[2], bb[3]);
        }
      }
    }
    publish(s ^ 1);  // the next chunk's snapshot: read after its barrier
  }
  cp_async_wait_all();  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < QP; ++i) {
    const int q = warp + kMmaWarps * i;
    if (q < T2) {
      const int pr = (q / NC) * 16 + g;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = (q % NC) * 16 + nt * 8 + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(p.h_last + hbase + (int64_t)(pr + 8 * half) * N + n) =
              make_float2(hr[i][nt][2 * half], hr[i][nt][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch_kernel(K kernel, dim3 grid, int threads, size_t smem, const Params& p,
                          cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

enum Path { kFma = 0, kMma = 1 };

template <int N, int PS>
int launch(const Params& p, int path, cudaStream_t stream) {
  const dim3 grid(p.P / PS, p.H, p.B);
  if (path == kFma)
    return (int)launch_kernel(mamba2_ssd_kernel<float, N, PS>, grid, kThreads,
                              smem_floats(N, PS) * sizeof(float), p, stream);
  return (int)launch_kernel(mamba2_ssd_mma_kernel<N, PS>, grid, kMmaThreads,
                            mma_smem_bytes(N, PS), p, stream);
}

template <int N>
int launch_ps(const Params& p, int path, int ps, cudaStream_t stream) {
  if (ps <= 0 || p.P % ps != 0) return -2;
  if (ps == 16) return launch<N, 16>(p, path, stream);
  if (ps == 32) return launch<N, 32>(p, path, stream);
  if (ps == 64) return launch<N, 64>(p, path, stream);
  return -2;  // a p_block this build does not have
}

int launch_n(const Params& p, int path, int n, int ps, cudaStream_t stream) {
  if (n == 16) return launch_ps<16>(p, path, ps, stream);
  if (n == 32) return launch_ps<32>(p, path, ps, stream);
  if (n == 64) return launch_ps<64>(p, path, ps, stream);
  if (n == 128) return launch_ps<128>(p, path, ps, stream);
  return -1;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of `path` (0 fma, 1 mma) takes at state
// width n and p_block ps.
long long repro_mamba2_ssd_smem_bytes(int path, int n, int ps) {
  if (path == kFma) return (long long)(smem_floats(n, ps) * sizeof(float));
  if (path == kMma) return (long long)mma_smem_bytes(n, ps);
  return -1;
}

// Enqueues the kernel of `path` on `stream` and returns cudaGetLastError()
// (0 = launched), or a negative code for arguments no instantiation takes:
// -1 state width, -2 p_block, -3 element type, -4 shape, -5 a path that does
// not take the element type (fp32: fma; bf16: mma).  dtype codes: 0 float32,
// 1 bfloat16 (x, bm and cm share `dtype`; a is float32; h0 and h_last are
// float32 and contiguous (B, H, P, N); h0 may be null).  `vec` non-zero
// promises that x, bm and cm and all their strides are multiples of 16 bytes
// (the mma path then copies 16 bytes at a time).  Never synchronises,
// allocates nothing.
int repro_mamba2_ssd(
    const void* x, const void* dt, const void* a, const void* bm, const void* cm,
    const void* h0, void* y, void* h_last,
    int B, int S, int H, int P, int N,
    int64_t x_sb, int64_t x_ss, int64_t x_sh,
    int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,
    int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,
    int64_t y_sb, int64_t y_ss, int64_t y_sh,
    int dtype, int dt_dtype, int out_dtype, int p_block, int path, int vec, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || B > 65535 || H > 65535) return -4;
  if (dtype < 0 || dtype > 1 || dt_dtype < 0 || dt_dtype > 1 || out_dtype < 0 ||
      out_dtype > 1)
    return -3;
  if (out_dtype == 1 && dtype != 1) return -3;  // y in fp32 or in x's type
  if (!((dtype == 0 && path == kFma) || (dtype == 1 && path == kMma))) return -5;
  Params p;
  p.x = x; p.dt = dt; p.a = static_cast<const float*>(a); p.bm = bm; p.cm = cm;
  p.h0 = static_cast<const float*>(h0);
  p.y = y; p.h_last = static_cast<float*>(h_last);
  p.B = B; p.S = S; p.H = H; p.P = P;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh;
  p.dt_sb = dt_sb; p.dt_ss = dt_ss; p.dt_sh = dt_sh;
  p.b_sb = b_sb; p.b_ss = b_ss; p.c_sb = c_sb; p.c_ss = c_ss;
  p.y_sb = y_sb; p.y_ss = y_ss; p.y_sh = y_sh;
  p.dt_bf16 = dt_dtype; p.out_bf16 = out_dtype; p.vec = vec;
  return launch_n(p, path, N, p_block, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
