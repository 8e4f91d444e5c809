// Flash attention for Hopper (sm_90a): online softmax over KV tiles with the
// running state kept on chip, in three paths chosen per call by the wrapper.
//
// Replaces the TPU kernel `_attention_kernel` launched by `flash_attention_bh`
// (src/repro/kernels/flash_attention.py).  Every path computes the same function,
//
//     out = softmax(q k^T * scale + mask) v
//     mask: kp >= 0 and kp <= qp and kp > qp - window and kp // chunk == qp // chunk
//
// by the same recurrence (m = running max, l = normaliser, acc = output
// accumulator; a masked score is the finite NEG_INF = -1e30, so a row whose
// every key is masked yields the mean of the v rows; out = acc / max(l, 1e-30)).
// q, k, v and out are read and written in the model layout (B, S, H, Dh)
// through their strides (no transpose, no copy of K / V per query group);
// positions are (B, S) int32, possibly with stride 0; window and chunk are
// runtime integers (1 << 30 = unrestricted), so one build serves every layer.
//
// Masked-tile skipping (mma and split paths).  Positions are data (padding at
// -1, unequal slot lengths, windows that start mid-tile), so nothing is derived
// from arange.  Before its KV loop a block passes once over the kpos row and
// learns (a) which KV tiles may hold a key that one of its live rows sees (a
// conservative test against the rows' min / max position) and (b) exactly
// whether every live row sees at least one key somewhere in the whole range.
// Only if (b) holds are the tiles of (a)'s complement skipped: no load, no
// arithmetic.  That is exact: once a row's m is finite a masked score adds
// exp(-1e30 - m) = 0, and the corr = 0 step wipes what masked tiles added
// before the first visible key.  If some live row sees no key, nothing is
// skipped and that row gets the mean of all Skv value rows.  The decision is
// taken on the device and never reaches the host.
//
// Path "fma" (fp32 inputs only; any query count).  grid (ceil(Sq/BQ), B*Hq),
// 256 threads as 16 row groups x 16 column lanes; q, k, v in fp32 tiles in
// shared memory, both products as plain fp32 FMAs on the CUDA cores (no TF32,
// so fp32 parity holds at 2e-5).  Bound on this card: operations, at the fp32
// CUDA-core rate.  It serves float32 calls only, where parity comes first;
// bf16 calls never take it.
//
// Path "mma" (bf16 inputs, longer queries: prefill).  Bound by the operations
// of the two products, which only the tensor cores can deliver.  The
// FlashAttention-2 form with mma.sync.m16n8k16 (bf16 in, fp32 accumulate):
// grid (ceil(Sq/64), B*Hq), four warps, each owning 16 query rows of a 64-row
// Q tile.  Q is loaded once (cp.async) and, up to Dh = 128, held in registers
// as A fragments (ldmatrix); at Dh = 256 its fragments would not fit beside
// acc (128 floats a thread), so Q stays in shared memory and is re-read with
// ldmatrix per k-step.  K and V stay bf16 in shared memory, rows padded by 16
// bytes so that ldmatrix (and ldmatrix.trans for V) is free of bank
// conflicts, staged through a two-stage ring of cp.async 16-byte copies (a
// third stage measured no faster on the card).  S lives in
// the fp32 accumulator fragments; the mask is applied there from the staged
// position tiles; the online softmax runs on the fragments with quad
// shuffles; P is rounded to bf16 in registers and fed straight back as the A
// operand of P V.  m / l / acc never leave the registers: the placement of
// loop-carried state that this repository is about.
//
// Path "split" (bf16 inputs, decode: Sq * (Hq/Hkv) <= 16 rows, 8 above Dh = 128,
// where 16 rows' accumulators, 128 floats a lane, would spill).  Bound by the
// bytes of K and V.  grid (splits, B*Hkv): one block serves every query head of
// a kv head (GQA by rows), so each K/V row is read once per (batch, kv head).
// The wrapper picks the fewest splits that fill one wave of resident blocks
// (one split at B*Hkv = 256): each block pays a fixed set-up, so more splits
// than that were slower on the card.  The splits share out the tiles to visit,
// not the key range, so skipping leaves them balanced.  Four warps, each with
// its own ring of cp.async 16-byte copies (32 keys a stage, two stages up to
// Dh = 128: eight tiles, 256 keys, in flight a block; one stage above, where two
// would not fit), walk interleaved tiles of the block's share; no warp waits at
// a block barrier inside the loop.  A lane owns one key for the scores and
// column pairs for the output (fp32 FMAs on unpacked bf16: the work is bound
// by bytes).  The warps' states are merged in shared memory, each split writes
// (m, l, acc) in fp32 to a workspace, and the last block of a (batch, kv head)
// to finish (an atomic ticket that it resets) combines the splits:
//     m = max m_i,  l = sum l_i e^(m_i - m),  acc = sum acc_i e^(m_i - m).
// A split whose tiles were all skipped contributes (-1e30, 0, 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // fma path
constexpr int kWarps = kThreads / 32;
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr float kNegInf = -1e30f;

constexpr int kMmaThreads = 128;   // four warps of 16 query rows
constexpr int kMmaBQ = 64;
constexpr int kMmaStages = 2;       // K / V tiles in the copy ring
constexpr int kSplitThreads = 128;  // four warps
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitKeys = 32;      // keys of one warp's tile: one a lane
constexpr int kMaxRows = 16;        // query rows a split block serves ...
constexpr int kMaxRowsWide = 8;     // ... above Dh = 128
constexpr int kPad = 8;             // bf16 elements of padding a shared row

// stages of a split warp's copy ring: two up to Dh = 128; one above, where two
// would not fit the block's shared memory
__host__ __device__ constexpr int split_stages(int dh) { return dh > 128 ? 1 : 2; }

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
  int splits;
  float* ws;      // split path: partial (m, l) then acc, fp32
  int* tickets;   // split path: one counter per (batch, kv head), zero between launches
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

// Python's //: rounds toward minus infinity (C's / truncates).  d > 0.
__device__ __forceinline__ int floor_div(int a, int d) {
  int q = a / d;
  return (a % d < 0) ? q - 1 : q;
}

// The mask of one (query, key) pair, without a division in the inner loops: a
// power-of-two chunk (BIG = 1 << 30 among them) is a shift, which floors as //
// does, and a query's chunk index is computed once (qc = bucket(qp)).  kp >= 0
// first: C's division differs from Python's only below zero.
struct Mask {
  int window, chunk, shift;  // shift = log2(chunk), or -1
  __device__ __forceinline__ explicit Mask(const Params& p)
      : window(p.window), chunk(p.chunk), shift(-1) {
    if ((chunk & (chunk - 1)) == 0)
      for (shift = 0; (1 << shift) < chunk; ++shift) {
      }
  }
  __device__ __forceinline__ int bucket(int x) const {
    return shift >= 0 ? x >> shift : floor_div(x, chunk);
  }
  __device__ __forceinline__ bool sees(int qp, int qc, int kp) const {
    return kp >= 0 && kp <= qp && kp > qp - window && bucket(kp) == qc;
  }
};

// exp2 on the special-function unit; ex2(-1.44e30) = 0 and ex2(0) = 1 exactly
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// asynchronous copies and tensor-core fragments
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

// waits until at most `Pending` groups of this thread are in flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
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

// Copies `rows` rows of `dh` bf16 from device memory (row stride `src_stride`
// elements) into shared memory (row stride `dst_stride`); rows from `valid`
// on are zero.  `lane` / `nlanes` are the caller's threads (a warp or the
// block); with `vec` as 16-byte cp.async copies (the caller commits and
// waits), else element by element (visible after the caller's barrier).  A
// lane keeps one 16-byte column of the rows and steps over rows, so the loop
// holds no division.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int dst_stride,
                                           const __nv_bfloat16* src, int64_t src_stride,
                                           int rows, int valid, int dh, bool vec, int lane,
                                           int nlanes) {
  if (vec) {
    const int per_row = dh / 8;
    const int rstep = nlanes / per_row;  // rows one pass covers (dh <= 256: at least 1)
    const int r0 = lane / per_row;
    if (r0 >= rstep) return;             // the lanes past rstep * per_row copy nothing
    const int col = (lane - r0 * per_row) * 8;
    for (int r = r0; r < rows; r += rstep) {
      __nv_bfloat16* d = dst + r * dst_stride + col;
      if (r < valid)
        cp_async16(d, src + (int64_t)r * src_stride + col);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const int total = rows * dh;
    for (int c = lane; c < total; c += nlanes) {
      const int r = c / dh;
      const int col = c - r * dh;
      dst[r * dst_stride + col] =
          r < valid ? src[(int64_t)r * src_stride + col] : __float2bfloat16(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// The pre-pass: which KV tiles to walk
// ---------------------------------------------------------------------------

// All threads of the block take part.  `qp_s` holds the positions of the
// block's nq (<= 64) distinct live query rows.  For every tile t of `tile`
// keys it sets flags[t] = 1 if one of those rows may see a key of the tile,
// and partial[t] = 1 unless every row surely sees every key of it (both
// conservative, from the rows' smallest and largest position).  It returns
// whether every live row sees at least one key in [0, Skv), decided exactly:
// a row that sees no key turns skipping off.  kpos values are loaded U
// chunks of 32 at a time, so their latencies overlap.
__device__ bool plan_tiles(const int* kpos, int64_t kp_ss, int Skv, int tile, const int* qp_s,
                           int nq, const Mask& mk, unsigned char* flags, unsigned char* partial,
                           unsigned long long* seen_s) {
  constexpr int U = 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int qmin = 0x7fffffff, qmax = -0x7fffffff - 1;
  for (int r = 0; r < nq; ++r) {
    qmin = min(qmin, qp_s[r]);
    qmax = max(qmax, qp_s[r]);
  }
  const int cmin = mk.bucket(qmin), cmax = mk.bucket(qmax);
  const unsigned long long full = nq == 64 ? ~0ull : ((1ull << nq) - 1ull);
  const int ntiles = (Skv + tile - 1) / tile;
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x) flags[t] = partial[t] = 0;
  if (threadIdx.x == 0) *seen_s = 0ull;
  __syncthreads();

  const int stride = nwarps * 32;
  for (int base = warp * 32; base < Skv; base += U * stride) {
    int kpv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = base + u * stride + lane;
      kpv[u] = k < Skv ? kpos[(int64_t)k * kp_ss] : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = base + u * stride + lane;
      if (k - lane >= Skv) break;  // uniform
      const int kp = kpv[u];
      const int kc = kp >= 0 ? mk.bucket(kp) : 0;
      const bool maybe = kp >= 0 && kp <= qmax && kp > qmin - mk.window && kc >= cmin &&
                         kc <= cmax;
      const bool sure = kp >= 0 && kp <= qmin && kp > qmax - mk.window && kc == cmin &&
                        cmin == cmax;
      if (maybe) flags[k / tile] = 1;
      if (!sure && k < Skv) partial[k / tile] = 1;
      // one value for the whole warp: the loop below holds warp-wide votes
      unsigned long long have = *reinterpret_cast<volatile unsigned long long*>(seen_s);
      have = ((unsigned long long)__shfl_sync(0xffffffffu, (unsigned)(have >> 32), 0) << 32) |
             (unsigned long long)__shfl_sync(0xffffffffu, (unsigned)have, 0);
      if (have != full && __any_sync(0xffffffffu, maybe)) {
        unsigned long long mine = 0ull;
        for (int r = 0; r < nq; ++r) {
          if ((have >> r) & 1ull) continue;
          const int qp = qp_s[r];
          if (__any_sync(0xffffffffu, maybe && mk.sees(qp, mk.bucket(qp), kp))) mine |= 1ull << r;
        }
        if (lane == 0 && mine) atomicOr(seen_s, mine);
      }
    }
  }
  // keys past Skv of the last tile make it partial
  if (threadIdx.x == 0 && Skv % tile) partial[ntiles - 1] = 1;
  __syncthreads();
  return *seen_s == full;
}

// The next tile to walk after `t` (or `t_end`): every tile when skipping is off.
__device__ __forceinline__ int next_tile(int t, int t_end, bool skip, const unsigned char* flags) {
  ++t;
  if (skip)
    while (t < t_end && !flags[t]) ++t;
  return t;
}

// ---------------------------------------------------------------------------
// Path "fma": fp32 operands on the CUDA cores
// ---------------------------------------------------------------------------
//
// Thread layout: 256 threads as 16 (ty, rows) x 16 (tx, columns).  Thread
// (ty, tx) owns query rows ty*RM .. ty*RM+RM-1 and the strided columns
// tx + 16*j, both of the score tile (j < NKJ) and of the output (j < NJ).  The 16
// threads of one row group are half a warp, so row reductions are shuffles and
// the P tile needs only a warp-level barrier between its writers and readers.

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

__host__ __device__ inline size_t fma_smem_bytes(int dh, int bq, int bkv) {
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

  const Mask mk(p);
  int qp[RM], qc[RM];
  float m[RM], l[RM], acc[RM][NJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    qp[i] = qpos_s[row0 + i];
    qc[i] = mk.bucket(qp[i]);
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
        const bool ok = col < nkv && mk.sees(qp[i], qc[i], kpos_s[col]);
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

// ---------------------------------------------------------------------------
// Path "mma": bf16 operands on the tensor cores (prefill)
// ---------------------------------------------------------------------------
//
// Warp w owns query rows 16w .. 16w+15 of the 64-row tile.  In the m16n8k16
// fragments a lane (g = lane / 4, t = lane % 4) holds rows g and g + 8 and,
// of every 8-column n-tile, columns 2t and 2t + 1: so does each score and
// output fragment, and the row reductions of the softmax are shuffles within
// a quad.  Shared rows are dh + 8 elements: (dh + 8) / 2 words is an odd
// multiple of 4 for every dh that is a multiple of 16, so the eight 16-byte
// rows one ldmatrix phase reads fall in distinct banks.

__host__ __device__ inline size_t mma_smem_bytes(int dh, int bkv, int skv) {
  const size_t row = (size_t)(dh + kPad) * 2;  // one padded bf16 row
  const int ntiles = (skv + bkv - 1) / bkv;
  return kMmaBQ * row                          // Q
         + 2 * (size_t)kMmaStages * bkv * row  // K and V rings
         + (size_t)kMmaStages * bkv * 4        // kpos ring
         + kMmaBQ * 4                      // qpos
         + 16                                  // the rows that see a key
         + 2 * (size_t)((ntiles + 15) & ~15);  // tile flags: may be seen, not surely seen
}

template <int DHC, int BKV, bool QREG>
__global__ void __launch_bounds__(kMmaThreads, 1) flash_attention_mma_kernel(const Params p) {
  constexpr int KS = DHC / 16;  // k-steps of q k^T
  constexpr int NS = BKV / 8;   // n-tiles of the score tile
  constexpr int NO = DHC / 8;   // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];

  constexpr int S = kMmaStages;
  const int dh = p.dh;
  const int stride = dh + kPad;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kMmaBQ * stride;
  __nv_bfloat16* Vs = Ks + S * BKV * stride;
  int* kpos_s = reinterpret_cast<int*>(Vs + S * BKV * stride);
  int* qpos_s = kpos_s + S * BKV;
  unsigned long long* seen_s = reinterpret_cast<unsigned long long*>(qpos_s + kMmaBQ);
  unsigned char* flags = reinterpret_cast<unsigned char*>(seen_s + 2);
  unsigned char* partial = flags + ((p.Skv + BKV - 1) / BKV + 15) / 16 * 16;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const Mask mk(p);
  const float scale2 = p.scale * kLog2e;  // scores in log2 units: p = 2^(s - m)
  const bool vec = p.vec != 0;

  const int b = blockIdx.y / p.Hq;
  const int h = blockIdx.y % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  // the last query block first: under a causal mask it has the most keys to
  // walk, so the long blocks start in the first wave and the short ones fill in
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaBQ;
  const int nq = min(kMmaBQ, p.Sq - q0);
  const int Skv = p.Skv;

  using bf16 = __nv_bfloat16;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh + (int64_t)q0 * p.q_ss;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  bf16* og = static_cast<bf16*>(p.out) + b * p.o_sb + h * p.o_sh + (int64_t)q0 * p.o_ss;
  const int* kp_g = p.kpos + b * p.kp_sb;

  // ---- the query tile (its own copy group), positions, the tile plan ----------
  stage_rows(Qs, stride, qg, p.q_ss, kMmaBQ, nq, dh, vec, tid, kMmaThreads);
  cp_async_commit();
  if (tid < kMmaBQ)
    qpos_s[tid] = tid < nq ? p.qpos[b * p.qp_sb + (int64_t)(q0 + tid) * p.qp_ss] : -1;
  __syncthreads();
  const int ntiles = (Skv + BKV - 1) / BKV;
  const bool skip = plan_tiles(kp_g, p.kp_ss, Skv, BKV, qpos_s, nq, mk, flags, partial, seen_s);

  auto issue = [&](int t, int slot) {
    const int kv0 = t * BKV;
    const int nkv = min(BKV, Skv - kv0);
    stage_rows(Ks + slot * BKV * stride, stride, kg + (int64_t)kv0 * p.k_ss, p.k_ss, BKV, nkv,
               dh, vec, tid, kMmaThreads);
    stage_rows(Vs + slot * BKV * stride, stride, vg + (int64_t)kv0 * p.v_ss, p.v_ss, BKV, nkv,
               dh, vec, tid, kMmaThreads);
    if (tid < BKV) {
      int* d = kpos_s + slot * BKV + tid;
      if (tid < nkv)
        cp_async4(d, kp_g + (int64_t)(kv0 + tid) * p.kp_ss);
      else
        *d = -1;
    }
  };

  // ---- prologue: the first S - 1 tiles in flight -----------------------------
  int t_load = next_tile(-1, ntiles, skip, flags);
  int t_comp = t_load;
  for (int s = 0; s < S - 1; ++s) {
    if (t_load < ntiles) {
      issue(t_load, s);
      t_load = next_tile(t_load, ntiles, skip, flags);
    }
    cp_async_commit();  // empty groups too: the wait below counts groups
  }

  const int r0 = warp * 16 + g;  // this lane's rows: r0 and r0 + 8
  const int qp0 = qpos_s[r0], qp1 = qpos_s[r0 + 8];
  const int qc0 = mk.bucket(qp0), qc1 = mk.bucket(qp1);
  uint32_t qf[QREG ? KS : 1][4];
  const bf16* qa = Qs + (warp * 16 + (lane & 15)) * stride + (lane >> 4) * 8;
  if (QREG) {
    cp_async_wait<S - 1>();  // the query tile has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      if (16 * kk < dh) ldmatrix_x4(qf[QREG ? kk : 0], qa + kk * 16);
  }

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; t_comp < ntiles; ++i) {
    cp_async_wait<S - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();       // ... everyone's, and tile i - 1's slot is free
    if (t_load < ntiles) {
      issue(t_load, (i + S - 1) % S);
      t_load = next_tile(t_load, ntiles, skip, flags);
    }
    cp_async_commit();

    const int slot = i % S;
    const bf16* Kt = Ks + slot * BKV * stride;
    const bf16* Vt = Vs + slot * BKV * stride;
    const int* kpt = kpos_s + slot * BKV;
    const int nkv = min(BKV, Skv - t_comp * BKV);

    // ---- s = q k^T on the tensor cores ---------------------------------------
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (16 * kk < dh) {
        uint32_t a[4];
        if (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[QREG ? kk : 0][e];
        } else {
          ldmatrix_x4(a, qa + kk * 16);
        }
#pragma unroll
        for (int j2 = 0; j2 < NS / 2; ++j2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, Kt + (16 * j2 + (lane & 7) + ((lane >> 4) << 3)) * stride + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * j2], a, bk[0], bk[1]);
          mma_bf16(s[2 * j2 + 1], a, bk[2], bk[3]);
        }
      }
    }

    // ---- mask and online softmax on the fragments ----------------------------
    // a tile every live row surely sees wholly (the pre-pass) takes no mask
    const bool masked = partial[t_comp] != 0;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (masked) {
          const int col = 8 * j + 2 * t4 + e;
          const int kp = kpt[col];
          const bool ex = col < nkv;
          s[j][e] = ex && mk.sees(qp0, qc0, kp) ? s[j][e] * scale2 : kNegInf;
          s[j][2 + e] = ex && mk.sees(qp1, qc1, kp) ? s[j][2 + e] * scale2 : kNegInf;
        } else {
          s[j][e] *= scale2;
          s[j][2 + e] *= scale2;
        }
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // a column past Skv does not exist: it adds nothing, masked or not
        const bool ex = !masked || 8 * j + 2 * t4 + e < nkv;
        s[j][e] = ex ? ex2(s[j][e] - mn0) : 0.f;
        s[j][2 + e] = ex ? ex2(s[j][2 + e] - mn1) : 0.f;
        rs0 += s[j][e];
        rs1 += s[j][2 + e];
      }
    }
    l0 = l0 * c0 + rs0;  // this lane's columns; the quad is summed at the end
    l1 = l1 * c1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }

    // ---- acc += p v: p in bf16 from the score fragments, v by ldmatrix.trans --
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j2 = 0; j2 < NO / 2; ++j2) {
        if (16 * j2 < dh) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, Vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * stride +
                                    16 * j2 + (lane >> 4) * 8);
          mma_bf16(acc[2 * j2], a, bv[0], bv[1]);
          mma_bf16(acc[2 * j2 + 1], a, bv[2], bv[3]);
        }
      }
    }
    t_comp = next_tile(t_comp, ntiles, skip, flags);
  }
  cp_async_wait<0>();  // no copy outlives the block

  // ---- out = acc / max(l, 1e-30), bf16 -----------------------------------------
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = 1.f / fmaxf(l0, 1e-30f), d1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (8 * j < dh) {
      const int col = 8 * j + 2 * t4;
      if (r0 < nq)
        *reinterpret_cast<uint32_t*>(og + (int64_t)r0 * p.o_ss + col) =
            pack_bf16(acc[j][0] * d0, acc[j][1] * d0);
      if (r0 + 8 < nq)
        *reinterpret_cast<uint32_t*>(og + (int64_t)(r0 + 8) * p.o_ss + col) =
            pack_bf16(acc[j][2] * d1, acc[j][3] * d1);
    }
  }
}

// ---------------------------------------------------------------------------
// Path "split": bf16 decode, split over the KV range
// ---------------------------------------------------------------------------
//
// Row r of a block is query i = r % Sq of query head hk * groups + r / Sq.
// RC is the row class (1, 4, 8 or 16 rows computed; rows past R are never
// written).  A lane owns key `lane` of its warp's tile for the scores, and
// output column pairs 2 (lane + 32 i), i < NP.

__host__ __device__ inline size_t split_smem_bytes(int dh, int rc, int skv) {
  const int stages = split_stages(dh);
  const size_t row = (size_t)(dh + kPad) * 2;
  const int ntiles = (skv + kSplitKeys - 1) / kSplitKeys;
  // the K / V rings also hold the merge of the warps' states (W x RC x (dh + 2) floats)
  return 2 * (size_t)kSplitWarps * stages * kSplitKeys * row  // K and V rings
         + (size_t)rc * dh * 4                                // q rows, fp32
         + (size_t)kSplitWarps * kSplitKeys * rc * 4          // p of each warp's tile
         + (size_t)kSplitWarps * stages * kSplitKeys * 4      // kpos rings
         + kMaxRows * 4                                       // qpos
         + 16                                                 // the rows that see a key
         + 2 * (size_t)((ntiles + 15) & ~15);                 // tile flags
}

template <int DHC, int RC>
__global__ void __launch_bounds__(kSplitThreads, 1) flash_attention_split_kernel(const Params p) {
  constexpr int NP = (DHC + 63) / 64;  // column pairs a lane owns
  constexpr int W = kSplitWarps;
  constexpr int T = kSplitKeys;
  constexpr int S = split_stages(DHC);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using bf16 = __nv_bfloat16;

  const int dh = p.dh;
  const int stride = dh + kPad;
  bf16* Kr = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vr = Kr + W * S * T * stride;
  float* q_s = reinterpret_cast<float*>(Vr + W * S * T * stride);
  float* p_s = q_s + RC * dh;
  int* kpos_r = reinterpret_cast<int*>(p_s + W * T * RC);
  int* qpos_s = kpos_r + W * S * T;
  unsigned long long* seen_s = reinterpret_cast<unsigned long long*>(qpos_s + kMaxRows);
  unsigned char* flags = reinterpret_cast<unsigned char*>(seen_s + 2);
  unsigned char* partial = flags + ((p.Skv + T - 1) / T + 15) / 16 * 16;
  __shared__ int last_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool vec = p.vec != 0;
  const int groups = p.Hq / p.Hkv;
  const int Sq = p.Sq;
  const int R = groups * Sq;
  const int bh = blockIdx.y;
  const int b = bh / p.Hkv, hk = bh % p.Hkv;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int Skv = p.Skv;
  const int ntiles = (Skv + T - 1) / T;
  const Mask mk(p);
  const float scale2 = p.scale * kLog2e;  // scores in log2 units: p = 2^(s - m)

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + (int64_t)hk * groups * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int* kp_g = p.kpos + b * p.kp_sb;

  // ---- positions and the tile plan; the query rows once the first tiles are
  // in flight (below), so that their latencies overlap ----------------------
  if (tid < Sq) qpos_s[tid] = p.qpos[b * p.qp_sb + (int64_t)tid * p.qp_ss];
  __syncthreads();
  const bool skip = plan_tiles(kp_g, p.kp_ss, Skv, T, qpos_s, Sq, mk, flags, partial, seen_s);
  // the splits share out the tiles to visit, not the key range: with skipping,
  // each gets the same number of tiles whatever the slot's length
  int nvis = 0;
  for (int t = 0; t < ntiles; ++t) nvis += !skip || flags[t];
  const int v_begin = (int)((int64_t)split * nvis / nsplit);
  const int v_end = (int)((int64_t)(split + 1) * nvis / nsplit);

  int rowpos[RC], rowc[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    rowpos[r] = r < R ? qpos_s[r % Sq] : -1;
    rowc[r] = mk.bucket(rowpos[r]);
  }

  // ---- each warp walks every W-th tile to visit, through its own ring ---------
  bf16* Kw = Kr + warp * S * T * stride;
  bf16* Vw = Vr + warp * S * T * stride;
  int* kpw = kpos_r + warp * S * T;
  float* pw = p_s + warp * T * RC;
  auto advance = [&](int t, int n) {
    for (int c = 0; c < n; ++c) t = next_tile(t, ntiles, skip, flags);
    return t;
  };
  auto issue = [&](int t, int slot) {
    const int kv0 = t * T;
    const int nkv = min(T, Skv - kv0);
    stage_rows(Kw + slot * T * stride, stride, kg + (int64_t)kv0 * p.k_ss, p.k_ss, T, nkv, dh,
               vec, lane, 32);
    stage_rows(Vw + slot * T * stride, stride, vg + (int64_t)kv0 * p.v_ss, p.v_ss, T, nkv, dh,
               vec, lane, 32);
    int* d = kpw + slot * T + lane;
    if (lane < nkv)
      cp_async4(d, kp_g + (int64_t)(kv0 + lane) * p.kp_ss);
    else
      *d = -1;
  };

  float m[RC], l[RC], acc[RC][NP][2];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[r][i][0] = acc[r][i][1] = 0.f;
  }

  // this warp visits the tiles of visit index v_begin + warp, + W, ... < v_end
  int v_load = v_begin + warp;
  int t_load = advance(-1, v_load + 1);
  int v_comp = v_load, t_comp = t_load;
  for (int s = 0; s < S - 1; ++s) {
    if (v_load < v_end) {
      issue(t_load, s);
      t_load = advance(t_load, W);
      v_load += W;
    }
    cp_async_commit();
  }
  for (int c = tid; c < RC * dh; c += kSplitThreads) {
    const int r = c / dh, d = c - r * dh;
    q_s[c] = r < R ? __bfloat162float(qg[(int64_t)(r % Sq) * p.q_ss + (r / Sq) * p.q_sh + d])
                   : 0.f;
  }
  __syncthreads();  // the query rows are every warp's
  for (int it = 0; v_comp < v_end; ++it) {
    if (v_load < v_end) {  // into the slot the previous tile freed
      issue(t_load, (it + S - 1) % S);
      t_load = advance(t_load, W);
      v_load += W;
    }
    cp_async_commit();
    cp_async_wait<S - 1>();  // this tile has landed (this lane's copies) ...
    __syncwarp();          // ... and every lane's

    const int slot = it % S;
    const bf16* Kt = Kw + slot * T * stride;
    const bf16* Vt = Vw + slot * T * stride;
    const int nkv = min(T, Skv - t_comp * T);
    const bool exists = lane < nkv;
    const int kp = kpw[slot * T + lane];

    // ---- scores of this lane's key -------------------------------------------
    float s[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) s[r] = 0.f;
    const bf16* krow = Kt + lane * stride;
#pragma unroll 2
    for (int d0 = 0; d0 < dh; d0 += 8) {
      float kf[8];
      unpack(*reinterpret_cast<const uint4*>(krow + d0), kf, bf16());
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const float4 qa = *reinterpret_cast<const float4*>(q_s + r * dh + d0);
        const float4 qb = *reinterpret_cast<const float4*>(q_s + r * dh + d0 + 4);
        s[r] = fmaf(qa.x, kf[0], s[r]);
        s[r] = fmaf(qa.y, kf[1], s[r]);
        s[r] = fmaf(qa.z, kf[2], s[r]);
        s[r] = fmaf(qa.w, kf[3], s[r]);
        s[r] = fmaf(qb.x, kf[4], s[r]);
        s[r] = fmaf(qb.y, kf[5], s[r]);
        s[r] = fmaf(qb.z, kf[6], s[r]);
        s[r] = fmaf(qb.w, kf[7], s[r]);
      }
    }

    // ---- mask, online softmax over the warp's keys ----------------------------
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const float sr = exists && mk.sees(rowpos[r], rowc[r], kp) ? s[r] * scale2 : kNegInf;
      float mx = sr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float c = ex2(m[r] - mn);
      // a key past Skv does not exist: it adds nothing, masked or not
      const float pr = exists ? ex2(sr - mn) : 0.f;
      l[r] = l[r] * c + pr;  // this lane's keys; the warp is summed at the end
      m[r] = mn;
      s[r] = pr;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        acc[r][i][0] *= c;
        acc[r][i][1] *= c;
      }
    }
    if constexpr (RC % 4 == 0) {
#pragma unroll
      for (int r = 0; r < RC; r += 4)
        *reinterpret_cast<float4*>(pw + lane * RC + r) = make_float4(s[r], s[r + 1], s[r + 2], s[r + 3]);
    } else {
#pragma unroll
      for (int r = 0; r < RC; ++r) pw[lane * RC + r] = s[r];
    }
    __syncwarp();

    // ---- acc += p v over the tile's keys ----------------------------------------
#pragma unroll 4
    for (int j = 0; j < nkv; ++j) {
      float pj[RC];
      if constexpr (RC % 4 == 0) {
#pragma unroll
        for (int r = 0; r < RC; r += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(pw + j * RC + r);
          pj[r] = v4.x;
          pj[r + 1] = v4.y;
          pj[r + 2] = v4.z;
          pj[r + 3] = v4.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < RC; ++r) pj[r] = pw[j * RC + r];
      }
      const bf16* vrow = Vt + j * stride;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int c = 2 * (lane + 32 * i);
        if (c < dh) {
          const uint32_t raw = *reinterpret_cast<const uint32_t*>(vrow + c);
          const float v0 = __uint_as_float(raw << 16), v1 = __uint_as_float(raw & 0xffff0000u);
#pragma unroll
          for (int r = 0; r < RC; ++r) {
            acc[r][i][0] = fmaf(pj[r], v0, acc[r][i][0]);
            acc[r][i][1] = fmaf(pj[r], v1, acc[r][i][1]);
          }
        }
      }
    }
    __syncwarp();  // the slot and p are free for the next tile
    t_comp = advance(t_comp, W);
    v_comp += W;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);

  // ---- merge the warps' states in shared memory (over the rings) --------------
  __syncthreads();
  float* m_w = reinterpret_cast<float*>(smem_raw);  // [W][RC]
  float* l_w = m_w + W * RC;                        // [W][RC]
  float* a_w = l_w + W * RC;                        // [W][RC][dh]
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    if (lane == 0) {
      m_w[warp * RC + r] = m[r];
      l_w[warp * RC + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int c = 2 * (lane + 32 * i);
      if (c < dh) {
        a_w[(warp * RC + r) * dh + c] = acc[r][i][0];
        a_w[(warp * RC + r) * dh + c + 1] = acc[r][i][1];
      }
    }
  }
  __syncthreads();

  using out_t = bf16;
  out_t* og = static_cast<out_t*>(p.out) + b * p.o_sb + (int64_t)hk * groups * p.o_sh;
  float* ws_ml = p.ws + ((int64_t)bh * nsplit + split) * kMaxRows * 2;
  float* ws_acc = p.ws + (int64_t)gridDim.y * nsplit * kMaxRows * 2 +
                  ((int64_t)bh * nsplit + split) * kMaxRows * dh;
  for (int c = tid; c < R * dh; c += kSplitThreads) {
    const int r = c / dh, d = c - r * dh;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) M = fmaxf(M, m_w[w * RC + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float e = ex2(m_w[w * RC + r] - M);
      L += l_w[w * RC + r] * e;
      A += a_w[(w * RC + r) * dh + d] * e;
    }
    if (nsplit == 1) {
      og[(int64_t)(r % Sq) * p.o_ss + (r / Sq) * p.o_sh + d] = __float2bfloat16(A / fmaxf(L, 1e-30f));
    } else {
      ws_acc[r * dh + d] = A;
      if (d == 0) {
        ws_ml[2 * r] = M;
        ws_ml[2 * r + 1] = L;
      }
    }
  }
  if (nsplit == 1) return;

  // ---- the last split of this (batch, kv head) to finish combines them ---------
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(p.tickets + bh, 1) == nsplit - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* ml_all = p.ws + (int64_t)bh * nsplit * kMaxRows * 2;
  const float* acc_all = p.ws + (int64_t)gridDim.y * nsplit * kMaxRows * 2 +
                         (int64_t)bh * nsplit * kMaxRows * dh;
  for (int c = tid; c < R * dh; c += kSplitThreads) {
    const int r = c / dh, d = c - r * dh;
    float M = kNegInf;
    for (int sp = 0; sp < nsplit; ++sp) M = fmaxf(M, __ldcg(ml_all + sp * kMaxRows * 2 + 2 * r));
    float L = 0.f, A = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float e = ex2(__ldcg(ml_all + sp * kMaxRows * 2 + 2 * r) - M);
      L += __ldcg(ml_all + sp * kMaxRows * 2 + 2 * r + 1) * e;
      A += __ldcg(acc_all + (int64_t)sp * kMaxRows * dh + r * dh + d) * e;
    }
    og[(int64_t)(r % Sq) * p.o_ss + (r / Sq) * p.o_sh + d] = __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
  if (tid == 0) p.tickets[bh] = 0;  // ready for the next launch
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

// fp32 only: bf16 calls take the mma and split paths
template <int NJ>
int launch_fma(const Params& p, int bq, int bkv, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(p.dh, bq, bkv);
  const dim3 grid((p.Sq + bq - 1) / bq, p.B * p.Hq);
  if (bq == 64 && bkv == 64)
    return (int)launch_kernel(flash_attention_kernel<float, NJ, 4, 4>, grid, kThreads, smem, p, stream);
  if (bq == 64 && bkv == 32)
    return (int)launch_kernel(flash_attention_kernel<float, NJ, 4, 2>, grid, kThreads, smem, p, stream);
  if (bq == 16 && bkv == 64)
    return (int)launch_kernel(flash_attention_kernel<float, NJ, 1, 4>, grid, kThreads, smem, p, stream);
  if (bq == 16 && bkv == 32)
    return (int)launch_kernel(flash_attention_kernel<float, NJ, 1, 2>, grid, kThreads, smem, p, stream);
  return -2;  // a tile this build does not have
}

template <int DHC, bool QREG>
int launch_mma(const Params& p, int bkv, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(p.dh, bkv, p.Skv);
  const dim3 grid((p.Sq + kMmaBQ - 1) / kMmaBQ, p.B * p.Hq);
  if (bkv == 64)
    return (int)launch_kernel(flash_attention_mma_kernel<DHC, 64, QREG>, grid, kMmaThreads, smem,
                              p, stream);
  if (bkv == 32)
    return (int)launch_kernel(flash_attention_mma_kernel<DHC, 32, QREG>, grid, kMmaThreads, smem,
                              p, stream);
  return -2;
}

template <int DHC>
int launch_split(const Params& p, cudaStream_t stream) {
  const int rows = (p.Hq / p.Hkv) * p.Sq;
  if (rows > (DHC > 128 ? kMaxRowsWide : kMaxRows) || p.splits < 1) return -2;
  if (p.splits > 1 && (p.ws == nullptr || p.tickets == nullptr)) return -4;
  const dim3 grid(p.splits, p.B * p.Hkv);
  const int rc = rows <= 1 ? 1 : rows <= 4 ? 4 : rows <= 8 ? 8 : 16;
  const size_t smem = split_smem_bytes(p.dh, rc, p.Skv);
  switch (rc) {
    case 1: return (int)launch_kernel(flash_attention_split_kernel<DHC, 1>, grid, kSplitThreads, smem, p, stream);
    case 4: return (int)launch_kernel(flash_attention_split_kernel<DHC, 4>, grid, kSplitThreads, smem, p, stream);
    case 8: return (int)launch_kernel(flash_attention_split_kernel<DHC, 8>, grid, kSplitThreads, smem, p, stream);
  }
  // the 16-row class only up to Dh = 128: wider, the wrapper sends 9-16 rows to mma
  if constexpr (DHC <= 128)
    return (int)launch_kernel(flash_attention_split_kernel<DHC, 16>, grid, kSplitThreads, smem, p, stream);
  return -2;
}

enum Path { kFma = 0, kMma = 1, kSplit = 2 };

// the instantiated head-width class: the smallest of 64, 80, 128, 256 that
// covers dh; fp32 takes the fma path, bf16 the mma and split paths
int launch_path(const Params& p, int dtype, int path, int bq, int bkv, cudaStream_t stream) {
  const int dh = p.dh;
  if (dh <= 0 || dh % 16 != 0 || dh > 256) return -1;
  if (dtype == 0 && path == kFma) {
    if (dh <= 64) return launch_fma<4>(p, bq, bkv, stream);
    if (dh == 80) return launch_fma<5>(p, bq, bkv, stream);
    if (dh <= 128) return launch_fma<8>(p, bq, bkv, stream);
    return launch_fma<16>(p, bq, bkv, stream);
  }
  if (dtype == 1 && path == kMma) {
    if (dh <= 64) return launch_mma<64, true>(p, bkv, stream);
    if (dh == 80) return launch_mma<80, true>(p, bkv, stream);
    if (dh <= 128) return launch_mma<128, true>(p, bkv, stream);
    return launch_mma<256, false>(p, bkv, stream);
  }
  if (dtype == 1 && path == kSplit) {
    if (dh <= 64) return launch_split<64>(p, stream);
    if (dh == 80) return launch_split<80>(p, stream);
    if (dh <= 128) return launch_split<128>(p, stream);
    return launch_split<256>(p, stream);
  }
  return -5;  // the path does not take this element type
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of `path` takes: fma (bq, bkv); mma (bkv,
// skv); split (bq = the row class, skv).
long long repro_flash_attention_smem_bytes(int path, int dh, int bq, int bkv, int skv) {
  if (path == kFma) return (long long)fma_smem_bytes(dh, bq, bkv);
  if (path == kMma) return (long long)mma_smem_bytes(dh, bkv, skv);
  if (path == kSplit) return (long long)split_smem_bytes(dh, bq, skv);
  return -1;
}

// Enqueues the kernel of `path` on `stream` and returns cudaGetLastError()
// (0 = launched), or a negative code for arguments no instantiation takes:
// -1 head width, -2 tile / rows, -3 element type, -4 shape or workspace,
// -5 a path that does not take the element type (fp32: fma; bf16: mma, split).  `vec` non-zero promises that q, k and v and all their
// strides are multiples of 16 bytes.  The split path with splits > 1 needs
// `ws` (fp32, B*Hkv*splits*16*(dh + 2) floats) and `tickets` (B*Hkv int32,
// zero; the kernel leaves them zero).  Never synchronises, allocates nothing.
int repro_flash_attention(
    const void* q, const void* k, const void* v, const void* qpos, const void* kpos, void* out,
    int B, int Sq, int Skv, int Hq, int Hkv, int dh,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int64_t qp_sb, int64_t qp_ss, int64_t kp_sb, int64_t kp_ss,
    int window, int chunk, float scale, int dtype, int path, int bq, int bkv, int splits,
    int vec, void* ws, void* tickets, void* stream) {
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
  p.splits = splits;
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return -3;
  return launch_path(p, dtype, path, bq, bkv, s);
}

}  // extern "C"
