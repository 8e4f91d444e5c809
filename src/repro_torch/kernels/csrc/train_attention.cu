// Training attention for Hopper (sm_90a): the forward and the backward of the
// attention that the trainer's `chunked` path computes, on the tensor cores.
//
// Replaces no TPU kernel.  The reference trains through its `chunked` loop
// (src/repro/models/attention.py `attention_chunked`, a `lax.scan` that XLA
// compiles); its Pallas kernel `_attention_kernel` has no backward.  The port's
// loop (src/repro_torch/models/attention.py) runs that scan in float32
// PyTorch: every chunk's score tensor in device memory, the masked half of
// the causal square computed, autograd's backward over all of it.  These
// kernels compute the same function,
//
//     out = softmax(q k^T * scale + mask) v
//     mask: kp >= 0 and kp <= qp and kp > qp - window and kp // chunk == qp // chunk
//
// and its gradients, as one autograd function (kernels/train_attention.py).
//
// Bound on this card: operations.  Causal attention at 4,096 tokens, Dh 80,
// does about 1,000 operations for every byte it must read or write (q, k, v,
// o, their gradients, LSE), forward and backward alike, above the card's 295
// a byte: only the tensor cores can deliver them.  So every
// product is an mma.sync.m16n8k16 (bf16 operands, fp32 accumulators), the
// running state stays in registers, no score tile reaches device memory, and
// tiles that the mask wholly hides are never computed.
//
// Forward, grid (ceil(Sq/64), B*Hq), four warps of 16 query rows: the
// online-softmax recurrence of the serving `mma` path (m, l and acc in fp32
// registers, P rounded to bf16 into the A operand of P V, K and V through a
// two-stage cp.async ring), which also writes LSE = m + log l in fp32 for
// each (batch, head, query row).
//
// Backward, FlashAttention-2's recomputation from LSE, deterministic: no
// atomics, every sum in one block in a fixed order.
//   * `dot`, one warp a row: D = rowsum(dO * O), fp32.
//   * `dkdv`, grid (ceil(Skv/64), B*Hkv): a block owns 64 keys (16 a warp)
//     and walks the visible 32-row query tiles of every query head of its kv
//     head's group.  Per tile it recomputes S^T = K Q^T, P^T = exp(S^T scale -
//     LSE), and accumulates dV += P^T dO and dK += dS^T Q, dS^T = P^T *
//     (V dO^T - D), in fp32 registers.  The accumulators (2 x Dh/2 floats a
//     lane) are the loop-carried state; the staged operands (the Q and dO
//     tiles, LSE, D and the positions) stay in shared memory, and the query
//     tile is 32 rows: at 64, the score and dP fragments beside the
//     accumulators take 204 registers at Dh 80 (208 at Dh 128, against 160)
//     and the kernel ran 7 % slower on the card (PERF.md).
//   * `dq`, grid (ceil(Sq/64), B*Hq): a block owns 64 query rows and walks
//     their visible 32-key tiles, accumulating dQ += dS K in fp32 (64-key
//     tiles took 210 registers against 156 and ran 12 % slower).
// P and dS are rounded to bf16 before their products, as P is in the
// forward; m, l, LSE, D and every accumulator stay fp32.
//
// Skipped tiles.  Positions are data, so before its loop each block passes
// once over the other side's positions and flags the tiles that one of its
// rows may see (a conservative test against the rows' or keys' smallest and
// largest position), and the tiles that every row surely sees whole (those
// take no mask).  A tile no row may see is skipped, which is exact: a row that
// sees a key adds exp(-1e30 - m) = 0 for a hidden one.  A row that sees no key
// at all gets what the chunked loop gives it, the mean over its keys padded
// to a whole number of chunks (`pad_keys`): out = sum(v) / pad_keys, LSE =
// +inf as its mark, dQ = 0 and dV += dO / pad_keys on every key.  Training's
// own positions never produce one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps of 16 rows
constexpr int kBQ = 64;        // query rows of a forward or dq block
constexpr int kTile = 32;      // keys of a KV tile of a forward or dq block
constexpr int kKeys = 64;      // keys of a dkdv block
constexpr int kBR = 32;        // query rows of a dkdv tile
constexpr int kStages = 2;     // tiles in a copy ring (a third measured slower)
constexpr int kPad = 8;        // bf16 elements of padding a shared row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;     // the forward's output (backward)
  const bf16* dout;  // its gradient (backward)
  bf16* out;         // forward
  float* lse;        // (B, Hq, Sq)
  float* dsum;       // D, (B, Hq, Sq)
  bf16* dq;          // dq, dk, dv and out are contiguous (B, S, H, Dh)
  bf16* dk;
  bf16* dv;
  const int* qpos;   // (B, Sq) contiguous
  const int* kpos;   // (B, Skv) contiguous
  int B, Sq, Skv, Hq, Hkv, dh;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t do_sb, do_ss, do_sh;
  int window, chunk, pad_keys;
  float scale;
};

// Python's //: rounds toward minus infinity (C's / truncates).  d > 0.
__device__ __forceinline__ int floor_div(int a, int d) {
  int q = a / d;
  return (a % d < 0) ? q - 1 : q;
}

// The mask of one (query, key) pair; a power-of-two chunk is a shift.
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

// exp2 on the special-function unit; ex2(-1.44e30) = ex2(-inf) = 0 exactly
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

// The A operand of a 16 x 16 step from accumulator fragments: n-tiles 2 kk and
// 2 kk + 1 of a 16-row product, rounded to bf16 (the accumulator's layout is
// the A operand's, pair by pair).
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4], const float (&c0)[4],
                                           const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Per 16-row warp tile: an A fragment of rows `rows` (row-major, k = the
// head width) at k-step kk; a B fragment pair whose n index runs along the
// rows of `rows` (k = the head width: "non-transposed"); and a B fragment pair
// whose k index runs along the rows (n = the head width: "transposed").
__device__ __forceinline__ const bf16* a_rows(const bf16* rows, int stride, int lane, int kk) {
  return rows + (lane & 15) * stride + (lane >> 4) * 8 + kk * 16;
}
__device__ __forceinline__ const bf16* b_rows(const bf16* rows, int stride, int lane, int j2,
                                              int kk) {
  return rows + (16 * j2 + (lane & 7) + ((lane >> 4) << 3)) * stride + kk * 16 +
         ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const bf16* b_cols(const bf16* rows, int stride, int lane, int kk,
                                              int j2) {
  return rows + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * stride + 16 * j2 +
         (lane >> 4) * 8;
}

// Copies `rows` rows of `dh` bf16 from device memory (row stride `src_stride`
// elements, every row on a 16-byte boundary) into shared memory (row stride
// `dst_stride`) as 16-byte cp.async copies; rows from `valid` on are zero.
// All threads of the block take part; the caller commits and waits.
__device__ __forceinline__ void stage_rows(bf16* dst, int dst_stride, const bf16* src,
                                           int64_t src_stride, int rows, int valid, int dh) {
  const int per_row = dh / 8;
  const int rstep = kThreads / per_row;
  const int r0 = threadIdx.x / per_row;
  if (r0 >= rstep) return;
  const int col = (threadIdx.x - r0 * per_row) * 8;
  for (int r = r0; r < rows; r += rstep) {
    bf16* d = dst + r * dst_stride + col;
    if (r < valid)
      cp_async16(d, src + (int64_t)r * src_stride + col);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__host__ __device__ constexpr size_t pad16(size_t n) { return (n + 15) & ~size_t(15); }

// ---------------------------------------------------------------------------
// The KV tiles a query block walks (forward and dq)
// ---------------------------------------------------------------------------

// For query rows with positions in [qmin, qmax]: flags[t] = 1 if one of them
// may see a key of tile t, partial[t] = 1 unless each surely sees every key
// of it.  All threads take part; kpos loads are U at a time in flight.
__device__ void plan_kv_tiles(const int* kpos, int Skv, int qmin, int qmax, const Mask& mk,
                              unsigned char* flags, unsigned char* partial) {
  constexpr int U = 8;
  const int ntiles = (Skv + kTile - 1) / kTile;
  for (int t = threadIdx.x; t < ntiles; t += kThreads) flags[t] = partial[t] = 0;
  __syncthreads();
  const int cmin = mk.bucket(qmin), cmax = mk.bucket(qmax);
  for (int base = 0; base < Skv; base += U * kThreads) {
    int kpv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = base + u * kThreads + threadIdx.x;
      kpv[u] = k < Skv ? kpos[k] : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = base + u * kThreads + threadIdx.x;
      if (k >= Skv) continue;
      const int kp = kpv[u];
      const int kc = kp >= 0 ? mk.bucket(kp) : 0;
      if (kp >= 0 && kp <= qmax && kp > qmin - mk.window && kc >= cmin && kc <= cmax)
        flags[k / kTile] = 1;
      if (!(kp >= 0 && kp <= qmin && kp > qmax - mk.window && kc == cmin && cmin == cmax))
        partial[k / kTile] = 1;
    }
  }
  // keys past Skv of the last tile must be masked
  if (threadIdx.x == 0 && Skv % kTile) partial[ntiles - 1] = 1;
  __syncthreads();
}

__device__ __forceinline__ int next_flagged(int t, int t_end, const unsigned char* flags) {
  ++t;
  while (t < t_end && !flags[t]) ++t;
  return t;
}

// Shared memory of a query block: its Q tile (and dq's dO tile), the K / V
// rings, the kpos ring, qpos, and two flags a KV tile.
__host__ __device__ inline size_t query_block_smem(int dh, int skv, int row_tiles) {
  const size_t row = (size_t)(dh + kPad) * 2;
  const int ntiles = (skv + kTile - 1) / kTile;
  return row_tiles * kBQ * row + 2 * (size_t)kStages * kTile * row + (size_t)kStages * kTile * 4 +
         kBQ * 4 + 2 * pad16(ntiles);
}

__host__ __device__ inline size_t fwd_smem_bytes(int dh, int skv) {
  return query_block_smem(dh, skv, 1);
}
__host__ __device__ inline size_t dq_smem_bytes(int dh, int skv) {
  return query_block_smem(dh, skv, 2);
}
// dkdv: K and V, the Q / dO rings, the LSE / D / qpos rings, kpos, the tiles
// to walk (one a query head and tile), may-see and partial flags a tile
__host__ __device__ inline size_t dkdv_smem_bytes(int dh, int sq, int groups) {
  const size_t row = (size_t)(dh + kPad) * 2;
  const int ntq = (sq + kBR - 1) / kBR;
  return 2 * (size_t)kKeys * row + 2 * (size_t)kStages * kBR * row +
         3 * (size_t)kStages * kBR * 4 + kKeys * 4 + pad16((size_t)groups * ntq) + 2 * pad16(ntq);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int DHC>
__global__ void __launch_bounds__(kThreads, 1) train_attention_fwd_kernel(const Params p) {
  constexpr int KS = DHC / 16;  // k-steps of q k^T
  constexpr int NS = kTile / 8; // n-tiles of the score tile
  constexpr int NO = DHC / 8;   // n-tiles of the output
  constexpr int S = kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int dh = p.dh;
  const int stride = dh + kPad;
  const int Skv = p.Skv;
  const int ntiles = (Skv + kTile - 1) / kTile;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBQ * stride;
  bf16* Vs = Ks + S * kTile * stride;
  int* kpos_s = reinterpret_cast<int*>(Vs + S * kTile * stride);
  int* qpos_s = kpos_s + S * kTile;
  unsigned char* flags = reinterpret_cast<unsigned char*>(qpos_s + kBQ);
  unsigned char* partial = flags + pad16(ntiles);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const Mask mk(p);
  const float scale2 = p.scale * kLog2e;  // scores in log2 units

  const int b = blockIdx.y / p.Hq;
  const int h = blockIdx.y % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  // the last query block first: under a causal mask it walks the most tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int nq = min(kBQ, p.Sq - q0);

  const bf16* qg = p.q + b * p.q_sb + h * p.q_sh + (int64_t)q0 * p.q_ss;
  const bf16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + hk * p.v_sh;
  const int* kp_g = p.kpos + (int64_t)b * Skv;

  stage_rows(Qs, stride, qg, p.q_ss, kBQ, nq, dh);
  cp_async_commit();
  if (tid < kBQ) qpos_s[tid] = tid < nq ? p.qpos[(int64_t)b * p.Sq + q0 + tid] : -1;
  __syncthreads();
  int qmin = 0x7fffffff, qmax = -0x7fffffff - 1;
  for (int r = 0; r < nq; ++r) {
    qmin = min(qmin, qpos_s[r]);
    qmax = max(qmax, qpos_s[r]);
  }
  plan_kv_tiles(kp_g, Skv, qmin, qmax, mk, flags, partial);

  auto issue = [&](int t, int slot) {
    const int kv0 = t * kTile;
    const int nkv = min(kTile, Skv - kv0);
    stage_rows(Ks + slot * kTile * stride, stride, kg + (int64_t)kv0 * p.k_ss, p.k_ss, kTile, nkv,
               dh);
    stage_rows(Vs + slot * kTile * stride, stride, vg + (int64_t)kv0 * p.v_ss, p.v_ss, kTile, nkv,
               dh);
    if (tid < kTile) {
      int* d = kpos_s + slot * kTile + tid;
      if (tid < nkv)
        cp_async4(d, kp_g + kv0 + tid);
      else
        *d = -1;
    }
  };

  int t_load = next_flagged(-1, ntiles, flags);
  int t_comp = t_load;
  for (int s = 0; s < S - 1; ++s) {
    if (t_load < ntiles) {
      issue(t_load, s);
      t_load = next_flagged(t_load, ntiles, flags);
    }
    cp_async_commit();
  }

  const int r0 = warp * 16 + g;  // this lane's rows: r0 and r0 + 8
  const int qp0 = qpos_s[r0], qp1 = qpos_s[r0 + 8];
  const int qc0 = mk.bucket(qp0), qc1 = mk.bucket(qp1);
  // the query tile's A fragments stay in registers for the whole walk
  const bf16* qa = Qs + warp * 16 * stride;
  uint32_t qf[KS][4];
  cp_async_wait<S - 1>();  // the query tile has landed
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    if (16 * kk < dh) ldmatrix_x4(qf[kk], a_rows(qa, stride, lane, kk));

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; t_comp < ntiles; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (t_load < ntiles) {
      issue(t_load, (i + S - 1) % S);
      t_load = next_flagged(t_load, ntiles, flags);
    }
    cp_async_commit();

    const int slot = i % S;
    const bf16* Kt = Ks + slot * kTile * stride;
    const bf16* Vt = Vs + slot * kTile * stride;
    const int* kpt = kpos_s + slot * kTile;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (16 * kk < dh) {
#pragma unroll
        for (int j2 = 0; j2 < NS / 2; ++j2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, b_rows(Kt, stride, lane, j2, kk));
          mma_bf16(s[2 * j2], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * j2 + 1], qf[kk], bk[2], bk[3]);
        }
      }
    }

    // mask (keys past Skv carry kpos -1) and online softmax on the fragments
    const bool masked = partial[t_comp] != 0;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (masked) {
          const int kp = kpt[8 * j + 2 * t4 + e];
          s[j][e] = mk.sees(qp0, qc0, kp) ? s[j][e] * scale2 : kNegInf;
          s[j][2 + e] = mk.sees(qp1, qc1, kp) ? s[j][2 + e] * scale2 : kNegInf;
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
        s[j][e] = ex2(s[j][e] - mn0);
        s[j][2 + e] = ex2(s[j][2 + e] - mn1);
        rs0 += s[j][e];
        rs1 += s[j][2 + e];
      }
    }
    l0 = l0 * c0 + rs0;
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

#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      a_from_acc(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j2 = 0; j2 < NO / 2; ++j2) {
        if (16 * j2 < dh) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, b_cols(Vt, stride, lane, kk, j2));
          mma_bf16(acc[2 * j2], a, bv[0], bv[1]);
          mma_bf16(acc[2 * j2 + 1], a, bv[2], bv[3]);
        }
      }
    }
    t_comp = next_flagged(t_comp, ntiles, flags);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // a live row whose running max never left -1e30 saw no key: it takes the
  // mean of the v rows padded to pad_keys (what the chunked loop gives it)
  const bool e0 = r0 < nq && m0 == kNegInf, e1 = r0 + 8 < nq && m1 == kNegInf;
  const float* vsum = reinterpret_cast<const float*>(Ks);
  if (__syncthreads_or(e0 || e1)) {  // every warp is past its last read of the ring
    float* sum = reinterpret_cast<float*>(Ks);
    for (int d = tid; d < dh; d += kThreads) {
      float acc_d = 0.f;
      for (int j = 0; j < Skv; ++j) acc_d += __bfloat162float(vg[(int64_t)j * p.v_ss + d]);
      sum[d] = acc_d;
    }
    __syncthreads();
  }
  const float inv_pad = 1.f / (float)p.pad_keys;
  const float d0 = e0 ? inv_pad : 1.f / fmaxf(l0, 1e-30f);
  const float d1 = e1 ? inv_pad : 1.f / fmaxf(l1, 1e-30f);
  bf16* og = p.out + (((int64_t)b * p.Sq + q0) * p.Hq + h) * dh;
  const int64_t o_ss = (int64_t)p.Hq * dh;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (8 * j < dh) {
      const int col = 8 * j + 2 * t4;
      if (r0 < nq)
        *reinterpret_cast<uint32_t*>(og + r0 * o_ss + col) =
            e0 ? pack_bf16(vsum[col] * d0, vsum[col + 1] * d0)
               : pack_bf16(acc[j][0] * d0, acc[j][1] * d0);
      if (r0 + 8 < nq)
        *reinterpret_cast<uint32_t*>(og + (r0 + 8) * o_ss + col) =
            e1 ? pack_bf16(vsum[col] * d1, vsum[col + 1] * d1)
               : pack_bf16(acc[j][2] * d1, acc[j][3] * d1);
    }
  }
  if (t4 == 0) {
    float* lse = p.lse + ((int64_t)b * p.Hq + h) * p.Sq + q0;
    if (r0 < nq) lse[r0] = e0 ? INFINITY : (m0 + log2f(l0)) * kLn2;
    if (r0 + 8 < nq) lse[r0 + 8] = e1 ? INFINITY : (m1 + log2f(l1)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// Backward: D = rowsum(dO * O)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) train_attention_bwd_dot_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int64_t rows = (int64_t)p.B * p.Sq * p.Hq;
  const int64_t step = (int64_t)gridDim.x * (kThreads / 32);
  // rows in (b, s, h) order: neighbouring warps read neighbouring memory
  for (int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); row < rows;
       row += step) {
    const int h = (int)(row % p.Hq);
    const int64_t bs = row / p.Hq;
    const int s = (int)(bs % p.Sq);
    const int b = (int)(bs / p.Sq);
    const bf16* o = p.o + row * p.dh;
    const bf16* d = p.dout + b * p.do_sb + s * p.do_ss + h * p.do_sh;
    float acc = 0.f;
    for (int c = 2 * lane; c < p.dh; c += 64) {
      const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + c));
      const float2 df = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d + c));
      acc = fmaf(of.x, df.x, acc);
      acc = fmaf(of.y, df.y, acc);
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) p.dsum[((int64_t)b * p.Hq + h) * p.Sq + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// Backward: dK and dV, one block a key tile and kv head
// ---------------------------------------------------------------------------

template <int DHC>
__global__ void __launch_bounds__(kThreads, 1) train_attention_bwd_dkdv_kernel(const Params p) {
  constexpr int BR = kBR;
  constexpr int KS = DHC / 16;  // k-steps over the head width
  constexpr int NQ = BR / 8;    // n-tiles along the query rows
  constexpr int NO = DHC / 8;   // n-tiles of dK and dV
  constexpr int S = kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int dh = p.dh;
  const int stride = dh + kPad;
  const int Sq = p.Sq;
  const int groups = p.Hq / p.Hkv;
  const int ntq = (Sq + BR - 1) / BR;
  const int nwalk = groups * ntq;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kKeys * stride;
  bf16* Qs = Vs + kKeys * stride;
  bf16* dOs = Qs + S * BR * stride;
  float* lse_s = reinterpret_cast<float*>(dOs + S * BR * stride);
  float* dsum_s = lse_s + S * BR;
  int* qpos_s = reinterpret_cast<int*>(dsum_s + S * BR);
  int* kpos_s = qpos_s + S * BR;
  unsigned char* walk = reinterpret_cast<unsigned char*>(kpos_s + kKeys);
  unsigned char* maybe = walk + pad16(nwalk);
  unsigned char* partial = maybe + pad16(ntq);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const Mask mk(p);
  const float scale2 = p.scale * kLog2e;
  const float inv_pad = 1.f / (float)p.pad_keys;

  const int b = blockIdx.y / p.Hkv;
  const int hk = blockIdx.y % p.Hkv;
  const int k0 = blockIdx.x * kKeys;  // the first keys first: they have the most rows to walk
  const int nk = min(kKeys, p.Skv - k0);

  stage_rows(Ks, stride, p.k + b * p.k_sb + hk * p.k_sh + (int64_t)k0 * p.k_ss, p.k_ss, kKeys, nk,
             dh);
  stage_rows(Vs, stride, p.v + b * p.v_sb + hk * p.v_sh + (int64_t)k0 * p.v_ss, p.v_ss, kKeys, nk,
             dh);
  cp_async_commit();
  if (tid < kKeys) kpos_s[tid] = tid < nk ? p.kpos[(int64_t)b * p.Skv + k0 + tid] : -1;
  for (int i = tid; i < nwalk; i += kThreads) walk[i] = 0;
  for (int i = tid; i < ntq; i += kThreads) maybe[i] = partial[i] = 0;
  __syncthreads();

  // ---- which query tiles to walk -------------------------------------------
  // the keys' range (positions >= 0) and whether each key of the tile has one
  int kmin = 0x7fffffff, kmax = -1;
  bool whole = nk == kKeys;
  for (int j = 0; j < kKeys; ++j) {
    const int kp = kpos_s[j];
    if (kp >= 0) {
      kmin = min(kmin, kp);
      kmax = max(kmax, kp);
    } else {
      whole = false;
    }
  }
  const bool any_key = kmax >= 0;
  const int kcmin = any_key ? mk.bucket(kmin) : 0, kcmax = any_key ? mk.bucket(kmax) : 0;
  constexpr int U = 8;
  const int* qp_g = p.qpos + (int64_t)b * Sq;
  for (int base = 0; base < Sq; base += U * kThreads) {
    int qpv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * kThreads + tid;
      qpv[u] = r < Sq ? qp_g[r] : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * kThreads + tid;
      if (r >= Sq) continue;
      const int qp = qpv[u];
      const int qc = mk.bucket(qp);
      if (any_key && kmin <= qp && kmax > qp - mk.window && kcmin <= qc && qc <= kcmax)
        maybe[r / BR] = 1;
      if (!(whole && kmax <= qp && kmin > qp - mk.window && kcmin == qc && kcmax == qc))
        partial[r / BR] = 1;
    }
  }
  // a row that sees no key (LSE +inf) has P = 1 / pad_keys on every key
  const float* lse_g = p.lse + ((int64_t)b * p.Hq + hk * groups) * Sq;
  const int n_lse = groups * Sq;
  for (int base = 0; base < n_lse; base += U * kThreads) {
    float lv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * kThreads + tid;
      lv[u] = i < n_lse ? lse_g[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * kThreads + tid;
      if (i < n_lse && isinf(lv[u])) {
        const int gi = i / Sq;
        walk[gi * ntq + (i - gi * Sq) / BR] = 1;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nwalk; i += kThreads) walk[i] |= maybe[i % ntq];
  __syncthreads();

  // ---- the walk over (query head, query tile) ---------------------------------
  auto issue = [&](int w, int slot) {
    const int gi = w / ntq;
    const int q0 = (w - gi * ntq) * BR;
    const int h = hk * groups + gi;
    const int nq = min(BR, Sq - q0);
    stage_rows(Qs + slot * BR * stride, stride,
               p.q + b * p.q_sb + h * p.q_sh + (int64_t)q0 * p.q_ss, p.q_ss, BR, nq, dh);
    stage_rows(dOs + slot * BR * stride, stride,
               p.dout + b * p.do_sb + h * p.do_sh + (int64_t)q0 * p.do_ss, p.do_ss, BR, nq, dh);
    if (tid < BR) {
      const int64_t at = ((int64_t)b * p.Hq + h) * Sq + q0 + tid;
      if (tid < nq) {
        cp_async4(lse_s + slot * BR + tid, p.lse + at);
        cp_async4(dsum_s + slot * BR + tid, p.dsum + at);
        cp_async4(qpos_s + slot * BR + tid, qp_g + q0 + tid);
      } else {  // a row past Sq: zero Q and dO make it add nothing
        lse_s[slot * BR + tid] = INFINITY;
        dsum_s[slot * BR + tid] = 0.f;
        qpos_s[slot * BR + tid] = -0x7fffffff - 1;
      }
    }
  };

  int w_load = next_flagged(-1, nwalk, walk);
  int w_comp = w_load;
  for (int s = 0; s < S - 1; ++s) {
    if (w_load < nwalk) {
      issue(w_load, s);
      w_load = next_flagged(w_load, nwalk, walk);
    }
    cp_async_commit();
  }

  const bf16* ka = Ks + warp * 16 * stride;  // this warp's 16 keys
  const bf16* va = Vs + warp * 16 * stride;
  const int kp0 = kpos_s[warp * 16 + g], kp1 = kpos_s[warp * 16 + g + 8];
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;

  for (int i = 0; w_comp < nwalk; ++i) {
    cp_async_wait<S - 2>();  // tile i (and, the first time, K and V) has landed
    __syncthreads();
    if (w_load < nwalk) {
      issue(w_load, (i + S - 1) % S);
      w_load = next_flagged(w_load, nwalk, walk);
    }
    cp_async_commit();

    const int slot = i % S;
    const bf16* Qt = Qs + slot * BR * stride;
    const bf16* dOt = dOs + slot * BR * stride;
    const float* lset = lse_s + slot * BR;
    const float* dst = dsum_s + slot * BR;
    const int* qpt = qpos_s + slot * BR;
    const bool masked = partial[w_comp % ntq] != 0;

    // ---- S^T = K Q^T: rows are this warp's keys, columns the tile's queries
    float s[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (16 * kk < dh) {
        uint32_t a[4];
        ldmatrix_x4(a, a_rows(ka, stride, lane, kk));
#pragma unroll
        for (int j2 = 0; j2 < NQ / 2; ++j2) {
          uint32_t bq[4];
          ldmatrix_x4(bq, b_rows(Qt, stride, lane, j2, kk));
          mma_bf16(s[2 * j2], a, bq[0], bq[1]);
          mma_bf16(s[2 * j2 + 1], a, bq[2], bq[3]);
        }
      }
    }

    // ---- P^T = exp(S^T scale - LSE), and which entries the mask shows ---------
    uint32_t vis = 0xffffffffu;
    if (masked) {
      vis = 0u;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = 8 * j + 2 * t4 + e;
          const float L = lset[qi];
          const int qp = qpt[qi];
          const int qc = mk.bucket(qp);
          const bool v0 = mk.sees(qp, qc, kp0), v1 = mk.sees(qp, qc, kp1);
          const float hidden = isinf(L) ? inv_pad : 0.f;
          vis |= ((uint32_t)v0 << (4 * j + e)) | ((uint32_t)v1 << (4 * j + 2 + e));
          s[j][e] = v0 ? ex2(fmaf(s[j][e], scale2, -L * kLog2e)) : hidden;
          s[j][2 + e] = v1 ? ex2(fmaf(s[j][2 + e], scale2, -L * kLog2e)) : hidden;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float L2 = lset[8 * j + 2 * t4 + e] * kLog2e;  // +inf: a row past Sq
          s[j][e] = ex2(fmaf(s[j][e], scale2, -L2));
          s[j][2 + e] = ex2(fmaf(s[j][2 + e], scale2, -L2));
        }
      }
    }

    // ---- dV += P^T dO --------------------------------------------------------
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      uint32_t a[4];
      a_from_acc(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j2 = 0; j2 < NO / 2; ++j2) {
        if (16 * j2 < dh) {
          uint32_t bo[4];
          ldmatrix_x4_trans(bo, b_cols(dOt, stride, lane, kk, j2));
          mma_bf16(dv[2 * j2], a, bo[0], bo[1]);
          mma_bf16(dv[2 * j2 + 1], a, bo[2], bo[3]);
        }
      }
    }

    // ---- dP^T = V dO^T -------------------------------------------------------
    float dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (16 * kk < dh) {
        uint32_t a[4];
        ldmatrix_x4(a, a_rows(va, stride, lane, kk));
#pragma unroll
        for (int j2 = 0; j2 < NQ / 2; ++j2) {
          uint32_t bo[4];
          ldmatrix_x4(bo, b_rows(dOt, stride, lane, j2, kk));
          mma_bf16(dp[2 * j2], a, bo[0], bo[1]);
          mma_bf16(dp[2 * j2 + 1], a, bo[2], bo[3]);
        }
      }
    }

    // ---- dS^T = P^T * (dP^T - D), zero where the mask hides the pair -----------
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float D = dst[8 * j + 2 * t4 + e];
        dp[j][e] = (vis >> (4 * j + e)) & 1u ? s[j][e] * (dp[j][e] - D) : 0.f;
        dp[j][2 + e] = (vis >> (4 * j + 2 + e)) & 1u ? s[j][2 + e] * (dp[j][2 + e] - D) : 0.f;
      }
    }

    // ---- dK += dS^T Q --------------------------------------------------------
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      uint32_t a[4];
      a_from_acc(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int j2 = 0; j2 < NO / 2; ++j2) {
        if (16 * j2 < dh) {
          uint32_t bq[4];
          ldmatrix_x4_trans(bq, b_cols(Qt, stride, lane, kk, j2));
          mma_bf16(dk[2 * j2], a, bq[0], bq[1]);
          mma_bf16(dk[2 * j2 + 1], a, bq[2], bq[3]);
        }
      }
    }
    w_comp = next_flagged(w_comp, nwalk, walk);
  }
  cp_async_wait<0>();

  const int64_t ss = (int64_t)p.Hkv * dh;  // dk and dv are contiguous (B, Skv, Hkv, Dh)
  const int64_t at = ((int64_t)b * p.Skv + k0) * ss + hk * dh;
  const int kr = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (8 * j < dh) {
      const int col = 8 * j + 2 * t4;
      if (kr < nk) {
        *reinterpret_cast<uint32_t*>(p.dk + at + kr * ss + col) =
            pack_bf16(dk[j][0] * p.scale, dk[j][1] * p.scale);
        *reinterpret_cast<uint32_t*>(p.dv + at + kr * ss + col) = pack_bf16(dv[j][0], dv[j][1]);
      }
      if (kr + 8 < nk) {
        *reinterpret_cast<uint32_t*>(p.dk + at + (kr + 8) * ss + col) =
            pack_bf16(dk[j][2] * p.scale, dk[j][3] * p.scale);
        *reinterpret_cast<uint32_t*>(p.dv + at + (kr + 8) * ss + col) =
            pack_bf16(dv[j][2], dv[j][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: dQ, one block a query tile and head
// ---------------------------------------------------------------------------

template <int DHC, bool AREG>
__global__ void __launch_bounds__(kThreads, 1) train_attention_bwd_dq_kernel(const Params p) {
  constexpr int KS = DHC / 16;
  constexpr int NS = kTile / 8;
  constexpr int NO = DHC / 8;
  constexpr int S = kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int dh = p.dh;
  const int stride = dh + kPad;
  const int Skv = p.Skv;
  const int ntiles = (Skv + kTile - 1) / kTile;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kBQ * stride;
  bf16* Ks = dOs + kBQ * stride;
  bf16* Vs = Ks + S * kTile * stride;
  int* kpos_s = reinterpret_cast<int*>(Vs + S * kTile * stride);
  int* qpos_s = kpos_s + S * kTile;
  unsigned char* flags = reinterpret_cast<unsigned char*>(qpos_s + kBQ);
  unsigned char* partial = flags + pad16(ntiles);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const Mask mk(p);
  const float scale2 = p.scale * kLog2e;

  const int b = blockIdx.y / p.Hq;
  const int h = blockIdx.y % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int nq = min(kBQ, p.Sq - q0);

  const bf16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + hk * p.v_sh;
  const int* kp_g = p.kpos + (int64_t)b * Skv;

  stage_rows(Qs, stride, p.q + b * p.q_sb + h * p.q_sh + (int64_t)q0 * p.q_ss, p.q_ss, kBQ, nq,
             dh);
  stage_rows(dOs, stride, p.dout + b * p.do_sb + h * p.do_sh + (int64_t)q0 * p.do_ss, p.do_ss,
             kBQ, nq, dh);
  cp_async_commit();
  if (tid < kBQ) qpos_s[tid] = tid < nq ? p.qpos[(int64_t)b * p.Sq + q0 + tid] : -1;
  const int r0 = warp * 16 + g;
  // this lane's rows' LSE (log2 units; +inf: a row past Sq or one that sees no
  // key, whose P is 0 here) and D
  const float* lse = p.lse + ((int64_t)b * p.Hq + h) * p.Sq + q0;
  const float* dsum = p.dsum + ((int64_t)b * p.Hq + h) * p.Sq + q0;
  const float L0 = r0 < nq ? lse[r0] * kLog2e : INFINITY;
  const float L1 = r0 + 8 < nq ? lse[r0 + 8] * kLog2e : INFINITY;
  const float D0 = r0 < nq ? dsum[r0] : 0.f, D1 = r0 + 8 < nq ? dsum[r0 + 8] : 0.f;
  __syncthreads();
  int qmin = 0x7fffffff, qmax = -0x7fffffff - 1;
  for (int r = 0; r < nq; ++r) {
    qmin = min(qmin, qpos_s[r]);
    qmax = max(qmax, qpos_s[r]);
  }
  plan_kv_tiles(kp_g, Skv, qmin, qmax, mk, flags, partial);

  auto issue = [&](int t, int slot) {
    const int kv0 = t * kTile;
    const int nkv = min(kTile, Skv - kv0);
    stage_rows(Ks + slot * kTile * stride, stride, kg + (int64_t)kv0 * p.k_ss, p.k_ss, kTile, nkv,
               dh);
    stage_rows(Vs + slot * kTile * stride, stride, vg + (int64_t)kv0 * p.v_ss, p.v_ss, kTile, nkv,
               dh);
    if (tid < kTile) {
      int* d = kpos_s + slot * kTile + tid;
      if (tid < nkv)
        cp_async4(d, kp_g + kv0 + tid);
      else
        *d = -1;
    }
  };

  int t_load = next_flagged(-1, ntiles, flags);
  int t_comp = t_load;
  for (int s = 0; s < S - 1; ++s) {
    if (t_load < ntiles) {
      issue(t_load, s);
      t_load = next_flagged(t_load, ntiles, flags);
    }
    cp_async_commit();
  }

  const int qp0 = qpos_s[r0], qp1 = qpos_s[r0 + 8];
  const int qc0 = mk.bucket(qp0), qc1 = mk.bucket(qp1);
  const bf16* qa = Qs + warp * 16 * stride;
  const bf16* da = dOs + warp * 16 * stride;
  uint32_t qf[AREG ? KS : 1][4], df[AREG ? KS : 1][4];
  if (AREG) {
    cp_async_wait<S - 1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (16 * kk < dh) {
        ldmatrix_x4(qf[AREG ? kk : 0], a_rows(qa, stride, lane, kk));
        ldmatrix_x4(df[AREG ? kk : 0], a_rows(da, stride, lane, kk));
      }
    }
  }

  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int i = 0; t_comp < ntiles; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (t_load < ntiles) {
      issue(t_load, (i + S - 1) % S);
      t_load = next_flagged(t_load, ntiles, flags);
    }
    cp_async_commit();

    const int slot = i % S;
    const bf16* Kt = Ks + slot * kTile * stride;
    const bf16* Vt = Vs + slot * kTile * stride;
    const int* kpt = kpos_s + slot * kTile;

    // ---- S = Q K^T and dP = dO V^T -------------------------------------------
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (16 * kk < dh) {
        uint32_t a[4], ad[4];
        if (AREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a[e] = qf[AREG ? kk : 0][e];
            ad[e] = df[AREG ? kk : 0][e];
          }
        } else {
          ldmatrix_x4(a, a_rows(qa, stride, lane, kk));
          ldmatrix_x4(ad, a_rows(da, stride, lane, kk));
        }
#pragma unroll
        for (int j2 = 0; j2 < NS / 2; ++j2) {
          uint32_t bk[4], bv[4];
          ldmatrix_x4(bk, b_rows(Kt, stride, lane, j2, kk));
          mma_bf16(s[2 * j2], a, bk[0], bk[1]);
          mma_bf16(s[2 * j2 + 1], a, bk[2], bk[3]);
          ldmatrix_x4(bv, b_rows(Vt, stride, lane, j2, kk));
          mma_bf16(dp[2 * j2], ad, bv[0], bv[1]);
          mma_bf16(dp[2 * j2 + 1], ad, bv[2], bv[3]);
        }
      }
    }

    // ---- dS = P * (dP - D), P = exp(S scale - LSE), 0 where hidden --------------
    const bool masked = partial[t_comp] != 0;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = ex2(fmaf(s[j][e], scale2, -L0));
        float p1 = ex2(fmaf(s[j][2 + e], scale2, -L1));
        if (masked) {
          const int kp = kpt[8 * j + 2 * t4 + e];
          p0 = mk.sees(qp0, qc0, kp) ? p0 : 0.f;
          p1 = mk.sees(qp1, qc1, kp) ? p1 : 0.f;
        }
        dp[j][e] = p0 * (dp[j][e] - D0);
        dp[j][2 + e] = p1 * (dp[j][2 + e] - D1);
      }
    }

    // ---- dQ += dS K ----------------------------------------------------------
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      a_from_acc(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int j2 = 0; j2 < NO / 2; ++j2) {
        if (16 * j2 < dh) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, b_cols(Kt, stride, lane, kk, j2));
          mma_bf16(dq[2 * j2], a, bk[0], bk[1]);
          mma_bf16(dq[2 * j2 + 1], a, bk[2], bk[3]);
        }
      }
    }
    t_comp = next_flagged(t_comp, ntiles, flags);
  }
  cp_async_wait<0>();

  bf16* dqg = p.dq + (((int64_t)b * p.Sq + q0) * p.Hq + h) * dh;
  const int64_t ss = (int64_t)p.Hq * dh;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (8 * j < dh) {
      const int col = 8 * j + 2 * t4;
      if (r0 < nq)
        *reinterpret_cast<uint32_t*>(dqg + r0 * ss + col) =
            pack_bf16(dq[j][0] * p.scale, dq[j][1] * p.scale);
      if (r0 + 8 < nq)
        *reinterpret_cast<uint32_t*>(dqg + (r0 + 8) * ss + col) =
            pack_bf16(dq[j][2] * p.scale, dq[j][3] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch_kernel(K kernel, dim3 grid, size_t smem, const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the instantiated head-width class: the smallest of 64, 80, 128 covering dh
template <int DHC>
int launch_forward(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.B * p.Hq);
  return (int)launch_kernel(train_attention_fwd_kernel<DHC>, grid,
                            fwd_smem_bytes(p.dh, p.Skv), p, stream);
}

template <int DHC>
int launch_backward(const Params& p, cudaStream_t stream) {
  const long long warps = ((long long)p.B * p.Sq * p.Hq + kThreads / 32 - 1) / (kThreads / 32);
  const int dot_blocks = warps < 132 * 16 ? (int)warps : 132 * 16;  // one warp a row, in waves
  cudaError_t err = launch_kernel(train_attention_bwd_dot_kernel, dim3(dot_blocks), 0, p, stream);
  if (err != cudaSuccess) return (int)err;
  const int groups = p.Hq / p.Hkv;
  err = launch_kernel(train_attention_bwd_dkdv_kernel<DHC>,
                      dim3((p.Skv + kKeys - 1) / kKeys, p.B * p.Hkv),
                      dkdv_smem_bytes(p.dh, p.Sq, groups), p, stream);
  if (err != cudaSuccess) return (int)err;
  // Q and dO fragments in registers up to Dh 80; above, read again each tile
  return (int)launch_kernel(train_attention_bwd_dq_kernel<DHC, (DHC <= 80)>,
                            dim3((p.Sq + kBQ - 1) / kBQ, p.B * p.Hq), dq_smem_bytes(p.dh, p.Skv),
                            p, stream);
}

int check_shape(const Params& p) {
  if (p.dh <= 0 || p.dh % 16 != 0 || p.dh > 128) return -1;
  if (p.B <= 0 || p.Sq <= 0 || p.Skv <= 0 || p.Hq <= 0 || p.Hkv <= 0 || p.Hq % p.Hkv != 0)
    return -4;
  if ((long long)p.B * p.Hq > 65535 || p.window <= 0 || p.chunk <= 0 || p.pad_keys < p.Skv)
    return -4;
  return 0;
}

Params make_params(const void* q, const void* k, const void* v, const void* qpos,
                   const void* kpos, int B, int Sq, int Skv, int Hq, int Hkv, int dh,
                   const int64_t* strides, int window, int chunk, int pad_keys, float scale) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.Hq = Hq; p.Hkv = Hkv; p.dh = dh;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.do_sb = strides[9]; p.do_ss = strides[10]; p.do_sh = strides[11];
  p.window = window; p.chunk = chunk; p.pad_keys = pad_keys; p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block: kernel 0 forward (dh, skv), 1 dkdv
// (dh, sq, groups), 2 dq (dh, skv); -1 for another kernel.
long long repro_train_attention_smem_bytes(int kernel, int dh, int sq, int skv, int groups) {
  if (kernel == 0) return (long long)fwd_smem_bytes(dh, skv);
  if (kernel == 1) return (long long)dkdv_smem_bytes(dh, sq, groups);
  if (kernel == 2) return (long long)dq_smem_bytes(dh, skv);
  return -1;
}

// Enqueues the forward on `stream`: out (B, Sq, Hq, Dh) bf16 and lse (B, Hq,
// Sq) fp32, both contiguous.  q, k, v are bf16 (B, S, H, Dh) with a contiguous
// last dimension and every row on a 16-byte boundary; `strides` holds (batch,
// sequence, head) strides in elements of q, k, v and dout (dout unused here).
// Positions are contiguous int32.  Returns cudaGetLastError() (0 = launched),
// -1 for a head width that is not a multiple of 16 up to 128, -4 for a shape
// out of range.  Never synchronises, allocates nothing.
int repro_train_attention_forward(const void* q, const void* k, const void* v, const void* qpos,
                                  const void* kpos, void* out, void* lse, int B, int Sq, int Skv,
                                  int Hq, int Hkv, int dh, const int64_t* strides, int window,
                                  int chunk, int pad_keys, float scale, void* stream) {
  Params p = make_params(q, k, v, qpos, kpos, B, Sq, Skv, Hq, Hkv, dh, strides, window, chunk,
                         pad_keys, scale);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  const int bad = check_shape(p);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 64) return launch_forward<64>(p, s);
  if (dh == 80) return launch_forward<80>(p, s);
  return launch_forward<128>(p, s);
}

// Enqueues the backward's three kernels on `stream`: dsum (B, Hq, Sq) fp32 is
// their workspace; dq, dk, dv are written whole, contiguous like q, k, v.  o
// and lse are the forward's (contiguous); dout bf16 with the strides given.
int repro_train_attention_backward(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, const void* qpos,
                                   const void* kpos, void* dsum, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Skv, int Hq, int Hkv, int dh,
                                   const int64_t* strides, int window, int chunk, int pad_keys,
                                   float scale, void* stream) {
  Params p = make_params(q, k, v, qpos, kpos, B, Sq, Skv, Hq, Hkv, dh, strides, window, chunk,
                         pad_keys, scale);
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.dsum = static_cast<float*>(dsum);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  const int bad = check_shape(p);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 64) return launch_backward<64>(p, s);
  if (dh == 80) return launch_backward<80>(p, s);
  return launch_backward<128>(p, s);
}

}  // extern "C"
