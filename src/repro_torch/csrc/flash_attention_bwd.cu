// Flash attention backward for Hopper (sm_90a) on the tensor cores, with a
// plain C interface.
//
// The gradient of the forward kernel `flash_attention.cu`, which replaces
// the JAX package's Pallas TPU kernel `kernels/flash_attention.py`
// (`flash_attention`).  The JAX package has no Pallas backward (its models
// differentiate jnp attention); the port's models call the forward kernel
// at every length, so a gradient on the card passes through these kernels.
//
// With P = exp(S * scale - lse) recomputed from the forward's per-row
// log-sum-exp, D = rowsum(dO o O), dP = dO V^T and dS = P o (dP - D):
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K.
//
// What bounds it on the H100.  Operations: 10 * hd flops per unmasked
// (query, key) pair at the least (Q K^T, dO V^T, P^T dO, dS^T Q, dS K),
// against 4 * hd * (bytes per element) bytes of q/k/v/o/dO and the
// gradients per token.  bf16 products run on the tensor cores at 989
// TFLOP/s (`wgmma`).  f32 runs 3xTF32 on `mma.sync` (three TF32 products per
// f32 one, at 495 TFLOP/s), as the forward does: one TF32 pass keeps about 3
// decimal digits, too few for the 1e-4 the gradients are held to.  The
// design recomputes Q K^T and dO V^T in the dQ pass (14 * hd flops per
// pair) so that every output is written by one block, in a fixed order:
// no atomics, and the gradients are the same bit for bit on every call.
//
// The design, four launches on one stream:
//   1. `flash_bwd_delta`: D = rowsum(dO o O) per query row, 16-byte loads,
//      and the forward's log-sum-exp times log2(e), both into (B*H, SP)
//      f32 arrays padded to SP = S rounded up to 128, with lse = +inf and
//      D = 0 on the padding: a query row past S then gets P = 0 and
//      dS = 0 without a mask.
//   2. `flash_bwd_dkdv`, keys as rows: one block per (key tile, batch *
//      query head), the earliest key tile (under the causal mask the one
//      that most queries see) scheduled first.  The forward's block turned
//      on its side: a producer warpgroup (one thread issuing TMA) and two
//      consumer warpgroups of 64 key rows each.  K and V load once; Q, dO
//      and the query rows' lse and D stream through a ring of stages, each
//      with a full and an empty mbarrier.  The consumers compute
//      S^T = K Q^T and dP^T = V dO^T into accumulator registers, where
//      P^T = exp2(S^T * scale * log2(e) - lse2[column]) and
//      dS^T = P^T o (dP^T - D[column]) are formed, and hand them over in
//      registers as the A operand of dV += P^T dO and dK += dS^T Q, with Q
//      and dO the B operand read MN-major (as the forward reads V).
//   3. `flash_bwd_dq`, queries as rows: one block per (query tile, batch *
//      head), the latest tile first; Q and dO load once, K and V stream.
//      S = Q K^T and dP = dO V^T, then dQ += dS K with dS in registers.
//   4. GQA (H > G): the dK/dV blocks of the H / G query heads of a group
//      would write one group's rows, so each writes its head's dK and dV in
//      f32 to a (B, T, H, hd) scratch, and `flash_bwd_group_sum` adds each
//      group's heads in head order and casts.  Where H == G the dK/dV
//      blocks write dk and dv directly and this launch is skipped.
//   bf16 products are `wgmma` (m64nNk16, f32 accumulators; P and dS rounded
//   to bf16 as operands).  f32 products are `mma.sync.m16n8k8` in 3xTF32,
//   each warp of 16 rows reading its fragments from the swizzled tiles and
//   splitting them in registers; an accumulator's column pairs serve as the
//   next product's A fragment, as in the forward.
//   The tile shapes are per (dtype, head_dim) (`KVTile`, `QTile`).  At
//   head_dim 256 a consumer cannot hold both dK and dV of 64 rows (256
//   registers), so the dK/dV block takes 64 keys and splits its two
//   warpgroups by output: one computes S^T, P^T and dV += P^T dO and hands
//   P^T to the other through shared memory (a named-barrier pair per
//   warp), which computes dP^T, dS^T and dK += dS^T Q, 4 hd flops per pair
//   each; the dQ block takes 64 queries (two 128-row f32 Q and dO tiles
//   would not fit), its two warpgroups taking alternate key tiles, and adds
//   their dQ parts in a fixed order at the end.
//   Query row i sits at position q_offset + i of the key sequence (the
//   forward's offset): the masks, the tile-skip tests, the dK/dV block's
//   query range and the dQ block's key range compare keys with positions.
//   Tiles wholly masked for a warpgroup are waited for and released without
//   computing; masks are applied only on tiles that cross the diagonal, the
//   window's edge or T.  TMA fills rows past S or T with zeros.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int NTHREADS = 384;  // a producer warpgroup and two consumer warpgroups
constexpr int SP_ROUND = 128;      // lse2 and D rows are padded to a multiple of this
constexpr int DELTA_THREADS = 256;
constexpr int SUM_THREADS = 256;
constexpr int NSTAGE = 2;          // stages of the dK/dV pass's Q/dO ring and the dQ pass's K/V ring

// Lanes that share a row of the D pass: one per 16-byte chunk where a row
// is a power-of-two number of chunks below 32, else a warp.
template <typename T, int HD>
__host__ __device__ constexpr int delta_lanes() {
  constexpr int nc = HD * static_cast<int>(sizeof(T)) / 16;
  return nc >= 32 || (nc & (nc - 1)) != 0 ? 32 : nc;
}

// Roles of a consumer warpgroup in the dK/dV pass: both products on its own
// 64 keys, or (head_dim 256) one of two warpgroups on the same 64 keys,
// which computes P^T and dV and hands P^T over, or dP^T, dS^T and dK.
constexpr int BOTH = 0, DV_ONLY = 1, DK_ONLY = 2;
// Named barriers of that hand-over, one pair per warp w of a warpgroup and
// the same warp of the other (barrier 0 is __syncthreads'): P_FULL + w
// once P^T is written, P_EMPTY + w once it is read.
constexpr int P_FULL = 1, P_EMPTY = 5;
// Named barrier of the dQ pass's two warpgroups under KSPLIT.
constexpr int DQ_MERGE = 1;

// dK/dV pass: keys per block (BKEY: two warpgroups of 64, or 64 shared by
// both at head_dim 256) and query rows per stage (BQ).
template <typename T, int HD>
struct KVTile : RowBoxes<T, HD> {
  using R = RowBoxes<T, HD>;
  static constexpr bool SPLIT = HD == 256;
  static constexpr int BKEY = SPLIT ? 64 : 128;
  static constexpr int BQ = R::ES == 2 || HD <= 64 ? 64 : HD <= 128 ? 32 : 16;
  static constexpr int KEY_BYTES = BKEY * R::ROWB;
  static constexpr int Q_BYTES = BQ * R::ROWB;
  static constexpr int X_FLOATS = SPLIT ? BQ / 2 * 128 : 0;  // P^T handed between the warpgroups
  static constexpr int SMEM = 1024 + 2 * KEY_BYTES + NSTAGE * (2 * Q_BYTES + 2 * BQ * 4) +
                              4 * X_FLOATS + 8 * (1 + 2 * NSTAGE);
  static_assert(SMEM <= SMEM_LIMIT, "the dK/dV tiles do not fit a block's shared memory");
};

// dQ pass: queries per block (BQ: two warpgroups of 64, or at head_dim 256
// one tile of 64 that both warpgroups work on, each taking every other key
// tile from its own stage: KSPLIT) and keys per stage (BK).
template <typename T, int HD>
struct QTile : RowBoxes<T, HD> {
  using R = RowBoxes<T, HD>;
  static constexpr bool KSPLIT = HD == 256;
  static constexpr int BQ = KSPLIT ? 64 : 128;
  static constexpr int BK = R::ES == 2 || HD <= 96 ? 64 : HD <= 128 ? 32 : 16;
  static constexpr int STAGE_WARPS = KSPLIT ? 4 : 8;  // consumer warps that release a stage
  static constexpr int Q_BYTES = BQ * R::ROWB;
  static constexpr int KV_BYTES = BK * R::ROWB;
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * NSTAGE * KV_BYTES + 8 * (1 + 2 * NSTAGE);
  static_assert(SMEM <= SMEM_LIMIT, "the dQ tiles do not fit a block's shared memory");
  static_assert(!KSPLIT || (NSTAGE == 2 && 2 * NSTAGE * KV_BYTES >= 128 * HD / 2 * 4),
                "a warpgroup's stage, and the K/V ring holding one warpgroup's dQ part");
};

struct Common {
  const float* lse2;   // (B*H, SP): the forward's log-sum-exp times log2(e); +inf past S
  const float* delta;  // (B*H, SP): rowsum(dO o O); 0 past S
  int S, T, H, G, SP, causal, window;
  int q_offset;        // query row i sits at position q_offset + i; keys from 0
  float scale, scale_log2;
};

struct KVParams {
  CUtensorMap tq, tdo, tk, tv;  // boxes of BQ (q, dO) and BKEY (k, v) rows
  Common c;
  void *dk, *dv;     // (B, T, H, hd): f32 scratch if f32_out (H > G), else dk and dv (H == G)
  long long ds[3];   // their element strides: batch, sequence, head
  int f32_out;
};

struct QParams {
  CUtensorMap tq, tdo, tk, tv;  // boxes of BQ (q, dO) and BK (k, v) rows
  Common c;
  void* dq;          // (B, S, H, hd) contiguous
};

struct DeltaParams {
  const void *o, *dout;
  const float* lse;        // (B, H, S)
  float *lse2, *delta;     // (B*H, SP)
  long long os[3], dos[3];
  int S, H, SP;
  long long rows;          // B * H * SP
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Query row i (at position i + q_offset) sees key j.
__device__ __forceinline__ bool visible(const Common& c, int i, int j) {
  const int pi = i + c.q_offset;
  return j < c.T && (!c.causal || j <= pi) && (c.window <= 0 || j > pi - c.window);
}

// Keys [r, r + 64) of a warpgroup against query rows [q0, q0 + bq): all
// masked; and keys [rw, rw + 16) of a warp: none masked.  Rows are compared
// with keys at their positions (row + q_offset).
__device__ __forceinline__ bool kv_all_masked(const Common& c, int q0, int bq, int r) {
  const int p0 = q0 + c.q_offset;
  return r >= c.T || (c.causal && r > p0 + bq - 1) || (c.window > 0 && p0 - (r + 63) >= c.window);
}
__device__ __forceinline__ bool kv_unmasked(const Common& c, int q0, int bq, int rw) {
  const int p0 = q0 + c.q_offset;
  return rw + 15 < c.T && (!c.causal || rw + 15 <= p0) &&
         (c.window <= 0 || rw > p0 + bq - 1 - c.window);
}
// Query rows [r, r + 64) of a warpgroup against keys [k0, k0 + bk): all
// masked; and rows [rw, rw + 16) of a warp: none masked.
__device__ __forceinline__ bool q_all_masked(const Common& c, int k0, int bk, int r) {
  const int pr = r + c.q_offset;
  return r >= c.S || (c.causal && k0 > pr + 63) || (c.window > 0 && k0 + bk - 1 <= pr - c.window);
}
__device__ __forceinline__ bool q_unmasked(const Common& c, int k0, int bk, int rw) {
  const int pw = rw + c.q_offset;
  return k0 + bk <= c.T && (!c.causal || k0 + bk - 1 <= pw) &&
         (c.window <= 0 || k0 > pw + 15 - c.window);
}

// ---------------------------------------------------------------------------
// P and dS on accumulator fragments, shared by both dtypes
//
// A warp owns 16 rows; its accumulator over N columns holds, for n8 block
// j, s[4j + e] = (row g + 8*(e >> 1), column 8j + 2t + (e & 1)) with
// g = lane / 4 and t = lane % 4 (the wgmma and the mma.sync layouts agree).

// Keys as rows, queries as columns (the dK/dV pass): S^T in st becomes
// P^T, with sl the tile's lse2 by column; key is this thread's first row
// and col its first column.
template <int N>
__device__ __forceinline__ void p_t(const Common& c, float* st, const float* sl, int key, int q0,
                                    int col, bool mask) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(sl + 8 * j + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pe = exp2f(fmaf(st[4 * j + e], c.scale_log2, -(e & 1 ? l.y : l.x)));
      if (mask && !visible(c, q0 + 8 * j + col + (e & 1), key + 8 * (e >> 1))) pe = 0.f;
      st[4 * j + e] = pe;
    }
  }
}

// dP^T in dpt becomes dS^T = P^T o (dP^T - D), with sd the tile's D by
// column.
template <int N>
__device__ __forceinline__ void ds_t(const float* pt, float* dpt, const float* sd, int col) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 d = *reinterpret_cast<const float2*>(sd + 8 * j + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) dpt[4 * j + e] = pt[4 * j + e] * (dpt[4 * j + e] - (e & 1 ? d.y : d.x));
  }
}

// The P^T hand-over: thread i of the dV warpgroup writes its accumulator
// fragments where thread i of the dK warpgroup, which holds the same
// elements of dP^T, reads them (conflict-free: consecutive threads,
// consecutive words).
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
template <int N>
__device__ __forceinline__ void put_p(float* x, const float* st, int tid, bool first) {
  if (!first) bar_sync(P_EMPTY + tid / 32, 64);  // the other warp has read the last tile's
#pragma unroll
  for (int j = 0; j < N / 2; ++j) x[j * 128 + tid] = st[j];
  bar_arrive(P_FULL + tid / 32, 64);
}
template <int N>
__device__ __forceinline__ void take_p(const float* x, float* st, int tid) {
  bar_sync(P_FULL + tid / 32, 64);
#pragma unroll
  for (int j = 0; j < N / 2; ++j) st[j] = x[j * 128 + tid];
  bar_arrive(P_EMPTY + tid / 32, 64);
}

// Queries as rows, keys as columns (the dQ pass): dp becomes dS.  l2 and dd
// hold lse2 and D of this thread's rows q_row and q_row + 8.
template <int N>
__device__ __forceinline__ void grad_scores(const Common& c, const float* s, float* dp,
                                            const float* l2, const float* dd, int q_row, int k_col,
                                            bool mask) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pe = exp2f(fmaf(s[4 * j + e], c.scale_log2, -l2[e >> 1]));
      if (mask && !visible(c, q_row + 8 * (e >> 1), k_col + 8 * j + (e & 1))) pe = 0.f;
      dp[4 * j + e] = pe * (dp[4 * j + e] - dd[e >> 1]);
    }
  }
}

// Writes rows `row` and row + 8 (those below n) of a 16 x HD accumulator
// fragment, times `mul`, to base + row * rs; col is this thread's first
// column.
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* base, long long rs, const float* acc, int row,
                                           int col, int n, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    if (i >= n) continue;
    T* dst = base + i * rs + col;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store_pair(dst + 8 * j, acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// 1. D and lse2

template <typename T, int HD>
__global__ void __launch_bounds__(DELTA_THREADS) flash_bwd_delta(const __grid_constant__ DeltaParams p) {
  constexpr int NC = HD * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks of a row
  constexpr int LPR = delta_lanes<T, HD>();
  const long long row = (static_cast<long long>(blockIdx.x) * DELTA_THREADS + threadIdx.x) / LPR;
  const int lane = threadIdx.x % LPR;
  if (row >= p.rows) return;  // whole rows of LPR lanes leave together
  const int bh = static_cast<int>(row / p.SP), i = static_cast<int>(row % p.SP);
  const int b = bh / p.H, h = bh % p.H;
  float acc = 0.f;
  if (i < p.S) {
    const uint4* o = reinterpret_cast<const uint4*>(static_cast<const T*>(p.o) + b * p.os[0] +
                                                    i * p.os[1] + h * p.os[2]);
    const uint4* g = reinterpret_cast<const uint4*>(static_cast<const T*>(p.dout) + b * p.dos[0] +
                                                    i * p.dos[1] + h * p.dos[2]);
    for (int c = lane; c < NC; c += LPR) {
      const uint4 a = o[c], d = g[c];
      const uint32_t av[4] = {a.x, a.y, a.z, a.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (sizeof(T) == 4) {
          acc = fmaf(__uint_as_float(av[e]), __uint_as_float(dv[e]), acc);
        } else {
          acc = fmaf(__uint_as_float(av[e] << 16), __uint_as_float(dv[e] << 16), acc);
          acc = fmaf(__uint_as_float(av[e] & 0xffff0000u), __uint_as_float(dv[e] & 0xffff0000u), acc);
        }
      }
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    p.delta[row] = acc;
    p.lse2[row] = i < p.S ? p.lse[static_cast<long long>(bh) * p.S + i] * LOG2E : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV

struct KVWork {
  uint8_t *sk, *sv, *sq, *sdo;
  float *sl, *sd, *sx;
  uint64_t *kv_full, *full, *empty;
  int b, h, g, k0, q_begin, n_tiles;
};

template <typename T, int HD>
__device__ void kv_produce(const KVParams& p, const KVWork& w) {
  using C = KVTile<T, HD>;
  mbar_expect_tx(w.kv_full, 2 * C::KEY_BYTES);
  tma_load_rows<T, HD>(w.sk, &p.tk, w.kv_full, C::BKEY, w.k0, w.g, w.b);
  tma_load_rows<T, HD>(w.sv, &p.tv, w.kv_full, C::BKEY, w.k0, w.g, w.b);
  const long long rows = (static_cast<long long>(w.b) * p.c.H + w.h) * p.c.SP;
  for (int i = 0; i < w.n_tiles; ++i) {
    const int s = i % NSTAGE;
    const int q0 = w.q_begin + i * C::BQ;
    mbar_wait(w.empty + s, ((i / NSTAGE) & 1) ^ 1);  // the first round passes at once
    mbar_expect_tx(w.full + s, 2 * C::Q_BYTES + 2 * C::BQ * 4);
    tma_load_rows<T, HD>(w.sq + s * C::Q_BYTES, &p.tq, w.full + s, C::BQ, q0, w.h, w.b);
    tma_load_rows<T, HD>(w.sdo + s * C::Q_BYTES, &p.tdo, w.full + s, C::BQ, q0, w.h, w.b);
    bulk_load(w.sl + s * C::BQ, p.c.lse2 + rows + q0, C::BQ * 4, w.full + s);
    bulk_load(w.sd + s * C::BQ, p.c.delta + rows + q0, C::BQ * 4, w.full + s);
  }
}

// dK (times scale) and dV of this thread's rows to the outputs or the scratch.
template <typename T, int HD, bool DV, bool DK>
__device__ __forceinline__ void kv_store(const KVParams& p, const KVWork& w, const float* dv,
                                         const float* dk, int key, int col) {
  const long long off = w.b * p.ds[0] + w.h * p.ds[2];
  if (p.f32_out) {
    if constexpr (DV) store_rows<float, HD>(static_cast<float*>(p.dv) + off, p.ds[1], dv, key, col, p.c.T, 1.f);
    if constexpr (DK) store_rows<float, HD>(static_cast<float*>(p.dk) + off, p.ds[1], dk, key, col, p.c.T, p.c.scale);
  } else {
    if constexpr (DV) store_rows<T, HD>(static_cast<T*>(p.dv) + off, p.ds[1], dv, key, col, p.c.T, 1.f);
    if constexpr (DK) store_rows<T, HD>(static_cast<T*>(p.dk) + off, p.ds[1], dk, key, col, p.c.T, p.c.scale);
  }
}

// bf16 on wgmma: a warpgroup of 64 key rows from row0 of the block's tile.
template <int HD, int ROLE>
__device__ void kv_consume_bf16(const KVParams& p, const KVWork& w, int row0) {
  using C = KVTile<__nv_bfloat16, HD>;
  constexpr int BQ = C::BQ, W = C::W;
  constexpr bool DV = ROLE != DK_ONLY, DK = ROLE != DV_ONLY;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int r_wg = w.k0 + row0, rw = r_wg + 16 * warp;
  const int key = rw + lane / 4, col = 2 * (lane % 4);
  float dv[DV ? HD / 2 : 1], dk[DK ? HD / 2 : 1];
#pragma unroll
  for (int i = 0; i < (DV ? HD / 2 : 1); ++i) dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DK ? HD / 2 : 1); ++i) dk[i] = 0.f;
  const uint32_t k_addr = smem_u32(w.sk) + row0 * W, v_addr = smem_u32(w.sv) + row0 * W;
  int processed = 0;  // tiles not wholly masked: the same count in both roles
  mbar_wait(w.kv_full, 0);
  for (int i = 0; i < w.n_tiles; ++i) {
    const int s = i % NSTAGE;
    const int q0 = w.q_begin + i * BQ;
    mbar_wait(w.full + s, (i / NSTAGE) & 1);
    if (!kv_all_masked(p.c, q0, BQ, r_wg)) {
      const uint32_t q_addr = smem_u32(w.sq + s * C::Q_BYTES);
      const uint32_t do_addr = smem_u32(w.sdo + s * C::Q_BYTES);
      float st[BQ / 2], dpt[DK ? BQ / 2 : 1];
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) st[j] = 0.f;
#pragma unroll
      for (int j = 0; j < (DK ? BQ / 2 : 1); ++j) dpt[j] = 0.f;
      wgmma_fence();
      if constexpr (DV) wgmma_ss_rows<BQ, HD, W>(st, k_addr, C::BKEY, q_addr, BQ, true);
      if constexpr (DK) wgmma_ss_rows<BQ, HD, W>(dpt, v_addr, C::BKEY, do_addr, BQ, true);
      wgmma_commit();
      wgmma_wait_all();
      if constexpr (DV) fence_regs<BQ / 2>(st);
      if constexpr (DK) fence_regs<BQ / 2>(dpt);
      if constexpr (DV) p_t<BQ>(p.c, st, w.sl + s * BQ, key, q0, col, !kv_unmasked(p.c, q0, BQ, rw));
      if constexpr (ROLE == DV_ONLY) put_p<BQ>(w.sx, st, tid, processed == 0);
      if constexpr (ROLE == DK_ONLY) take_p<BQ>(w.sx, st, tid);
      if constexpr (DK) ds_t<BQ>(st, dpt, w.sd + s * BQ, col);
      ++processed;
      uint32_t pa[DV ? BQ / 16 : 1][4], da[DK ? BQ / 16 : 1][4];
      if constexpr (DV) pack_a_bf16<BQ>(st, pa);
      if constexpr (DK) pack_a_bf16<BQ>(dpt, da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        if constexpr (DV) wgmma_rs<HD>(dv, pa[kk], mnmajor_desc<W>(do_addr + kk * 16 * W, BQ * W));
        if constexpr (DK) wgmma_rs<HD>(dk, da[kk], mnmajor_desc<W>(q_addr + kk * 16 * W, BQ * W));
      }
      wgmma_commit();
      wgmma_wait_all();
      if constexpr (DV) fence_regs<HD / 2>(dv);
      if constexpr (DK) fence_regs<HD / 2>(dk);
    }
    release(w.empty + s, lane);
  }
  if (ROLE == DV_ONLY && processed > 0) bar_sync(P_EMPTY + warp, 64);  // the last hand-over's read
  kv_store<__nv_bfloat16, HD, DV, DK>(p, w, dv, dk, key, col);
}

// f32 in 3xTF32 on mma.sync: four warps of 16 key rows from row0.
template <int HD, int ROLE>
__device__ void kv_consume_f32(const KVParams& p, const KVWork& w, int row0) {
  using C = KVTile<float, HD>;
  constexpr int BQ = C::BQ, W = C::W, BKEY = C::BKEY;
  constexpr bool DV = ROLE != DK_ONLY, DK = ROLE != DV_ONLY;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_wg = w.k0 + row0, rw = r_wg + 16 * warp;
  const int kr = row0 + 16 * warp + g;  // this thread's first row within the K and V tiles
  float dv[DV ? HD / 2 : 1], dk[DK ? HD / 2 : 1];
#pragma unroll
  for (int i = 0; i < (DV ? HD / 2 : 1); ++i) dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DK ? HD / 2 : 1); ++i) dk[i] = 0.f;
  int processed = 0;  // tiles not wholly masked: the same count in both roles
  mbar_wait(w.kv_full, 0);
  for (int i = 0; i < w.n_tiles; ++i) {
    const int s = i % NSTAGE;
    const int q0 = w.q_begin + i * BQ;
    mbar_wait(w.full + s, (i / NSTAGE) & 1);
    if (!kv_all_masked(p.c, q0, BQ, r_wg)) {
      const uint8_t* sq = w.sq + s * C::Q_BYTES;
      const uint8_t* sdo = w.sdo + s * C::Q_BYTES;
      float st[BQ / 2], dpt[DK ? BQ / 2 : 1];
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) st[j] = 0.f;
#pragma unroll
      for (int j = 0; j < (DK ? BQ / 2 : 1); ++j) dpt[j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const int c = 8 * kk + t;
        uint32_t ah[4], al[4];
        if constexpr (DV) {
          ld_a_3xtf32<W>(w.sk, BKEY, kr, c, ah, al);
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            uint32_t bh[2], bl[2];
            split_tf32(ld_tile<W>(sq, BQ, 8 * j + g, c), bh[0], bl[0]);
            split_tf32(ld_tile<W>(sq, BQ, 8 * j + g, c + 4), bh[1], bl[1]);
            mma_3xtf32(st + 4 * j, ah, al, bh, bl);
          }
        }
        if constexpr (DK) {
          ld_a_3xtf32<W>(w.sv, BKEY, kr, c, ah, al);
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            uint32_t bh[2], bl[2];
            split_tf32(ld_tile<W>(sdo, BQ, 8 * j + g, c), bh[0], bl[0]);
            split_tf32(ld_tile<W>(sdo, BQ, 8 * j + g, c + 4), bh[1], bl[1]);
            mma_3xtf32(dpt + 4 * j, ah, al, bh, bl);
          }
        }
      }
      if constexpr (DV)
        p_t<BQ>(p.c, st, w.sl + s * BQ, rw + g, q0, 2 * t, !kv_unmasked(p.c, q0, BQ, rw));
      if constexpr (ROLE == DV_ONLY) put_p<BQ>(w.sx, st, tid, processed == 0);
      if constexpr (ROLE == DK_ONLY) take_p<BQ>(w.sx, st, tid);
      if constexpr (DK) ds_t<BQ>(st, dpt, w.sd + s * BQ, 2 * t);
      ++processed;
#pragma unroll
      for (int kk = 0; kk < BQ / 8; ++kk) {
        // k = t holds query 8kk + 2t and k = t + 4 query 8kk + 2t + 1
        const int r0 = 8 * kk + 2 * t;
        if constexpr (DV) {
          uint32_t ah[4], al[4];
          acc_a_3xtf32(st + 4 * kk, ah, al);
#pragma unroll
          for (int n = 0; n < HD / 8; ++n) {
            uint32_t bh[2], bl[2];
            split_tf32(ld_tile<W>(sdo, BQ, r0, 8 * n + g), bh[0], bl[0]);
            split_tf32(ld_tile<W>(sdo, BQ, r0 + 1, 8 * n + g), bh[1], bl[1]);
            mma_3xtf32(dv + 4 * n, ah, al, bh, bl);
          }
        }
        if constexpr (DK) {
          uint32_t ah[4], al[4];
          acc_a_3xtf32(dpt + 4 * kk, ah, al);
#pragma unroll
          for (int n = 0; n < HD / 8; ++n) {
            uint32_t bh[2], bl[2];
            split_tf32(ld_tile<W>(sq, BQ, r0, 8 * n + g), bh[0], bl[0]);
            split_tf32(ld_tile<W>(sq, BQ, r0 + 1, 8 * n + g), bh[1], bl[1]);
            mma_3xtf32(dk + 4 * n, ah, al, bh, bl);
          }
        }
      }
    }
    release(w.empty + s, lane);
  }
  if (ROLE == DV_ONLY && processed > 0) bar_sync(P_EMPTY + warp, 64);  // the last hand-over's read
  kv_store<float, HD, DV, DK>(p, w, dv, dk, rw + g, 2 * t);
}

template <typename T, int HD, int ROLE>
__device__ __forceinline__ void kv_consume(const KVParams& p, const KVWork& w, int row0) {
  if constexpr (sizeof(T) == 2)
    kv_consume_bf16<HD, ROLE>(p, w, row0);
  else
    kv_consume_f32<HD, ROLE>(p, w, row0);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_dkdv(const __grid_constant__ KVParams p) {
  using C = KVTile<T, HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);  // swizzle atoms need 1024 B
  KVWork w;
  w.sk = smem;
  w.sv = w.sk + C::KEY_BYTES;
  w.sq = w.sv + C::KEY_BYTES;
  w.sdo = w.sq + NSTAGE * C::Q_BYTES;
  w.sl = reinterpret_cast<float*>(w.sdo + NSTAGE * C::Q_BYTES);
  w.sd = w.sl + NSTAGE * C::BQ;
  w.sx = w.sd + NSTAGE * C::BQ;
  w.kv_full = reinterpret_cast<uint64_t*>(w.sx + C::X_FLOATS);
  w.full = w.kv_full + 1;
  w.empty = w.full + NSTAGE;
  w.b = blockIdx.x / p.c.H;
  w.h = blockIdx.x % p.c.H;
  w.g = w.h / (p.c.H / p.c.G);
  w.k0 = blockIdx.y * C::BKEY;  // the earliest key tile first: under the causal mask the heaviest
  // the query rows that see a key of this tile, row i at position
  // i + q_offset: i + q_offset >= j (causal), i + q_offset < j + window
  const int k_last = min(w.k0 + C::BKEY, p.c.T) - 1;
  w.q_begin = p.c.causal ? max(0, w.k0 - p.c.q_offset) / C::BQ * C::BQ : 0;
  const int q_end =
      p.c.window > 0 ? min(p.c.S, k_last + p.c.window - p.c.q_offset) : p.c.S;
  w.n_tiles = q_end > w.q_begin ? (q_end - w.q_begin + C::BQ - 1) / C::BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(w.kv_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(w.full + s, 1);
      mbar_init(w.empty + s, 8);  // the consumer warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) kv_produce<T, HD>(p, w);
  } else {
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;
    if constexpr (C::SPLIT) {
      if (cw == 0)
        kv_consume<T, HD, DV_ONLY>(p, w, 0);
      else
        kv_consume<T, HD, DK_ONLY>(p, w, 0);
    } else {
      kv_consume<T, HD, BOTH>(p, w, 64 * cw);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ

struct QWork {
  uint8_t *sq, *sdo, *sk, *sv;
  uint64_t *q_full, *full, *empty;
  int b, h, g, q0, k_begin, n_tiles;
};

template <typename T, int HD>
__device__ void q_produce(const QParams& p, const QWork& w) {
  using C = QTile<T, HD>;
  mbar_expect_tx(w.q_full, 2 * C::Q_BYTES);
  tma_load_rows<T, HD>(w.sq, &p.tq, w.q_full, C::BQ, w.q0, w.h, w.b);
  tma_load_rows<T, HD>(w.sdo, &p.tdo, w.q_full, C::BQ, w.q0, w.h, w.b);
  for (int i = 0; i < w.n_tiles; ++i) {
    const int s = i % NSTAGE;
    const int k0 = w.k_begin + i * C::BK;
    mbar_wait(w.empty + s, ((i / NSTAGE) & 1) ^ 1);
    mbar_expect_tx(w.full + s, 2 * C::KV_BYTES);
    tma_load_rows<T, HD>(w.sk + s * C::KV_BYTES, &p.tk, w.full + s, C::BK, k0, w.g, w.b);
    tma_load_rows<T, HD>(w.sv + s * C::KV_BYTES, &p.tv, w.full + s, C::BK, k0, w.g, w.b);
  }
}

// lse2 and D of rows q_row and q_row + 8 (below SP: q tiles end at or
// before it).
__device__ __forceinline__ void row_stats(const QParams& p, const QWork& w, int q_row, float* l2,
                                          float* dd) {
  const long long base = (static_cast<long long>(w.b) * p.c.H + w.h) * p.c.SP + q_row;
  l2[0] = p.c.lse2[base];
  l2[1] = p.c.lse2[base + 8];
  dd[0] = p.c.delta[base];
  dd[1] = p.c.delta[base + 8];
}

template <typename T, int HD>
__device__ __forceinline__ void q_store(const QParams& p, const QWork& w, const float* dq,
                                        int q_row, int col) {
  const long long rs = static_cast<long long>(p.c.H) * HD;
  T* base = static_cast<T*>(p.dq) + (static_cast<long long>(w.b) * p.c.S * p.c.H + w.h) * HD;
  store_rows<T, HD>(base, rs, dq, q_row, col, p.c.S, p.c.scale);
}

// KSPLIT: warpgroup 1 hands its dQ part to warpgroup 0, thread to thread,
// through the K/V ring, which holds no tile in use or in flight once both
// have left their loops; warpgroup 0 adds it to its own (a fixed order)
// and alone stores.  Returns whether this warpgroup stores.
template <int HD>
__device__ __forceinline__ bool merge_dq(const QWork& w, float* dq, int cw) {
  float* x = reinterpret_cast<float*>(w.sk);
  const int tid = threadIdx.x % 128;
  bar_sync(DQ_MERGE, 256);
  if (cw == 1) {
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) x[j * 128 + tid] = dq[j];
  }
  bar_sync(DQ_MERGE, 256);
  if (cw == 1) return false;
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) dq[j] += x[j * 128 + tid];
  return true;
}

template <int HD>
__device__ void q_consume_bf16(const QParams& p, const QWork& w, int cw) {
  using C = QTile<__nv_bfloat16, HD>;
  constexpr int BK = C::BK, W = C::W;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row0 = C::KSPLIT ? 0 : 64 * cw;
  const int r_wg = w.q0 + row0, rw = r_wg + 16 * warp;
  const int q_row = rw + lane / 4, col = 2 * (lane % 4);
  float l2[2], dd[2];
  row_stats(p, w, q_row, l2, dd);
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  const uint32_t q_addr = smem_u32(w.sq) + row0 * W, do_addr = smem_u32(w.sdo) + row0 * W;
  mbar_wait(w.q_full, 0);
  for (int i = C::KSPLIT ? cw : 0; i < w.n_tiles; i += C::KSPLIT ? 2 : 1) {
    const int s = i % NSTAGE;
    const int k0 = w.k_begin + i * BK;
    mbar_wait(w.full + s, (i / NSTAGE) & 1);
    if (!q_all_masked(p.c, k0, BK, r_wg)) {
      const uint32_t k_addr = smem_u32(w.sk + s * C::KV_BYTES);
      const uint32_t v_addr = smem_u32(w.sv + s * C::KV_BYTES);
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = dp[j] = 0.f;
      wgmma_fence();
      wgmma_ss_rows<BK, HD, W>(sc, q_addr, C::BQ, k_addr, BK, true);
      wgmma_ss_rows<BK, HD, W>(dp, do_addr, C::BQ, v_addr, BK, true);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BK / 2>(sc);
      fence_regs<BK / 2>(dp);
      grad_scores<BK>(p.c, sc, dp, l2, dd, q_row, k0 + col, !q_unmasked(p.c, k0, BK, rw));
      uint32_t da[BK / 16][4];
      pack_a_bf16<BK>(dp, da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<HD>(dq, da[kk], mnmajor_desc<W>(k_addr + kk * 16 * W, BK * W));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<HD / 2>(dq);
    }
    release(w.empty + s, lane);
  }
  if constexpr (C::KSPLIT) {
    if (!merge_dq<HD>(w, dq, cw)) return;
  }
  q_store<__nv_bfloat16, HD>(p, w, dq, q_row, col);
}

template <int HD>
__device__ void q_consume_f32(const QParams& p, const QWork& w, int cw) {
  using C = QTile<float, HD>;
  constexpr int BK = C::BK, W = C::W, BQ = C::BQ;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = C::KSPLIT ? 0 : 64 * cw;
  const int r_wg = w.q0 + row0, rw = r_wg + 16 * warp;
  const int qr = row0 + 16 * warp + g;  // this thread's first row within the Q and dO tiles
  float l2[2], dd[2];
  row_stats(p, w, rw + g, l2, dd);
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  mbar_wait(w.q_full, 0);
  for (int i = C::KSPLIT ? cw : 0; i < w.n_tiles; i += C::KSPLIT ? 2 : 1) {
    const int s = i % NSTAGE;
    const int k0 = w.k_begin + i * BK;
    mbar_wait(w.full + s, (i / NSTAGE) & 1);
    if (!q_all_masked(p.c, k0, BK, r_wg)) {
      const uint8_t* kt = w.sk + s * C::KV_BYTES;
      const uint8_t* vt = w.sv + s * C::KV_BYTES;
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = dp[j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const int c = 8 * kk + t;
        uint32_t ah[4], al[4];
        ld_a_3xtf32<W>(w.sq, BQ, qr, c, ah, al);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          uint32_t bh[2], bl[2];
          split_tf32(ld_tile<W>(kt, BK, 8 * j + g, c), bh[0], bl[0]);
          split_tf32(ld_tile<W>(kt, BK, 8 * j + g, c + 4), bh[1], bl[1]);
          mma_3xtf32(sc + 4 * j, ah, al, bh, bl);
        }
        ld_a_3xtf32<W>(w.sdo, BQ, qr, c, ah, al);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          uint32_t bh[2], bl[2];
          split_tf32(ld_tile<W>(vt, BK, 8 * j + g, c), bh[0], bl[0]);
          split_tf32(ld_tile<W>(vt, BK, 8 * j + g, c + 4), bh[1], bl[1]);
          mma_3xtf32(dp + 4 * j, ah, al, bh, bl);
        }
      }
      grad_scores<BK>(p.c, sc, dp, l2, dd, rw + g, k0 + 2 * t, !q_unmasked(p.c, k0, BK, rw));
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        // k = t holds key 8kk + 2t and k = t + 4 key 8kk + 2t + 1
        uint32_t ah[4], al[4];
        acc_a_3xtf32(dp + 4 * kk, ah, al);
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          uint32_t bh[2], bl[2];
          split_tf32(ld_tile<W>(kt, BK, 8 * kk + 2 * t, 8 * n + g), bh[0], bl[0]);
          split_tf32(ld_tile<W>(kt, BK, 8 * kk + 2 * t + 1, 8 * n + g), bh[1], bl[1]);
          mma_3xtf32(dq + 4 * n, ah, al, bh, bl);
        }
      }
    }
    release(w.empty + s, lane);
  }
  if constexpr (C::KSPLIT) {
    if (!merge_dq<HD>(w, dq, cw)) return;
  }
  q_store<float, HD>(p, w, dq, rw + g, 2 * t);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_dq(const __grid_constant__ QParams p) {
  using C = QTile<T, HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  QWork w;
  w.sq = smem;
  w.sdo = w.sq + C::Q_BYTES;
  w.sk = w.sdo + C::Q_BYTES;
  w.sv = w.sk + NSTAGE * C::KV_BYTES;
  w.q_full = reinterpret_cast<uint64_t*>(w.sv + NSTAGE * C::KV_BYTES);
  w.full = w.q_full + 1;
  w.empty = w.full + NSTAGE;
  w.b = blockIdx.x / p.c.H;
  w.h = blockIdx.x % p.c.H;
  w.g = w.h / (p.c.H / p.c.G);
  w.q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;  // the latest query tile first
  // the keys this tile's queries see, at positions i + q_offset: j <= the
  // position (causal), j > the position - window
  const int pos0 = p.c.q_offset + w.q0;
  const int k_end = p.c.causal ? min(p.c.T, pos0 + C::BQ) : p.c.T;
  w.k_begin = (p.c.window > 0 ? max(0, pos0 - p.c.window + 1) : 0) / C::BK * C::BK;
  w.n_tiles = k_end > w.k_begin ? (k_end - w.k_begin + C::BK - 1) / C::BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(w.q_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(w.full + s, 1);
      mbar_init(w.empty + s, C::STAGE_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) q_produce<T, HD>(p, w);
  } else {
    setmaxnreg_inc<240>();
    if constexpr (sizeof(T) == 2)
      q_consume_bf16<HD>(p, w, threadIdx.x / 128 - 1);
    else
      q_consume_f32<HD>(p, w, threadIdx.x / 128 - 1);
  }
}

// ---------------------------------------------------------------------------
// 4. GQA: dk and dv as the sums of their group's heads, in head order

template <typename T>
__global__ void __launch_bounds__(SUM_THREADS) flash_bwd_group_sum(
    const float* __restrict__ sk, const float* __restrict__ sv, T* __restrict__ dk,
    T* __restrict__ dv, long long n4, int rep, int hd) {
  const long long i = static_cast<long long>(blockIdx.x) * SUM_THREADS + threadIdx.x;
  if (i >= n4) return;
  const float* src = blockIdx.y ? sv : sk;
  T* dst = blockIdx.y ? dv : dk;
  const long long e = 4 * i, row = e / hd;  // row: (batch, key, group) of the output
  const float* in = src + row * rep * hd + (e - row * hd);
  float4 acc = *reinterpret_cast<const float4*>(in);
  for (int r = 1; r < rep; ++r) {
    const float4 x = *reinterpret_cast<const float4*>(in + static_cast<long long>(r) * hd);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  store_pair(dst + e, acc.x, acc.y);
  store_pair(dst + e + 2, acc.z, acc.w);
}

// ---------------------------------------------------------------------------
// host

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float *lse2, *delta, *sk, *sv;
  void *dq, *dk, *dv;
  const long long* strides;  // (batch, seq, head) of q, k, v, o, dO
  int B, S, T, H, G, causal, window, q_offset;
  float scale;
};

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  using KV = KVTile<T, HD>;
  using Q = QTile<T, HD>;
  // once per kernel: the attribute holds for every later launch
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, KV::SMEM);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::SMEM);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const long long* st = a.strides;
  Common c;
  c.lse2 = a.lse2;
  c.delta = a.delta;
  c.S = a.S;
  c.T = a.T;
  c.H = a.H;
  c.G = a.G;
  c.SP = (a.S + SP_ROUND - 1) / SP_ROUND * SP_ROUND;
  c.causal = a.causal;
  c.window = a.window;
  c.q_offset = a.q_offset;
  c.scale = a.scale;
  c.scale_log2 = a.scale * LOG2E;
  KVParams kv;
  QParams qp;
  if (!encode_rows<T, HD>(&kv.tq, a.q, a.S, a.H, a.B, st, KV::BQ) ||
      !encode_rows<T, HD>(&kv.tdo, a.dout, a.S, a.H, a.B, st + 12, KV::BQ) ||
      !encode_rows<T, HD>(&kv.tk, a.k, a.T, a.G, a.B, st + 3, KV::BKEY) ||
      !encode_rows<T, HD>(&kv.tv, a.v, a.T, a.G, a.B, st + 6, KV::BKEY) ||
      !encode_rows<T, HD>(&qp.tq, a.q, a.S, a.H, a.B, st, Q::BQ) ||
      !encode_rows<T, HD>(&qp.tdo, a.dout, a.S, a.H, a.B, st + 12, Q::BQ) ||
      !encode_rows<T, HD>(&qp.tk, a.k, a.T, a.G, a.B, st + 3, Q::BK) ||
      !encode_rows<T, HD>(&qp.tv, a.v, a.T, a.G, a.B, st + 6, Q::BK))
    return ENCODE_FAILED;
  const int kv_tiles = (a.T + KV::BKEY - 1) / KV::BKEY, q_tiles = (a.S + Q::BQ - 1) / Q::BQ;
  if (kv_tiles > 65535 || q_tiles > 65535) return cudaErrorInvalidValue;

  DeltaParams dp;
  dp.o = a.o;
  dp.dout = a.dout;
  dp.lse = a.lse;
  dp.lse2 = a.lse2;
  dp.delta = a.delta;
  for (int i = 0; i < 3; ++i) {
    dp.os[i] = st[9 + i];
    dp.dos[i] = st[12 + i];
  }
  dp.S = a.S;
  dp.H = a.H;
  dp.SP = c.SP;
  dp.rows = static_cast<long long>(a.B) * a.H * c.SP;
  const long long delta_blocks =
      (dp.rows * delta_lanes<T, HD>() + DELTA_THREADS - 1) / DELTA_THREADS;
  flash_bwd_delta<T, HD><<<static_cast<unsigned>(delta_blocks), DELTA_THREADS, 0, stream>>>(dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const bool grouped = a.H > a.G;
  kv.c = c;
  kv.f32_out = grouped;
  kv.dk = grouped ? static_cast<void*>(a.sk) : a.dk;
  kv.dv = grouped ? static_cast<void*>(a.sv) : a.dv;
  kv.ds[2] = HD;  // (B, T, H, hd) contiguous, the scratch and the H == G outputs alike
  kv.ds[1] = static_cast<long long>(a.H) * HD;
  kv.ds[0] = kv.ds[1] * a.T;
  flash_bwd_dkdv<T, HD><<<dim3(a.B * a.H, kv_tiles), NTHREADS, KV::SMEM, stream>>>(kv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  qp.c = c;
  qp.dq = a.dq;
  flash_bwd_dq<T, HD><<<dim3(a.B * a.H, q_tiles), NTHREADS, Q::SMEM, stream>>>(qp);
  err = cudaGetLastError();
  if (err != cudaSuccess || !grouped) return err;

  const long long n4 = static_cast<long long>(a.B) * a.T * a.G * HD / 4;
  const dim3 grid(static_cast<unsigned>((n4 + SUM_THREADS - 1) / SUM_THREADS), 2);
  flash_bwd_group_sum<T><<<grid, SUM_THREADS, 0, stream>>>(a.sk, a.sv, static_cast<T*>(a.dk),
                                                           static_cast<T*>(a.dv), n4, a.H / a.G, HD);
  return cudaGetLastError();
}

template <typename T>
int dispatch_hd(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 96: return launch<T, 96>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ptrs[13] = q, k, v, o, dO (B,S,H,hd or B,T,G,hd, last dim contiguous,
// suited to TMA: 16-byte aligned base, byte strides that are multiples of
// 16), lse (f32 (B,H,S) from the forward, contiguous), lse2 and delta (f32
// scratch of B*H*SP floats each, SP = S rounded up to 128), dq, dk, dv
// (contiguous, the shapes of q, k, v), and where H > G two f32 scratch
// arrays of B*T*H*hd floats for the heads' dK and dV (else null);
// strides[15] = (batch, seq, head) element strides of q, k, v, o, dO; query
// row i sits at position q_offset + i (>= 0) and key j at j.
// dtype: 0 = float32, 1 = bfloat16 (every tensor but lse and the scratch).
// Returns 0 on success, -1 if a tensor map could not be encoded, else the
// CUDA error of a launch.
extern "C" int flash_attention_bwd(const long long* ptrs, const long long* strides, int dtype,
                                   int B, int S, int T, int H, int G, int hd, int causal,
                                   int window, int q_offset, float scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || G <= 0 || H % G != 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = reinterpret_cast<const void*>(ptrs[0]);
  a.k = reinterpret_cast<const void*>(ptrs[1]);
  a.v = reinterpret_cast<const void*>(ptrs[2]);
  a.o = reinterpret_cast<const void*>(ptrs[3]);
  a.dout = reinterpret_cast<const void*>(ptrs[4]);
  a.lse = reinterpret_cast<const float*>(ptrs[5]);
  a.lse2 = reinterpret_cast<float*>(ptrs[6]);
  a.delta = reinterpret_cast<float*>(ptrs[7]);
  a.dq = reinterpret_cast<void*>(ptrs[8]);
  a.dk = reinterpret_cast<void*>(ptrs[9]);
  a.dv = reinterpret_cast<void*>(ptrs[10]);
  a.sk = reinterpret_cast<float*>(ptrs[11]);
  a.sv = reinterpret_cast<float*>(ptrs[12]);
  if (H > G && (a.sk == nullptr || a.sv == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  a.strides = strides;
  a.B = B;
  a.S = S;
  a.T = T;
  a.H = H;
  a.G = G;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0   ? dispatch_hd<float>(a, hd, st)
         : dtype == 1 ? dispatch_hd<__nv_bfloat16>(a, hd, st)
                      : static_cast<int>(cudaErrorInvalidValue);
}
