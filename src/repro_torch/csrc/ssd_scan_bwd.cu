// Mamba2 SSD scan backward for Hopper (sm_90a), chunk-parallel, with a plain C interface.
//
// The gradient of the JAX package's Pallas TPU kernel `kernels/ssd_scan.py`
// (`ssd_scan`), which the JAX package takes by autodiff of its jnp
// `models/mamba.py` `ssd_chunked`: it has no Pallas backward.  In the
// forward's notation (ssd_scan.cu), per (batch, head) and chunk of L = 64
// rows, cum the in-chunk inclusive cumsum of dt * a, h_in the state entering
// the chunk and g the gradient of the state leaving it (dState after the
// last chunk):
//   M[l][m] = (C_l . B_m) exp(cum_l - cum_m),  W[l][m] = exp(cum_l - cum_m) dt_m (dY_l . x_m),
//     both for l >= m, else 0
//   dx_m   = dt_m (sum_l M[l][m] dY_l + exp(cum_{L-1} - cum_m) g^T B_m)
//   dC_l   = sum_m W[l][m] B_m + exp(cum_l) h_in dY_l
//   dB_m   = sum_l W[l][m] C_l + dt_m exp(cum_{L-1} - cum_m) g x_m
//   dh_in  = exp(cum_{L-1}) g + sum_l exp(cum_l) C_l^T dY_l   (g of the chunk before)
//   dcum_l = sum_m M[l][m] dt_m (dY_l . x_m) - (the same summed over the column l)
//            + dY_l . (exp(cum_l) C_l h_in) - u_l,  u_m = exp(cum_{L-1} - cum_m) dt_m x_m . (g^T B_m),
//            and on the last row also sum_m u_m + exp(cum_{L-1}) <g, h_in>
//   ddt_m  = x_m . dx_m / dt_m + a rc_m,  da = sum dt_m rc_m,  rc = the reverse cumsum of dcum
// dx, dB and dC in the inputs' dtype, ddt and da in f32; a group's dB and dC
// summed over its heads.  `ssd_scan_bwd_plain` in kernels/ssd_scan.py is the
// same chunk algebra in plain torch.
//
// Design: five launches, none with atomics, so two calls give the same bits.
// The per-chunk launches (1 and 3) take a block per (chunk, batch, kh heads
// of one group), kh by the forward's rule (`heads_per_block`, ssd_scan.cuh:
// the most, up to 8, that leave 512 blocks; 8 at mamba2-130m's (4, 4096, 24,
// 64), N = 128, 768 blocks of each kind).  A block loads B and C once and
// walks its heads; the next head's operands arrive by cp.async while the
// current head computes.
//   1. ssd_bwd_chunk_grad: Z_c = sum_l exp(cum_l) C_l^T dY_l (N x P) per
//      head into a scratch buffer, phase 1 of the forward turned over; Z
//      leaves through the bulk copy engine (cp.async.bulk, a row a thread)
//      while the next head's product runs.  Bound by operations, 2 L N P
//      flops per chunk and head, and by the 201 MB it writes at mamba2-130m.
//   2. ssd_bwd_state_pass, a thread per 4 state elements: the chain walked
//      backwards, g <- exp(cum_{L-1}) g + Z_c, leaving in each chunk's slot
//      the gradient of the state leaving it.  Bound by bytes (the scratch
//      read and written once), pipelined as the forward's pass.
//   3. ssd_bwd_dxbc: dx, ddt and the chunk's share of da per head, and dB and
//      dC summed over the block's heads in registers, in head order, written
//      as one f32 partial per (batch, row, head-block).  Per head:
//        with g in shared memory:    B g (dx, and u), x g^T (dB);
//        with h_in replacing g:      dY h_in^T (dC, and dY . C h_in = C . dY h_in^T);
//        the scores, once per head:  x dY^T -> W^T, and M^T from the block's C B^T
//                                    (computed once for the kh heads);
//        through shared memory:      M^T dY (dx), W^T C (dB), W B (dC);
//      dcum from row and column sums taken in a fixed order, its reverse
//      cumsum, ddt and da's share.  6 L N P + L^2 (3.25 P + 2.5 N + 2 N / kh)
//      flops per chunk and head as run (score tiles above the diagonal and
//      the diagonal's 16 x 16 blocks computed whole): bound by operations.
//   4. ssd_bwd_group_sum: each group's head-block partials of dB and dC
//      added in order, cast to the dtype.  Bound by bytes.
//   5. ssd_bwd_da: per head, the chunks' shares of da added in a fixed order.
//
// The states entering each chunk are the forward's own scratch, which holds
// them after its phase 2: the autograd Function saves it, 201 MB a layer at
// mamba2-130m's train shape (12.6 MB on a rank that scans 4 of its 64 head
// columns), so the forward is not launched again.  The
// backward's own scratch, (B*H, nc, N, P) for g and (B, S, H/kh, N) twice for
// the head-blocks' dB and dC (252 MB at that shape), lives for one call.
//
// Products.  All on the tensor cores, mma.sync m16n8k8 TF32 with f32
// accumulators: in f32 as 3xTF32 (hi and lo parts by `split_tf32_trunc`,
// the three passes of `mma_3xtf32`, hopper.cuh; one TF32 pass misses 1e-4),
// each A fragment split once per k-step and reused across the warp's
// n-tiles.  The truncating split takes 2 operations where the rounding one
// takes 5 (and ptxas drops the hi mask, which mma ignores): the products'
// integer work, more than the tensor cores, sets their pace.  bf16 inputs
// are exact in TF32, so a product with one bf16 operand drops its lo term
// (two passes), and the two products of bf16 inputs alone (C B^T, x dY^T) run
// on mma.sync m16n8k16 bf16, operands by ldmatrix, as the forward's
// ssd_scan_output_bf16.  Eight warps: warp w owns rows 16 (w % 4) .. + 15 of
// the chunk and half w / 4 of the output's columns.  Since a warp holds only
// half of a row's scores, M^T and W^T pass through shared memory (once per
// head) as the A operand of the next products.
//
// One copy of each operand in shared memory, read in either orientation: f32
// rows of max(W, 32) floats, the 4-float group of column c in row r at
// c ^ swz(r) (`STile`: m16n8k8 fragments read conflict-free as rows or as
// columns); bf16 rows padded by 16 bytes (conflict-free for ldmatrix and for
// single loads either way).  A lane's fragment rows keep their low three
// bits, so each lane computes its three swizzles once (`Lane`).  Budget of
// ssd_bwd_dxbc at N = 128, P = 64 f32:
// B and C 64 KB, x and dY 2 x 32 KB (this head's and the next's), g then
// h_in 32 KB, M^T and W^T 32 KB: one block of 8 warps an SM.  g arrives by
// cp.async while the scores run; h_in by plain loads (prefetched into L2)
// that also take <g, h_in> as they replace g.  Where the two stages of x and
// dY do not fit (f32, P = 128) they take one, and where M^T and W^T do not
// (f32, N = P = 128) they share one buffer.  Rows past S load as dt = 0 and
// x = B = C = dY = 0 and are never written.
//
// Head dims Q below 16 take the forward's packed tiles (`Packed`,
// ssd_scan.cuh: K = 16 / Q heads of a group side by side, kt tiles a block by
// `tiles_per_block`), states (N, Q) a head, and five launches again:
//   1. ssd_bwd_chunk_grad_narrow: Z_c of a tile's heads as one product
//      C^T (dY o exp(cum)), the forward's `narrow_chunk_state` turned over.
//   2. ssd_bwd_state_pass at P = Q.
//   3. ssd_bwd_dx_narrow, a block per (chunk, batch, kt tiles of a group): R =
//      C B^T once; per tile B g and C h_in as one product each over the packed
//      g and h_in (N x 16); then per head at width Q, a thread per row m and 4
//      columns walking every l: pair (l, m), l >= m, gives M^T dY into dx, T's
//      column sum and W, pair (m, l), l <= m, T's row sum, each pair one exp
//      of a non-positive difference.  W is summed over the block's heads in
//      shared memory (a thread owns its rows l = 4 i + lq of column m, so the
//      sums need no atomics: each tile's heads in order, the tiles in order),
//      and written once per block.
//   4. ssd_bwd_dbc_narrow, a block per (chunk, batch, group): the group's W
//      (its head-blocks' partials added in order), dC = W B + the packed
//      (dY e_in) h_in^T and dB = W^T C + (x dt e_end) g^T, one product of
//      depth 16 per tile: the products whose width is N run once per group
//      and block, not per head.  Written in the dtype: no group sum.
//   5. ssd_bwd_da.
// The products (C B^T, B g, C h_in, Z_c, and dB and dC) on the tensor cores
// in 3xTF32 (`warp_block`, `warp_mma`; a pass fewer for bf16 B and C), the
// per-head scores on the CUDA cores in f32, exp by the SFU's ex2.  The
// scratch: the state gradients (N, Q) a head and W per head-block, not dB and
// dC per head-block.  Launches at Q >= 16 are the code they were.
//
// `nvcc -Xptxas -v` (CUDA 12.8, sm_90a) at N = 128, P = 64, f32 / bf16, no
// spills (spills only at N = P = 128, up to 88 bytes):
//   ssd_bwd_chunk_grad  127 / 91 registers, 103,424 / 73,728 B shared, 256 threads: 2 blocks/SM
//   ssd_bwd_state_pass   95 registers, no shared, 256 threads
//   ssd_bwd_dxbc        255 / 249 registers, 200,736 / 141,344 B shared, 256 threads: 1 block/SM
//   ssd_bwd_group_sum    46 / 44 registers, no shared, 256 threads
//   ssd_bwd_da           33 registers, no shared, 32 threads
// and at N = 128, Q = 4 (f32 / bf16):
//   ssd_bwd_chunk_grad_narrow  56 / 59 registers, 256 threads
//   ssd_bwd_dx_narrow          159,824 B shared at K = 4 heads a tile: 1 block/SM
//   ssd_bwd_dbc_narrow         128 / 128 registers (32 / 36 B spilled), 98,304 B shared: 2 blocks/SM

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_scan.cuh"

namespace {

constexpr int NT = 256;  // threads of the per-chunk kernels 1 and 3: 8 warps
constexpr int NT_PASS = 256;
constexpr int PASS_DEPTH = 8;  // chunks whose loads a thread of the pass keeps in flight
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const void* dy;
  const float* dstate;  // (B, H, P, N), or null for zero
  const float* h_in;    // (B*H, nc, N, P): the state entering each chunk (the forward's scratch)
  const float* decay;   // (B*H, nc): exp(cum_{L-1}) of each chunk (the forward's scratch)
  float* g;             // (B*H, nc, N, P): Z_c, then the gradient of the state leaving chunk c
  float* db_part;       // (B, S, H/kh, N): each head-block's dB
  float* dc_part;       // (B, S, H/kh, N): each head-block's dC
  float* w_part;        // at P < 16 (B, nc, G, head-blocks of a group, L, L): W over a block's heads
  float* da_part;       // (B*H, nc): each chunk's share of da
  void* dx;             // (B, S, H, P), contiguous
  float* ddt;           // (B, S, H), contiguous
  float* da;            // (H,)
  void* db;             // (B, S, G, N), contiguous
  void* dc;             // (B, S, G, N), contiguous
  int B, S, H, G, nc;
  int kh;  // heads per block of kernels 1 and 3, all of one group; at P < 16 tiles per block
  // element strides of (batch, sequence, head or group) for x, dt, b, c, dy;
  // the last dim of x, b, c, dy is contiguous
  long long xs[3], dts[3], bs[3], cs[3], dys[3];
};

// The (chunk, batch, kh heads of one group) of a per-chunk block
struct Blk {
  int ch, s0, bi, hb, h0, g;
  __device__ explicit Blk(const Params& p) : ch(blockIdx.x), s0(blockIdx.x * L) {
    const int per_b = p.H / p.kh;  // head-blocks per batch row
    bi = blockIdx.y / per_b;
    hb = blockIdx.y % per_b;
    h0 = hb * p.kh;
    g = h0 / (p.H / p.G);
  }
  __device__ long long slot(const Params& p, int h) const {
    return (static_cast<long long>(bi) * p.H + h) * p.nc + ch;
  }
  __device__ long long row(const Params& p, int s) const {  // (b, s) of (B, S, ...)
    return static_cast<long long>(bi) * p.S + s;
  }
};

// Warp 0 only.  Lane k's rows 2k, 2k+1 of head h's dt (0 past S) and the
// head's a, fetched a head ahead.
__device__ __forceinline__ HeadDt fetch_dt(const Params& p, const Blk& k, int h) {
  const float* dtg = p.dt + k.bi * p.dts[0] + h * p.dts[2];
  const int s = k.s0 + 2 * threadIdx.x;
  return {s < p.S ? dtg[s * p.dts[1]] : 0.f, s + 1 < p.S ? dtg[(s + 1) * p.dts[1]] : 0.f, p.a[h]};
}

template <typename T>
__device__ __forceinline__ const T* at(const void* base, const long long* st, int bi, int h) {
  return static_cast<const T*>(base) + bi * st[0] + h * st[2];
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  uint2 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  *reinterpret_cast<uint2*>(dst) = u;
}

// ---- shared-memory tiles ----------------------------------------------------------------------
// Rows of W elements of T, addressed by (row, column).  An m16n8k8 fragment
// reads 8 rows x 4 columns (an operand as stored) or 4 rows x 8 columns (an
// operand transposed) at once; both must hit 32 distinct banks.  f32 rows
// take max(W, 32) floats and hold column c at c ^ swz(r): swz keeps the
// 4-float groups whole, gives rows 0..7 distinct multiples of 4 (bits 2-4)
// and rows 0..3 and 4..7 distinct multiples of 8 (bits 3-4).  bf16 rows take
// W + 8 elements, which does both for 2-byte loads and keeps ldmatrix rows
// on 16 bytes.
__device__ __forceinline__ int swz(int r) {
  return ((r >> 1 & 1) << 4) | (((r ^ (r >> 2)) & 1) << 3) | ((r >> 2 & 1) << 2);
}

template <typename T, int W>
struct STile;

// Every access below but the loads into the tiles reads rows whose low three
// bits are fixed for the lane (gq, tq or tq + 4 above a multiple of 8), so
// it passes the row's swizzle `s`, computed once (`Lane`).
template <int W>
struct STile<float, W> {
  static constexpr int LD = W < 32 ? 32 : W;
  static constexpr bool EXACT = false;  // needs a lo part in TF32
  float* p;
  __device__ __forceinline__ int off(int r, int c, int s) const { return r * LD + (c ^ s); }
  __device__ __forceinline__ int off(int r, int c) const { return off(r, c, swz(r)); }
  __device__ __forceinline__ float at(int r, int c, int s) const { return p[off(r, c, s)]; }
};

template <int W>
struct STile<__nv_bfloat16, W> {
  static constexpr int LD = W + 8;
  static constexpr bool EXACT = true;  // 8 significant bits: exact in TF32
  __nv_bfloat16* p;
  __device__ __forceinline__ int off(int r, int c, int = 0) const { return r * LD + c; }
  __device__ __forceinline__ float at(int r, int c, int = 0) const {
    return __bfloat162float(p[off(r, c)]);
  }
};

// A lane's place in the m16n8k8 fragments: gq = lane / 4, tq = lane % 4, and
// the swizzles of the rows it reads: s1 of gq (and gq + 8), s2[e] of tq + 4e.
struct Lane {
  int lane, gq, tq, s1, s2[2];
  __device__ Lane() : lane(threadIdx.x & 31), gq(lane >> 2), tq(lane & 3), s1(swz(gq)) {
    s2[0] = swz(tq);
    s2[1] = swz(tq + 4);
  }
};

template <typename T, int W>
constexpr int tile_bytes(int rows) {
  return rows * STile<T, W>::LD * static_cast<int>(sizeof(T));
}

// The chunk's L rows of W values (row stride rs; zeros past S) into t, by cp.async.
template <typename T, int W>
__device__ __forceinline__ void async_rows(const STile<T, W>& t, const T* src, long long rs,
                                           int s0, int S) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte copy
  for (int i = threadIdx.x; i < L * W / V; i += NT) {
    const int l = i / (W / V), c = (i % (W / V)) * V, s = s0 + l;
    cp_async16(t.p + t.off(l, c), src + (s < S ? s : 0) * rs + c, s < S);
  }
}

// A chunk's (N, P) f32 state into t, by cp.async.
template <int N, int P>
__device__ __forceinline__ void async_state(const STile<float, P>& t, const float* src) {
  for (int i = threadIdx.x; i < N * P / 4; i += NT) {
    const int n = i / (P / 4), q = (i % (P / 4)) * 4;
    cp_async16(t.p + t.off(n, q), src + 4 * i, true);
  }
}

// ---- warp products on the tensor cores ----------------------------------------------------------
// The same for two bf16 tiles that both hold k along their rows:
// acc[j] += sum_k A[r0 + row][k] Bt[n0 + 8 j + col][k], k < K, by ldmatrix
// and mma.sync m16n8k16 bf16 (exact products, f32 sums).
template <int NJ, int K, int LDA, int LDB>
__device__ __forceinline__ void warp_mma_bf16(float (&acc)[NJ][4], const __nv_bfloat16* A, int r0,
                                              const __nv_bfloat16* Bt, int n0) {
  static_assert(NJ % 2 == 0, "n-tiles go in pairs");
  const int lane = threadIdx.x & 31;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, A + (r0 + lrow) * LDA + 16 * kk + lcol);
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, Bt + (n0 + 16 * jp + brow) * LDB + 16 * kk + bcol);
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// Lane sums of the rows gq and gq + 8 over the quad's four lanes (fixed order)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}
// ... and of a column over the warp's 8 row pairs
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 4);
  v += __shfl_xor_sync(FULL, v, 8);
  return v + __shfl_xor_sync(FULL, v, 16);
}

// ---- 1: Z_c = sum_l exp(cum_l) C_l^T dY_l, kh heads a block ---------------------------------------
template <typename T, int N, int P>
struct GradSmem {
  static constexpr int C_BYTES = tile_bytes<T, N>(L), Y_BYTES = tile_bytes<T, P>(L);
  // Z staged for the bulk copies, rows padded by 8 floats: a half-warp's
  // float2 stores of rows gq and columns 2 tq hit 32 banks
  static constexpr int ZLD = P + 8, Z_BYTES = N * ZLD * static_cast<int>(sizeof(float));
  static constexpr int BYTES = C_BYTES + 2 * Y_BYTES + Z_BYTES + 4 * L * static_cast<int>(sizeof(float));
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

template <typename T, int N, int P>
__global__ void __launch_bounds__(NT, 2) ssd_bwd_chunk_grad(const Params p) {
  using SM = GradSmem<T, N, P>;
  constexpr bool EX = STile<T, P>::EXACT;
  // warps over the output's N / 16 row slabs and column groups of NJ n-tiles
  constexpr int WR = N / 16 < 8 ? N / 16 : 8, WC = 8 / WR;
  constexpr int NJ = P / 8 / WC > 0 ? P / 8 / WC : 1;
  extern __shared__ float4 smem4[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem4);
  const STile<T, N> Cs{reinterpret_cast<T*>(base)};
  T* y0 = reinterpret_cast<T*>(base + SM::C_BYTES);
  float* zs = reinterpret_cast<float*>(base + SM::C_BYTES + 2 * SM::Y_BYTES);  // N x ZLD: Z
  float* ew = zs + N * SM::ZLD;                                                 // 2 x L: exp(cum)
  float* cum = ew + 2 * L;                                                      // L
  float* dtl = cum + L;                                                         // L
  const Lane ln;
  const int tid = threadIdx.x, warp = tid >> 5, lane = ln.lane, gq = ln.gq, tq = ln.tq;
  const int n0 = 16 * (warp % WR), c0 = 8 * NJ * (warp / WR);
  const Blk k(p);
  const auto ys = [&](int st) { return STile<T, P>{y0 + st * (SM::Y_BYTES / sizeof(T))}; };
  const auto weights = [&](const HeadDt& d, float* e) {  // warp 0: exp(cum) of a head
    chunk_cumsum(d, cum, dtl);
    e[2 * lane] = expf(cum[2 * lane]);
    e[2 * lane + 1] = expf(cum[2 * lane + 1]);
  };

  async_rows(Cs, at<T>(p.c, p.cs, k.bi, k.g), p.cs[1], k.s0, p.S);
  async_rows(ys(0), at<T>(p.dy, p.dys, k.bi, k.h0), p.dys[1], k.s0, p.S);
  if (warp == 0) weights(fetch_dt(p, k, k.h0), ew);
  cp_async_wait_all();
  __syncthreads();
  for (int kq = 0; kq < p.kh; ++kq) {
    const int h = k.h0 + kq, st = kq & 1;
    const bool more = kq + 1 < p.kh;
    HeadDt next{};
    if (more) {  // the next head's dY arrives while this head's product runs
      async_rows(ys(st ^ 1), at<T>(p.dy, p.dys, k.bi, h + 1), p.dys[1], k.s0, p.S);
      if (warp == 0) next = fetch_dt(p, k, h + 1);
    }
    if (c0 < P) {
      const STile<T, P> Y = ys(st);
      const float* e = ew + st * L;
      float acc[NJ][4];
      zero_acc(acc);
      // A(n, l) = C[l][n] exp(cum_l), B(l, q) = dY[l][q]
      warp_mma<NJ, false, EX>(
          acc,
          [&](int hi, int i, int kb) {
            const int l = kb + tq + 4 * i;
            return Cs.at(l, n0 + gq + 8 * hi, ln.s2[i]) * e[l];
          },
          [&](int i, int kb, int j) { return Y.at(kb + tq + 4 * i, c0 + 8 * j + gq, ln.s2[i]); },
          0, L);
      // every bulk copy of the last head's Z had read zs before the barrier above
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int q = c0 + 8 * j + 2 * tq;
        store_pair(zs + (n0 + gq) * SM::ZLD + q, acc[j][0], acc[j][1]);
        store_pair(zs + (n0 + gq + 8) * SM::ZLD + q, acc[j][2], acc[j][3]);
      }
    }
    fence_async_smem();
    __syncthreads();
    // Z leaves a row a thread through the bulk copy engine while the next
    // head's product runs
    if (tid < N) bulk_store(p.g + k.slot(p, h) * N * P + tid * P, zs + tid * SM::ZLD, P * 4);
    // the other weights' last readers passed the barrier before this head
    if (more && warp == 0) weights(next, ew + (st ^ 1) * L);
    if (tid < N) bulk_wait_read();
    cp_async_wait_all();
    __syncthreads();
  }
  if (tid < N) bulk_wait();
}

// ---- 2: g <- exp(cum_{L-1}) g + Z_c, chunks in reverse, in place -----------------------------
template <int N, int P>
__global__ void __launch_bounds__(NT_PASS) ssd_bwd_state_pass(const Params p) {
  constexpr int V = N * P / 4;  // float4s per chunk state
  const int e4 = blockIdx.x * NT_PASS + threadIdx.x;
  if (e4 >= V) return;
  const long long bh = blockIdx.y;
  const float* dec = p.decay + bh * p.nc;
  float4* st = reinterpret_cast<float4*>(p.g) + bh * p.nc * V + e4;
  // dState is (P, N) per head, the scratch (N, P)
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p.dstate) {
    const float* ds = p.dstate + bh * P * N;
    if constexpr (P >= 4) {
      const int n = 4 * e4 / P, q = 4 * e4 % P;
      g = make_float4(ds[q * N + n], ds[(q + 1) * N + n], ds[(q + 2) * N + n], ds[(q + 3) * N + n]);
    } else {  // the four span rows n
      const auto at4 = [&](int j) { return ds[(4 * e4 + j) % P * N + (4 * e4 + j) / P]; };
      g = make_float4(at4(0), at4(1), at4(2), at4(3));
    }
  }
  // step k visits chunk nc-1-k: Z_c is read and the gradient of the state
  // leaving chunk c written in its place; the next PASS_DEPTH chunks' loads
  // are issued before this group's stores
  float4 cur[PASS_DEPTH], nxt[PASS_DEPTH];
  float ec[PASS_DEPTH], en[PASS_DEPTH];
#pragma unroll
  for (int k = 0; k < PASS_DEPTH; ++k) {
    const int c = p.nc - 1 - k;
    if (c >= 0) cur[k] = __ldcs(st + static_cast<long long>(c) * V), ec[k] = dec[c];
  }
  for (int k0 = 0; k0 < p.nc; k0 += PASS_DEPTH) {
#pragma unroll
    for (int k = 0; k < PASS_DEPTH; ++k) {
      const int c = p.nc - 1 - (k0 + PASS_DEPTH + k);
      if (c >= 0) nxt[k] = __ldcs(st + static_cast<long long>(c) * V), en[k] = dec[c];
    }
#pragma unroll
    for (int k = 0; k < PASS_DEPTH; ++k)
      if (k0 + k < p.nc) {
        __stcs(st + static_cast<long long>(p.nc - 1 - (k0 + k)) * V, g);
        g = make_float4(fmaf(ec[k], g.x, cur[k].x), fmaf(ec[k], g.y, cur[k].y),
                        fmaf(ec[k], g.z, cur[k].z), fmaf(ec[k], g.w, cur[k].w));
      }
#pragma unroll
    for (int k = 0; k < PASS_DEPTH; ++k) cur[k] = nxt[k], ec[k] = en[k];
  }
}

// ---- 3: dx, ddt, da's share per head; dB and dC per head-block -----------------------------------
template <typename T, int N, int P>
struct DxbcSmem {
  static constexpr int B_BYTES = tile_bytes<T, N>(L);      // one of B, C
  static constexpr int X_BYTES = tile_bytes<T, P>(L);      // one of x, dY
  static constexpr int G_BYTES = tile_bytes<float, P>(N);  // g, then h_in
  static constexpr int S_BYTES = tile_bytes<float, L>(L);  // one of M^T, W^T
  // cum and dt of two heads; column sums by slab; row sums, u, dY . C h_in
  // and x . dx by column half; <g, h_in> by warp
  static constexpr int SMALL = (4 + 4 + 8) * L * 4 + 8 * 4;
  static constexpr int bytes(int xs, int ss) {
    return 2 * B_BYTES + 2 * xs * X_BYTES + G_BYTES + ss * S_BYTES + SMALL;
  }
  static constexpr int XS = bytes(2, 2) <= SMEM_LIMIT ? 2 : 1;   // stages of x and dY
  static constexpr int SS = bytes(XS, 2) <= SMEM_LIMIT ? 2 : 1;  // M^T and W^T apart or in turn
  static constexpr int BYTES = bytes(XS, SS);
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

template <typename T, int N, int P>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_dxbc(const Params p) {
  using SM = DxbcSmem<T, N, P>;
  constexpr int XS = SM::XS, SS = SM::SS;
  constexpr bool EX = STile<T, P>::EXACT;
  constexpr int NP = P / 16, NN = N / 16;  // n-tiles of a column half of P and of N
  extern __shared__ float4 smem4[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem4);
  const STile<T, N> Bs{reinterpret_cast<T*>(base)};
  const STile<T, N> Cs{reinterpret_cast<T*>(base + SM::B_BYTES)};
  uint8_t* xbase = base + 2 * SM::B_BYTES;  // x of each stage, then dY of each stage
  const STile<float, P> Gs{reinterpret_cast<float*>(xbase + 2 * XS * SM::X_BYTES)};
  const STile<float, L> Ms{Gs.p + SM::G_BYTES / 4};                  // M^T
  const STile<float, L> Ws{Ms.p + (SS - 1) * (SM::S_BYTES / 4)};     // W^T
  float* cum = Ms.p + SS * (SM::S_BYTES / 4);  // 2 x L
  float* dtl = cum + 2 * L;                    // 2 x L
  float* tcol = dtl + 2 * L;                   // 4 x L: column sums of T' by row slab
  float* trow = tcol + 4 * L;                  // 2 x L: row sums of T' by column half
  float* upart = trow + 2 * L;                 // 2 x L: x . (B g) by half
  float* ypart = upart + 2 * L;                // 2 x L: C . (dY h_in^T) by half
  float* dpart = ypart + 2 * L;                // 2 x L: x . dx / dt by half
  float* ghp = dpart + 2 * L;                  // 8: <g, h_in> by warp
  const Lane ln;
  const int tid = threadIdx.x, warp = tid >> 5, lane = ln.lane, gq = ln.gq, tq = ln.tq;
  const int s1 = ln.s1;                     // the swizzle of rows ra and rb
  const int sl = warp & 3, hc = warp >> 2;  // the warp's row slab and column half
  const int r0 = 16 * sl, ra = r0 + gq, rb = ra + 8;
  const int cp0 = hc * P / 2, cn0 = hc * N / 2, cl0 = hc * L / 2;
  const Blk k(p);
  const auto xs = [&](int st) { return STile<T, P>{reinterpret_cast<T*>(xbase + st * SM::X_BYTES)}; };
  const auto ys = [&](int st) {
    return STile<T, P>{reinterpret_cast<T*>(xbase + (XS + st) * SM::X_BYTES)};
  };
  const auto fetch_xy = [&](int st, int h) {
    async_rows(xs(st), at<T>(p.x, p.xs, k.bi, h), p.xs[1], k.s0, p.S);
    async_rows(ys(st), at<T>(p.dy, p.dys, k.bi, h), p.dys[1], k.s0, p.S);
  };
  async_rows(Bs, at<T>(p.b, p.bs, k.bi, k.g), p.bs[1], k.s0, p.S);
  async_rows(Cs, at<T>(p.c, p.cs, k.bi, k.g), p.cs[1], k.s0, p.S);
  fetch_xy(0, k.h0);
  async_state<N, P>(Gs, p.g + k.slot(p, k.h0) * N * P);
  if (warp == 0) chunk_cumsum(fetch_dt(p, k, k.h0), cum, dtl);
  cp_async_wait_all();
  __syncthreads();

  // R^T[m][l] = B_m . C_l for the warp's rows m and half of l, once for the block's heads
  float rt[4][4];
  zero_acc(rt);
  if constexpr (EX) {
    warp_mma_bf16<4, N, STile<T, N>::LD, STile<T, N>::LD>(rt, Bs.p, r0, Cs.p, cl0);
  } else {
    warp_mma<4, false, false>(
        rt, [&](int hi, int i, int kb) { return Bs.at(ra + 8 * hi, kb + tq + 4 * i, s1); },
        [&](int i, int kb, int j) { return Cs.at(cl0 + 8 * j + gq, kb + tq + 4 * i, s1); }, 0, N);
  }

  float dbt[NN][4], dct[NN][4];  // dB and dC of the block's heads, rows of the slab, half of N
  zero_acc(dbt);
  zero_acc(dct);
  for (int kq = 0; kq < p.kh; ++kq) {
    const int h = k.h0 + kq, st = XS == 2 ? (kq & 1) : 0;
    const bool more = kq + 1 < p.kh;
    const float* cm = cum + (kq & 1) * L;
    const float* dm = dtl + (kq & 1) * L;
    const STile<T, P> X = xs(st), Y = ys(st);
    if constexpr (XS == 2)
      if (more) fetch_xy(st ^ 1, h + 1);
    HeadDt next{};
    if (warp == 0 && more) next = fetch_dt(p, k, h + 1);
    const float* hsrc = p.h_in + k.slot(p, h) * N * P;
    for (int i = tid; i < N * P / 32; i += NT)  // h_in's lines into L2 ahead of their use
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(hsrc + 32 * i));
    const float ea = expf(cm[L - 1] - cm[ra]), eb = expf(cm[L - 1] - cm[rb]);

    // -- with g: dx = exp(cum_{L-1} - cum_m) (B g) [+ M^T dY below]; u; dB += (dt e x) g^T
    float dxa[NP][4];
    zero_acc(dxa);
    warp_mma<NP, EX, false>(
        dxa, [&](int hi, int i, int kb) { return Bs.at(ra + 8 * hi, kb + tq + 4 * i, s1); },
        [&](int i, int kb, int j) { return Gs.at(kb + tq + 4 * i, cp0 + 8 * j + gq, ln.s2[i]); },
        0, N);
    {
      float ua = 0.f, ub = 0.f;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int q = cp0 + 8 * j + 2 * tq;
        ua += X.at(ra, q, s1) * dxa[j][0] + X.at(ra, q + 1, s1) * dxa[j][1];
        ub += X.at(rb, q, s1) * dxa[j][2] + X.at(rb, q + 1, s1) * dxa[j][3];
        dxa[j][0] *= ea, dxa[j][1] *= ea, dxa[j][2] *= eb, dxa[j][3] *= eb;
      }
      ua = quad_sum(ua), ub = quad_sum(ub);
      if (tq == 0) upart[hc * L + ra] = ua, upart[hc * L + rb] = ub;
    }
    {
      const float fa = dm[ra] * ea, fb = dm[rb] * eb;
      warp_mma<NN, false, false>(
          dbt,
          [&](int hi, int i, int kb) { return X.at(ra + 8 * hi, kb + tq + 4 * i, s1) * (hi ? fb : fa); },
          [&](int i, int kb, int j) { return Gs.at(cn0 + 8 * j + gq, kb + tq + 4 * i, s1); }, 0, P);
    }
    __syncthreads();  // g is read no more

    // -- h_in replaces g, and <g, h_in> on the way
    {
      constexpr int V = N * P / 4, BATCH = 8;
      float dot = 0.f;
      for (int i0 = tid; i0 < V; i0 += BATCH * NT) {
        float4 hv[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j)
          if (i0 + j * NT < V) hv[j] = *reinterpret_cast<const float4*>(hsrc + 4 * (i0 + j * NT));
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int i = i0 + j * NT;
          if (i >= V) break;
          float* gp = Gs.p + Gs.off(i / (P / 4), (i % (P / 4)) * 4);
          const float4 gv = *reinterpret_cast<const float4*>(gp);
          dot += gv.x * hv[j].x + gv.y * hv[j].y + gv.z * hv[j].z + gv.w * hv[j].w;
          *reinterpret_cast<float4*>(gp) = hv[j];
        }
      }
      dot = column_sum(quad_sum(dot));
      if (lane == 0) ghp[warp] = dot;
    }
    __syncthreads();

    // -- with h_in: V = dY h_in^T; dC += exp(cum_l) V; C_l . V_l for dcum
    {
      float va[NN][4];
      zero_acc(va);
      warp_mma<NN, EX, false>(
          va, [&](int hi, int i, int kb) { return Y.at(ra + 8 * hi, kb + tq + 4 * i, s1); },
          [&](int i, int kb, int j) { return Gs.at(cn0 + 8 * j + gq, kb + tq + 4 * i, s1); }, 0, P);
      const float ia = expf(cm[ra]), ib = expf(cm[rb]);
      float ya = 0.f, yb = 0.f;
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const int n = cn0 + 8 * j + 2 * tq;
        ya += Cs.at(ra, n, s1) * va[j][0] + Cs.at(ra, n + 1, s1) * va[j][1];
        yb += Cs.at(rb, n, s1) * va[j][2] + Cs.at(rb, n + 1, s1) * va[j][3];
        dct[j][0] += ia * va[j][0], dct[j][1] += ia * va[j][1];
        dct[j][2] += ib * va[j][2], dct[j][3] += ib * va[j][3];
      }
      ya = quad_sum(ya), yb = quad_sum(yb);
      if (tq == 0) ypart[hc * L + ra] = ya, ypart[hc * L + rb] = yb;
    }
    __syncthreads();  // h_in is read no more: the next head's g arrives while the scores run
    if (more) async_state<N, P>(Gs, p.g + k.slot(p, h + 1) * N * P);

    // -- scores: Q^T[m][l] = x_m . dY_l; M^T = R^T o D, W^T = D dt_m Q^T, T' = R^T o W^T
    float qa[4][4];
    zero_acc(qa);
    if constexpr (EX) {
      warp_mma_bf16<4, P, STile<T, P>::LD, STile<T, P>::LD>(qa, X.p, r0, Y.p, cl0);
    } else {
      warp_mma<4, false, false>(
          qa, [&](int hi, int i, int kb) { return X.at(ra + 8 * hi, kb + tq + 4 * i, s1); },
          [&](int i, int kb, int j) { return Y.at(cl0 + 8 * j + gq, kb + tq + 4 * i, s1); }, 0, P);
    }
    {
      float rowa = 0.f, rowb = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l0 = cl0 + 8 * j + 2 * tq;
        float mv[4], col[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = e < 2 ? ra : rb, l = l0 + (e & 1);
          float mm = 0.f, ww = 0.f;
          if (l >= m) {
            const float d = expf(cm[l] - cm[m]);
            mm = rt[j][e] * d;
            ww = d * dm[m] * qa[j][e];
          }
          const float tt = rt[j][e] * ww;
          if (e < 2) rowa += tt; else rowb += tt;
          col[e & 1] += tt;
          mv[e] = mm;
          qa[j][e] = ww;
        }
        store_pair(Ms.p + Ms.off(ra, l0, s1), mv[0], mv[1]);
        store_pair(Ms.p + Ms.off(rb, l0, s1), mv[2], mv[3]);
        if constexpr (SS == 2) {
          store_pair(Ws.p + Ws.off(ra, l0, s1), qa[j][0], qa[j][1]);
          store_pair(Ws.p + Ws.off(rb, l0, s1), qa[j][2], qa[j][3]);
        }
        col[0] = column_sum(col[0]), col[1] = column_sum(col[1]);
        if (gq == 0) tcol[sl * L + l0] = col[0], tcol[sl * L + l0 + 1] = col[1];
      }
      rowa = quad_sum(rowa), rowb = quad_sum(rowb);
      if (tq == 0) trow[hc * L + ra] = rowa, trow[hc * L + rb] = rowb;
    }
    __syncthreads();

    // -- dx += M^T dY (l >= m); dx out; x . dx / dt
    warp_mma<NP, false, EX>(
        dxa, [&](int hi, int i, int kb) { return Ms.at(ra + 8 * hi, kb + tq + 4 * i, s1); },
        [&](int i, int kb, int j) { return Y.at(kb + tq + 4 * i, cp0 + 8 * j + gq, ln.s2[i]); },
        r0, L);
    {
      T* dxg = static_cast<T*>(p.dx);
      const float da0 = dm[ra], db0 = dm[rb];
      const int sa = k.s0 + ra, sb = k.s0 + rb;
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int q = cp0 + 8 * j + 2 * tq;
        pa += X.at(ra, q, s1) * dxa[j][0] + X.at(ra, q + 1, s1) * dxa[j][1];
        pb += X.at(rb, q, s1) * dxa[j][2] + X.at(rb, q + 1, s1) * dxa[j][3];
        if (sa < p.S) store_pair(dxg + (k.row(p, sa) * p.H + h) * P + q, da0 * dxa[j][0], da0 * dxa[j][1]);
        if (sb < p.S) store_pair(dxg + (k.row(p, sb) * p.H + h) * P + q, db0 * dxa[j][2], db0 * dxa[j][3]);
      }
      pa = quad_sum(pa), pb = quad_sum(pb);
      if (tq == 0) dpart[hc * L + ra] = pa, dpart[hc * L + rb] = pb;
    }
    if constexpr (SS == 1) {  // W^T takes M^T's place
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l0 = cl0 + 8 * j + 2 * tq;
        store_pair(Ws.p + Ws.off(ra, l0, s1), qa[j][0], qa[j][1]);
        store_pair(Ws.p + Ws.off(rb, l0, s1), qa[j][2], qa[j][3]);
      }
      __syncthreads();
    }

    // -- dB += W^T C (l >= m); dC += W B (m <= l)
    warp_mma<NN, false, EX>(
        dbt, [&](int hi, int i, int kb) { return Ws.at(ra + 8 * hi, kb + tq + 4 * i, s1); },
        [&](int i, int kb, int j) { return Cs.at(kb + tq + 4 * i, cn0 + 8 * j + gq, ln.s2[i]); },
        r0, L);
    warp_mma<NN, false, EX>(
        dct, [&](int hi, int i, int kb) { return Ws.at(kb + tq + 4 * i, ra + 8 * hi, ln.s2[i]); },
        [&](int i, int kb, int j) { return Bs.at(kb + tq + 4 * i, cn0 + 8 * j + gq, ln.s2[i]); },
        0, r0 + 16);
    __syncthreads();  // the partial sums are in; x, dY, M^T and W^T are read no more
    if constexpr (XS == 1)
      if (more) fetch_xy(0, h + 1);

    if (warp == 0) {  // dcum, its reverse cumsum, ddt and da's share of head h
      const int l0 = 2 * lane;
      float dcum[2], us = 0.f, dd[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int l = l0 + e;
        const float u = (upart[l] + upart[L + l]) * expf(cm[L - 1] - cm[l]) * dm[l];
        const float ts = (tcol[l] + tcol[L + l] + tcol[2 * L + l] + tcol[3 * L + l]) -
                         (trow[l] + trow[L + l]);
        dcum[e] = ts + expf(cm[l]) * (ypart[l] + ypart[L + l]) - u;
        dd[e] = dpart[l] + dpart[L + l];
        us += u;
      }
      float hs = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) hs += ghp[w];
#pragma unroll
      for (int off = 16; off; off >>= 1) us += __shfl_xor_sync(FULL, us, off);
      // the state's terms land on the chunk's last row
      if (lane == 31) dcum[1] += us + expf(cm[L - 1]) * hs;
      // rc = the reverse inclusive cumsum of dcum
      float inc = dcum[0] + dcum[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float dn = __shfl_down_sync(FULL, inc, off);
        if (lane + off < 32) inc += dn;
      }
      float excl = __shfl_down_sync(FULL, inc, 1);
      if (lane == 31) excl = 0.f;
      const float rc1 = excl + dcum[1], rc0 = rc1 + dcum[0];
      const float a = p.a[h];
      if (k.s0 + l0 < p.S) p.ddt[k.row(p, k.s0 + l0) * p.H + h] = dd[0] + a * rc0;
      if (k.s0 + l0 + 1 < p.S) p.ddt[k.row(p, k.s0 + l0 + 1) * p.H + h] = dd[1] + a * rc1;
      float da = dm[l0] * rc0 + dm[l0 + 1] * rc1;
#pragma unroll
      for (int off = 16; off; off >>= 1) da += __shfl_xor_sync(FULL, da, off);
      if (lane == 0) p.da_part[k.slot(p, h)] = da;
      // the next head's cumsum: the other buffer's last readers passed the barrier above
      if (more) chunk_cumsum(next, cum + ((kq + 1) & 1) * L, dtl + ((kq + 1) & 1) * L);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // the head-block's dB and dC
  const int hbs = p.H / p.kh;
#pragma unroll
  for (int j = 0; j < NN; ++j) {
    const int n = cn0 + 8 * j + 2 * tq;
    const int sa = k.s0 + ra, sb = k.s0 + rb;
    if (sa < p.S) {
      const long long o = (k.row(p, sa) * hbs + k.hb) * N + n;
      store_pair(p.db_part + o, dbt[j][0], dbt[j][1]);
      store_pair(p.dc_part + o, dct[j][0], dct[j][1]);
    }
    if (sb < p.S) {
      const long long o = (k.row(p, sb) * hbs + k.hb) * N + n;
      store_pair(p.db_part + o, dbt[j][2], dbt[j][3]);
      store_pair(p.dc_part + o, dct[j][2], dct[j][3]);
    }
  }
}

// ---- 4: dB and dC of each group, its head-blocks added in order ---------------------------------
constexpr int NT_SUM = 256;

template <typename T, int N>
__global__ void __launch_bounds__(NT_SUM) ssd_bwd_group_sum(const Params p) {
  const long long i = static_cast<long long>(blockIdx.x) * NT_SUM + threadIdx.x;  // a float4 of (B, S, G, N)
  if (i >= static_cast<long long>(p.B) * p.S * p.G * (N / 4)) return;
  const int n = static_cast<int>(i % (N / 4)) * 4, g = static_cast<int>(i / (N / 4) % p.G);
  const long long bs = i / (N / 4) / p.G;  // b * S + s
  const int hbs = p.H / p.kh, rep = hbs / p.G;  // head-blocks per row and per group
  float db[4] = {0.f, 0.f, 0.f, 0.f}, dc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < rep; ++j) {
    const long long off = (bs * hbs + g * rep + j) * N + n;
    float v[4];
    load16(p.db_part + off, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) db[e] += v[e];
    load16(p.dc_part + off, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) dc[e] += v[e];
  }
  const long long o = (bs * p.G + g) * N + n;
  store4(static_cast<T*>(p.db) + o, db);
  store4(static_cast<T*>(p.dc) + o, dc);
}

// ---- 5: da per head, over batch rows and chunks in a fixed order ------------------------------
__global__ void __launch_bounds__(32) ssd_bwd_da(const Params p) {
  const int h = blockIdx.x, lane = threadIdx.x;
  float s = 0.f;
  for (int i = lane; i < p.B * p.nc; i += 32)
    s += p.da_part[(static_cast<long long>(i / p.nc) * p.H + h) * p.nc + i % p.nc];
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) p.da[h] = s;
}

// ---- head dims below 16: the packed tiles (ssd_scan.cuh) -----------------------------------------
// 1: Z_c of a tile's K heads as one product C^T (dY o exp(cum)), as the forward's phase 1
template <typename T, int N, int Q>
__global__ void __launch_bounds__(nt_state(N, 16), 2) ssd_bwd_chunk_grad_narrow(const NarrowStateArgs a) {
  narrow_chunk_state<T, N, Q, true>(a);
}

// 3: dx, ddt and da's share per head, and W summed over the block's heads
template <int N, int Q>
struct DxNarrowSmem {
  // rows padded so a warp's accesses spread over the banks: C and B
  // transposed (72: the mma fragments' k rows), R (76: both of the score
  // loop's patterns), g and h_in (24), x, dY, B g and C h_in (20), per head (65)
  static constexpr int K = Packed<Q>::K, LT = L + 8, LR = 76, GS = 24, XR = 20, LC = L + 1;
  // C and B transposed, the raw scores, W's sum; a tile's g, h_in, x, dY,
  // B g and C h_in; per head cum, dt, dcum, x . dx / dt and u
  static constexpr int FLOATS = 2 * N * LT + L * LR + L * L + 2 * N * GS + 4 * L * XR + 5 * K * LC;
  static constexpr int BYTES = FLOATS * static_cast<int>(sizeof(float));
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

template <typename T, int N, int Q>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_dx_narrow(const Params p) {
  using SM = DxNarrowSmem<N, Q>;
  constexpr int K = SM::K, LT = SM::LT, LR = SM::LR, GS = SM::GS, XR = SM::XR, LC = SM::LC;
  constexpr int NW = NT / 32, VT = 16 / sizeof(T);
  constexpr int QC = Packed<Q>::QC, HPT = Packed<Q>::HPT;
  constexpr bool EX = sizeof(T) == 2;  // bf16 B and C: exact in TF32
  extern __shared__ float4 smem4[];
  float* Ct = reinterpret_cast<float*>(smem4);  // N x LT: C transposed
  float* Bt = Ct + N * LT;                      // N x LT: B transposed
  float* R = Bt + N * LT;                       // L x LR: R[l][m] = C_l . B_m at l LR + m, m <= l
  float* Ws = R + L * LR;                       // L x L: W[l][m] summed over the block's heads
  float* gs = Ws + L * L;                       // N x GS: the tile's g
  float* hs = gs + N * GS;                      // N x GS: the tile's h_in
  float* xs = hs + N * GS;                      // L x XR: the tile's x
  float* ys = xs + L * XR;                      // L x XR: the tile's dY
  float* bgs = ys + L * XR;                     // L x XR: B g
  float* chs = bgs + L * XR;                    // L x XR: C h_in
  float* cum = chs + L * XR;                    // K x LC
  float* dtl = cum + K * LC;                    // K x LC
  float* dcs = dtl + K * LC;                    // K x LC: dcum
  float* xdx = dcs + K * LC;                    // K x LC: x . dx / dt
  float* us = xdx + K * LC;                     // K x LC: u
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const NarrowBlock blk(p.H, p.G, K, p.kh);

  const T* cg = at<T>(p.c, p.cs, blk.bi, blk.g);
  const T* bg = at<T>(p.b, p.bs, blk.bi, blk.g);
  // neighbouring lanes take neighbouring rows, so the transposed stores hit distinct banks
  for (int i = tid; i < L * N / VT; i += NT) {
    const int l = i % L, n = (i / L) * VT, s = blk.s0 + l;
    float cv[VT] = {}, bv[VT] = {};
    if (s < p.S) load16(cg + s * p.cs[1] + n, cv), load16(bg + s * p.bs[1] + n, bv);
#pragma unroll
    for (int k = 0; k < VT; ++k) Ct[(n + k) * LT + l] = cv[k], Bt[(n + k) * LT + l] = bv[k];
  }
  __syncthreads();
  // R once for the block's tiles, on the tensor cores
  raw_scores<N, EX>(Ct, Bt, LT, [&](int l, int m, float v0, float v1) {
    store_pair(R + l * LR + m, v0, v1);
  });

  // A thread's row m of the chunk.  In the products and for dx, columns c0 ..
  // c0 + 3 of a tile (HPT heads from kb on, QC columns each; at Q = 8 the two
  // lanes of a column pair share a head); in the scores, every head of the
  // tile and rows l = 4 i + lq (lq = lane % 4) of the chunk, so W[l][m] of the
  // block's heads sums in the thread's own places of Ws and the four lanes
  // of a row add their shares of dx and T once a tile.
  using Tl = Tile<L, 16, NT>;
  static_assert(Tl::CT == 4 && Tl::WC == 4, "lane % 4 is the column group");
  const Tl t(tid);
  const int m = t.row(0), c0 = t.col0(), kb = c0 / Q, lq = lane & 3, sm = blk.s0 + m;
  for (int i = tid; i < L * L; i += NT) Ws[i] = 0.f;
  for (int tt = 0; tt < p.kh; ++tt) {
    const int tile = blk.t0 + tt, h0 = blk.head0(tile, K), nh = blk.heads(tile, K);
    const long long slab = ((static_cast<long long>(blk.bi) * p.H + h0) * p.nc + blk.ch) * N * Q;
    const long long hstride = static_cast<long long>(p.nc) * N * Q;
    __syncthreads();  // R is in; the last tile is done with every tile buffer
    async_packed_state<N, Q, NT>(gs, p.g + slab, hstride, nh, GS);
    async_packed_state<N, Q, NT>(hs, p.h_in + slab, hstride, nh, GS);
    narrow_cumsums<K, NW>(p.dt, p.dts, p.a, blk.bi, blk.s0, p.S, h0, nh, cum, dtl, LC);
    {
      const T* xg = at<T>(p.x, p.xs, blk.bi, h0);
      const T* yg = at<T>(p.dy, p.dys, blk.bi, h0);
      for (int i = tid; i < L * 4; i += NT) {  // row i / 4, columns 4 (i % 4) .. + 3
        const int l = i >> 2, cx = (i & 3) * 4, s = blk.s0 + l;
        float xv[4] = {0.f, 0.f, 0.f, 0.f}, yv[4] = {0.f, 0.f, 0.f, 0.f};
        if (s < p.S) {
          load_packed4<Q>(xg + s * p.xs[1], p.xs[2], cx, nh, xv);
          load_packed4<Q>(yg + s * p.dys[1], p.dys[2], cx, nh, yv);
        }
        *reinterpret_cast<float4*>(xs + l * XR + cx) = make_float4(xv[0], xv[1], xv[2], xv[3]);
        *reinterpret_cast<float4*>(ys + l * XR + cx) = make_float4(yv[0], yv[1], yv[2], yv[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    {  // B g (dx's state term, u) and C h_in (dY . C h_in), one product each for
       // the tile's heads, on the tensor cores: warps 0-3 the first, 4-7 the
       // second, 16 rows and the tile's 16 columns a warp
      float* out = warp < 4 ? bgs : chs;
      warp_block<2, N, EX, false>(warp < 4 ? Bt : Ct, LT, warp < 4 ? gs : hs, GS, 16 * (warp & 3), 0,
                                  [&](int r, int c, float v0, float v1) { store_pair(out + r * XR + c, v0, v1); });
    }
    __syncthreads();
    float bgv[1][4], chv[1][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bgv[0][j] = bgs[m * XR + c0 + j], chv[0][j] = chs[m * XR + c0 + j];
    float xm[16], ym[16];  // row m of the tile's x and dY
#pragma unroll
    for (int j = 0; j < 16; j += 4) {
      const float4 xa = *reinterpret_cast<const float4*>(xs + m * XR + j);
      const float4 ya = *reinterpret_cast<const float4*>(ys + m * XR + j);
      xm[j] = xa.x, xm[j + 1] = xa.y, xm[j + 2] = xa.z, xm[j + 3] = xa.w;
      ym[j] = ya.x, ym[j + 1] = ya.y, ym[j + 2] = ya.z, ym[j + 3] = ya.w;
    }
    float x4[4], y4[4];  // row m's x and dY in this lane's columns
#pragma unroll
    for (int j = 0; j < 4; ++j) x4[j] = xs[m * XR + c0 + j], y4[j] = ys[m * XR + c0 + j];
    float eend[HPT], uu[HPT], yo[HPT];
#pragma unroll
    for (int hh = 0; hh < HPT; ++hh) {  // the heads of this lane's 4 columns
      const int k = kb + hh;
      const float cmk = cum[k * LC + m];
      eend[hh] = expf(cum[k * LC + L - 1] - cmk);
      float su = 0.f, sy = 0.f;
#pragma unroll
      for (int jj = 0; jj < QC; ++jj) {
        const int j = hh * QC + jj;
        su = fmaf(x4[j], bgv[0][j], su);
        sy = fmaf(y4[j], chv[0][j], sy);
      }
      if constexpr (Q == 8) su += __shfl_xor_sync(FULL, su, 1), sy += __shfl_xor_sync(FULL, sy, 1);
      uu[hh] = su * eend[hh] * dtl[k * LC + m];
      yo[hh] = sy * expf(cmk);
    }

    // the scores, per head at width Q: pair (l, m), l >= m, gives M^T dY
    // into dx, T's column sum and W; pair (m, l), l <= m, T's row sum; each
    // one exp of a non-positive difference, by the SFU's ex2 (__expf: a few
    // ulp more error than expf on values that only feed sums held at 1e-4,
    // for a quarter of the loop's instructions)
    float cm[K], dtm[K], colT[K], rowT[K], dxp[16];
#pragma unroll
    for (int k = 0; k < K; ++k) cm[k] = cum[k * LC + m], dtm[k] = dtl[k * LC + m], colT[k] = rowT[k] = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) dxp[j] = 0.f;
#pragma unroll 2
    for (int i = 0; i < L / 4; ++i) {
      const int l = 4 * i + lq;
      if (l >= m) {
        const float r = R[l * LR + m];
        float yl[16];
#pragma unroll
        for (int j = 0; j < 16; j += 4) {
          const float4 ya = *reinterpret_cast<const float4*>(ys + l * XR + j);
          yl[j] = ya.x, yl[j + 1] = ya.y, yl[j + 2] = ya.z, yl[j + 3] = ya.w;
        }
        float w = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float e = __expf(cum[k * LC + l] - cm[k]);
          float qc = 0.f;  // dY_l . x_m
#pragma unroll
          for (int q = 0; q < Q; ++q) qc = fmaf(yl[k * Q + q], xm[k * Q + q], qc);
          const float mm = r * e, wc = e * dtm[k] * qc;
#pragma unroll
          for (int q = 0; q < Q; ++q) dxp[k * Q + q] = fmaf(mm, yl[k * Q + q], dxp[k * Q + q]);
          colT[k] = fmaf(r, wc, colT[k]);
          w += wc;
        }
        Ws[l * L + m] += w;
      }
      if (l <= m) {
        const float r = R[m * LR + l];
        float xl[16];
#pragma unroll
        for (int j = 0; j < 16; j += 4) {
          const float4 xa = *reinterpret_cast<const float4*>(xs + l * XR + j);
          xl[j] = xa.x, xl[j + 1] = xa.y, xl[j + 2] = xa.z, xl[j + 3] = xa.w;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float cl = cum[k * LC + l];
          float qr = 0.f;  // dY_m . x_l
#pragma unroll
          for (int q = 0; q < Q; ++q) qr = fmaf(ym[k * Q + q], xl[k * Q + q], qr);
          rowT[k] = fmaf(r, __expf(cm[k] - cl) * dtl[k * LC + l] * qr, rowT[k]);
        }
      }
    }
    // the four lanes of row m add their shares, in a fixed order
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      dxp[j] += __shfl_xor_sync(FULL, dxp[j], 1);
      dxp[j] += __shfl_xor_sync(FULL, dxp[j], 2);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      colT[k] += __shfl_xor_sync(FULL, colT[k], 1);
      colT[k] += __shfl_xor_sync(FULL, colT[k], 2);
      rowT[k] += __shfl_xor_sync(FULL, rowT[k], 1);
      rowT[k] += __shfl_xor_sync(FULL, rowT[k], 2);
      if (k * Q / 4 == lq) dcs[k * LC + m] = rowT[k] - colT[k];  // the head's first lane
    }

    {  // dx out for this lane's columns; x . dx / dt and the rest of dcum per head
      float dxm[4], out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dxm[j] = 0.f;
#pragma unroll
        for (int g4 = 0; g4 < 4; ++g4)
          if (g4 == lq) dxm[j] = dxp[4 * g4 + j];
      }
#pragma unroll
      for (int hh = 0; hh < HPT; ++hh) {
        const int k = kb + hh;
        const float dtk = dtl[k * LC + m];
        float sx = 0.f;
#pragma unroll
        for (int jj = 0; jj < QC; ++jj) {
          const int j = hh * QC + jj;
          const float dxj = fmaf(eend[hh], bgv[0][j], dxm[j]);
          sx = fmaf(x4[j], dxj, sx);
          out[j] = dtk * dxj;
        }
        if constexpr (Q == 8) sx += __shfl_xor_sync(FULL, sx, 1);
        if (Q < 8 || (lane & 1) == 0) {  // the head's first lane
          dcs[k * LC + m] += yo[hh] - uu[hh];
          xdx[k * LC + m] = sx;
          us[k * LC + m] = uu[hh];
        }
      }
      if (sm < p.S)
        store_packed4<Q>(static_cast<T*>(p.dx) + (blk.row(sm, p.S) * p.H + h0) * Q, Q, c0, nh, out);
    }
    __syncthreads();

    // per head, a warp: the state's terms on the chunk's last row, rc = the
    // reverse cumsum of dcum, ddt and da's share
    for (int k = warp; k < nh; k += NW) {
      const int h = h0 + k, l0 = 2 * lane;
      float gh = 0.f;  // <g, h_in>
      for (int i = lane; i < N * Q; i += 32) {
        const int off = (i / Q) * GS + k * Q + i % Q;
        gh = fmaf(gs[off], hs[off], gh);
      }
      float su = us[k * LC + l0] + us[k * LC + l0 + 1];
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        gh += __shfl_xor_sync(FULL, gh, off);
        su += __shfl_xor_sync(FULL, su, off);
      }
      const float d0 = dcs[k * LC + l0];
      const float d1 = dcs[k * LC + l0 + 1] + (lane == 31 ? su + expf(cum[k * LC + L - 1]) * gh : 0.f);
      float inc = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float dn = __shfl_down_sync(FULL, inc, off);
        if (lane + off < 32) inc += dn;
      }
      float excl = __shfl_down_sync(FULL, inc, 1);
      if (lane == 31) excl = 0.f;
      const float rc1 = excl + d1, rc0 = rc1 + d0;
      const float a = p.a[h];
      const int s = blk.s0 + l0;
      if (s < p.S) p.ddt[blk.row(s, p.S) * p.H + h] = xdx[k * LC + l0] + a * rc0;
      if (s + 1 < p.S) p.ddt[blk.row(s + 1, p.S) * p.H + h] = xdx[k * LC + l0 + 1] + a * rc1;
      float da = dtl[k * LC + l0] * rc0 + dtl[k * LC + l0 + 1] * rc1;
#pragma unroll
      for (int off = 16; off; off >>= 1) da += __shfl_xor_sync(FULL, da, off);
      if (lane == 0) p.da_part[(static_cast<long long>(blk.bi) * p.H + h) * p.nc + blk.ch] = da;
    }
  }
  // the block's W, for ssd_bwd_dbc_narrow
  __syncthreads();
  const int tb_n = (blk.hg + K - 1) / K / p.kh;
  float4* wp = reinterpret_cast<float4*>(
      p.w_part + (((static_cast<long long>(blk.bi) * p.nc + blk.ch) * p.G + blk.g) * tb_n + blk.tb) * L * L);
  for (int i = tid; i < L * L / 4; i += NT) wp[i] = reinterpret_cast<const float4*>(Ws)[i];
}

// 4 at Q < 16: dB and dC of a group per (chunk, batch, group), summed over its heads,
//   dC = W B + sum_h (dY_h o exp(cum_h)) h_in_h^T,
//   dB = W^T C + sum_h (x_h dt_h exp(cum_{L-1} - cum_h)) g_h^T,
// W the group's head-blocks' partials added in order; the per-head terms one
// product of depth 16 per packed tile.  3xTF32 on the tensor cores (two
// passes where B or C is bf16, exact in TF32); warp w takes rows 16 (w % 4)
// and half w / 4 of N.  No head-block partials: no group sum.
template <int N, int Q>
struct DbcNarrowSmem {
  static constexpr int K = Packed<Q>::K, LA = L + 8, NB = N + 8;  // rows padded: no bank conflicts
  // B and C rows; then W (L x LA), or a tile's (dY e_in)^T, (x dt e_end)^T
  // (16 x LA each), h_in^T and g^T (16 x NB each) in its place; cum and dt per head
  static constexpr int TILE = 2 * 16 * LA + 2 * 16 * NB;
  static constexpr int FLOATS = 2 * L * NB + (TILE > L * LA ? TILE : L * LA) + 2 * K * L;
  static constexpr int BYTES = FLOATS * static_cast<int>(sizeof(float));
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

template <typename T, int N, int Q>
__global__ void __launch_bounds__(NT, 2) ssd_bwd_dbc_narrow(const Params p) {
  using SM = DbcNarrowSmem<N, Q>;
  constexpr int K = SM::K, LA = SM::LA, NB = SM::NB, NW = NT / 32, VT = 16 / sizeof(T);
  constexpr int NJ = N / 16;           // n-tiles of a warp's half of N
  constexpr bool EX = sizeof(T) == 2;  // bf16 B and C: exact in TF32
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);  // L x NB: B
  float* Cs = Bs + L * NB;                      // L x NB: C
  float* Ws = Cs + L * NB;                      // L x LA: W[l][m]
  float* Ay = Ws;                               // 16 x LA: a tile's (dY e_in)^T, [c][l]
  float* Ax = Ay + 16 * LA;                     // 16 x LA: (x dt e_end)^T, [c][m]
  float* Gh = Ax + 16 * LA;                     // 16 x NB: h_in^T, [c][n]
  float* Gg = Gh + 16 * NB;                     // 16 x NB: g^T
  float* cum = Ws + (SM::TILE > L * LA ? SM::TILE : L * LA);  // K x L
  float* dtl = cum + K * L;                                   // K x L
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * (warp & 3), n0 = (warp >> 2) * (N / 2);
  const int ch = blockIdx.x, s0 = ch * L, bi = blockIdx.y / p.G, g = blockIdx.y % p.G;
  const int hg = p.H / p.G, tiles = (hg + K - 1) / K, tb_n = tiles / p.kh;
  const T* bg = at<T>(p.b, p.bs, bi, g);
  const T* cg = at<T>(p.c, p.cs, bi, g);
  for (int i = tid; i < L * N / VT; i += NT) {
    const int l = i / (N / VT), n = (i % (N / VT)) * VT, s = s0 + l;
    float bv[VT] = {}, cv[VT] = {};
    if (s < p.S) load16(bg + s * p.bs[1] + n, bv), load16(cg + s * p.cs[1] + n, cv);
#pragma unroll
    for (int k = 0; k < VT; ++k) Bs[l * NB + n + k] = bv[k], Cs[l * NB + n + k] = cv[k];
  }
  {  // W of the group: its head-blocks' partials added in order, 4 floats at a time
    const float4* wp = reinterpret_cast<const float4*>(
        p.w_part + ((static_cast<long long>(bi) * p.nc + ch) * p.G + g) * tb_n * L * L);
    for (int i = tid; i < L * L / 4; i += NT) {
      float4 v = wp[i];
      for (int b = 1; b < tb_n; ++b) {
        const float4 u = wp[static_cast<long long>(b) * L * L / 4 + i];
        v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
      }
      *reinterpret_cast<float4*>(Ws + (i / (L / 4)) * LA + (i % (L / 4)) * 4) = v;
    }
  }
  __syncthreads();
  float db[NJ][4], dc[NJ][4];
  zero_acc(db);
  zero_acc(dc);
  // dB[m][n] = sum_l W[l][m] C[l][n], dC[l][n] = sum_m W[l][m] B[m][n]
  warp_mma<NJ, false, EX>(
      db, [&](int hi, int e, int kb) { return Ws[(kb + tq + 4 * e) * LA + r0 + gq + 8 * hi]; },
      [&](int e, int kb, int j) { return Cs[(kb + tq + 4 * e) * NB + n0 + 8 * j + gq]; }, 0, L);
  warp_mma<NJ, false, EX>(
      dc, [&](int hi, int e, int kb) { return Ws[(r0 + gq + 8 * hi) * LA + kb + tq + 4 * e]; },
      [&](int e, int kb, int j) { return Bs[(kb + tq + 4 * e) * NB + n0 + 8 * j + gq]; }, 0, L);
  for (int tile = 0; tile < tiles; ++tile) {
    const int h0 = g * hg + tile * K, nh = min(K, hg - tile * K);
    const long long slab = ((static_cast<long long>(bi) * p.H + h0) * p.nc + ch) * N * Q;
    const long long hstride = static_cast<long long>(p.nc) * N * Q;
    __syncthreads();  // the last products are done with W's place, cum and dtl
    async_packed_state<N, Q, NT, true>(Gh, p.h_in + slab, hstride, nh, NB);
    async_packed_state<N, Q, NT, true>(Gg, p.g + slab, hstride, nh, NB);
    narrow_cumsums<K, NW>(p.dt, p.dts, p.a, bi, s0, p.S, h0, nh, cum, dtl, L);
    __syncthreads();
    const T* xg = at<T>(p.x, p.xs, bi, h0);
    const T* yg = at<T>(p.dy, p.dys, bi, h0);
    for (int i = tid; i < L * 4; i += NT) {  // row i / 4, columns 4 (i % 4) .. + 3
      const int l = i >> 2, cx = (i & 3) * 4, s = s0 + l;
      float xv[4] = {0.f, 0.f, 0.f, 0.f}, yv[4] = {0.f, 0.f, 0.f, 0.f};
      if (s < p.S) {
        load_packed4<Q>(xg + s * p.xs[1], p.xs[2], cx, nh, xv);
        load_packed4<Q>(yg + s * p.dys[1], p.dys[2], cx, nh, yv);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cx + j, k = c / Q;
        const float cl = cum[k * L + l];
        Ay[c * LA + l] = yv[j] * expf(cl);
        Ax[c * LA + l] = xv[j] * dtl[k * L + l] * expf(cum[k * L + L - 1] - cl);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    warp_mma<NJ, false, false>(
        dc, [&](int hi, int e, int kb) { return Ay[(kb + tq + 4 * e) * LA + r0 + gq + 8 * hi]; },
        [&](int e, int kb, int j) { return Gh[(kb + tq + 4 * e) * NB + n0 + 8 * j + gq]; }, 0, 16);
    warp_mma<NJ, false, false>(
        db, [&](int hi, int e, int kb) { return Ax[(kb + tq + 4 * e) * LA + r0 + gq + 8 * hi]; },
        [&](int e, int kb, int j) { return Gg[(kb + tq + 4 * e) * NB + n0 + 8 * j + gq]; }, 0, 16);
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int s = s0 + r0 + gq + 8 * hi;
    if (s >= p.S) continue;
    const long long o = ((static_cast<long long>(bi) * p.S + s) * p.G + g) * N + n0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      store_pair(static_cast<T*>(p.db) + o + 8 * j + 2 * tq, db[j][2 * hi], db[j][2 * hi + 1]);
      store_pair(static_cast<T*>(p.dc) + o + 8 * j + 2 * tq, dc[j][2 * hi], dc[j][2 * hi + 1]);
    }
  }
}

// ---- launches --------------------------------------------------------------------------------
template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, const Args& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int N, int P>
cudaError_t run(const Params& p, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (P < 16) {  // packed tiles, kh = tiles per block
    const int tb_n = (p.H / p.G + Packed<P>::K - 1) / Packed<P>::K / p.kh;
    const dim3 blocks(p.nc, p.B * p.G * tb_n);
    const NarrowStateArgs a{p.c, p.dy, p.dt, p.a, p.g, nullptr, p.S, p.H, p.G, p.nc, p.kh,
                            {p.cs[0], p.cs[1], p.cs[2]}, {p.dys[0], p.dys[1], p.dys[2]},
                            {p.dts[0], p.dts[1], p.dts[2]}};
    err = launch(ssd_bwd_chunk_grad_narrow<T, N, P>, blocks, nt_state(N, 16),
                 NarrowStateSmem<N, P>::BYTES, a, stream);
    if (err == cudaSuccess)
      err = launch(ssd_bwd_state_pass<N, P>, dim3((N * P / 4 + NT_PASS - 1) / NT_PASS, p.B * p.H),
                   NT_PASS, 0, p, stream);
    if (err == cudaSuccess)
      err = launch(ssd_bwd_dx_narrow<T, N, P>, blocks, NT, DxNarrowSmem<N, P>::BYTES, p, stream);
    if (err == cudaSuccess)
      err = launch(ssd_bwd_dbc_narrow<T, N, P>, dim3(p.nc, p.B * p.G), NT,
                   DbcNarrowSmem<N, P>::BYTES, p, stream);
  } else {
    const dim3 blocks(p.nc, p.B * p.H / p.kh);
    err = launch(ssd_bwd_chunk_grad<T, N, P>, blocks, NT, GradSmem<T, N, P>::BYTES, p, stream);
    if (err == cudaSuccess)
      err = launch(ssd_bwd_state_pass<N, P>, dim3((N * P / 4 + NT_PASS - 1) / NT_PASS, p.B * p.H),
                   NT_PASS, 0, p, stream);
    if (err == cudaSuccess)
      err = launch(ssd_bwd_dxbc<T, N, P>, blocks, NT, DxbcSmem<T, N, P>::BYTES, p, stream);
    if (err == cudaSuccess) {
      const long long sums = static_cast<long long>(p.B) * p.S * p.G * (N / 4);
      err = launch(ssd_bwd_group_sum<T, N>, dim3(static_cast<unsigned>((sums + NT_SUM - 1) / NT_SUM)),
                   NT_SUM, 0, p, stream);
    }
  }
  if (err == cudaSuccess) err = launch(ssd_bwd_da, dim3(p.H), 32, 0, p, stream);
  return err;
}

template <typename T, int N>
cudaError_t dispatch_p(const Params& p, int P, cudaStream_t stream) {
  switch (P) {
    case 1: return run<T, N, 1>(p, stream);
    case 2: return run<T, N, 2>(p, stream);
    case 4: return run<T, N, 4>(p, stream);
    case 8: return run<T, N, 8>(p, stream);
    case 16: return run<T, N, 16>(p, stream);
    case 32: return run<T, N, 32>(p, stream);
    case 64: return run<T, N, 64>(p, stream);
    case 128: return run<T, N, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_n(const Params& p, int P, int N, cudaStream_t stream) {
  switch (N) {
    case 16: return dispatch_p<T, 16>(p, P, stream);
    case 32: return dispatch_p<T, 32>(p, P, stream);
    case 64: return dispatch_p<T, 64>(p, P, stream);
    case 128: return dispatch_p<T, 128>(p, P, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The floats of one call's own scratch: per (batch, head) and chunk an (N, P)
// state gradient and a share of da, B*H*nc*(N*P + 1), and dB and dC of each
// head-block (kh = heads_per_block(H/G, B*H*nc)), 2*B*S*(H/kh)*N; at P < 16
// W over each head-block's heads instead (the group's tiles of K = 16 / P
// heads, kt = tiles_per_block(tiles, B*G*tiles*nc) of them a block),
// B*nc*G*(tiles/kt)*L*L.  0 for sizes the entry refuses.
extern "C" long long ssd_scan_bwd_scratch_floats(int B, int S, int H, int G, int P, int N) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || N <= 0) return 0;
  const long long nc = (S + L - 1) / L;
  const long long states = B * H * nc * (static_cast<long long>(N) * P + 1);
  if (P < 16) {
    const int tiles = (H / G + 16 / P - 1) / (16 / P);
    return states + B * nc * G * (tiles / tiles_per_block(tiles, B * G * tiles * nc)) * L * L;
  }
  const int kh = heads_per_block(H / G, B * H * nc);
  return states + 2LL * B * S * (H / kh) * N;
}

// ptrs[14]: x, dt, a, b, c, dy, dstate (0: zero), the forward's scratch (the
// states entering each chunk, B*H*nc*N*P floats, then each chunk's decay,
// B*H*nc), this call's scratch (work_floats floats, at least
// ssd_scan_bwd_scratch_floats), dx, ddt, da, db, dc.  x (B,S,H,P), dt
// (B,S,H) f32, a (H,) f32, b/c (B,S,G,N), dy (B,S,H,P) read through
// strides[15] = (batch, seq, head|group) element strides of x, dt, b, c, dy,
// with the last dim contiguous and rows 16-byte aligned (x and dy at P >= 16
// only); dstate (B,H,P,N) f32, dx (B,S,H,P), ddt (B,S,H) f32, db/dc
// (B,S,G,N) contiguous.  dtype (of x, b, c, dy, dx, db, dc): 0 = float32, 1 =
// bfloat16.  P in {1, 2, 4, 8, 16, 32, 64, 128}, N in {16, 32, 64, 128}.  Returns cudaErrorInvalidValue for a scratch too short, else the
// first launch's cudaGetLastError() that is not 0, else 0.
extern "C" int ssd_scan_bwd(const long long* ptrs, const long long* strides,
                            long long work_floats, int dtype, int B, int S, int H, int G, int P,
                            int N, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || B * H > 65535 ||
      work_floats < ssd_scan_bwd_scratch_floats(B, S, H, G, P, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (S + L - 1) / L;
  const bool narrow = P < 16;
  const int tiles = narrow ? (H / G + 16 / P - 1) / (16 / P) : 0;
  const int kh = narrow ? tiles_per_block(tiles, static_cast<long long>(B) * G * tiles * nc)
                        : heads_per_block(H / G, static_cast<long long>(B) * H * nc);
  const long long states = static_cast<long long>(B) * H * nc * N * P;
  const long long per_block = narrow ? 0 : static_cast<long long>(B) * S * (H / kh) * N;
  const long long w_floats = narrow ? static_cast<long long>(B) * nc * G * (tiles / kh) * L * L : 0;
  const auto ptr = [&](int i) { return reinterpret_cast<void*>(ptrs[i]); };
  float* fwd = static_cast<float*>(ptr(7));
  float* bwd = static_cast<float*>(ptr(8));
  float* parts = bwd + states;  // dB and dC per head-block, or W per head-block
  Params p{ptr(0), static_cast<const float*>(ptr(1)), static_cast<const float*>(ptr(2)), ptr(3),
           ptr(4), ptr(5), static_cast<const float*>(ptr(6)), fwd, fwd + states, bwd,
           parts, parts + per_block, parts + 2 * per_block, parts + 2 * per_block + w_floats,
           ptr(9), static_cast<float*>(ptr(10)), static_cast<float*>(ptr(11)), ptr(12), ptr(13),
           B, S, H, G, nc, kh, {}, {}, {}, {}, {}};
  for (int i = 0; i < 3; ++i) {
    p.xs[i] = strides[i];
    p.dts[i] = strides[3 + i];
    p.bs[i] = strides[6 + i];
    p.cs[i] = strides[9 + i];
    p.dys[i] = strides[12 + i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? dispatch_n<float>(p, P, N, st)
                    : dtype == 1 ? dispatch_n<__nv_bfloat16>(p, P, N, st)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
