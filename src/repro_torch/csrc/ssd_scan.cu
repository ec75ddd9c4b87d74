// Mamba2 SSD scan for Hopper (sm_90a), chunk-parallel, with a plain C interface.
//
// Replaces the JAX package's Pallas TPU kernel `kernels/ssd_scan.py`
// (`ssd_scan`, body `_ssd_kernel`).  Per (batch, head), over chunks of
// L = 64 tokens with cum = inclusive cumsum of dt * a inside the chunk:
//   y   = ((C B^T) o decay) (x * dt) + exp(cum) o (C h_in),
//         decay[l, m] = exp(cum_l - cum_m) for l >= m, else 0
//   h   <- exp(cum_{L-1}) h + S_c,  S_c = B^T (x * dt * exp(cum_{L-1} - cum))
// with y in x's dtype and the final state as f32 (B, H, P, N).
//
// Design: the SSD decomposition of the Mamba2 paper, in three launches.  The
// Pallas kernel walks its chunk grid axis in order.  One Hopper block per
// head walking every chunk leaves the card latency-bound (192 blocks on 132
// SMs at mamba2-130m, every product of a chunk waiting behind the state
// chain), yet only the N x P state update carries from chunk to chunk.  So:
//   1. ssd_scan_chunk_state: each chunk's contribution S_c (N x P, f32) and
//      decay exp(cum_{L-1}) into a scratch buffer that the wrapper allocates,
//      (B*H, nc, N, P) + (B*H, nc) f32.  Bound by operations, 2*L*N*P flops
//      per chunk and head.
//   2. ssd_scan_state_pass, a thread per 4 state elements of a (batch, head):
//      walks the nc chunks, overwrites S_c with the state entering chunk c,
//      h <- e_c h + S_c, and writes the final state.  No products: bound by
//      bytes, the scratch read and written once; the next 8 chunks' loads are
//      issued before this 8's stores, with streaming cache hints.
//   3. ssd_scan_output_{f32,bf16}: y per chunk.  Bound by operations, per
//      chunk and head 2*L*N*P (C h_in) + L*L*P (the masked scores times x)
//      flops, plus the L*L*N of the scores, shared by a group's heads.
// Phases 1 and 3 take a block per (chunk, batch, kh heads of one group): B
// and C, and the raw scores C B^T, are the same for the heads of a group, so
// a block loads and computes them once and then walks its heads.  kh is the
// most, up to 8, that still leaves 512 blocks: at mamba2-130m's (4, 4096,
// 24, P 64, N 128) kh = 8 and each product kernel has 768 blocks in place of
// 192.  The scratch there is 201 MB: written by 1, read and written by 2,
// read by 3.
//
// What keeps the product kernels fed.  A head's dt and x are fetched into
// registers while the last head's products run, its h_in by cp.async while
// the last head's Gt^T x runs (phase 3), and phase 1's S_c leaves through the
// bulk copy engine (cp.async.bulk, smem -> global) while the next head's
// product runs.
//
// Products.  f32 stays on the CUDA cores (TF32 would miss the 1e-4
// tolerance): every product is a register tile of TR x 4 outputs per thread
// (1 x 4 to 16 x 4 by shape, 8 x 4 in phase 1 and 4 x 4 in phase 3 at
// mamba2-130m), fed by 16-byte shared-memory loads laid out so a warp's
// loads are conflict-free and broadcast (`Tile` below): the FMA rate, not
// the load rate, is the limit.  bf16 runs the three products that feed only
// y (C B^T, the masked scores times x, C h_in) on the tensor cores,
// `mma.sync.m16n8k16` bf16 with f32 accumulators, operands by `ldmatrix`; the
// masked scores stay in registers as the A operand of the next product.  The
// chunk-state product feeds the final state, held at 1e-4 in every dtype, so
// phase 1 keeps f32 operands on the CUDA cores for bf16 inputs too.
//
// Head dims Q below 16 (the head_dim split over a mesh axis: mamba2's 64 on 16
// ranks is 4) pack a group's heads into tiles of 16 columns, K = 16 / Q heads
// a tile (`Packed`, ssd_scan.cuh), and take a block per (chunk, batch, kt
// tiles of one group), kt by `tiles_per_block` (at mamba2-130m's (4, 4096,
// 24, 4) all 6 tiles of the group: 256 blocks, C B^T formed once per chunk
// and batch, not three times).  The chunk states are (N, Q) a head, so the
// scratch and the pass move Q / 16 of the bytes a tile of 16 would:
//   1. ssd_scan_chunk_state_narrow: S_c of the tile's K heads as one product
//      B^T (x o w) of the packed (L x 16) tile, each head's weights on its own
//      columns (`narrow_chunk_state`, ssd_scan.cuh, which the backward's
//      chunk_grad shares); stored per head.
//   2. ssd_scan_state_pass at P = Q.
//   3. ssd_scan_output_narrow: C B^T once for the block, and per tile C h_in
//      as one product over the packed h_in (N x 16); the masked scores stay
//      per head, each thread walking m <= l for its row l and 4 columns with
//      exp(cum_l - cum_m) of its columns' heads, times x dt at width Q.  No
//      exp of a positive difference (exp(cum_l) exp(-cum_m) would overflow
//      f32 past 88).
// The products (C B^T, B^T (x o w), C h_in) run on the tensor cores as
// mma.sync m16n8k8 in 3xTF32 (one pass where both operands are bf16, exact in
// TF32: `warp_block`), each warp a 16-row block, the operands' rows padded so
// the fragments' loads hit distinct banks; the per-head masked scores on the
// CUDA cores in f32, both dtypes.  x and y rows are read and written 16 bytes
// (8 in bf16) at a time where a packed row lies whole and aligned, else an
// element at a time (a column slice of a wider x).  Launches at Q >= 16 are
// the code they were.
//
// Kept from the serial design: L = 64; exp only of non-positive differences
// (l >= m, cum_{L-1} - cum, cum <= 0), score tiles wholly above the diagonal
// skipped; rows past S load as dt = 0, x = B = C = 0 and are never written;
// the model layout read through strides, x (B,S,H,P), dt (B,S,H), B/C
// (B,S,G,N), head h reading group h / (H/G); rows of x, B, C 16-byte aligned
// (the wrapper copies a view that is not).
//
// `nvcc -Xptxas -v` (CUDA 12.8, sm_90a) at N = 128, P = 64, no spills:
//   ssd_scan_chunk_state<float>   128 registers, 82,432 B shared, 256 threads: 2 blocks/SM
//   ssd_scan_chunk_state<bf16>    112 registers, 82,432 B shared, 256 threads: 2 blocks/SM
//   ssd_scan_state_pass           102 registers, no shared, 256 threads
//   ssd_scan_output_f32           115 registers, 115,712 B shared, 256 threads: 2 blocks/SM
//   ssd_scan_output_bf16          168 registers, 63,488 B shared, 128 threads: 3 blocks/SM
// and at N = 128, Q = 4 (f32 / bf16), no spills:
//   ssd_scan_chunk_state_narrow   56 / 61 registers, 256 threads
//   ssd_scan_output_narrow        80 / 80 registers, 91,152 B shared at K = 4 heads a tile
//                                  (a tile's buffers in B's place): 2 blocks/SM

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_scan.cuh"

namespace {

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  void* y;
  float* state;        // (B, H, P, N)
  float* chunk_state;  // (B*H, nc, N, P): S_c from phase 1, h entering chunk c after phase 2
  float* chunk_decay;  // (B*H, nc): exp(cum_{L-1}) of each chunk
  int S, H, G, nc;
  int kh;  // heads per product block, all of one group; at P < 16 tiles per block
  // element strides of (batch, sequence, head or group) for x, dt, b, c, y;
  // the last dim of x, b, c, y is contiguous
  long long xs[3], dts[3], bs[3], cs[3], ys[3];
};

// The (chunk, batch, group, kh heads of the group) a product block works on.
// B and C, and in phase 3 the raw scores C B^T, are shared by the heads of a
// group: the block loads and computes them once for its kh heads.
struct Block {
  int ch, s0, bi, g, h0;
  __device__ explicit Block(const Params& p) : ch(blockIdx.x), s0(blockIdx.x * L) {
    const int per_b = p.H / p.kh;  // blocks per batch row
    bi = blockIdx.y / per_b;
    h0 = (blockIdx.y % per_b) * p.kh;
    g = h0 / (p.H / p.G);
  }
  __device__ long long bh(const Params& p, int h) const {
    return static_cast<long long>(bi) * p.H + h;
  }
};

// Warp 0 only.  Lane k's rows 2k, 2k+1 of head h's dt (0 past S) and the
// head's a, fetched a head ahead so their latency hides behind a product.
__device__ __forceinline__ HeadDt fetch_dt(const Params& p, const Block& blk, int h) {
  const float* dtg = p.dt + blk.bi * p.dts[0] + h * p.dts[2];
  const int s = blk.s0 + 2 * threadIdx.x;
  return {s < p.S ? dtg[s * p.dts[1]] : 0.f, s + 1 < p.S ? dtg[(s + 1) * p.dts[1]] : 0.f, p.a[h]};
}

// ---- phase 1: S_c = B^T (x * dt * exp(cum_{L-1} - cum)), and exp(cum_{L-1}) --------------
template <int N, int P>
constexpr int smem_chunk_state() {
  return (L * N + L * P + N * P + 2 * L) * static_cast<int>(sizeof(float));
}

// Warp 0 only: head h's cumsum, w = dt * exp(cum_{L-1} - cum) and the chunk's decay.
__device__ __forceinline__ void chunk_weights(const Params& p, const Block& blk, int h,
                                              const HeadDt& d, float* cum, float* w) {
  const float last = chunk_cumsum(d, cum, w);
  const int l0 = 2 * threadIdx.x;
  w[l0] *= expf(last - cum[l0]);
  w[l0 + 1] *= expf(last - cum[l0 + 1]);
  if (threadIdx.x == 0) p.chunk_decay[blk.bh(p, h) * p.nc + blk.ch] = expf(last);
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(nt_state(N, P), 2) ssd_scan_chunk_state(const Params p) {
  constexpr int NT = nt_state(N, P), VT = 16 / sizeof(T);
  constexpr int XV = (L * P / VT + NT - 1) / NT;  // 16-byte loads of x per thread and head
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);  // L x N
  float* Xs = Bs + L * N;                       // L x P: x * w
  float* Ss = Xs + L * P;                       // N x P: S_c, staged for the bulk store
  float* cum = Ss + N * P;                      // L
  float* w = cum + L;                           // L: dt * exp(cum_{L-1} - cum)
  const int tid = threadIdx.x;
  const Block blk(p);

  if (tid < 32) chunk_weights(p, blk, blk.h0, fetch_dt(p, blk, blk.h0), cum, w);
  const T* bg = static_cast<const T*>(p.b) + blk.bi * p.bs[0] + blk.g * p.bs[2];
  for (int i = tid; i < L * N / VT; i += NT) {
    const int l = i / (N / VT), n = (i % (N / VT)) * VT, s = blk.s0 + l;
    float v[VT] = {};
    if (s < p.S) load16(bg + s * p.bs[1] + n, v);
#pragma unroll
    for (int k = 0; k < VT; ++k) Bs[l * N + n + k] = v[k];
  }
  // a head's x rows, fetched into registers while the last head's product runs
  uint4 xr[XV];
  const auto fetch_x = [&](int h) {
    const T* xg = static_cast<const T*>(p.x) + blk.bi * p.xs[0] + h * p.xs[2];
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = tid + j * NT, l = i / (P / VT), q = (i % (P / VT)) * VT, s = blk.s0 + l;
      xr[j] = make_uint4(0, 0, 0, 0);
      if (i < L * P / VT && s < p.S) xr[j] = *reinterpret_cast<const uint4*>(xg + s * p.xs[1] + q);
    }
  };
  fetch_x(blk.h0);
  using Tl = Tile<N, P, NT>;
  const Tl t(tid);
  for (int k = 0; k < p.kh; ++k) {
    const int h = blk.h0 + k;
    __syncthreads();  // the last head's product is done with Xs; w of head h is in
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = tid + j * NT, l = i / (P / VT), q = (i % (P / VT)) * VT;
      if (i >= L * P / VT) continue;
      float v[VT];
      unpack16(xr[j], v, T());
#pragma unroll
      for (int e = 0; e < VT; ++e) Xs[l * P + q + e] = v[e] * w[l];
    }
    if (tid == 0) bulk_wait_read();  // the last head's S_c has left Ss
    __syncthreads();
    HeadDt next{};
    if (tid < 32 && k + 1 < p.kh) next = fetch_dt(p, blk, h + 1);
    if (k + 1 < p.kh) fetch_x(h + 1);
    float acc[Tl::TR][4];
    zero<N, P, NT>(acc);
    t.mac(acc, Bs, N, Xs, P, 0, L);
    // S_c leaves through the bulk copy engine while the next head's product runs
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i)
      *reinterpret_cast<float4*>(Ss + t.row(i) * P + t.col0()) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    fence_async_smem();
    __syncthreads();
    if (tid == 0)
      bulk_store(p.chunk_state + (blk.bh(p, h) * p.nc + blk.ch) * N * P, Ss,
                 N * P * static_cast<int>(sizeof(float)));
    // the next head's weights: every reader of w passed the barrier above
    if (tid < 32 && k + 1 < p.kh) chunk_weights(p, blk, h + 1, next, cum, w);
  }
  if (tid == 0) bulk_wait();
}

// ---- phase 2: the chain h <- e_c h + S_c, in place ---------------------------------------
constexpr int NT_PASS = 256;
constexpr int PASS_DEPTH = 8;  // chunks whose loads a thread keeps in flight

template <int N, int P>
__global__ void __launch_bounds__(NT_PASS) ssd_scan_state_pass(const Params p) {
  constexpr int V = N * P / 4;  // float4s per chunk state
  const int e4 = blockIdx.x * NT_PASS + threadIdx.x;
  if (e4 >= V) return;
  const int bh = blockIdx.y;
  const float* dec = p.chunk_decay + static_cast<long long>(bh) * p.nc;
  float4* st = reinterpret_cast<float4*>(p.chunk_state) + static_cast<long long>(bh) * p.nc * V + e4;
  // software pipeline: the next PASS_DEPTH chunks' loads are issued before
  // this group's stores, so loads stay in flight while the chain runs;
  // streaming hints, since the 201 MB of states do not fit in L2
  float4 cur[PASS_DEPTH], nxt[PASS_DEPTH];
  float ec[PASS_DEPTH], en[PASS_DEPTH];
#pragma unroll
  for (int k = 0; k < PASS_DEPTH; ++k)
    if (k < p.nc) cur[k] = __ldcs(st + static_cast<long long>(k) * V), ec[k] = dec[k];
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < p.nc; c0 += PASS_DEPTH) {
#pragma unroll
    for (int k = 0; k < PASS_DEPTH; ++k) {
      const int c = c0 + PASS_DEPTH + k;
      if (c < p.nc) nxt[k] = __ldcs(st + static_cast<long long>(c) * V), en[k] = dec[c];
    }
#pragma unroll
    for (int k = 0; k < PASS_DEPTH; ++k)
      if (c0 + k < p.nc) {
        __stcs(st + static_cast<long long>(c0 + k) * V, h);
        h = make_float4(fmaf(ec[k], h.x, cur[k].x), fmaf(ec[k], h.y, cur[k].y),
                        fmaf(ec[k], h.z, cur[k].z), fmaf(ec[k], h.w, cur[k].w));
      }
#pragma unroll
    for (int k = 0; k < PASS_DEPTH; ++k) cur[k] = nxt[k], ec[k] = en[k];
  }
  // the state is (N, P) here and (P, N) in the output
  float* out = p.state + static_cast<long long>(bh) * P * N;
  const float hv[4] = {h.x, h.y, h.z, h.w};
  if constexpr (P >= 4) {
    const int n = 4 * e4 / P, q = 4 * e4 % P;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(q + j) * N + n] = hv[j];
  } else {  // the four span rows n
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(4 * e4 + j) % P * N + (4 * e4 + j) / P] = hv[j];
  }
}

// ---- phase 3, f32: y on the CUDA cores ------------------------------------------------------
constexpr int NT_OUT = 256;

template <int N, int P>
constexpr int smem_output_f32() {
  return (N * L + 2 * L * L + L * P + N * (L > P ? L : P) + 2 * 2 * L) *
         static_cast<int>(sizeof(float));
}

template <int N, int P>
__global__ void __launch_bounds__(NT_OUT, 2) ssd_scan_output_f32(const Params p) {
  constexpr int NT = NT_OUT, XV = L * P / 4 / NT;  // float4s of x per thread and head
  extern __shared__ float4 smem4[];
  float* Ct = reinterpret_cast<float*>(smem4);  // N x L: C transposed
  float* Rt = Ct + N * L;                       // L x L: raw scores C B^T, Rt[m * L + l]
  float* Gt = Rt + L * L;                       // L x L: a head's masked scores times dt_m
  float* Xs = Gt + L * L;                       // L x P: x
  float* Bt = Xs + L * P;                       // N x L: B transposed; then h_in, N x P
  float* decays = Bt + N * (L > P ? L : P);     // 2 x (cum, dt): this head's and the next's
  float* Hs = Bt;
  const int tid = threadIdx.x;
  const Block blk(p);

  // a head's x rows into registers, fetched while the last head's products run
  float4 xr[XV];
  const auto fetch_x = [&](int h) {
    const float* xg = static_cast<const float*>(p.x) + blk.bi * p.xs[0] + h * p.xs[2];
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = tid + j * NT, l = i / (P / 4), q = (i % (P / 4)) * 4, s = blk.s0 + l;
      xr[j] = s < p.S ? *reinterpret_cast<const float4*>(xg + s * p.xs[1] + q)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  const auto store_x = [&]() {
#pragma unroll
    for (int j = 0; j < XV; ++j) reinterpret_cast<float4*>(Xs)[tid + j * NT] = xr[j];
  };
  // a head's h_in into Hs, copied in the background
  const auto fetch_h = [&](int h) {
    const float* hin = p.chunk_state + (blk.bh(p, h) * p.nc + blk.ch) * N * P;
    for (int i = tid; i < N * P / 4; i += NT) cp_async16(Hs + 4 * i, hin + 4 * i, true);
  };
  // Gt[m][l] = Rt[m][l] exp(cum_l - cum_m) dt_m for l >= m; above the
  // diagonal Gt stays 0 from the start
  const auto fill_g = [&](const float* cum) {
    const float* dtl = cum + L;
    for (int i = tid; i < L * L; i += NT) {
      const int m = i / L, l = i % L;
      if (l >= m) Gt[i] = Rt[i] * expf(cum[l] - cum[m]) * dtl[m];
    }
  };

  if (tid < 32) chunk_cumsum(fetch_dt(p, blk, blk.h0), decays, decays + L);
  const float* cg = static_cast<const float*>(p.c) + blk.bi * p.cs[0] + blk.g * p.cs[2];
  const float* bg = static_cast<const float*>(p.b) + blk.bi * p.bs[0] + blk.g * p.bs[2];
  // neighbouring lanes take neighbouring rows, so the transposed stores hit distinct banks
  for (int i = tid; i < L * N / 4; i += NT) {
    const int l = i % L, n = (i / L) * 4, s = blk.s0 + l;
    float cv[4] = {}, bv[4] = {};
    if (s < p.S) load16(cg + s * p.cs[1] + n, cv), load16(bg + s * p.bs[1] + n, bv);
#pragma unroll
    for (int k = 0; k < 4; ++k) Ct[(n + k) * L + l] = cv[k], Bt[(n + k) * L + l] = bv[k];
  }
  fetch_x(blk.h0);
  for (int i = tid; i < L * L; i += NT) Gt[i] = 0.f;
  __syncthreads();
  {  // raw scores Rt[m][l] = C_l . B_m, tiles wholly above the diagonal skipped
    using Tl = Tile<L, L, NT>;
    const Tl t(tid);
    if (t.col0() <= t.row_max()) {
      float acc[Tl::TR][4];
      zero<L, L, NT>(acc);
      t.mac(acc, Ct, L, Bt, L, 0, N);
#pragma unroll
      for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Rt[(t.col0() + j) * L + t.row(i)] = acc[i][j];
    }
  }
  __syncthreads();  // Bt is read no more
  fetch_h(blk.h0);
  store_x();
  fill_g(decays);
  cp_async_wait_all();
  __syncthreads();

  // per head: y = exp(cum) o (C h_in) + Gt^T x.  The next head's dt and x
  // are fetched while C h_in runs, its h_in while Gt^T x runs.
  using Tl = Tile<L, P, NT>;
  const Tl t(tid);
  for (int k = 0; k < p.kh; ++k) {
    const int h = blk.h0 + k;
    const bool more = k + 1 < p.kh;
    const float* cum = decays + (k & 1) * 2 * L;
    float* cum_next = decays + ((k + 1) & 1) * 2 * L;
    HeadDt next{};
    if (tid < 32 && more) next = fetch_dt(p, blk, h + 1);
    if (more) fetch_x(h + 1);
    float acc[Tl::TR][4];
    zero<L, P, NT>(acc);
    t.mac(acc, Ct, L, Hs, P, 0, N);
    __syncthreads();  // Hs is read no more
    if (more) fetch_h(h + 1);
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i) {
      const float e = expf(cum[t.row(i)]);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= e;
    }
    t.mac(acc, Gt, L, Xs, P, 0, t.row_max() + 1);  // Gt is 0 above the diagonal
    float* yg = static_cast<float*>(p.y) + blk.bi * p.ys[0] + h * p.ys[2];
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i) {
      const int s = blk.s0 + t.row(i);
      if (s < p.S)
        *reinterpret_cast<float4*>(yg + s * p.ys[1] + t.col0()) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    if (more) {
      // the other decay buffer's last readers passed the barrier above
      if (tid < 32) chunk_cumsum(next, cum_next, cum_next + L);
      __syncthreads();  // Xs and Gt are read no more
      store_x();
      fill_g(cum_next);
      cp_async_wait_all();
      __syncthreads();
    }
  }
}

// ---- phase 3, bf16: y on the tensor cores ---------------------------------------------------
constexpr int NT_MMA = 128;  // four warps, each owning 16 rows of the chunk

template <int N, int P>
constexpr int smem_output_bf16() {
  return (2 * L * (N + 8) + L * (P + 8) + N * (P + 8)) * 2 + 2 * 2 * L * static_cast<int>(sizeof(float));
}

template <int N, int P>
__global__ void __launch_bounds__(NT_MMA, 3) ssd_scan_output_bf16(const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int LDN = N + 8, LDP = P + 8;  // rows padded by 16 bytes: ldmatrix is conflict-free
  extern __shared__ float4 smem4[];
  bf16* Cs = reinterpret_cast<bf16*>(smem4);  // L x N
  bf16* Bs = Cs + L * LDN;                    // L x N
  bf16* Xs = Bs + L * LDN;                    // L x P: x
  bf16* Hs = Xs + L * LDP;                    // N x P: h_in
  float* decays = reinterpret_cast<float*>(Hs + N * LDP);  // 2 x (cum, dt)
  const int tid = threadIdx.x;
  const Block blk(p);

  if (tid < 32) chunk_cumsum(fetch_dt(p, blk, blk.h0), decays, decays + L);
  const bf16* cg = static_cast<const bf16*>(p.c) + blk.bi * p.cs[0] + blk.g * p.cs[2];
  const bf16* bg = static_cast<const bf16*>(p.b) + blk.bi * p.bs[0] + blk.g * p.bs[2];
  for (int i = tid; i < L * N / 8; i += NT_MMA) {
    const int l = i / (N / 8), n = (i % (N / 8)) * 8, s = blk.s0 + l;
    uint4 cv = make_uint4(0, 0, 0, 0), bv = cv;
    if (s < p.S) {
      cv = *reinterpret_cast<const uint4*>(cg + s * p.cs[1] + n);
      bv = *reinterpret_cast<const uint4*>(bg + s * p.bs[1] + n);
    }
    *reinterpret_cast<uint4*>(Cs + l * LDN + n) = cv;
    *reinterpret_cast<uint4*>(Bs + l * LDN + n) = bv;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * warp;                                  // the warp's rows
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;       // ldmatrix row of this lane
  const int lcol = (lane >> 4) * 8;                          // and its column
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;

  // raw scores C B^T for rows r0..r0+15 and columns m < r0 + 16 (the rest is
  // above the diagonal), once for the block's heads
  float sc[L / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, Cs + (r0 + lrow) * LDN + 16 * kk + lcol);
#pragma unroll
    for (int jp = 0; jp < L / 16; ++jp) {
      if (jp > warp) break;
      uint32_t b[4];
      ldmatrix_x4(b, Bs + (16 * jp + brow) * LDN + 16 * kk + bcol);
      mma_bf16(sc[2 * jp], a, b[0], b[1]);
      mma_bf16(sc[2 * jp + 1], a, b[2], b[3]);
    }
  }

  const int la = r0 + gq, lb = la + 8, sa = blk.s0 + la, sb = blk.s0 + lb;
  for (int k = 0; k < p.kh; ++k) {
    const int h = blk.h0 + k;
    const float* cum = decays + (k & 1) * 2 * L;
    const float* dtl = cum + L;
    __syncthreads();  // the last head's y is done; head h's cumsum is in
    HeadDt next{};
    if (tid < 32 && k + 1 < p.kh) next = fetch_dt(p, blk, h + 1);
    const bf16* xg = static_cast<const bf16*>(p.x) + blk.bi * p.xs[0] + h * p.xs[2];
    for (int i = tid; i < L * P / 8; i += NT_MMA) {
      const int l = i / (P / 8), q = (i % (P / 8)) * 8, s = blk.s0 + l;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (s < p.S) v = *reinterpret_cast<const uint4*>(xg + s * p.xs[1] + q);
      *reinterpret_cast<uint4*>(Xs + l * LDP + q) = v;
    }
    const float* hin = p.chunk_state + (blk.bh(p, h) * p.nc + blk.ch) * N * P;
    for (int i = tid; i < N * P / 8; i += NT_MMA) {
      const int n = i / (P / 8), q = (i % (P / 8)) * 8;
      float v[8];
      load16(hin + n * P + q, v);
      load16(hin + n * P + q + 4, v + 4);
      *reinterpret_cast<uint4*>(Hs + n * LDP + q) = make_uint4(
          pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
    __syncthreads();

    // this head's scores: mask, decay and dt_m.  The accumulator layout of two
    // neighbouring n-tiles is the A-operand layout of one k-step, so they
    // stay in registers.
    uint32_t ga[L / 16][4];
#pragma unroll
    for (int j = 0; j < L / 8; ++j) {
      const int m = 8 * j + 2 * tq;
      const float w0 = dtl[m], w1 = dtl[m + 1];
      const float v0 = la >= m ? sc[j][0] * expf(cum[la] - cum[m]) * w0 : 0.f;
      const float v1 = la >= m + 1 ? sc[j][1] * expf(cum[la] - cum[m + 1]) * w1 : 0.f;
      const float v2 = lb >= m ? sc[j][2] * expf(cum[lb] - cum[m]) * w0 : 0.f;
      const float v3 = lb >= m + 1 ? sc[j][3] * expf(cum[lb] - cum[m + 1]) * w1 : 0.f;
      ga[j / 2][(j % 2) * 2] = pack_bf16(v0, v1);
      ga[j / 2][(j % 2) * 2 + 1] = pack_bf16(v2, v3);
    }

    // y = exp(cum) o (C h_in) + G x
    float acc[P / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, Cs + (r0 + lrow) * LDN + 16 * kk + lcol);
#pragma unroll
      for (int jp = 0; jp < P / 16; ++jp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Hs + (16 * kk + lrow) * LDP + 16 * jp + lcol);
        mma_bf16(acc[2 * jp], a, b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
      }
    }
    const float ea = expf(cum[la]), eb = expf(cum[lb]);
#pragma unroll
    for (int j = 0; j < P / 8; ++j) acc[j][0] *= ea, acc[j][1] *= ea, acc[j][2] *= eb, acc[j][3] *= eb;
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      if (kk > warp) break;
#pragma unroll
      for (int jp = 0; jp < P / 16; ++jp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Xs + (16 * kk + lrow) * LDP + 16 * jp + lcol);
        mma_bf16(acc[2 * jp], ga[kk], b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], ga[kk], b[2], b[3]);
      }
    }
    bf16* yg = static_cast<bf16*>(p.y) + blk.bi * p.ys[0] + h * p.ys[2];
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      const int q = 8 * j + 2 * tq;
      if (sa < p.S) store_pair(yg + sa * p.ys[1] + q, acc[j][0], acc[j][1]);
      if (sb < p.S) store_pair(yg + sb * p.ys[1] + q, acc[j][2], acc[j][3]);
    }
    // the next head's cumsum; the other buffer was last read before the barrier above
    if (tid < 32 && k + 1 < p.kh) {
      float* nxt = decays + ((k + 1) & 1) * 2 * L;
      chunk_cumsum(next, nxt, nxt + L);
    }
  }
}

// ---- phase 3, head dims below 16: y of a block's packed tiles ------------------------------
template <int N, int Q>
struct OutNarrowSmem {
  // rows padded so the mma fragments' loads spread over the banks: C and B
  // transposed (72), h_in (24), C h_in and x dt (20), each head's cumsum (65)
  static constexpr int LT = L + 8, HS = 24, XR = 20, LC = L + 1;
  // a tile's h_in, C h_in and x dt take B's place once the raw scores are in,
  // where it is large enough: two blocks an SM at N = 128
  static constexpr int TILE = N * HS + 2 * L * XR;
  static constexpr bool IN_B = N * LT >= TILE;
  static constexpr int FLOATS = 2 * N * LT + L * L + (IN_B ? 0 : TILE) + Packed<Q>::K * LC;
  static constexpr int BYTES = FLOATS * static_cast<int>(sizeof(float));
};

template <typename T, int N, int Q>
__global__ void __launch_bounds__(NT_OUT, 2) ssd_scan_output_narrow(const Params p) {
  using SM = OutNarrowSmem<N, Q>;
  constexpr int NT = NT_OUT, NW = NT / 32, VT = 16 / sizeof(T);
  constexpr int LT = SM::LT, HS = SM::HS, XR = SM::XR, LC = SM::LC;
  constexpr int K = Packed<Q>::K, QC = Packed<Q>::QC, HPT = Packed<Q>::HPT;
  constexpr bool EX = sizeof(T) == 2;  // bf16 B and C: exact in TF32
  extern __shared__ float4 smem4[];
  float* Ct = reinterpret_cast<float*>(smem4);  // N x LT: C transposed
  float* Bt = Ct + N * LT;                      // N x LT: B transposed
  float* Rt = Bt + N * LT;                      // L x L: raw scores C B^T, Rt[m * L + l]
  float* Hs = SM::IN_B ? Bt : Rt + L * L;      // N x HS: the tile's h_in
  float* Ys = Hs + N * HS;                      // L x XR: C h_in
  float* Xw = Ys + L * XR;                      // L x XR: the tile's x dt
  float* cum = Rt + L * L + (SM::IN_B ? 0 : SM::TILE);  // K x LC: each head's cumsum
  const int tid = threadIdx.x, warp = tid >> 5;
  const NarrowBlock blk(p.H, p.G, K, p.kh);

  const T* cg = static_cast<const T*>(p.c) + blk.bi * p.cs[0] + blk.g * p.cs[2];
  const T* bg = static_cast<const T*>(p.b) + blk.bi * p.bs[0] + blk.g * p.bs[2];
  // neighbouring lanes take neighbouring rows, so the transposed stores hit distinct banks
  for (int i = tid; i < L * N / VT; i += NT) {
    const int l = i % L, n = (i / L) * VT, s = blk.s0 + l;
    float cv[VT] = {}, bv[VT] = {};
    if (s < p.S) load16(cg + s * p.cs[1] + n, cv), load16(bg + s * p.bs[1] + n, bv);
#pragma unroll
    for (int k = 0; k < VT; ++k) Ct[(n + k) * LT + l] = cv[k], Bt[(n + k) * LT + l] = bv[k];
  }
  __syncthreads();
  // raw scores, once for the block's tiles, on the tensor cores
  raw_scores<N, EX>(Ct, Bt, LT, [&](int l, int m, float v0, float v1) {
    Rt[m * L + l] = v0;
    Rt[(m + 1) * L + l] = v1;
  });

  // a thread's row l and columns c0 .. c0 + 3: HPT heads from kb on, QC columns each
  using Tl = Tile<L, 16, NT>;
  const Tl t(tid);
  const int l = t.row(0), c0 = t.col0(), kb = c0 / Q, s = blk.s0 + l;
  for (int tt = 0; tt < p.kh; ++tt) {
    const int tile = blk.t0 + tt, h0 = blk.head0(tile, K), nh = blk.heads(tile, K);
    __syncthreads();  // Rt is in (and Bt read no more); the last tile is done with Hs, Ys, Xw, cum
    async_packed_state<N, Q, NT>(
        Hs, p.chunk_state + ((static_cast<long long>(blk.bi) * p.H + h0) * p.nc + blk.ch) * N * Q,
        static_cast<long long>(p.nc) * N * Q, nh, HS);
    // each head's cumsum (its dt is read again below, with x)
    narrow_cumsums<K, NW>(p.dt, p.dts, p.a, blk.bi, blk.s0, p.S, h0, nh, cum, nullptr, LC);
    {  // x dt, row i / 4 and columns 4 (i % 4) .. + 3 a thread
      const T* xg = static_cast<const T*>(p.x) + blk.bi * p.xs[0] + h0 * p.xs[2];
      for (int i = tid; i < L * 4; i += NT) {
        const int lx = i >> 2, cx = (i & 3) * 4, sx = blk.s0 + lx;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (sx < p.S) {
          load_packed4<Q>(xg + sx * p.xs[1], p.xs[2], cx, nh, v);
          const float* dtr = p.dt + blk.bi * p.dts[0] + sx * p.dts[1];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = (cx + j) / Q;
            if (k < nh) v[j] *= dtr[(h0 + k) * p.dts[2]];
          }
        }
        *reinterpret_cast<float4*>(Xw + lx * XR + cx) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // C h_in for the tile's heads, one product on the tensor cores: warp w
    // the rows 16 (w % 4) .. and columns 8 (w / 4) ..
    warp_block<1, N, EX, false>(Ct, LT, Hs, HS, 16 * (warp & 3), 8 * (warp >> 2),
                                [&](int r, int c, float v0, float v1) { store_pair(Ys + r * XR + c, v0, v1); });
    __syncthreads();

    // y = exp(cum_l) o (C h_in) + sum_{m <= l} (C_l . B_m) exp(cum_l - cum_m) dt_m x_m
    float acc[4], cl[HPT];
#pragma unroll
    for (int hh = 0; hh < HPT; ++hh) cl[hh] = cum[(kb + hh) * LC + l];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = Ys[l * XR + c0 + j] * expf(cl[j / QC]);
    for (int m = 0; m <= l; ++m) {
      const float r = Rt[m * L + l];
      const float4 xv = *reinterpret_cast<const float4*>(Xw + m * XR + c0);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int hh = 0; hh < HPT; ++hh) {
        const float e = r * expf(cl[hh] - cum[(kb + hh) * LC + m]);
#pragma unroll
        for (int jj = 0; jj < QC; ++jj) acc[hh * QC + jj] = fmaf(e, xa[hh * QC + jj], acc[hh * QC + jj]);
      }
    }
    if (s < p.S)
      store_packed4<Q>(static_cast<T*>(p.y) + blk.bi * p.ys[0] + s * p.ys[1] + h0 * p.ys[2], p.ys[2],
                       c0, nh, acc);
  }
}

// ---- launches --------------------------------------------------------------------------------
template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, const Args& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // all of the SM's 228 KB as shared memory: two phase-3 blocks fit
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int N, int Q>
__global__ void __launch_bounds__(nt_state(N, 16), 2) ssd_scan_chunk_state_narrow(const NarrowStateArgs a) {
  narrow_chunk_state<T, N, Q, false>(a);
}

template <typename T, int N, int P>
cudaError_t run(const Params& p, int B, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (P < 16) {  // packed tiles, kh = tiles per block
    const int tb_n = (p.H / p.G + Packed<P>::K - 1) / Packed<P>::K / p.kh;
    const dim3 blocks(p.nc, B * p.G * tb_n);
    const NarrowStateArgs a{p.b, p.x, p.dt, p.a, p.chunk_state, p.chunk_decay, p.S, p.H, p.G, p.nc,
                            p.kh, {p.bs[0], p.bs[1], p.bs[2]}, {p.xs[0], p.xs[1], p.xs[2]},
                            {p.dts[0], p.dts[1], p.dts[2]}};
    err = launch(ssd_scan_chunk_state_narrow<T, N, P>, blocks, nt_state(N, 16),
                 NarrowStateSmem<N, P>::BYTES, a, stream);
    if (err == cudaSuccess)
      err = launch(ssd_scan_state_pass<N, P>, dim3((N * P / 4 + NT_PASS - 1) / NT_PASS, B * p.H),
                   NT_PASS, 0, p, stream);
    if (err == cudaSuccess)
      err = launch(ssd_scan_output_narrow<T, N, P>, blocks, NT_OUT, OutNarrowSmem<N, P>::BYTES, p,
                   stream);
    return err;
  } else {
    const dim3 blocks(p.nc, B * p.H / p.kh);
    err = launch(ssd_scan_chunk_state<T, N, P>, blocks, nt_state(N, P), smem_chunk_state<N, P>(), p,
                 stream);
    if (err != cudaSuccess) return err;
    err = launch(ssd_scan_state_pass<N, P>, dim3((N * P / 4 + NT_PASS - 1) / NT_PASS, B * p.H),
                 NT_PASS, 0, p, stream);
    if (err != cudaSuccess) return err;
    if constexpr (sizeof(T) == 4)
      return launch(ssd_scan_output_f32<N, P>, blocks, NT_OUT, smem_output_f32<N, P>(), p, stream);
    else
      return launch(ssd_scan_output_bf16<N, P>, blocks, NT_MMA, smem_output_bf16<N, P>(), p,
                    stream);
  }
}

template <typename T, int N>
cudaError_t dispatch_p(const Params& p, int B, int P, cudaStream_t stream) {
  switch (P) {
    case 1: return run<T, N, 1>(p, B, stream);
    case 2: return run<T, N, 2>(p, B, stream);
    case 4: return run<T, N, 4>(p, B, stream);
    case 8: return run<T, N, 8>(p, B, stream);
    case 16: return run<T, N, 16>(p, B, stream);
    case 32: return run<T, N, 32>(p, B, stream);
    case 64: return run<T, N, 64>(p, B, stream);
    case 128: return run<T, N, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_n(const Params& p, int B, int P, int N, cudaStream_t stream) {
  switch (N) {
    case 16: return dispatch_p<T, 16>(p, B, P, stream);
    case 32: return dispatch_p<T, 32>(p, B, P, stream);
    case 64: return dispatch_p<T, 64>(p, B, P, stream);
    case 128: return dispatch_p<T, 128>(p, B, P, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B,S,H,P), dt (B,S,H) f32, a (H,) f32, b/c (B,S,G,N), y (B,S,H,P), with
// the last dim of x, b, c, y contiguous and their rows 16-byte aligned (x
// and y at P >= 16 only); state (B,H,P,N) f32, contiguous; scratch f32 of at
// least B*H*nc*(N*P + 1) floats, nc = ceil(S / 64), which the three launches
// use in turn.
// strides[15] = (batch, seq, head|group) element strides of x, dt, b, c, y.
// dtype (of x, b, c, y): 0 = float32, 1 = bfloat16.  P in {1, 2, 4, 8, 16,
// 32, 64, 128}, N in {16, 32, 64, 128}.  Returns the first launch's
// cudaGetLastError() that is not 0, else 0.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* a, const void* b,
                            const void* c, void* y, float* state, float* scratch,
                            long long scratch_floats, int dtype, int B, int S, int H, int G,
                            int P, int N, const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (S + L - 1) / L;
  const long long chunk_floats = static_cast<long long>(B) * H * nc * N * P;
  if (scratch_floats < chunk_floats + static_cast<long long>(B) * H * nc)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = P < 16 ? (H / G + 16 / P - 1) / (16 / P) : 0;
  const int kh = P < 16 ? tiles_per_block(tiles, static_cast<long long>(B) * G * tiles * nc)
                        : heads_per_block(H / G, static_cast<long long>(B) * H * nc);
  Params p{x, dt, a, b, c, y, state, scratch, scratch + chunk_floats, S, H, G, nc, kh,
           {}, {}, {}, {}, {}};
  for (int i = 0; i < 3; ++i) {
    p.xs[i] = strides[i];
    p.dts[i] = strides[3 + i];
    p.bs[i] = strides[6 + i];
    p.cs[i] = strides[9 + i];
    p.ys[i] = strides[12 + i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? dispatch_n<float>(p, B, P, N, st)
                    : dtype == 1 ? dispatch_n<__nv_bfloat16>(p, B, P, N, st)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
