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
// Design: six launches, none with atomics, so two calls give the same bits.
//   1. ssd_bwd_chunk_grad, a block per (chunk, batch*head): Z_c =
//      sum_l exp(cum_l) C_l^T dY_l (N x P) into a scratch buffer, phase 1 of
//      the forward turned over.  Bound by operations, 2 L N P flops.
//   2. ssd_bwd_state_pass, a thread per 4 state elements: the chain walked
//      backwards, g <- exp(cum_{L-1}) g + Z_c, leaving in each chunk's slot
//      the gradient of the state leaving it.  Bound by bytes (the scratch
//      read and written once), pipelined as the forward's pass.
//   3. ssd_bwd_dx, a block per (chunk, batch*head): dx, ddt and the chunk's
//      share of da.  Products (f32, the forward's register tiles) C B^T,
//      dY x^T, B g, M^T dY and C h_in: 2 L^2 (N + 2P) + 4 L N P flops; dcum
//      and its reverse cumsum from row and column sums taken in a fixed
//      order.  Bound by operations.
//   4. ssd_bwd_dbc, a block per (chunk, batch*head): each head's dB and dC
//      (f32, (B, S, H, N)).  Products dY x^T, dY h_in^T, W B, x g^T and
//      W^T C: 2 L^2 (P + 2N) + 4 L N P flops.  Bound by operations.
//   5. ssd_bwd_group_sum: each group's heads added in head order, cast to
//      the dtype.  Bound by bytes.
//   6. ssd_bwd_da: per head, the chunks' shares of da added in a fixed order.
// Computing dY x^T in both 3 and 4, instead of passing the L x L scores
// through device memory, keeps each block's shared memory under the card's
// 227 KB at every N and P up to 128.
//
// The states entering each chunk are the forward's own scratch, which
// holds them after its phase 2: the autograd Function saves it, 201 MB a
// layer at mamba2-130m's (4, 4096, 24, 64), N = 128 (4.8 GB over 24 layers
// under remat "none"; one layer's worth under "dots" or "full", whose
// recompute launches the forward again).  This saves two launches over
// recomputing them.  The backward's own scratch, (B*H, nc, N, P) for g and
// (B, S, H, N) twice for each head's dB and dC, 603 MB there, lives for one
// call.
//
// Products.  f32 on the CUDA cores in both dtypes (one TF32 pass would miss
// 1e-4; bf16 inputs are widened to f32 in shared memory), every operand
// k-major in shared memory, so each matrix that is contracted over both of
// its indices is loaded twice, once transposed.  Rows past S load as dt = 0
// and x = B = C = dY = 0 and are never written.
//
// `nvcc -Xptxas -v` (CUDA 12.8, sm_90a) at N = 128, P = 64, f32 and bf16 alike, no
// spills (none at any N and P):
//   ssd_bwd_chunk_grad   64 registers,  49,920 B shared, 256 threads: 4 blocks/SM
//   ssd_bwd_state_pass   95 registers, no shared, 256 threads
//   ssd_bwd_dx           58 registers, 158,208 B shared, 256 threads: 1 block/SM
//   ssd_bwd_dbc          89 registers, 164,352 B shared, 256 threads: 1 block/SM
//   ssd_bwd_group_sum    48 registers, no shared, 256 threads
//   ssd_bwd_da           33 registers, no shared, 32 threads

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_scan.cuh"

namespace {

constexpr int NT = 256;  // threads of the per-chunk product kernels 3 and 4
constexpr int NT_PASS = 256;
constexpr int PASS_DEPTH = 8;  // chunks whose loads a thread of the pass keeps in flight
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use

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
  float* db_h;          // (B, S, H, N): each head's dB
  float* dc_h;          // (B, S, H, N): each head's dC
  float* da_part;       // (B*H, nc): each chunk's share of da
  void* dx;             // (B, S, H, P), contiguous
  float* ddt;           // (B, S, H), contiguous
  float* da;            // (H,)
  void* db;             // (B, S, G, N), contiguous
  void* dc;             // (B, S, G, N), contiguous
  int B, S, H, G, nc;
  // element strides of (batch, sequence, head or group) for x, dt, b, c, dy;
  // the last dim of x, b, c, dy is contiguous
  long long xs[3], dts[3], bs[3], cs[3], dys[3];
};

// The (chunk, batch, head) of a per-chunk block, and the head's group
struct Blk {
  int ch, s0, bi, h, g;
  long long bh;
  __device__ explicit Blk(const Params& p)
      : ch(blockIdx.x), s0(blockIdx.x * L), bi(blockIdx.y / p.H), h(blockIdx.y % p.H),
        g(blockIdx.y % p.H / (p.H / p.G)), bh(blockIdx.y) {}
  __device__ long long slot(const Params& p) const { return bh * p.nc + ch; }
  __device__ long long row(const Params& p, int s) const {  // (b, s) of (B, S, ...)
    return static_cast<long long>(bi) * p.S + s;
  }
};

// Warp 0 only: the head's dt into dtl[] and the cumsum of dt * a into cum[]
// (the forward's own arithmetic); returns cum[L-1].
__device__ __forceinline__ float head_cumsum(const Params& p, const Blk& k, float* cum, float* dtl) {
  const float* dtg = p.dt + k.bi * p.dts[0] + k.h * p.dts[2];
  const int s = k.s0 + 2 * threadIdx.x;
  const HeadDt d{s < p.S ? dtg[s * p.dts[1]] : 0.f, s + 1 < p.S ? dtg[(s + 1) * p.dts[1]] : 0.f,
                 p.a[k.h]};
  return chunk_cumsum(d, cum, dtl);
}

// 4 consecutive values as floats, and back
__device__ __forceinline__ void load4(const float* src, float* v) { load16(src, v); }
__device__ __forceinline__ void load4(const __nv_bfloat16* src, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// The chunk's L rows of K values (zeros past S) into shared memory as f32,
// row-major (dst[l * K + k]) or transposed (dst[k * L + l]), each row times
// w[l] if w is given.  Transposed, neighbouring lanes take neighbouring rows,
// so the stores hit distinct banks.
template <int K, bool TRANS, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long rs, int s0, int S,
                                          const float* w) {
  for (int i = threadIdx.x; i < L * K / 4; i += blockDim.x) {
    const int l = TRANS ? i % L : i / (K / 4), k = TRANS ? (i / L) * 4 : (i % (K / 4)) * 4;
    const int s = s0 + l;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (s < S) load4(src + s * rs + k, v);
    if (w) {
      const float f = w[l];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] *= f;
    }
    if constexpr (TRANS) {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[(k + j) * L + l] = v[j];
    } else {
      store4(dst + l * K + k, v);
    }
  }
}

// A chunk's (N, P) state into shared memory, as it is (dst[n * P + q]) or
// transposed (dst[q * N + n]).
template <int N, int P, bool TRANS>
__device__ __forceinline__ void load_state(float* dst, const float* src) {
  for (int i = threadIdx.x; i < N * P / 4; i += blockDim.x) {
    const int n = TRANS ? i % N : i / (P / 4), q = TRANS ? (i / N) * 4 : (i % (P / 4)) * 4;
    float v[4];
    load16(src + n * P + q, v);
    if constexpr (TRANS) {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[(q + j) * N + n] = v[j];
    } else {
      store4(dst + n * P + q, v);
    }
  }
}

template <typename T>
__device__ __forceinline__ const T* at(const void* base, const long long* st, int bi, int h) {
  return static_cast<const T*>(base) + bi * st[0] + h * st[2];
}

// ---- 1: Z_c = sum_l exp(cum_l) C_l^T dY_l ----------------------------------------------------
template <int N, int P>
constexpr int smem_chunk_grad() {
  return (L * N + L * P + 3 * L) * static_cast<int>(sizeof(float));
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(nt_state(N, P)) ssd_bwd_chunk_grad(const Params p) {
  constexpr int NTS = nt_state(N, P);
  extern __shared__ float4 smem4[];
  float* Cs = reinterpret_cast<float*>(smem4);  // L x N: C
  float* Ys = Cs + L * N;                       // L x P: dY exp(cum)
  float* cum = Ys + L * P;                      // L
  float* dtl = cum + L;                         // L
  float* ew = dtl + L;                          // L: exp(cum)
  const int tid = threadIdx.x;
  const Blk k(p);
  if (tid < 32) {
    head_cumsum(p, k, cum, dtl);
    ew[2 * tid] = expf(cum[2 * tid]);
    ew[2 * tid + 1] = expf(cum[2 * tid + 1]);
  }
  load_rows<N, false>(Cs, at<T>(p.c, p.cs, k.bi, k.g), p.cs[1], k.s0, p.S, nullptr);
  __syncthreads();
  load_rows<P, false>(Ys, at<T>(p.dy, p.dys, k.bi, k.h), p.dys[1], k.s0, p.S, ew);
  __syncthreads();
  using Tl = Tile<N, P, NTS>;
  const Tl t(tid);
  float acc[Tl::TR][4];
  zero<N, P, NTS>(acc);
  t.mac(acc, Cs, N, Ys, P, 0, L);
  float* out = p.g + k.slot(p) * N * P;
#pragma unroll
  for (int i = 0; i < Tl::TR; ++i) store4(out + t.row(i) * P + t.col0(), acc[i]);
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
  const int n = 4 * e4 / P, q = 4 * e4 % P;
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p.dstate) {
    const float* ds = p.dstate + bh * P * N + n;
    g = make_float4(ds[q * N], ds[(q + 1) * N], ds[(q + 2) * N], ds[(q + 3) * N]);
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

// ---- 3: dx, ddt and the chunk's share of da ---------------------------------------------------
constexpr int RED = 32;  // partial sums per row: the most column groups a tile has (P / 4)

template <int N, int P>
constexpr int smem_dx() {
  return (2 * N * L + 2 * P * L + L * L + N * P + L * RED + NT + 6 * L) *
         static_cast<int>(sizeof(float));
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(NT) ssd_bwd_dx(const Params p) {
  extern __shared__ float4 smem4[];
  float* Ct = reinterpret_cast<float*>(smem4);  // N x L: C^T
  float* Bt = Ct + N * L;                       // N x L: B^T
  float* Ys = Bt + N * L;                       // P x L: dY^T; then L x P: dY
  float* Xt = Ys + P * L;                       // P x L: x^T
  float* Ms = Xt + P * L;                       // L x L: M, row-major
  float* Gs = Ms + L * L;                       // N x P: g; then h_in
  float* red = Gs + N * P;                      // L x RED: partial sums by row (and column)
  float* gh = red + L * RED;                    // NT: partial sums of <g, h_in>
  float* cum = gh + NT;                         // L
  float* dtl = cum + L;                         // L
  float* tsum = dtl + L;                        // L: row sum - column sum of M o dt_m (dY . x)
  float* uvec = tsum + L;                       // L: u
  float* ddir = uvec + L;                       // L: x . dx / dt
  float* dcum = ddir + L;                       // L
  const int tid = threadIdx.x;
  const Blk k(p);
  const T* xg = at<T>(p.x, p.xs, k.bi, k.h);
  const T* yg = at<T>(p.dy, p.dys, k.bi, k.h);
  const float* gsrc = p.g + k.slot(p) * N * P;
  const float* hsrc = p.h_in + k.slot(p) * N * P;

  if (tid < 32) head_cumsum(p, k, cum, dtl);
  load_rows<N, true>(Ct, at<T>(p.c, p.cs, k.bi, k.g), p.cs[1], k.s0, p.S, nullptr);
  load_rows<N, true>(Bt, at<T>(p.b, p.bs, k.bi, k.g), p.bs[1], k.s0, p.S, nullptr);
  load_rows<P, true>(Ys, yg, p.dys[1], k.s0, p.S, nullptr);
  load_rows<P, true>(Xt, xg, p.xs[1], k.s0, p.S, nullptr);
  {  // g into Gs, and this thread's share of <g, h_in>
    float dot = 0.f;
    for (int i = tid; i < N * P / 4; i += NT) {
      float v[4], w[4];
      load16(gsrc + 4 * i, v);
      load16(hsrc + 4 * i, w);
      store4(Gs + 4 * i, v);
      dot += v[0] * w[0] + v[1] * w[1] + v[2] * w[2] + v[3] * w[3];
    }
    gh[tid] = dot;
  }
  __syncthreads();

  {  // scores: M into Ms, and the row and column sums of T = M o dt_m (dY . x)
    using Tl = Tile<L, L, NT>;  // rows l, columns m
    static_assert(Tl::CT + Tl::RT <= RED, "partial sums");
    const Tl t(tid);
    float r[Tl::TR][4], q[Tl::TR][4];
    zero<L, L, NT>(r);
    zero<L, L, NT>(q);
    if (t.col0() <= t.row_max()) {  // the tile has some l >= m
      t.mac(r, Ct, L, Bt, L, 0, N);
      t.mac(q, Ys, L, Xt, L, 0, P);
    }
    float colp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i) {
      const int l = t.row(i);
      float rowp = 0.f, mv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = t.col0() + j;
        float mm = 0.f, tt = 0.f;
        if (l >= m) {
          mm = r[i][j] * expf(cum[l] - cum[m]);
          tt = mm * dtl[m] * q[i][j];
        }
        mv[j] = mm;
        rowp += tt;
        colp[j] += tt;
      }
      store4(Ms + l * L + t.col0(), mv);
      red[l * Tl::CT + t.tc] = rowp;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) red[L * Tl::CT + (t.col0() + j) * Tl::RT + t.tr] = colp[j];
    __syncthreads();
    if (tid < L) {
      float rs = 0.f, cs = 0.f;
      for (int j = 0; j < Tl::CT; ++j) rs += red[tid * Tl::CT + j];
      for (int j = 0; j < Tl::RT; ++j) cs += red[L * Tl::CT + tid * Tl::RT + j];
      tsum[tid] = rs - cs;
    }
    __syncthreads();  // red is free again
  }

  using Tp = Tile<L, P, NT>;  // rows m (or l), columns p
  constexpr int CP = Tp::CT;
  static_assert(CP <= RED, "partial sums");
  const Tp t(tid);
  float dxt[Tp::TR][4];
  zero<L, P, NT>(dxt);
  t.mac(dxt, Bt, L, Gs, P, 0, N);  // (B g)[m]: B_m^T g
#pragma unroll
  for (int i = 0; i < Tp::TR; ++i) {
    const int m = t.row(i), s = k.s0 + m;
    float xv[4] = {0.f, 0.f, 0.f, 0.f};
    if (s < p.S) load4(xg + s * p.xs[1] + t.col0(), xv);
    float up = 0.f;
    const float e = expf(cum[L - 1] - cum[m]);
#pragma unroll
    for (int j = 0; j < 4; ++j) up += xv[j] * dxt[i][j], dxt[i][j] *= e;
    red[m * CP + t.tc] = up;
  }
  __syncthreads();  // g and dY^T are read no more
  if (tid < L) {
    float u = 0.f;
    for (int j = 0; j < CP; ++j) u += red[tid * CP + j];
    uvec[tid] = u * expf(cum[L - 1] - cum[tid]) * dtl[tid];
  }
  load_rows<P, false>(Ys, yg, p.dys[1], k.s0, p.S, nullptr);
  load_state<N, P, false>(Gs, hsrc);
  __syncthreads();

  t.mac(dxt, Ms, L, Ys, P, t.row(0), L);  // + sum_{l >= m} M[l][m] dY_l
  T* dxg = static_cast<T*>(p.dx);
#pragma unroll
  for (int i = 0; i < Tp::TR; ++i) {
    const int m = t.row(i), s = k.s0 + m;
    float xv[4] = {0.f, 0.f, 0.f, 0.f}, out[4];
    if (s < p.S) load4(xg + s * p.xs[1] + t.col0(), xv);
    float dp = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) dp += xv[j] * dxt[i][j], out[j] = dtl[m] * dxt[i][j];
    if (s < p.S) store4(dxg + (k.row(p, s) * p.H + k.h) * P + t.col0(), out);
    red[m * CP + t.tc] = dp;
  }
  __syncthreads();
  if (tid < L) {
    float d = 0.f;
    for (int j = 0; j < CP; ++j) d += red[tid * CP + j];
    ddir[tid] = d;
  }
  __syncthreads();

  {  // dY_l . (C h_in)_l, for dcum
    float yo[Tp::TR][4];
    zero<L, P, NT>(yo);
    t.mac(yo, Ct, L, Gs, P, 0, N);
#pragma unroll
    for (int i = 0; i < Tp::TR; ++i) {
      const int l = t.row(i);
      float yv[4], dp = 0.f;
      load16(Ys + l * P + t.col0(), yv);
#pragma unroll
      for (int j = 0; j < 4; ++j) dp += yv[j] * yo[i][j];
      red[l * CP + t.tc] = dp;
    }
  }
  __syncthreads();
  if (tid < L) {
    float y = 0.f;
    for (int j = 0; j < CP; ++j) y += red[tid * CP + j];
    dcum[tid] = tsum[tid] + expf(cum[tid]) * y - uvec[tid];
  }
  __syncthreads();
  if (tid < 32) {
    // the state's terms land on the chunk's last row
    float us = uvec[tid] + uvec[tid + 32], hs = 0.f;
    for (int j = tid; j < NT; j += 32) hs += gh[j];
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      us += __shfl_xor_sync(FULL, us, off);
      hs += __shfl_xor_sync(FULL, hs, off);
    }
    const int l0 = 2 * tid;
    const float v0 = dcum[l0];
    float v1 = dcum[l0 + 1];
    if (tid == 31) v1 += us + expf(cum[L - 1]) * hs;
    // rc = the reverse inclusive cumsum of dcum
    float inc = v0 + v1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float dn = __shfl_down_sync(FULL, inc, off);
      if (tid + off < 32) inc += dn;
    }
    float excl = __shfl_down_sync(FULL, inc, 1);
    if (tid == 31) excl = 0.f;
    const float rc1 = excl + v1, rc0 = rc1 + v0;
    const float a = p.a[k.h];
    if (k.s0 + l0 < p.S) p.ddt[k.row(p, k.s0 + l0) * p.H + k.h] = ddir[l0] + a * rc0;
    if (k.s0 + l0 + 1 < p.S) p.ddt[k.row(p, k.s0 + l0 + 1) * p.H + k.h] = ddir[l0 + 1] + a * rc1;
    float da = dtl[l0] * rc0 + dtl[l0 + 1] * rc1;
#pragma unroll
    for (int off = 16; off; off >>= 1) da += __shfl_xor_sync(FULL, da, off);
    if (tid == 0) p.da_part[k.slot(p)] = da;
  }
}

// ---- 4: each head's dB and dC ------------------------------------------------------------------
template <int N, int P>
constexpr int smem_dbc() {
  return (2 * P * L + 2 * L * L + 2 * L * N + P * N + 2 * L) * static_cast<int>(sizeof(float));
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(NT) ssd_bwd_dbc(const Params p) {
  extern __shared__ float4 smem4[];
  float* Yt = reinterpret_cast<float*>(smem4);  // P x L: dY^T
  float* Xt = Yt + P * L;                       // P x L: x^T
  float* Ws = Xt + P * L;                       // L x L: W, row-major
  float* Wt = Ws + L * L;                       // L x L: W^T
  float* Bn = Wt + L * L;                       // L x N: B
  float* Cn = Bn + L * N;                       // L x N: C
  float* Hs = Cn + L * N;                       // P x N: h_in^T; then g^T
  float* cum = Hs + P * N;                      // L
  float* dtl = cum + L;                         // L
  const int tid = threadIdx.x;
  const Blk k(p);

  if (tid < 32) head_cumsum(p, k, cum, dtl);
  load_rows<P, true>(Yt, at<T>(p.dy, p.dys, k.bi, k.h), p.dys[1], k.s0, p.S, nullptr);
  load_rows<P, true>(Xt, at<T>(p.x, p.xs, k.bi, k.h), p.xs[1], k.s0, p.S, nullptr);
  load_rows<N, false>(Bn, at<T>(p.b, p.bs, k.bi, k.g), p.bs[1], k.s0, p.S, nullptr);
  load_rows<N, false>(Cn, at<T>(p.c, p.cs, k.bi, k.g), p.cs[1], k.s0, p.S, nullptr);
  load_state<N, P, true>(Hs, p.h_in + k.slot(p) * N * P);
  __syncthreads();
  {  // W, row-major and transposed
    using Tl = Tile<L, L, NT>;  // rows l, columns m
    const Tl t(tid);
    float q[Tl::TR][4];
    zero<L, L, NT>(q);
    if (t.col0() <= t.row_max()) t.mac(q, Yt, L, Xt, L, 0, P);
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i) {
      const int l = t.row(i);
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = t.col0() + j;
        w[j] = l >= m ? expf(cum[l] - cum[m]) * dtl[m] * q[i][j] : 0.f;
        Wt[m * L + l] = w[j];
      }
      store4(Ws + l * L + t.col0(), w);
    }
  }
  __syncthreads();

  using Tn = Tile<L, N, NT>;  // rows l (dC) or m (dB), columns n
  const Tn t(tid);
  float acc[Tn::TR][4];
  zero<L, N, NT>(acc);
  t.mac(acc, Yt, L, Hs, N, 0, P);  // (dY h_in^T)[l]
#pragma unroll
  for (int i = 0; i < Tn::TR; ++i) {
    const float e = expf(cum[t.row(i)]);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= e;
  }
  t.mac(acc, Wt, L, Bn, N, 0, t.row_max() + 1);  // + sum_{m <= l} W[l][m] B_m
#pragma unroll
  for (int i = 0; i < Tn::TR; ++i) {
    const int s = k.s0 + t.row(i);
    if (s < p.S) store4(p.dc_h + (k.row(p, s) * p.H + k.h) * N + t.col0(), acc[i]);
  }
  __syncthreads();  // h_in^T is read no more
  load_state<N, P, true>(Hs, p.g + k.slot(p) * N * P);
  __syncthreads();
  zero<L, N, NT>(acc);
  t.mac(acc, Xt, L, Hs, N, 0, P);  // (x g^T)[m]
#pragma unroll
  for (int i = 0; i < Tn::TR; ++i) {
    const int m = t.row(i);
    const float f = dtl[m] * expf(cum[L - 1] - cum[m]);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= f;
  }
  t.mac(acc, Ws, L, Cn, N, t.row(0), L);  // + sum_{l >= m} W[l][m] C_l
#pragma unroll
  for (int i = 0; i < Tn::TR; ++i) {
    const int s = k.s0 + t.row(i);
    if (s < p.S) store4(p.db_h + (k.row(p, s) * p.H + k.h) * N + t.col0(), acc[i]);
  }
}

// ---- 5: dB and dC of each group, its heads added in head order -------------------------------
constexpr int NT_SUM = 256;

template <typename T, int N>
__global__ void __launch_bounds__(NT_SUM) ssd_bwd_group_sum(const Params p) {
  const long long i = static_cast<long long>(blockIdx.x) * NT_SUM + threadIdx.x;  // a float4 of (B, S, G, N)
  if (i >= static_cast<long long>(p.B) * p.S * p.G * (N / 4)) return;
  const int n = static_cast<int>(i % (N / 4)) * 4, g = static_cast<int>(i / (N / 4) % p.G);
  const long long bs = i / (N / 4) / p.G;  // b * S + s
  const int rep = p.H / p.G;
  float db[4] = {0.f, 0.f, 0.f, 0.f}, dc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < rep; ++j) {
    const long long off = (bs * p.H + g * rep + j) * N + n;
    float v[4];
    load16(p.db_h + off, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) db[e] += v[e];
    load16(p.dc_h + off, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) dc[e] += v[e];
  }
  const long long o = (bs * p.G + g) * N + n;
  store4(static_cast<T*>(p.db) + o, db);
  store4(static_cast<T*>(p.dc) + o, dc);
}

// ---- 6: da per head, over batch rows and chunks in a fixed order ------------------------------
__global__ void __launch_bounds__(32) ssd_bwd_da(const Params p) {
  const int h = blockIdx.x, lane = threadIdx.x;
  float s = 0.f;
  for (int i = lane; i < p.B * p.nc; i += 32)
    s += p.da_part[(static_cast<long long>(i / p.nc) * p.H + h) * p.nc + i % p.nc];
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) p.da[h] = s;
}

// ---- launches --------------------------------------------------------------------------------
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, const Params& p,
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
  static_assert(smem_dx<N, P>() <= SMEM_MAX && smem_dbc<N, P>() <= SMEM_MAX, "shared memory");
  const dim3 chunks(p.nc, p.B * p.H);
  cudaError_t err = launch(ssd_bwd_chunk_grad<T, N, P>, chunks, nt_state(N, P),
                           smem_chunk_grad<N, P>(), p, stream);
  if (err == cudaSuccess)
    err = launch(ssd_bwd_state_pass<N, P>, dim3((N * P / 4 + NT_PASS - 1) / NT_PASS, p.B * p.H),
                 NT_PASS, 0, p, stream);
  if (err == cudaSuccess) err = launch(ssd_bwd_dx<T, N, P>, chunks, NT, smem_dx<N, P>(), p, stream);
  if (err == cudaSuccess) err = launch(ssd_bwd_dbc<T, N, P>, chunks, NT, smem_dbc<N, P>(), p, stream);
  if (err == cudaSuccess) {
    const long long sums = static_cast<long long>(p.B) * p.S * p.G * (N / 4);
    err = launch(ssd_bwd_group_sum<T, N>, dim3(static_cast<unsigned>((sums + NT_SUM - 1) / NT_SUM)),
                 NT_SUM, 0, p, stream);
  }
  if (err == cudaSuccess) err = launch(ssd_bwd_da, dim3(p.H), 32, 0, p, stream);
  return err;
}

template <typename T, int N>
cudaError_t dispatch_p(const Params& p, int P, cudaStream_t stream) {
  switch (P) {
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

// ptrs[14]: x, dt, a, b, c, dy, dstate (0: zero), the forward's scratch (the
// states entering each chunk, B*H*nc*N*P floats, then each chunk's decay,
// B*H*nc), this call's scratch (B*H*nc*N*P + 2*B*S*H*N + B*H*nc floats),
// dx, ddt, da, db, dc.  x (B,S,H,P), dt (B,S,H) f32, a (H,) f32, b/c
// (B,S,G,N), dy (B,S,H,P) read through strides[15] = (batch, seq,
// head|group) element strides of x, dt, b, c, dy, with the last dim
// contiguous and rows 16-byte aligned; dstate (B,H,P,N) f32, dx (B,S,H,P),
// ddt (B,S,H) f32, db/dc (B,S,G,N) contiguous.  dtype (of x, b, c, dy, dx,
// db, dc): 0 = float32, 1 = bfloat16.  P and N in {16, 32, 64, 128}.
// Returns the first launch's cudaGetLastError() that is not 0, else 0.
extern "C" int ssd_scan_bwd(const long long* ptrs, const long long* strides, int dtype, int B,
                            int S, int H, int G, int P, int N, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (S + L - 1) / L;
  const long long states = static_cast<long long>(B) * H * nc * N * P;
  const long long per_head = static_cast<long long>(B) * S * H * N;
  const auto ptr = [&](int i) { return reinterpret_cast<void*>(ptrs[i]); };
  float* fwd = static_cast<float*>(ptr(7));
  float* bwd = static_cast<float*>(ptr(8));
  Params p{ptr(0), static_cast<const float*>(ptr(1)), static_cast<const float*>(ptr(2)), ptr(3),
           ptr(4), ptr(5), static_cast<const float*>(ptr(6)), fwd, fwd + states, bwd,
           bwd + states, bwd + states + per_head, bwd + states + 2 * per_head, ptr(9),
           static_cast<float*>(ptr(10)), static_cast<float*>(ptr(11)), ptr(12), ptr(13),
           B, S, H, G, nc, {}, {}, {}, {}, {}};
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
