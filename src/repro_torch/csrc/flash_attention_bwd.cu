// Flash attention backward for Hopper (sm_90a), with a plain C interface.
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
// gradients per token.  These kernels recompute Q K^T and dO V^T in both
// passes (14 * hd flops per pair) and run on the CUDA cores in f32 (SIMT),
// so they are held by the f32 FMA rate, far from the tensor cores' bound:
// the simple design, right first; `wgmma`/TMA is a later redesign.
//
// The design, FlashAttention-2 style, three launches on one stream:
//   1. `flash_bwd_delta`: one warp per (batch, query, head) row computes
//      D = sum(dO * O) in f32 into a (B, H, S) scratch array.
//   2. `flash_bwd_dkdv`: one block per (key tile, batch * KV group).  The
//      block keeps its K and V tiles and its dK and dV accumulators (f32
//      registers) and walks, for each query head of its group in turn, the
//      query tiles its keys are visible to under the causal and window
//      masks.  GQA's sum over a group's heads is this loop: deterministic,
//      no atomics.
//   3. `flash_bwd_dq`: one block per (query tile, batch * head), which keeps
//      its Q, dO and dQ and walks the key tiles visible to it.
//   Tiles are BM rows (64; 32 at head_dim 256, whose 1 KB f32 rows would not
//   fit four 64-row tiles in shared memory).  Every tile is converted to
//   f32 in shared memory with rows padded to HD + 1 floats, so the block's
//   16 x 16 (scores) and (256 / TN) x TN (gradients) thread grids read
//   free of bank conflicts; each thread accumulates a register micro-tile.
//   Rows past S or T load as zeros and are masked; a row whose lse is +inf
//   (no valid key) gets p = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block, every kernel
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // (B, H, S), natural log
  float* delta;      // (B, H, S) scratch
  void *dq, *dk, *dv;
  // (batch, sequence, head) element strides of q, k, v, o, dO, dq, dk, dv
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  int B, S, T, H, G, causal, window;
  float scale, scale_log2;
};

template <int HD>
struct Cfg {
  static constexpr int BM = HD <= 128 ? 64 : 32;  // rows of a query tile and of a key tile
  static constexpr int LD = HD + 1;               // padded f32 row of a tile in shared memory
  static constexpr int LP = BM + 1;               // padded row of the P and dS tiles
  static constexpr int SR = BM / 16;              // score rows and columns per thread (16 x 16 grid)
  static constexpr int TN = HD < 32 ? HD : 32;    // gradient tiles: TM x TN thread grid
  static constexpr int TM = NT / TN;
  static constexpr int AR = BM / TM, AC = HD / TN;  // gradient rows and columns per thread
  static constexpr int SMEM = (4 * BM * LD + 2 * BM * LP + 2 * BM) * 4;
  static_assert(TM * TN == NT && AR * TM == BM && AC * TN == HD, "thread grid");
  static_assert(SMEM <= 232448, "the tiles do not fit a block's shared memory");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows r0 .. r0 + BM of an (n, HD) slice with row stride rs, to f32 rows of
// HD + 1 floats; rows at or past n are zeros.
template <typename T, int HD, int BM>
__device__ __forceinline__ void load_tile(float* dst, const T* base, long long rs, int r0, int n) {
  for (int e = threadIdx.x; e < BM * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    dst[r * (HD + 1) + d] = r0 + r < n ? to_f(base[static_cast<long long>(r0 + r) * rs + d]) : 0.f;
  }
}

// acc[i][j] += sum_k A(ty + TM*i, k) * B(k, tx + TN*j), with A(r, k) at
// a[r*ar + k*ak] and B(k, c) at b[k*bk + c*bc], all in shared memory.
template <int R, int C, int K, int TM, int TN>
__device__ __forceinline__ void gemm_tile(float (&acc)[R][C], const float* a, int ar, int ak,
                                          const float* b, int bk, int bc, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[R], bv[C];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a[(ty + TM * i) * ar + k * ak];
#pragma unroll
    for (int j = 0; j < C; ++j) bv[j] = b[k * bk + (tx + TN * j) * bc];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  return i < p.S && j < p.T && (!p.causal || j <= i) && (p.window <= 0 || j > i - p.window);
}

// S = Q K^T and dP = dO V^T on the block's (query tile, key tile), then
// P and dS = P o (dP - D) into shared memory (rows: queries i0.., columns:
// keys j0..).
template <int HD>
__device__ __forceinline__ void scores(const Params& p, const float* sQ, const float* sK,
                                       const float* sdO, const float* sV, const float* sL,
                                       const float* sD, float* sP, float* sdS, int i0, int j0) {
  using C = Cfg<HD>;
  constexpr int SR = C::SR, LD = C::LD, LP = C::LP;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[SR][SR], dp[SR][SR];
#pragma unroll
  for (int a = 0; a < SR; ++a)
#pragma unroll
    for (int c = 0; c < SR; ++c) s[a][c] = dp[a][c] = 0.f;
  gemm_tile<SR, SR, HD, 16, 16>(s, sQ, LD, 1, sK, 1, LD, ty, tx);
  gemm_tile<SR, SR, HD, 16, 16>(dp, sdO, LD, 1, sV, 1, LD, ty, tx);
#pragma unroll
  for (int a = 0; a < SR; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int c = 0; c < SR; ++c) {
      const int col = tx + 16 * c;
      const float pv = visible(p, i0 + r, j0 + col)
                           ? exp2f(s[a][c] * p.scale_log2 - sL[r] * LOG2E) : 0.f;
      if (sP != nullptr) sP[r * LP + col] = pv;
      sdS[r * LP + col] = pv * (dp[a][c] - sD[r]);
    }
  }
}

// Rows i0 .. i0 + BM of lse and D for (b, h); rows past S are 0 (masked).
template <int BM>
__device__ __forceinline__ void load_rows(const Params& p, float* sL, float* sD, int b, int h,
                                          int i0) {
  const long long base = (static_cast<long long>(b) * p.H + h) * p.S;
  for (int e = threadIdx.x; e < BM; e += NT) {
    const int i = i0 + e;
    sL[e] = i < p.S ? p.lse[base + i] : 0.f;
    sD[e] = i < p.S ? p.delta[base + i] : 0.f;
  }
}

// Writes a BM x HD f32 accumulator (rows r0.., times `mul`) to rows below n.
template <typename T, int HD>
__device__ __forceinline__ void store_acc(const float (&acc)[Cfg<HD>::AR][Cfg<HD>::AC], T* base,
                                          long long rs, int r0, int n, float mul) {
  using C = Cfg<HD>;
  const int ty = threadIdx.x / C::TN, tx = threadIdx.x % C::TN;
#pragma unroll
  for (int a = 0; a < C::AR; ++a) {
    const int r = r0 + ty + C::TM * a;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < C::AC; ++c)
      base[static_cast<long long>(r) * rs + tx + C::TN * c] = from_f<T>(acc[a][c] * mul);
  }
}

// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_delta(const __grid_constant__ Params p) {
  const long long row = static_cast<long long>(blockIdx.x) * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(p.B) * p.S * p.H) return;
  const int h = static_cast<int>(row % p.H);
  const int s = static_cast<int>(row / p.H % p.S);
  const int b = static_cast<int>(row / p.H / p.S);
  const T* o = static_cast<const T*>(p.o) + b * p.os[0] + s * p.os[1] + h * p.os[2];
  const T* g = static_cast<const T*>(p.dout) + b * p.dos[0] + s * p.dos[1] + h * p.dos[2];
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc = fmaf(to_f(o[d]), to_f(g[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) p.delta[(static_cast<long long>(b) * p.H + h) * p.S + s] = acc;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv(const __grid_constant__ Params p) {
  using C = Cfg<HD>;
  constexpr int BM = C::BM, LD = C::LD, LP = C::LP;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BM * LD;
  float* sQ = sV + BM * LD;
  float* sdO = sQ + BM * LD;
  float* sP = sdO + BM * LD;
  float* sdS = sP + BM * LP;
  float* sL = sdS + BM * LP;
  float* sD = sL + BM;
  const int k0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.G, g = blockIdx.y % p.G;
  const int ty = threadIdx.x / C::TN, tx = threadIdx.x % C::TN;
  load_tile<T, HD, BM>(sK, static_cast<const T*>(p.k) + b * p.ks[0] + g * p.ks[2], p.ks[1], k0, p.T);
  load_tile<T, HD, BM>(sV, static_cast<const T*>(p.v) + b * p.vs[0] + g * p.vs[2], p.vs[1], k0, p.T);
  float dk[C::AR][C::AC], dv[C::AR][C::AC];
#pragma unroll
  for (int a = 0; a < C::AR; ++a)
#pragma unroll
    for (int c = 0; c < C::AC; ++c) dk[a][c] = dv[a][c] = 0.f;
  // the queries that see a key of this tile: i >= j (causal), i < j + window
  const int i_begin = p.causal ? k0 / BM * BM : 0;
  const int i_end = p.window > 0 ? min(p.S, min(k0 + BM, p.T) - 1 + p.window) : p.S;
  const int rep = p.H / p.G;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = g * rep + hh;
    const T* qb = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
    const T* gb = static_cast<const T*>(p.dout) + b * p.dos[0] + h * p.dos[2];
    for (int i0 = i_begin; i0 < i_end; i0 += BM) {
      __syncthreads();  // the last tile's readers are done
      load_tile<T, HD, BM>(sQ, qb, p.qs[1], i0, p.S);
      load_tile<T, HD, BM>(sdO, gb, p.dos[1], i0, p.S);
      load_rows<BM>(p, sL, sD, b, h, i0);
      __syncthreads();
      scores<HD>(p, sQ, sK, sdO, sV, sL, sD, sP, sdS, i0, k0);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: rows are keys, the sum runs over queries
      gemm_tile<C::AR, C::AC, BM, C::TM, C::TN>(dv, sP, 1, LP, sdO, LD, 1, ty, tx);
      gemm_tile<C::AR, C::AC, BM, C::TM, C::TN>(dk, sdS, 1, LP, sQ, LD, 1, ty, tx);
    }
  }
  store_acc<T, HD>(dk, static_cast<T*>(p.dk) + b * p.dks[0] + g * p.dks[2], p.dks[1], k0, p.T,
                   p.scale);
  store_acc<T, HD>(dv, static_cast<T*>(p.dv) + b * p.dvs[0] + g * p.dvs[2], p.dvs[1], k0, p.T,
                   1.f);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dq(const __grid_constant__ Params p) {
  using C = Cfg<HD>;
  constexpr int BM = C::BM, LD = C::LD, LP = C::LP;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BM * LD;
  float* sK = sdO + BM * LD;
  float* sV = sK + BM * LD;
  float* sdS = sV + BM * LD;
  float* sL = sdS + 2 * BM * LP;
  float* sD = sL + BM;
  const int i0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int g = h / (p.H / p.G);
  const int ty = threadIdx.x / C::TN, tx = threadIdx.x % C::TN;
  load_tile<T, HD, BM>(sQ, static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2], p.qs[1], i0, p.S);
  load_tile<T, HD, BM>(sdO, static_cast<const T*>(p.dout) + b * p.dos[0] + h * p.dos[2], p.dos[1],
                       i0, p.S);
  load_rows<BM>(p, sL, sD, b, h, i0);
  float dq[C::AR][C::AC];
#pragma unroll
  for (int a = 0; a < C::AR; ++a)
#pragma unroll
    for (int c = 0; c < C::AC; ++c) dq[a][c] = 0.f;
  // the keys this tile's queries see: j <= i (causal), j > i - window
  const int j_begin = p.window > 0 ? max(0, i0 - p.window + 1) / BM * BM : 0;
  const int j_end = p.causal ? min(p.T, min(i0 + BM, p.S)) : p.T;
  const T* kb = static_cast<const T*>(p.k) + b * p.ks[0] + g * p.ks[2];
  const T* vb = static_cast<const T*>(p.v) + b * p.vs[0] + g * p.vs[2];
  for (int j0 = j_begin; j0 < j_end; j0 += BM) {
    __syncthreads();  // the last tile's readers are done
    load_tile<T, HD, BM>(sK, kb, p.ks[1], j0, p.T);
    load_tile<T, HD, BM>(sV, vb, p.vs[1], j0, p.T);
    __syncthreads();
    scores<HD>(p, sQ, sK, sdO, sV, sL, sD, nullptr, sdS, i0, j0);
    __syncthreads();
    // dQ += dS K: rows are queries, the sum runs over keys
    gemm_tile<C::AR, C::AC, BM, C::TM, C::TN>(dq, sdS, LP, 1, sK, LD, 1, ty, tx);
  }
  store_acc<T, HD>(dq, static_cast<T*>(p.dq) + b * p.dqs[0] + h * p.dqs[2], p.dqs[1], i0, p.S,
                   p.scale);
}

// ---------------------------------------------------------------------------
// host

template <typename T, int HD>
int launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<HD>;
  // once per kernel: the attribute holds for every later launch
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const long long rows = static_cast<long long>(p.B) * p.S * p.H;
  flash_bwd_delta<T, HD><<<static_cast<unsigned>((rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<T, HD><<<dim3((p.T + C::BM - 1) / C::BM, p.B * p.G), NT, C::SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<T, HD><<<dim3((p.S + C::BM - 1) / C::BM, p.B * p.H), NT, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 96: return launch<T, 96>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ptrs[10] = q, k, v, o, dO (B,S,H,hd or B,T,G,hd, last dim contiguous),
// lse (f32 (B,H,S) from the forward), delta (f32 (B,H,S) scratch), dq, dk,
// dv (the layouts of q, k, v); strides[24] = (batch, seq, head) element
// strides of q, k, v, o, dO, dq, dk, dv.  dtype: 0 = float32, 1 = bfloat16
// (every tensor but lse and delta).  Returns 0 on success, else the CUDA
// error of a launch.
extern "C" int flash_attention_bwd(const long long* ptrs, const long long* strides, int dtype,
                                   int B, int S, int T, int H, int G, int hd, int causal,
                                   int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || G <= 0 || H % G != 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = reinterpret_cast<const void*>(ptrs[0]);
  p.k = reinterpret_cast<const void*>(ptrs[1]);
  p.v = reinterpret_cast<const void*>(ptrs[2]);
  p.o = reinterpret_cast<const void*>(ptrs[3]);
  p.dout = reinterpret_cast<const void*>(ptrs[4]);
  p.lse = reinterpret_cast<const float*>(ptrs[5]);
  p.delta = reinterpret_cast<float*>(ptrs[6]);
  p.dq = reinterpret_cast<void*>(ptrs[7]);
  p.dk = reinterpret_cast<void*>(ptrs[8]);
  p.dv = reinterpret_cast<void*>(ptrs[9]);
  long long* dst[8] = {p.qs, p.ks, p.vs, p.os, p.dos, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.B = B;
  p.S = S;
  p.T = T;
  p.H = H;
  p.G = G;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0   ? dispatch_hd<float>(p, hd, st)
         : dtype == 1 ? dispatch_hd<__nv_bfloat16>(p, hd, st)
                      : static_cast<int>(cudaErrorInvalidValue);
}
