// Flash attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the JAX package's Pallas TPU kernel `kernels/flash_attention.py`
// (`flash_attention`, body `_flash_kernel`): blockwise online-softmax
// attention with f32 running max / denominator / accumulator, causal,
// sliding-window and key-length masks, fully masked tiles skipped, and one
// cast on the write.
//
// What bounds it on the H100.  Products are done in f32 on the CUDA cores
// (67 TFLOP/s), not on the tensor cores, so at prefill lengths the kernel is
// bound by operations: 4*hd flops per (query, key) pair against 2*hd*(bytes
// per element) bytes of q/k/v/o per token.  Within the block, each f32 FMA
// needs its operands from shared memory, so the shared-memory load rate is
// the limit this simple design reaches first.
//
// What the design does about it.
//   * One block per (64-query tile, batch*head); it loops over 64-key tiles
//     staged in shared memory as f32, and keeps m, l and the (64 x hd)
//     accumulator in registers: the (S x T) score matrix never reaches
//     device memory, and q/k/v are read once per query tile.
//   * 256 threads as 16 x 16: thread (ty, tx) owns rows ty+16i (i < 4) of
//     both the score tile (columns tx+16j, j < 4) and the output tile
//     (columns tx+16j, j < hd/16), so the online-softmax rescale of a row
//     never leaves the thread; row max and sum reduce over the 16 lanes of
//     a half-warp with shuffles.  Q and K rows are padded by one float so
//     the strided reads hit distinct banks.
//   * Tiles above the causal diagonal or left of the window are never
//     loaded; q tiles are scheduled heaviest (latest) first.
//   * GQA: head h reads K/V group h / (H/G) through strides; nothing is
//     repeated in memory.  Any S and T: rows past S and keys past T are
//     loaded as zeros, masked, and never written.
//   * A masked score is -inf and the running max starts at -1e30, so a row
//     with no valid key yet keeps p = 0, alpha = 1 and never produces NaN.
// wgmma/TMA and bf16 tensor-core products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block, as 16 x 16
constexpr float M_FLOOR = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, H, G, causal, window;
  float scale;
  // element strides of (batch, sequence, head) for q, k, v, o; hd is contiguous
  long long qs[3], ks[3], vs[3], os[3];
};

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 2) flash_fwd_kernel(const Params p) {
  constexpr int NJ = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // BQ x (HD+1)
  float* Ks = Qs + BQ * (HD + 1);     // BK x (HD+1)
  float* Vs = Ks + BK * (HD + 1);     // BK x HD
  float* Ps = Vs + BK * HD;           // BQ x (BK+1)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int g = h / (p.H / p.G);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + g * p.ks[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + g * p.vs[2];
  T* og = static_cast<T*>(p.o) + b * p.os[0] + h * p.os[2];

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    Qs[r * (HD + 1) + d] = qi < p.S ? to_f32(qg[qi * p.qs[1] + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = M_FLOOR;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int k_end = p.T;
  if (p.causal) k_end = min(k_end, q0 + BQ);
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers of Ks/Vs/Ps are done
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, kj = k0 + r;
      const bool in = kj < p.T;
      Ks[r * (HD + 1) + d] = in ? to_f32(kg[kj * p.ks[1] + d]) : 0.f;
      Vs[r * HD + d] = in ? to_f32(vg[kj * p.vs[1] + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = M_FLOOR;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < p.T && (!p.causal || kj <= qi) &&
                        (p.window <= 0 || kj > qi - p.window);
        s[i][j] = ok ? s[i][j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = expf(s[i][j] - m_new);  // exactly 0 where masked
        rs += pij;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = pij;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.S) continue;  // padded query rows are dropped
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      og[qi * p.os[1] + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, (p.S + BQ - 1) / BQ);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,S,H,hd), k/v (B,T,G,hd), o (B,S,H,hd) with the last dim contiguous;
// strides[12] = (batch, seq, head) element strides of q, k, v, o.
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int S, int T, int H, int G, int hd,
                                   const long long* strides, int causal, int window,
                                   float scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || G <= 0 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, S, T, H, G, causal, window, scale, {}, {}, {}, {}};
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? dispatch_hd<float>(p, B, hd, st)
                    : dtype == 1 ? dispatch_hd<__nv_bfloat16>(p, B, hd, st)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
