// Mamba2 SSD chunked scan for Hopper (sm_90a), with a plain C interface.
//
// Replaces the JAX package's Pallas TPU kernel `kernels/ssd_scan.py`
// (`ssd_scan`, body `_ssd_kernel`).  For each (batch, head) it walks the
// sequence in chunks of L tokens, carrying the f32 state h (N x P):
//   da = dt * a, cum = inclusive cumsum(da) over the chunk
//   y  = ((C B^T) o decay) (x * dt) + exp(cum) o (C h),
//        decay[l, m] = exp(cum_l - cum_m) for l >= m, else 0
//   h <- exp(cum_{L-1}) h + B^T (x * dt * exp(cum_{L-1} - cum))
// and emits y in x's dtype and the final state as f32 (B, H, P, N).
//
// What bounds it on the H100.  Per (batch, head) the chunked dual form does
// 2*S*(L*(N+P) + 2*N*P) flops against (2*P + 1)*S elements of x, dt and y
// (B and C are shared by the heads of a group).  The function itself needs
// only the sequential recurrence's 4*S*N*P flops, which at N = 128 in f32
// still take longer than the bytes.  The products run in f32 on the CUDA cores (67 TFLOP/s), with
// operands from shared memory; the shared-memory load rate is the limit this
// simple design reaches first.
//
// What the design does about it.
//   * Hopper blocks run in no order, so the chunk loop lives inside one
//     block.  A block owns one (batch*head) and a slice of PB = 32 state
//     columns (16 when P = 16): the columns of h are independent, so the
//     grid is (B*H, P/PB), 192 blocks at mamba2-130m's P = 64, two of them
//     resident per SM.  Both slices of a head recompute the L x L scores.
//   * Per chunk, B, C, x*dt and the scores sit in shared memory as f32 (B and
//     C rows padded by one float so strided reads hit distinct banks); the
//     state lives in registers, thread (ty, tx) owning rows ty+16i and
//     columns tx+16j, and is mirrored into shared memory once per chunk for
//     the C h product.  Only x, dt, B, C are read and only y and the final
//     state are written: the L x L scores never reach device memory.
//   * Score tiles wholly above the diagonal are skipped, and exp is taken
//     only under l >= m: above the diagonal cum_l - cum_m > 0 can overflow,
//     and inf * 0 would be NaN.
//   * Model layout through strides: x (B,S,H,P), dt (B,S,H), B/C (B,S,G,N),
//     head h reading group h / (H/G); nothing is folded, repeated or
//     transposed in memory, and the state is written directly as (B,H,P,N).
//   * Any S: rows past S load as dt = 0, x = B = C = 0 (decay 1, no update,
//     so the state is unchanged) and are never written.
// wgmma/TMA and a warp-specialised producer are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int L = 64;    // chunk length, the kernel's own choice
constexpr int NT = 256;  // threads per block, as 16 x 16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  void* y;
  float* state;
  int S, H, G, P;
  // element strides of (batch, sequence, head or group) for x, dt, b, c, y;
  // the last dim of x, b, c, y is contiguous, the state is contiguous
  long long xs[3], dts[3], bs[3], cs[3], ys[3];
};

template <int N, int PB>
constexpr int smem_floats() {
  return 2 * L * (N + 1) + L * PB + L * (L + 1) + N * (PB + 1) + 4 * L;
}

template <typename T, int N, int PB>
__global__ void __launch_bounds__(NT, 2) ssd_scan_kernel(const Params p) {
  constexpr int NI = N / 16;   // state rows per thread
  constexpr int PJ = PB / 16;  // state / output columns per thread
  extern __shared__ float smem[];
  float* Bs = smem;                // L x (N+1)
  float* Cs = Bs + L * (N + 1);    // L x (N+1)
  float* Xs = Cs + L * (N + 1);    // L x PB: x * dt
  float* Gs = Xs + L * PB;         // L x (L+1): (C B^T) o decay
  float* Hs = Gs + L * (L + 1);    // N x (PB+1): the carried state
  float* cum = Hs + N * (PB + 1);  // L: inclusive cumsum of dt * a
  float* ecum = cum + L;           // L: exp(cum)
  float* dend = ecum + L;          // L: exp(cum[L-1] - cum)
  float* dtl = dend + L;           // L: dt

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int bi = bh / p.H, h = bh % p.H;
  const int g = h / (p.H / p.G);
  const int p0 = blockIdx.y * PB;
  const float a = p.a[h];

  const T* xg = static_cast<const T*>(p.x) + bi * p.xs[0] + h * p.xs[2] + p0;
  const float* dtg = p.dt + bi * p.dts[0] + h * p.dts[2];
  const T* bg = static_cast<const T*>(p.b) + bi * p.bs[0] + g * p.bs[2];
  const T* cg = static_cast<const T*>(p.c) + bi * p.cs[0] + g * p.cs[2];
  T* yg = static_cast<T*>(p.y) + bi * p.ys[0] + h * p.ys[2] + p0;

  float hreg[NI][PJ];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) hreg[i][j] = 0.f;
  for (int i = tid; i < N * (PB + 1); i += NT) Hs[i] = 0.f;

  const int n_chunks = (p.S + L - 1) / L;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s0 = ch * L;
    // Every reader of the previous chunk's tiles passed the barrier before
    // the state write below, so the tiles can be refilled without another.
    if (tid < 32) {  // warp 0: dt and the chunk's cumsum; lane k owns rows 2k, 2k+1
      const int l0 = 2 * tid;
      const float d0 = s0 + l0 < p.S ? dtg[(s0 + l0) * p.dts[1]] : 0.f;
      const float d1 = s0 + l0 + 1 < p.S ? dtg[(s0 + l0 + 1) * p.dts[1]] : 0.f;
      const float v0 = d0 * a;
      float inc = v0 + d1 * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, inc, off);
        if (tid >= off) inc += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, inc, 1);
      if (tid == 0) excl = 0.f;
      const float last = __shfl_sync(0xffffffffu, inc, 31);
      const float c0 = excl + v0, c1 = inc;
      cum[l0] = c0;
      cum[l0 + 1] = c1;
      ecum[l0] = expf(c0);
      ecum[l0 + 1] = expf(c1);
      dend[l0] = expf(last - c0);
      dend[l0 + 1] = expf(last - c1);
      dtl[l0] = d0;
      dtl[l0 + 1] = d1;
    }
    for (int i = tid; i < L * N; i += NT) {
      const int l = i / N, n = i % N, s = s0 + l;
      const bool in = s < p.S;
      Bs[l * (N + 1) + n] = in ? to_f32(bg[s * p.bs[1] + n]) : 0.f;
      Cs[l * (N + 1) + n] = in ? to_f32(cg[s * p.cs[1] + n]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < L * PB; i += NT) {
      const int l = i / PB, q = i % PB, s = s0 + l;
      Xs[i] = s < p.S ? to_f32(xg[s * p.xs[1] + q]) * dtl[l] : 0.f;
    }

    // scores: Gs[l][m] = (C_l . B_m) exp(cum_l - cum_m) for l >= m, else 0
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * (N + 1) + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * (N + 1) + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int l = ty + 16 * i, m = tx + 16 * j;
          Gs[l * (L + 1) + m] = (j <= i && l >= m) ? acc[i][j] * expf(cum[l] - cum[m]) : 0.f;
        }
    }
    __syncthreads();

    // y = exp(cum) o (C h) + Gs (x * dt), rows ty+16i, columns tx+16j
    {
      float acc[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * (N + 1) + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) hv[j] = Hs[n * (PB + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = ecum[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] *= e;
      }
#pragma unroll 4
      for (int m = 0; m < L; ++m) {
        float gv[4], xv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = Gs[(ty + 16 * i) * (L + 1) + m];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = Xs[m * PB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + ty + 16 * i;
        if (s >= p.S) continue;  // padded rows are dropped
#pragma unroll
        for (int j = 0; j < PJ; ++j) yg[s * p.ys[1] + tx + 16 * j] = from_f32<T>(acc[i][j]);
      }
    }

    // state: h <- exp(cum[L-1]) h + B^T (x * dt * dend), rows ty+16i, columns tx+16j
    {
      const float chunk_decay = ecum[L - 1];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) hreg[i][j] *= chunk_decay;
#pragma unroll 4
      for (int l = 0; l < L; ++l) {
        const float de = dend[l];
        float bv[NI], xv[PJ];
#pragma unroll
        for (int i = 0; i < NI; ++i) bv[i] = Bs[l * (N + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = Xs[l * PB + tx + 16 * j] * de;
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) hreg[i][j] = fmaf(bv[i], xv[j], hreg[i][j]);
      }
    }
    __syncthreads();  // every reader of the old state (the y pass) is done
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) Hs[(ty + 16 * i) * (PB + 1) + tx + 16 * j] = hreg[i][j];
  }
  __syncthreads();

  // final state (B, H, P, N), n contiguous
  float* sg = p.state + (static_cast<long long>(bh) * p.P + p0) * N;
  for (int i = tid; i < PB * N; i += NT) {
    const int q = i / N, n = i % N;
    sg[q * N + n] = Hs[n * (PB + 1) + q];
  }
}

template <typename T, int N, int PB>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = smem_floats<N, PB>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, N, PB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, p.P / PB);
  ssd_scan_kernel<T, N, PB><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t dispatch_p(const Params& p, int B, cudaStream_t stream) {
  switch (p.P) {
    case 16: return launch<T, N, 16>(p, B, stream);
    case 32:
    case 64:
    case 128: return launch<T, N, 32>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_n(const Params& p, int B, int N, cudaStream_t stream) {
  switch (N) {
    case 16: return dispatch_p<T, 16>(p, B, stream);
    case 32: return dispatch_p<T, 32>(p, B, stream);
    case 64: return dispatch_p<T, 64>(p, B, stream);
    case 128: return dispatch_p<T, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B,S,H,P), dt (B,S,H) f32, a (H,) f32, b/c (B,S,G,N), y (B,S,H,P), with
// the last dim of x, b, c, y contiguous; state (B,H,P,N) f32, contiguous.
// strides[15] = (batch, seq, head|group) element strides of x, dt, b, c, y.
// dtype (of x, b, c, y): 0 = float32, 1 = bfloat16.  P and N in
// {16, 32, 64, 128}.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* a, const void* b,
                            const void* c, void* y, float* state, int dtype, int B, int S,
                            int H, int G, int P, int N, const long long* strides,
                            void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, dt, a, b, c, y, state, S, H, G, P, {}, {}, {}, {}, {}};
  for (int i = 0; i < 3; ++i) {
    p.xs[i] = strides[i];
    p.dts[i] = strides[3 + i];
    p.bs[i] = strides[6 + i];
    p.cs[i] = strides[9 + i];
    p.ys[i] = strides[12 + i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? dispatch_n<float>(p, B, N, st)
                    : dtype == 1 ? dispatch_n<__nv_bfloat16>(p, B, N, st)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
