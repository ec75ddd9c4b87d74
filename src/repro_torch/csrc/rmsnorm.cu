// Fused RMSNorm for Hopper (sm_90a), with a plain C interface.
//
// Replaces the JAX package's Pallas TPU kernel `kernels/rmsnorm.py`
// (`rmsnorm`): per row, the f32 mean of squares, then
// x * rsqrt(mean + eps) * (1 + w) in f32 and one cast on the write.
//
// What bounds it on the H100: device-memory bytes.  It does a handful of
// flops per element against one read of x and one write of the output (w is
// read by every row, so it stays in L1/L2).
//
// The design.
//   * A row of up to 2 vectors per thread: TPR threads per row (32, 64, 128
//     or 256, the fewest that hold it), 256 threads per block.  Each thread
//     reads its part of the row once into registers (16-byte loads, all in
//     flight before the first use), the sum of squares reduces over the warp
//     with shuffles and across the row's warps through shared memory, and
//     the normalised row is written from those registers: each byte moves
//     once, and a thread holds at most 16 floats, so the SM keeps 2048
//     threads (8 to 64 rows) in flight.  (4 vectors per thread, and a
//     persistent grid, measured slower on the H100.)
//   * Wider rows: one block of 256 threads per row, which reads the row
//     twice (the second read hits L1/L2).
//   * 16-byte loads and stores where the pointers, the row strides and the
//     row width allow them; element by element otherwise.
//   * x and the output in f32 or bf16; w in f32 or bf16, independently (the
//     models keep f32 weights under a bf16 compute dtype).
// A decode step launches it on a few rows, where the host's launch path is
// the cost: the C entry takes one argument block and only picks an instance
// and launches.
//
// The backward (`rmsnorm_bwd`, training): with r = rsqrt(mean(x^2) + eps)
// and u = g * (1 + w) for the output's gradient g,
//   dx = r * u - x * r^3 * mean(u * x),   dw = sum over rows of g * x * r.
// Also bound by bytes: x and g read once, dx written once.  The forward's
// register-held design, with one wave of blocks (the SMs times the blocks
// an SM holds at the kernel's registers) walking the rows with a grid
// stride:
//   * `rmsnorm_bwd_rows_kernel`: TPR threads per row (the fewest that hold
//     it at up to 2 vectors of 16 bytes each of x and g), several rows per
//     block of 256 threads.  All loads of a row are in flight before the
//     first use; both row sums reduce over the row's warps (one
//     __syncthreads per row, the partial sums double-buffered); dx is
//     written from the registers.  A thread always owns the same columns,
//     so its (1 + w) and its dw partial sums stay in registers across the
//     loop, and each block writes its column sums once to a (parts, d)
//     scratch.
//   * `rmsnorm_bwd_wide_kernel`, rows wider than that: a block per row at a
//     time, x and g read twice (the second read hits L1/L2), the column
//     sums in shared memory.
//   * 16-byte loads where the pointers, the row strides and d allow them;
//     element by element otherwise.
//   * `rmsnorm_bwd_dw` adds the scratch up per column in a fixed order, so
//     dw is the same bit for bit on every call (no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // threads per block, every kernel
constexpr int NV = 2;         // vectors per thread in the register-held kernel

__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 two = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&two);
}

// N consecutive elements as f32: N = 4 or 8 f32 by float4, 8 bf16 by one
// 16-byte load, 4 bf16 by one 8-byte load, N = 1 element by element.
template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = f.x;
      out[4 * i + 1] = f.y;
      out[4 * i + 2] = f.z;
      out[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p, float* out) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      unpack_bf16x2(u.x, out + 8 * i);
      unpack_bf16x2(u.y, out + 8 * i + 2);
      unpack_bf16x2(u.z, out + 8 * i + 4);
      unpack_bf16x2(u.w, out + 8 * i + 6);
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[i];
      unpack_bf16x2(u.x, out + 4 * i);
      unpack_bf16x2(u.y, out + 4 * i + 2);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __bfloat162float(p[i]);
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* __restrict__ p, const float* v) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(pack_bf16x2(v[8 * i], v[8 * i + 1]), pack_bf16x2(v[8 * i + 2], v[8 * i + 3]),
                     pack_bf16x2(v[8 * i + 4], v[8 * i + 5]), pack_bf16x2(v[8 * i + 6], v[8 * i + 7]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = __float2bfloat16(v[i]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// y = x * r * (1 + w) for VEC elements, as the reference orders it.
template <int VEC, typename TW>
__device__ __forceinline__ void scale_store(const float* x, const TW* w, float r, float* y) {
  float wv[VEC];
  load_vec<VEC>(w, wv);
#pragma unroll
  for (int e = 0; e < VEC; ++e) y[e] = x[e] * r * (1.f + wv[e]);
}

// TPR threads per row, THREADS / TPR rows per block; each thread holds up
// to NV vectors of VEC elements.
template <typename T, typename TW, int VEC, int TPR>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_rows_kernel(const T* __restrict__ x, const TW* __restrict__ w, T* __restrict__ o,
                        long long xs, long long os, long long rows, int d, float eps) {
  constexpr int WPR = TPR / 32;  // warps per row
  __shared__ float part[THREADS / 32];
  const int sub = threadIdx.x / TPR, tid = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / TPR) + sub;
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * xs;
  T* orow = o + (live ? row : 0) * os;
  const int nvec = live ? d / VEC : 0;
  float v[NV][VEC];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = tid + TPR * i;
    if (c < nvec) {
      load_vec<VEC>(xr + c * VEC, v[i]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss = fmaf(v[i][e], v[i][e], ss);
    }
  }
  ss = warp_sum(ss);
  if constexpr (WPR > 1) {
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int j = 0; j < WPR; ++j) ss += part[sub * WPR + j];
  }
  const float r = rsqrtf(ss / d + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = tid + TPR * i;
    if (c < nvec) {
      float y[VEC];
      scale_store<VEC>(v[i], w + c * VEC, r, y);
      store_vec<VEC>(orow + c * VEC, y);
    }
  }
}

// One block per row, for rows wider than NV vectors per thread of a block.
template <typename T, typename TW, int VEC>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_wide_kernel(const T* __restrict__ x, const TW* __restrict__ w, T* __restrict__ o,
                        long long xs, long long os, int d, float eps) {
  __shared__ float part[THREADS / 32];
  const T* xr = x + blockIdx.x * xs;
  T* orow = o + blockIdx.x * os;
  const int nvec = d / VEC;
  float ss = 0.f;
  for (int c = threadIdx.x; c < nvec; c += THREADS) {
    float v[VEC];
    load_vec<VEC>(xr + c * VEC, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss = fmaf(v[e], v[e], ss);
  }
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  ss = lane < THREADS / 32 ? part[lane] : 0.f;
  const float r = rsqrtf(warp_sum(ss) / d + eps);  // every warp sums the same parts
  for (int c = threadIdx.x; c < nvec; c += THREADS) {
    float v[VEC], y[VEC];
    load_vec<VEC>(xr + c * VEC, v);
    scale_store<VEC>(v, w + c * VEC, r, y);
    store_vec<VEC>(orow + c * VEC, y);
  }
}

template <typename T, typename TW, int VEC, int TPR>
void launch_rows(const T* x, const TW* w, T* o, long long rows, int d, long long xs, long long os,
                 float eps, cudaStream_t stream) {
  const long long blocks = (rows + THREADS / TPR - 1) / (THREADS / TPR);
  rmsnorm_rows_kernel<T, TW, VEC, TPR><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      x, w, o, xs, os, rows, d, eps);
}

template <typename T, typename TW, int VEC>
cudaError_t launch(const void* x, const void* w, void* o, long long rows, int d, long long xs,
                   long long os, float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const TW* wp = static_cast<const TW*>(w);
  T* op = static_cast<T*>(o);
  const int nvec = d / VEC;
  if (nvec <= 32 * NV)
    launch_rows<T, TW, VEC, 32>(xp, wp, op, rows, d, xs, os, eps, stream);
  else if (nvec <= 64 * NV)
    launch_rows<T, TW, VEC, 64>(xp, wp, op, rows, d, xs, os, eps, stream);
  else if (nvec <= 128 * NV)
    launch_rows<T, TW, VEC, 128>(xp, wp, op, rows, d, xs, os, eps, stream);
  else if (nvec <= 256 * NV)
    launch_rows<T, TW, VEC, 256>(xp, wp, op, rows, d, xs, os, eps, stream);
  else
    rmsnorm_wide_kernel<T, TW, VEC><<<static_cast<unsigned>(rows), THREADS, 0, stream>>>(
        xp, wp, op, xs, os, d, eps);
  return cudaGetLastError();
}

template <typename T, typename TW>
cudaError_t dispatch_vec(const void* x, const void* w, void* o, long long rows, int d,
                         long long xs, long long os, float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(o);
  const bool vec = addr % 16 == 0 && d % VEC == 0 && xs % VEC == 0 && os % VEC == 0;
  return vec ? launch<T, TW, VEC>(x, w, o, rows, d, xs, os, eps, stream)
             : launch<T, TW, 1>(x, w, o, rows, d, xs, os, eps, stream);
}

template <typename T>
cudaError_t dispatch_w(const void* x, const void* w, void* o, int w_dtype, long long rows, int d,
                       long long xs, long long os, float eps, cudaStream_t stream) {
  return w_dtype == 0   ? dispatch_vec<T, float>(x, w, o, rows, d, xs, os, eps, stream)
         : w_dtype == 1 ? dispatch_vec<T, __nv_bfloat16>(x, w, o, rows, d, xs, os, eps, stream)
                        : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// backward

template <typename T>
__device__ __forceinline__ T of_f(float v);
template <>
__device__ __forceinline__ float of_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 of_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// One row-sum pair per warp, double-buffered so a row needs one
// __syncthreads: the buffer a row writes was last read two rows before, by
// threads that have since passed the previous row's barrier.
struct RowSums {
  float s[2][2][THREADS / 32];  // [buffer][sum of x^2, sum of u*x][warp]
};

// TPR threads per row, THREADS / TPR rows per block at a time; the block
// walks its rows with a grid stride.  Each thread holds up to NV vectors of
// x and of g and always the same columns, so (1 + w) and its dw partial
// sums stay in registers across the loop.
template <typename T, typename TW, int VEC, int TPR>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                            const T* __restrict__ g, T* __restrict__ dx,
                            float* __restrict__ dw_part, long long xs, long long gs,
                            long long rows, int d, float eps) {
  constexpr int WPR = TPR / 32, RPB = THREADS / TPR;
  __shared__ RowSums part;
  const int sub = threadIdx.x / TPR, tid = threadIdx.x % TPR, warp = threadIdx.x / 32;
  const int nvec = d / VEC;
  float w1[NV][VEC], acc[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = tid + TPR * i;
    if (c < nvec) load_vec<VEC>(w + c * VEC, w1[i]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (c < nvec) w1[i][e] += 1.f;
      acc[i][e] = 0.f;
    }
  }
  int buf = 0;
  for (long long row0 = static_cast<long long>(blockIdx.x) * RPB; row0 < rows;
       row0 += static_cast<long long>(gridDim.x) * RPB, buf ^= 1) {
    const long long row = row0 + sub;
    const int live = row < rows ? nvec : 0;
    const T* xr = x + (row < rows ? row : 0) * xs;
    const T* gr = g + (row < rows ? row : 0) * gs;
    float xv[NV][VEC], gv[NV][VEC];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = tid + TPR * i;
      if (c < live) {
        load_vec<VEC>(xr + c * VEC, xv[i]);
        load_vec<VEC>(gr + c * VEC, gv[i]);
      }
    }
    float ss = 0.f, su = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (tid + TPR * i < live) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ss = fmaf(xv[i][e], xv[i][e], ss);
          su = fmaf(gv[i][e] * w1[i][e], xv[i][e], su);
        }
      }
    }
    ss = warp_sum(ss);
    su = warp_sum(su);
    if constexpr (WPR > 1) {
      if (threadIdx.x % 32 == 0) {
        part.s[buf][0][warp] = ss;
        part.s[buf][1][warp] = su;
      }
      __syncthreads();
      ss = su = 0.f;
#pragma unroll
      for (int j = 0; j < WPR; ++j) {  // every thread of a row adds in the same order
        ss += part.s[buf][0][sub * WPR + j];
        su += part.s[buf][1][sub * WPR + j];
      }
    }
    const float r = rsqrtf(ss / d + eps);
    const float coef = r * r * r * (su / d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = tid + TPR * i;
      if (c < live) {
        float y[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          y[e] = r * (gv[i][e] * w1[i][e]) - xv[i][e] * coef;
          acc[i][e] = fmaf(gv[i][e] * xv[i][e], r, acc[i][e]);
        }
        store_vec<VEC>(dx + row * d + c * VEC, y);
      }
    }
  }
  // the block's column sums: its RPB rows' partial sums added in row order
  float* out = dw_part + static_cast<long long>(blockIdx.x) * d;
  if constexpr (RPB == 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = tid + TPR * i;
      if (c < nvec) store_vec<VEC>(out + c * VEC, acc[i]);
    }
  } else {
    __shared__ float cols[RPB][NV * TPR * VEC];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = tid + TPR * i;
      if (c < nvec)
#pragma unroll
        for (int e = 0; e < VEC; ++e) cols[sub][c * VEC + e] = acc[i][e];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < RPB; ++j) s += cols[j][c];
      out[c] = s;
    }
  }
}

constexpr int WIDE_SUMS = 2 * THREADS / 32;  // the wide kernel's row sums, after its column sums

// One block per row at a time, for rows wider than NV vectors per thread of
// a block: the row sums first, then dx, with x and g read twice (the second
// read hits L1/L2) and the dw partial sums in shared memory (a column is
// always the same thread's).
template <typename T, typename TW, int VEC>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_bwd_wide_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                            const T* __restrict__ g, T* __restrict__ dx,
                            float* __restrict__ dw_part, long long xs, long long gs,
                            long long rows, int d, float eps) {
  extern __shared__ float col_sum[];  // d floats, then the row's two sums per warp
  float* part = col_sum + d;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nvec = d / VEC;
  for (int c = tid; c < nvec; c += THREADS)  // a thread's own columns, as it sums them
#pragma unroll
    for (int e = 0; e < VEC; ++e) col_sum[c * VEC + e] = 0.f;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * xs;
    const T* gr = g + row * gs;
    float ss = 0.f, su = 0.f;
    for (int c = tid; c < nvec; c += THREADS) {
      float xv[VEC], gv[VEC], wv[VEC];
      load_vec<VEC>(xr + c * VEC, xv);
      load_vec<VEC>(gr + c * VEC, gv);
      load_vec<VEC>(w + c * VEC, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ss = fmaf(xv[e], xv[e], ss);
        su = fmaf(gv[e] * (1.f + wv[e]), xv[e], su);
      }
    }
    ss = warp_sum(ss);
    su = warp_sum(su);
    if (lane == 0) {
      part[warp] = ss;
      part[THREADS / 32 + warp] = su;
    }
    __syncthreads();
    ss = su = 0.f;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) {  // every thread adds in the same order
      ss += part[i];
      su += part[THREADS / 32 + i];
    }
    __syncthreads();  // `part` is rewritten by the next row
    const float r = rsqrtf(ss / d + eps);
    const float coef = r * r * r * (su / d);
    T* dxr = dx + row * d;
    for (int c = tid; c < nvec; c += THREADS) {
      float xv[VEC], gv[VEC], wv[VEC], y[VEC];
      load_vec<VEC>(xr + c * VEC, xv);
      load_vec<VEC>(gr + c * VEC, gv);
      load_vec<VEC>(w + c * VEC, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        y[e] = r * (gv[e] * (1.f + wv[e])) - xv[e] * coef;
        col_sum[c * VEC + e] = fmaf(gv[e] * xv[e], r, col_sum[c * VEC + e]);
      }
      store_vec<VEC>(dxr + c * VEC, y);
    }
  }
  float* out = dw_part + static_cast<long long>(blockIdx.x) * d;
  for (int c = tid; c < nvec; c += THREADS) store_vec<VEC>(out + c * VEC, col_sum + c * VEC);
}

// dw = the column sums of the (parts, d) scratch: 8 columns per block and
// 32 groups of parts (group k adds parts k, k + 32, ... in order), then the
// groups added in order.
constexpr int DW_COLS = 8;

template <typename TW>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_bwd_dw(const float* __restrict__ dw_part, TW* __restrict__ dw, int parts, int d) {
  constexpr int GROUPS = THREADS / DW_COLS;
  __shared__ float red[GROUPS][DW_COLS];
  const int col = threadIdx.x % DW_COLS, grp = threadIdx.x / DW_COLS;
  const int c = blockIdx.x * DW_COLS + col;
  float s = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int i = grp; i < parts; i += GROUPS) s += dw_part[static_cast<long long>(i) * d + c];
  }
  red[grp][col] = s;
  __syncthreads();
  if (threadIdx.x < DW_COLS && c < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < GROUPS; ++k) t += red[k][threadIdx.x];
    dw[c] = of_f<TW>(t);
  }
}

struct BwdArgs {
  const void *x, *w, *g;
  void *dx, *dw;
  float* part;
  long long rows, xs, gs;
  int d, parts;
  float eps;
  cudaStream_t stream;
};

// Blocks of `kernel` (THREADS threads and `smem` dynamic bytes each) that
// fill the card once: its SMs times the blocks an SM holds.
template <typename K>
int one_wave(K kernel, int smem) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

inline int fewest(long long a, long long b, long long c) {
  const long long m = a < b ? (a < c ? a : c) : (b < c ? b : c);
  return static_cast<int>(m);
}

// Launches the row kernel on one wave of blocks (at most a.parts, at most
// one per RPB rows); returns the blocks launched.
template <typename T, typename TW, int VEC, int TPR>
int launch_bwd_rows(const BwdArgs& a) {
  constexpr int RPB = THREADS / TPR;
  static const int wave = one_wave(rmsnorm_bwd_rows_kernel<T, TW, VEC, TPR>, 0);
  const int blocks = fewest((a.rows + RPB - 1) / RPB, a.parts, wave);
  rmsnorm_bwd_rows_kernel<T, TW, VEC, TPR><<<blocks, THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const TW*>(a.w), static_cast<const T*>(a.g),
      static_cast<T*>(a.dx), a.part, a.xs, a.gs, a.rows, a.d, a.eps);
  return blocks;
}

template <typename T, typename TW, int VEC>
cudaError_t launch_bwd_vec(const BwdArgs& a) {
  const int nvec = a.d / VEC;
  int blocks;
  if (nvec <= 32 * NV) {
    blocks = launch_bwd_rows<T, TW, VEC, 32>(a);
  } else if (nvec <= 64 * NV) {
    blocks = launch_bwd_rows<T, TW, VEC, 64>(a);
  } else if (nvec <= 128 * NV) {
    blocks = launch_bwd_rows<T, TW, VEC, 128>(a);
  } else if (nvec <= 256 * NV) {
    blocks = launch_bwd_rows<T, TW, VEC, 256>(a);
  } else {
    const int smem = (a.d + WIDE_SUMS) * 4;
    if (smem > 48 * 1024) {
      const cudaError_t attr = cudaFuncSetAttribute(
          rmsnorm_bwd_wide_kernel<T, TW, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (attr != cudaSuccess) return attr;
    }
    blocks = fewest(a.rows, a.parts, one_wave(rmsnorm_bwd_wide_kernel<T, TW, VEC>, smem));
    rmsnorm_bwd_wide_kernel<T, TW, VEC><<<blocks, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const TW*>(a.w), static_cast<const T*>(a.g),
        static_cast<T*>(a.dx), a.part, a.xs, a.gs, a.rows, a.d, a.eps);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dw<TW><<<(a.d + DW_COLS - 1) / DW_COLS, THREADS, 0, a.stream>>>(
      a.part, static_cast<TW*>(a.dw), blocks, a.d);
  return cudaGetLastError();
}

template <typename T, typename TW>
cudaError_t launch_bwd(const BwdArgs& a) {
  constexpr int VEC = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.w) |
                         reinterpret_cast<uintptr_t>(a.g) | reinterpret_cast<uintptr_t>(a.dx);
  const bool vec = addr % 16 == 0 && a.d % VEC == 0 && a.xs % VEC == 0 && a.gs % VEC == 0;
  return vec ? launch_bwd_vec<T, TW, VEC>(a) : launch_bwd_vec<T, TW, 1>(a);
}


// ---------------------------------------------------------------------------
// split rows: a row whose columns several ranks hold (mamba2's gated norm on
// its d_inner split over 'model').  Each of the two sums the row needs
// crosses ranks, so each direction is two calls with an all-reduce of one
// f32 a row between them (outside the kernels):
//   * `rmsnorm_part_kernel`: a row's sum over this rank's columns, of x^2
//     (S, forward) or of g * (1 + w) * x (T, backward);
//   * `rmsnorm_apply_kernel`: y = x * rsqrt(S / d_full + eps) * (1 + w), from
//     the reduced S, d_full being the whole row's width;
//   * `rmsnorm_split_bwd_kernel`: dx = r * g * (1 + w) - x * r^3 * T / d_full
//     from the reduced S and T, and each block's dw column sums (g * x * r)
//     into the (parts, d) scratch, which `rmsnorm_bwd_dw` adds up in a fixed
//     order, as the whole-row backward does.
// Bound by device-memory bytes, as the whole-row kernels.  With the row's
// sums given, the apply and the backward read each element once, so they
// hold nothing of the row in registers: TPR threads a row (the whole-row
// kernels' choice for the local width), each walking its vectors.  The
// backward keeps its dw partial sums in shared memory (one row of d floats
// a row of the block), as the whole-row wide kernel does.

template <typename T, typename TW, int VEC, int TPR, bool DOT>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_part_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                        const T* __restrict__ g, float* __restrict__ out, long long xs,
                        long long gs, long long rows, int d) {
  constexpr int WPR = TPR / 32;
  __shared__ float part[THREADS / 32];
  const int sub = threadIdx.x / TPR, tid = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / TPR) + sub;
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * xs;
  const int nvec = live ? d / VEC : 0;
  float s = 0.f;
  for (int c = tid; c < nvec; c += TPR) {
    float xv[VEC];
    load_vec<VEC>(xr + c * VEC, xv);
    if constexpr (DOT) {
      float gv[VEC], wv[VEC];
      load_vec<VEC>(g + row * gs + c * VEC, gv);
      load_vec<VEC>(w + c * VEC, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) s = fmaf(gv[e] * (1.f + wv[e]), xv[e], s);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) s = fmaf(xv[e], xv[e], s);
    }
  }
  s = warp_sum(s);
  if constexpr (WPR > 1) {
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
    __syncthreads();
    s = 0.f;
#pragma unroll
    for (int j = 0; j < WPR; ++j) s += part[sub * WPR + j];
  }
  if (live && tid == 0) out[row] = s;
}

template <typename T, typename TW, int VEC, int TPR>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_apply_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                         const float* __restrict__ ss, T* __restrict__ o, long long xs,
                         long long rows, int d, float d_full, float eps) {
  const int sub = threadIdx.x / TPR, tid = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / TPR) + sub;
  if (row >= rows) return;
  const float r = rsqrtf(ss[row] / d_full + eps);
  const T* xr = x + row * xs;
  T* orow = o + row * d;
  for (int c = tid; c < d / VEC; c += TPR) {
    float v[VEC], y[VEC];
    load_vec<VEC>(xr + c * VEC, v);
    scale_store<VEC>(v, w + c * VEC, r, y);
    store_vec<VEC>(orow + c * VEC, y);
  }
}

template <typename T, typename TW, int VEC, int TPR>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_split_bwd_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                             const T* __restrict__ g, const float* __restrict__ ss,
                             const float* __restrict__ st, T* __restrict__ dx,
                             float* __restrict__ dw_part, long long xs, long long gs,
                             long long rows, int d, float d_full, float eps) {
  constexpr int RPB = THREADS / TPR;
  extern __shared__ float cols[];  // RPB rows of d column sums
  const int sub = threadIdx.x / TPR, tid = threadIdx.x % TPR;
  const int nvec = d / VEC;
  float* mine = cols + sub * d;  // a column is always the same thread's
  for (int c = tid; c < nvec; c += TPR)
#pragma unroll
    for (int e = 0; e < VEC; ++e) mine[c * VEC + e] = 0.f;
  for (long long row0 = static_cast<long long>(blockIdx.x) * RPB; row0 < rows;
       row0 += static_cast<long long>(gridDim.x) * RPB) {
    const long long row = row0 + sub;
    if (row >= rows) continue;
    const float r = rsqrtf(ss[row] / d_full + eps);
    const float coef = r * r * r * (st[row] / d_full);
    const T* xr = x + row * xs;
    const T* gr = g + row * gs;
    T* dxr = dx + row * d;
    for (int c = tid; c < nvec; c += TPR) {
      float xv[VEC], gv[VEC], wv[VEC], y[VEC];
      load_vec<VEC>(xr + c * VEC, xv);
      load_vec<VEC>(gr + c * VEC, gv);
      load_vec<VEC>(w + c * VEC, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        y[e] = r * (gv[e] * (1.f + wv[e])) - xv[e] * coef;
        mine[c * VEC + e] = fmaf(gv[e] * xv[e], r, mine[c * VEC + e]);
      }
      store_vec<VEC>(dxr + c * VEC, y);
    }
  }
  __syncthreads();
  float* out = dw_part + static_cast<long long>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += THREADS) {  // the block's rows added in row order
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < RPB; ++j) s += cols[j * d + c];
    out[c] = s;
  }
}

struct SplitArgs {
  const void *x, *w, *g;
  const float *ss, *st;
  void *o, *dw;
  float *sum, *part;
  long long rows, xs, gs;
  int d, parts;
  float d_full, eps;
  cudaStream_t stream;
};

// The whole-row kernels' threads a row for a local width of nvec vectors:
// the fewest of 32 to 256 that hold it at NV vectors a thread.
inline int split_tpr(int nvec) {
  return nvec <= 32 * NV ? 32 : nvec <= 64 * NV ? 64 : nvec <= 128 * NV ? 128 : 256;
}

// mode 0: S = the rows' local sums of x^2; 1: T = those of g * (1 + w) * x;
// 2: the forward's apply; 3: the backward (dx, then dw over the blocks).
template <typename T, typename TW, int VEC, int TPR>
cudaError_t launch_split_tpr(const SplitArgs& a, int mode) {
  constexpr int RPB = THREADS / TPR;
  const T* x = static_cast<const T*>(a.x);
  const TW* w = static_cast<const TW*>(a.w);
  const T* g = static_cast<const T*>(a.g);
  const long long grid = (a.rows + RPB - 1) / RPB;
  if (mode == 0) {
    rmsnorm_part_kernel<T, TW, VEC, TPR, false><<<static_cast<unsigned>(grid), THREADS, 0,
                                                  a.stream>>>(x, w, g, a.sum, a.xs, a.gs,
                                                              a.rows, a.d);
  } else if (mode == 1) {
    rmsnorm_part_kernel<T, TW, VEC, TPR, true><<<static_cast<unsigned>(grid), THREADS, 0,
                                                 a.stream>>>(x, w, g, a.sum, a.xs, a.gs,
                                                             a.rows, a.d);
  } else if (mode == 2) {
    rmsnorm_apply_kernel<T, TW, VEC, TPR><<<static_cast<unsigned>(grid), THREADS, 0, a.stream>>>(
        x, w, a.ss, static_cast<T*>(a.o), a.xs, a.rows, a.d, a.d_full, a.eps);
  } else {
    const int smem = RPB * a.d * 4;
    if (smem > 48 * 1024) {
      const cudaError_t attr =
          cudaFuncSetAttribute(rmsnorm_split_bwd_kernel<T, TW, VEC, TPR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (attr != cudaSuccess) return attr;
    }
    const int blocks =
        fewest(grid, a.parts, one_wave(rmsnorm_split_bwd_kernel<T, TW, VEC, TPR>, smem));
    rmsnorm_split_bwd_kernel<T, TW, VEC, TPR><<<blocks, THREADS, smem, a.stream>>>(
        x, w, g, a.ss, a.st, static_cast<T*>(a.o), a.part, a.xs, a.gs, a.rows, a.d, a.d_full,
        a.eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    rmsnorm_bwd_dw<TW><<<(a.d + DW_COLS - 1) / DW_COLS, THREADS, 0, a.stream>>>(
        a.part, static_cast<TW*>(a.dw), blocks, a.d);
  }
  return cudaGetLastError();
}

template <typename T, typename TW, int VEC>
cudaError_t launch_split_vec(const SplitArgs& a, int mode) {
  switch (split_tpr(a.d / VEC)) {
    case 32: return launch_split_tpr<T, TW, VEC, 32>(a, mode);
    case 64: return launch_split_tpr<T, TW, VEC, 64>(a, mode);
    case 128: return launch_split_tpr<T, TW, VEC, 128>(a, mode);
    default: return launch_split_tpr<T, TW, VEC, 256>(a, mode);
  }
}

template <typename T, typename TW>
cudaError_t launch_split(const SplitArgs& a, int mode) {
  constexpr int VEC = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.w) |
                         reinterpret_cast<uintptr_t>(a.g) | reinterpret_cast<uintptr_t>(a.o);
  const bool vec = addr % 16 == 0 && a.d % VEC == 0 && a.xs % VEC == 0 && a.gs % VEC == 0;
  return vec ? launch_split_vec<T, TW, VEC>(a, mode) : launch_split_vec<T, TW, 1>(a, mode);
}

int split_entry(const long long* args, int mode, float d_full, float eps) {
  // args: as the C entries below say; the pointers a mode does not read are 0
  const long long code = args[9], rows = args[10], d = args[11], parts = args[15];
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0 || code < 0 || code > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode >= 2 && !(d_full >= static_cast<float>(d)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 3 && (parts < 1 || parts > rows || d * 4 > 232448))
    return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs a;
  a.x = reinterpret_cast<const void*>(args[0]);
  a.w = reinterpret_cast<const void*>(args[1]);
  a.g = reinterpret_cast<const void*>(args[2]);
  a.ss = reinterpret_cast<const float*>(args[3]);
  a.st = reinterpret_cast<const float*>(args[4]);
  a.o = reinterpret_cast<void*>(args[5]);
  a.dw = reinterpret_cast<void*>(args[6]);
  a.sum = reinterpret_cast<float*>(args[7]);
  a.part = reinterpret_cast<float*>(args[8]);
  a.rows = rows;
  a.d = static_cast<int>(d);
  a.xs = args[12];
  a.gs = args[13];
  a.stream = reinterpret_cast<cudaStream_t>(args[14]);
  a.parts = static_cast<int>(mode == 3 ? parts : 1);
  a.d_full = d_full;
  a.eps = eps;
  const int x_dtype = static_cast<int>(code % 2), w_dtype = static_cast<int>(code / 2);
  cudaError_t err;
  if (x_dtype == 0)
    err = w_dtype == 0 ? launch_split<float, float>(a, mode)
                       : launch_split<float, __nv_bfloat16>(a, mode);
  else
    err = w_dtype == 0 ? launch_split<__nv_bfloat16, float>(a, mode)
                       : launch_split<__nv_bfloat16, __nv_bfloat16>(a, mode);
  return static_cast<int>(err);
}

}  // namespace

// args[13] = {x, w, g, dx, dw, scratch, dtypes, rows, d, xs, gs, stream,
// parts}: x (rows, d) with row stride xs and contiguous rows, w (d,)
// contiguous, g (the output's gradient, x's dtype) with row stride gs, dx
// (rows, d) contiguous in x's dtype, dw (d,) in w's dtype, scratch f32 of
// parts * d floats, one row of column sums per block of the first launch,
// which takes one wave of blocks at its occupancy but at most parts
// (1 <= parts <= rows); dtypes as for rmsnorm_fwd.  Rows wider than 2048
// (f32) or 4096 (bf16) elements keep their column sums in shared memory:
// d <= 58096.  Returns cudaGetLastError() after the launches (0 on success).
extern "C" int rmsnorm_bwd(const long long* args, float eps) {
  const long long code = args[6], rows = args[7], d = args[8], parts = args[12];
  if (rows <= 0 || d <= 0 || (d + WIDE_SUMS) * 4 > 232448 || code < 0 ||
      code > 3 || parts < 1 || parts > rows || parts > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.x = reinterpret_cast<const void*>(args[0]);
  a.w = reinterpret_cast<const void*>(args[1]);
  a.g = reinterpret_cast<const void*>(args[2]);
  a.dx = reinterpret_cast<void*>(args[3]);
  a.dw = reinterpret_cast<void*>(args[4]);
  a.part = reinterpret_cast<float*>(args[5]);
  a.rows = rows;
  a.d = static_cast<int>(d);
  a.xs = args[9];
  a.gs = args[10];
  a.stream = reinterpret_cast<cudaStream_t>(args[11]);
  a.parts = static_cast<int>(parts);
  a.eps = eps;
  const int x_dtype = static_cast<int>(code % 2), w_dtype = static_cast<int>(code / 2);
  cudaError_t err;
  if (x_dtype == 0)
    err = w_dtype == 0 ? launch_bwd<float, float>(a) : launch_bwd<float, __nv_bfloat16>(a);
  else
    err = w_dtype == 0 ? launch_bwd<__nv_bfloat16, float>(a)
                       : launch_bwd<__nv_bfloat16, __nv_bfloat16>(a);
  return static_cast<int>(err);
}

// args[8] = {x, w, o, dtypes, rows, d, xs, stream}: x (rows, d) with row
// stride xs (elements) and contiguous rows; w (d,) contiguous; o (rows, d)
// contiguous.  dtypes = x code + 2 * w code, a code being 0 for float32 and
// 1 for bfloat16.  One argument block keeps the host's call cheap: this runs
// once per normalisation, decode steps included.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int rmsnorm_fwd(const long long* args, float eps) {
  const void* x = reinterpret_cast<const void*>(args[0]);
  const void* w = reinterpret_cast<const void*>(args[1]);
  void* o = reinterpret_cast<void*>(args[2]);
  const int x_dtype = static_cast<int>(args[3] % 2), w_dtype = static_cast<int>(args[3] / 2);
  const long long rows = args[4], xs = args[6];
  const int d = static_cast<int>(args[5]);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(args[7]);
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0 || args[3] < 0 || args[3] > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = x_dtype == 0
                              ? dispatch_w<float>(x, w, o, w_dtype, rows, d, xs, d, eps, st)
                              : dispatch_w<__nv_bfloat16>(x, w, o, w_dtype, rows, d, xs, d, eps, st);
  return static_cast<int>(err);
}


// The split-row mode (see above).  args[16] = {x, w, g, ss, st, o, dw, sum,
// scratch, dtypes, rows, d, xs, gs, stream, parts}: x (rows, d) this rank's
// columns of rows d_full wide, with row stride xs and contiguous rows; w (d,)
// its columns, contiguous; g (x's dtype) with row stride gs; ss and st the
// rows' reduced sums of x^2 and of g * (1 + w) * x, f32 (rows,); o (rows, d)
// contiguous (y, or dx); dw (d,) in w's dtype; sum f32 (rows,); scratch f32 of
// parts * d floats (1 <= parts <= rows); dtypes as for rmsnorm_fwd.  A call
// reads and writes only its own arguments, the others being 0:
//   rmsnorm_split_sum:  mode 0 (x; sum = S) or 1 (x, w, g; sum = T);
//   rmsnorm_split_fwd:  x, w, ss; o = y;
//   rmsnorm_split_bwd:  x, w, g, ss, st; o = dx, dw (two launches; scratch).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int rmsnorm_split_sum(const long long* args, int dot) {
  return split_entry(args, dot ? 1 : 0, 0.f, 0.f);
}

extern "C" int rmsnorm_split_fwd(const long long* args, float d_full, float eps) {
  return split_entry(args, 2, d_full, eps);
}

extern "C" int rmsnorm_split_bwd(const long long* args, float d_full, float eps) {
  return split_entry(args, 3, d_full, eps);
}
