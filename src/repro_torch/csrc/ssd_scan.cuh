// Shared by the SSD scan's forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu):
// the chunk length, the in-chunk cumsum of dt * a, 16-byte loads as floats,
// the narrow head dims' tile width and column-wise loads and stores,
// cp.async and bulk copies, ldmatrix and bf16 mma.sync, the rule of heads per block, and the
// forward's register-tiled f32 product on the CUDA cores.  hopper.cuh brings
// smem_u32 and the 3xTF32 helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <initializer_list>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int L = 64;  // chunk length, the kernel's own choice

// Lane k's rows 2k, 2k+1 of a head's dt (0 past S) and the head's a.
struct HeadDt {
  float d0, d1, a;
};

// Warp 0 only: the inclusive cumsum of dt * a over the chunk into cum[], dt
// into dtl[]; returns cum[L-1].
__device__ __forceinline__ float chunk_cumsum(const HeadDt& d, float* cum, float* dtl) {
  const int lane = threadIdx.x, l0 = 2 * lane;
  const float v0 = d.d0 * d.a;
  float inc = v0 + d.d1 * d.a;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += up;
  }
  float excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = 0.f;
  cum[l0] = excl + v0;
  cum[l0 + 1] = inc;
  dtl[l0] = d.d0;
  dtl[l0 + 1] = d.d1;
  return __shfl_sync(0xffffffffu, inc, 31);
}

// 16 bytes of x, B or C as floats
__device__ __forceinline__ void unpack16(const uint4& u, float* v, float) {
  v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float* v, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* v) {
  unpack16(*reinterpret_cast<const uint4*>(src), v, T());
}

// Head dims Q below 16 (a head_dim split over a mesh axis: 64 on 16 ranks is
// 4) run on the tiles of P = 16, the narrowest the products take: x and dY
// read as zeros past their Q columns, so every product leaves zeros in the
// tile's other columns, and y, dx and the final state are stored in their Q
// columns only.  The chunk states in the scratch are (N, tile_p(Q)).
__host__ __device__ constexpr int tile_p(int q) { return q < 16 ? 16 : q; }

template <typename T>
struct RawBits;  // the integer that holds a T's bits
template <>
struct RawBits<float> {
  using type = uint32_t;
};
template <>
struct RawBits<__nv_bfloat16> {
  using type = uint16_t;
};

// 16 bytes of a row of x or dY from column c on, as the tile of P columns
// holds them: the row's own 16 bytes where it has P columns (Q == P), else
// its elements below Q one at a time (a row of Q < 16 elements need not
// start on 16 bytes) and zeros past them.
template <int Q, int P, typename T>
__device__ __forceinline__ uint4 load16_cols(const T* row, int c) {
  if constexpr (Q == P) {
    return *reinterpret_cast<const uint4*>(row + c);
  } else {
    using U = typename RawBits<T>::type;
    constexpr int V = 16 / sizeof(T);
    union {
      uint4 v;
      U e[V];
    } r;
    r.v = make_uint4(0, 0, 0, 0);
    const U* src = reinterpret_cast<const U*>(row);
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (c + e < Q) r.e[e] = src[c + e];
    return r.v;
  }
}

// v[0 .. 4) into columns c .. c + 3 of a row of Q columns (Q < 16: those below Q only)
template <int Q, int P>
__device__ __forceinline__ void store4_cols(float* row, int c, const float* v) {
  if constexpr (Q == P) {
    *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < Q) row[c + e] = v[e];
  }
}

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16_rn(v); }

// (a, b) into columns c, c + 1 of a row of Q columns (Q < 16: those below Q only)
template <int Q, int P, typename T>
__device__ __forceinline__ void store_pair_cols(T* row, int c, float a, float b) {
  if constexpr (Q == P) {
    store_pair(row + c, a, b);
  } else {
    if (c < Q) store1(row + c, a);
    if (c + 1 < Q) store1(row + c + 1, b);
  }
}

// A register-tiled f32 product on the CUDA cores,
//   out[r][c] = sum_k A[k * lda + r] * Bm[k * ldb + c],  r < R, c < C,
// both operands k-major in shared memory.  NT threads form an RT x CT grid;
// a thread owns TR rows (chunks of RV = min(TR, 4) consecutive rows, RT*RV
// apart) and 4 consecutive columns, so each k costs it TR/RV + 1 16-byte
// loads for 4*TR FMAs.  A warp spans WR row groups and WC column groups:
// its A loads are WR consecutive 16-byte words (conflict-free) broadcast
// over WC lanes, its B loads WC consecutive words broadcast over WR lanes.
template <int R, int C, int NT>
struct Tile {
  static constexpr int CT = C / 4, RT = NT / CT, TR = R / RT, RV = TR < 4 ? TR : 4;
  static constexpr int WR = RT < 8 ? RT : 8, WC = 32 / WR;
  static_assert(C % 4 == 0 && CT * RT == NT && TR * RT == R && TR % RV == 0, "tile");
  static_assert(RT % WR == 0 && CT % WC == 0, "warp layout");
  int tr, tc;
  __device__ explicit Tile(int tid) {
    const int lane = tid & 31, warp = tid >> 5;
    tr = (warp / (CT / WC)) * WR + lane / WC;
    tc = (warp % (CT / WC)) * WC + lane % WC;
  }
  __device__ __forceinline__ int row(int i) const { return ((i / RV) * RT + tr) * RV + i % RV; }
  __device__ __forceinline__ int col0() const { return tc * 4; }
  __device__ __forceinline__ int row_max() const { return row(TR - 1); }

  // acc[i][j] += sum_{k0 <= k < k1} A[k * lda + row(i)] * Bm[k * ldb + col0() + j]
  __device__ __forceinline__ void mac(float (&acc)[TR][4], const float* A, int lda,
                                      const float* Bm, int ldb, int k0, int k1) const {
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      float av[TR], bv[4];
      load16(Bm + k * ldb + col0(), bv);
#pragma unroll
      for (int q = 0; q < TR / RV; ++q) {
        const float* src = A + k * lda + (q * RT + tr) * RV;
        if constexpr (RV == 4) {
          load16(src, av + 4 * q);
        } else if constexpr (RV == 2) {
          const float2 f = *reinterpret_cast<const float2*>(src);
          av[2 * q] = f.x, av[2 * q + 1] = f.y;
        } else {
          av[q] = *src;
        }
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
};

template <int R, int C, int NT>
__device__ __forceinline__ void zero(float (&acc)[Tile<R, C, NT>::TR][4]) {
#pragma unroll
  for (int i = 0; i < Tile<R, C, NT>::TR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// 16 bytes from device to shared memory, in the background; zeros if !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Hopper's bulk copy engine (TMA, 1-D): shared -> global without the threads
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {  // the source may be overwritten
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {  // the copies are done
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {  // smem writes -> the copy engine
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// four 8 x 8 b16 matrices; lane i gives the address of row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Heads of one group per product block: the most, up to 8, that leave at
// least 512 blocks (four per SM) to fill the card.
int heads_per_block(int heads_per_group, long long chunk_heads) {
  for (int kh : {8, 6, 4, 3, 2})
    if (heads_per_group % kh == 0 && chunk_heads / kh >= 512) return kh;
  return 1;
}

__host__ __device__ constexpr int nt_state(int N, int P) { return N * P / 4 < 256 ? N * P / 4 : 256; }

}  // namespace
