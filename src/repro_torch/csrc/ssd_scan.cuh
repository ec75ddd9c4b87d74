// Shared by the SSD scan's forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu):
// the chunk length, the in-chunk cumsum of dt * a, 16-byte loads as floats,
// cp.async and bulk copies, ldmatrix and bf16 mma.sync, the rule of heads per
// block, the forward's register-tiled f32 product on the CUDA cores, and the
// narrow head dims' packed tiles: the rule of tiles per block, their loads and
// stores, and the chunk-state product both directions run on them.
// hopper.cuh brings smem_u32 and the 3xTF32 helpers.
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

// Lane k of a warp: rows 2k, 2k+1 of the inclusive cumsum of dt * a over the
// chunk into c0, c1; returns cum[L-1].
__device__ __forceinline__ float lane_cumsum(const HeadDt& d, float& c0, float& c1) {
  const int lane = threadIdx.x & 31;
  const float v0 = d.d0 * d.a;
  float inc = v0 + d.d1 * d.a;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += up;
  }
  float excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = 0.f;
  c0 = excl + v0;
  c1 = inc;
  return __shfl_sync(0xffffffffu, inc, 31);
}

// Warp 0 only: the inclusive cumsum of dt * a over the chunk into cum[], dt
// into dtl[]; returns cum[L-1].
__device__ __forceinline__ float chunk_cumsum(const HeadDt& d, float* cum, float* dtl) {
  const int l0 = 2 * threadIdx.x;
  float c0, c1;
  const float last = lane_cumsum(d, c0, c1);
  cum[l0] = c0;
  cum[l0 + 1] = c1;
  dtl[l0] = d.d0;
  dtl[l0 + 1] = d.d1;
  return last;
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

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16_rn(v); }

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

// ---- warp products on the tensor cores: mma.sync m16n8k8 TF32 ------------------------------
template <int K, bool EXACT>
__device__ __forceinline__ void to_tf32(const float* v, uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if constexpr (EXACT) {
      hi[i] = __float_as_uint(v[i]);
    } else {
      split_tf32_trunc(v[i], hi[i], lo[i]);
    }
  }
}

// d += a b in TF32 passes: 3xTF32, without the lo term of an exact operand
template <bool AX, bool BX>
__device__ __forceinline__ void mma_x(float* d, const uint32_t* ah, const uint32_t* al,
                                      const uint32_t* bh, const uint32_t* bl) {
  if constexpr (!AX && !BX) {
    mma_3xtf32(d, ah, al, bh, bl);
  } else {
    if constexpr (!AX) mma_tf32(d, al, bh);
    if constexpr (!BX) mma_tf32(d, ah, bl);
    mma_tf32(d, ah, bh);
  }
}

// A warp's 16 x 8NJ tile: acc[j] += sum_{k0 <= k < k1} A(row, k) Bm(k, col)
// over k-steps of 8 from k0 (a multiple of 8).  The lane's operands come from
// a(hi, e, kb) = A(gq + 8 hi, kb + tq + 4 e) and b(e, kb, j) = Bm(kb + tq + 4 e,
// 8 j + gq).  AX, BX: the operand is exact in TF32.  Each A fragment is
// split once per k-step and serves every n-tile.  Tiles that a mask leaves
// zero are computed all the same: a branch around mma.sync costs more.
template <int NJ, bool AX, bool BX, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NJ][4], const FA& a, const FB& b, int k0,
                                         int k1) {
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    const float av[4] = {a(0, 0, k), a(1, 0, k), a(0, 1, k), a(1, 1, k)};
    uint32_t ah[4], al[4];
    to_tf32<4, AX>(av, ah, al);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float bv[2] = {b(0, k, j), b(1, k, j)};
      uint32_t bh[2], bl[2];
      to_tf32<2, BX>(bv, bh, bl);
      mma_x<AX, BX>(acc[j], ah, al, bh, bl);
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero_acc(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// ---- head dims Q below 16: a group's heads packed into tiles of 16 columns ---------------
// A head_dim split over a mesh axis leaves a rank Q < 16 columns a head (mamba2's
// 64 on 16 ranks: 4).  The heads of one group share B and C, so K = 16 / Q of
// them sit side by side in one tile of 16 columns: column c of a tile is
// column c % Q of the tile's head c / Q.  Every product whose shared operand
// is B or C then serves K heads at once, and a head's chunk states are
// (N, Q).  A group's heads that K does not divide leave zero columns in its
// last tile.  A thread that owns 4 consecutive columns of a tile holds
// HPT = 4 / QC heads of QC columns each (at Q = 8 two threads share a head).
template <int Q>
struct Packed {
  static_assert(Q == 1 || Q == 2 || Q == 4 || Q == 8, "narrow head dims");
  static constexpr int K = 16 / Q, QC = Q < 4 ? Q : 4, HPT = 4 / QC;
};

// Tiles of one group per narrow block: the most that divide the group's
// tiles and leave at least 256 blocks (two per SM) of chunk_tiles = B*G*tiles*nc,
// so the raw scores C B^T are formed once per (chunk, batch, group) where the
// card stays full.
int tiles_per_block(int tiles_per_group, long long chunk_tiles) {
  for (int kt = tiles_per_group; kt > 1; --kt)
    if (tiles_per_group % kt == 0 && chunk_tiles / kt >= 256) return kt;
  return 1;
}

// The (chunk, batch, group, kt tiles of the group) of a narrow block: grid
// (nc, B * G * tb_n), tb_n = the group's tiles / kt.  Tile t holds the group's
// heads t K .. t K + K - 1 that lie below hg.
struct NarrowBlock {
  int ch, s0, bi, g, tb, t0, hg;
  __device__ NarrowBlock(int H, int G, int K, int kt) : ch(blockIdx.x), s0(blockIdx.x * L) {
    hg = H / G;
    const int tb_n = (hg + K - 1) / K / kt;
    bi = blockIdx.y / (G * tb_n);
    g = blockIdx.y / tb_n % G;
    tb = blockIdx.y % tb_n;
    t0 = tb * kt;
  }
  __device__ int head0(int t, int K) const { return g * hg + t * K; }
  __device__ int heads(int t, int K) const { return min(K, hg - t * K); }
  __device__ long long row(int s, int S) const {  // (b, s) of (B, S, ...)
    return static_cast<long long>(bi) * S + s;
  }
};

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Whether columns c0 .. c0 + 3 of a packed tile row lie side by side from p0
// (one head's columns at Q >= 4, or heads whose rows touch), within nh heads
// and on 4 elements' alignment: then one 16-byte (f32) or 8-byte (bf16) access.
template <int Q, typename T>
__device__ __forceinline__ bool whole4(const T* p0, long long hs, int c0, int nh) {
  return (c0 + 3) / Q < nh && (Q >= 4 || hs == Q) &&
         reinterpret_cast<uintptr_t>(p0) % (4 * sizeof(T)) == 0;
}

// Columns c0 .. c0 + 3 of a packed tile row of x or dY into v (row0: the
// row's first head at column 0, hs: the head stride), zeros past nh heads;
// a column slice of a wider tensor, or a ragged tile's edge, an element at a time.
template <int Q, typename T>
__device__ __forceinline__ void load_packed4(const T* row0, long long hs, int c0, int nh, float* v) {
  const T* p0 = row0 + (c0 / Q) * hs + c0 % Q;
  if (whole4<Q>(p0, hs, c0, nh)) {
    if constexpr (sizeof(T) == 4) {
      const float4 f = *reinterpret_cast<const float4*>(p0);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p0);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = (c0 + j) / Q;
      v[j] = k < nh ? ld1(row0 + k * hs + (c0 + j) % Q) : 0.f;
    }
  }
}

// v into columns c0 .. c0 + 3 of a packed tile row of y or dx, heads below nh only
template <int Q, typename T>
__device__ __forceinline__ void store_packed4(T* row0, long long hs, int c0, int nh, const float* v) {
  T* p0 = row0 + (c0 / Q) * hs + c0 % Q;
  if (whole4<Q>(p0, hs, c0, nh)) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<uint2*>(p0) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = (c0 + j) / Q;
      if (k < nh) store1(row0 + k * hs + (c0 + j) % Q, v[j]);
    }
  }
}

// 4 bytes from device to shared memory, in the background; zero if !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// A tile's packed chunk state from its heads' (N, Q) slabs (first: the first
// head's, hstride: from one head's slab to the next), zeros past nh heads,
// by cp.async: element (n, c) to dst[n * ld + c], or to dst[c * ld + n]
// transposed.  Neighbouring threads take neighbouring columns: a head's Q
// floats of a row, then the next head's.
template <int N, int Q, int NT, bool TRANSPOSED = false>
__device__ __forceinline__ void async_packed_state(float* dst, const float* first, long long hstride,
                                                   int nh, int ld) {
  for (int i = threadIdx.x; i < N * 16; i += NT) {
    const int n = i / 16, c = i % 16, k = c / Q;
    cp_async4(dst + (TRANSPOSED ? c * ld + n : n * ld + c),
              first + (k < nh ? k * hstride + n * Q + c % Q : 0), k < nh);
  }
}

// Warps of a block: each head k < K of a tile, warp k % NW, its cumsum of dt * a
// into cum[k * ld ..] and, unless dtl is null, dt into dtl[k * ld ..]; zeros
// past nh heads.  dt is (B, S, H) through strides dts; h0 the tile's first head.
template <int K, int NW>
__device__ __forceinline__ void narrow_cumsums(const float* dt, const long long* dts, const float* a,
                                               int bi, int s0, int S, int h0, int nh, float* cum,
                                               float* dtl, int ld) {
  const int warp = threadIdx.x >> 5, l0 = 2 * (threadIdx.x & 31);
  for (int k = warp; k < K; k += NW) {
    float c0 = 0.f, c1 = 0.f;
    HeadDt d{0.f, 0.f, 0.f};
    if (k < nh) {
      const float* dtg = dt + bi * dts[0] + (h0 + k) * dts[2];
      const int s = s0 + l0;
      d = HeadDt{s < S ? dtg[s * dts[1]] : 0.f, s + 1 < S ? dtg[(s + 1) * dts[1]] : 0.f, a[h0 + k]};
      lane_cumsum(d, c0, c1);
    }
    cum[k * ld + l0] = c0, cum[k * ld + l0 + 1] = c1;
    if (dtl) dtl[k * ld + l0] = d.d0, dtl[k * ld + l0 + 1] = d.d1;
  }
}

// A warp's (16 x 8 NJ) block of A B over k < K, in 3xTF32 on the tensor cores
// (a pass fewer for an operand exact in TF32: AX, BX), A given transposed
// (At[k * lda + row]), B as stored (Bm[k * ldb + col]); rows r0 .., columns
// c0 ..; each (row, col, value pair) handed to store(row, col, v0, v1).
template <int NJ, int K, bool AX, bool BX, typename Store>
__device__ __forceinline__ void warp_block(const float* At, int lda, const float* Bm, int ldb, int r0,
                                           int c0, Store store) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  float acc[NJ][4];
  zero_acc(acc);
  warp_mma<NJ, AX, BX>(
      acc, [&](int hi, int e, int kb) { return At[(kb + tq + 4 * e) * lda + r0 + gq + 8 * hi]; },
      [&](int e, int kb, int j) { return Bm[(kb + tq + 4 * e) * ldb + c0 + 8 * j + gq]; }, 0, K);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    store(r0 + gq, c0 + 8 * j + 2 * tq, acc[j][0], acc[j][1]);
    store(r0 + gq + 8, c0 + 8 * j + 2 * tq, acc[j][2], acc[j][3]);
  }
}

// The raw scores R[l][m] = C_l . B_m of a chunk for m <= l, from C and B
// transposed (Ct, Bt: N x ld), by the 8 warps of a block: warp w the rows
// 16 (w % 4) .. and columns 32 (w / 4) .. + 31 (the warp wholly above the
// diagonal skips).  EX: C and B bf16, exact in TF32 (one pass).
template <int N, bool EX, typename Store>
__device__ __forceinline__ void raw_scores(const float* Ct, const float* Bt, int ld, Store store) {
  const int warp = threadIdx.x >> 5, r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
  if (c0 <= r0 + 15) warp_block<4, N, EX, EX>(Ct, ld, Bt, ld, r0, c0, store);
}

// The chunk-state product of the narrow tiles, forward and backward: per head
// h of a block's tiles,  out_h = Op^T (In_h o w_h)  (N x Q), Op the group's
// rows of B (forward) or C (backward), In x or dY,
//   forward:  w = dt exp(cum_{L-1} - cum), and exp(cum_{L-1}) into decay;
//   backward: w = exp(cum), the chunk's share Z_c of the state gradient.
// One product of Op^T (N x L) by the packed (L x 16) tile serves its K heads.
struct NarrowStateArgs {
  const void* op;  // (B, S, G, N)
  const void* in;  // (B, S, H, Q)
  const float* dt;
  const float* a;
  float* out;    // (B*H, nc, N, Q)
  float* decay;  // (B*H, nc): forward only
  int S, H, G, nc, kt;
  long long ops[3], ins[3], dts[3];  // (batch, sequence, head or group) element strides
};

template <int N, int Q>
struct NarrowStateSmem {
  static constexpr int OB = N + 8, XW = 24;  // rows padded: the mma fragments' loads spread over the banks
  static constexpr int BYTES = (L * OB + L * XW + 2 * Packed<Q>::K * L) * static_cast<int>(sizeof(float));
};

template <typename T, int N, int Q, bool GRAD>
__device__ __forceinline__ void narrow_chunk_state(const NarrowStateArgs& p) {
  using SM = NarrowStateSmem<N, Q>;
  constexpr int K = Packed<Q>::K, NT = nt_state(N, 16), NW = NT / 32, VT = 16 / sizeof(T);
  constexpr int OB = SM::OB, XW = SM::XW;
  // warps over the output's N / 16 row blocks and 16 / (8 NJ) column blocks
  constexpr int RB = N / 16, CB = NW / RB, NJ = 2 / CB;
  static_assert(RB * CB == NW && NJ * CB == 2, "warp layout");
  extern __shared__ float4 smem4[];
  float* Ops = reinterpret_cast<float*>(smem4);  // L x OB: B or C
  float* Xw = Ops + L * OB;                      // L x XW: the tile's In o w
  float* cum = Xw + L * XW;                      // K x L
  float* dtl = cum + K * L;                      // K x L
  const int tid = threadIdx.x, warp = tid >> 5;
  const NarrowBlock blk(p.H, p.G, K, p.kt);
  const T* og = static_cast<const T*>(p.op) + blk.bi * p.ops[0] + blk.g * p.ops[2];
  for (int i = tid; i < L * N / VT; i += NT) {
    const int l = i / (N / VT), n = (i % (N / VT)) * VT, s = blk.s0 + l;
    float v[VT] = {};
    if (s < p.S) load16(og + s * p.ops[1] + n, v);
#pragma unroll
    for (int k = 0; k < VT; ++k) Ops[l * OB + n + k] = v[k];
  }
  for (int tt = 0; tt < p.kt; ++tt) {
    const int tile = blk.t0 + tt, h0 = blk.head0(tile, K), nh = blk.heads(tile, K);
    __syncthreads();  // the last tile's product is done with Xw, cum and dtl
    narrow_cumsums<K, NW>(p.dt, p.dts, p.a, blk.bi, blk.s0, p.S, h0, nh, cum, dtl, L);
    __syncthreads();
    if constexpr (!GRAD) {  // each head's decay over the chunk
      if (tid < nh) p.decay[(static_cast<long long>(blk.bi) * p.H + h0 + tid) * p.nc + blk.ch] =
          expf(cum[tid * L + L - 1]);
    }
    const T* ig = static_cast<const T*>(p.in) + blk.bi * p.ins[0] + h0 * p.ins[2];
    for (int i = tid; i < L * 4; i += NT) {  // row i / 4, columns 4 (i % 4) .. + 3
      const int l = i >> 2, c0 = (i & 3) * 4, s = blk.s0 + l;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (s < p.S) load_packed4<Q>(ig + s * p.ins[1], p.ins[2], c0, nh, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = (c0 + j) / Q;
        const float c = cum[k * L + l];
        const float w = GRAD ? expf(c) : dtl[k * L + l] * expf(cum[k * L + L - 1] - c);
        Xw[l * XW + c0 + j] = v[j] * w;
      }
    }
    __syncthreads();
    // Op^T (In o w) in 3xTF32 (B and C exact in bf16), each head's (N, Q) slab
    // from head k's columns k Q .. k Q + Q - 1
    float* out = p.out + ((static_cast<long long>(blk.bi) * p.H + h0) * p.nc + blk.ch) * N * Q;
    const long long hstride = static_cast<long long>(p.nc) * N * Q;
    warp_block<NJ, L, sizeof(T) == 2, false>(
        Ops, OB, Xw, XW, 16 * (warp % RB), 8 * NJ * (warp / RB), [&](int n, int c, float v0, float v1) {
          if constexpr (Q >= 2) {
            if (c / Q < nh) store_pair(out + (c / Q) * hstride + n * Q + c % Q, v0, v1);
          } else {
            if (c < nh) out[c * hstride + n] = v0;
            if (c + 1 < nh) out[(c + 1) * hstride + n] = v1;
          }
        });
  }
}

}  // namespace
