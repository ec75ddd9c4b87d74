// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (`flash_attention.cu`, `flash_attention_bwd.cu`): mbarriers, TMA loads and
// their tensor maps, `setmaxnreg`, bf16 `wgmma` with its shared-memory
// descriptors, and 3xTF32 products on `mma.sync` for f32.
//
// Tiles in shared memory follow one layout.  A tile of `rows` rows of W*NBOX
// bytes is stored as NBOX boxes one after another, box x holding bytes
// [x*W, (x+1)*W) of every row, each row W bytes, under the TMA swizzle of W
// bytes (128, 64 or 32); a tile starts on a 1024-byte boundary.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may take on the H100
constexpr float LOG2E = 1.4426950408889634f;

// A row of HD elements of T as TMA boxes: W bytes of a row per box (the
// widest of 128, 64 and 32 that divides the row; 192-byte rows take three
// boxes of 64), NBOX boxes per row.
template <typename T, int HD>
struct RowBoxes {
  static constexpr int ES = sizeof(T);
  static constexpr int ROWB = HD * ES;
  static constexpr int W = ROWB % 128 == 0 ? 128 : ROWB % 64 == 0 ? 64 : 32;
  static constexpr int NBOX = ROWB / W;
  static_assert(NBOX * W == ROWB, "a row must be whole TMA boxes");
};

// ---------------------------------------------------------------------------
// barriers, TMA, register hand-over

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// All NBOX boxes of `rows` rows from row c1 of (c2, c3) into a tile at dst.
template <typename T, int HD>
__device__ __forceinline__ void tma_load_rows(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                              int rows, int c1, int c2, int c3) {
  using R = RowBoxes<T, HD>;
#pragma unroll
  for (int x = 0; x < R::NBOX; ++x)
    tma_load_4d(dst + x * rows * R::W, map, bar, x * R::W / R::ES, c1, c2, c3);
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// A consumer warp is done with a stage: lane 0 arrives for the warp.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// ---------------------------------------------------------------------------
// wgmma (bf16)

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Ties the accumulator registers to the wait above, so no read of them is
// scheduled before it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Swizzle mode of a span of W bytes, as the wgmma descriptor encodes it.
template <int W>
__host__ __device__ constexpr uint64_t desc_layout() {
  return W == 128 ? 1 : W == 64 ? 2 : 3;
}

// K-major operand: rows of W bytes, 8-row groups every 8*W bytes.
template <int W>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (static_cast<uint64_t>(8 * W / 16) << 32) | (desc_layout<W>() << 62);
}

// MN-major operand (a tile's rows as the K of B, its columns as N): W-byte
// spans of N, one per box, `lbo` bytes apart; 8-row groups every 8*W bytes.
template <int W>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(8 * W / 16) << 32) | (desc_layout<W>() << 62);
}

#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D8(i) WG_D4(i), WG_D4(i + 4)
#define WG_D16(i) WG_D8(i), WG_D8(i + 8)
#define WG_D32(i) WG_D16(i), WG_D16(i + 16)
#define WG_D64(i) WG_D32(i), WG_D32(i + 32)
#define WG_D128(i) WG_D64(i), WG_D64(i + 64)

// d (64 x N f32, accumulated) += a (64 x 16 bf16, registers) * B (16 x N, MN-major in shared memory)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc_b);
// d (64 x N) = (scale_d ? d : 0) + A (64 x 16, K-major) * B (16 x N, K-major), both in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t desc_a, uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : WG_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : WG_D32(0), WG_D16(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_D128(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(0)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D64(0)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

#undef WG_D128
#undef WG_D64
#undef WG_D32
#undef WG_D16
#undef WG_D8
#undef WG_D4

// d (64 x N, accumulated) += A (64 x HD, K-major tile at a) * B^T, B an
// (N x HD) K-major tile at b: the tiles' rows split into boxes of W bytes,
// a_rows and b_rows rows per box.  The product of the first k-slice
// overwrites d where `fresh`.
template <int N, int HD, int W>
__device__ __forceinline__ void wgmma_ss_rows(float* d, uint32_t a, int a_rows, uint32_t b,
                                              int b_rows, bool fresh) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int box = kk * 32 / W, inb = kk * 32 % W;
    wgmma_ss<N>(d, kmajor_desc<W>(a + box * a_rows * W + inb),
                kmajor_desc<W>(b + box * b_rows * W + inb), kk > 0 || !fresh);
  }
}

// 64 x N f32 accumulator fragments as bf16 A operands of m64k16 products:
// the accumulator's columns 16kk .. 16kk + 15 are the A operand's k.
template <int N>
__device__ __forceinline__ void pack_a_bf16(const float* s, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      __nv_bfloat162 two = __floats2bfloat162_rn(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
      a[kk][x] = *reinterpret_cast<uint32_t*>(&two);
    }
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 (f32)

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero: what cvt.rna.tf32.f32 returns for every finite x and for
// infinities, in two integer operations (an add of half a TF32 unit to the
// magnitude's bits, a mask).  cvt.rna.tf32.f32 itself makes the kernel
// slower on the H100 (PERF.md).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The same split in two operations: hi keeps x's top 10 explicit mantissa
// bits (truncated), lo = x - hi exactly, and the tensor core reads lo's own
// top TF32 bits.  A product of split operands is then off by at most about
// 2^-20 of its size (split_tf32: 2^-22), well inside f32 accuracy at 1e-4.
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ahi, const uint32_t* alo,
                                           const uint32_t* bhi, const uint32_t* blo) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// Element (r, c) of an f32 tile of the layout above, `box_rows` rows per box.
template <int W>
__device__ __forceinline__ float ld_tile(const uint8_t* base, int box_rows, int r, int c) {
  const int box = c * 4 / W;
  const int off = r * W + c * 4 % W;
  const int phys = off ^ (((off >> 7) & (W / 16 - 1)) << 4);
  return *reinterpret_cast<const float*>(base + box * box_rows * W + phys);
}

// A warp's m16n8k8 A fragment of rows r, r + 8 and columns c, c + 4 of an
// f32 tile, split into TF32 hi and lo parts.
template <int W>
__device__ __forceinline__ void ld_a_3xtf32(const uint8_t* base, int box_rows, int r, int c,
                                            uint32_t* hi, uint32_t* lo) {
  split_tf32(ld_tile<W>(base, box_rows, r, c), hi[0], lo[0]);
  split_tf32(ld_tile<W>(base, box_rows, r + 8, c), hi[1], lo[1]);
  split_tf32(ld_tile<W>(base, box_rows, r, c + 4), hi[2], lo[2]);
  split_tf32(ld_tile<W>(base, box_rows, r + 8, c + 4), hi[3], lo[3]);
}

// An m16n8 f32 accumulator as the A fragment of an m16n8k8 product, split:
// the accumulator's columns 2t and 2t + 1 serve as the A operand's k = t and
// t + 4, so B's rows must be read in that order (row 8kk + 2t, then + 1).
__device__ __forceinline__ void acc_a_3xtf32(const float* s, uint32_t* hi, uint32_t* lo) {
  split_tf32(s[0], hi[0], lo[0]);
  split_tf32(s[2], hi[1], lo[1]);
  split_tf32(s[1], hi[2], lo[2]);
  split_tf32(s[3], hi[3], lo[3]);
}

// ---------------------------------------------------------------------------
// host: tensor maps

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime, so that nothing
// links libcuda.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A 4-D map (hd, n, heads, batch) over a tensor of the model layout whose
// (batch, sequence, head) element strides are st; boxes of W bytes x rows.
// Rows past n read as zeros.  A dimension of extent 1 is never stepped, so
// its stride is replaced by the tensor's dense size (any multiple of 16
// would do).
template <typename T, int HD>
bool encode_rows(CUtensorMap* map, const void* ptr, int n, int heads, int batch,
                 const long long* st, int rows) {
  using R = RowBoxes<T, HD>;
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dense = (static_cast<cuuint64_t>(HD) * n * heads * batch * R::ES + 15) / 16 * 16;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {n > 1 ? st[1] * R::ES : dense, heads > 1 ? st[2] * R::ES : dense,
                                 batch > 1 ? st[0] * R::ES : dense};
  const cuuint32_t box[4] = {R::W / R::ES, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = R::W == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : R::W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType type =
      R::ES == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int ENCODE_FAILED = -1;

}  // namespace
