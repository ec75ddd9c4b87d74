// Flash attention forward for Hopper (sm_90a) on the tensor cores, with a
// plain C interface.
//
// Replaces the JAX package's Pallas TPU kernel `kernels/flash_attention.py`
// (`flash_attention`, body `_flash_kernel`): blockwise online-softmax
// attention with f32 running max / denominator / accumulator, causal,
// sliding-window and key-length masks, fully masked tiles skipped, and one
// cast on the write.
//
// What bounds it on the H100.  At prefill lengths the work is operations:
// 4*hd flops per unmasked (query, key) pair against 2*hd*(bytes per element)
// bytes of q/k/v/o per token.  bf16 products run at 989 TFLOP/s on the
// tensor cores.  f32 has no full-precision tensor-core product, and one TF32
// pass keeps about 3 decimal digits, so f32 runs 3xTF32: each operand splits
// into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest (ties
// away, as cvt.rna.tf32), and every product sums lo*hi + hi*lo + hi*hi in
// f32 (small terms first), three TF32 products at 495 TFLOP/s for every f32
// one.
//
// The design, one kernel per dtype, both with the same block:
//   * One block per (128-query tile, batch*head), 384 threads: warpgroup 0
//     is the producer, warpgroups 1 and 2 each own 64 query rows.
//     `setmaxnreg` gives the producer 24 registers and each consumer 240.
//   * One producer thread loads the Q tile once and keeps a ring of K/V
//     stages in flight with TMA (4-D tensor maps over the model layout, so
//     rows past S or T arrive as zeros); each stage has a full and an empty
//     barrier for K and the same for V.  Each of the 8 consumer warps
//     arrives on K's empty barrier once S is computed and on V's once P V
//     is, so the next K loads while a tile's softmax and P V run.  Rows are
//     split into boxes of at most 128 bytes under the matching TMA swizzle
//     (128, 64 or 32 B), so shared-memory reads are free of bank conflicts.
//   * The key tile and the number of stages are per (type, head_dim)
//     (`Tile`): up to head_dim 128, bf16 128 keys and f32 64, two stages.
//     head_dim 96 (phi-3-vision) has bf16 rows of 192 bytes, three boxes of
//     64 bytes under the 64 B swizzle (P V is `wgmma.m64n96k16`), and f32
//     rows of 384 bytes, three boxes of 128.
//     head_dim 256 (gemma3) has rows of 512 (bf16) or 1024 (f32) bytes, so
//     its Q tile alone is 64 or 128 KB of the block's 227: bf16 takes 64
//     keys in two stages (192 KB, and o[128] + S[32] + P[16] registers of a
//     consumer's 240), f32 the key tile and stages of `F32_HD256_*`.
//   * bf16: S = Q K^T is `wgmma.m64n{BK}k16` with both
//     operands K-major in shared memory; the online softmax runs on the
//     accumulator registers (scale and mask before exp2, masks only on tiles
//     that cross the diagonal, the window edge or T); P is packed to bf16x2
//     in registers and is the A operand of O += P V (`m64n{hd}k16`), with V
//     the B operand through an MN-major descriptor.
//   * f32: each warp runs `mma.sync.m16n8k8` TF32 on 16 query
//     rows, reading its fragments from the swizzled tiles and splitting them
//     in registers.  P stays in registers: the accumulator's column pairs
//     (2t, 2t+1) serve as the A fragment's k = (t, t+4), and V's rows are
//     read in the same order.
//   * Tiles above the causal diagonal or left of the window are never
//     loaded; a consumer warpgroup whose 64 rows are all masked on a tile
//     (or all past S) waits for it and releases it without computing.  q
//     tiles are scheduled heaviest (latest) first.
//   * A query offset: query row i sits at position q_offset + i of the key
//     sequence (keys from 0), so one rank of a sequence-split attention
//     takes its own rows against the whole K/V.  Every mask, every
//     tile-skip test and a tile's key range compare keys with positions.
//   * GQA: head h reads K/V group h / (H/G) through the tensor maps; nothing
//     is repeated in memory.  A masked score is -inf and the running max
//     starts at -1e30, so a row with no valid key keeps p = 0 and writes 0.
//   * Rows, strides and base pointers must suit TMA: 16-byte aligned base,
//     byte strides that are multiples of 16 (the wrapper checks both).
//   * Optionally (training) each row's log-sum-exp of its scaled scores,
//     m + log(l) in natural log, goes to an f32 (B, H, S) array for the
//     backward kernels (`flash_attention_bwd.cu`); serving passes no array
//     and writes none.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;           // query rows per block: two consumer warpgroups of 64
constexpr int NTHREADS = 384;     // the producer warpgroup and two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr float M_FLOOR = -1e30f;

// f32 at head_dim 256: the Q tile alone takes 128 KB, so the K/V ring gets
// what is left (PERF.md gives the shapes tried on the card).
constexpr int F32_HD256_BK = 32;
constexpr int F32_HD256_NSTAGE = 1;

// The tile shape of one (type, head_dim): keys per tile (BK) and K/V stages
// in flight (NSTAGE).  Up to head_dim 128: bf16 BK 128, f32 BK 64, two
// stages.  At 256 the rows are four (bf16) or eight (f32) TMA boxes of 128
// bytes, and the bf16 consumer's o[128] + S[BK/2] + P[BK/4] registers fit
// its 240 at BK 64, not at 128.
template <typename T, int HD>
struct Tile : RowBoxes<T, HD> {
  using R = RowBoxes<T, HD>;
  static constexpr int BK = R::ES == 2 ? (HD <= 128 ? 128 : 64) : (HD <= 128 ? 64 : F32_HD256_BK);
  static constexpr int NSTAGE = R::ES == 2 || HD <= 128 ? 2 : F32_HD256_NSTAGE;
  static constexpr int Q_BYTES = BQ * R::ROWB;
  static constexpr int KV_BYTES = BK * R::ROWB;
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * NSTAGE * KV_BYTES + 8 * (1 + 4 * NSTAGE);
  static_assert(SMEM <= SMEM_LIMIT, "the tiles do not fit a block's shared memory");
};

struct Params {
  CUtensorMap tq, tk, tv;  // (hd, S, H, B) for q; (hd, T, G, B) for k and v
  void* o;
  float* lse;              // (B, H, S) row log-sum-exp, or null
  long long os[3];         // element strides of o: batch, sequence, head
  int S, T, H, G, causal, window;
  int q_offset;            // query row i sits at position q_offset + i; keys from 0
  float scale_log2;        // softmax scale times log2(e)
};

// ---------------------------------------------------------------------------
// online softmax on accumulator fragments, shared by both dtypes
//
// A warp owns 16 query rows; its accumulator over N columns holds, for n8
// block j, s[4j + e] = (row g + 8*(e >> 1), column 8j + 2t + (e & 1)) with
// g = lane / 4 and t = lane % 4 (the wgmma and the mma.sync layouts agree).

template <int N>
__device__ __forceinline__ void online_softmax(float* s, float* m, float* l, float* alpha,
                                               int q_row, int k_col, bool mask,
                                               const Params& p) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * p.scale_log2;
      if (mask) {
        const int kj = k_col + 8 * j + (e & 1);
        const int qi = q_row + 8 * (e >> 1) + p.q_offset;  // the row's position
        const bool ok = kj < p.T && (!p.causal || kj <= qi) && (p.window <= 0 || kj > qi - p.window);
        x = ok ? x : -INFINITY;
      }
      s[4 * j + e] = x;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = M_FLOOR;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pe = exp2f(s[4 * j + 2 * r + e] - m_new);  // exactly 0 where masked
        s[4 * j + 2 * r + e] = pe;
        sum += pe;
      }
    }
    l[r] = l[r] * alpha[r] + sum;  // this thread's part of the row; lanes add up at the end
  }
}

template <int N>
__device__ __forceinline__ void rescale(float* o, const float* alpha) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// Divides by the row sums and writes the rows below S, one cast each, and
// the rows' log-sum-exp where asked (+inf for a row with no valid key, so
// that the backward gives it p = 0).
template <typename T, int HD>
__device__ __forceinline__ void write_out(const Params& p, const float* o, const float* m, float* l,
                                          int b, int h, int q_row, int col) {
  T* og = static_cast<T*>(p.o) + b * p.os[0] + h * p.os[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q_row + 8 * r;
    if (qi >= p.S) continue;  // padded query rows are dropped
    if (p.lse != nullptr && col == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.S + qi] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * (1.f / LOG2E) : INFINITY;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* row = og + qi * p.os[1] + col;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store_pair(row + 8 * j, o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

// What a block works on, and where its shared memory lies.
struct Work {
  uint8_t *sq, *sk, *sv;
  uint64_t *q_full, *k_full, *v_full, *k_empty, *v_empty;
  int b, h, g, q0, k_begin, n_tiles;
};

// Whether a warpgroup whose rows start at r (64 of them) needs no mask on a
// tile of keys [k0, k0 + bk) restricted to 16 rows from rw; and whether all
// 64 rows are masked on it.  Rows are compared with keys at their positions
// (row + q_offset).
__device__ __forceinline__ bool tile_unmasked(const Params& p, int k0, int bk, int rw) {
  const int pw = rw + p.q_offset;
  return k0 + bk <= p.T && (!p.causal || k0 + bk - 1 <= pw) &&
         (p.window <= 0 || k0 > pw + 15 - p.window);
}
__device__ __forceinline__ bool tile_all_masked(const Params& p, int k0, int bk, int r) {
  const int pr = r + p.q_offset;
  return r >= p.S || (p.causal && k0 > pr + 63) || (p.window > 0 && k0 + bk - 1 <= pr - p.window);
}

// ---------------------------------------------------------------------------
// producer: one thread

template <typename T, int HD>
__device__ void produce(const Params& p, const Work& w) {
  using C = Tile<T, HD>;
  mbar_expect_tx(w.q_full, C::Q_BYTES);
  tma_load_rows<T, HD>(w.sq, &p.tq, w.q_full, BQ, w.q0, w.h, w.b);
  for (int i = 0; i < w.n_tiles; ++i) {
    const int s = i % C::NSTAGE;
    const uint32_t free_ph = ((i / C::NSTAGE) & 1) ^ 1;  // the first round passes at once
    const int k0 = w.k_begin + i * C::BK;
    mbar_wait(w.k_empty + s, free_ph);
    mbar_expect_tx(w.k_full + s, C::KV_BYTES);
    tma_load_rows<T, HD>(w.sk + s * C::KV_BYTES, &p.tk, w.k_full + s, C::BK, k0, w.g, w.b);
    mbar_wait(w.v_empty + s, free_ph);
    mbar_expect_tx(w.v_full + s, C::KV_BYTES);
    tma_load_rows<T, HD>(w.sv + s * C::KV_BYTES, &p.tv, w.v_full + s, C::BK, k0, w.g, w.b);
  }
}

// ---------------------------------------------------------------------------
// consumers: bf16 on wgmma

template <int HD>
__device__ void consume_bf16(const Params& p, const Work& w, int cw) {
  using C = Tile<__nv_bfloat16, HD>;
  constexpr int BK = C::BK;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int r_wg = w.q0 + 64 * cw;            // first row of this warpgroup
  const int rw = r_wg + 16 * warp;            // first row of this warp
  const int q_row = rw + lane / 4, col = 2 * (lane % 4);
  float o[HD / 2], m[2] = {M_FLOOR, M_FLOOR}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  const uint32_t q_addr = smem_u32(w.sq) + cw * 64 * C::W;
  mbar_wait(w.q_full, 0);
  for (int i = 0; i < w.n_tiles; ++i) {
    const int s = i % C::NSTAGE;
    const uint32_t ph = (i / C::NSTAGE) & 1;
    const int k0 = w.k_begin + i * BK;
    const bool skip = tile_all_masked(p, k0, BK, r_wg);
    mbar_wait(w.k_full + s, ph);
    if (!skip) {
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      const uint32_t k_addr = smem_u32(w.sk + s * C::KV_BYTES);
      wgmma_fence();
      wgmma_ss_rows<BK, HD, C::W>(sc, q_addr, BQ, k_addr, BK, true);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BK / 2>(sc);
      release(w.k_empty + s, lane);
      online_softmax<BK>(sc, m, l, alpha, q_row, k0 + col, !tile_unmasked(p, k0, BK, rw), p);
      rescale<HD>(o, alpha);
      uint32_t pa[BK / 16][4];
      pack_a_bf16<BK>(sc, pa);
      mbar_wait(w.v_full + s, ph);
      const uint32_t v_addr = smem_u32(w.sv + s * C::KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<HD>(o, pa[kk], mnmajor_desc<C::W>(v_addr + kk * 16 * C::W, BK * C::W));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<HD / 2>(o);
    } else {
      release(w.k_empty + s, lane);
      mbar_wait(w.v_full + s, ph);
    }
    release(w.v_empty + s, lane);
  }
  write_out<__nv_bfloat16, HD>(p, o, m, l, w.b, w.h, q_row, col);
}

// ---------------------------------------------------------------------------
// consumers: f32 in 3xTF32 on mma.sync

template <int HD>
__device__ void consume_f32(const Params& p, const Work& w, int cw) {
  using C = Tile<float, HD>;
  constexpr int BK = C::BK, W = C::W;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_wg = w.q0 + 64 * cw;
  const int rw = r_wg + 16 * warp;
  const int qr = 64 * cw + 16 * warp + g;  // this thread's first row within the Q tile
  float o[HD / 2], m[2] = {M_FLOOR, M_FLOOR}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  mbar_wait(w.q_full, 0);
  for (int i = 0; i < w.n_tiles; ++i) {
    const int s = i % C::NSTAGE;
    const uint32_t ph = (i / C::NSTAGE) & 1;
    const int k0 = w.k_begin + i * BK;
    const bool skip = tile_all_masked(p, k0, BK, r_wg);
    mbar_wait(w.k_full + s, ph);
    if (!skip) {
      const uint8_t* kt = w.sk + s * C::KV_BYTES;
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const int c = 8 * kk + t;
        uint32_t ah[4], al[4];
        ld_a_3xtf32<W>(w.sq, BQ, qr, c, ah, al);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          uint32_t bh[2], bl[2];
          split_tf32(ld_tile<W>(kt, BK, 8 * j + g, c), bh[0], bl[0]);
          split_tf32(ld_tile<W>(kt, BK, 8 * j + g, c + 4), bh[1], bl[1]);
          mma_3xtf32(sc + 4 * j, ah, al, bh, bl);
        }
      }
      release(w.k_empty + s, lane);
      online_softmax<BK>(sc, m, l, alpha, rw + g, k0 + 2 * t, !tile_unmasked(p, k0, BK, rw), p);
      rescale<HD>(o, alpha);
      mbar_wait(w.v_full + s, ph);
      const uint8_t* vt = w.sv + s * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        // k = t holds key 8kk + 2t and k = t + 4 key 8kk + 2t + 1
        uint32_t ah[4], al[4];
        acc_a_3xtf32(sc + 4 * kk, ah, al);
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          uint32_t bh[2], bl[2];
          split_tf32(ld_tile<W>(vt, BK, 8 * kk + 2 * t, 8 * n + g), bh[0], bl[0]);
          split_tf32(ld_tile<W>(vt, BK, 8 * kk + 2 * t + 1, 8 * n + g), bh[1], bl[1]);
          mma_3xtf32(o + 4 * n, ah, al, bh, bl);
        }
      }
    } else {
      release(w.k_empty + s, lane);
      mbar_wait(w.v_full + s, ph);
    }
    release(w.v_empty + s, lane);
  }
  write_out<float, HD>(p, o, m, l, w.b, w.h, rw + g, 2 * t);
}

// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS, 1) flash_fwd_kernel(const __grid_constant__ Params p) {
  using C = Tile<T, HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);  // swizzle atoms need 1024 B
  Work w;
  w.sq = smem;
  w.sk = w.sq + C::Q_BYTES;
  w.sv = w.sk + C::NSTAGE * C::KV_BYTES;
  w.q_full = reinterpret_cast<uint64_t*>(w.sv + C::NSTAGE * C::KV_BYTES);
  w.k_full = w.q_full + 1;
  w.v_full = w.k_full + C::NSTAGE;
  w.k_empty = w.v_full + C::NSTAGE;
  w.v_empty = w.k_empty + C::NSTAGE;
  w.b = blockIdx.x / p.H;
  w.h = blockIdx.x % p.H;
  w.g = w.h / (p.H / p.G);
  w.q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  // the keys this tile's rows see: j <= position (causal), j > position - window
  const int pos0 = p.q_offset + w.q0;
  const int k_end = p.causal ? min(p.T, pos0 + BQ) : p.T;
  w.k_begin = (p.window > 0 ? max(0, pos0 - p.window + 1) : 0) / C::BK * C::BK;
  w.n_tiles = k_end > w.k_begin ? (k_end - w.k_begin + C::BK - 1) / C::BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(w.q_full, 1);
    for (int s = 0; s < C::NSTAGE; ++s) {
      mbar_init(w.k_full + s, 1);
      mbar_init(w.v_full + s, 1);
      mbar_init(w.k_empty + s, CONSUMER_WARPS);
      mbar_init(w.v_empty + s, CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) produce<T, HD>(p, w);
  } else {
    setmaxnreg_inc<240>();
    if constexpr (sizeof(T) == 2)
      consume_bf16<HD>(p, w, threadIdx.x / 128 - 1);
    else
      consume_f32<HD>(p, w, threadIdx.x / 128 - 1);
  }
}

// ---------------------------------------------------------------------------
// host

template <typename T, int HD>
int launch(Params& p, const void* q, const void* k, const void* v, int B,
           const long long* strides, cudaStream_t stream) {
  using C = Tile<T, HD>;
  // once per kernel: the attribute holds for every later launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  if (!encode_rows<T, HD>(&p.tq, q, p.S, p.H, B, strides, BQ) ||
      !encode_rows<T, HD>(&p.tk, k, p.T, p.G, B, strides + 3, C::BK) ||
      !encode_rows<T, HD>(&p.tv, v, p.T, p.G, B, strides + 6, C::BK))
    return ENCODE_FAILED;
  const dim3 grid(B * p.H, (p.S + BQ - 1) / BQ);
  flash_fwd_kernel<T, HD><<<grid, NTHREADS, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch_hd(Params& p, const void* q, const void* k, const void* v, int B, int hd,
                const long long* strides, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(p, q, k, v, B, strides, stream);
    case 32: return launch<T, 32>(p, q, k, v, B, strides, stream);
    case 64: return launch<T, 64>(p, q, k, v, B, strides, stream);
    case 96: return launch<T, 96>(p, q, k, v, B, strides, stream);
    case 128: return launch<T, 128>(p, q, k, v, B, strides, stream);
    case 256: return launch<T, 256>(p, q, k, v, B, strides, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,S,H,hd), k/v (B,T,G,hd), o (B,S,H,hd) with the last dim contiguous;
// lse: an f32 (B,H,S) contiguous array for each row's log-sum-exp, or null;
// strides[12] = (batch, seq, head) element strides of q, k, v, o; query row i
// sits at position q_offset + i (>= 0) and key j at j.  q, k and v
// must suit TMA: 16-byte aligned base, byte strides that are multiples of 16
// (dims of extent 1 aside).  dtype: 0 = float32, 1 = bfloat16.  Returns 0 on
// success, -1 if a tensor map could not be encoded, else the CUDA error of
// the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int dtype, int B, int S, int T, int H, int G, int hd,
                                   const long long* strides, int causal, int window,
                                   int q_offset, float scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || G <= 0 || H % G != 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.o = o;
  p.lse = lse;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.S = S;
  p.T = T;
  p.H = H;
  p.G = G;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale_log2 = scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0   ? dispatch_hd<float>(p, q, k, v, B, hd, strides, st)
         : dtype == 1 ? dispatch_hd<__nv_bfloat16>(p, q, k, v, B, hd, strides, st)
                      : static_cast<int>(cudaErrorInvalidValue);
}
