// The design-space explorer's simulation kernels for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the JAX package's `jax` simulation backend
// (`core/backends/jax_backend.py`), whose hot loop is XLA-jitted jnp rather
// than a Pallas kernel:
//   * `_fused_eval` (:129-146) prices every duration class x population
//     member through `simulator.batch_op_durations` (`simulator.py:525-578`)
//     and `collectives.multidim_collective_time_vec` (`collectives.py:264-315`);
//   * `_sweep_population` (:66-89) runs the max-plus longest-path recurrence
//     finish[i, p] = dur[i, p] + max(finish[parents[i, :], p]) over the ops in
//     uid order, vmapped over the members.
//
// Three kernels, float64 throughout, as the JAX backend is under `_x64`:
//
// `dse_class_times_kernel`: the (P, C) class-time table.  One thread per
// (member, class) walks the D padded dims of its packed tables
// (`simulator.plan_duration_tables`) in order, prices each dim's phase as
// `collective_time_vec` does (`collectives.py:225-261`) and reduces over the
// dims as the unrolled loop of `multidim_collective_time_vec` does
// (:299-315); transfer classes take the transfer lane
// xfer_lat + (size / xfer_bw) * 1e-3 instead.  ceil(log2(n)) is the exponent
// of frexp(n - 1), as `_vec_ceil_log2` takes it: exact.
//
// `dse_op_durations_kernel`: each op's duration for each member, one thread
// per (op, member), gathered through `src_of_op` as `batch_op_durations`
// gathers it: 0 (slot 0), the roofline max(flops / peak, bytes / membw) *
// 1e6, a class time times the op's repeat count, or a delay; written
// op-major, (n_ops, P).  The unfused path gives its durations instead and
// skips this launch.
//
// `dse_sweep_kernel`: the sweep.  It is persistent: one thread per member,
// blocks of one warp (32 members; P = 256 spreads over 8 SMs), each thread
// walking all the ops in uid order.  The finish table is op-major,
// (n_ops + 1, P), so a warp's writes of one op's row coalesce; row n_ops is
// the padded parent slot, pinned to 0.  The durations come from their own
// launch rather than being gathered in the walk: the gather's dependent
// loads would sit on the sweep's chain (on an H100 at P = 32, gathering
// inside the walk took 14.4 device ms where the sweep over given durations
// took 9.6).
//
// The walk keeps its chain on the SM.  On the request-stream trace 98.3% of
// parent reads are one or two ops back and the farthest is 233 back, so
// each thread holds the finish times of the last two ops in registers and
// the last kRing = 256 (K) in a ring in shared memory, slot (j mod K), one
// column per lane, beside a row of zeros for the padded slot.  Parent j of
// op i is taken from the registers when i - j <= 2, from the ring when
// i - j <= K, and otherwise from the finish table in device memory, which
// the same thread stored earlier (a thread reads its own stores in order).
// The padded slot n_ops, and any index outside [0, i), is 0.  The parents
// table is the same for every lane, so every choice is uniform over the
// warp.
//
// The walk's inputs do not depend on the chain, so they are staged ahead:
// tiles of T ops (kTile = 256, halved while a wide parents table does not
// fit) go by cp.async into a double buffer in shared memory while the warp
// walks the tile before.  A duration row is 8 bytes a lane (a 32-member
// row is 16-byte aligned only when P is even); the parents tile is 16-byte
// chunks (T a multiple of 4; the table's base 16-byte aligned, the last
// chunk cut to the table's end).  Finish rows are written with predicated
// streaming stores (st.global.cs): only far parents read them back.
//
// Each landed tile takes one of two walks, the same for the whole warp:
//   * walk_near, when every row has at most kRegCols = 4 parents and every
//     parent is within K ops (every tile of the request-stream trace).  The
//     lanes first turn the tile's parent indices, in place, into codes (the
//     parent's ring row offset, with its distance when it is 1 or 2); then
//     each op's ring values and duration are read two ops ahead and its
//     codes three ahead, and the op itself is predicated selects, the fmax
//     and the add: no branch but the loops' (four ops a trip, written out,
//     then the tile's last rows % 4 one a trip).  (A walk that
//     branches on the distances, or keeps a never-taken predicated load of
//     the finish table, makes the one warp wait on them every op.)
//   * walk_general, any other tile: a branch per parent on its distance,
//     the finish table read only for a parent more than K ops back.
//
// Shared memory a block: the ring (K + 1) x 32 x 8 = 64.3 KB, the
// durations 2 x (T + 4) x 32 x 8 = 130 KB and the parents 2 x (T + 4) x W
// x 4 (6.1 KB at W = 3; the 4 spare rows take reads past a tile's end):
// 200.3 KB on the request-stream trace, one block an SM.  The launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize, and a table too wide to fit
// even at T = 4 (W above 2,540 on an H100) is refused.
//
// Exactness.  nvcc contracts a * b + c into one fused multiply-add by
// default, and the build flags are shared by every source, so every product,
// sum and quotient that numpy rounds on its own goes through __dmul_rn,
// __dadd_rn, __dsub_rn or __ddiv_rn (never contracted, round to nearest).
// Max and the frexp exponent are exact.  The durations are then bit-identical
// to numpy's `plan_durations_batch`, and the finish times to a numpy max-plus
// over those durations (one rounding per add).
//
// What bounds it on the H100.
//   * The class table: P x C x D <= 32 x 24 x 6 dim entries, a few
//     microseconds of bytes and float64 operations; one launch.
//   * The durations: by bytes, each written once (6.6 MB at P = 32).
//   * The sweep: by bytes, each duration read or written once, each parent
//     index read once and each finish time written once: about 13.6 MB at
//     P = 32 on the 25,872-op request-stream trace, 4 us at 3.35 TB/s.  Its
//     true limit is the dependency chain: 12,995 levels, each an fp64 max
//     and an add that wait on the op before (34 cycles a dependent fmax and
//     add on an H100, measured by dse_fp64_probe).  One warp issues every
//     op of walk_near, the chain in it a select, one or two fmax and the
//     add; chip_smoke.py reads its cycles an op.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// collectives.py's coefficient tables: concurrently driven links per NPU,
// [topo kind (ring, switch, fc)][algo (ring, direct, rhd, dbt)], -1 for the
// n-dependent fc/direct entry (n - 1); the serialized-rounds and
// injection-bytes multipliers per kind (all_reduce, all_gather,
// reduce_scatter, all_to_all).
__constant__ double kLinks[3][4] = {{1.0, 1.0, 1.0, 2.0},
                                    {1.0, 1.0, 1.0, 1.0},
                                    {1.0, -1.0, 1.0, 2.0}};
__constant__ double kStepMult[4] = {2.0, 1.0, 1.0, 1.0};
__constant__ double kWireMult[4] = {2.0, 1.0, 1.0, 1.0};
constexpr int kRingAlgo = 0, kDirectAlgo = 1, kRhdAlgo = 2, kDbtAlgo = 3;
constexpr int kRingTopo = 0;

__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double ddiv(double a, double b) { return __ddiv_rn(a, b); }

// One dim's phase: `collective_time_vec` for one element.  `size` is the
// class payload already times the dim's hierarchical scale.
__device__ double phase_time(int kind, double size, double n, double bw, double lat, int topo,
                             int algo, double c) {
  if (!(n > 1.0 && size > 0.0)) return 0.0;
  int e;
  frexp(fmax(dsub(n, 1.0), 1.0), &e);
  const double lg = fmax(static_cast<double>(e), 1.0);
  const double per_pass = algo == kRingAlgo ? dsub(n, 1.0) : (algo == kDirectAlgo ? 1.0 : lg);
  const double steps = dmul(dmul(per_pass, kStepMult[kind]), c);
  const double frac = ddiv(dsub(n, 1.0), n);
  const double wire = dmul(dmul(kWireMult[kind], size), frac);
  double links = kLinks[topo][algo];
  if (links < 0.0) links = dsub(n, 1.0);
  double cong = 1.0;
  if (topo == kRingTopo && algo == kDirectAlgo) cong = ddiv(n, 4.0);
  if (topo == kRingTopo && algo == kRhdAlgo) cong = fmax(1.0, ddiv(ddiv(n, 2.0), lg));
  if (topo == kRingTopo && algo == kDbtAlgo) cong = fmax(1.0, ddiv(n, dmul(2.0, lg)));
  if (n <= 2.0) cong = 1.0;
  const double eff_bw = ddiv(dmul(bw, links), cong);
  return dadd(dmul(steps, lat), dmul(ddiv(wire, eff_bw), 1e-3));
}

struct ClassArgs {
  const int32_t* kind;    // (C,) collective kind id
  const double* size;     // (C,) class payload bytes
  const bool* is_xfer;    // (C,) transfer-lane classes
  const double* npus;     // (P, C, D) dim tables, padded with npus 1
  const double* bw;
  const double* lat;
  const double* scale;
  const int32_t* topo;
  const int32_t* algo;
  const double* chunks;   // (P,)
  const bool* blue;       // (P,) blueconnect mode
  const double* xfer_bw;  // (P,)
  const double* xfer_lat; // (P,)
  double* out;            // (P, C)
  int P, C, D;
};

__global__ void dse_class_times_kernel(ClassArgs a) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(a.P) * a.C) return;
  const int p = static_cast<int>(idx / a.C), cls = static_cast<int>(idx % a.C);
  const double size = a.size[cls];
  double t;
  if (a.is_xfer[cls]) {
    t = dadd(a.xfer_lat[p], dmul(ddiv(size, a.xfer_bw[p]), 1e-3));
  } else {
    const int kind = a.kind[cls];
    const double c = fmax(a.chunks[p], 1.0);
    const long long row = idx * a.D;
    double sum_p = 0.0, max_p = 0.0, base_sum = 0.0;
    int active = 0;
    for (int d = 0; d < a.D; ++d) {
      const double n = a.npus[row + d];
      const double ph = phase_time(kind, dmul(size, a.scale[row + d]), n, a.bw[row + d],
                                   a.lat[row + d], a.topo[row + d], a.algo[row + d], c);
      if (d == 0) {
        sum_p = ph;
        max_p = ph;
        base_sum = ddiv(ph, c);
      } else {
        sum_p = dadd(sum_p, ph);
        max_p = fmax(max_p, ph);
        base_sum = dadd(base_sum, ddiv(ph, c));
      }
      active += n > 1.0;
    }
    if (active <= 1) {
      t = sum_p;  // 0 or 1 active dims: the bare phase, no cross-dim pipelining
    } else if (a.blue[p]) {
      t = dadd(max_p, ddiv(dsub(sum_p, max_p), c));
    } else {
      t = dadd(base_sum, dmul(ddiv(dsub(c, 1.0), c), max_p));
    }
  }
  a.out[idx] = t;
}

struct SweepArgs {
  const int32_t* __restrict__ parents;     // (n_ops, W) augmented parents, padded with n_ops
  const int32_t* __restrict__ src_of_op;   // (n_ops,) slot in [zero | comp | coll | delay]
  const double* __restrict__ comp_flops;   // (n_comp,)
  const double* __restrict__ comp_bytes;   // (n_comp,)
  const double* __restrict__ peak;         // (P,) FLOP/s
  const double* __restrict__ membw;        // (P,) bytes/s
  const double* __restrict__ class_t;      // (P, C)
  const int32_t* __restrict__ coll_class;  // (n_coll,)
  const double* __restrict__ coll_repeat;  // (n_coll,)
  const double* __restrict__ delay_us;     // (n_delay,)
  const double* __restrict__ dur_in;       // (n_ops, P) the durations the sweep reads
  double* __restrict__ dur_out;            // (n_ops, P) gathered durations
  double* finish;  // (n_ops + 1, P): written and, for far parents, read back
  int n_ops, P, W, n_comp, n_coll, C;
};

constexpr int kLanes = 32;   // members a block: one warp
constexpr int kRing = 256;   // K: the finish times of a member's last K ops in shared memory
constexpr int kTile = 256;   // T: ops a staged tile (halved for a wide parents table)
constexpr int kRegCols = 4;  // the widest parent rows the branch-free walk takes
constexpr int kSlack = 4;    // rows a tile buffer holds past T (a multiple of 4: 16-byte buffers)

// Dynamic shared memory of a sweep block: the ring and its zero row, then
// two tiles of durations and two of parents.
constexpr long long sweep_smem(long long tile, long long W) {
  return (kRing + 1) * kLanes * 8LL + 2 * (tile + kSlack) * (kLanes * 8 + W * 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
// 16 bytes into shared memory, of which the first `src_bytes` are read and
// the rest are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest has landed (this lane's copies)
__device__ __forceinline__ void cp_async_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__global__ void dse_op_durations_kernel(SweepArgs a) {
  const long long at = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (at >= static_cast<long long>(a.n_ops) * a.P) return;
  const int i = static_cast<int>(at / a.P), p = static_cast<int>(at % a.P);
  const int coll_base = 1 + a.n_comp, delay_base = coll_base + a.n_coll;
  const int s = a.src_of_op[i];
  double d;
  if (s == 0) {
    d = 0.0;
  } else if (s < coll_base) {
    const int k = s - 1;
    d = dmul(fmax(ddiv(a.comp_flops[k], a.peak[p]), ddiv(a.comp_bytes[k], a.membw[p])), 1e6);
  } else if (s < delay_base) {
    const int k = s - coll_base;
    d = dmul(a.class_t[p * static_cast<long long>(a.C) + a.coll_class[k]], a.coll_repeat[k]);
  } else {
    d = a.delay_us[s - delay_base];
  }
  a.dur_out[at] = d;
}

// Tile t (ops [t*T, t*T + rows)) into buffer t & 1: the lane's duration of
// each op, and the tile's parent rows in 16-byte chunks spread over the lanes.
// A buffer holds T + kSlack rows: walk_near reads up to three rows past its
// tile's last op (values it then drops) without a bound check.
__device__ __forceinline__ void stage_tile(const SweepArgs& a, double* dtile, int32_t* ptile,
                                           int T, int t, int lane, int p, bool live) {
  const int i0 = t * T, rows = min(T, a.n_ops - i0), b = t & 1;
  if (live) {
    const double* src = a.dur_in + static_cast<long long>(i0) * a.P + p;
    double* dst = dtile + b * (T + kSlack) * kLanes + lane;
    for (int r = 0; r < rows; ++r) cp_async8(dst + r * kLanes, src + static_cast<long long>(r) * a.P);
  }
  const int n_int = rows * a.W;
  const int32_t* src = a.parents + static_cast<long long>(i0) * a.W;
  int32_t* dst = ptile + b * (T + kSlack) * a.W;
  for (int c = 4 * lane; c < n_int; c += 4 * kLanes)
    cp_async16(dst + c, src + c, 4 * min(4, n_int - c));
}

// How far back parent j of op i sits: i - j, or 0 for the padded slot n_ops
// (and any j outside [0, i)).
__device__ __forceinline__ int distance(int j, int i) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(i) ? i - j : 0;
}
__device__ __forceinline__ double& ring_at(double* ring, int slot, int lane) {
  return ring[slot * kLanes + lane];
}

// Whether tile rows [0, rows) of ops from i0 can take walk_near: W <=
// kRegCols and every parent within kRing ops.  Uniform over the warp.
__device__ __forceinline__ bool tile_is_near(const int32_t* pt, int rows, int W, int i0, int lane) {
  if (W > kRegCols) return false;
  bool far = false;
  for (int e = lane; e < rows * W; e += kLanes) far |= distance(pt[e], i0 + e / W) > kRing;
  return !__any_sync(0xffffffffu, far);
}

// A streaming store of f to *dst on the lanes that hold a member, predicated
// rather than branched around.
__device__ __forceinline__ void store_finish(double* dst, double f, bool live) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %2, 0;\n @p st.global.cs.f64 [%0], %1;\n}\n" ::"l"(dst),
      "d"(f), "r"(static_cast<unsigned>(live))
      : "memory");
}

// d == c ? a : b as one predicated select.  nvcc compiles a nested
// conditional expression on doubles into branches, which would split the
// walk's loop body and stall each op on them.
__device__ __forceinline__ double select_if(int d, int c, double a, double b) {
  double r;
  asm("{\n .reg .pred q;\n setp.eq.s32 q, %3, %4;\n selp.f64 %0, %1, %2, q;\n}\n"
      : "=d"(r)
      : "d"(a), "d"(b), "r"(d), "r"(c));
  return r;
}

// Writes op i's finish time f: into the ring, and into the finish table at
// *dst, then steps dst to the next op's row.
__device__ __forceinline__ void put(double f, int i, double* ring, double*& dst, long long P,
                                   int lane, bool live, double& r1, double& r2) {
  ring_at(ring, i & (kRing - 1), lane) = f;
  store_finish(dst, f, live);
  dst += P;
  r2 = r1;
  r1 = f;
}

// The ring value a code names, for the lane whose ring column starts at
// ring_lane.
__device__ __forceinline__ double ring_value(const char* ring_lane, int code) {
  return *reinterpret_cast<const double*>(ring_lane + (code & ~3));
}

// The walk of a tile whose ops have kW parents each, all within kRing ops:
// no branch but the loops'.
//
// First the lanes turn the tile's parent indices, in place, into codes:
// the byte offset of the parent's ring row (the zero row kRing for the
// padded slot) with its distance in the low two bits when it is 1 or 2 (the
// parents the chain takes from registers), else 0.  Then, while op i is on
// the chain, the walk reads op i + 2's ring values and duration and op
// i + 3's codes, so no read is used before a whole op has passed.  The
// ring rows op i + 2 reads for its parents 3 or more back are those of op
// i - 1 and before, already stored.  Past the tile's end the reads land in
// the buffer's slack rows and are dropped.
template <int kW>
__device__ __forceinline__ void walk_near(int32_t* pt, const double* dt, int i0, int rows, int T,
                                          double* ring, double*& dst, long long P, int lane,
                                          bool live, double& r1, double& r2) {
  for (int e = lane; e < (T + kSlack) * kW; e += kLanes) {
    const int i = i0 + e / kW, j = pt[e];
    const bool real = static_cast<unsigned>(j) < static_cast<unsigned>(i);
    const int near = real && i - j <= 2 ? i - j : 0;
    pt[e] = (real ? j & (kRing - 1) : kRing) * kLanes * 8 | near;
  }
  __syncwarp();
  const char* ring_lane = reinterpret_cast<const char*>(ring + lane);
  int c0[kW], c1[kW], c2[kW];  // codes of ops i, i + 1, i + 2
  double v0[kW], v1[kW];       // ring values of ops i, i + 1
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    c0[k] = pt[k];
    c1[k] = pt[kW + k];
    c2[k] = pt[2 * kW + k];
    v0[k] = ring_value(ring_lane, c0[k]);
    v1[k] = ring_value(ring_lane, c1[k]);
  }
  double du0 = dt[0], du1 = dt[kLanes];
  // op i0 + r: its parents' fmax in column order, then one rounded add;
  // meanwhile op r + 2's ring values and duration and op r + 3's codes are
  // read, and the window moves up one op
  auto step = [&](int r) {
    int c3[kW];
    double v2[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      v2[k] = ring_value(ring_lane, c2[k]);
      c3[k] = pt[(r + 3) * kW + k];
    }
    const double du2 = dt[(r + 2) * kLanes];
    double m = 0.0;
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const int near = c0[k] & 3;
      const double x = select_if(near, 1, r1, select_if(near, 2, r2, v0[k]));
      m = k == 0 ? x : fmax(m, x);
    }
    put(dadd(m, du0), i0 + r, ring, dst, P, lane, live, r1, r2);
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      c0[k] = c1[k];
      c1[k] = c2[k];
      c2[k] = c3[k];
      v0[k] = v1[k];
      v1[k] = v2[k];
    }
    du0 = du1;
    du1 = du2;
  };
  // Four ops a trip, written out so that the registers rotate by renaming
  // (on an H100 faster than two ops a trip or one: PERF.md section 6), then
  // the tile's last rows % 4 ops one a trip.  Both trip counts are explicit:
  // what runs does not hang on how the compiler unrolls a loop.  (Counting
  // the trips down ran faster than testing r + 4 <= rows each trip.)
  int r = 0;
#pragma unroll 1
  for (int trips = rows >> 2; trips > 0; --trips, r += 4) {
    step(r);
    step(r + 1);
    step(r + 2);
    step(r + 3);
  }
#pragma unroll 1
  for (; r < rows; ++r) step(r);
}

// Parent j of op i in the general walk: from registers, the ring or the
// finish table (the thread's own store, made at least kRing ops before).
__device__ __forceinline__ double parent_finish(int j, int i, double r1, double r2,
                                                const double* ring, const double* finish,
                                                long long P, int lane, int p, bool live) {
  const int d = distance(j, i);
  if (d == 0) return 0.0;
  if (d == 1) return r1;
  if (d == 2) return r2;
  if (d <= kRing) return ring[(j & (kRing - 1)) * kLanes + lane];
  return live ? finish[static_cast<long long>(j) * P + p] : 0.0;
}

// The walk of any other tile: wider parent rows, or a parent further back
// than the ring.
__device__ __forceinline__ void walk_general(const int32_t* pt, const double* dt, int i0,
                                             int rows, int W, double* ring, const double* finish,
                                             double*& dst, long long P, int lane, int p,
                                             bool live, double& r1, double& r2) {
  for (int r = 0; r < rows; ++r) {
    const int i = i0 + r;
    double m = parent_finish(pt[r * W], i, r1, r2, ring, finish, P, lane, p, live);
    for (int k = 1; k < W; ++k)
      m = fmax(m, parent_finish(pt[r * W + k], i, r1, r2, ring, finish, P, lane, p, live));
    put(dadd(m, dt[r * kLanes]), i, ring, dst, P, lane, live, r1, r2);
  }
}

__global__ void __launch_bounds__(kLanes) dse_sweep_kernel(SweepArgs a, int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* ring = reinterpret_cast<double*>(smem);  // (kRing + 1, 32), row kRing all 0
  double* dtile = ring + (kRing + 1) * kLanes;     // (2, T + kSlack, 32)
  int32_t* ptile = reinterpret_cast<int32_t*>(dtile + 2 * (T + kSlack) * kLanes);  // (2, T + kSlack, W)
  const int lane = threadIdx.x, p = blockIdx.x * kLanes + lane, W = a.W;
  const bool live = p < a.P;  // the last block's spare lanes walk along and store nothing
  const long long P = a.P;
  const double* finish = a.finish;
  double* dst = a.finish + p;  // op i's finish time goes to dst = finish + i * P + p
  if (live) a.finish[a.n_ops * P + p] = 0.0;
  ring_at(ring, kRing, lane) = 0.0;
  const int n_tiles = (a.n_ops + T - 1) / T;
  stage_tile(a, dtile, ptile, T, 0, lane, p, live);
  cp_async_commit();
  double r1 = 0.0, r2 = 0.0;  // the finish times of the last two ops
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) stage_tile(a, dtile, ptile, T, t + 1, lane, p, live);
    cp_async_commit();  // an empty group after the last tile keeps the wait below uniform
    cp_async_wait_but_newest();
    __syncwarp();  // tile t has landed, every lane's part of it
    const int i0 = t * T, rows = min(T, a.n_ops - i0);
    int32_t* pt = ptile + (t & 1) * (T + kSlack) * W;
    const double* dt = dtile + (t & 1) * (T + kSlack) * kLanes + lane;
    if (!tile_is_near(pt, rows, W, i0, lane)) {
      walk_general(pt, dt, i0, rows, W, ring, finish, dst, P, lane, p, live, r1, r2);
    } else if (W == 1) {
      walk_near<1>(pt, dt, i0, rows, T, ring, dst, P, lane, live, r1, r2);
    } else if (W == 2) {
      walk_near<2>(pt, dt, i0, rows, T, ring, dst, P, lane, live, r1, r2);
    } else if (W == 3) {
      walk_near<3>(pt, dt, i0, rows, T, ring, dst, P, lane, live, r1, r2);
    } else {
      walk_near<4>(pt, dt, i0, rows, T, ring, dst, P, lane, live, r1, r2);
    }
    __syncwarp();  // every lane is done with buffer t & 1 before tile t + 2 lands in it
  }
}

// The latency of the sweep's chain link on this card: one thread runs n
// dependent (fmax, __dadd_rn) pairs between two clock64() reads.  On no
// main path; chip_smoke.py prices the chain with it.
__global__ void dse_fp64_probe_kernel(double* buf, long long* cycles, int n) {
  double x = buf[0];
  const double y = buf[1], z = buf[2];
  const long long t0 = clock64();
#pragma unroll 16
  for (int k = 0; k < n; ++k) x = dadd(fmax(x, y), z);
  const long long t1 = clock64();
  buf[3] = x;
  cycles[0] = t1 - t0;
}

}  // namespace

// args[18] = {kind, size, is_xfer, npus, bw, lat, scale, topo, algo, chunks,
// blue, xfer_bw, xfer_lat, out, P, C, D, stream}: device pointers of the
// contiguous tables (float64, int32 ids, bool masks) and the (P, C) float64
// output.  Returns the launch's CUDA error (0 on success).
extern "C" int dse_class_times(const long long* args) {
  ClassArgs a;
  a.kind = reinterpret_cast<const int32_t*>(args[0]);
  a.size = reinterpret_cast<const double*>(args[1]);
  a.is_xfer = reinterpret_cast<const bool*>(args[2]);
  a.npus = reinterpret_cast<const double*>(args[3]);
  a.bw = reinterpret_cast<const double*>(args[4]);
  a.lat = reinterpret_cast<const double*>(args[5]);
  a.scale = reinterpret_cast<const double*>(args[6]);
  a.topo = reinterpret_cast<const int32_t*>(args[7]);
  a.algo = reinterpret_cast<const int32_t*>(args[8]);
  a.chunks = reinterpret_cast<const double*>(args[9]);
  a.blue = reinterpret_cast<const bool*>(args[10]);
  a.xfer_bw = reinterpret_cast<const double*>(args[11]);
  a.xfer_lat = reinterpret_cast<const double*>(args[12]);
  a.out = reinterpret_cast<double*>(args[13]);
  const long long P = args[14], C = args[15], D = args[16];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(args[17]);
  if (P <= 0 || C <= 0 || D <= 0 || P * C > 0x7fffffffLL || D > 0xffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.P = static_cast<int>(P);
  a.C = static_cast<int>(C);
  a.D = static_cast<int>(D);
  constexpr int threads = 128;
  const long long blocks = (P * C + threads - 1) / threads;
  dse_class_times_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// args[21] = {parents, src_of_op, comp_flops, comp_bytes, peak, membw,
// class_t, coll_class, coll_repeat, delay_us, dur_in, dur_out, finish,
// n_ops, P, W, n_comp, n_coll, n_delay, C, stream}.  With dur_in non-null
// the sweep reads its durations and the gather's pointers (src_of_op to
// delay_us, dur_out) are not touched: one launch.  With dur_in null the
// durations are gathered into dur_out first and the sweep reads them: two
// launches.  The parents table's base must be 16-byte aligned.  Returns the
// first failed launch's CUDA error (0 on success), cudaErrorInvalidValue
// for arguments the kernels do not take.
extern "C" int dse_sweep(const long long* args) {
  SweepArgs a;
  a.parents = reinterpret_cast<const int32_t*>(args[0]);
  a.src_of_op = reinterpret_cast<const int32_t*>(args[1]);
  a.comp_flops = reinterpret_cast<const double*>(args[2]);
  a.comp_bytes = reinterpret_cast<const double*>(args[3]);
  a.peak = reinterpret_cast<const double*>(args[4]);
  a.membw = reinterpret_cast<const double*>(args[5]);
  a.class_t = reinterpret_cast<const double*>(args[6]);
  a.coll_class = reinterpret_cast<const int32_t*>(args[7]);
  a.coll_repeat = reinterpret_cast<const double*>(args[8]);
  a.delay_us = reinterpret_cast<const double*>(args[9]);
  a.dur_in = reinterpret_cast<const double*>(args[10]);
  a.dur_out = reinterpret_cast<double*>(args[11]);
  a.finish = reinterpret_cast<double*>(args[12]);
  const long long n_ops = args[13], P = args[14], W = args[15], n_comp = args[16],
                  n_coll = args[17], n_delay = args[18], C = args[19];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(args[20]);
  const long long lim = 0x7fffffffLL;
  if (n_ops <= 0 || P <= 0 || W <= 0 || n_ops >= lim || P > lim || W > lim || n_comp < 0 ||
      n_coll < 0 || n_delay < 0 || C < 0 || 1 + n_comp + n_coll + n_delay > lim ||
      (n_ops + 1) * P > (1LL << 48) || n_ops * W > lim || a.finish == nullptr ||
      (reinterpret_cast<uintptr_t>(a.parents) & 15) != 0 ||
      (a.dur_in == nullptr && (a.dur_out == nullptr || a.src_of_op == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int tile = kTile;
  while (tile > 4 && sweep_smem(tile, W) > smem_max) tile /= 2;
  const long long smem = sweep_smem(tile, W);
  if (smem > smem_max) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(dse_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  a.n_ops = static_cast<int>(n_ops);
  a.P = static_cast<int>(P);
  a.W = static_cast<int>(W);
  a.n_comp = static_cast<int>(n_comp);
  a.n_coll = static_cast<int>(n_coll);
  a.C = static_cast<int>(C);
  if (a.dur_in == nullptr) {
    constexpr int gather_threads = 256;
    const long long blocks = (n_ops * P + gather_threads - 1) / gather_threads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    dse_op_durations_kernel<<<static_cast<unsigned>(blocks), gather_threads, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    a.dur_in = a.dur_out;
  }
  // one warp a block: the members spread over the SMs
  dse_sweep_kernel<<<static_cast<unsigned>((P + kLanes - 1) / kLanes), kLanes,
                     static_cast<size_t>(smem), st>>>(a, tile);
  return static_cast<int>(cudaGetLastError());
}

// args[4] = {buf, cycles, n, stream}: buf a float64 device buffer of 4 (x,
// y, z in; the chain's end out), cycles an int64 device buffer of 1.  One
// thread; returns the launch's CUDA error.
extern "C" int dse_fp64_probe(const long long* args) {
  const long long n = args[2];
  if (n <= 0 || n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dse_fp64_probe_kernel<<<1, 1, 0, reinterpret_cast<cudaStream_t>(args[3])>>>(
      reinterpret_cast<double*>(args[0]), reinterpret_cast<long long*>(args[1]),
      static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}
