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
// blocks of one warp, each thread walking all the ops in uid order.  The
// finish table is op-major, (n_ops + 1, P), so a warp's reads and writes of
// one op's row coalesce; row n_ops is the padded parent slot, pinned to 0.
// The durations come from their own launch rather than being gathered in
// the walk: the gather's dependent loads would sit on the sweep's chain (on
// an H100 at P = 32, gathering inside the walk took 14.4 device ms where the
// sweep over given durations took 9.6).
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
//     true limit is the dependency chain: 12,995 levels, each a dependent
//     load of a parent's finish time (written by the same thread just
//     before, so from L1 or L2), an fp64 max and an add.  The design does
//     nothing about that latency yet; a shared-memory window of recent
//     finish rows, so that most parent reads skip L2, is later work.
//   * The members run in parallel, one per thread and one warp a block, yet
//     the device time still grows with P: on an H100 80GB HBM3 at 700 W
//     chip_smoke.py reads 10.8 to 11.3 ms at P = 32 and 16.9 to 17.1 ms at
//     P = 256 (eight blocks).  Why is not measured yet.

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
  const int32_t* parents;     // (n_ops, W) augmented parents, padded with n_ops
  const int32_t* src_of_op;   // (n_ops,) slot in [zero | comp | coll | delay]
  const double* comp_flops;   // (n_comp,)
  const double* comp_bytes;   // (n_comp,)
  const double* peak;         // (P,) FLOP/s
  const double* membw;        // (P,) bytes/s
  const double* class_t;      // (P, C)
  const int32_t* coll_class;  // (n_coll,)
  const double* coll_repeat;  // (n_coll,)
  const double* delay_us;     // (n_delay,)
  const double* dur_in;       // (n_ops, P) the durations the sweep reads
  double* dur_out;            // (n_ops, P) gathered durations
  double* finish;             // (n_ops + 1, P)
  int n_ops, P, W, n_comp, n_coll, C;
};

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

__global__ void dse_sweep_kernel(SweepArgs a) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.P) return;
  const long long P = a.P;
  a.finish[a.n_ops * P + p] = 0.0;
  for (int i = 0; i < a.n_ops; ++i) {
    const int32_t* par = a.parents + static_cast<long long>(i) * a.W;
    double m = a.finish[par[0] * P + p];
    for (int k = 1; k < a.W; ++k) m = fmax(m, a.finish[par[k] * P + p]);
    const long long at = i * P + p;
    a.finish[at] = dadd(m, a.dur_in[at]);
  }
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
// launches.  Returns the first failed launch's CUDA error (0 on success).
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
      (n_ops + 1) * P > (1LL << 48) || a.finish == nullptr ||
      (a.dur_in == nullptr && (a.dur_out == nullptr || a.src_of_op == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
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
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    a.dur_in = a.dur_out;
  }
  constexpr int threads = 32;  // one warp a block: the members spread over the SMs
  dse_sweep_kernel<<<static_cast<unsigned>((P + threads - 1) / threads), threads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
