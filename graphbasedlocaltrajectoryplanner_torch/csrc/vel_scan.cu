// Stacked velocity recurrences: the velocity stage of the batched fleet
// tick and every velocity profile of the interactive facade.
//
// Replaces the TPU kernels graphbasedlocaltrajectoryplanner_tpu/ops/
// pallas_velocity.py:_kernel_cgg (TPU kernel 4, via
// _fused_vel_scan_flat_cgg, the constant-gg velocity stage) and :_kernel
// (TPU kernel 5, via _fused_vel_scan_flat, per-step gg streams) — one
// template, CGG selecting between a constant local gg and per-step gg
// streams, EXP_ONE dropping the pow calls of the friction circle when
// dyn_model_exp == 1.  Semantics of ops/velocity.stacked_vel_scan: R
// independent length-T recurrences, per row one mode — FWD (friction circle
// and machine-limit interpolation minus drag, capped by v_lim), BRAKE, or
// BWD (two-step conservative refinement; rows arrive pre-flipped).
// Output (R, T+1) with column 0 = v_init.  The machine limit follows
// jnp.interp (constant extrapolation, same arithmetic order).  IEEE
// division and square root, no FMA contraction (-fmad=false): bit-equal to
// the plain PyTorch version.
//
// Bound on the H100: neither bytes nor operations.  A row is a chain of T
// dependent steps, each two IEEE divisions and one square root deep (BWD:
// three divisions, three roots), so a launch cannot take less than T times
// the latency of one step, whatever R is; a few thousand rows are a few
// hundred warps, less than one per warp scheduler.  The design therefore
// leaves on the chain only the arithmetic that depends on v:
//   * a block owns a tile of 32 consecutive rows and has three pairs of
//     warps, one pair per mode.  A pair takes the tile's rows of its mode
//     (a ballot; lane j gets the j-th such row), so the mode is a template
//     parameter of the loop whatever order the caller stacked the rows in,
//     and a pair with no row leaves at once;
//   * the pair's copy warp walks T in chunks of CH steps and keeps a ring
//     of STAGES chunks in shared memory filled two chunks ahead of its
//     partner, by 4-byte cp.async (rows start at r*T floats, T odd: no
//     wider copy is aligned) with lanes along T, so every global read is
//     coalesced and none waits on v.  Only the streams the mode reads are
//     copied.  It also writes each finished chunk of v from shared memory
//     to the output, lanes along T again;
//   * the pair's compute warp does nothing but the steps: the lane that
//     owns a row reads smem[row][t] at a pitch of CH+1 floats (32 lanes,
//     32 banks), one step ahead of its use, and leaves v in shared memory.
//     The two warps meet once per chunk at a named barrier of their own
//     (bar.sync over 64 threads); pairs never wait for one another;
//   * a step is straight-line code.  The compiler's division and square
//     root each end in a branch to a slow subroutine (taken for a zero
//     operand: a stopped row, a straight), which also keeps the step's
//     divisions from overlapping; ieee_fast.cuh has the same correctly
//     rounding sequences without it, and a flag for operands out of their
//     range.  Only a lane whose flag fell branches, at the end of the step,
//     and computes it again with the plain operators (step_exact): the same
//     bits either way;
//   * the machine table lies in shared memory, per interval (x0, f0, dx,
//     df) and the reciprocal of dx.  A row keeps the interval of its last
//     step in registers and interpolates on it at once; the knots are
//     counted beside that (xp <= v, four a pass, no branch for M <= 4),
//     and a row that has crossed a knot goes through step_exact, which
//     loads its new interval;
//   * what does not depend on v (the clamp of ay_max and its reciprocal,
//     2*ds, the constants of the call) is computed beside the loads or
//     held in registers; (2*acc)*ds == acc*(2*ds) bit for bit.
#include <cuda_runtime.h>
#include <math.h>

#include "ieee_fast.cuh"

namespace {

constexpr int ROWS = 32;             // rows of a block's tile, lanes of a warp
constexpr int CH = 16;               // steps per chunk
constexpr int PITCH = CH + 1;        // floats between rows of a staged chunk
constexpr int STAGES = 3;            // chunks in a mode's ring
constexpr int TILE = ROWS * PITCH;   // floats of one stream's staged chunk
constexpr int MODES = 3;             // a pair of warps for each
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;  // bytes a block may use on sm_90

enum { FWD = 0, BRAKE = 1, BWD = 2 };

// Order of the streams in Streams::p, such that each mode reads a prefix.
// Constant gg: k1, ds, v_lim, k2.  Per-step gg: k1, ds, axm1, aym1, v_lim,
// k2, axm2, aym2.
struct Streams {
  const float* p[8];
};

__host__ __device__ constexpr int nstreams(bool cgg, int mode) {
  return cgg ? (mode == BRAKE ? 2 : mode == FWD ? 3 : 4)
             : (mode == BRAKE ? 4 : mode == FWD ? 5 : 8);
}

// floats of one mode's region: its ring and two chunks of output
__host__ __device__ constexpr int mode_floats(bool cgg, int mode) {
  return (nstreams(cgg, mode) * STAGES + 2) * TILE;
}

__host__ __device__ constexpr int mode_offset(bool cgg, int mode) {
  int off = 0;
  for (int m = 0; m < mode; ++m) off += mode_floats(cgg, m);
  return off;
}

struct VelParams {
  float gg_ax, gg_ay;      // constant local gg (CGG)
  float exp, inv_exp;      // friction-circle shape
  float drag_coeff, m_veh;
  float interp_eps;        // jnp.interp zero-width guard
  int M;                   // machine-limit table rows
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The machine table in shared memory: the knots xs, padded with +inf to a
// multiple of four, and two float4 per interval i in [1, M-1]:
// (xp[i-1], fp[i-1], dxs, fp[i]-fp[i-1]) and (refined 1/dxs, flags, -, -),
// dxs the interval's width, or 1 where it has none (then the value is
// fp[i-1]: flag FLAT).
struct Machines {
  const float4* xs;
  const float4* iv;
  int M, passes;
  float x_lo, f_lo, x_hi, f_hi;
};
constexpr int FLAT = 1, DX_OK = 2;

// searchsorted(xp, v, right) clamped to [1, M-1]: a count of xp <= v, four
// knots a pass.  ONE_PASS (M <= 4): no loop, so no branch.
template <bool ONE_PASS>
__device__ __forceinline__ int knot_index(float v, const Machines& m) {
  int i = 0;
  const int passes = ONE_PASS ? 1 : m.passes;
  for (int j = 0; j < passes; ++j) {
    const float4 x = m.xs[j];
    i += (x.x <= v ? 1 : 0) + (x.y <= v ? 1 : 0)
         + ((x.z <= v ? 1 : 0) + (x.w <= v ? 1 : 0));
  }
  return min(max(i, 1), m.M - 1);
}

// The interval a row's v lay in at its last step, in registers.
struct Interval {
  int i;
  float x0, f0, df;
  ieee_fast::Recip dx;
  bool flat;
};

__device__ __forceinline__ Interval load_interval(int i, const Machines& m) {
  const float4 e = m.iv[2 * (i - 1)], r = m.iv[2 * (i - 1) + 1];
  const int flags = __float_as_int(r.y);
  return Interval{i, e.x, e.y, e.w,
                  ieee_fast::Recip{e.z, r.x, (flags & DX_OK) != 0},
                  (flags & FLAT) != 0};
}

// A warp writes the table into shared memory for its own use.
__device__ __forceinline__ Machines setup_machines(
    const float* __restrict__ machines, const VelParams& p, int lane,
    float* mach_smem) {
  const int M = p.M, M4 = (M + 3) & ~3;
  float* xs = mach_smem;
  float4* iv = reinterpret_cast<float4*>(mach_smem + M4);
  for (int j = lane; j < M4; j += 32) {
    xs[j] = j < M ? machines[2 * j] : INFINITY;
    if (j > 0 && j < M) {
      const float dx = machines[2 * j] - machines[2 * j - 2];
      const bool flat = fabsf(dx) <= p.interp_eps;
      const ieee_fast::Recip r = ieee_fast::make_recip(flat ? 1.0f : dx);
      iv[2 * j - 2] = make_float4(machines[2 * j - 2], machines[2 * j - 1],
                                  r.y,
                                  machines[2 * j + 1] - machines[2 * j - 1]);
      iv[2 * j - 1] = make_float4(
          r.r, __int_as_float((flat ? FLAT : 0) | (r.ok ? DX_OK : 0)), 0.0f,
          0.0f);
    }
  }
  __syncwarp();
  return Machines{reinterpret_cast<const float4*>(xs), iv, M, M4 / 4,
                  machines[0], machines[1], machines[2 * (M - 1)],
                  machines[2 * (M - 1) + 1]};
}

// What the steps of a warp share.
struct Consts {
  float gg_ax, exp, inv_exp, drag_coeff;
  ieee_fast::Recip gg_aym, m_veh;   // max(gg_ay, 1e-9); the vehicle's mass
};

__device__ __forceinline__ Consts make_consts(const VelParams& p) {
  return Consts{p.gg_ax, p.exp, p.inv_exp, p.drag_coeff,
                ieee_fast::make_recip(fmaxf(p.gg_ay, 1e-9f)),
                ieee_fast::make_recip(p.m_veh)};
}

// One step's inputs, with what does not depend on v done: 2*ds, the clamp
// of ay_max and its reciprocal.
template <bool CGG, int MODE>
struct StepIn {
  float k1, d2, axm1, vl, k2, axm2;
  ieee_fast::Recip aym1, aym2;

  // `in` points at the row's entry of the staged chunk (stream q at
  // in[q * TILE])
  __device__ __forceinline__ void load(const float* in, const Consts& c) {
    using ieee_fast::make_recip;
    constexpr int K1 = 0, DS = 1, A1 = 2, Y1 = 3, VL = CGG ? 2 : 4,
                  K2 = CGG ? 3 : 5, A2 = 6, Y2 = 7;
    k1 = in[K1 * TILE];
    d2 = 2.0f * in[DS * TILE];
    axm1 = CGG ? c.gg_ax : in[A1 * TILE];
    aym1 = CGG ? c.gg_aym : make_recip(fmaxf(in[Y1 * TILE], 1e-9f));
    vl = MODE != BRAKE ? in[VL * TILE] : 0.0f;
    k2 = MODE == BWD ? in[K2 * TILE] : 0.0f;
    axm2 = MODE != BWD ? 0.0f : CGG ? c.gg_ax : in[A2 * TILE];
    aym2 = MODE != BWD || CGG ? c.gg_aym
                              : make_recip(fmaxf(in[Y2 * TILE], 1e-9f));
  }
};

// Available longitudinal tire acceleration from the share frac of ay_max
// in use.
template <bool EXP_ONE>
__device__ __forceinline__ float ax_tires(float frac_raw, float axm,
                                          const Consts& c) {
  const float frac = fminf(fmaxf(frac_raw, 0.0f), 1.0f);
  if (EXP_ONE) return axm * fmaxf(1.0f - frac, 0.0f);
  const float radicand = 1.0f - powf(frac, c.exp);
  return axm * powf(fmaxf(radicand, 0.0f), c.inv_exp);
}

// One step without a branch (ieee_fast.cuh): the divisions and roots of the
// step overlap, and only what follows from v is on the chain.  Clears `ok`
// where an operand leaves the range in which that arithmetic is exact, or
// where v has left the machine table's interval of the last step; the
// caller then takes step_exact.
template <bool CGG, bool EXP_ONE, int MODE, bool ONE_PASS>
__device__ __forceinline__ float step_fast(float v,
                                           const StepIn<CGG, MODE>& s,
                                           const Machines& mach,
                                           const Interval& iv,
                                           const Consts& c, bool& ok) {
  namespace f = ieee_fast;
  const float v2 = v * v;
  const float a_t = ax_tires<EXP_ONE>(f::div(v2 * s.k1, s.aym1, ok), s.axm1,
                                      c);
  const float drag = f::div(v2 * c.drag_coeff, c.m_veh, ok);
  if (MODE == FWD) {
    // interpolated on the last step's interval while the knots are counted
    // (`&`, not `&&`: the count must not wait for the flag)
    ok &= knot_index<ONE_PASS>(v, mach) == iv.i;
    const float g = iv.f0 + f::div(v - iv.x0, iv.dx, ok) * iv.df;
    float a_m = iv.flat ? iv.f0 : g;
    if (v < mach.x_lo) a_m = mach.f_lo;
    if (v > mach.x_hi) a_m = mach.f_hi;
    const float acc = fminf(a_t, a_m) - drag;
    return fminf(f::sqrt(fmaxf(v2 + acc * s.d2, 0.0f), ok), s.vl);
  }
  const float dec = a_t + drag;
  if (MODE == BRAKE) return f::sqrt(fmaxf(v2 - dec * s.d2, 0.0f), ok);
  const float v_est = f::sqrt(v2 + dec * s.d2, ok);            // BWD
  const float ve2 = v_est * v_est;
  const float a_t2 = ax_tires<EXP_ONE>(f::div(ve2 * s.k2, s.aym2, ok),
                                       s.axm2, c);
  const float dec2 = a_t2 + f::div(ve2 * c.drag_coeff, c.m_veh, ok);
  return fminf(f::sqrt(fmaxf(v2 + fminf(dec, dec2) * s.d2, 0.0f), ok), s.vl);
}

// The same step with the plain operators, for the lanes step_fast gave up
// on.  Rare, so a call, by value, and the loop of steps runs straight
// through.  Returns v and the interval of the machine table it lies in.
struct Stepped {
  float v;
  Interval iv;
};

template <bool CGG, bool EXP_ONE, int MODE>
__device__ __noinline__ Stepped step_exact(float v, StepIn<CGG, MODE> s,
                                           Machines mach, Consts c) {
  Interval iv{};
  const float v2 = v * v;
  const float a_t = ax_tires<EXP_ONE>(v2 * s.k1 / s.aym1.y, s.axm1, c);
  const float drag = v2 * c.drag_coeff / c.m_veh.y;
  if (MODE == FWD) {
    iv = load_interval(knot_index<false>(v, mach), mach);
    float a_m = iv.flat ? iv.f0 : iv.f0 + ((v - iv.x0) / iv.dx.y) * iv.df;
    if (v < mach.x_lo) a_m = mach.f_lo;
    if (v > mach.x_hi) a_m = mach.f_hi;
    const float acc = fminf(a_t, a_m) - drag;
    return Stepped{fminf(sqrtf(fmaxf(v2 + acc * s.d2, 0.0f)), s.vl), iv};
  }
  const float dec = a_t + drag;
  if (MODE == BRAKE) return Stepped{sqrtf(fmaxf(v2 - dec * s.d2, 0.0f)), iv};
  const float v_est = sqrtf(v2 + dec * s.d2);                  // BWD
  const float ve2 = v_est * v_est;
  const float a_t2 = ax_tires<EXP_ONE>(ve2 * s.k2 / s.aym2.y, s.axm2, c);
  const float dec2 = a_t2 + ve2 * c.drag_coeff / c.m_veh.y;
  return Stepped{
      fminf(sqrtf(fmaxf(v2 + fminf(dec, dec2) * s.d2, 0.0f)), s.vl), iv};
}

template <bool CGG, bool EXP_ONE, int MODE, bool ONE_PASS>
__device__ __forceinline__ float step(float v, const StepIn<CGG, MODE>& s,
                                      const Machines& mach, Interval& iv,
                                      const Consts& c) {
  bool ok = true;
  const float vf = step_fast<CGG, EXP_ONE, MODE, ONE_PASS>(v, s, mach, iv, c,
                                                           ok);
  if (ok) return vf;
  const Stepped e = step_exact<CGG, EXP_ONE, MODE>(v, s, mach, c);
  if (MODE == FWD) iv = e.iv;
  return e.v;
}

// Barrier of one warp pair (64 threads); ids 1..3, 0 is __syncthreads'.
__device__ __forceinline__ void pair_sync(int mode) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(mode + 1) : "memory");
}

// What a mode's two warps share: where their rows and their memory are.
template <bool CGG, int MODE>
struct Pair {
  static constexpr int NS = nstreams(CGG, MODE);
  float* ring;       // STAGES chunks of NS streams
  float* vout;       // two chunks of output
  int nrows, row;    // rows of the mode; this lane's (spare lanes: the first)
  int nchunks;

  __device__ __forceinline__ Pair(float* smem, unsigned rows, int r0,
                                  int lane, int T) {
    ring = smem + mode_offset(CGG, MODE);
    vout = ring + NS * STAGES * TILE;
    nrows = __popc(rows);
    // lane j owns the j-th row of the mode
    row = r0 + (int)__fns(rows, 0, (lane < nrows ? lane : 0) + 1);
    nchunks = (T + CH - 1) / CH;
  }
};

// The compute warp of a mode: T dependent steps per lane, nothing else.
// Before barrier c its partner has chunk c of the inputs in the ring; after
// barrier c + 1 the partner writes out the chunk of v left in vout.
template <bool CGG, bool EXP_ONE, int MODE, bool ONE_PASS>
__device__ __forceinline__ void compute_warp(
    const Pair<CGG, MODE>& pr, const float* __restrict__ v_init,
    const float* __restrict__ machines, float* __restrict__ out, int T,
    const VelParams& p, int lane, float* mach_smem) {
  constexpr int NS = Pair<CGG, MODE>::NS;
  const bool owner = lane < pr.nrows;
  const int slot = owner ? lane : 0;

  const Machines mach = MODE == FWD
                            ? setup_machines(machines, p, lane, mach_smem)
                            : Machines{};
  const Consts c = make_consts(p);

  float v = v_init[pr.row];
  if (owner) out[(size_t)pr.row * (T + 1)] = v;
  Interval iv{};
  if (MODE == FWD) iv = load_interval(knot_index<false>(v, mach), mach);
  for (int ch = 0; ch < pr.nchunks; ++ch) {
    pair_sync(MODE);
    const float* st = pr.ring + (ch % STAGES) * NS * TILE + slot * PITCH;
    float* vo = pr.vout + (ch & 1) * TILE + lane * PITCH;
    const int n = min(CH, T - ch * CH);
    StepIn<CGG, MODE> cur, nxt;
    cur.load(st, c);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      nxt.load(st + j + 1, c);        // one step ahead of its use
      v = step<CGG, EXP_ONE, MODE, ONE_PASS>(v, cur, mach, iv, c);
      vo[j] = v;
      cur = nxt;
    }
  }
  pair_sync(MODE);
}

// The copy warp of a mode: keeps the ring two chunks ahead of its partner
// and writes the partner's last chunk of v, both with lanes along T (lanes
// 0-15 on one row, 16-31 on the next).
template <bool CGG, int MODE>
__device__ __forceinline__ void copy_warp(const Pair<CGG, MODE>& pr,
                                          const Streams& in,
                                          float* __restrict__ out, int T,
                                          int lane) {
  constexpr int NS = Pair<CGG, MODE>::NS;
  const int half = lane >> 4, l = lane & (CH - 1);

  auto stage_chunk = [&](int ch) {    // one commit group
    const int t = ch * CH + l;
    float* dst = pr.ring + (ch % STAGES) * NS * TILE + l;
    for (int i0 = 0; i0 < pr.nrows; i0 += 8) {
#pragma unroll
      for (int u = 0; u < 8; u += 2) {
        const int i = i0 + u + half;
        const int src = __shfl_sync(FULL, pr.row, i & 31);
        if (i < pr.nrows && t < T) {
          const size_t g = (size_t)src * T + t;
#pragma unroll
          for (int q = 0; q < NS; ++q)
            cp_async4(dst + q * TILE + i * PITCH, in.p[q] + g);
        }
      }
    }
    cp_async_commit();
  };

  stage_chunk(0);
  stage_chunk(1);
  cp_async_wait<1>();                 // chunk 0 has landed
  for (int k = 0; k <= pr.nchunks; ++k) {
    pair_sync(MODE);                  // partner: done with k - 1, starts k
    if (k > 0) {
      const int ch = k - 1, n = min(CH, T - ch * CH);
      const float* vo = pr.vout + (ch & 1) * TILE + l;
      for (int i0 = 0; i0 < pr.nrows; i0 += 8) {
#pragma unroll
        for (int u = 0; u < 8; u += 2) {
          const int i = i0 + u + half;
          const int dst = __shfl_sync(FULL, pr.row, i & 31);
          if (i < pr.nrows && l < n)
            out[(size_t)dst * (T + 1) + 1 + ch * CH + l] = vo[i * PITCH];
        }
      }
    }
    if (k < pr.nchunks) {
      stage_chunk(k + 2);             // into the stage of chunk k - 1
      cp_async_wait<1>();             // chunk k + 1 has landed
    }
  }
  cp_async_wait<0>();
}

template <bool CGG, bool EXP_ONE, int MODE>
__device__ __forceinline__ void run_pair(
    bool copies, const Streams& in, const float* __restrict__ v_init,
    const float* __restrict__ machines, float* __restrict__ out, int T,
    const VelParams& p, unsigned rows, int r0, int lane, float* smem) {
  const Pair<CGG, MODE> pr(smem, rows, r0, lane, T);
  if (copies)
    copy_warp<CGG, MODE>(pr, in, out, T, lane);
  else if (MODE == FWD && p.M <= 4)   // the knots fit one pass: no loop
    compute_warp<CGG, EXP_ONE, MODE, true>(pr, v_init, machines, out, T, p,
                                           lane,
                                           smem + mode_offset(CGG, MODES));
  else
    compute_warp<CGG, EXP_ONE, MODE, false>(pr, v_init, machines, out, T, p,
                                            lane,
                                            smem + mode_offset(CGG, MODES));
}

template <bool CGG, bool EXP_ONE>
__global__ void __launch_bounds__(2 * MODES * 32) vel_scan_kernel(
    Streams in, const float* __restrict__ v_init,
    const int* __restrict__ mode, const float* __restrict__ machines,
    float* __restrict__ out, int R, int T, VelParams p) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // warps 0-2 compute modes 0-2, each on a scheduler of its own; warps 3-5
  // copy for them
  const bool copies = warp >= MODES;
  const int my_mode = copies ? warp - MODES : warp;
  const int r0 = blockIdx.x * ROWS;
  int md = -1;
  if (r0 + lane < R) {
    md = mode[r0 + lane];
    md = (md == FWD || md == BRAKE) ? md : BWD;
  }
  const unsigned rows = __ballot_sync(FULL, md == my_mode);
  if (rows == 0) return;              // both warps of the pair
  if (my_mode == FWD)
    run_pair<CGG, EXP_ONE, FWD>(copies, in, v_init, machines, out, T, p,
                                rows, r0, lane, smem);
  else if (my_mode == BRAKE)
    run_pair<CGG, EXP_ONE, BRAKE>(copies, in, v_init, machines, out, T, p,
                                  rows, r0, lane, smem);
  else
    run_pair<CGG, EXP_ONE, BWD>(copies, in, v_init, machines, out, T, p,
                                rows, r0, lane, smem);
}

// bytes of dynamic shared memory: the three modes' regions and the table
size_t smem_bytes(bool cgg, int M) {
  return (size_t)mode_offset(cgg, MODES) * 4 + (size_t)((M + 3) & ~3) * 4
         + (size_t)(M > 1 ? M - 1 : 0) * 32;
}

template <bool CGG, bool EXP_ONE>
int launch(const Streams& in, const float* v_init, const int* mode,
           const float* machines, float* out, int R, int T, VelParams p,
           cudaStream_t s) {
  const size_t smem = smem_bytes(CGG, p.M);
  if (smem > SMEM_MAX || p.M < 2) return (int)cudaErrorInvalidValue;
  auto kernel = vel_scan_kernel<CGG, EXP_ONE>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<(R + ROWS - 1) / ROWS, 2 * MODES * 32, smem, s>>>(
      in, v_init, mode, machines, out, R, T, p);
  return (int)cudaGetLastError();
}

}  // namespace

// gg streams a1/y1/a2/y2 may be null when const_gg != 0.
extern "C" int vel_scan_launch(
    const float* k1, const float* a1, const float* y1, const float* k2,
    const float* a2, const float* y2, const float* ds, const float* v_lim,
    const float* v_init, const int* mode, const float* machines, int M,
    float* out, int R, int T, int const_gg, float gg_ax, float gg_ay,
    float exp, float inv_exp, float drag_coeff, float m_veh,
    float interp_eps, void* stream) {
  if (R == 0) return 0;
  VelParams p{gg_ax, gg_ay, exp, inv_exp, drag_coeff, m_veh, interp_eps, M};
  cudaStream_t s = (cudaStream_t)stream;
  const bool exp_one = exp == 1.0f;
  if (const_gg) {
    const Streams in{{k1, ds, v_lim, k2, nullptr, nullptr, nullptr, nullptr}};
    return exp_one
               ? launch<true, true>(in, v_init, mode, machines, out, R, T, p, s)
               : launch<true, false>(in, v_init, mode, machines, out, R, T, p,
                                     s);
  }
  const Streams in{{k1, ds, a1, y1, v_lim, k2, a2, y2}};
  return exp_one
             ? launch<false, true>(in, v_init, mode, machines, out, R, T, p, s)
             : launch<false, false>(in, v_init, mode, machines, out, R, T, p,
                                    s);
}
