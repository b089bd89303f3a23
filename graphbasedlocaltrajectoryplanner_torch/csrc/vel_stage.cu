// The fb velocity stage's glue around the stacked recurrences of
// vel_scan.cu: each dependency level's rows, and the stage's tail.
//
// No TPU kernel: the JAX package runs this glue in XLA around its velocity
// kernel.  Semantics of ops/cuda_velstage.fb_level_plain and
// epilogue_plain, bit for bit (but for ego_stop_d, below):
//   * vel_stage_level_kernel, one launch before each level's scan, one
//     block a scenario n: level 0 writes every path's brake-prefix row;
//     level 1 first finds each path's prefix cut (the first point of the
//     level-0 profile at or below vel_max, at least c_len), start velocity
//     and end index (5 m short of a reduced spline's end), one warp a path,
//     and writes the follow slot's ego-brake and unconstrained forward rows
//     and every path's normal forward row; level 2 first finds the follow
//     state (stop index from the follow path's masked arc lengths s_f, the
//     opponent's run-out velocity, the ego brake's stopping distance, the
//     segment-1 hand-off), one warp, and writes the segment-2 forward row
//     and the backward rows of the unconstrained and every normal profile;
//     level 3 writes the segment-2 backward row.  Rows go straight into
//     the scan's (R, T) streams, row n * r + j; a backward row's step t
//     reads point P - 1 - t (k1) and P - 2 - t (k2, ds, v_lim) of its path
//     and profile, so nothing is flipped or stacked in memory.  Only
//     backward rows have k2 apart from k1: levels 0 and 1 write k1 alone,
//     which the wrapper passes as both;
//   * vel_stage_epilogue_kernel, one launch after the last scan, one block
//     a path: the follow assembly (fb; the QP profiles under sqp), the
//     normal profile zeroed from its end index, the bounds, the slot
//     select, the committed course and the prefix into shared memory, then
//     the profile row [s x y psi kappa vx ax] (ax with the stationary rule
//     of torch.isclose at its default tolerances, zero at the last point),
//     written in the output's own order, consecutive threads on
//     consecutive floats.
//
// Rounding: every operation rounds on its own as PyTorch's elementwise
// kernels do (built with -fmad=false, no fast math), in the plain
// version's order; divisions and square roots correctly rounded
// (ieee_fast.cuh, the plain operators where it declines); minimum and
// maximum propagate NaN; argmax and argmin take the first index; Python
// constants are doubles rounded to float.  The one sum, the follow path's
// stopping distance, runs in the order the plain version leaves open on
// the card (torch.sum): lane l adds elements l, l + 32, ... in turn, the
// lanes' sums then meet in a butterfly of shuffles.
//
// Bound: bytes.  A fleet tick at B = 1024 writes about 110 MB of rows and
// 51 MB of profiles, and reads the paths and the scans' profiles.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ieee_fast.cuh"

namespace vel_stage {

constexpr int WARPS = 8;            // a level launch's block: 32 x WARPS
constexpr int EPI_THREADS = 128;    // an epilogue block's, a path each
constexpr int K_MAX = 32;           // paths a scenario
constexpr unsigned FULL = 0xffffffffu;
constexpr int FWD = 0, BRAKE = 1, BWD = 2;
constexpr float EPS_K = (float)1e-9;      // clamp of |kappa| and of 2 ds
constexpr float ISCLOSE_ATOL = (float)1e-8;
constexpr float PREFIX_MARGIN = (float)0.1;
constexpr float STOP_V = (float)0.1;      // velops.stop_distance's v_thresh

// ops/cuda_velstage.StageArgs, field for field.
struct Args {
  const float* paths;         // (N, k, P, 5) [x y psi kappa el]
  const float* s;             // (N, k, P) arc lengths, a leading zero
  const long long* n_valid;   // (N, k)
  const long long* c_len;     // (N,)
  const bool* red_len;        // (N, k)
  const float* v_end_rl;      // (N, k)
  const float* vel_plan;      // (N,)
  const float* vel_max;       // ()
  const float* ay;            // (P,) at stride ay_st
  const float* v_control;     // (N,)
  const float* obj_dist;      // (N,)
  const float* safety_d;      // ()
  const float* veh_length;    // ()
  const float* opp_stop_dist; // (N,)
  const float* roll_vel;      // (N, F)
  const float* roll_cum;      // (N, F)
  const float* s_f;           // (N, P)
  const float* lv0;           // (N k, P) the levels' profiles
  const float* lv1;           // (N (k + 2), P)
  const float* lv2;           // (N (k + 2), P)
  const float* lv3;           // (N, P)
  long long* pref_idx;        // (N, k): level 1 writes the paths' state
  float* vel_start;
  long long* v_idx;
  long long* stop_idx;        // (N,): level 2 writes the follow state
  long long* idx_c;
  bool* seg1_active;
  bool* cannot_hold;
  bool* too_close;
  float* vx_control_start;
  float* ego_stop_d;
  float* k1;                  // (R, T) the level's rows
  float* k2;
  float* ds;
  float* v_lim;
  float* v_init;              // (R,)
  int* mode;                  // (R,)
  const float* vel_course;    // (N, P)
  const float* v_max_offset;  // ()
  const float* vx_normal;     // (N, k, P) sqp
  const float* vx_follow;     // (N, P) sqp
  const bool* follow_bound;   // (N,) sqp
  float* trajs;               // (N, k, P, 7)
  bool* vel_bound;            // (N, k)
  long long N, pref_sn, pref_sj, vs_sn, vs_sj, ay_st;
  int k, P, F, fs, level, fb;
};

// torch.minimum / torch.maximum (NaN propagates), torch.clamp(min=)
__device__ __forceinline__ float vmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float div_rn(float x, float y) {
  bool ok = true;
  const float q = ieee_fast::div(x, ieee_fast::make_recip(y), ok);
  return ok ? q : __fdiv_rn(x, y);
}
__device__ __forceinline__ float sqrt_rn(float x) {
  bool ok = true;
  const float r = ieee_fast::sqrt(x, ok);
  return ok ? r : __fsqrt_rn(x);
}

// The first of a warp's strided hits (INT32_MAX: none), on every lane.
__device__ __forceinline__ int warp_first(int hit) {
  return (int)__reduce_min_sync(FULL, (unsigned)hit);
}

// A path's (row n * k + j) point t.
struct Path {
  const Args& a;
  long long row;
  __device__ float kappa(int t) const {
    return a.paths[(row * a.P + t) * 5 + 3];
  }
  __device__ float el(int t) const { return a.paths[(row * a.P + t) * 5 + 4]; }
};

// A path's state after level 1 and what follows from it.
struct Slot {
  long long pref, v_idx;
  float vel_start, v_end;
};

__device__ __forceinline__ float kabs_m(const Path& p, const Slot& s, int t) {
  return t < s.pref ? 0.0f : fabsf(p.kappa(t));
}
__device__ __forceinline__ float el_m(const Path& p, const Slot& s, int t) {
  return t < s.pref ? 0.0f : p.el(t);
}
__device__ __forceinline__ float el_n(const Path& p, const Slot& s, int t) {
  return t >= s.v_idx - 1 ? 0.0f : el_m(p, s, t);
}
__device__ __forceinline__ float v_lat(const Args& a, const Path& p,
                                       const Slot& s, int t) {
  return sqrt_rn(div_rn(a.ay[t * a.ay_st],
                        clamp_min(kabs_m(p, s, t), EPS_K)));
}
__device__ __forceinline__ float v0(const Args& a, const Path& p,
                                    const Slot& s, int t, float vm) {
  return vmin(v_lat(a, p, s, t), vm);
}
__device__ __forceinline__ float v0_n(const Args& a, const Path& p,
                                      const Slot& s, int t, float vm) {
  const float v = v0(a, p, s, t, vm);
  return t >= s.v_idx - 1 ? vmin(v, s.v_end) : v;
}

// The follow state after level 2.
struct Follow {
  long long stop_idx, idx_c;
  bool seg1, cannot_hold;
  float vcs, v_end_f;
};

__device__ __forceinline__ float el_seg2(const Path& p, const Slot& s,
                                         const Follow& f, int t) {
  if (t < f.idx_c) return 0.0f;
  return t < f.stop_idx ? el_m(p, s, t) : 0.0f;
}

__device__ void write_row(const Args& a, long long r, int t, float k1,
                          float k2, float ds, float v_lim, bool with_k2) {
  const long long i = r * (a.P - 1) + t;
  a.k1[i] = k1;
  if (with_k2) a.k2[i] = k2;
  a.ds[i] = ds;
  a.v_lim[i] = v_lim;
}

__device__ __forceinline__ Slot slot_of(const Args& a, long long n, int j) {
  const long long i = n * a.k + j;
  const float v_end = a.red_len[i] ? 0.0f : a.v_end_rl[i];
  return Slot{a.pref_idx[i], a.v_idx[i], a.vel_start[i], v_end};
}

__global__ void __launch_bounds__(WARPS * 32)
vel_stage_level_kernel(const Args a) {
  __shared__ Slot slots[K_MAX];
  __shared__ Follow fol;
  const long long n = blockIdx.x;
  const int k = a.k, P = a.P, T = P - 1, fs = a.fs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float vm = *a.vel_max;
  const long long base = n * k;
  const int r = a.level == 0 ? k : a.level == 3 ? 1 : k + 2;
  const long long row0 = n * r;

  if (a.level == 0) {
    const float vp = a.vel_plan[n];
    const long long c_len = a.c_len[n];
    for (int e = threadIdx.x; e < r * T; e += blockDim.x) {
      const int j = e / T, t = e - j * T;
      const Path p{a, base + j};
      write_row(a, row0 + j, t, fabsf(p.kappa(t)), 0.0f,
                t < c_len ? 0.0f : p.el(t), INFINITY, false);
    }
    for (int j = threadIdx.x; j < r; j += blockDim.x) {
      a.v_init[row0 + j] = vp;
      a.mode[row0 + j] = BRAKE;
    }
    return;
  }

  if (a.level == 1) {
    // each path's prefix cut, start velocity and end index: a warp a path
    const float vp = a.vel_plan[n];
    const bool prefix_active = vp > __fadd_rn(vm, PREFIX_MARGIN);
    const long long c_len = a.c_len[n];
    for (int j = warp; j < k; j += WARPS) {
      const long long i = base + j;
      const float* vd = a.lv0 + i * P;
      const float* s = a.s + i * P;
      const long long nv = a.n_valid[i];
      const long long last = nv < 1 ? 0 : (nv > P ? P - 1 : nv - 1);
      const float thr = __fsub_rn(s[last], 5.0f);
      // both searches in one pass, every lane loading all its points (no
      // early exit: the loads overlap)
      int hit = INT32_MAX, hit_s = INT32_MAX;
      for (int t = lane; t < P; t += 32) {
        if (vd[t] <= vm && t < hit) hit = t;
        if (t < P - 1 && !(s[t + 1] < thr) && t < hit_s) hit_s = t;
      }
      int first = warp_first(hit);
      if (first == INT32_MAX) first = P - 1;
      const long long pref = prefix_active
          ? (first > c_len ? (long long)first : c_len) : c_len;
      const float vel_start = prefix_active
          ? vd[pref < P ? pref : P - 1] : vp;
      const int not_below = warp_first(hit_s);
      long long v_idx_red = (not_below == INT32_MAX ? 0 : not_below) + 1;
      if (v_idx_red == 1 && nv > 1) v_idx_red = nv;
      const long long v_idx = a.red_len[i] ? v_idx_red : nv;
      if (lane == 0) {
        a.pref_idx[i] = pref;
        a.vel_start[i] = vel_start;
        a.v_idx[i] = v_idx;
        slots[j] = Slot{pref, v_idx, vel_start,
                        a.red_len[i] ? 0.0f : a.v_end_rl[i]};
      }
    }
    __syncthreads();
    const Path pf{a, base + fs};
    const Slot sf = slots[fs];
    for (int e = threadIdx.x; e < r * T; e += blockDim.x) {
      const int q = e / T, t = e - q * T;
      if (q < 2) {            // the ego brake, the unconstrained forward
        write_row(a, row0 + q, t, kabs_m(pf, sf, t), 0.0f, el_m(pf, sf, t),
                  q == 0 ? INFINITY : v0(a, pf, sf, t + 1, vm), false);
      } else {                // normal forward
        const Path p{a, base + q - 2};
        const Slot s = slots[q - 2];
        write_row(a, row0 + q, t, kabs_m(p, s, t), 0.0f, el_n(p, s, t),
                  v0_n(a, p, s, t + 1, vm), false);
      }
    }
    for (int q = threadIdx.x; q < r; q += blockDim.x) {
      float v;
      if (q == 0) {
        v = sf.vel_start;
      } else if (q == 1) {
        v = vmin(v0(a, pf, sf, 0, vm), sf.vel_start);
      } else {
        const Path p{a, base + q - 2};
        const Slot s = slots[q - 2];
        v = vmin(v0_n(a, p, s, 0, vm), s.vel_start);
      }
      a.v_init[row0 + q] = v;
      a.mode[row0 + q] = q == 0 ? BRAKE : FWD;
    }
    return;
  }

  for (int j = threadIdx.x; j < k; j += blockDim.x)
    slots[j] = slot_of(a, n, j);
  if (a.level == 3 && threadIdx.x == 0) {
    fol = Follow{a.stop_idx[n], a.idx_c[n], false, false, 0.0f, 0.0f};
  }
  __syncthreads();
  const Path pf{a, base + fs};
  const Slot sf = slots[fs];

  if (a.level == 3) {           // segment-2 backward
    const Follow f = fol;
    const float* vf_s = a.lv2 + (n * (k + 2)) * P;
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      write_row(a, n, t, kabs_m(pf, sf, P - 1 - t), kabs_m(pf, sf, P - 2 - t),
                el_seg2(pf, sf, f, P - 2 - t), vf_s[P - 2 - t], true);
    }
    if (threadIdx.x == 0) {
      a.v_init[n] = vf_s[P - 1];
      a.mode[n] = BWD;
    }
    return;
  }

  // level 2: warp 0 finds the follow state while the other warps write the
  // backward rows, which need only the paths' state
  const float vc = a.v_control[n];
  const long long lv1_row = n * r;
  if (warp == 0) {
    const float osd = a.opp_stop_dist[n];
    const float safety_total = __fadd_rn(*a.safety_d, *a.veh_length);
    const float gap = __fsub_rn(a.obj_dist[n], safety_total);
    const float s_stop = __fadd_rn(gap, osd);
    const float* s_f = a.s_f + n * P;
    int cnt = 0;
    for (int t = lane; t < P; t += 32) cnt += s_f[t] < s_stop;
    long long stop_idx = __reduce_add_sync(FULL, cnt);
    if (stop_idx > P - 1) stop_idx = P - 1;
    const float* s = a.s + (base + fs) * P;
    const long long nv = a.n_valid[base + fs];
    const long long last = nv < 1 ? 0 : (nv > P ? P - 1 : nv - 1);
    const float run = __fsub_rn(
        osd, __fsub_rn(s_stop, __fsub_rn(s[last], s[sf.pref])));
    const float* rc = a.roll_cum + n * a.F;
    cnt = 0;
    for (int f = lane; f < a.F; f += 32) cnt += rc[f] < run;
    long long i_run = (long long)__reduce_add_sync(FULL, cnt) + 1;
    if (i_run > a.F - 1) i_run = a.F - 1;
    const float* rv = a.roll_vel + n * a.F;
    const float opp_vel_at = run <= 0.0f ? rv[0] : rv[i_run];
    const float v_end_f = s_stop > s_f[P - 1] ? opp_vel_at : 0.0f;
    // the ego brake's stopping distance and the segment-1 hand-off
    const float* veb = a.lv1 + lv1_row * P;
    float acc = 0.0f;
    int hit = INT32_MAX;
    for (int t = lane; t < P; t += 32) {
      const float v = veb[t];
      acc = __fadd_rn(acc, v > STOP_V ? el_m(pf, sf, t) : 0.0f);
      if (v <= vc && t < hit) hit = t;
    }
    for (int o = 16; o > 0; o >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(FULL, acc, o));
    const int first = warp_first(hit);
    const long long idx_c_raw = first == INT32_MAX ? stop_idx : first;
    const bool seg1 = (sf.vel_start > vc) & (stop_idx >= 2);
    long long idx_c = 0;
    if (seg1) {
      idx_c = idx_c_raw == 0 ? stop_idx : idx_c_raw;
      if (idx_c > stop_idx) idx_c = stop_idx;
    }
    const float vcs = seg1 ? veb[idx_c] : sf.vel_start;
    const bool cannot_hold = acc >= s_stop;
    if (lane == 0) {
      a.stop_idx[n] = stop_idx;
      a.idx_c[n] = idx_c;
      a.seg1_active[n] = seg1;
      a.cannot_hold[n] = cannot_hold;
      a.too_close[n] = gap < 0.0f;
      a.vx_control_start[n] = vcs;
      a.ego_stop_d[n] = acc;
      fol = Follow{stop_idx, idx_c, seg1, cannot_hold, vcs, v_end_f};
    }
  } else {
    const int step = blockDim.x - 32;
    for (int e = threadIdx.x - 32; e < (r - 1) * T; e += step) {
      const int q = 1 + e / T, t = e - (q - 1) * T;
      if (q == 1) {           // unconstrained backward
        const float* vf_u = a.lv1 + (lv1_row + 1) * P;
        write_row(a, row0 + 1, t, kabs_m(pf, sf, P - 1 - t),
                  kabs_m(pf, sf, P - 2 - t), el_m(pf, sf, P - 2 - t),
                  vf_u[P - 2 - t], true);
      } else {                // normal backward
        const Path p{a, base + q - 2};
        const Slot s = slots[q - 2];
        const float* vf_n = a.lv1 + (lv1_row + q) * P;
        write_row(a, row0 + q, t, kabs_m(p, s, P - 1 - t),
                  kabs_m(p, s, P - 2 - t), el_n(p, s, P - 2 - t),
                  vf_n[P - 2 - t], true);
      }
    }
  }
  __syncthreads();
  const Follow f = fol;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {  // segment-2 forward
    float v = vmin(v_lat(a, pf, sf, t + 1), vc);
    if (t + 1 >= f.stop_idx) v = vmin(v, f.v_end_f);
    const float kf = kabs_m(pf, sf, t);
    write_row(a, row0, t, kf, kf, el_seg2(pf, sf, f, t), v, true);
  }
  for (int q = threadIdx.x; q < r; q += blockDim.x) {
    float v;
    if (q == 0) {
      float v0s = vmin(v_lat(a, pf, sf, 0), vc);
      if (0 >= f.stop_idx) v0s = vmin(v0s, f.v_end_f);
      v = vmin(v0s, vmin(f.vcs, vc));
    } else {
      v = a.lv1[(lv1_row + q) * P + P - 1];
    }
    a.v_init[row0 + q] = v;
    a.mode[row0 + q] = q == 0 ? FWD : BWD;
  }
}

// ---- the epilogue ----------------------------------------------------------

// ops/cuda_velstage.normal_bound's profile at point t of path j.
template <bool FB>
__device__ __forceinline__ float vx_normal(const Args& a, long long n, int j,
                                           const Slot& s, int t) {
  if (t >= s.v_idx || s.v_idx - s.pref <= 1) return 0.0f;
  const int P = a.P;
  return FB ? a.lv2[(n * (a.k + 2) + 2 + j) * P + P - 1 - t]
            : a.vx_normal[((n * a.k) + j) * P + t];
}

template <bool FB>
__global__ void __launch_bounds__(EPI_THREADS)
vel_stage_epilogue_kernel(const Args a) {
  extern __shared__ float vx[];               // the path's P velocities
  const int k = a.k, P = a.P, fs = a.fs;
  const long long i = blockIdx.x, n = i / k;
  const int j = (int)(i - n * k);
  const long long c_len = a.c_len[n];
  const Slot s{a.pref_idx[n * a.pref_sn + j * a.pref_sj], a.v_idx[i],
               a.vel_start[n * a.vs_sn + j * a.vs_sj], 0.0f};
  const bool follow = j == fs;
  const bool merge = follow && a.red_len[i];
  // the follow assembly (fb)
  long long stop_idx = 0, idx_c = 0;
  bool cannot_hold = false;
  const float *veb = nullptr, *v_seg2 = nullptr, *compl_ = nullptr;
  if (FB && follow) {
    stop_idx = a.stop_idx[n];
    idx_c = a.idx_c[n];
    cannot_hold = a.cannot_hold[n];
    veb = a.lv1 + (n * (k + 2)) * P;
    v_seg2 = a.lv3 + n * P;                     // flipped: point P - 1 - t
    compl_ = a.lv2 + (n * (k + 2) + 1) * P;    // flipped too
  }
  if (threadIdx.x == 0) {
    bool bound;
    if (!follow) {
      bound = s.v_idx - s.pref > 1
          && fabsf(__fsub_rn(vx_normal<FB>(a, n, j, s, (int)s.pref),
                             s.vel_start)) < *a.v_max_offset;
    } else if (FB) {
      const float vcs = a.vx_control_start[n];
      bool fbd = fabsf(__fsub_rn(v_seg2[P - 1 - idx_c], vcs)) <= 1.0f;
      fbd &= !((!a.seg1_active[n]) & (stop_idx < 2));
      const float vf0 = 0 < idx_c ? veb[0] : v_seg2[P - 1];
      fbd &= fabsf(__fsub_rn(vf0, s.vel_start)) <= 1.0f;
      bound = cannot_hold ? true : fbd;
    } else {
      bound = a.follow_bound[n];
    }
    a.vel_bound[i] = bound;
  }
  const float* vd = FB ? a.lv0 + i * P : nullptr;
  for (int t = threadIdx.x; t < P; t += blockDim.x) {
    float v;
    if (t < c_len) {
      v = a.vel_course[n * P + t];
    } else if (t < s.pref) {
      v = FB ? vd[t] : 0.0f;
    } else if (follow) {
      float vf;
      if (FB) {
        if (cannot_hold) {
          vf = veb[t];
        } else if (t > stop_idx) {
          vf = 0.0f;
        } else {
          vf = t < idx_c ? veb[t] : v_seg2[P - 1 - t];
        }
        vf = vmin(vf, compl_[P - 1 - t]);
      } else {
        vf = a.vx_follow[n * P + t];
      }
      v = merge ? vmin(vf, vx_normal<FB>(a, n, j, s, t)) : vf;
    } else {
      v = vx_normal<FB>(a, n, j, s, t);
    }
    vx[t] = v;
  }
  __syncthreads();
  // the profile row, in the output's order: 7 floats a point
  const float* path = a.paths + i * P * 5;
  const float* sr = a.s + i * P;
  const long long nv = a.n_valid[i];
  float* out = a.trajs + i * P * 7;
  for (int e = threadIdx.x; e < P * 7; e += blockDim.x) {
    const int t = e / 7, c = e - t * 7;
    float v;
    if (c == 0) {
      v = sr[t];
    } else if (c < 5) {
      v = path[t * 5 + c - 1];
    } else if (c == 5) {
      v = vx[t];
    } else if (t == P - 1) {
      v = 0.0f;
    } else {
      const float v0 = vx[t], v1 = vx[t + 1], el = path[t * 5 + 4];
      const float dv2 = __fsub_rn(__fmul_rn(v1, v1), __fmul_rn(v0, v0));
      const float ax = el > EPS_K
          ? div_rn(dv2, clamp_min(__fmul_rn(2.0f, el), EPS_K)) : 0.0f;
      const bool stationary = fabsf(v0) <= ISCLOSE_ATOL
          && fabsf(ax) <= ISCLOSE_ATOL && t < nv - 1;
      v = stationary ? -5.0f : ax;
    }
    out[e] = v;
  }
}

static int launch_level(const Args& a, cudaStream_t stream) {
  if (a.k < 1 || a.k > K_MAX || a.P < 2 || a.N < 0 || a.level < 0
      || a.level > 3 || a.fs < 0 || a.fs >= a.k || a.F < 1)
    return -1;
  if (a.N == 0) return 0;
  if (a.N > 0x7fffffffLL) return -1;
  vel_stage_level_kernel<<<(unsigned)a.N, WARPS * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Let the epilogue take more than 48 KB of shared memory (paths of more
// than 12,288 points), once per instance, at the first launch that needs
// it.
template <bool FB>
static int allow_smem(bool* done) {
  if (*done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      vel_stage_epilogue_kernel<FB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  *done = err == cudaSuccess;
  return (int)err;
}

static int launch_epilogue(const Args& a, cudaStream_t stream) {
  if (a.k < 1 || a.P < 2 || a.N < 0 || a.fs < 0 || a.fs >= a.k) return -1;
  if (a.N == 0) return 0;
  if (a.N * a.k > 0x7fffffffLL) return -1;
  const unsigned blocks = (unsigned)(a.N * a.k);
  const size_t bytes = (size_t)a.P * sizeof(float);
  if (bytes > 227 * 1024) return -1;
  if (bytes > 48 * 1024) {
    static bool ready[2] = {false, false};
    const int err = a.fb ? allow_smem<true>(&ready[1])
                         : allow_smem<false>(&ready[0]);
    if (err) return err;
  }
  if (a.fb) {
    vel_stage_epilogue_kernel<true><<<blocks, EPI_THREADS, bytes,
                                      stream>>>(a);
  } else {
    vel_stage_epilogue_kernel<false><<<blocks, EPI_THREADS, bytes,
                                       stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace vel_stage

extern "C" int vel_stage_level_launch(const vel_stage::Args* a,
                                      void* stream) {
  return vel_stage::launch_level(*a, (cudaStream_t)stream);
}

extern "C" int vel_stage_epilogue_launch(const vel_stage::Args* a,
                                         void* stream) {
  return vel_stage::launch_epilogue(*a, (cudaStream_t)stream);
}
