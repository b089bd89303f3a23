// Fixed-iteration ADMM on banded velocity QPs: the SQP velocity backend's
// solver for the batched fleet tick, the interactive facade and the SQP
// backup-brake ladder.
//
// No TPU kernel: the JAX package runs this solve (graphbasedlocaltrajectory
// planner_tpu/ops/qp.py:admm_vel_qp) as one lax.scan inside one compiled
// XLA program.  Its plain PyTorch version (ops/qp.py:admm_vel_qp, written
// step for step as the JAX function) launches about 115 small device
// kernels a step (the PCR levels' shifts and multiply-adds), 17,160 a solve
// of 150 steps on an H100 (chip_smoke.py), so on the card the solve costs
// launches, not arithmetic.  This kernel is the whole solve in one launch.
//
// Per QP row (R rows of n points, the output of ops/qp.py:_vel_qp_data):
// the KKT band (diag, off), its parallel-cyclic-reduction factor, `iters`
// ADMM steps and the residuals r_prim and r_dual; optionally the duals y.
//
// Two designs, chosen by n alone (admm_vel_launch):
//
// Warp design, n <= WARP_N_MAX = 128 (every call of the planner: n = 115,
// nmbr_export_points).  One warp a QP row, WARP_ROWS rows a block; lane l
// holds the K = ceil(n / 32) consecutive points i = K l + k (blocked
// layout), so a stride below K stays inside the lane for most slots.  Every
// neighbour exchange (A'w, A x, the factor's and the sweeps' ceil(log2 n)
// levels, the residuals) is a warp shuffle; there is no block barrier at
// all, and the warps of rows past R leave at once.  The PCR tables (2 x
// levels x K floats a lane) lie in the warp's slice of shared memory, each
// lane reading only what it wrote.  The three divisions a point and step
// by the constant penalties (y/rho) run through csrc/ieee_fast.cuh: the
// reciprocals are made once a solve, and a step whose operands leave the
// window divides again with __fdiv_rn.  r_prim and r_dual are warp
// max-reductions.  The cyclic layout (i = l + 32 k) and the tables in
// registers were the other candidates measured (PERF.md, row 7).
//
// Block design, n > 128 (the kernel's first design): one block a row,
// one thread a point (K points a thread where n exceeds the block), the
// PCR tables in shared memory, neighbours through a double-buffered shared
// array with one __syncthreads() an exchange.
//
// Bound on the H100: neither bytes (about 5 KB of inputs a row) nor the
// 67 TFLOP/s of fused multiply-adds (about 80 float32 operations a point a
// step), which this kernel cannot use: without contraction a lane starts
// one add or multiply a cycle, 33.5e12 a second on 132 SMs.  Measured
// against both in chip_smoke.py; the chain of a step (about 9 dependent
// shuffles and their arithmetic) is the floor PERF.md records for row 7.
//
// Bit-equal to the plain version: every operation is the plain version's,
// in its order, each rounded on its own (the __f*_rn intrinsics; built with
// -fmad=false besides), divisions correctly rounded (__fdiv_rn or its
// branch-free form, bit for bit), the zero-filled shifts as additions and
// products with 0.0f, maximum and minimum propagating NaN as PyTorch's do.
// The layout changes where a point lives, not what is computed for it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ieee_fast.cuh"

namespace admm {

constexpr int N_MAX = 1024;       // points a row
constexpr int T_MAX = 256;        // threads a block
constexpr float BIG = 1e12f;

struct Args {
  const float *e, *f, *rho_b, *rho_a, *rho_d, *q, *x0, *lb, *ub, *ua, *ud;
  float *x, *r_prim, *r_dual, *y;  // y may be null
  int R, n, iters, levels;
  float sigma, alpha, one_m_alpha, w_smooth;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// torch.maximum / torch.minimum: NaN propagates
__device__ __forceinline__ float vmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float vmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// running max of a reduction (torch.amax: NaN propagates)
__device__ __forceinline__ float rmax(float m, float v) {
  return (v != v || v > m) ? v : m;
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = rmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();                   // red may still be read by a caller
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = rmax(m, red[w]);
  return m;
}

// K points a thread: point k of thread t is i = t + k * blockDim.x.
template <int K>
__global__ void __launch_bounds__(T_MAX)
admm_vel_kernel(Args a) {
  extern __shared__ float sm[];
  const int n = a.n, T = blockDim.x, t = threadIdx.x;
  const long long row = blockIdx.x;
  float* tbl_al = sm;                          // levels x n
  float* tbl_ga = tbl_al + a.levels * n;       // levels x n
  float* buf0 = tbl_ga + a.levels * n;         // 2 x n exchange buffers
  float* fac = buf0 + 2 * n;                   // 3 x n factor scratch
  float* red = fac + 3 * n;                    // 32 warp partials
  int p = 0;
  auto buf = [&](int which) { return buf0 + which * n; };

  const long long o1 = row * n, o2 = row * (n - 1);
  const float ws = a.w_smooth;

  // ---- coefficients and the start, in registers --------------------------
  float x[K], zb[K], za[K], zd[K], yb[K], ya[K], yd[K];
  float q[K], lb[K], ub[K], rb[K], e[K], f[K], ra[K], rd[K], ua[K], ud[K];
  float binv[K], dd1[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = t + k * T;
    const bool in = i < n, inner = i < n - 1;
    q[k] = in ? a.q[o1 + i] : 0.f;
    lb[k] = in ? a.lb[o1 + i] : 0.f;
    ub[k] = in ? a.ub[o1 + i] : 0.f;
    rb[k] = in ? a.rho_b[o1 + i] : 1.f;
    x[k] = in ? a.x0[o1 + i] : 0.f;
    e[k] = inner ? a.e[o2 + i] : 0.f;
    f[k] = inner ? a.f[o2 + i] : 0.f;
    ra[k] = inner ? a.rho_a[o2 + i] : 1.f;
    rd[k] = inner ? a.rho_d[o2 + i] : 1.f;
    ua[k] = inner ? a.ua[o2 + i] : 0.f;
    ud[k] = inner ? a.ud[o2 + i] : 0.f;
    // 1 + w_smooth * dd, dd = 1 at both ends, 2 between
    dd1[k] = add(1.0f, mul(ws, (i == 0 || i == n - 1) ? 1.0f : 2.0f));
    yb[k] = ya[k] = yd[k] = 0.f;
  }

  // ---- the KKT band: diag, and off in the factor's a (sub) and c (super)
  float fa[K], fb[K], fc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = t + k * T;
    if (i >= n) { fa[k] = fb[k] = fc[k] = 0.f; continue; }
    const float pr = i < n - 1 ? add(mul(ra[k], mul(e[k], e[k])),
                                     mul(rd[k], mul(f[k], f[k]))) : 0.0f;
    float pl = 0.0f, off_l = 0.0f;
    if (i > 0) {
      const float ral = a.rho_a[o2 + i - 1], rdl = a.rho_d[o2 + i - 1];
      pl = add(ral, rdl);
      off_l = sub(add(-ws, mul(ral, a.e[o2 + i - 1])),
                  mul(rdl, a.f[o2 + i - 1]));
    }
    fb[k] = add(add(add(add(dd1[k], a.sigma), rb[k]), pr), pl);
    fa[k] = off_l;
    fc[k] = i < n - 1 ? sub(add(-ws, mul(ra[k], e[k])), mul(rd[k], f[k]))
                      : 0.0f;
  }

  // ---- PCR factor: a level eliminates the couplings at stride s ----------
  float* fa_s = fac;
  float* fb_s = fac + n;
  float* fc_s = fac + 2 * n;
  for (int lv = 0, s = 1; lv < a.levels; ++lv, s *= 2) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = t + k * T;
      if (i < n) { fa_s[i] = fa[k]; fb_s[i] = fb[k]; fc_s[i] = fc[k]; }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = t + k * T;
      if (i >= n) continue;
      const bool dn = i - s >= 0, up = i + s < n;
      const float b_dn = dn ? fb_s[i - s] : 1.0f;
      const float b_up = up ? fb_s[i + s] : 1.0f;
      const float c_dn = dn ? fc_s[i - s] : 0.0f;
      const float a_up = up ? fa_s[i + s] : 0.0f;
      const float a_dn = dn ? fa_s[i - s] : 0.0f;
      const float c_up = up ? fc_s[i + s] : 0.0f;
      const float al = dvd(-fa[k], b_dn);
      const float ga = dvd(-fc[k], b_up);
      fb[k] = add(add(fb[k], mul(al, c_dn)), mul(ga, a_up));
      fa[k] = mul(al, a_dn);
      fc[k] = mul(ga, c_up);
      tbl_al[lv * n + i] = al;
      tbl_ga[lv * n + i] = ga;
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < K; ++k) binv[k] = dvd(1.0f, fb[k]);

  // ---- z = A x0 ------------------------------------------------------------
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = t + k * T;
    if (i < n) buf(p)[i] = x[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = t + k * T;
    zb[k] = x[k];
    if (i < n - 1) {
      const float xn = buf(p)[i + 1];
      za[k] = add(mul(e[k], x[k]), xn);
      zd[k] = sub(mul(f[k], x[k]), xn);
    } else {
      za[k] = zd[k] = 0.f;
    }
  }
  p ^= 1;

  // ---- ADMM steps ----------------------------------------------------------
  for (int it = 0; it < a.iters; ++it) {
    // rhs = sigma x - q + A'(rho z - y)
    float r[K], u[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = t + k * T;
      const float wb = sub(mul(rb[k], zb[k]), yb[k]);
      const float wa = sub(mul(ra[k], za[k]), ya[k]);
      const float wd = sub(mul(rd[k], zd[k]), yd[k]);
      u[k] = add(wb, i < n - 1 ? add(mul(e[k], wa), mul(f[k], wd)) : 0.0f);
      if (i < n - 1) buf(p)[i] = sub(wa, wd);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = t + k * T;
      const float vl = (i > 0 && i < n) ? buf(p)[i - 1] : 0.0f;
      r[k] = add(sub(mul(a.sigma, x[k]), q[k]), add(u[k], vl));
    }
    p ^= 1;
    // x_t = K^-1 rhs: the PCR sweeps, then b_inv
    for (int lv = 0, s = 1; lv < a.levels; ++lv, s *= 2) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = t + k * T;
        if (i < n) buf(p)[i] = r[k];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = t + k * T;
        if (i >= n) continue;
        const float rm = i - s >= 0 ? buf(p)[i - s] : 0.0f;
        const float rp = i + s < n ? buf(p)[i + s] : 0.0f;
        r[k] = add(add(r[k], mul(tbl_al[lv * n + i], rm)),
                   mul(tbl_ga[lv * n + i], rp));
      }
      p ^= 1;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = t + k * T;
      r[k] = mul(r[k], binv[k]);
      if (i < n) buf(p)[i] = r[k];
    }
    __syncthreads();
    // relaxation, projection and dual update
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = t + k * T;
      const float xt = r[k];
      const float zh_b = add(mul(a.alpha, xt), mul(a.one_m_alpha, zb[k]));
      const float z_bn = vmin(vmax(add(zh_b, dvd(yb[k], rb[k])), lb[k]),
                              ub[k]);
      x[k] = add(mul(a.alpha, xt), mul(a.one_m_alpha, x[k]));
      yb[k] = add(yb[k], mul(rb[k], sub(zh_b, z_bn)));
      zb[k] = z_bn;
      if (i < n - 1) {
        const float xn = buf(p)[i + 1];
        const float ta = add(mul(e[k], xt), xn);
        const float td = sub(mul(f[k], xt), xn);
        const float zh_a = add(mul(a.alpha, ta), mul(a.one_m_alpha, za[k]));
        const float zh_d = add(mul(a.alpha, td), mul(a.one_m_alpha, zd[k]));
        const float z_an = vmin(vmax(add(zh_a, dvd(ya[k], ra[k])), -BIG),
                                ua[k]);
        const float z_dn = vmin(vmax(add(zh_d, dvd(yd[k], rd[k])), -BIG),
                                ud[k]);
        ya[k] = add(ya[k], mul(ra[k], sub(zh_a, z_an)));
        yd[k] = add(yd[k], mul(rd[k], sub(zh_d, z_dn)));
        za[k] = z_an;
        zd[k] = z_dn;
      }
    }
    p ^= 1;
  }

  // ---- residuals -------------------------------------------------------------
  // neighbours of the final x (both sides) and of y_a - y_d (left), in both
  // buffers: the last exchange's reads end first
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = t + k * T;
    if (i < n) buf(p)[i] = x[k];
    if (i < n - 1) buf(p ^ 1)[i] = sub(ya[k], yd[k]);
  }
  __syncthreads();
  float mp = 0.0f, md = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = t + k * T;
    if (i >= n) continue;
    const float xl = i > 0 ? buf(p)[i - 1] : 0.0f;
    const float xr = i < n - 1 ? buf(p)[i + 1] : 0.0f;
    mp = rmax(mp, fabsf(sub(x[k], zb[k])));
    float atw = yb[k];
    if (i < n - 1) {
      mp = rmax(mp, fabsf(sub(add(mul(e[k], x[k]), xr), za[k])));
      mp = rmax(mp, fabsf(sub(sub(mul(f[k], x[k]), xr), zd[k])));
      atw = add(atw, add(mul(e[k], ya[k]), mul(f[k], yd[k])));
    } else {
      atw = add(atw, 0.0f);
    }
    atw = add(atw, i > 0 ? buf(p ^ 1)[i - 1] : 0.0f);
    const float px = sub(mul(dd1[k], x[k]), mul(ws, add(xl, xr)));
    md = rmax(md, fabsf(add(add(px, q[k]), atw)));
  }
  mp = block_max(mp, red);
  md = block_max(md, red + 32);

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = t + k * T;
    if (i < n) a.x[o1 + i] = x[k];
    if (a.y) {
      float* yr = a.y + row * (3LL * n - 2);
      if (i < n) yr[i] = yb[k];
      if (i < n - 1) {
        yr[n + i] = ya[k];
        yr[2 * n - 1 + i] = yd[k];
      }
    }
  }
  if (t == 0) {
    a.r_prim[row] = mp;
    a.r_dual[row] = md;
  }
}

// ===========================================================================
// The warp design: one warp a QP row
// ===========================================================================

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_N_MAX = 128;   // the largest n of the warp design
// chosen by measurement (PERF.md, row 7)
constexpr int WARP_ROWS = 2;          // rows (warps) a block
constexpr bool WARP_CYCLIC = false;   // point i at lane i / K, slot i % K
constexpr bool WARP_TBL_REGS = false; // the PCR tables in shared memory

// the PCR levels unrolled for K points a lane, n in (32 (K - 1), 32 K]:
// ceil(log2 n) is at most 5, 6, 7, 7
__host__ __device__ constexpr int warp_levels(int K) {
  return K == 1 ? 5 : K == 2 ? 6 : 7;
}

template <int V> struct Int { static constexpr int value = V; };

// The clamps of the warp design: maximum and minimum that propagate NaN in
// one instruction each (max.NaN, min.NaN), without the predicates of vmax
// and vmin.  They return the canonical NaN where vmax and vmin return the
// NaN operand itself; the card's arithmetic makes only the canonical NaN,
// and a clamped z reaches every output through a subtraction, so x, y,
// r_prim and r_dual are the same bits either way.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// f(Int<0>{}), ..., f(Int<N - 1>{}): a loop whose index is a constant
template <int N, typename F>
__device__ __forceinline__ void unroll(F&& f) {
  if constexpr (N > 0) {
    unroll<N - 1>(f);
    f(Int<N - 1>{});
  }
}

// Where the K points of a lane lie, and their neighbours at a constant
// stride S by warp shuffles.  Cyclic: i = lane + 32 k, so a stride below
// 32 is one rotation of each slot across the lanes and a stride of 32 or
// 64 a move between slots of a lane.  Blocked: i = K lane + k, so a stride
// below K stays in the lane for most slots.
template <int K, bool CYCLIC>
struct Lanes {
  static __device__ __forceinline__ int point(int lane, int k) {
    return CYCLIC ? lane + 32 * k : K * lane + k;
  }

  // out[k] = v at point i - S; `fill` where i - S < 0
  template <int S>
  static __device__ __forceinline__ void down(const float (&v)[K],
                                              float (&out)[K], int lane,
                                              float fill) {
    if constexpr (CYCLIC && S % 32 == 0) {
      constexpr int M = S / 32;
#pragma unroll
      for (int k = 0; k < K; ++k)
        out[k] = k >= M ? v[k >= M ? k - M : 0] : fill;
    } else if constexpr (CYCLIC) {
      float rot[K];
      const int src = (lane - S) & 31;
#pragma unroll
      for (int k = 0; k < K; ++k) rot[k] = __shfl_sync(FULL, v[k], src);
#pragma unroll
      for (int k = 0; k < K; ++k)
        out[k] = lane >= S ? rot[k] : (k > 0 ? rot[k > 0 ? k - 1 : 0] : fill);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int q = k - S;                  // constants once unrolled
        if (q >= 0) {
          out[k] = v[q >= 0 ? q : 0];
        } else {
          const int dl = (K - 1 - q) / K;     // lanes back: ceil(-q / K)
          const float t = __shfl_up_sync(FULL, v[q + dl * K], dl);
          out[k] = lane >= dl ? t : fill;
        }
      }
    }
  }

  // out[k] = v at point i + S; `fill` where i + S >= n
  template <int S>
  static __device__ __forceinline__ void up(const float (&v)[K],
                                            float (&out)[K], int lane, int n,
                                            float fill) {
    if constexpr (CYCLIC && S % 32 == 0) {
      constexpr int M = S / 32;
#pragma unroll
      for (int k = 0; k < K; ++k)
        out[k] = k + M < K ? v[k + M < K ? k + M : 0] : fill;
    } else if constexpr (CYCLIC) {
      float rot[K];
      const int src = (lane + S) & 31;
#pragma unroll
      for (int k = 0; k < K; ++k) rot[k] = __shfl_sync(FULL, v[k], src);
#pragma unroll
      for (int k = 0; k < K; ++k)
        out[k] = lane + S < 32
                     ? rot[k]
                     : (k + 1 < K ? rot[k + 1 < K ? k + 1 : 0] : fill);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int q = k + S;
        if (q < K) {
          out[k] = v[q < K ? q : 0];
        } else {
          const int dl = q / K;               // lanes ahead
          out[k] = __shfl_down_sync(FULL, v[q - dl * K], dl);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (point(lane, k) + S >= n) out[k] = fill;
  }
};

// One warp a row, blockDim.x / 32 rows a block.  TBL_REGS: the PCR tables
// in registers, else in the warp's slice of shared memory (each lane reads
// only what it wrote: no barrier).  CHAIN_ONLY (a measurement variant):
// the steps' exchanges and PCR sweeps without the relaxation, projection
// and dual update.
template <int K, bool CYCLIC, bool TBL_REGS, bool CHAIN_ONLY>
__global__ void __launch_bounds__(256)
admm_vel_warp_kernel(Args a) {
  using L = Lanes<K, CYCLIC>;
  constexpr int LV = warp_levels(K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= a.R) return;                 // no block barrier follows
  const int n = a.n, levels = a.levels;
  const long long o1 = row * n, o2 = row * (n - 1);
  const float ws = a.w_smooth;
  extern __shared__ float wsm[];
  float* tsm = wsm + warp * (2 * LV * K * 32);
  float t_al[TBL_REGS ? LV : 1][K], t_ga[TBL_REGS ? LV : 1][K];

  // ---- coefficients and the start, in registers --------------------------
  float x[K], zb[K], za[K], zd[K], yb[K], ya[K], yd[K];
  float q[K], lb[K], ub[K], rb[K], e[K], f[K], ra[K], rd[K], ua[K], ud[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = L::point(lane, k);
    const bool in = i < n, inner = i < n - 1;
    q[k] = in ? a.q[o1 + i] : 0.f;
    lb[k] = in ? a.lb[o1 + i] : 0.f;
    ub[k] = in ? a.ub[o1 + i] : 0.f;
    rb[k] = in ? a.rho_b[o1 + i] : 1.f;
    x[k] = in ? a.x0[o1 + i] : 0.f;
    e[k] = inner ? a.e[o2 + i] : 0.f;
    f[k] = inner ? a.f[o2 + i] : 0.f;
    ra[k] = inner ? a.rho_a[o2 + i] : 1.f;
    rd[k] = inner ? a.rho_d[o2 + i] : 1.f;
    ua[k] = inner ? a.ua[o2 + i] : 0.f;
    ud[k] = inner ? a.ud[o2 + i] : 0.f;
    yb[k] = ya[k] = yd[k] = 0.f;
  }

  // ---- the KKT band: diag, and off in the factor's a (sub) and c (super)
  float fa[K], fb[K], fc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = L::point(lane, k);
    if (i >= n) { fa[k] = fb[k] = fc[k] = 0.f; continue; }
    // 1 + w_smooth * dd, dd = 1 at both ends, 2 between
    const float dd1 = add(1.0f, mul(ws, (i == 0 || i == n - 1) ? 1.0f : 2.0f));
    const float pr = i < n - 1 ? add(mul(ra[k], mul(e[k], e[k])),
                                     mul(rd[k], mul(f[k], f[k]))) : 0.0f;
    float pl = 0.0f, off_l = 0.0f;
    if (i > 0) {
      const float ral = a.rho_a[o2 + i - 1], rdl = a.rho_d[o2 + i - 1];
      pl = add(ral, rdl);
      off_l = sub(add(-ws, mul(ral, a.e[o2 + i - 1])),
                  mul(rdl, a.f[o2 + i - 1]));
    }
    fb[k] = add(add(add(add(dd1, a.sigma), rb[k]), pr), pl);
    fa[k] = off_l;
    fc[k] = i < n - 1 ? sub(add(-ws, mul(ra[k], e[k])), mul(rd[k], f[k]))
                      : 0.0f;
  }

  // ---- PCR factor: a level eliminates the couplings at stride S ----------
  unroll<LV>([&](auto lv_) {
    constexpr int lv = decltype(lv_)::value, S = 1 << lv;
    if constexpr (K == 1) {           // K > 1: levels == LV (launch_warp_k)
      if (lv >= levels) return;
    }
    float b_dn[K], b_up[K], c_dn[K], a_up[K], a_dn[K], c_up[K];
    L::template down<S>(fb, b_dn, lane, 1.0f);
    L::template up<S>(fb, b_up, lane, n, 1.0f);
    L::template down<S>(fc, c_dn, lane, 0.0f);
    L::template up<S>(fa, a_up, lane, n, 0.0f);
    L::template down<S>(fa, a_dn, lane, 0.0f);
    L::template up<S>(fc, c_up, lane, n, 0.0f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool in = L::point(lane, k) < n;
      const float al = in ? dvd(-fa[k], b_dn[k]) : 0.0f;
      const float ga = in ? dvd(-fc[k], b_up[k]) : 0.0f;
      if (in) {
        fb[k] = add(add(fb[k], mul(al, c_dn[k])), mul(ga, a_up[k]));
        fa[k] = mul(al, a_dn[k]);
        fc[k] = mul(ga, c_up[k]);
      }
      if constexpr (TBL_REGS) {
        t_al[lv][k] = al;
        t_ga[lv][k] = ga;
      } else {
        tsm[(lv * K + k) * 32 + lane] = al;
        tsm[((LV + lv) * K + k) * 32 + lane] = ga;
      }
    }
  });
  // b_inv, and the reciprocals of the penalties for the steps' divisions
  float binv[K], rcb[K], rca[K], rcd[K];
  bool rc_ok = true;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    binv[k] = L::point(lane, k) < n ? dvd(1.0f, fb[k]) : 0.0f;
    const ieee_fast::Recip Rb = ieee_fast::make_recip(rb[k]);
    const ieee_fast::Recip Ra = ieee_fast::make_recip(ra[k]);
    const ieee_fast::Recip Rd = ieee_fast::make_recip(rd[k]);
    rcb[k] = Rb.r;
    rca[k] = Ra.r;
    rcd[k] = Rd.r;
    rc_ok &= Rb.ok & Ra.ok & Rd.ok;
  }

  // ---- z = A x0 ------------------------------------------------------------
  {
    float xn[K];
    L::template up<1>(x, xn, lane, n, 0.0f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      zb[k] = x[k];
      if (L::point(lane, k) < n - 1) {
        za[k] = add(mul(e[k], x[k]), xn[k]);
        zd[k] = sub(mul(f[k], x[k]), xn[k]);
      } else {
        za[k] = zd[k] = 0.f;
      }
    }
  }

  // ---- ADMM steps ----------------------------------------------------------
  for (int it = 0; it < a.iters; ++it) {
    // y / rho first: off the step's chain, and the step's one branch (taken
    // where an operand leaves ieee_fast's window).  The window test of
    // ieee_fast::div, |y| in [2^-60, 2^60] or y == 0, runs on the bit
    // patterns of all 3 K dividends at once, as a max and a min tree
    // (NaN and infinity lie above 2^60; y - 1 wraps a zero to the top)
    float db[K], da[K], dd[K];
    if constexpr (!CHAIN_ONLY) {
      unsigned hi[K], lo[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        bool unused = true;       // the test below replaces div's own
        const ieee_fast::Recip Rb{rb[k], rcb[k], true};
        const ieee_fast::Recip Ra{ra[k], rca[k], true};
        const ieee_fast::Recip Rd{rd[k], rcd[k], true};
        db[k] = ieee_fast::div(yb[k], Rb, unused);
        da[k] = ieee_fast::div(ya[k], Ra, unused);
        dd[k] = ieee_fast::div(yd[k], Rd, unused);
        const unsigned b0 = abs_bits(yb[k]), b1 = abs_bits(ya[k]),
                       b2 = abs_bits(yd[k]);
        hi[k] = umax(umax(b0, b1), b2);
        lo[k] = umin(umin(b0 - 1u, b1 - 1u), b2 - 1u);
      }
#pragma unroll
      for (int w = 1; w < K; w *= 2) {
#pragma unroll
        for (int k = 0; k + w < K; k += 2 * w) {
          hi[k] = umax(hi[k], hi[k + w]);
          lo[k] = umin(lo[k], lo[k + w]);
        }
      }
      const bool ok = rc_ok & (hi[0] <= 0x5d800000u)     // 2^60
                      & (lo[0] >= 0x217fffffu);          // 2^-60, less 1
      if (!ok) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          db[k] = dvd(yb[k], rb[k]);
          da[k] = dvd(ya[k], ra[k]);
          dd[k] = dvd(yd[k], rd[k]);
        }
      }
    }
    // rhs = sigma x - q + A'(rho z - y)
    float r[K], u[K], wmd[K], vl[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float wb = sub(mul(rb[k], zb[k]), yb[k]);
      const float wa = sub(mul(ra[k], za[k]), ya[k]);
      const float wd = sub(mul(rd[k], zd[k]), yd[k]);
      u[k] = add(wb, L::point(lane, k) < n - 1
                         ? add(mul(e[k], wa), mul(f[k], wd)) : 0.0f);
      wmd[k] = sub(wa, wd);
    }
    L::template down<1>(wmd, vl, lane, 0.0f);
#pragma unroll
    for (int k = 0; k < K; ++k)
      r[k] = add(sub(mul(a.sigma, x[k]), q[k]), add(u[k], vl[k]));
    // x_t = K^-1 rhs: the PCR sweeps, then b_inv
    unroll<LV>([&](auto lv_) {
      constexpr int lv = decltype(lv_)::value, S = 1 << lv;
      if constexpr (K == 1) {
        if (lv >= levels) return;
      }
      float rm[K], rp[K];
      L::template down<S>(r, rm, lane, 0.0f);
      L::template up<S>(r, rp, lane, n, 0.0f);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float al, ga;
        if constexpr (TBL_REGS) {
          al = t_al[lv][k];
          ga = t_ga[lv][k];
        } else {
          al = tsm[(lv * K + k) * 32 + lane];
          ga = tsm[((LV + lv) * K + k) * 32 + lane];
        }
        r[k] = add(add(r[k], mul(al, rm[k])), mul(ga, rp[k]));
      }
    });
    float xn[K];
#pragma unroll
    for (int k = 0; k < K; ++k) r[k] = mul(r[k], binv[k]);
    L::template up<1>(r, xn, lane, n, 0.0f);
    // relaxation, projection and dual update.  The dynamics rows run on
    // every slot without a branch: past the last one (i >= n - 1) e, f,
    // u_acc, u_dec, z, y and the neighbour are 0 and rho_acc, rho_dec 1,
    // so z and y stay 0 there, and only points past n read them
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float xt = r[k];
      const float ta = add(mul(e[k], xt), xn[k]);
      const float td = sub(mul(f[k], xt), xn[k]);
      if constexpr (CHAIN_ONLY) {
        x[k] = xt;
        za[k] = ta;
        zd[k] = td;
      } else {
        const float zh_b = add(mul(a.alpha, xt), mul(a.one_m_alpha, zb[k]));
        const float z_bn = min_nan(max_nan(add(zh_b, db[k]), lb[k]), ub[k]);
        x[k] = add(mul(a.alpha, xt), mul(a.one_m_alpha, x[k]));
        yb[k] = add(yb[k], mul(rb[k], sub(zh_b, z_bn)));
        zb[k] = z_bn;
        const float zh_a = add(mul(a.alpha, ta), mul(a.one_m_alpha, za[k]));
        const float zh_d = add(mul(a.alpha, td), mul(a.one_m_alpha, zd[k]));
        const float z_an = min_nan(max_nan(add(zh_a, da[k]), -BIG), ua[k]);
        const float z_dn = min_nan(max_nan(add(zh_d, dd[k]), -BIG), ud[k]);
        ya[k] = add(ya[k], mul(ra[k], sub(zh_a, z_an)));
        yd[k] = add(yd[k], mul(rd[k], sub(zh_d, z_dn)));
        za[k] = z_an;
        zd[k] = z_dn;
      }
    }
  }

  // ---- residuals ----------------------------------------------------------
  float xl[K], xr[K], ymd[K], yl[K];
  L::template down<1>(x, xl, lane, 0.0f);
  L::template up<1>(x, xr, lane, n, 0.0f);
#pragma unroll
  for (int k = 0; k < K; ++k) ymd[k] = sub(ya[k], yd[k]);
  L::template down<1>(ymd, yl, lane, 0.0f);
  float mp = 0.0f, md = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = L::point(lane, k);
    if (i >= n) continue;
    mp = rmax(mp, fabsf(sub(x[k], zb[k])));
    float atw = yb[k];
    if (i < n - 1) {
      mp = rmax(mp, fabsf(sub(add(mul(e[k], x[k]), xr[k]), za[k])));
      mp = rmax(mp, fabsf(sub(sub(mul(f[k], x[k]), xr[k]), zd[k])));
      atw = add(atw, add(mul(e[k], ya[k]), mul(f[k], yd[k])));
    } else {
      atw = add(atw, 0.0f);
    }
    atw = add(atw, yl[k]);
    const float dd1 = add(1.0f, mul(ws, (i == 0 || i == n - 1) ? 1.0f : 2.0f));
    const float px = sub(mul(dd1, x[k]), mul(ws, add(xl[k], xr[k])));
    md = rmax(md, fabsf(add(add(px, q[k]), atw)));
  }
  for (int o = 16; o > 0; o >>= 1) {
    mp = rmax(mp, __shfl_xor_sync(FULL, mp, o));
    md = rmax(md, __shfl_xor_sync(FULL, md, o));
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = L::point(lane, k);
    if (i < n) a.x[o1 + i] = x[k];
    if (a.y) {
      float* yr = a.y + row * (3LL * n - 2);
      if (i < n) yr[i] = yb[k];
      if (i < n - 1) {
        yr[n + i] = ya[k];
        yr[2 * n - 1 + i] = yd[k];
      }
    }
  }
  if (lane == 0) {
    a.r_prim[row] = mp;
    a.r_dual[row] = md;
  }
}

int levels_of(int n) {
  int lv = 0;
  for (int s = 1; s < n; s *= 2) ++lv;
  return lv;
}

size_t smem_bytes(int n) {
  return sizeof(float) * ((size_t)(2 * levels_of(n) + 5) * n + 64);
}

template <int K>
static int launch(const Args& a, int threads, size_t smem, cudaStream_t st) {
  // the largest shared memory any n takes, once for each instance (a
  // static of a static function: one object per library)
  static bool attr_set = false;
  if (smem > 48 * 1024 && !attr_set) {
    if (cudaFuncSetAttribute(admm_vel_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(N_MAX)) != cudaSuccess)
      return -1;
    attr_set = true;
  }
  admm_vel_kernel<K><<<a.R, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// the block design at any n
static int launch_block(const Args& a, cudaStream_t st) {
  const int n = a.n;
  const int threads = n < T_MAX ? (n + 31) / 32 * 32 : T_MAX;
  const int k = (n + threads - 1) / threads;
  const size_t smem = smem_bytes(n);
  if (k == 1) return launch<1>(a, threads, smem, st);
  if (k == 2) return launch<2>(a, threads, smem, st);
  return launch<4>(a, threads, smem, st);
}

// the warp design with K points a lane, `rows` rows (1 .. 8) a block
template <int K, bool CYCLIC, bool TBL_REGS, bool CHAIN_ONLY>
static int launch_warp_k(const Args& a, int rows, cudaStream_t st) {
  constexpr int LV = warp_levels(K);
  if (rows < 1 || rows > 8 || a.n > 32 * K || a.levels > LV ||
      (K > 1 && a.levels != LV))
    return -1;
  constexpr size_t warp_smem = TBL_REGS ? 0 : sizeof(float) * 2 * LV * K * 32;
  const size_t smem = warp_smem * rows;
  static bool attr_set = false;       // once a library (see launch)
  if (smem > 48 * 1024 && !attr_set) {
    if (cudaFuncSetAttribute(
            admm_vel_warp_kernel<K, CYCLIC, TBL_REGS, CHAIN_ONLY>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)(warp_smem * 8)) != cudaSuccess)
      return -1;
    attr_set = true;
  }
  const long long blocks = ((long long)a.R + rows - 1) / rows;
  admm_vel_warp_kernel<K, CYCLIC, TBL_REGS, CHAIN_ONLY>
      <<<(unsigned)blocks, 32 * rows, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool CYCLIC, bool TBL_REGS>
static int launch_warp(const Args& a, int rows, cudaStream_t st) {
  switch ((a.n + 31) / 32) {
    case 1: return launch_warp_k<1, CYCLIC, TBL_REGS, false>(a, rows, st);
    case 2: return launch_warp_k<2, CYCLIC, TBL_REGS, false>(a, rows, st);
    case 3: return launch_warp_k<3, CYCLIC, TBL_REGS, false>(a, rows, st);
    case 4: return launch_warp_k<4, CYCLIC, TBL_REGS, false>(a, rows, st);
    default: return -1;
  }
}

}  // namespace admm

// R rows of n points: the warp design for n <= 128, the block design
// above.  Returns 0, -1 for an unsupported shape (n < 2 or n > N_MAX), or
// the CUDA error of the launch.
extern "C" int admm_vel_launch(
    const float* e, const float* f, const float* rho_b, const float* rho_a,
    const float* rho_d, const float* q, const float* x0, const float* lb,
    const float* ub, const float* ua, const float* ud, float* x,
    float* r_prim, float* r_dual, float* y, int R, int n, int iters,
    float sigma, float alpha, float one_m_alpha, float w_smooth,
    void* stream) {
  if (n < 2 || n > admm::N_MAX || iters < 0 || R < 0) return -1;
  if (R == 0) return 0;
  admm::Args a{e, f, rho_b, rho_a, rho_d, q, x0, lb, ub, ua, ud,
               x, r_prim, r_dual, y, R, n, iters, admm::levels_of(n),
               sigma, alpha, one_m_alpha, w_smooth};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= admm::WARP_N_MAX)
    return admm::launch_warp<admm::WARP_CYCLIC, admm::WARP_TBL_REGS>(
        a, admm::WARP_ROWS, st);
  return admm::launch_block(a, st);
}
