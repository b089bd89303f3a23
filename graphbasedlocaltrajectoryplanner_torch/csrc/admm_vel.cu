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
// Design (simple and right first): one block a row, one thread a point
// (K points a thread where n exceeds the block), the iterate in registers.
// The PCR tables (ceil(log2 n) levels x 2 x n floats) lie in shared memory;
// neighbours are exchanged through a double-buffered shared array, one
// __syncthreads() an exchange: 1 for A'w, one a PCR level, 1 for A x, so
// 9 a step at n = 115.  r_prim and r_dual are block max-reductions (max is
// exact in any order).
//
// Bound on the H100: neither bytes (about 5 KB of inputs a row) nor
// operations (about 70 float32 operations a point a step), but the chain of
// barriers: 150 steps of 9 dependent exchanges per row.  Rows are
// independent, so many blocks an SM hide each other's barriers.
//
// Bit-equal to the plain version: every operation is the plain version's,
// in its order, each rounded on its own (the __f*_rn intrinsics; built with
// -fmad=false besides), divisions correctly rounded (__fdiv_rn), the
// zero-filled shifts as additions and products with 0.0f, maximum and
// minimum propagating NaN as PyTorch's do.
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace admm

// R rows of n points.  Returns 0, -1 for an unsupported shape (n < 2 or
// n > N_MAX), or the CUDA error of the launch.
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
  const int threads = n < admm::T_MAX ? (n + 31) / 32 * 32 : admm::T_MAX;
  const int k = (n + threads - 1) / threads;
  const size_t smem = admm::smem_bytes(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 1) return admm::launch<1>(a, threads, smem, st);
  if (k == 2) return admm::launch<2>(a, threads, smem, st);
  return admm::launch<4>(a, threads, smem, st);
}
