// Stacked velocity recurrences for the batched fleet tick.
//
// Replaces the TPU kernels graphbasedlocaltrajectoryplanner_tpu/ops/
// pallas_velocity.py:_kernel_cgg (via _fused_vel_scan_flat_cgg, the
// constant-gg velocity stage) and :_kernel (via _fused_vel_scan_flat, the
// brake rows of the opponent summary and the emergency profile) — one
// template, CONST_GG selecting between a constant local gg and per-step gg
// streams, EXP_ONE dropping the pow calls of the friction circle when
// dyn_model_exp == 1.  Semantics of ops/velocity.stacked_vel_scan: R
// independent length-T recurrences, per row one mode — FWD (friction circle
// and machine-limit interpolation minus drag, capped by v_lim), BRAKE, or
// BWD (two-step conservative refinement; rows arrive pre-flipped).
// Output (R, T+1) with column 0 = v_init.  The machine limit follows
// jnp.interp (constant extrapolation, same arithmetic order).
//
// Bound on the H100: bytes by the count (4 or 8 float32 streams of R x T in,
// one out), but the T dependent steps per row make it latency-bound.
// Design: one thread per row with the carry in a register; each thread
// reads its own row sequentially in the (R, T) layout of the JAX caller
// (consecutive steps share cache lines, so no transpose pass is made); a
// row computes only its own mode's candidate.
#include <cuda_runtime.h>
#include <math.h>

struct VelParams {
  float gg_ax, gg_ay;      // constant local gg (CONST_GG)
  float exp, inv_exp;      // friction-circle shape
  float drag_coeff, m_veh;
  float interp_eps;        // jnp.interp zero-width guard
  int M;                   // machine-limit table rows
};

template <bool EXP_ONE>
__device__ __forceinline__ float ax_tires(float v, float k_abs, float axm,
                                          float aym, const VelParams& p) {
  const float ay_used = v * v * k_abs;
  const float frac = fminf(fmaxf(ay_used / fmaxf(aym, 1e-9f), 0.0f), 1.0f);
  if (EXP_ONE) return axm * fmaxf(1.0f - frac, 0.0f);
  const float radicand = 1.0f - powf(frac, p.exp);
  return axm * powf(fmaxf(radicand, 0.0f), p.inv_exp);
}

__device__ __forceinline__ float interp_machines(float v,
                                                 const float* __restrict__ m,
                                                 const VelParams& p) {
  const int M = p.M;
  int i = 0;                                  // searchsorted(xp, v, right)
  while (i < M && m[2 * i] <= v) ++i;
  i = i < 1 ? 1 : (i > M - 1 ? M - 1 : i);
  const float x0 = m[2 * (i - 1)], f0 = m[2 * (i - 1) + 1];
  const float df = m[2 * i + 1] - f0;
  const float dx = m[2 * i] - x0;
  const float delta = v - x0;
  const bool dx0 = fabsf(dx) <= p.interp_eps;
  float f = dx0 ? f0 : f0 + (delta / (dx0 ? 1.0f : dx)) * df;
  if (v < m[0]) f = m[1];
  if (v > m[2 * (M - 1)]) f = m[2 * (M - 1) + 1];
  return f;
}

template <bool CONST_GG, bool EXP_ONE>
__global__ void vel_scan_kernel(
    const float* __restrict__ k1, const float* __restrict__ a1,
    const float* __restrict__ y1, const float* __restrict__ k2,
    const float* __restrict__ a2, const float* __restrict__ y2,
    const float* __restrict__ ds, const float* __restrict__ v_lim,
    const float* __restrict__ v_init, const int* __restrict__ mode,
    const float* __restrict__ machines, float* __restrict__ out, int R,
    int T, VelParams p) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long base = (long long)r * T;
  float* o = out + (long long)r * (T + 1);
  const int md = mode[r];
  float v = v_init[r];
  o[0] = v;
  for (int t = 0; t < T; ++t) {
    const long long i = base + t;
    const float axm1 = CONST_GG ? p.gg_ax : a1[i];
    const float aym1 = CONST_GG ? p.gg_ay : y1[i];
    const float d = ds[i];
    const float a_t = ax_tires<EXP_ONE>(v, k1[i], axm1, aym1, p);
    const float drag = v * v * p.drag_coeff / p.m_veh;
    if (md == 0) {                                   // FWD
      const float a_m = interp_machines(v, machines, p);
      const float acc = fminf(a_t, a_m) - drag;
      v = fminf(sqrtf(fmaxf(v * v + 2.0f * acc * d, 0.0f)), v_lim[i]);
    } else if (md == 1) {                            // BRAKE
      const float dec = a_t + drag;
      v = sqrtf(fmaxf(v * v - 2.0f * dec * d, 0.0f));
    } else {                                         // BWD
      const float dec = a_t + drag;
      const float v_est = sqrtf(v * v + 2.0f * dec * d);
      const float axm2 = CONST_GG ? p.gg_ax : a2[i];
      const float aym2 = CONST_GG ? p.gg_ay : y2[i];
      const float a_t2 = ax_tires<EXP_ONE>(v_est, k2[i], axm2, aym2, p);
      const float dec2 = a_t2 + v_est * v_est * p.drag_coeff / p.m_veh;
      v = fminf(sqrtf(fmaxf(v * v + 2.0f * fminf(dec, dec2) * d, 0.0f)),
                v_lim[i]);
    }
    o[t + 1] = v;
  }
}

template <bool CONST_GG, bool EXP_ONE>
static void launch(const float* k1, const float* a1, const float* y1,
                   const float* k2, const float* a2, const float* y2,
                   const float* ds, const float* v_lim, const float* v_init,
                   const int* mode, const float* machines, float* out, int R,
                   int T, VelParams p, cudaStream_t s) {
  // small blocks spread the few thousand rows over all SMs
  const int threads = 32;
  const int blocks = (R + threads - 1) / threads;
  vel_scan_kernel<CONST_GG, EXP_ONE><<<blocks, threads, 0, s>>>(
      k1, a1, y1, k2, a2, y2, ds, v_lim, v_init, mode, machines, out, R, T,
      p);
}

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
    if (exp_one)
      launch<true, true>(k1, a1, y1, k2, a2, y2, ds, v_lim, v_init, mode,
                         machines, out, R, T, p, s);
    else
      launch<true, false>(k1, a1, y1, k2, a2, y2, ds, v_lim, v_init, mode,
                          machines, out, R, T, p, s);
  } else {
    if (exp_one)
      launch<false, true>(k1, a1, y1, k2, a2, y2, ds, v_lim, v_init, mode,
                          machines, out, R, T, p, s);
    else
      launch<false, false>(k1, a1, y1, k2, a2, y2, ds, v_lim, v_init, mode,
                           machines, out, R, T, p, s);
  }
  return (int)cudaGetLastError();
}
