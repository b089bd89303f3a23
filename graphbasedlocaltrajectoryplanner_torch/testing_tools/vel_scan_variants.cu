// Measurement variants of the stacked velocity recurrences (where does the
// time of a step go?) and the check of csrc/ieee_fast.cuh against the plain
// operators.  Built and timed by testing_tools/vel_scan_variants.py
// beside the kernel in csrc/vel_scan.cu; nothing in the package calls them.
// All compute ops/velocity.stacked_vel_scan for dyn_model_exp == 1.
//
//   0  baseline: one thread per row in the caller's order, 32-thread
//      blocks, every load strided and inside the loop that carries v, the
//      mode tested per lane at every step (the design csrc/vel_scan.cu had
//      before its shared-memory ring);
//   1  the baseline with thread i on row perm[i], perm sorting the rows by
//      mode: warps run one mode, loads as before;
//   2  a warp on 32 consecutive rows, inputs staged through a shared-memory
//      ring by 4-byte cp.async two chunks ahead, arithmetic, per-lane mode
//      test and strided output of the baseline: loads off the chain, modes
//      still mixed;
//   3  arithmetic alone: rows regrouped as in 1, each row's inputs read
//      once before the loop (its step 0) and held in registers, only the
//      last v written: the chain of T dependent steps and nothing else;
//   4  variant 3 with the zero guards of csrc/vel_scan.cu around every
//      division and square root (a zero operand sends div.rn and sqrt.rn
//      down their slow path; the guards give the same bits without it);
//   5-7  the step of csrc/vel_scan.cu itself (branch-free arithmetic, the
//      machine table's interval in registers) alone, for calls whose rows
//      all run mode 0, 1 or 2: inputs of step 0 in registers, only the last
//      v written.  T times its step is the least a launch of that mode can
//      take.
#include <cuda_runtime.h>
#include <math.h>

#include "../csrc/ieee_fast.cuh"

namespace shipped {            // the kernel's own step, for variants 5-7
#include "../csrc/vel_scan.cu"
}

namespace {

// ---- csrc/ieee_fast.cuh against the plain operators, bit for bit ---------
__device__ __forceinline__ unsigned mix(unsigned long long i, unsigned salt) {
  unsigned long long z = (i + salt) * 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return (unsigned)(z ^ (z >> 31));
}

// kind 0: the root of every float32.  kind 1: every float32 over y_fixed.
// kind 2: 2^32 pairs of random bits.  kind 3: 2^32 pairs of random sign and
// mantissa with exponents drawn from the accepted window, its edges
// included.  res[0] counts operands the fast function accepted (ok stayed
// set), res[1] those of them whose bits differ from the plain operator's.
__global__ void check_ieee_fast_kernel(int kind, float y_fixed,
                                       unsigned long long* res) {
  unsigned long long accepted = 0, wrong = 0;
  const unsigned long long n = 1ull << 32;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x
                              + threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
    bool ok = true;
    float fast, plain;
    if (kind == 0) {
      const float x = __uint_as_float((unsigned)i);
      fast = ieee_fast::sqrt(x, ok);
      plain = sqrtf(x);
    } else {
      unsigned xb = kind == 1 ? (unsigned)i : mix(i, 1), yb = mix(i, 2);
      if (kind == 3) {        // exponents 67..187: 2^-60 .. 2^60
        xb = (xb & 0x807fffffu) | ((67u + mix(i, 3) % 121u) << 23);
        yb = (yb & 0x807fffffu) | ((67u + mix(i, 4) % 121u) << 23);
      }
      const float x = __uint_as_float(xb);
      const float y = kind == 1 ? y_fixed : __uint_as_float(yb);
      fast = ieee_fast::div(x, ieee_fast::make_recip(y), ok);
      plain = x / y;
    }
    if (ok) {
      ++accepted;
      wrong += __float_as_uint(fast) != __float_as_uint(plain);
    }
  }
  atomicAdd(res, accepted);
  atomicAdd(res + 1, wrong);
}

struct VelParams {
  float gg_ax, gg_ay, drag_coeff, m_veh, interp_eps;
  int M;
};

struct Args {
  const float *k1, *a1, *y1, *k2, *a2, *y2, *ds, *v_lim, *v_init;
  const int *mode, *perm;
  const float* machines;
  float* out;
  int R, T;
};

__device__ __forceinline__ float opaque(float x) {
  asm volatile("" : "+f"(x));
  return x;
}

template <bool G>
__device__ __forceinline__ float dv(float x, float y) {
  if (!G) return x / y;
  const bool z = x == 0.0f && y != 0.0f && fabsf(y) < INFINITY;
  const float q = opaque(z ? 1.0f : x) / y;
  return z ? x * y : q;
}

template <bool G>
__device__ __forceinline__ float sq(float x) {
  if (!G) return sqrtf(x);
  const bool z = x == 0.0f;
  const float r = sqrtf(opaque(z ? 1.0f : x));
  return z ? x : r;
}

template <bool G = false>
__device__ __forceinline__ float ax_tires(float v, float k_abs, float axm,
                                          float aym) {
  const float ay_used = v * v * k_abs;
  const float frac =
      fminf(fmaxf(dv<G>(ay_used, fmaxf(aym, 1e-9f)), 0.0f), 1.0f);
  return axm * fmaxf(1.0f - frac, 0.0f);
}

template <bool G = false>
__device__ __forceinline__ float interp_machines(float v,
                                                 const float* __restrict__ m,
                                                 const VelParams& p) {
  const int M = p.M;
  int i = 0;
  while (i < M && m[2 * i] <= v) ++i;
  i = i < 1 ? 1 : (i > M - 1 ? M - 1 : i);
  const float x0 = m[2 * (i - 1)], f0 = m[2 * (i - 1) + 1];
  const float df = m[2 * i + 1] - f0;
  const float dx = m[2 * i] - x0;
  const float delta = v - x0;
  const bool dx0 = fabsf(dx) <= p.interp_eps;
  float f = dx0 ? f0 : f0 + dv<G>(delta, dx0 ? 1.0f : dx) * df;
  if (v < m[0]) f = m[1];
  if (v > m[2 * (M - 1)]) f = m[2 * (M - 1) + 1];
  return f;
}

// one step of the baseline, the mode tested per lane
template <bool G = false>
__device__ __forceinline__ float step(float v, int md, float k1, float axm1,
                                      float aym1, float k2, float axm2,
                                      float aym2, float d, float vl,
                                      const float* machines,
                                      const VelParams& p) {
  const float a_t = ax_tires<G>(v, k1, axm1, aym1);
  const float drag = dv<G>(v * v * p.drag_coeff, p.m_veh);
  if (md == 0) {
    const float a_m = interp_machines<G>(v, machines, p);
    const float acc = fminf(a_t, a_m) - drag;
    return fminf(sq<G>(fmaxf(v * v + 2.0f * acc * d, 0.0f)), vl);
  } else if (md == 1) {
    const float dec = a_t + drag;
    return sq<G>(fmaxf(v * v - 2.0f * dec * d, 0.0f));
  }
  const float dec = a_t + drag;
  const float v_est = sq<G>(v * v + 2.0f * dec * d);
  const float a_t2 = ax_tires<G>(v_est, k2, axm2, aym2);
  const float dec2 = a_t2 + dv<G>(v_est * v_est * p.drag_coeff, p.m_veh);
  return fminf(sq<G>(fmaxf(v * v + 2.0f * fminf(dec, dec2) * d, 0.0f)), vl);
}

// variants 0, 1 (perm != null), 3 (CONST_IN) and 4 (CONST_IN, G)
template <bool CGG, bool CONST_IN, bool G = false>
__global__ void per_row_kernel(Args a, VelParams p) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= a.R) return;
  const int r = a.perm ? a.perm[tid] : tid;
  const int T = a.T;
  const long long base = (long long)r * T;
  float* o = a.out + (long long)r * (T + 1);
  const int md = a.mode[r];
  float v = a.v_init[r];
  o[0] = v;
  if (CONST_IN) {
    const float k1 = a.k1[base], k2 = a.k2[base], d = a.ds[base];
    const float vl = a.v_lim[base];
    const float a1 = CGG ? p.gg_ax : a.a1[base];
    const float y1 = CGG ? p.gg_ay : a.y1[base];
    const float a2 = CGG ? p.gg_ax : a.a2[base];
    const float y2 = CGG ? p.gg_ay : a.y2[base];
    for (int t = 0; t < T; ++t)
      v = step<G>(v, md, k1, a1, y1, k2, a2, y2, d, vl, a.machines, p);
    o[T] = v;
    return;
  }
  for (int t = 0; t < T; ++t) {
    const long long i = base + t;
    const float axm1 = CGG ? p.gg_ax : a.a1[i];
    const float aym1 = CGG ? p.gg_ay : a.y1[i];
    const float d = a.ds[i];
    const float a_t = ax_tires(v, a.k1[i], axm1, aym1);
    const float drag = v * v * p.drag_coeff / p.m_veh;
    if (md == 0) {                                   // FWD
      const float a_m = interp_machines(v, a.machines, p);
      const float acc = fminf(a_t, a_m) - drag;
      v = fminf(sqrtf(fmaxf(v * v + 2.0f * acc * d, 0.0f)), a.v_lim[i]);
    } else if (md == 1) {                            // BRAKE
      const float dec = a_t + drag;
      v = sqrtf(fmaxf(v * v - 2.0f * dec * d, 0.0f));
    } else {                                         // BWD
      const float dec = a_t + drag;
      const float v_est = sqrtf(v * v + 2.0f * dec * d);
      const float axm2 = CGG ? p.gg_ax : a.a2[i];
      const float aym2 = CGG ? p.gg_ay : a.y2[i];
      const float a_t2 = ax_tires(v_est, a.k2[i], axm2, aym2);
      const float dec2 = a_t2 + v_est * v_est * p.drag_coeff / p.m_veh;
      v = fminf(sqrtf(fmaxf(v * v + 2.0f * fminf(dec, dec2) * d, 0.0f)),
                a.v_lim[i]);
    }
    o[t + 1] = v;
  }
}

constexpr int CH = 16, PITCH = CH + 1, STAGES = 3, TILE = 32 * PITCH;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// variant 2: one warp per block on rows 32*blockIdx.x ..., all streams staged
template <bool CGG>
__global__ void __launch_bounds__(32) staged_mixed_kernel(Args a,
                                                          VelParams p) {
  constexpr int NS = CGG ? 4 : 8;
  extern __shared__ __align__(16) float ring[];
  const float* src[8] = {a.k1, a.ds, a.v_lim, a.k2, a.a1, a.y1, a.a2, a.y2};
  const int lane = threadIdx.x, r0 = blockIdx.x * 32, T = a.T;
  const int nrows = min(32, a.R - r0);
  const int r = r0 + (lane < nrows ? lane : 0);
  const int half = lane >> 4, l = lane & (CH - 1);
  const int md = a.mode[r];
  float v = a.v_init[r];
  float* o = a.out + (long long)r * (T + 1);
  if (lane < nrows) o[0] = v;

  auto stage_chunk = [&](int c) {
    const int t = c * CH + l;
    float* dst = ring + (c % STAGES) * NS * TILE + l;
    if (t < T) {
      for (int i = half; i < nrows; i += 2) {
        const size_t g = (size_t)(r0 + i) * T + t;
#pragma unroll
        for (int q = 0; q < NS; ++q)
          cp_async4(dst + q * TILE + i * PITCH, src[q] + g);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int nchunks = (T + CH - 1) / CH;
  stage_chunk(0);
  stage_chunk(1);
  for (int c = 0; c < nchunks; ++c) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    stage_chunk(c + 2);
    const float* st = ring + (c % STAGES) * NS * TILE
                      + (lane < nrows ? lane : 0) * PITCH;
    const int n = min(CH, T - c * CH);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (j < n) {
        v = step(v, md, st[j], CGG ? p.gg_ax : st[4 * TILE + j],
                 CGG ? p.gg_ay : st[5 * TILE + j], st[3 * TILE + j],
                 CGG ? p.gg_ax : st[6 * TILE + j],
                 CGG ? p.gg_ay : st[7 * TILE + j], st[TILE + j],
                 st[2 * TILE + j], a.machines, p);
        if (lane < nrows) o[c * CH + j + 1] = v;
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// variants 5-7: one warp per 32 rows, all of mode MODE
template <bool CGG, int MODE>
__global__ void __launch_bounds__(32) shipped_step_kernel(
    shipped::Streams in, const float* v_init, const float* machines,
    float* out, int R, int T, shipped::VelParams p) {
  using namespace shipped;
  extern __shared__ __align__(16) float sm[];
  constexpr int NS = nstreams(CGG, MODE);
  const int lane = threadIdx.x;
  const int r = min((int)blockIdx.x * 32 + lane, R - 1);
  for (int q = 0; q < NS; ++q)
    sm[q * shipped::TILE + lane * shipped::PITCH] = in.p[q][(size_t)r * T];
  __syncwarp();
  const Machines mach = MODE == FWD ? setup_machines(machines, p, lane,
                                                     sm + 8 * shipped::TILE)
                                    : Machines{};
  const Consts c = make_consts(p);
  StepIn<CGG, MODE> s;
  s.load(sm + lane * shipped::PITCH, c);
  float v = v_init[r];
  Interval iv{};
  if (MODE == FWD) iv = load_interval(knot_index<false>(v, mach), mach);
  if (p.M <= 4)
    for (int t = 0; t < T; ++t)
      v = shipped::step<CGG, true, MODE, true>(v, s, mach, iv, c);
  else
    for (int t = 0; t < T; ++t)
      v = shipped::step<CGG, true, MODE, false>(v, s, mach, iv, c);
  if (blockIdx.x * 32 + lane < R) out[(size_t)r * (T + 1) + T] = v;
}

template <bool CGG, int MODE>
void launch_shipped_step(const shipped::Streams& in, const float* v_init,
                         const float* machines, float* out, int R, int T,
                         const shipped::VelParams& p, cudaStream_t s) {
  const size_t smem = (size_t)8 * shipped::TILE * 4 + ((p.M + 3) & ~3) * 4
                      + (size_t)(p.M - 1) * 32;
  shipped_step_kernel<CGG, MODE><<<(R + 31) / 32, 32, smem, s>>>(
      in, v_init, machines, out, R, T, p);
}

}  // namespace

extern "C" int check_ieee_fast(int kind, float y_fixed,
                               unsigned long long* res, void* stream) {
  check_ieee_fast_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      kind, y_fixed, res);
  return (int)cudaGetLastError();
}

extern "C" int vel_variant_launch(
    int variant, const float* k1, const float* a1, const float* y1,
    const float* k2, const float* a2, const float* y2, const float* ds,
    const float* v_lim, const float* v_init, const int* mode, const int* perm,
    const float* machines, int M, float* out, int R, int T, int const_gg,
    float gg_ax, float gg_ay, float drag_coeff, float m_veh,
    float interp_eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (variant >= 5) {
    const shipped::VelParams sp{gg_ax, gg_ay, 1.0f, 1.0f, drag_coeff, m_veh,
                                interp_eps, M};
    const int m = variant - 5;
    if (const_gg) {
      const shipped::Streams in{{k1, ds, v_lim, k2}};
      if (m == 0) launch_shipped_step<true, 0>(in, v_init, machines, out, R, T, sp, s);
      else if (m == 1) launch_shipped_step<true, 1>(in, v_init, machines, out, R, T, sp, s);
      else launch_shipped_step<true, 2>(in, v_init, machines, out, R, T, sp, s);
    } else {
      const shipped::Streams in{{k1, ds, a1, y1, v_lim, k2, a2, y2}};
      if (m == 0) launch_shipped_step<false, 0>(in, v_init, machines, out, R, T, sp, s);
      else if (m == 1) launch_shipped_step<false, 1>(in, v_init, machines, out, R, T, sp, s);
      else launch_shipped_step<false, 2>(in, v_init, machines, out, R, T, sp, s);
    }
    return (int)cudaGetLastError();
  }
  VelParams p{gg_ax, gg_ay, drag_coeff, m_veh, interp_eps, M};
  Args a{k1, a1, y1, k2, a2, y2, ds, v_lim, v_init, mode,
         (variant == 1 || variant >= 3) ? perm : nullptr, machines, out, R, T};
  const int blocks = (R + 31) / 32;
  if (variant == 2) {
    const size_t smem = (size_t)(const_gg ? 4 : 8) * STAGES * TILE * 4;
    if (const_gg) {
      cudaFuncSetAttribute(staged_mixed_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
      staged_mixed_kernel<true><<<blocks, 32, smem, s>>>(a, p);
    } else {
      cudaFuncSetAttribute(staged_mixed_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
      staged_mixed_kernel<false><<<blocks, 32, smem, s>>>(a, p);
    }
  } else if (variant == 4) {
    if (const_gg) per_row_kernel<true, true, true><<<blocks, 32, 0, s>>>(a, p);
    else per_row_kernel<false, true, true><<<blocks, 32, 0, s>>>(a, p);
  } else if (variant == 3) {
    if (const_gg) per_row_kernel<true, true><<<blocks, 32, 0, s>>>(a, p);
    else per_row_kernel<false, true><<<blocks, 32, 0, s>>>(a, p);
  } else {
    if (const_gg) per_row_kernel<true, false><<<blocks, 32, 0, s>>>(a, p);
    else per_row_kernel<false, false><<<blocks, 32, 0, s>>>(a, p);
  }
  return (int)cudaGetLastError();
}
