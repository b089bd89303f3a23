// Arc-length projections of the fleet tick: positions onto a polyline,
// the continuous s coordinate and the enclosing vertex indices.
//
// No TPU kernel: the JAX package leaves get_s_coord to XLA
// (graphbasedlocaltrajectoryplanner_tpu/ops/projection.py).  Semantics of
// ops/projection.get_s_coord (s_array given, no valid mask), bit for bit,
// for each query position q:
//   * the closest vertex nb: squared distance (dx*dx) + (dy*dy), the first
//     index on ties, a NaN distance wins at its first index (torch.argmin);
//   * its neighbours wrapped (closed) or clamped (open);
//   * the angles turning from nb to each neighbour around q, atan2f minus
//     atan2f, wrapped to (-pi, pi] with pi rounded to float, their
//     magnitudes ang1 and ang2;
//   * the foot point on the segment (prev, nb) where ang1 > ang2, else on
//     (nb, next): t = (d0*ab0 + d1*ab1) / max(|ab|^2, 1e-12), foot = a + t*ab,
//     s = s_array[a] + |foot - a|;
//   * (idx_a, idx_b) = (prev, nb) where ang1 >= ang2, else (nb, next).
// Every product and sum rounds on its own in the order of the torch
// expression (built with -fmad=false, no fast math); the one division and
// the square root are the correctly rounded operators, as PyTorch's.
//
// A launch takes up to MAX_SETS query sets over one polyline argument.  A
// polyline shared by every query (line_sr == 0) is staged once a block in
// shared memory; one a row (line_sr != 0, a query of every set a row) is
// read in place through the caller's row and element strides (the follow
// path's x, y of the spliced 20-byte path rows, its s of the four slots'
// arc lengths), no copy.  A warp takes item i: query i of every set that
// has one; its lanes scan the vertices i = lane, lane + 32, ... keeping the
// closest for each set, a butterfly of shuffles finds the warp's, and lane
// k computes set k's tail.  The work is latency-bound: a fleet tick's three
// launches read a few MB.
#include <cuda_runtime.h>
#include <math.h>

namespace proj {

constexpr int MAX_SETS = 3;
constexpr int WARPS = 8;              // items a block
constexpr int MAX_STAGE = 4096;       // a shared polyline's vertices staged
constexpr unsigned FULL = 0xffffffffu;
constexpr float PI_F = (float)3.14159265358979323846;
constexpr float TWO_PI_F = (float)6.28318530717958647692;
constexpr float DENOM_MIN = (float)1e-12;

// ops/cuda_projection.ProjArgs, field for field.
struct Args {
  const float* line;          // vertex i of row r, coordinate c at
                              // line + r line_sr + i line_si + c line_sc
  const float* s;             // s + r s_sr + i s_si
  const float* pos[MAX_SETS]; // query q of a set, coordinate c at
                              // pos + q pos_sq + c pos_sc
  float* s_out[MAX_SETS];     // (count,) each
  long long* idx_a[MAX_SETS];
  long long* idx_b[MAX_SETS];
  long long line_sr, line_si, line_sc, s_sr, s_si;
  long long pos_sq[MAX_SETS];
  long long pos_sc[MAX_SETS];
  long long count[MAX_SETS];  // queries of each set
  long long items;            // the largest count
  int n;                      // vertices of the polyline
  int closed;
  int sets;
};

// torch.clamp(min=): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// ops/projection._angle3pt(a, b, c), the magnitude
__device__ __forceinline__ float angle3(float ax, float ay, float bx,
                                       float by, float cx, float cy) {
  float ang = atan2f(cy - by, cx - bx) - atan2f(ay - by, ax - bx);
  ang = ang > PI_F ? ang - TWO_PI_F
                   : (ang <= -PI_F ? ang + TWO_PI_F : ang);
  return fabsf(ang);
}

// Whether (d2, i2) comes before (d1, i1) in torch.argmin's order; i < 0 is
// no candidate.
__device__ __forceinline__ bool before(float d2, int i2, float d1, int i1) {
  if (i2 < 0) return false;
  if (i1 < 0) return true;
  if (isnan(d2)) return !isnan(d1) || i2 < i1;
  if (isnan(d1)) return false;
  return d2 < d1 || (d2 == d1 && i2 < i1);
}

__global__ void __launch_bounds__(WARPS * 32)
projection_kernel(const Args a, int stage) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = a.n;
  const long long item = (long long)blockIdx.x * WARPS + warp;

  // the polyline's x, y and s: staged, or in place at the item's row
  const float *X, *Y, *S;
  long long xs, ss;
  if (stage) {
    float* sx = smem;
    float* sy = smem + n;
    float* sv = smem + 2 * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float* v = a.line + i * a.line_si;
      sx[i] = v[0];
      sy[i] = v[a.line_sc];
      sv[i] = a.s[i * a.s_si];
    }
    __syncthreads();
    X = sx;
    Y = sy;
    S = sv;
    xs = ss = 1;
  } else {
    X = a.line + item * a.line_sr;
    Y = X + a.line_sc;
    S = a.s + item * a.s_sr;
    xs = a.line_si;
    ss = a.s_si;
  }
  if (item >= a.items) return;        // the whole warp, after the staging

  float qx[MAX_SETS], qy[MAX_SETS], best[MAX_SETS];
  int bi[MAX_SETS];
  bool on[MAX_SETS];
#pragma unroll
  for (int k = 0; k < MAX_SETS; ++k) {
    on[k] = k < a.sets && item < a.count[k];
    qx[k] = qy[k] = best[k] = 0.0f;
    bi[k] = -1;
    if (on[k]) {
      const float* p = a.pos[k] + item * a.pos_sq[k];
      qx[k] = p[0];
      qy[k] = p[a.pos_sc[k]];
    }
  }
  // each lane's closest vertex over ascending indices
  for (int i = lane; i < n; i += 32) {
    const float x = X[i * xs];
    const float y = Y[i * xs];
#pragma unroll
    for (int k = 0; k < MAX_SETS; ++k) {
      if (!on[k]) continue;
      const float dx = x - qx[k];
      const float dy = y - qy[k];
      const float d = dx * dx + dy * dy;
      if (before(d, i, best[k], bi[k])) {
        best[k] = d;
        bi[k] = i;
      }
    }
  }
  // the warp's, in every lane
#pragma unroll
  for (int k = 0; k < MAX_SETS; ++k) {
    if (!on[k]) continue;            // warp-uniform
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      const float d = __shfl_xor_sync(FULL, best[k], m);
      const int i = __shfl_xor_sync(FULL, bi[k], m);
      if (before(d, i, best[k], bi[k])) {
        best[k] = d;
        bi[k] = i;
      }
    }
  }
  // lane k: set k's tail
  int nb = 0;
  float px = 0.0f, py = 0.0f;
  float* s_out = nullptr;
  long long *out_a = nullptr, *out_b = nullptr;
#pragma unroll
  for (int k = 0; k < MAX_SETS; ++k) {
    if (lane == k && on[k]) {
      nb = bi[k];
      px = qx[k];
      py = qy[k];
      s_out = a.s_out[k];
      out_a = a.idx_a[k];
      out_b = a.idx_b[k];
    }
  }
  if (s_out == nullptr) return;
  int i1, i2;
  if (a.closed) {
    i1 = nb == 0 ? n - 1 : nb - 1;
    i2 = nb == n - 1 ? 0 : nb + 1;
  } else {
    i1 = nb > 0 ? nb - 1 : 0;
    i2 = nb < n - 1 ? nb + 1 : n - 1;
  }
  const float nx = X[nb * xs], ny = Y[nb * xs];
  const float ang1 = angle3(nx, ny, px, py, X[i1 * xs], Y[i1 * xs]);
  const float ang2 = angle3(nx, ny, px, py, X[i2 * xs], Y[i2 * xs]);
  const bool use_prev = ang1 > ang2;
  const int ia = use_prev ? i1 : nb;
  const int ib = use_prev ? nb : i2;
  const float ax = X[ia * xs], ay = Y[ia * xs];
  const float ab0 = X[ib * xs] - ax;
  const float ab1 = Y[ib * xs] - ay;
  const float denom = clamp_min(ab0 * ab0 + ab1 * ab1, DENOM_MIN);
  const float d0 = px - ax;
  const float d1 = py - ay;
  const float t = (d0 * ab0 + d1 * ab1) / denom;
  const float f0 = ax + t * ab0;
  const float f1 = ay + t * ab1;
  const float fa0 = f0 - ax;
  const float fa1 = f1 - ay;
  const float ds = sqrtf(fa0 * fa0 + fa1 * fa1);
  const bool ge = ang1 >= ang2;
  s_out[item] = S[ia * ss] + ds;
  out_a[item] = ge ? i1 : nb;
  out_b[item] = ge ? nb : i2;
}

static int launch(const Args& a, cudaStream_t stream) {
  if (a.n < 1 || a.sets < 1 || a.sets > MAX_SETS || a.items < 0) return -1;
  for (int k = 0; k < a.sets; ++k)
    if (a.count[k] < 0 || a.count[k] > a.items) return -1;
  if (a.items == 0) return 0;
  const int stage = a.line_sr == 0 && a.s_sr == 0 && a.n <= MAX_STAGE;
  const size_t bytes = stage ? (size_t)3 * a.n * sizeof(float) : 0;
  const long long blocks = (a.items + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return -1;
  projection_kernel<<<(unsigned)blocks, WARPS * 32, bytes, stream>>>(a,
                                                                     stage);
  return (int)cudaGetLastError();
}

}  // namespace proj

extern "C" int projection_launch(const proj::Args* a, void* stream) {
  return proj::launch(*a, (cudaStream_t)stream);
}
