// Path assembly for the batched fleet tick and the interactive facade: the
// C2 refit of each row's node chain and its resampling, in one launch.
//
// No TPU kernel: the JAX package runs planner/pathgen.assemble_action_kernel
// in XLA.  Semantics of ops/cuda_assemble.assemble_path_plain, bit for bit,
// per row r with horizon h = h_eff[r]:
//   * edge j of the chain, j = 0..H, is packed[win[j], n_j, n_min(j+1,H)]
//     (nodes clamped to [0, N)): [npts, len, a0x a0y a1x a1y a2x a2y a3x a3y];
//     edges j >= h count 1 point and length 1;
//   * node_idx = exclusive running sum of npts - 1, n_valid = node_idx[h] + 1;
//   * the clamped C2 fit through the edges' start points (those past h on
//     the point at h), chord lengths the stored lengths, start heading
//     psi_s, end heading the analytic heading of edge h - 1 at t = 1;
//     equations from h - 1 on pinned to the end heading; one Thomas sweep
//     in the order of ops/splines._thomas;
//   * point i lies on segment min(#{j >= 1: node_idx[j] <= i}, H - 1), at
//     t = clamp((i - node_idx[seg]) / max(npts[seg] - 1, 1), 0, 1): x, y,
//     heading, curvature of the refit, element length of the stored edge
//     between t and the next point's t; from point n_valid - 1 on, the
//     refit's last real segment at t = 1 and element length 0.
//
// The plain formulation is about 455 kernels at the fleet's 4,096 rows (a
// Thomas sweep of 26 steps of small kernels, a (R, p_max, H) comparison to
// find each point's segment, a gather of 18 floats a point, some 60
// elementwise passes).  Here a warp takes a row, four rows a block: the
// lanes gather the row's H + 1 edges into shared memory, one lane runs the
// sweep for x and another for y, and all lanes then resample 32 points at
// a time and store them through shared memory, so that a warp's stores are
// contiguous.  The bound is the 35 MB of outputs a fleet tick writes.
//
// Rounding: every operation rounds on its own as in the plain version's
// elementwise kernels (built with -fmad=false, no fast math), in the plain
// version's order; remainder, atan2, pow, sin and cos are PyTorch's own
// formulas for float32 on the card (fmodf with its sign fix, atan2f, powf,
// sinf, cosf), constants are Python's doubles rounded to float.  The index
// tensors are read as the caller has them, int32 or int64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace asmb {

constexpr int WARPS = 4;        // rows a block
constexpr int NE = 10;          // floats a packed edge entry
constexpr float PI_F = (float)3.141592653589793;
constexpr float TWO_PI_F = (float)(2.0 * 3.141592653589793);
constexpr float HALF_PI_F = (float)(3.141592653589793 / 2.0);
constexpr float EPS_LEN = (float)1e-9;
constexpr float EPS_CURV = (float)1e-12;

// An index tensor as the caller has it, int32 or int64.
struct Ints {
  const void* p;
  int wide;         // 1: int64
  __device__ __forceinline__ long long operator[](long long i) const {
    return wide ? static_cast<const long long*>(p)[i]
                : (long long)static_cast<const int*>(p)[i];
  }
};

struct Args {
  const float* packed;      // (L, N, N, 10)
  Ints win, nodes, h_eff;   // (R / k, H+1), (R, H+1), (R,)
  const float* psi_s;       // (R,)
  float* path;              // (R, P, 5)
  long long* n_valid;       // (R,)
  int* node_idx;            // (R, H+1)
  float* coeffs;            // (R, H, 8)
  int R, k, H, L, N, P;
};

// torch.clamp(v, min=lo) and torch.clamp(v, lo, hi) on a float: NaN passes.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// ops/heading.dir_to_heading: normalize_psi(atan2(dy, dx) - pi / 2), the
// wrap torch.remainder(psi + pi, 2 pi) - pi.
__device__ __forceinline__ float heading(float dx, float dy) {
  const float a = (atan2f(dy, dx) - HALF_PI_F) + PI_F;
  float mod = fmodf(a, TWO_PI_F);
  if (mod != 0.0f && ((TWO_PI_F < 0.0f) != (mod < 0.0f))) mod += TWO_PI_F;
  return mod - PI_F;
}

// ops/splines.head_curv_an at t = 1 of one cubic: x's coefficient k at
// a[k * st], y's at b[k * st].  Heading and curvature.
__device__ __forceinline__ void head_curv_t1(const float* a, const float* b,
                                             int st, float* psi,
                                             float* kappa) {
  const float dx = a[st] + (2.0f * a[2 * st] + 3.0f * a[3 * st]);
  const float dy = b[st] + (2.0f * b[2 * st] + 3.0f * b[3 * st]);
  const float ddx = 2.0f * a[2 * st] + 6.0f * a[3 * st];
  const float ddy = 2.0f * b[2 * st] + 6.0f * b[3 * st];
  *psi = heading(dx, dy);
  const float denom = powf(dx * dx + dy * dy, 1.5f);
  *kappa = (dx * ddy - dy * ddx) / clamp_min(denom, EPS_CURV);
}

// The warp's slice of shared memory, by H.
struct Smem {
  float* E;       // (H+1, 10) the chain's packed edges
  float* pos;     // (H+1, 2) fitted points
  float* sl;      // (H) clamped chord lengths
  float* dpl;     // (H, 2) chord over length
  float* lo;      // (H-1) the tridiagonal system
  float* di;
  float* up;
  float* rhs;     // (H-1, 2)
  float* cs;      // (H-1) the sweep's c and d
  float* ds;      // (H-1, 2)
  float* m;       // (H+1, 2) tangents
  float* coef;    // (H, 8) refit [x a0..a3, y a0..a3]
  float* stage;   // (32, 5) a chunk of points
  float* sc;      // m0 (2), mn (2), fin (5)
  int* nidx;      // (H+1) node_idx
  int* npts;      // (H) points a segment
};

__host__ __device__ inline int smem_floats(int H) {
  const int Hp1 = H + 1, n = H - 1;
  return Hp1 * NE + 2 * Hp1 + H + 2 * H + 5 * n + 3 * n + 2 * Hp1 + 8 * H +
         32 * 5 + 9;
}
__host__ __device__ inline int smem_words(int H) {
  return smem_floats(H) + (H + 1) + H;
}

__device__ inline Smem carve(float* base, int H) {
  const int Hp1 = H + 1, n = H - 1;
  Smem s;
  float* p = base;
  s.E = p; p += Hp1 * NE;
  s.pos = p; p += 2 * Hp1;
  s.sl = p; p += H;
  s.dpl = p; p += 2 * H;
  s.lo = p; p += n;
  s.di = p; p += n;
  s.up = p; p += n;
  s.rhs = p; p += 2 * n;
  s.cs = p; p += n;
  s.ds = p; p += 2 * n;
  s.m = p; p += 2 * Hp1;
  s.coef = p; p += 8 * H;
  s.stage = p; p += 32 * 5;
  s.sc = p; p += 9;
  s.nidx = reinterpret_cast<int*>(p);
  s.npts = s.nidx + Hp1;
  return s;
}

// One resampled point i of the row (i < n_valid - 1): [x y psi kappa el].
__device__ __forceinline__ void sample(const Smem& s, int H, int i,
                                       float* o) {
  int cnt = 0;
  for (int j = 1; j <= H; ++j) cnt += s.nidx[j] <= i;
  const int seg = min(max(cnt, 0), H - 1);
  // node_idx and npts pass through float32 in the plain version's table
  const long long start = (long long)(float)s.nidx[seg];
  const long long np = (long long)(float)s.npts[seg];
  const float within = (float)((long long)i - start);
  const float den = (float)(np - 1 > 1 ? np - 1 : 1);
  const float t = clamp01(within / den);
  const float* c = s.coef + seg * 8;          // x a0..a3, y a0..a3
  const float ax0 = c[0], ax1 = c[1], ax2 = c[2], ax3 = c[3];
  const float ay0 = c[4], ay1 = c[5], ay2 = c[6], ay3 = c[7];
  o[0] = ax0 + t * (ax1 + t * (ax2 + t * ax3));
  o[1] = ay0 + t * (ay1 + t * (ay2 + t * ay3));
  const float dx = ax1 + t * (2.0f * ax2 + (t * 3.0f) * ax3);
  const float dy = ay1 + t * (2.0f * ay2 + (t * 3.0f) * ay3);
  const float ddx = 2.0f * ax2 + (t * 6.0f) * ax3;
  const float ddy = 2.0f * ay2 + (t * 6.0f) * ay3;
  o[2] = heading(dx, dy);
  const float denom = powf(dx * dx + dy * dy, 1.5f);
  o[3] = (dx * ddy - dy * ddx) / clamp_min(denom, EPS_CURV);
  const float t2 = clamp01((within + 1.0f) / den);
  const float* e = s.E + seg * NE + 2;        // x0 y0 x1 y1 x2 y2 x3 y3
  const float dxe = (e[0] + t2 * (e[2] + t2 * (e[4] + t2 * e[6]))) -
                    (e[0] + t * (e[2] + t * (e[4] + t * e[6])));
  const float dye = (e[1] + t2 * (e[3] + t2 * (e[5] + t2 * e[7]))) -
                    (e[1] + t * (e[3] + t * (e[5] + t * e[7])));
  o[4] = sqrtf(dxe * dxe + dye * dye);
}

__global__ void __launch_bounds__(WARPS * 32)
assemble_kernel(const Args a, int warps) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r = blockIdx.x * warps + w;
  if (r >= a.R) return;
  const int H = a.H, Hp1 = H + 1, n = H - 1;
  const Smem s = carve(smem + w * smem_words(H), H);

  long long hh = a.h_eff[r];
  const int h = (int)(hh < 0 ? 0 : (hh > H ? H : hh));
  // index h - 1 as the plain version's (h = 0 reads the last entry)
  const int he = h >= 1 ? h - 1 : H;        // of the H + 1 edges
  const int hc = h >= 1 ? h - 1 : H - 1;    // of the H segments

  // ---- the chain's edges ---------------------------------------------
  const long long nrow = (long long)r * Hp1;
  const long long wrow = (long long)(r / a.k) * Hp1;
  for (int j = lane; j < Hp1; j += 32) {
    long long n0 = a.nodes[nrow + j];
    long long n1 = a.nodes[nrow + min(j + 1, H)];
    n0 = n0 < 0 ? 0 : (n0 >= a.N ? a.N - 1 : n0);
    n1 = n1 < 0 ? 0 : (n1 >= a.N ? a.N - 1 : n1);
    long long wl = a.win[wrow + j];
    wl = wl < 0 ? 0 : (wl >= a.L ? a.L - 1 : wl);
    const float* e = a.packed + ((wl * a.N + n0) * a.N + n1) * NE;
    float* d = s.E + j * NE;
#pragma unroll
    for (int q = 0; q < NE; ++q) d[q] = e[q];
  }
  __syncwarp();

  // counts, lengths, points; the end and start tangents
  for (int j = lane; j < Hp1; j += 32) {
    if (j < H) {
      s.npts[j] = j < h ? (int)s.E[j * NE] : 1;
      s.sl[j] = clamp_min(j < h ? s.E[j * NE + 1] : 1.0f, EPS_LEN);
    }
    const int src = j > h ? h : j;
    s.pos[2 * j] = s.E[src * NE + 2];
    s.pos[2 * j + 1] = s.E[src * NE + 3];
  }
  if (lane == 0) {
    const float psi = a.psi_s[r];
    s.sc[0] = -sinf(psi);
    s.sc[1] = cosf(psi);
  } else if (lane == 1) {     // the end heading: edge h - 1 at t = 1
    const float* c = s.E + he * NE + 2;       // x0 y0 x1 y1 x2 y2 x3 y3
    float psi_e, kap;
    head_curv_t1(c, c + 1, 2, &psi_e, &kap);
    s.sc[2] = -sinf(psi_e);
    s.sc[3] = cosf(psi_e);
  }
  __syncwarp();
  if (lane == 2) {                  // the exclusive running sum
    int acc = 0;
    s.nidx[0] = 0;
    for (int j = 0; j < H; ++j) {
      acc += s.npts[j] - 1;
      s.nidx[j + 1] = acc;
    }
  }
  for (int j = lane; j < H; j += 32) {
    const float l = s.sl[j];
    s.dpl[2 * j] = (s.pos[2 * j + 2] - s.pos[2 * j]) / l;
    s.dpl[2 * j + 1] = (s.pos[2 * j + 3] - s.pos[2 * j + 1]) / l;
  }
  __syncwarp();

  // ---- the tridiagonal system (ops/cuda_assemble._fit_clamped_chain_padded)
  for (int i = lane; i < n; i += 32) {
    const float lam = s.sl[i] / s.sl[i + 1];
    float rx = 3.0f * (s.dpl[2 * i] + lam * s.dpl[2 * i + 2]);
    float ry = 3.0f * (s.dpl[2 * i + 1] + lam * s.dpl[2 * i + 3]);
    if (i == 0) {
      rx = rx + (-s.sc[0]);
      ry = ry + (-s.sc[1]);
    }
    float lo = i == 0 ? 0.0f : 1.0f, di = 2.0f * (1.0f + lam), up = lam;
    if (i >= h - 1) {
      lo = 0.0f;
      di = 1.0f;
      up = 0.0f;
      rx = s.sc[2];
      ry = s.sc[3];
    }
    s.lo[i] = lo;
    s.di[i] = di;
    s.up[i] = up;
    s.rhs[2 * i] = rx;
    s.rhs[2 * i + 1] = ry;
  }
  __syncwarp();

  // ---- the sweep: lane 0 for x, lane 1 for y (ops/splines._thomas) ----
  if (lane < 2) {
    const int c = lane;
    float c_prev = s.di[0] * 0.0f;
    float d_prev = s.rhs[c] * 0.0f;
    for (int i = 0; i < n; ++i) {
      const float lo = s.lo[i];
      const float denom = s.di[i] - lo * c_prev;
      c_prev = s.up[i] / denom;
      d_prev = (s.rhs[2 * i + c] - lo * d_prev) / denom;
      if (c == 0) s.cs[i] = c_prev;
      s.ds[2 * i + c] = d_prev;
    }
    __syncwarp(3u);
    float x = s.rhs[c] * 0.0f;
    for (int i = n - 1; i >= 0; --i) {
      x = s.ds[2 * i + c] - s.cs[i] * x;
      s.m[2 * (i + 1) + c] = i + 1 >= h ? s.sc[2 + c] : x;
    }
    s.m[c] = s.sc[c];
    s.m[2 * H + c] = s.sc[2 + c];
  }
  __syncwarp();

  // ---- Hermite coefficients (ops/splines._coeffs_from_tangents) -------
  for (int q = lane; q < 2 * H; q += 32) {
    const int j = q >> 1, c = q & 1;
    const float l = s.sl[j];
    const float p0 = s.pos[2 * j + c];
    const float dp = s.pos[2 * j + 2 + c] - p0;
    const float mL0 = s.m[2 * j + c] * l;
    const float mL1 = s.m[2 * j + 2 + c] * l;
    float* o = s.coef + j * 8 + c * 4;
    o[0] = p0;
    o[1] = mL0;
    o[2] = (3.0f * dp - 2.0f * mL0) - mL1;
    o[3] = (-2.0f * dp + mL0) + mL1;
  }
  __syncwarp();

  const long long nv = (long long)s.nidx[h] + 1;
  if (lane == 0) {
    // the final point: the refit's last real segment at t = 1
    const float* cx = s.coef + hc * 8;
    const float* cy = cx + 4;
    float psi_f, kappa_f;
    head_curv_t1(cx, cy, 1, &psi_f, &kappa_f);
    s.sc[4] = cx[0] + (cx[1] + (cx[2] + cx[3]));
    s.sc[5] = cy[0] + (cy[1] + (cy[2] + cy[3]));
    s.sc[6] = psi_f;
    s.sc[7] = kappa_f;
    s.sc[8] = 0.0f;
    a.n_valid[r] = nv;
  }
  for (int j = lane; j < Hp1; j += 32) a.node_idx[nrow + j] = s.nidx[j];
  float* co = a.coeffs + (long long)r * H * 8;
  for (int q = lane; q < H * 8; q += 32) co[q] = s.coef[q];
  __syncwarp();

  // ---- resampling, 32 points at a time --------------------------------
  float* out = a.path + (long long)r * a.P * 5;
  for (int base = 0; base < a.P; base += 32) {
    const int i = base + lane;
    float o[5];
    if (i < a.P) {
      if ((long long)i >= nv - 1) {
#pragma unroll
        for (int q = 0; q < 5; ++q) o[q] = s.sc[4 + q];
      } else {
        sample(s, H, i, o);
      }
#pragma unroll
      for (int q = 0; q < 5; ++q) s.stage[lane * 5 + q] = o[q];
    }
    __syncwarp();
    const int cnt = min(32, a.P - base) * 5;
    for (int q = lane; q < cnt; q += 32) out[base * 5 + q] = s.stage[q];
    __syncwarp();
  }
}

// Rows a block and the block's bytes of dynamic shared memory (0 rows: not
// even one row fits).
inline int block_rows(int H, size_t* bytes) {
  const size_t per_warp = (size_t)smem_words(H) * sizeof(float);
  const size_t limit = 227 * 1024;
  int warps = WARPS;
  while (warps > 1 && warps * per_warp > limit) --warps;
  *bytes = warps * per_warp;
  return *bytes <= limit ? warps : 0;
}

// Let the kernel take up to 227 KB of shared memory, once, at its first
// launch.  (static: the flag is this library's own.)
static int allow_smem(bool* done) {
  if (*done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      227 * 1024);
  *done = err == cudaSuccess;
  return (int)err;
}

static int launch(const Args& a, cudaStream_t stream) {
  if (a.R == 0) return 0;
  size_t bytes;
  const int warps = block_rows(a.H, &bytes);
  if (warps == 0 || a.H < 2) return -1;
  static bool ready = false;
  const int err = allow_smem(&ready);
  if (err) return err;
  assemble_kernel<<<(a.R + warps - 1) / warps, warps * 32, bytes, stream>>>(
      a, warps);
  return (int)cudaGetLastError();
}

}  // namespace asmb

// win, nodes, h_eff: int32 or int64 by bits 0, 1, 2 of wide; win holds
// R / k rows, row r reading row r / k.
extern "C" int assemble_launch(const float* packed, const void* win,
                               const void* nodes, const void* h_eff,
                               const float* psi_s, float* path,
                               long long* n_valid, int* node_idx,
                               float* coeffs, int R, int k, int H, int L,
                               int N, int P, int wide, void* stream) {
  const asmb::Args a{packed, asmb::Ints{win, wide & 1},
                     asmb::Ints{nodes, (wide >> 1) & 1},
                     asmb::Ints{h_eff, (wide >> 2) & 1}, psi_s, path,
                     n_valid, node_idx, coeffs, R, k, H, L, N, P};
  return asmb::launch(a, (cudaStream_t)stream);
}
