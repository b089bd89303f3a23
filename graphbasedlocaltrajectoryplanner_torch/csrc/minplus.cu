// Batched min-plus DP over a materialized window.
//
// Replaces the TPU kernel graphbasedlocaltrajectoryplanner_tpu/ops/
// pallas_minplus.py:_minplus_kernel (via minplus_scan_pallas).  Semantics
// of ops/search.minplus_scan, per row r: best[0] is 0 at start[r / ks] and
// INF elsewhere, bp[0] = -1, and for h = 0 .. H-1
//   best[h+1, m] = min(min_n best[h, n] + w[h, n, m], INF)
//   bp[h+1, m]   = argmin_n of the same sums, the lowest n on ties.
//
// Bound on the H100: bytes.  Each row reads its H * N * N window once
// (4 * H * N^2 bytes against 2 * H * N^2 flops), so the card must keep
// enough bytes in flight: 3.35 TB/s times about 1 us of latency, some
// 25 KB an SM.  The first design loaded step h's slab inside the chain,
// after step h-1, and moved the window at 48 % of HBM rate.
//
// Design: a warp per row, four rows a block (fewer where four rings do not
// fit, N > 84).  The warp streams its row's window through a ring of 3
// stages in shared memory, each stage the slabs (N * N floats) of 2
// consecutive steps, which arrive by one copy, two stages ahead of the
// relax:
//   * where a slab is a whole number of 16-byte units and the window is
//     16-byte aligned (even N), one lane issues one bulk copy a stage (the
//     TMA's 1D cp.async.bulk) that completes on the stage's mbarrier;
//   * otherwise (odd N, or a window not 16-byte aligned) every lane copies
//     its 4-byte elements by cp.async and arrives on the same mbarrier when
//     they have landed (cp.async.mbarrier.arrive.noinc).
//   Copies of 2 steps stream faster than copies of one (2,304 bytes at
//   N = 24); 3 stages of 2 leave room for 4 blocks an SM, whose 16 warps
//   hide the relax.  Deeper or wider rings cost blocks an SM (measured
//   on the H100); where N is so large that this ring does not fit, plan()
//   takes fewer steps and stages.
// The relax waits on the stage's barrier only: lane m owns target m (and
// m + 32, ...), reads its column of the slab conflict-free and the
// frontier from shared memory, 16 bytes at a time where N % 4 == 0, and
// keeps the lowest n on ties by a strict compare.  It is bound by issue
// slots, not by its chain of compares (four chains merged at the end were
// measured no faster).  A stage is refilled as soon as its last step is
// relaxed.
// The TPU's BLOCK_B row padding was a layout of that chip and is gone.
#include <cuda_runtime.h>
#include <stdint.h>

#define MP_INF 1e30f

namespace mp {

constexpr int WARPS = 4;        // rows a block
constexpr int MAX_STAGES = 4;   // barriers a warp has, for its stages
// The ring's shape where it fits: STAGES stages of STEPS steps' slabs
// each, one bulk copy a stage
constexpr int STEPS = 2;
constexpr int STAGES = 3;

// An index tensor as the caller has it, int32 or int64.
struct Ints {
  const void* p;
  int wide;         // 1: int64
  __device__ __forceinline__ int operator[](long long i) const {
    return wide ? (int)static_cast<const long long*>(p)[i]
                : static_cast<const int*>(p)[i];
  }
};

struct Args {
  const float* w;
  Ints start;
  float* best;
  int* bp;
  int R, H, N;
  int ks;           // rows that share one start node
  int warps;        // rows a block (1 .. WARPS)
  int stages;       // stages in a warp's ring (2 .. MAX_STAGES)
  int steps;        // steps' slabs a stage holds
  int pitch;        // floats a stage takes in the ring (multiple of 4)
  int fpitch;       // floats a frontier buffer takes (multiple of 4)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Bytes of the per-block shared memory that hold the warps' barriers.
constexpr int BAR_BYTES = WARPS * MAX_STAGES * 8;

// One warp's part of the block's shared memory.
struct Ring {
  uint64_t* bar;    // a barrier a stage
  float* slab;      // stages * pitch floats: a stage's slabs one after
                    // another, N * N floats each
  float* cur;       // frontier of step h
  float* nxt;       // frontier of step h + 1
};

__device__ __forceinline__ Ring ring_of(unsigned char* smem, const Args& a,
                                        int warp) {
  Ring g;
  g.bar = reinterpret_cast<uint64_t*>(smem) + warp * MAX_STAGES;
  g.slab = reinterpret_cast<float*>(smem + BAR_BYTES) +
           (long long)warp * (a.stages * a.pitch + 2 * a.fpitch);
  g.cur = g.slab + a.stages * a.pitch;
  g.nxt = g.cur + a.fpitch;
  return g;
}

// Barriers of the warp's ring: one arrival (the bulk copy's issuing lane,
// bytes counted by the copy) or 32 (every lane's cp.async).
template <bool BULK>
__device__ __forceinline__ void ring_init(const Ring& g, int stages,
                                          int lane) {
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) bar_init(g.bar + s, BULK ? 1 : 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
}

// Start the copy of a stage's slabs (nn floats at src) into stage s.
template <bool BULK>
__device__ __forceinline__ void ring_load(const Ring& g, const Args& a, int s,
                                          const float* src, int nn,
                                          int lane) {
  float* dst = g.slab + s * a.pitch;
  const uint32_t bar = smem_addr(g.bar + s);
  if (BULK) {
    if (lane == 0) {
      const uint32_t bytes = (uint32_t)nn * 4u;
      // the stage was last read by ordinary loads: order them before the
      // copy engine's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
          "l"(src), "r"(bytes), "r"(bar)
          : "memory");
    }
  } else {
    for (int i = lane; i < nn; i += 32)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       smem_addr(dst + i)),
                   "l"(src + i)
                   : "memory");
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                     bar)
                 : "memory");
  }
}

// Sources n .. n + 3 of target m into (bmin, bi), in order, the lowest n
// kept on ties by the strict compare; c = the frontier at n .. n + 3.
__device__ __forceinline__ void scan4(float4 c, const float* col, int N,
                                      int n, float& bmin, int& bi) {
  float t = c.x + col[0];
  if (t < bmin) { bmin = t; bi = n; }
  t = c.y + col[N];
  if (t < bmin) { bmin = t; bi = n + 1; }
  t = c.z + col[2 * N];
  if (t < bmin) { bmin = t; bi = n + 2; }
  t = c.w + col[3 * N];
  if (t < bmin) { bmin = t; bi = n + 3; }
}

// One relax step of the warp's row: frontier cur -> nxt and the step's row
// of best and bp in device memory.  The scan starts from +inf with source
// 0, which gives the first sum's place to the lowest n where all are +inf.
// VEC (N % 4 == 0): the frontier read 16 bytes at a time.
template <bool VEC>
__device__ __forceinline__ void relax(const float* __restrict__ slab,
                                      const float* __restrict__ cur,
                                      float* __restrict__ nxt, float* bo,
                                      int* po, int N, int lane) {
  for (int m = lane; m < N; m += 32) {
    float bmin = INFINITY;
    int bi = 0;
    if (VEC) {
#pragma unroll 2
      for (int n = 0; n < N; n += 4)
        scan4(*reinterpret_cast<const float4*>(cur + n), slab + n * N + m,
              N, n, bmin, bi);
    } else {
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float t = cur[n] + slab[n * N + m];
        if (t < bmin) { bmin = t; bi = n; }
      }
    }
    bmin = fminf(bmin, MP_INF);
    nxt[m] = bmin;
    bo[m] = bmin;
    po[m] = bi;
  }
}

template <bool BULK, bool VEC>
__global__ void __launch_bounds__(WARPS * 32) minplus_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * a.warps + warp;
  if (r >= a.R) return;     // no barrier of the block is shared
  Ring g = ring_of(smem, a, warp);
  const int N = a.N, NN = N * N;
  const int H = a.H, S = a.stages, K = a.steps;
  const int chunks = (H + K - 1) / K;   // stages' worth of steps
  const float* wr = a.w + (long long)r * H * NN;
  float* bo = a.best + (long long)r * (H + 1) * N;
  int* po = a.bp + (long long)r * (H + 1) * N;

  ring_init<BULK>(g, S, lane);
  for (int c = 0; c < S && c < chunks; ++c)
    ring_load<BULK>(g, a, c, wr + (long long)c * K * NN,
                    min(K, H - c * K) * NN, lane);

  const int st = a.start[r / a.ks];
  for (int m = lane; m < N; m += 32) {
    const float v0 = (m == st) ? 0.0f : MP_INF;
    g.cur[m] = v0;
    bo[m] = v0;
    po[m] = -1;
  }
  __syncwarp();

  int s = 0;
  uint32_t parity = 0;
  for (int c = 0; c < chunks; ++c) {
    bar_wait(g.bar + s, parity);
    const float* stage = g.slab + s * a.pitch;
    for (int j = 0, h = c * K; j < K && h < H; ++j, ++h) {
      relax<VEC>(stage + j * NN, g.cur, g.nxt, bo + (h + 1) * N,
                     po + (h + 1) * N, N, lane);
      __syncwarp();         // the slab is read, the new frontier written
      float* t = g.cur;
      g.cur = g.nxt;
      g.nxt = t;
    }
    if (c + S < chunks)
      ring_load<BULK>(g, a, s, wr + (long long)(c + S) * K * NN,
                      min(K, H - (c + S) * K) * NN, lane);
    if (++s == S) {
      s = 0;
      parity ^= 1u;
    }
  }
}

inline int round4(int x) { return (x + 3) & ~3; }

constexpr size_t SMEM_LIMIT = 227 * 1024;

// Block shared memory of a ring of `stages` stages of `steps` steps' slabs
// each at N for `warps` rows a block; fills in the ring's fields of a.
inline size_t ring_bytes(int N, int warps, int steps, int stages, Args* a) {
  a->fpitch = round4(N);
  a->pitch = round4(steps * N * N);
  a->warps = warps;
  a->steps = steps;
  a->stages = stages;
  return BAR_BYTES +
         (size_t)warps * (stages * a->pitch + 2 * a->fpitch) * sizeof(float);
}

// Steps a stage, ring depth, rows a block and block shared memory for N:
// the first that fits of up to STEPS steps a stage, up to STAGES stages,
// WARPS rows a block, each taken smaller in that order (at least 2
// stages; false if not even one row's ring of single steps fits).
inline bool plan(int N, Args* a, size_t* bytes) {
  for (int w = WARPS; w >= 1; --w)
    for (int k = STEPS; k >= 1; --k)
      for (int s = STAGES; s >= 2; --s)
        if ((*bytes = ring_bytes(N, w, k, s, a)) <= SMEM_LIMIT) return true;
  return false;
}

// Let a kernel take up to 227 KB of shared memory, and the SM give shared
// memory the largest share of its L1 (more rings an SM).  Once a kernel,
// at its first launch.
template <typename K>
inline int allow_smem(K kernel, bool* done) {
  if (*done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  *done = err == cudaSuccess;
  return (int)err;
}

// (static: the flag below is this library's own; a function-local static
// of an inline function is one object for every library in the process)
template <bool BULK, bool VEC>
static int launch_as(const Args& a, size_t bytes, cudaStream_t stream) {
  static bool ready = false;
  const int err = allow_smem(minplus_kernel<BULK, VEC>, &ready);
  if (err) return err;
  minplus_kernel<BULK, VEC>
      <<<(a.R + a.warps - 1) / a.warps, a.warps * 32, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// Whether the bulk copy can take the window's slabs.
inline bool bulk_ok(const float* w, int N) {
  return ((uintptr_t)w % 16 == 0) && ((N * N) % 4 == 0);
}

// The launch of a planned ring (a's ring fields and bytes from plan or
// ring_bytes), bulk copies or cp.async, the frontier read by float4 where
// N % 4 == 0.
inline int launch_ring(const Args& a, size_t bytes, bool bulk,
                       cudaStream_t stream) {
  if (a.R == 0) return 0;
  const bool vec = a.N % 4 == 0;
  if (bulk) return vec ? launch_as<true, true>(a, bytes, stream)
                       : launch_as<true, false>(a, bytes, stream);
  return vec ? launch_as<false, true>(a, bytes, stream)
             : launch_as<false, false>(a, bytes, stream);
}

inline int launch(Args a, bool bulk, cudaStream_t stream) {
  size_t bytes;
  if (!plan(a.N, &a, &bytes)) return -1;
  return launch_ring(a, bytes, bulk, stream);
}

}  // namespace mp

// start: int32 or int64 (wide), one entry per ks rows.
extern "C" int minplus_launch(const float* w, const void* start,
                              float* best_out, int* bp_out, int R, int H,
                              int N, int ks, int wide, void* stream) {
  mp::Args a{w, mp::Ints{start, wide}, best_out, bp_out, R, H, N, ks,
             0, 0, 0, 0, 0};
  return mp::launch(a, mp::bulk_ok(w, N), (cudaStream_t)stream);
}
