// Measurement variants of the backpointer walk and the min-plus scan
// (where does the time of a launch go?).  Built and timed by
// testing_tools/walk_variants.py beside the kernels in csrc/backtrace.cu
// and csrc/minplus.cu, whose device functions they share; nothing in the
// package calls them.
//
// Walk (bt_variant_launch):
//   0  baseline: the kernel's first design.  One thread per row, 128 a
//      block, the H dependent loads of the chain from L2 or device memory;
//      int32 indices and its own (R, H+1, N) table per row only.
//   1  walk_only: the kernel's table staged once, then the walk repeated
//      reps times, each from the node the last one ended on; the slope
//      over reps is the chain of one walk (a dependent shared-memory read
//      and clamp a walked layer), the walk's chain floor.
//
// Min-plus (mp_variant_launch):
//   0  baseline: the kernel's first design.  One warp per row, lane m
//      owning target m; step h's loads issued inside the chain after the
//      __syncwarp of step h-1.  int32 start, one per row.
//   1  stream_only: the window streamed through the rings of
//      csrc/minplus.cu with no DP (each stage waited for, then refilled):
//      the bytes floor this streaming can reach.
//   2  relax_only: the ring's first stages loaded once and left in shared
//      memory; then H relax steps of csrc/minplus.cu over their slabs in
//      turn, outputs written.  No step waits for a load.
//   3  csrc/minplus.cu through its 4-byte cp.async path at any N.
//   100 + 10 K + S, 200 + 10 K + S: csrc/minplus.cu and stream_only with
//      K steps' slabs a stage (one bulk copy) and S stages a ring, four
//      rows a block (the kernel plans STEPS x STAGES where it fits).
#include <cuda_runtime.h>
#include <stdint.h>

#include "../csrc/backtrace.cu"
#include "../csrc/minplus.cu"

// ---- walk -----------------------------------------------------------------

__global__ void bt_baseline_kernel(const int* __restrict__ bp,
                                   const int* __restrict__ goal,
                                   const int* __restrict__ h_eff,
                                   int* __restrict__ nodes, int R, int Hp1,
                                   int N) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int* b = bp + (long long)r * Hp1 * N;
  int* out = nodes + (long long)r * Hp1;
  const int he = h_eff[r];
  const int g = goal[r];
  int carry = g;
  for (int h = Hp1 - 1; h >= 0; --h) {
    int node;
    if (h > he) {
      node = -1;
    } else if (h == he) {
      node = g;
    } else {
      const int hh = h + 1 < Hp1 - 1 ? h + 1 : Hp1 - 1;
      node = b[hh * N + (carry > 0 ? carry : 0)];
    }
    if (h <= he) carry = node;
    out[h] = node;
  }
}

__global__ void __launch_bounds__(bt::WARPS * 32)
    bt_walk_only(bt::Args a, int warps, int reps) {
  extern __shared__ int tbl_all[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * warps + warp;
  if (r >= a.R) return;
  int* tbl = tbl_all + (long long)warp * a.Hp1 * a.N;
  const int he = a.h_eff[r];
  int g = a.goal[r];
  const int hi = min(he, a.Hp1);
  int* out = a.nodes + (long long)r * a.Hp1;
  bt::load_smem(tbl, bt::row_table(a, r), a.Hp1, a.N, he, lane);
  for (int h = max(hi, 0) + lane; h < a.Hp1; h += 32)
    out[h] = bt::node_at(h, hi, he, g, 0);
  int carry;
  for (int i = 0; i < reps; ++i) {
    bt::walk_smem(tbl, a.Hp1, a.N, hi, g, lane,
                  i + 1 == reps ? out : nullptr, carry);
    g = carry > 0 ? carry : 0;
  }
}

extern "C" int bt_variant_launch(int variant, int reps, const int* bp,
                                 const void* goal, const void* h_eff,
                                 const void* slot, int* nodes, int R,
                                 int Hp1, int N, int S, int k, int wide,
                                 void* stream) {
  if (R == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bt::Args a{bp, bt::Ints{goal, wide & 1},
                   bt::Ints{h_eff, (wide >> 1) & 1},
                   bt::Ints{slot, (wide >> 2) & 1}, nodes, R, Hp1, N, S, k};
  switch (variant) {
    case 0:
      if (slot || wide) return -1;
      bt_baseline_kernel<<<(R + 127) / 128, 128, 0, st>>>(
          bp, (const int*)goal, (const int*)h_eff, nodes, R, Hp1, N);
      break;
    case 1: {
      size_t bytes;
      const int warps = bt::block_rows(Hp1, N, &bytes);
      if (warps == 0) return -1;
      bool ready = false;
      const int err = bt::allow_smem(bt_walk_only, &ready);
      if (err) return err;
      bt_walk_only<<<(R + warps - 1) / warps, warps * 32, bytes, st>>>(
          a, warps, reps);
      break;
    }
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

// ---- min-plus -------------------------------------------------------------

#define MP_BASE_WARPS 4

__global__ void mp_baseline_kernel(const float* __restrict__ w,
                                   const int* __restrict__ start,
                                   float* __restrict__ best_out,
                                   int* __restrict__ bp_out, int R, int H,
                                   int N) {
  extern __shared__ float bsm[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * MP_BASE_WARPS + warp;
  if (r >= R) return;
  float* cur = bsm + warp * 2 * N;
  float* nxt = cur + N;
  const long long NN = (long long)N * N;
  const float* wr = w + (long long)r * H * NN;
  float* bo = best_out + (long long)r * (H + 1) * N;
  int* po = bp_out + (long long)r * (H + 1) * N;
  const int s = start[r];

  for (int m = lane; m < N; m += 32) {
    const float v0 = (m == s) ? 0.0f : MP_INF;
    cur[m] = v0;
    bo[m] = v0;
    po[m] = -1;
  }
  __syncwarp();

  for (int h = 0; h < H; ++h) {
    const float* wh = wr + h * NN;
    for (int m = lane; m < N; m += 32) {
      float bmin = 0.0f;
      int bi = 0;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float tot = cur[n] + wh[n * N + m];
        if (n == 0 || tot < bmin) {
          bmin = tot;
          bi = n;
        }
      }
      bmin = fminf(bmin, MP_INF);
      nxt[m] = bmin;
      bo[(h + 1) * N + m] = bmin;
      po[(h + 1) * N + m] = bi;
    }
    __syncwarp();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

template <bool BULK>
__global__ void __launch_bounds__(mp::WARPS * 32)
    mp_stream_only(mp::Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * a.warps + warp;
  if (r >= a.R) return;
  mp::Ring g = mp::ring_of(smem, a, warp);
  const int NN = a.N * a.N, H = a.H, S = a.stages, K = a.steps;
  const int chunks = (H + K - 1) / K;
  const float* wr = a.w + (long long)r * H * NN;
  mp::ring_init<BULK>(g, S, lane);
  for (int c = 0; c < S && c < chunks; ++c)
    mp::ring_load<BULK>(g, a, c, wr + (long long)c * K * NN,
                        min(K, H - c * K) * NN, lane);
  int s = 0;
  uint32_t parity = 0;
  for (int c = 0; c < chunks; ++c) {
    mp::bar_wait(g.bar + s, parity);
    __syncwarp();
    if (c + S < chunks)
      mp::ring_load<BULK>(g, a, s, wr + (long long)(c + S) * K * NN,
                          min(K, H - (c + S) * K) * NN, lane);
    if (++s == S) {
      s = 0;
      parity ^= 1u;
    }
  }
}

template <bool BULK, bool VEC>
__global__ void __launch_bounds__(mp::WARPS * 32)
    mp_relax_only(mp::Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * a.warps + warp;
  if (r >= a.R) return;
  mp::Ring g = mp::ring_of(smem, a, warp);
  const int N = a.N, NN = N * N;
  const int H = a.H, S = a.stages, K = a.steps;
  const int chunks = (H + K - 1) / K;
  const float* wr = a.w + (long long)r * H * NN;
  float* bo = a.best + (long long)r * (H + 1) * N;
  int* po = a.bp + (long long)r * (H + 1) * N;
  mp::ring_init<BULK>(g, S, lane);
  const int loaded = S < chunks ? S : chunks;
  for (int c = 0; c < loaded; ++c)
    mp::ring_load<BULK>(g, a, c, wr + (long long)c * K * NN,
                        min(K, H - c * K) * NN, lane);
  const int st = a.start[r / a.ks];
  for (int m = lane; m < N; m += 32) {
    const float v0 = (m == st) ? 0.0f : MP_INF;
    g.cur[m] = v0;
    bo[m] = v0;
    po[m] = -1;
  }
  for (int c = 0; c < loaded; ++c) mp::bar_wait(g.bar + c, 0);
  __syncwarp();
  for (int h = 0; h < H; ++h) {
    const float* slab = g.slab + ((h / K) % loaded) * a.pitch + (h % K) * NN;
    mp::relax<VEC>(slab, g.cur, g.nxt, bo + (h + 1) * N,
                       po + (h + 1) * N, N, lane);
    __syncwarp();
    float* t = g.cur;
    g.cur = g.nxt;
    g.nxt = t;
  }
}

template <typename K>
static int launch_mp(K kernel, const mp::Args& a, size_t bytes,
                     cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, mp::SMEM_LIMIT);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(a.R + a.warps - 1) / a.warps, a.warps * 32, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool BULK>
static int launch_relax_only(const mp::Args& a, size_t bytes,
                             cudaStream_t st) {
  return a.N % 4 == 0 ? launch_mp(mp_relax_only<BULK, true>, a, bytes, st)
                      : launch_mp(mp_relax_only<BULK, false>, a, bytes, st);
}

// The ring of K steps a stage and S stages, four rows a block, or the
// kernel's own plan (K = S = 0); false where it does not fit.
static bool ring_of_shape(int N, int K, int S, mp::Args* a, size_t* bytes) {
  if (K == 0) return mp::plan(N, a, bytes);
  return S >= 2 && S <= mp::MAX_STAGES &&
         (*bytes = mp::ring_bytes(N, mp::WARPS, K, S, a)) <= mp::SMEM_LIMIT;
}

extern "C" int mp_variant_launch(int variant, const float* w,
                                 const void* start, float* best, int* bp,
                                 int R, int H, int N, int ks, int wide,
                                 void* stream) {
  if (R == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  mp::Args a{w, mp::Ints{start, wide}, best, bp, R, H, N, ks,
             0, 0, 0, 0, 0};
  // 100 + 10 K + S: the kernel, 200 + 10 K + S: stream_only, with K steps
  // a stage and S stages; otherwise the kernel's own plan
  const int steps = variant >= 100 ? variant / 10 % 10 : 0;
  const int stages = variant >= 100 ? variant % 10 : 0;
  size_t bytes;
  if (!ring_of_shape(N, steps, stages, &a, &bytes)) return -1;
  const bool bulk = mp::bulk_ok(w, N);
  if (variant >= 200)
    return bulk ? launch_mp(mp_stream_only<true>, a, bytes, st)
                : launch_mp(mp_stream_only<false>, a, bytes, st);
  if (variant >= 100) return mp::launch_ring(a, bytes, bulk, st);
  switch (variant) {
    case 0: {
      if (wide || ks != 1) return -1;
      const size_t shmem = (size_t)MP_BASE_WARPS * 2 * N * sizeof(float);
      mp_baseline_kernel<<<(R + MP_BASE_WARPS - 1) / MP_BASE_WARPS,
                           MP_BASE_WARPS * 32, shmem, st>>>(
          w, (const int*)start, best, bp, R, H, N);
      return (int)cudaGetLastError();
    }
    case 1:
      return bulk ? launch_mp(mp_stream_only<true>, a, bytes, st)
                  : launch_mp(mp_stream_only<false>, a, bytes, st);
    case 2:
      return bulk ? launch_relax_only<true>(a, bytes, st)
                  : launch_relax_only<false>(a, bytes, st);
    case 3:
      return mp::launch_ring(a, bytes, false, st);
    default:
      return -1;
  }
}

// Blocks of csrc/minplus.cu's kernel that one SM holds at N, with K steps
// a stage and S stages (the CUDA occupancy calculator, the kernel's
// attributes set as at its launch).
extern "C" int mp_blocks_per_sm(int N, int K, int S) {
  mp::Args a{};
  size_t bytes;
  if (!ring_of_shape(N, K, S, &a, &bytes)) return -1;
  bool ready = false;
  auto kernel = mp::minplus_kernel<true, true>;
  if (mp::allow_smem(kernel, &ready)) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    a.warps * 32, bytes))
    return -1;
  return blocks;
}
