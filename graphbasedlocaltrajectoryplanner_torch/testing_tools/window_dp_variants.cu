// Measurement variants of the window-DP and the slab-hit kernels (where
// does the time of a launch go?).  Built and timed by testing_tools/
// window_dp_variants.py beside the kernels in csrc/window_dp.cu and
// csrc/hit_slab.cu, whose device functions they share; nothing in the
// package calls them.
//
// Window DP (wdp_variant_launch):
//   0  baseline: the kernel's first design.  One block per scenario, 4*N
//      threads, three __syncthreads() a step; every thread builds a stripe
//      of the step's masked slabs (global loads, a loop over all 2*O slab
//      layers per edge) inside the chain, then one thread per (slot, m)
//      walks n = 0 .. N-1.
//   1  masks prefetched, the old relax: the producer warps and the ring of
//      csrc/window_dp.cu, but one consumer thread per (slot, m) walking all
//      N sources.
//   2  relax_only, the chain floor: the first STAGES steps' slabs are built
//      once and stay in shared memory; the consumers then run H relax steps
//      of csrc/window_dp.cu on them with their one barrier a step and write
//      the last frontier only.  H times its step is the least a launch can
//      take.
//   3  rows in shared memory: csrc/window_dp.cu, but the (4, H+1, N) rows
//      of best and bp stay in shared memory and leave at the end in 16-byte
//      stores by all threads of the block.
//
// Slab hits (hs_variant_launch):
//   0  baseline: the kernel's first design.  One thread per output byte,
//      64-bit index arithmetic, an edge's samples read from global memory
//      at 8*S bytes between neighbouring lanes, one-byte stores.
//   1  staged, one block per entry: every active (b, o, j) stages its
//      layer's samples in shared memory and computes its plane from there
//      with the packed stores of csrc/hit_slab.cu; an inactive one writes
//      its zeros.  No reuse of a layer between entries.
//   2  csrc/hit_slab.cu with the given number of entries per block range
//      and bytes of a layer's samples per block part; 3  the same without
//      the help of idle layers' blocks for crowded layers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../csrc/hit_slab.cu"
#include "../csrc/window_dp.cu"

// ---- window DP, variant 0 -------------------------------------------------

__global__ void wdp_baseline_kernel(wdp::Args a) {
  extern __shared__ float bsm[];
  const int N = a.N, O = a.O, H = a.H, L = a.L, n_last = a.n_last;
  const int NN = N * N;
  float* best = bsm;
  float* w_fol = best + 4 * N;
  float* w_def = w_fol + NN;
  int* slab = (int*)(w_def + NN);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int sl = a.start_layer[b];
  const uint8_t* zb = a.zone + a.zone_bstride * b;
  const uint8_t* hit = a.hit_slab + (long long)b * 2 * O * NN;
  const int obs = a.obs_node[b];
  const int po = a.p_obs[b];
  const bool iw = a.in_win[b] != 0;
  const long long out_base = (long long)b * 4 * (H + 1) * N;

  for (int k = tid; k < 2 * O; k += blockDim.x)
    slab[k] = a.slab_layers[(long long)b * 2 * O + k];
  if (tid < 4 * N) {
    const int s = tid / N, m = tid % N;
    const float v0 = (m == a.start_node[b]) ? 0.0f : WDP_INF;
    best[tid] = v0;
    a.best_out[out_base + (long long)s * (H + 1) * N + m] = v0;
    a.bp_out[out_base + (long long)s * (H + 1) * N + m] = -1;
  }
  __syncthreads();

  for (int h = 0; h < H; ++h) {
    const int layer = (sl + h) % L;
    const int nxt = (layer + 1) % L;
    const bool off_end = !a.closed && (sl + h >= L - 1);
    int na = -1, nb = -1;
    float fac = 1.0f;
    bool apply = false;
    if (n_last >= 2 && h < n_last - 1) {
      na = a.last_nodes[(long long)b * n_last + h];
      nb = a.last_nodes[(long long)b * n_last + h + 1];
      fac = a.w_fac[h];
      apply = na >= 0 && nb >= 0;
    }
    const float* wl = a.w + (long long)layer * NN;
    for (int e = tid; e < NN; e += blockDim.x) {
      const int n = e / N, m = e % N;
      float wv = off_end ? WDP_INF : wl[e];
      if (zb[layer * N + n] || zb[nxt * N + m]) wv = WDP_INF;
      if (apply && n == na && m == nb && wv < WDP_FEAS) wv = wv * fac;
      bool blocked = false;
      for (int k = 0; k < 2 * O; ++k)
        blocked |= (slab[k] == layer) && (hit[(long long)k * NN + e] != 0);
      w_fol[e] = wv;
      w_def[e] = blocked ? WDP_INF : wv;
    }
    __syncthreads();

    float bmin = 0.0f;
    int bi = 0;
    if (tid < 4 * N) {
      const int s = tid / N, m = tid % N;
      const float* ws = (s == 1) ? w_fol : w_def;
      const bool into = iw && (h == po - 1);
      const bool outof = iw && (h == po);
      const float* bs = best + s * N;
      for (int n = 0; n < N; ++n) {
        float wv = ws[n * N + m];
        if (s == 2 && ((into && m >= obs) || (outof && n >= obs)))
          wv = WDP_INF;
        if (s == 3 && ((into && m < obs) || (outof && n < obs)))
          wv = WDP_INF;
        const float tot = bs[n] + wv;
        if (n == 0 || tot < bmin) {
          bmin = tot;
          bi = n;
        }
      }
      bmin = fminf(bmin, WDP_INF);
    }
    __syncthreads();
    if (tid < 4 * N) {
      const int s = tid / N, m = tid % N;
      best[tid] = bmin;
      const long long o = out_base + ((long long)s * (H + 1) + h + 1) * N + m;
      a.best_out[o] = bmin;
      a.bp_out[o] = bi;
    }
    __syncthreads();
  }
}

// ---- window DP, variant 1: the ring, one consumer thread per (slot, m) ----

__global__ void wdp_prefetch_old_relax_kernel(wdp::Args a) {
  using namespace wdp;
  extern __shared__ __align__(16) float vsm[];
  const Smem s(vsm, a.N, a.O, a.H, a.n_last);
  const int N = a.N, H = a.H, n4 = rows_of(N), pitch = pitch_of(N);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int n_cons = round_up(4 * N, 32);
  const int sl = a.start_layer[b];
  prologue(a, s, b, sl);
  if (tid >= n_cons) {
    producer_loop(a, s, b, sl, (tid - n_cons) >> 5, lane, n_cons);
    return;
  }
  const int slot = tid / N, m = tid % N;
  const bool act = tid < 4 * N;
  const int obs = a.obs_node[b], po = a.p_obs[b];
  const bool iw = a.in_win[b] != 0;
  float* front = reinterpret_cast<float*>(s.front);
  const long long out0 = ((long long)b * 4 + slot) * (H + 1) * N + m;
  for (int h = 0; h < H; ++h) {
    const int stage = h % STAGES;
    bar_sync(BAR_FULL + stage, n_cons + 32);
    float bmin = 0.0f;
    int bi = 0;
    if (act) {
      const float* ws = slot == 1 ? s.fol(stage) : s.def(stage);
      const float* f = front + (h & 1) * n4 * 4 + slot;
      const bool into = iw && (h == po - 1);
      const bool outof = iw && (h == po);
      for (int n = 0; n < N; ++n) {
        float wv = ws[n * pitch + m];
        if (slot == 2 && ((into && m >= obs) || (outof && n >= obs)))
          wv = WDP_INF;
        if (slot == 3 && ((into && m < obs) || (outof && n < obs)))
          wv = WDP_INF;
        const float tot = f[4 * n] + wv;
        if (n == 0 || tot < bmin) {
          bmin = tot;
          bi = n;
        }
      }
      bmin = fminf(bmin, WDP_INF);
    }
    if (h + STAGES < H) bar_arrive(BAR_EMPTY + stage, n_cons + 32);
    if (act) {
      front[((h + 1) & 1) * n4 * 4 + 4 * m + slot] = bmin;
      a.best_out[out0 + (long long)(h + 1) * N] = bmin;
      a.bp_out[out0 + (long long)(h + 1) * N] = bi;
    }
  }
}

// ---- window DP, variants 2 and 3: the kernel's own consumer loop ----------

constexpr int BAR_CONSUMERS = 1 + 2 * wdp::STAGES;
constexpr int RELAX_ONLY = 2, ROWS_IN_SMEM = 3;

template <int MODE>
__global__ void wdp_variant_kernel(wdp::Args a) {
  using namespace wdp;
  extern __shared__ __align__(16) float vsm[];
  const Smem s(vsm, a.N, a.O, a.H, a.n_last);
  const int N = a.N, H = a.H, n4 = rows_of(N);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int n_cons = consumer_threads(N);
  const int sl = a.start_layer[b];
  // ROWS_IN_SMEM: the rows of both outputs behind the kernel's shared memory
  const int rows = 4 * (H + 1) * N;
  float* obest = vsm + round_up((int)s.bytes, 16) / 4;
  int* obp = reinterpret_cast<int*>(obest + round_up(rows, 4));
  prologue(a, s, b, sl);
  if (MODE == ROWS_IN_SMEM) {
    for (int i = tid; i < 4 * N; i += blockDim.x) {
      const int sidx = i / N, m = i - sidx * N;
      obest[sidx * (H + 1) * N + m] =
          (m == a.start_node[b]) ? 0.0f : WDP_INF;
      obp[sidx * (H + 1) * N + m] = -1;
    }
  }

  if (tid >= n_cons) {
    const int pw = (tid - n_cons) >> 5;
    if (MODE == RELAX_ONLY) {
      if (pw < H) {
        produce_step(a, s, Edges(a), b, sl, pw, s.fol(pw), s.def(pw), lane);
        bar_arrive(BAR_FULL + pw, n_cons + 32);
      }
      return;
    }
    producer_loop(a, s, b, sl, pw, lane, n_cons);
  } else {
    const int m = tid >> 2, q = tid & 3, slot = slot_of_lane(q);
    const int obs = a.obs_node[b], po = a.p_obs[b];
    const bool iw = a.in_win[b] != 0;
    float* front = reinterpret_cast<float*>(s.front);
    const int row0 = slot * (H + 1) * N + m;
    if (MODE == RELAX_ONLY)
      for (int p = 0; p < STAGES && p < H; ++p)
        bar_sync(BAR_FULL + p, n_cons + 32);
    const int n_stages = MODE == RELAX_ONLY && H < STAGES ? H : STAGES;
    int stage = 0;
    float val = 0.0f;
    int idx = 0;
    for (int h = 0; h < H; ++h) {
      if (MODE == RELAX_ONLY)
        bar_sync(BAR_CONSUMERS, n_cons);
      else
        bar_sync(BAR_FULL + stage, n_cons + 32);
      const bool into = iw && h == po - 1, outof = iw && h == po;
      const float4* fr = s.front + (h & 1) * n4;
      if (N == 24)
        relax_step<24>(s.fol(stage), s.def(stage), fr, N, m, q, into, outof,
                       obs, val, idx);
      else if (N == 32)
        relax_step<32>(s.fol(stage), s.def(stage), fr, N, m, q, into, outof,
                       obs, val, idx);
      else
        relax_step(s.fol(stage), s.def(stage), fr, N, m, q, into, outof, obs,
                   val, idx);
      if (MODE != RELAX_ONLY && h + STAGES < H)
        bar_arrive(BAR_EMPTY + stage, n_cons + 32);
      if (m < N) {
        front[((h + 1) & 1) * n4 * 4 + m * 4 + slot] = val;
        if (MODE == ROWS_IN_SMEM) {
          obest[row0 + (h + 1) * N] = val;
          obp[row0 + (h + 1) * N] = idx;
        }
      }
      stage = stage + 1 == n_stages ? 0 : stage + 1;
    }
    if (MODE == RELAX_ONLY && m < N) {
      const long long o = (long long)b * rows + row0 + H * N;
      a.best_out[o] = val;
      a.bp_out[o] = idx;
    }
  }
  if (MODE != ROWS_IN_SMEM) return;
  __syncthreads();
  // rows is a multiple of 4 and a scenario's rows start 16-byte aligned
  float4* gb = reinterpret_cast<float4*>(a.best_out + (long long)b * rows);
  int4* gp = reinterpret_cast<int4*>(a.bp_out + (long long)b * rows);
  for (int i = tid; i < rows / 4; i += blockDim.x) {
    gb[i] = reinterpret_cast<const float4*>(obest)[i];
    gp[i] = reinterpret_cast<const int4*>(obp)[i];
  }
}

extern "C" int wdp_variant_launch(
    int variant, const float* w, const uint8_t* zone, long long zone_bstride,
    const void* start_layer, const void* start_node, const void* slab_layers,
    const uint8_t* hit_slab, const void* p_obs, const uint8_t* in_win,
    const void* obs_node, const void* last_nodes, const float* w_fac,
    float* best_out, int* bp_out, int B, int L, int N, int O, int H,
    int n_last, int closed, int wide, void* stream) {
  if (B == 0) return 0;
  const wdp::Args a = wdp::make_args(
      w, zone, zone_bstride, start_layer, start_node, slab_layers, hit_slab,
      p_obs, in_win, obs_node, last_nodes, w_fac, best_out, bp_out, L, N, O,
      H, n_last, closed, wide);
  cudaStream_t st = (cudaStream_t)stream;
  void (*kern)(wdp::Args) = nullptr;
  int threads = wdp::consumer_threads(N) + 32 * wdp::STAGES;
  size_t shmem = wdp::smem_bytes(N, O, H, n_last);
  if (variant == 0) {
    kern = wdp_baseline_kernel;
    threads = ((4 * N + 31) / 32) * 32;
    shmem = (size_t)(4 * N + 2 * N * N) * sizeof(float)
            + (size_t)2 * O * sizeof(int);
  } else if (variant == 1) {
    kern = wdp_prefetch_old_relax_kernel;
    threads = wdp::round_up(4 * N, 32) + 32 * wdp::STAGES;
  } else if (variant == RELAX_ONLY) {
    kern = wdp_variant_kernel<RELAX_ONLY>;
  } else if (variant == ROWS_IN_SMEM) {
    kern = wdp_variant_kernel<ROWS_IN_SMEM>;
    shmem = wdp::round_up((int)shmem, 16)
            + (size_t)2 * wdp::round_up(4 * (H + 1) * N, 4) * sizeof(float);
  } else {
    return -2;
  }
  if (threads > 1024 || shmem > 227 * 1024) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, threads, shmem, st>>>(a);
  return (int)cudaGetLastError();
}

// ---- slab hits, variant 0 ---------------------------------------------------

__global__ void hs_baseline_kernel(const float* __restrict__ samples,
                                   const hs::Ints slab_layers,
                                   const float* __restrict__ obj_pos,
                                   const float* __restrict__ ref2,
                                   const uint8_t* __restrict__ obj_app,
                                   uint8_t* __restrict__ out,
                                   long long total, int L, int NN, int S) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    long long e = i % NN;
    long long boj = i / NN;          // (b * O + o) * 2 + j
    long long bo = boj >> 1;
    uint8_t hit = 0;
    if (obj_app[bo]) {
      int layer = slab_layers[boj];
      layer = layer < 0 ? 0 : (layer > L - 1 ? L - 1 : layer);
      const float ox = obj_pos[2 * bo];
      const float oy = obj_pos[2 * bo + 1];
      const float* p = samples + ((long long)layer * NN + e) * S * 2;
      float dmin = INFINITY;
      for (int s = 0; s < S; ++s) {
        float dx = p[2 * s] - ox;
        float dy = p[2 * s + 1] - oy;
        float d2 = dx * dx + dy * dy;
        dmin = fminf(dmin, d2);
      }
      hit = dmin <= ref2[bo];
    }
    out[i] = hit;
  }
}

// ---- slab hits, variant 1: staged, one block per entry ---------------------

__global__ void __launch_bounds__(hs::THREADS)
hs_block_per_entry_kernel(hs::Args a) {
  extern __shared__ __align__(16) float2 eslab[];
  const int entry = blockIdx.x, bo = entry >> 1;
  if (!a.obj_app[bo]) {
    hs::zero_inactive(a, entry, entry + 1);
    return;
  }
  int l = a.slab_layers[entry];
  l = l < 0 ? 0 : (l > a.L - 1 ? a.L - 1 : l);
  hs::stage_layer(a, l, 0, a.NN, eslab);
  hs::cp_async_wait_all();
  __syncthreads();
  const hs::Match mt{entry, a.obj_pos[2 * bo], a.obj_pos[2 * bo + 1],
                     a.ref2[bo]};
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < (a.NN + 31) / 32; c += hs::THREADS / 32)
    hs::hit_edges(a, eslab, 0, hs::pitch_of(a.S), mt, c, lane);
}

extern "C" int hs_variant_launch(int variant, int range, int part_bytes,
                                 const float* samples,
                                 const void* slab_layers, const float* obj_pos,
                                 const float* ref2, const uint8_t* obj_app,
                                 uint8_t* out, int B, int O, int L, int N,
                                 int S, int wide, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long E = (long long)B * O * 2;
  if (E == 0) return 0;
  if (variant == 0) {
    long long total = E * N * N;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > (1LL << 30)) blocks = 1LL << 30;
    hs_baseline_kernel<<<(unsigned)blocks, threads, 0, st>>>(
        samples, hs::Ints{slab_layers, wide}, obj_pos, ref2, obj_app, out,
        total, L, N * N, S);
    return (int)cudaGetLastError();
  }
  if (variant == 1) {
    const size_t shmem = (size_t)N * N * hs::pitch_of(S) * sizeof(float2);
    if (shmem > 227 * 1024) return -1;
    const hs::Args a{samples, hs::Ints{slab_layers, wide}, obj_pos, ref2,
                     obj_app, out, (int)E, L, N * N, S, 1, 0, 0};
    cudaError_t err = cudaFuncSetAttribute(
        hs_block_per_entry_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
    hs_block_per_entry_kernel<<<(unsigned)E, hs::THREADS, shmem, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (variant == 2 || variant == 3)
    return hs::launch(samples, slab_layers, obj_pos, ref2, obj_app, out, B, O,
                      L, N, S, wide, range, part_bytes,
                      variant == 2 ? hs::HEAVY : 1 << 30, st);
  return -2;
}
