// Masked 4-slot min-plus window DP for the batched fleet tick.
//
// Replaces the TPU kernel graphbasedlocaltrajectoryplanner_tpu/ops/
// pallas_window.py:_kernel (via fused_window_dp).  Semantics of the scan
// step of planner/pathgen.plan_window_kernel: per scenario and window step h
// the cost slab of layer (start_layer + h) mod L, blocked on an open track
// once start_layer + h >= L - 1; zone rows/cols (every slot); the one-edge
// w_last discount; object blocks (straight/left/right); the overtake splits
// at p_obs - 1 / p_obs (left/right); then for all 4 slots
// best'[m] = min_n best[n] + w[n, m] with the lowest n on ties, clamped to
// INF.  Slots: 0 straight, 1 follow, 2 left, 3 right.
//
// Bound on the H100: neither bytes nor operations (a few MB in, about
// 8 * N^2 flops per step and scenario) — the H sequential steps make it
// latency-bound.  Design: one block per scenario; the block builds the
// step's masked follow and default slabs in shared memory (each thread a
// stripe of the N*N edges), then one thread per (slot, target node m)
// relaxes over n with the 4-slot frontier in shared memory.  This replaces
// the TPU's sequential grid axis with its VMEM carry; the bf16x3 select,
// the replicate dot, the power-of-two node padding and the step-major
// tables were TPU workarounds and are gone.
#include <cuda_runtime.h>
#include <stdint.h>

#define WDP_INF 1e30f
#define WDP_FEAS 1e29f

__global__ void window_dp_kernel(
    const float* __restrict__ w, const uint8_t* __restrict__ zone,
    long long zone_bstride, const int* __restrict__ start_layer,
    const int* __restrict__ start_node, const int* __restrict__ slab_layers,
    const uint8_t* __restrict__ hit_slab, const int* __restrict__ p_obs,
    const uint8_t* __restrict__ in_win, const int* __restrict__ obs_node,
    const int* __restrict__ last_nodes, const float* __restrict__ w_fac,
    float* __restrict__ best_out, int* __restrict__ bp_out, int L, int N,
    int O, int H, int n_last, int closed) {
  extern __shared__ float smem[];
  const int NN = N * N;
  float* best = smem;               // 4 * N frontier
  float* w_fol = best + 4 * N;      // N * N follow-slot costs
  float* w_def = w_fol + NN;        // N * N object-blocked costs
  int* slab = (int*)(w_def + NN);   // 2 * O slab layers of this scenario

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int sl = start_layer[b];
  const uint8_t* zb = zone + zone_bstride * b;
  const uint8_t* hit = hit_slab + (long long)b * 2 * O * NN;
  const int* last = last_nodes + (long long)b * n_last;
  const int obs = obs_node[b];
  const int po = p_obs[b];
  const bool iw = in_win[b] != 0;
  const long long out_base = (long long)b * 4 * (H + 1) * N;

  for (int k = tid; k < 2 * O; k += blockDim.x)
    slab[k] = slab_layers[(long long)b * 2 * O + k];
  if (tid < 4 * N) {
    const int s = tid / N, m = tid % N;
    const float v0 = (m == start_node[b]) ? 0.0f : WDP_INF;
    best[tid] = v0;
    best_out[out_base + (long long)s * (H + 1) * N + m] = v0;
    bp_out[out_base + (long long)s * (H + 1) * N + m] = -1;
  }
  __syncthreads();

  for (int h = 0; h < H; ++h) {
    const int layer = (sl + h) % L;
    const int nxt = (layer + 1) % L;
    const bool off_end = !closed && (sl + h >= L - 1);
    int a = -1, bb = -1;
    float fac = 1.0f;
    bool apply = false;
    if (n_last >= 2 && h < n_last - 1) {
      a = last[h];
      bb = last[h + 1];
      fac = w_fac[h];
      apply = a >= 0 && bb >= 0;
    }
    const float* wl = w + (long long)layer * NN;
    for (int e = tid; e < NN; e += blockDim.x) {
      const int n = e / N, m = e % N;
      float wv = off_end ? WDP_INF : wl[e];
      if (zb[layer * N + n] || zb[nxt * N + m]) wv = WDP_INF;
      if (apply && n == a && m == bb && wv < WDP_FEAS) wv = wv * fac;
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
      best_out[o] = bmin;
      bp_out[o] = bi;
    }
    __syncthreads();
  }
}

extern "C" int window_dp_launch(
    const float* w, const uint8_t* zone, long long zone_bstride,
    const int* start_layer, const int* start_node, const int* slab_layers,
    const uint8_t* hit_slab, const int* p_obs, const uint8_t* in_win,
    const int* obs_node, const int* last_nodes, const float* w_fac,
    float* best_out, int* bp_out, int B, int L, int N, int O, int H,
    int n_last, int closed, void* stream) {
  if (B == 0) return 0;
  int threads = ((4 * N + 31) / 32) * 32;
  size_t shmem = (size_t)(4 * N + 2 * N * N) * sizeof(float)
                 + (size_t)2 * O * sizeof(int);
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  window_dp_kernel<<<B, threads, shmem, (cudaStream_t)stream>>>(
      w, zone, zone_bstride, start_layer, start_node, slab_layers, hit_slab,
      p_obs, in_win, obs_node, last_nodes, w_fac, best_out, bp_out, L, N, O,
      H, n_last, closed);
  return (int)cudaGetLastError();
}
