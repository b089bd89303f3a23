// Batched min-plus DP over a materialized window.
//
// Replaces the TPU kernel graphbasedlocaltrajectoryplanner_tpu/ops/
// pallas_minplus.py:_minplus_kernel (via minplus_scan_pallas).  Semantics
// of ops/search.minplus_scan, per row r: best[0] is 0 at start[r] and INF
// elsewhere, bp[0] = -1, and for h = 0 .. H-1
//   best[h+1, m] = min(min_n best[h, n] + w[h, n, m], INF)
//   bp[h+1, m]   = argmin_n of the same sums, the lowest n on ties.
//
// Bound on the H100: bytes.  Each row reads its H * N * N window once
// (4 * H * N^2 bytes against 2 * H * N^2 flops); the H dependent steps add
// latency.  Design: one warp per row, lane m owning target node m (and
// m + 32, ... for N > 32); the frontier lives in shared memory, double
// buffered so a step reads one buffer and writes the other with one
// __syncwarp between steps.  For fixed n the loads w[h, n, m] are
// consecutive across the lanes, so every row of the window is read
// coalesced.  The TPU's BLOCK_B row padding was a layout of that chip and
// is gone: a warp with no row returns at once.
#include <cuda_runtime.h>

#define MP_INF 1e30f
#define MP_WARPS 4

__global__ void minplus_kernel(const float* __restrict__ w,
                               const int* __restrict__ start,
                               float* __restrict__ best_out,
                               int* __restrict__ bp_out, int R, int H,
                               int N) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * MP_WARPS + warp;
  if (r >= R) return;
  float* cur = smem + warp * 2 * N;
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

extern "C" int minplus_launch(const float* w, const int* start,
                              float* best_out, int* bp_out, int R, int H,
                              int N, void* stream) {
  if (R == 0) return 0;
  const int blocks = (R + MP_WARPS - 1) / MP_WARPS;
  const size_t shmem = (size_t)MP_WARPS * 2 * N * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        minplus_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  minplus_kernel<<<blocks, MP_WARPS * 32, shmem, (cudaStream_t)stream>>>(
      w, start, best_out, bp_out, R, H, N);
  return (int)cudaGetLastError();
}
