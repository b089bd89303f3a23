// Backpointer walk for the batched fleet tick.
//
// Replaces the TPU kernel graphbasedlocaltrajectoryplanner_tpu/ops/
// pallas_backtrace.py:_kernel (via _walk_flat / make_backtrace_walk).
// Semantics of ops/search.backtrace, per row: node[h_eff] = goal,
// node[h] = bp[h+1][node[h+1]] below it, -1 above it.
//
// Bound on the H100: bytes, and in practice the latency of H dependent
// loads per row (each row touches H+1 of its (H+1) x N int32 backpointers).
// Design: one thread per row, the H+1 dependent loads in a loop; the
// one-hot select-reduce the TPU used instead of gathers is gone.
#include <cuda_runtime.h>

__global__ void backtrace_kernel(const int* __restrict__ bp,
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

extern "C" int backtrace_launch(const int* bp, const int* goal,
                                const int* h_eff, int* nodes, int R, int Hp1,
                                int N, void* stream) {
  if (R == 0) return 0;
  const int threads = 128;
  const int blocks = (R + threads - 1) / threads;
  backtrace_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      bp, goal, h_eff, nodes, R, Hp1, N);
  return (int)cudaGetLastError();
}
